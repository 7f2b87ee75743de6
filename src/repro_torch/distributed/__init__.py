"""Distributed substrate (port of ``repro.distributed``).

Ported so far: ``compression`` (the quantized halo wires' arithmetic and
the substrate's gradient compressors).  ``pipeline`` and ``elastic``
belong to the training-monitor substrate (ROADMAP A.10).
"""

from . import compression  # noqa: F401
