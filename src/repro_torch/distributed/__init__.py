"""Distributed substrate (port of ``repro.distributed``).

Ported so far: ``compression`` (the quantized halo wires' arithmetic and
the substrate's gradient compressors).  Of the port's own: ``collective``
(byte collectives over ``torch.distributed`` groups, staged through the
host on gloo) and ``launch`` (one process a rank, for the multi-process
paths and their tests).  ``pipeline`` and ``elastic`` belong to the
training-monitor substrate (ROADMAP A.10).
"""

from . import collective, compression, launch  # noqa: F401
