"""Distributed substrate (port of ``repro.distributed``).

Ported: ``compression`` (the quantized halo wires' arithmetic and the
substrate's gradient compressors), ``elastic`` (remesh after a lost rank,
reshard onto a mesh) and ``pipeline`` (the GPipe schedule over a
``stage`` axis, one stage a rank).  Of the port's own: ``collective``
(byte collectives and an all-reduce over ``torch.distributed`` groups,
staged through the host on gloo), ``launch`` (one process a rank, for the
multi-process paths and their tests), ``sharding`` (JAX's
``NamedSharding`` / ``device_put`` on ``DeviceMesh`` placements) and
``spmd`` (the steps of :mod:`repro_torch.training.steps` across a mesh of
more than one device).
"""

from . import (collective, compression, elastic, launch,  # noqa: F401
               pipeline, sharding, spmd)
