"""Production and host meshes (port of ``repro/launch/mesh.py``).

Both are FUNCTIONS: importing this module touches no device and no
process group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group (one rank a device, as one
JAX device is one mesh coordinate).  Single pod: 16x16 = 256 ranks over
("data", "model"); multi-pod: 2 pods = 512 ranks over ("pod", "data",
"model"), where the pod axis is the DCN dimension (batch sharding
composes over pod x data; the LSS-gated sync targets this axis).

The mesh's device type follows the default group's backend
(:func:`mesh_device_type`): ``"cpu"`` for gloo (the port's collectives
stage CUDA tensors through pinned host memory,
:mod:`repro_torch.distributed.collective`), ``"cuda"`` for NCCL.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

__all__ = ["make_production_mesh", "make_host_mesh", "mesh_device_type"]


def mesh_device_type() -> str:
    """``"cuda"`` on an NCCL default group, else ``"cpu"``."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with "
            "repro_torch.distributed.launch.spawn (or call "
            "torch.distributed.init_process_group) before making a mesh")
    return dist.get_world_size()


def _mesh(shape, axes):
    return init_device_mesh(mesh_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model"); ``ValueError`` on a world of any other size (JAX's
    ``make_mesh`` refuses too few devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    if math.prod(shape) != n:
        raise ValueError(f"production mesh {shape} needs {math.prod(shape)} "
                         f"ranks, the world has {n}")
    return _mesh(shape, axes)


def make_host_mesh(shape=None, axes=("data", "model")):
    """A mesh over the default group's whole world (tests, examples).

    The default shape favours data parallelism: ``(n, 1)``, or ``(n,)``
    for one axis.  ``ValueError`` when ``prod(shape)`` is not the world
    size, as JAX's.  Unlike JAX, where one process always sees its
    devices, a mesh needs an initialised process group: without one this
    raises ``RuntimeError`` naming the launcher
    (:func:`repro_torch.distributed.launch.spawn`) and sets nothing up.
    """
    n = _world()
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return _mesh(shape, axes)
