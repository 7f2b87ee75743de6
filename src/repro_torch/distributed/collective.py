"""Byte collectives over ``torch.distributed`` groups, for the port's
multi-process paths (the engine's collective halo transport, the mesh
monitor, placements and LocalSGD).

A collective here moves bytes: each tensor is viewed as one ``uint8`` row
per leading index, so every dtype crosses it (``bool`` flags, ``int8`` and
``bfloat16`` payloads included) and comes back bitwise.  :func:`all_reduce`
is the exception: it reduces values, in the buffer's own dtype.  An NCCL
group moves device memory.  A gloo group given a CUDA tensor moves it through
pinned host buffers: :func:`staged` says when, and :func:`staged_bytes`
counts what a call copies to the host.  :func:`axis_size` reads a named
axis of a ``DeviceMesh``.  Under :func:`repro_torch.launch.cost.analyze`
each all-to-all, all-gather, all-reduce and reduce-scatter counts the
payload bytes this rank sends, by op.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..launch import cost

__all__ = ["axis_size", "staged", "staged_bytes", "host_buffer", "to_host",
           "all_to_all", "all_gather", "all_reduce", "reduce_scatter"]


def axis_size(mesh, axis_name: str) -> int:
    """The size of ``mesh``'s axis ``axis_name`` (ValueError if it has
    none of that name)."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh has no axis {axis_name!r} (axes: {names})")
    return int(mesh.shape[names.index(axis_name)])


def staged(buf, group=None) -> bool:
    """Whether a collective over ``group`` (None: the default group) moves
    ``buf`` through host memory: a gloo group given a CUDA tensor."""
    return buf.is_cuda and dist.get_backend(group) == "gloo"


def staged_bytes(buf, group=None) -> int:
    """Bytes of ``buf`` a collective over ``group`` copies to the host (0
    when the group moves device memory or ``buf`` is on the CPU)."""
    return buf.numel() * buf.element_size() if staged(buf, group) else 0


def host_buffer(shape, dtype) -> torch.Tensor:
    """An empty pinned host tensor (the staging side of a gloo call)."""
    return torch.empty(shape, dtype=dtype, pin_memory=True)


def to_host(buf) -> torch.Tensor:
    """``buf`` copied into a pinned host tensor (waits for the copy)."""
    return host_buffer(buf.shape, buf.dtype).copy_(buf)


def _rows(buf) -> torch.Tensor:
    """``buf`` as one ``uint8`` row per leading index."""
    return buf.contiguous().reshape(buf.shape[0], -1).view(torch.uint8)


def _run(buf, group, op, out_rows: int) -> torch.Tensor:
    """``op(out, send)`` on ``buf``'s byte rows into ``out_rows`` rows of
    the same width, staged through pinned host memory when
    :func:`staged`; returns the rows as ``buf``'s dtype on its device."""
    send = _rows(buf)
    through_host = staged(buf, group)
    if through_host:
        send = to_host(send)
        out = host_buffer((out_rows, send.shape[1]), torch.uint8)
    else:
        out = torch.empty((out_rows, send.shape[1]), dtype=torch.uint8,
                          device=send.device)
    op(out, send)
    if through_host:
        out = out.to(buf.device, non_blocking=True)
    return out.view(buf.dtype).reshape(out_rows, *buf.shape[1:])


def all_to_all(buf, group=None) -> torch.Tensor:
    """Row ``t`` of ``buf`` (leading axis = the group's size) goes to rank
    ``t``; row ``s`` of the result is what rank ``s`` sent here."""
    def op(out, send):
        dist.all_to_all_single(out, send, group=group)

    with cost.collective("all-to-all", buf.numel() * buf.element_size()):
        return _run(buf, group, op, buf.shape[0])


def all_gather(buf, group=None) -> torch.Tensor:
    """Every rank's ``buf`` concatenated along axis 0, in group rank
    order."""
    world = dist.get_world_size(group)

    def op(out, send):
        dist.all_gather(list(out.chunk(world)), send, group=group)

    with cost.collective("all-gather", buf.numel() * buf.element_size()):
        rows = _run(buf.reshape(1, *buf.shape), group, op, world)
    return rows.reshape(world * buf.shape[0], *buf.shape[1:])


def all_reduce(buf, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``op`` over every rank's ``buf`` (same shape and dtype on each),
    as a new tensor on ``buf``'s device; ``buf`` is not written.  Staged
    through pinned host memory as the other collectives: gloo reduces on
    the host.  Gloo's algorithms reduce each element once and copy the
    result, so every rank gets the same bits.  Counted by
    :func:`repro_torch.launch.cost.analyze` as ``"all-reduce"`` (the
    engine, whose plans it ranks, reduces nothing)."""
    with cost.collective("all-reduce", buf.numel() * buf.element_size()):
        through_host = staged(buf, group)
        out = to_host(buf) if through_host else buf.clone()
        dist.all_reduce(out, op=op, group=group)
        return (out.to(buf.device, non_blocking=True) if through_host
                else out)


def reduce_scatter(buf, group=None) -> torch.Tensor:
    """The sum over every rank of ``buf`` (same shape and dtype on each),
    cut into the group's size of equal parts along axis 0: this rank's
    part, as a new tensor on ``buf``'s device.  Staged through pinned host
    memory as the others.  Counted as ``"reduce-scatter"``."""
    world = dist.get_world_size(group)
    n = buf.shape[0] // world
    if n * world != buf.shape[0]:
        raise ValueError(f"axis 0 of {tuple(buf.shape)} does not split "
                         f"into {world} parts")
    with cost.collective("reduce-scatter", buf.numel() * buf.element_size()):
        through_host = staged(buf, group)
        if through_host:
            send = to_host(buf)
            out = host_buffer((n, *buf.shape[1:]), buf.dtype)
        else:
            send = buf.contiguous()
            out = torch.empty((n, *buf.shape[1:]), dtype=buf.dtype,
                              device=buf.device)
        dist.reduce_scatter_tensor(out, send, group=group)
        return (out.to(buf.device, non_blocking=True) if through_host
                else out)
