"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (port of
``repro/distributed/pipeline.py``).

``pipeline(stage_fn, mesh)`` runs S stages over M microbatches with the
classic fill/drain schedule (M + S - 1 ticks).  Each rank on the ``stage``
axis holds one stage's params (row ``s`` of the stacked param tree, or
the local shard of a DTensor stacked tree placed on the axis); activations
hop stages with one ``batch_isend_irecv`` a tick in the axis's process
group, cyclic as JAX's ``ppermute`` (the value the last stage sends to
stage 0 is ignored there).  On gloo with CUDA tensors each hop is staged
through pinned host memory.

Bubble fraction = (S-1)/(M+S-1).  Forward only, as JAX's tests use it.
JAX runs every stage's ``stage_fn`` at every tick and masks the idle
ones; here an idle stage skips the call and forwards its buffer, which
is what JAX's mask keeps.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree as tree_lib
from . import collective

__all__ = ["pipeline"]


def _stage_params(params, s: int):
    """This stage's slice of a stacked tree: row ``s`` of a full leaf, the
    one row of a DTensor's local shard."""
    def row(a):
        if isinstance(a, DTensor):
            local = a.to_local()
            if local.shape[0] != 1:
                raise ValueError("a DTensor stacked leaf must hold one stage "
                                 f"a rank, got {local.shape[0]} rows")
            return local[0]
        return a[s]

    return tree_lib.map(row, params)


def _hop(y, group, ranks, s: int, S: int, tag: int):
    """Send ``y`` to stage s + 1 and receive stage s - 1's (mod S)."""
    out = y.contiguous()
    through_host = collective.staged(out, group)
    if through_host:
        out = collective.to_host(out)
        got = collective.host_buffer(out.shape, out.dtype)
    else:
        got = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, ranks[(s + 1) % S], group=group,
                      tag=tag),
           dist.P2POp(dist.irecv, got, ranks[(s - 1) % S], group=group,
                      tag=tag)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got.to(y.device, non_blocking=True) if through_host else got


def pipeline(stage_fn: Callable, mesh, axis: str = "stage"):
    """Build a pipelined apply: (stacked_params, x (M, B, ...)) -> (M, B, ...).

    ``stage_fn(params_slice, x)`` is one stage's computation; all stages
    must share input/output activation shapes (standard for repeated
    transformer blocks).  Every rank calls ``apply`` with the same ``xs``
    and gets the same outputs (a SUM over the axis, as JAX's ``psum``).
    ``apply.ticks`` records the last call's per-tick wall (s), the
    activation bytes a hop staged and whether the stage was active.
    """
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes: {names})")
    S = collective.axis_size(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    s = int(mesh.get_local_rank(axis))

    def apply(stacked_params, xs):
        M = xs.shape[0]
        p_local = _stage_params(stacked_params, s)
        buf = torch.zeros_like(xs[0])  # activation entering this stage
        outs = torch.zeros_like(xs)
        ticks = []
        for t in range(M + S - 1):
            t0 = time.perf_counter()
            active = 0 <= t - s < M
            if active:
                y = stage_fn(p_local, xs[t] if s == 0 else buf)
                if s == S - 1:  # the last stage records its microbatch
                    outs[t - s] = y
            else:
                y = buf
            staged = 0
            if S > 1:
                staged = collective.staged_bytes(y, group)
                buf = _hop(y, group, ranks, s, S, tag=t)
            else:
                buf = y
            ticks.append((time.perf_counter() - t0, staged, active))
        apply.ticks = ticks
        # Sum over stages: only the last stage wrote non-zeros.
        return collective.all_reduce(outs, dist.ReduceOp.SUM, group)

    apply.ticks = []
    return apply
