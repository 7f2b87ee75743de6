"""The roofline inputs of one call, counted while it runs.

The torch stand-in for ``repro.launch.hlo_cost.analyze``, which reads a
compiled XLA module: nothing in torch has optimized HLO to parse, so
:func:`analyze` runs the call once and counts what it does, under JAX's
keys:

* ``flops`` — one operation per element of each floating output of an
  aten op (a matrix product counts ``2 m n k``), plus the analytic
  operations of each kernel;
* ``hbm_bytes`` — each aten op's input and output tensor bytes (views
  move none), plus the analytic bytes of each kernel;
* ``collective_bytes`` — ``{"all-to-all", "all-gather", "all-reduce",
  "reduce-scatter", "total"}``: the payload bytes this rank sends through
  :mod:`repro_torch.distributed.collective`, by op.

The CUDA kernels are called through ctypes, which a dispatch mode never
sees, so the kernel suite counts them itself (:func:`kernel`, from the
models of :mod:`repro_torch.kernels.cost`, by shape), and while inside
such a call, or a collective, the torch ops are not counted again.  The
numbers are per rank and per call, like HLO's per-device module; they
only rank plans (:mod:`repro_torch.engine.autotune`), they do not predict
walls.
"""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["analyze", "counting", "kernel", "collective"]

COLLECTIVES = ("all-to-all", "all-gather", "all-reduce", "reduce-scatter")
_MATMULS = {"mm", "bmm", "addmm", "baddbmm"}
_open = threading.local()  # this thread's open counters


def _stack() -> list:
    if not hasattr(_open, "counters"):
        _open.counters = []
    return _open.counters


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """The tallies of one :func:`analyze` call; a dispatch mode that adds
    every aten op it sees while not paused."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll = dict.fromkeys(COLLECTIVES, 0.0)
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.paused or func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self.hbm_bytes += sum(_nbytes(t) for t in ins + outs)
        name = func.overloadpacket.__name__
        if name in _MATMULS:  # 2 m n k: the contracted axis of the product
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self.flops += 2 * outs[0].numel() * a.shape[-1]
        else:
            self.flops += sum(t.numel() for t in outs
                              if t.is_floating_point())
        return out


def counting() -> bool:
    """Whether an :func:`analyze` call is open on this thread."""
    return bool(_stack())


@contextmanager
def _paused(add):
    """Apply ``add`` to every open counter that is not paused, and pause
    them all inside the block."""
    counters = list(_stack())
    for c in counters:
        if not c.paused:
            add(c)
        c.paused += 1
    try:
        yield
    finally:
        for c in counters:
            c.paused -= 1


def kernel(nbytes, ops):
    """A kernel call of ``nbytes`` bytes and ``ops`` operations: counted
    as such, and its own torch ops not at all."""
    def add(c):
        c.hbm_bytes += nbytes
        c.flops += ops

    return _paused(add)


def collective(op: str, nbytes):
    """A collective ``op`` (one of :data:`COLLECTIVES`) sending ``nbytes``
    from this rank; its staging and copies are not counted."""
    def add(c):
        c.coll[op] += nbytes

    return _paused(add)


def analyze(fn, *args, **kw) -> dict:
    """Run ``fn(*args, **kw)`` once and return what it did: ``flops``,
    ``hbm_bytes`` and ``collective_bytes`` (by op, and ``total``), the keys
    of ``repro.launch.hlo_cost.analyze``."""
    counter = _Counter()
    stack = _stack()
    stack.append(counter)
    try:
        with counter:
            fn(*args, **kw)
    finally:
        stack.remove(counter)
    coll = dict(counter.coll)
    coll["total"] = math.fsum(coll.values())
    return {"flops": counter.flops, "hbm_bytes": counter.hbm_bytes,
            "collective_bytes": coll}
