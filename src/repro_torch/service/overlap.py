"""Host-boundary primitives of :class:`~repro_torch.service.Service`.

Port of ``repro/service/overlap.py``.  JAX gets the overlap from its
asynchronous dispatch; here a dispatch is a host loop (the correction
do-while reads its running flag every iteration), so the overlapped
service (``ServiceConfig(overlap=True)``) runs each dispatch on a worker
thread while the main thread runs the next boundary's host-only work and
finishes the previous window::

    sync     |--boundary K--|--dispatch K--|--boundary K+1--|--dispatch K+1--|
    overlap  |--boundary K--|--dispatch K (worker)-----|
                            |--host part of K+1--|join|--rest--|--dispatch K+1

* :class:`PendingWindow` — everything dispatch K's telemetry needs: the
  observation rows, copied to (pinned) host memory behind the dispatch,
  with the CUDA event that marks the copy done, plus a host-side snapshot
  of the bookkeeping the records are built from (active slots,
  dispatch/cycle counters, control events).  The synchronous service
  finishes it right after its dispatch, the overlapped one a tick later.
* :class:`DoubleBuffer` — the fixed-shape invariant made explicit: each
  launch stages the ``QueryParams``/``TopoArrays`` operands and ``swap``
  checks that their shapes and dtypes are unchanged, so a boundary edit
  that would reshape the hot dispatch raises instead.
* :class:`StagedBuild` — an epoch's heavy host work (a partition and its
  halo tables, a new engine) run on a background thread against an
  immutable topology snapshot; the boundary polls :meth:`StagedBuild.
  ready` and adopts the build at a later tick, caught up by the same
  incremental journal repair live membership uses.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

__all__ = ["PendingWindow", "DoubleBuffer", "StagedBuild", "BufferReshape"]


class PendingWindow(NamedTuple):
    """Dispatch K's un-finished telemetry: device tensors + the host
    bookkeeping snapshot the records will be built from."""

    dispatch: int  # 1-based dispatch index (post-increment)
    t: int  # service cycle counter after this window's K cycles
    k: int  # cycles this dispatch ran
    acc: Any  # (Q,) host f64 — per-slot accuracy (None until landed)
    quiescent: Any  # (Q,) host f64 — per-slot quiescence
    want: Any  # (Q,) host f64 — global correct region
    msgs: Any  # (Q,) host f64 — per-slot sends this window
    corr_iters: Any  # (Q,) host f64 — correction do-while iters
    active: Tuple[Tuple[str, int], ...]  # (query_id, slot) at launch
    queued: Tuple[str, ...]  # waiting query ids at launch
    preempted: Tuple[str, ...]  # suspended query ids at launch
    topo_version: int  # applied topology version at launch
    edges: int  # live edge count at launch (msgs_per_link denominator)
    events: list  # control events swapped out at launch
    spans: dict  # boundary span seconds swapped out at launch
    counts: dict  # boundary work counts swapped out at launch
    ready: Any = None  # CUDA event: the rows above reached the host


class BufferReshape(RuntimeError):
    """A boundary changed a dispatch operand's shape without declaring an
    epoch."""


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _leaves(sub)
    else:
        yield tree


def _signature(tree) -> tuple:
    """(shape, dtype) signature of nested tuples of tensors; other leaves
    contribute their value."""
    return tuple((tuple(leaf.shape), str(leaf.dtype))
                 if isinstance(leaf, torch.Tensor) else leaf
                 for leaf in _leaves(tree))


class DoubleBuffer:
    """Front staging of the dispatch operands (params + topo).

    ``swap`` stages the buffers for the next launch and enforces the
    fixed-shape invariant: staged buffers must keep the signature of the
    pair they replace.  An epoch would call :meth:`invalidate` first — the
    one place a reshape is expected.
    """

    __slots__ = ("front", "swaps", "epochs", "_sig")

    def __init__(self):
        self.front: Optional[tuple] = None  # operands of the last dispatch
        self.swaps = 0  # shape-stable swaps performed
        self.epochs = 0  # declared invalidations (expected reshapes)
        self._sig: Optional[tuple] = None

    def invalidate(self) -> None:
        """Declare an epoch: the next swap may reshape."""
        self.epochs += 1
        self._sig = None
        self.front = None

    def swap(self, *bufs) -> None:
        """Stage ``bufs`` as the next dispatch's operands.

        Raises :class:`BufferReshape` if their signature differs from the
        previous pair's without an :meth:`invalidate` between.
        """
        sig = _signature(bufs)
        if self._sig is not None and sig != self._sig:
            raise BufferReshape(
                "dispatch buffer shapes changed outside an epoch; call "
                "invalidate() from the epoch path if this reshape is "
                "intentional")
        self._sig = sig
        self.front = bufs
        self.swaps += 1


class StagedBuild:
    """One background build of an epoch's host-side product.

    Runs ``fn`` (work over an immutable snapshot — a partition, its halo
    tables, a fresh engine) on a daemon thread started at construction.
    The boundary polls :meth:`ready` and calls :meth:`take` to adopt;
    ``take`` joins, so calling it early waits for the build instead of
    racing it.  An exception of the build is kept and re-raised by
    ``take``; the adopter then rebuilds in line.
    """

    __slots__ = ("label", "_fn", "_result", "_error", "_thread")

    def __init__(self, fn: Callable[[], Any], label: str = ""):
        self.label = label
        self._fn = fn
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, name=f"staged-build-{label or 'epoch'}",
            daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            self._result = self._fn()
        except BaseException as e:  # re-raised by take()
            self._error = e

    def ready(self) -> bool:
        """True once the build finished (successfully or not)."""
        return not self._thread.is_alive()

    def take(self) -> Any:
        """Join and return the build product (re-raising its error)."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result
