"""Host-boundary primitives of :class:`~repro_torch.service.Service`.

Port of the two pieces of ``repro/service/overlap.py`` that the
synchronous service uses:

* :class:`PendingWindow` — everything dispatch K's telemetry needs,
  captured at launch time: the observation tensors plus a host-side
  snapshot of the bookkeeping the records are built from (active slots,
  dispatch/cycle counters, control events).  The synchronous service
  finishes the window right after its dispatch.
* :class:`DoubleBuffer` — the fixed-shape invariant made explicit: each
  launch stages the ``QueryParams``/``TopoArrays`` operands and ``swap``
  checks that their shapes and dtypes are unchanged, so a boundary edit
  that would reshape the hot dispatch raises instead.

The overlapped mode itself (``StagedBuild``, the deferred window) is not
ported yet (ROADMAP A.6).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

__all__ = ["PendingWindow", "DoubleBuffer", "BufferReshape"]


class PendingWindow(NamedTuple):
    """Dispatch K's un-finished telemetry: device tensors + the host
    bookkeeping snapshot the records will be built from."""

    dispatch: int  # 1-based dispatch index (post-increment)
    t: int  # service cycle counter after this window's K cycles
    k: int  # cycles this dispatch ran
    acc: Any  # (Q,) device — per-slot accuracy
    quiescent: Any  # (Q,) device — per-slot quiescence
    want: Any  # (Q,) device — global correct region
    msgs: Any  # (Q,) device — per-slot sends this window
    corr_iters: Any  # (Q,) device or None — correction do-while iters
    active: Tuple[Tuple[str, int], ...]  # (query_id, slot) at launch
    queued: Tuple[str, ...]  # waiting query ids at launch
    preempted: Tuple[str, ...]  # suspended query ids at launch
    topo_version: int  # applied topology version at launch
    edges: int  # live edge count at launch (msgs_per_link denominator)
    events: list  # control events swapped out at launch
    spans: dict  # boundary span seconds swapped out at launch
    counts: dict  # boundary work counts swapped out at launch


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
