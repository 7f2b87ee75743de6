"""Streaming data ingest: per-peer update batches between dispatches.

Port of ``repro/service/ingest.py``; batches apply to the stacked
``(Q, n, ...)`` input tensors of the port's service.

``sim.run_dynamic`` models data dynamics as i.i.d. resampling noise; a
serving deployment instead receives *real* update streams — "peer 1042's
sensor now reads v" or "add dv to peer 7's statistic".  An
:class:`UpdateBatch` carries one such batch; :class:`StreamIngest` queues
batches arriving while a dispatch is in flight and applies them all to the
batched local-input arrays at the next inter-dispatch boundary.

Two modes, in the paper's moment form (<m, c> with m = c*v):

* ``"set"``   — replace: ``x[q, who] = <w * v, w>`` (w defaults to 1), the
  generalization of ``run_dynamic``'s resampling.
* ``"delta"`` — accumulate: ``x[q, who] += <dm, dc>`` — values are moment
  deltas (and ``weights`` optional weight deltas), i.e. streaming (+) of
  an update vector onto the local input, the natural form for additive
  statistics (counters, sums, gradient accumulators).

A batch targets all active queries (``query_ids=None``) or a subset — a
tenant streaming to its own private statistic.

Targeted batches for a *preempted* tenant are not dropped: the service
parks them (:meth:`StreamIngest.park`, bounded per tenant) and replays
them into the tenant's slot when it resumes — a suspension pauses the
tenant's stream instead of losing it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["UpdateBatch", "StreamIngest"]


class UpdateBatch(NamedTuple):
    who: np.ndarray  # (m,) peer ids (original numbering)
    values: np.ndarray  # (m, d) vectors ("set") or moment deltas ("delta")
    weights: Optional[np.ndarray] = None  # (m,) weights / weight deltas
    mode: str = "set"  # "set" | "delta"
    query_ids: Optional[Tuple[str, ...]] = None  # None = all active


class StreamIngest:
    """Bounded queue of update batches, drained between dispatches."""

    def __init__(self, max_pending: int = 10_000, max_parked: int = 256):
        self.max_pending = max_pending
        self.max_parked = max_parked  # parked batches bound, per tenant
        self._queue: List[UpdateBatch] = []
        self._parked: Dict[str, List[UpdateBatch]] = {}
        self.applied_batches = 0
        self.applied_updates = 0
        self.parked_dropped = 0  # oldest-dropped under the per-tenant bound

    def __len__(self) -> int:
        return len(self._queue)

    # -- preempted-tenant buffering ----------------------------------------
    def park(self, query_id: str, batch: UpdateBatch) -> None:
        """Buffer a batch for a preempted tenant (replayed at resume).
        Bounded per tenant: past ``max_parked`` the OLDEST parked batch is
        dropped — the replay then starts from a later stream position,
        which "set"-mode streams absorb (last write wins) and "delta"
        streams surface via :attr:`parked_dropped`."""
        q = self._parked.setdefault(query_id, [])
        q.append(batch)
        if len(q) > self.max_parked:
            q.pop(0)
            self.parked_dropped += 1

    def take_parked(self, query_id: str) -> List[UpdateBatch]:
        """Remove and return the tenant's parked batches, oldest first."""
        return self._parked.pop(query_id, [])

    def discard_parked(self, query_id: str) -> int:
        """Drop a retired tenant's parked batches; returns how many."""
        return len(self._parked.pop(query_id, []))

    def num_parked(self, query_id: Optional[str] = None) -> int:
        """Parked batches for one tenant (or all, when ``None``)."""
        if query_id is not None:
            return len(self._parked.get(query_id, []))
        return sum(len(v) for v in self._parked.values())

    def push(self, who, values, weights=None, mode: str = "set",
             query_ids: Optional[Sequence[str]] = None) -> UpdateBatch:
        if mode not in ("set", "delta"):
            raise ValueError(f"mode must be 'set' or 'delta', got {mode!r}")
        who = np.atleast_1d(np.asarray(who, np.int32))
        values = np.asarray(values, np.float32).reshape(who.shape[0], -1)
        if weights is not None:
            weights = np.asarray(weights, np.float32).reshape(who.shape)
        if len(self._queue) >= self.max_pending:
            raise RuntimeError(
                f"ingest queue full ({self.max_pending} pending batches)")
        batch = UpdateBatch(who, values, weights, mode,
                            tuple(query_ids) if query_ids is not None
                            else None)
        self._queue.append(batch)
        return batch

    def drain(self) -> List[UpdateBatch]:
        out, self._queue = self._queue, []
        return out

    # -- application -------------------------------------------------------
    def apply(self, x_m, x_c, batch: UpdateBatch, slots: np.ndarray,
              pos=None):
        """Apply one batch to batched moments ``x_m (Q, N, d)/x_c (Q, N)``.

        ``slots``: target query-slot indices.  ``pos``: optional original-id
        -> storage-row permutation; identity when None.  Returns new
        (x_m', x_c'); the inputs are not written.
        """
        if slots.size == 0:
            return x_m, x_c
        dev = x_m.device
        who = torch.as_tensor(batch.who, dtype=torch.long, device=dev)
        if pos is not None:
            who = pos[who]
        q = torch.as_tensor(slots, dtype=torch.long, device=dev)[:, None]
        idx = (q, who[None, :])  # (slots, m) targets
        vals = torch.as_tensor(batch.values, dtype=x_m.dtype, device=dev)
        x_m, x_c = x_m.clone(), x_c.clone()
        shape = (q.shape[0], who.shape[0])
        if batch.mode == "set":
            w = (torch.ones((who.shape[0],), dtype=x_c.dtype, device=dev)
                 if batch.weights is None
                 else torch.as_tensor(batch.weights, dtype=x_c.dtype,
                                      device=dev))
            x_m[idx] = (vals * w[:, None]).expand(*shape, -1)
            x_c[idx] = w.expand(*shape)
        else:  # moment-space delta (repeated peers accumulate)
            x_m.index_put_(idx, vals.expand(*shape, -1), accumulate=True)
            if batch.weights is not None:
                w = torch.as_tensor(batch.weights, dtype=x_c.dtype,
                                    device=dev)
                x_c.index_put_(idx, w.expand(*shape), accumulate=True)
        self.applied_batches += 1
        self.applied_updates += int(who.shape[0]) * int(slots.size)
        return x_m, x_c
