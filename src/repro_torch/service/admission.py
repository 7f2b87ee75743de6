"""Bounded admission queue: backpressure instead of hard rejection.

Copy of ``src/repro/service/admission.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

The registry's slot capacity is a *compiled-shape* limit — Q is baked
into every traced program — so an admit when all slots are occupied
cannot simply allocate.  Previously that raised ``RuntimeError`` at the
call site; the :class:`AdmissionQueue` instead absorbs the burst: the
spec waits and the :class:`~repro_torch.service.service.Service` drains
waiting specs into slots as tenants retire, at every dispatch boundary —
in FIFO order by default, or in the order the control plane's scheduler
picks (:mod:`repro_torch.service.controlplane.scheduler`).

The queue itself is bounded.  What happens when *it* fills is the
explicit overflow policy:

* ``"reject"`` (default) — the overflowing ``admit`` raises
  ``RuntimeError``, i.e. backpressure propagates to the caller (the id,
  when caller-supplied, keeps a terminal ``"rejected"`` status).
* ``"evict-oldest"`` — the oldest *waiting* spec is dropped (its status
  becomes ``"evicted"``) and the new one enqueues; freshest-wins, for
  callers that re-submit rather than block.

Every terminal outcome records a human-readable *reason*
(:meth:`terminal_reason`), and the service mirrors evictions/depth into
the telemetry sink's control records — a query that left the queue
without a slot never just disappears.

``limit=0`` disables queueing entirely, restoring the original
fail-fast behavior.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """FIFO of (query_id, spec) waiting for a free slot."""

    OVERFLOW_POLICIES = ("reject", "evict-oldest")

    def __init__(self, limit: int = 16, overflow: str = "reject",
                 clock=None):
        if limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        if overflow not in self.OVERFLOW_POLICIES:
            raise ValueError(
                f"overflow must be one of {self.OVERFLOW_POLICIES}, "
                f"got {overflow!r}")
        self.limit = limit
        self.overflow = overflow
        # Optional timestamp source for terminal outcomes — the service
        # passes its dispatch ordinal, so "when was this evicted?" is
        # answerable in the same clock the trace spans use.
        self._clock = clock if clock is not None else (lambda: 0)
        self._queue: List[Tuple[str, object]] = []
        # Terminal outcomes of ids that left the queue without a slot:
        # query_id -> (status, reason, clock).  Bounded: oldest evicted
        # past _TERMINAL_CAP.
        self._terminal: Dict[str, Tuple[str, str, int]] = {}

    _TERMINAL_CAP = 1 << 16

    def _record_terminal(self, query_id: str, status: str,
                         reason: str) -> None:
        self._terminal[query_id] = (status, reason, int(self._clock()))
        while len(self._terminal) > self._TERMINAL_CAP:
            self._terminal.pop(next(iter(self._terminal)))

    def __len__(self) -> int:
        return len(self._queue)

    def __contains__(self, query_id: str) -> bool:
        return any(qid == query_id for qid, _ in self._queue)

    def queued_ids(self) -> List[str]:
        return [qid for qid, _ in self._queue]

    def items(self) -> List[Tuple[str, object]]:
        """Waiting (query_id, spec) pairs in arrival order (a copy)."""
        return list(self._queue)

    def terminal_status(self, query_id: str) -> Optional[str]:
        """"evicted"/"cancelled"/"rejected" for ids that left the queue
        without a slot."""
        entry = self._terminal.get(query_id)
        return entry[0] if entry is not None else None

    def terminal_reason(self, query_id: str) -> Optional[str]:
        """Why the id left the queue (None for unknown ids)."""
        entry = self._terminal.get(query_id)
        return entry[1] if entry is not None else None

    def terminal_at(self, query_id: str) -> Optional[int]:
        """Clock reading (the service's dispatch ordinal) at which the id
        left the queue (None for unknown ids)."""
        entry = self._terminal.get(query_id)
        return entry[2] if entry is not None else None

    def push(self, query_id: str, spec) -> Optional[str]:
        """Enqueue; returns the id of an evicted spec (or None).

        Raises ``RuntimeError`` under the ``"reject"`` policy when the
        queue is at its limit (including ``limit=0``: queueing disabled);
        the rejected id keeps a terminal ``"rejected"`` status.
        """
        evicted = None
        if len(self._queue) >= self.limit:
            if self.overflow == "reject" or self.limit == 0:
                msg = (f"service full: all slots occupied and the admission "
                       f"queue holds {len(self._queue)}/{self.limit} waiting "
                       f"specs (overflow policy: {self.overflow!r})")
                self._record_terminal(query_id, "rejected", msg)
                raise RuntimeError(msg)
            evicted, _ = self._queue.pop(0)
            self._record_terminal(
                evicted, "evicted",
                f"admission queue overflow at {self.limit}: displaced by "
                f"newer submission {query_id!r} (evict-oldest policy)")
        self._queue.append((query_id, spec))
        return evicted

    def pop(self) -> Tuple[str, object]:
        return self._queue.pop(0)

    def take(self, query_id: str):
        """Remove and return a specific waiting spec (scheduler-ordered
        activation); raises ``KeyError`` for ids not waiting."""
        for i, (qid, spec) in enumerate(self._queue):
            if qid == query_id:
                del self._queue[i]
                return spec
        raise KeyError(f"query id {query_id!r} is not waiting")

    def evict(self, query_id: str, reason: str) -> bool:
        """Drop a waiting spec with an ``"evicted"`` terminal status and
        an explicit reason (control-plane policy evictions, e.g.
        SLO-driven).  Returns False for ids not waiting."""
        for i, (qid, _) in enumerate(self._queue):
            if qid == query_id:
                del self._queue[i]
                self._record_terminal(query_id, "evicted", reason)
                return True
        return False

    def cancel(self, query_id: str) -> bool:
        """Drop a waiting spec (a retire() before it ever got a slot)."""
        for i, (qid, _) in enumerate(self._queue):
            if qid == query_id:
                del self._queue[i]
                self._record_terminal(query_id, "cancelled",
                                      "retired before activation")
                return True
        return False
