"""Flight recorder: a bounded ring of the most recent records + spans.

Copy of ``src/repro/obs/flight.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Post-mortems want the *last* N events — the admission, drains,
dispatches, alerts, and evictions leading up to an incident — without
paying for always-on JSONL.  :class:`FlightRecorder` is a tee
:class:`~repro_torch.obs.Tracker`: it wraps any inner backend (including
Noop), shares the inner registry, keeps every record (span records
included) in a ``deque(maxlen=capacity)``, and forwards everything to
the inner tracker untouched.

Crucially the ring retains span and alert records even when the inner
backend discards them (Noop), so a service running at the zero-overhead
baseline still produces a complete causal dump
(:meth:`~repro_torch.service.Service.dump_flight_recorder`) on SLO violation,
eviction, epoch, alert, or crash.

A dump is one JSONL file: a ``kind="flight"`` header (reason, trigger
context, ring size) followed by the ring oldest-first — the same schema
``python -m repro_torch.obs.validate`` checks, so dumps feed straight into
:func:`repro_torch.obs.trace.assemble` and ``dashboard.trace_view``.
"""

from __future__ import annotations

import json
from collections import deque
from typing import List, Optional

from .tracker import NoopTracker, Span, Tracker

__all__ = ["FlightRecorder"]


class FlightRecorder(Tracker):
    """Tee tracker with a bounded in-memory ring.

    Args:
      inner: the real backend (records forwarded verbatim; registry
        shared).  Defaults to :class:`NoopTracker` — ring only.
      capacity: ring size in records (oldest evicted first).
    """

    def __init__(self, inner: Optional[Tracker] = None,
                 capacity: int = 1024):
        self.inner = inner if inner is not None else NoopTracker()
        Tracker.__init__(self, registry=self.inner.registry)
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=max(1, self.capacity))
        self.dumps: List[str] = []

    # -- tee -----------------------------------------------------------
    def log_record(self, record: dict) -> None:
        self._ring.append(record)
        self.inner.log_record(record)

    def log_metrics(self, metrics, **labels) -> None:
        self.inner.log_metrics(metrics, **labels)

    def _finish_span(self, sp: Span) -> None:
        # Ring always keeps the span record; the inner backend applies
        # its own policy (Noop drops it, registry stays untouched).
        self._ring.append(sp.to_record())
        self.inner._finish_span(sp)

    # -- ring ----------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """Ring contents oldest-first (a copy)."""
        return list(self._ring)

    def records_of_kind(self, kind: str) -> List[dict]:
        """Ring records of one kind, oldest-first (e.g. ``"audit"`` —
        what forensics reads out of a triggered dump before it is even
        written)."""
        return [r for r in self._ring if r.get("kind") == kind]

    def __len__(self) -> int:
        return len(self._ring)

    def dump(self, path: str, reason: str = "manual", **context) -> str:
        """Write the ring to ``path`` as JSONL (header + records) and
        remember the path in :attr:`dumps`."""
        recs = self.snapshot()
        header = {"kind": "flight", "reason": str(reason),
                  "records": len(recs)}
        header.update(context)
        with open(path, "w") as fh:
            fh.write(json.dumps(header) + "\n")
            for rec in recs:
                fh.write(json.dumps(rec) + "\n")
        self.dumps.append(path)
        return path

    # -- lifecycle (inner is owned by the caller, not the tee) ---------
    def flush(self) -> None:
        self.inner.flush()
