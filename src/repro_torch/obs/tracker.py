"""Pluggable Tracker protocol: records, spans, and a metrics registry.

Copy of ``src/repro/obs/tracker.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

A :class:`Tracker` is the one observability interface every layer of the
repo talks to.  It bundles three surfaces:

* ``log_record(record)`` — structured event stream (the per-query and
  ``kind="control"`` dicts the service has always emitted; see
  :mod:`repro_torch.obs.schema`).
* ``span(name, **attrs)`` — host-side timing scopes (dispatch, admission
  drain, membership drain, ingest staging, epoch migration).  Spans are
  always timed with ``time.perf_counter`` — even under
  :class:`NoopTracker` — so callers can read ``span.seconds`` and fold
  real timings into control records regardless of backend.
* ``registry`` — a shared :class:`~repro_torch.obs.metrics.MetricsRegistry` of
  counters / gauges / histograms that policies (SLO eviction, bench
  gates, dashboards) read back.

Backends:

* :class:`NoopTracker` — timing only, records nothing (bench baseline).
* :class:`InMemoryTracker` — keeps records / metrics / finished spans in
  lists (tests).
* :class:`JsonlTracker` — writes each record as one JSON line, bitwise
  compatible with the legacy ``TelemetrySink`` file format, with an
  optional ``max_records`` ring buffer for the in-memory copy.
* :class:`PrometheusTextTracker` — keeps no record stream; its value is
  ``expose()``, the text-exposition snapshot of the registry.

All trackers are context managers with idempotent ``close()``.
"""

from __future__ import annotations

import itertools
import json
import time
from collections import deque
from contextlib import contextmanager
from typing import IO, Any, Dict, Iterable, List, Optional, Union

from .metrics import DEFAULT_TIME_BUCKETS, MetricsRegistry

__all__ = ["Span", "Tracker", "NoopTracker", "InMemoryTracker",
           "JsonlTracker", "PrometheusTextTracker", "jit_cache_size"]

# Process-wide span-id mint: ids stay unique (and start-ordered) even when
# several trackers contribute to one record stream (service + engine).
_SPAN_IDS = itertools.count(1)


def jit_cache_size(fn) -> Optional[int]:
    """Compiled-variant count of a jitted callable: always None here.

    The port runs eagerly and has no jit cache, so there is no recompile to
    count; the service reports ``step_cache_size: None`` and
    ``recompiles: 0``, as the JAX docstring allows for a jax that exposes
    no cache size.  ``fn`` is accepted for the JAX signature.
    """
    return None


class Span:
    """One timed scope.  ``attrs`` carries caller context (backend, k,
    batch sizes); ``set()`` adds results discovered inside the scope
    (recompile delta, events drained).  ``seconds`` is valid once the
    ``tracker.span(...)`` context exits.

    Every span carries a process-unique ``span_id`` and the ``span_id``
    of the enclosing span on the same tracker (``parent_id``, None for
    roots), so the record stream reconstructs into a causal tree
    (:func:`repro_torch.obs.trace.assemble`).  ``trace`` lists the tenant
    ``trace_id`` strings this scope did work for: one for per-tenant
    scopes (admission, preempt, resume, evict), all active tenants for
    shared scopes (dispatch, observe)."""

    __slots__ = ("name", "attrs", "seconds", "span_id", "parent_id",
                 "trace", "_t0")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 parent_id: Optional[int] = None,
                 trace: Iterable[str] = ()):
        self.name = name
        self.attrs = attrs
        self.seconds: float = 0.0
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent_id
        self.trace = tuple(trace)
        self._t0 = time.perf_counter()

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def set_trace(self, trace: Iterable[str]) -> None:
        """Attach tenant trace ids discovered inside the scope."""
        self.trace = tuple(trace)

    def _stop(self) -> None:
        self.seconds = time.perf_counter() - self._t0

    def elapsed(self, until: Optional[float] = None) -> float:
        """Seconds from the span's start to ``until`` (a
        ``time.perf_counter`` stamp; default now)."""
        return (time.perf_counter() if until is None else until) - self._t0

    def to_record(self) -> dict:
        """The ``kind="span"`` record for this scope (schema-validated).

        Deliberately has no ``query`` key: per-query record counting
        stays keyed on the dispatch stream."""
        rec: Dict[str, Any] = {
            "kind": "span",
            "name": self.name,
            "span_id": self.span_id,
            "seconds": self.seconds,
        }
        if self.parent_id is not None:
            rec["parent_id"] = self.parent_id
        if self.trace:
            rec["trace"] = list(self.trace)
        if self.attrs:
            rec["attrs"] = dict(self.attrs)
        return rec


class Tracker:
    """Base tracker: full span/registry behavior, records discarded.

    Subclasses override :meth:`log_record` (and optionally
    :meth:`_finish_span` / :meth:`log_metrics`) to route the streams
    somewhere; the timing and registry plumbing is shared.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._closed = False
        self._span_stack: List[Span] = []

    # -- record stream -------------------------------------------------
    def log_record(self, record: dict) -> None:
        """Append one structured event (per-query or control record)."""

    # -- point-in-time metrics ----------------------------------------
    def log_metrics(self, metrics: Dict[str, float], **labels) -> None:
        """Set a batch of gauges in one call."""
        for name, value in metrics.items():
            self.registry.gauge(name).set(value, **labels)

    # -- spans ---------------------------------------------------------
    @contextmanager
    def span(self, name: str, trace: Iterable[str] = (), **attrs):
        """Open a timed scope.  Nesting is tracked per tracker: a span
        opened while another is active records it as ``parent_id``.
        ``trace`` names the tenant trace ids this scope serves."""
        parent = self._span_stack[-1].span_id if self._span_stack else None
        sp = Span(name, attrs, parent_id=parent, trace=trace)
        self._span_stack.append(sp)
        try:
            yield sp
        finally:
            sp._stop()
            if self._span_stack and self._span_stack[-1] is sp:
                self._span_stack.pop()
            self._finish_span(sp)

    def start_span(self, name: str, trace: Iterable[str] = (),
                   **attrs) -> Span:
        """Open a timed scope outside the nesting stack: its parent is the
        span active now, and nothing opened later nests under it.  Close
        it with :meth:`end_span`, from any point of the program (the
        overlapped service ends a dispatch's span when its worker thread
        hands the dispatch back)."""
        parent = self._span_stack[-1].span_id if self._span_stack else None
        return Span(name, attrs, parent_id=parent, trace=trace)

    def end_span(self, sp: Span, seconds: Optional[float] = None) -> None:
        """Record a span from :meth:`start_span`, timed until now or with
        the given ``seconds``."""
        if seconds is None:
            sp._stop()
        else:
            sp.seconds = seconds
        self._finish_span(sp)

    def _finish_span(self, sp: Span) -> None:
        self.registry.histogram(
            "span_seconds", "wall time per named host-side span",
            buckets=DEFAULT_TIME_BUCKETS).observe(sp.seconds, span=sp.name)
        self.log_record(sp.to_record())

    # -- instrument shortcuts -----------------------------------------
    def counter(self, name: str, help: str = ""):
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = ""):
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_TIME_BUCKETS):
        return self.registry.histogram(name, help, buckets=buckets)

    def prometheus_text(self) -> str:
        return self.registry.prometheus_text()

    # -- lifecycle -----------------------------------------------------
    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NoopTracker(Tracker):
    """Times spans (so control-record timings stay real) but records
    nothing and keeps the registry empty: the zero-overhead baseline."""

    def _finish_span(self, sp: Span) -> None:
        pass

    def log_metrics(self, metrics: Dict[str, float], **labels) -> None:
        pass


class _RecordStore:
    """Shared record retention + the legacy TelemetrySink conveniences."""

    def __init__(self, keep: bool, max_records: Optional[int]):
        self._keep = keep
        if keep:
            self._records = (deque(maxlen=max_records)
                             if max_records is not None else [])
        else:
            self._records = []

    @property
    def records(self) -> List[dict]:
        """Retained records, oldest first (a list copy when ring-buffered)."""
        recs = self._records
        return recs if isinstance(recs, list) else list(recs)

    def _retain(self, record: dict) -> None:
        if self._keep:
            self._records.append(record)

    def for_query(self, query_id: str) -> List[dict]:
        return [r for r in self._records if r.get("query") == query_id]

    def controls(self) -> List[dict]:
        return [r for r in self._records if r.get("kind") == "control"]

    def audits(self, query_id: Optional[str] = None) -> List[dict]:
        """Retained ``kind="audit"`` records (optionally one tenant's)."""
        return [r for r in self._records if r.get("kind") == "audit"
                and (query_id is None or r.get("query") == query_id)]

    def last_by_query(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for r in self._records:
            q = r.get("query")
            if q is not None:
                out[q] = r
        return out


class InMemoryTracker(_RecordStore, Tracker):
    """Everything retained in Python lists — the test backend.

    ``.records`` / ``.metrics`` / ``.spans`` hold the full history."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 max_records: Optional[int] = None):
        _RecordStore.__init__(self, keep=True, max_records=max_records)
        Tracker.__init__(self, registry)
        self.metrics: List[dict] = []
        self.spans: List[Span] = []

    def log_record(self, record: dict) -> None:
        self._retain(record)

    def log_metrics(self, metrics: Dict[str, float], **labels) -> None:
        self.metrics.append({"metrics": dict(metrics), "labels": labels})
        Tracker.log_metrics(self, metrics, **labels)

    def _finish_span(self, sp: Span) -> None:
        self.spans.append(sp)
        Tracker._finish_span(self, sp)

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class JsonlTracker(_RecordStore, Tracker):
    """JSON-lines record stream, byte-identical to the legacy sink.

    Parameters
    ----------
    path:
        ``None`` (memory only), a path string (file opened/owned/closed
        by the tracker), or an open file-like object (borrowed — caller
        closes it).
    keep:
        Retain records in memory for ``for_query`` / ``controls`` /
        ``last_by_query``.
    max_records:
        When set (with ``keep=True``), retain only the most recent N
        records (ring buffer).  The JSONL file always gets every record;
        only the in-memory copy is bounded.
    mode:
        Open mode for a str ``path`` (``"w"``; the legacy sink shim
        passes ``"a"``).
    """

    def __init__(self, path: Union[str, IO[str], None] = None, *,
                 keep: bool = True, max_records: Optional[int] = None,
                 mode: str = "w",
                 registry: Optional[MetricsRegistry] = None):
        _RecordStore.__init__(self, keep=keep, max_records=max_records)
        Tracker.__init__(self, registry)
        self._own_file = isinstance(path, str)
        self._file: Optional[IO[str]] = (
            open(path, mode) if isinstance(path, str) else path)

    def log_record(self, record: dict) -> None:
        self._retain(record)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")

    def flush(self) -> None:
        if self._file is not None:
            self._file.flush()

    def close(self) -> None:
        if self._closed:
            return
        if self._file is not None:
            if self._own_file:
                self._file.close()
            else:
                self._file.flush()
            self._file = None
        super().close()


class PrometheusTextTracker(Tracker):
    """Registry-only backend for scrape-style export.

    Records are counted (``records_total`` by kind) but not retained;
    :meth:`expose` returns the text-exposition snapshot."""

    def log_record(self, record: dict) -> None:
        kind = record.get("kind", "query")
        self.registry.counter(
            "records_total", "structured records seen by kind").inc(
                1, kind=str(kind))

    def expose(self) -> str:
        return self.registry.prometheus_text()
