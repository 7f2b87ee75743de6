"""Fleet observability for the port (port of ``repro.obs``).

Host-side modules copied from ``src/repro/obs/``: :mod:`.metrics`
(counter / gauge / histogram registry with Prometheus text exposition),
:mod:`.tracker` (the :class:`Tracker` protocol and its Noop / InMemory /
Jsonl / PrometheusText backends; ``jit_cache_size`` is always None, since
the port has no jit cache), :mod:`.flight` (the flight-recorder tee),
:mod:`.push` (:class:`PushTracker`), :mod:`.trace` (causal trace trees),
:mod:`.alerts` (:class:`AlertRule` / :class:`AlertEngine`),
:mod:`.schema` (the golden record schema and its validators),
:mod:`.dashboard` (text dashboards and ``trace_view``), :mod:`.forensics`
(first-violation provenance, ``python -m repro_torch.obs.forensics``)
and :mod:`.validate` (the telemetry contract check, ``python -m
repro_torch.obs.validate``).

Ported for torch: :mod:`.audit` (the audit plane's verdicts over the
port's device reductions, and :class:`AuditFaults` on torch tensors) and
:mod:`.profile` (:class:`ProfiledDispatch`, fenced by a CUDA event, and
``torch.profiler`` sessions).
"""

from .metrics import (Counter, DEFAULT_COUNT_BUCKETS, DEFAULT_TIME_BUCKETS,
                      Gauge, Histogram, MetricsRegistry)
from .schema import (ALERT_OPTIONAL, ALERT_REQUIRED, AUDIT_OPTIONAL,
                     AUDIT_REQUIRED, CONTROL_OPTIONAL,
                     CONTROL_REQUIRED, FLIGHT_OPTIONAL, FLIGHT_REQUIRED,
                     PER_QUERY_OPTIONAL, PER_QUERY_REQUIRED, SPAN_OPTIONAL,
                     SPAN_REQUIRED, validate_record, validate_stream)
from .tracker import (InMemoryTracker, JsonlTracker, NoopTracker,
                      PrometheusTextTracker, Span, Tracker, jit_cache_size)
from .alerts import AlertEngine, AlertRule
from .audit import AuditFaults, AuditReport
from .flight import FlightRecorder
from .profile import ProfiledDispatch, profiler_session
from .push import PushTracker
from .trace import SpanNode, TenantTrace, TraceForest, assemble
from .dashboard import (render_audits, render_controls, render_dashboard,
                        render_fleet_header, render_histogram, sparkline,
                        trace_view)

__all__ = [
    "ALERT_OPTIONAL",
    "ALERT_REQUIRED",
    "AUDIT_OPTIONAL",
    "AUDIT_REQUIRED",
    "AlertEngine",
    "AlertRule",
    "AuditFaults",
    "AuditReport",
    "CONTROL_OPTIONAL",
    "CONTROL_REQUIRED",
    "Counter",
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "FLIGHT_OPTIONAL",
    "FLIGHT_REQUIRED",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InMemoryTracker",
    "JsonlTracker",
    "MetricsRegistry",
    "NoopTracker",
    "PER_QUERY_OPTIONAL",
    "PER_QUERY_REQUIRED",
    "PrometheusTextTracker",
    "ProfiledDispatch",
    "PushTracker",
    "SPAN_OPTIONAL",
    "SPAN_REQUIRED",
    "Span",
    "SpanNode",
    "TenantTrace",
    "TraceForest",
    "Tracker",
    "assemble",
    "jit_cache_size",
    "profiler_session",
    "render_audits",
    "render_controls",
    "render_dashboard",
    "render_fleet_header",
    "render_histogram",
    "sparkline",
    "trace_view",
    "validate_record",
    "validate_stream",
]
