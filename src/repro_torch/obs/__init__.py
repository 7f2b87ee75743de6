"""Fleet observability for the port (the part of ``repro.obs`` that the
monitor service uses).

Copies of the host-side modules of ``src/repro/obs/``: :mod:`.metrics`
(counter / gauge / histogram registry with Prometheus text exposition),
:mod:`.tracker` (the :class:`Tracker` protocol and its Noop / InMemory /
Jsonl / PrometheusText backends; ``jit_cache_size`` is always None, since
the port has no jit cache) and :mod:`.flight` (the flight-recorder tee).
The rest of ``repro.obs`` (schema, trace assembly, alerts, profiling,
audit, dashboards) is not ported yet (ROADMAP A.7).
"""

from .metrics import (Counter, DEFAULT_COUNT_BUCKETS, DEFAULT_TIME_BUCKETS,
                      Gauge, Histogram, MetricsRegistry)
from .tracker import (InMemoryTracker, JsonlTracker, NoopTracker,
                      PrometheusTextTracker, Span, Tracker, jit_cache_size)
from .flight import FlightRecorder

__all__ = [
    "Counter",
    "DEFAULT_COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InMemoryTracker",
    "JsonlTracker",
    "MetricsRegistry",
    "NoopTracker",
    "PrometheusTextTracker",
    "Span",
    "Tracker",
    "jit_cache_size",
]
