"""Multi-tenant streaming monitor service (port of ``repro.service``).

Q concurrent monitoring queries — each its own region family (Voronoi
source selection or halfspace threshold) plus its own
``beta``/``ell``/``eps`` knobs — share one network graph and advance
through one batched pass per cycle: the query axis is the leading axis of
one stacked :mod:`repro_torch.core.lss` state, and every kernel launches
once for all Q tenants (JAX gets the same from ``vmap``).

Components:

* :class:`QueryRegistry` — fixed-capacity query slots with an active mask;
  admit / retire / replace between dispatches never changes a shape.
* :class:`AdmissionQueue` — bounded backpressure when every slot is taken.
* :class:`StreamIngest` — queued per-peer data-update batches applied to
  the local input vectors between dispatches.
* :class:`Service` — the driver: K cycles per dispatch over all Q slots,
  admission + ingest between dispatches, per-tenant telemetry through a
  :class:`repro_torch.obs.Tracker` (:class:`TelemetrySink` by default).
* :mod:`.controlplane` — per-tenant SLOs, priority scheduling with
  preemption, SLO-driven queue eviction.

Ported: the core and engine backends, synchronous and overlapped
(:mod:`.overlap`: a worker thread per service, staged epoch builds), on a
static topology and under membership churn (:mod:`.membership`), with
the profiling, alert and audit hooks.
"""

from .admission import AdmissionQueue
from .controlplane import ControlPlaneConfig, SLOSpec
from .ingest import StreamIngest, UpdateBatch
from .query import QueryParams, QuerySpec
from .registry import QueryRegistry
from .service import Service, ServiceConfig
from .telemetry import TelemetrySink
from .workload import heterogeneous_tenants

__all__ = [
    "AdmissionQueue",
    "ControlPlaneConfig",
    "QueryParams",
    "QueryRegistry",
    "QuerySpec",
    "SLOSpec",
    "Service",
    "ServiceConfig",
    "StreamIngest",
    "TelemetrySink",
    "UpdateBatch",
    "heterogeneous_tenants",
]
