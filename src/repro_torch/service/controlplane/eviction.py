"""SLO-driven eviction: a policy that reads the shared metrics registry.

Copy of ``src/repro/service/controlplane/eviction.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

A long queue of waiting tenants whose SLOs are already unrecoverable is
pure backlog: every dispatch they sit there, :meth:`SLOTracker.
observe_waiting` burns more violations and the scheduler ages them ahead
of healthier tenants.  :class:`SLOEvictionPolicy` cuts them loose — any
*waiting* (queued) tenant whose published ``slo_attainment`` gauge has
fallen below a floor after enough evaluated windows is evicted with a
terminal reason, freeing the queue for tenants that can still meet their
targets.

The policy deliberately consumes ONLY the registry the
:class:`~repro_torch.service.controlplane.slo.SLOTracker` publishes into
(``slo_attainment`` / ``slo_evaluated`` gauges) — it has no access to
the tracker's private books, which is the point: any component that
publishes the same metrics could drive it, and any alternative policy
reads the same interface.
"""

from __future__ import annotations

from typing import List, Tuple

__all__ = ["SLOEvictionPolicy"]


class SLOEvictionPolicy:
    """Evict waiting tenants whose SLO attainment is unrecoverable.

    Args:
      registry: the shared :class:`repro_torch.obs.MetricsRegistry`.
      attainment_below: evict when attainment drops below this floor
        (0.0 disables the policy).
      min_windows: evaluated-window count required before a tenant is
        eligible — a fresh tenant's first bad window is not a verdict.
    """

    def __init__(self, registry, attainment_below: float = 0.0,
                 min_windows: int = 4):
        self.registry = registry
        self.attainment_below = float(attainment_below)
        self.min_windows = int(min_windows)

    @property
    def enabled(self) -> bool:
        return self.attainment_below > 0.0

    def victims(self, waiting_ids) -> List[Tuple[str, str]]:
        """(query_id, reason) for every waiting tenant past the floor."""
        if not self.enabled:
            return []
        att = self.registry.get("slo_attainment")
        ev = self.registry.get("slo_evaluated")
        if att is None or ev is None:  # no SLO tenant published yet
            return []
        out: List[Tuple[str, str]] = []
        for qid in waiting_ids:
            a = att.value(query=qid)
            n = ev.value(query=qid)
            if a is None or n is None or n < self.min_windows:
                continue
            if a < self.attainment_below:
                out.append((qid, (
                    f"SLO-driven eviction: attainment {a:.3f} < "
                    f"{self.attainment_below:.3f} after {int(n)} evaluated "
                    f"windows (>= {self.min_windows} required)")))
        return out
