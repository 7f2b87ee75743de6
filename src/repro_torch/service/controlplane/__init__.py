"""Service control plane: SLOs, priority scheduling, capacity management.

Copy of ``src/repro/service/controlplane/__init__.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

The serving layer (:mod:`repro_torch.service`) made the paper's algorithm a
multi-tenant service; this package makes that service *self-managing*
under heavy traffic:

* :mod:`.slo` — per-tenant service-level objectives evaluated from the
  telemetry the service already computes, with violation/attainment books
  published into the shared :class:`repro_torch.obs.MetricsRegistry`.
* :mod:`.scheduler` — admission-order + preemption policy when the Q
  compiled slots are contended (priority classes, violation-aware aging).
* :mod:`.eviction` — SLO-driven queue eviction: a policy that reads the
  registry the SLO tracker publishes (not its private books).
* :mod:`.capacity` — auto-regrow on membership-capacity exhaustion and
  drift-triggered partition-rebalance epochs.

Everything here is host-side policy over numbers the data plane already
produces; the only device work the control plane ever causes is the
explicitly-priced epoch (regrow / rebalance), which recompiles once.
:class:`ControlPlaneConfig` is the single knob block the service takes
(default: FIFO, no preemption, no auto-regrow, no rebalance — exactly the
pre-control-plane behavior).
"""

from typing import NamedTuple

from .capacity import CapacityManager
from .eviction import SLOEvictionPolicy
from .scheduler import (ActiveView, FifoScheduler, Plan, PriorityScheduler,
                        WaitingView)
from .slo import SLOSpec, SLOTracker

__all__ = [
    "ActiveView",
    "CapacityManager",
    "ControlPlaneConfig",
    "FifoScheduler",
    "Plan",
    "PriorityScheduler",
    "SLOEvictionPolicy",
    "SLOSpec",
    "SLOTracker",
    "WaitingView",
    "make_scheduler",
]


class ControlPlaneConfig(NamedTuple):
    """Control-plane knobs (see the module docstrings for semantics)."""

    scheduler: str = "fifo"  # "fifo" | "priority"
    aging: float = 0.25  # effective priority per dispatch waited
    violation_boost: float = 0.5  # effective priority per SLO violation
    preempt: bool = True  # priority scheduler may suspend active queries
    preempt_margin: float = 1.0  # class gap required to preempt
    auto_regrow: bool = False  # grow() + re-shard instead of raising
    grow_factor: float = 1.5  # capacity growth per regrow epoch
    rebalance_drift: float = 0.0  # cut-frac increase triggering an epoch
    rebalance_check_every: int = 8  # dispatches between drift checks
    evict_attainment_below: float = 0.0  # SLO-driven queue eviction floor
    evict_min_windows: int = 4  # evaluated windows before eligibility


def make_scheduler(cfg: ControlPlaneConfig):
    if cfg.scheduler == "fifo":
        return FifoScheduler()
    if cfg.scheduler == "priority":
        return PriorityScheduler(aging=cfg.aging,
                                 violation_boost=cfg.violation_boost,
                                 preempt=cfg.preempt,
                                 preempt_margin=cfg.preempt_margin)
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
