"""Admission-order and preemption policy under slot contention.

Copy of ``src/repro/service/controlplane/scheduler.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

The registry's Q slots are a compiled-shape resource; when demand
exceeds them the service has two levers: *which* waiting query activates
when a slot frees, and whether a waiting query may *preempt* an active
one.  Both decisions run host-side at dispatch boundaries (and at
retires) over plain views of the queue/slot state — the scheduler never
touches device arrays, so policy changes cannot recompile anything.

Policies:

* :class:`FifoScheduler` — arrival order, never preempts.  Exactly the
  pre-control-plane behavior (the default).
* :class:`PriorityScheduler` — effective priority =
  ``priority + aging * dispatches_waited + violation_boost * violations``.
  Waiting queries (queued or previously preempted) activate
  highest-effective-priority first; when the queue still holds a query
  whose effective priority clears a running query's *class* by
  ``preempt_margin``, the lowest-class running query is preempted — its
  state is snapshotted (the service keeps it core-layout, partition
  independent) and it re-enters the waiting pool, aging like everyone
  else, so starvation is impossible for any positive ``aging``.
"""

from __future__ import annotations

from typing import List, NamedTuple

__all__ = ["ActiveView", "WaitingView", "Plan", "FifoScheduler",
           "PriorityScheduler"]


class ActiveView(NamedTuple):
    """Scheduler-facing summary of one running query."""

    query_id: str
    priority: int
    violations: int
    activated_dispatch: int


class WaitingView(NamedTuple):
    """Summary of one waiting query (admission queue or preempted pool)."""

    query_id: str
    priority: int
    violations: int
    enqueued_dispatch: int
    preempted: bool  # resuming, not first activation


class Plan(NamedTuple):
    """One boundary's decisions, applied by the service in order:
    ``preempt`` first (frees slots), then ``admit`` while slots last."""

    admit: List[str]
    preempt: List[str]


class FifoScheduler:
    """Arrival order, no preemption (the pre-control-plane behavior)."""

    def plan(self, active: List[ActiveView], waiting: List[WaitingView],
             free_slots: int, now_dispatch: int) -> Plan:
        # Stable sort: same-dispatch arrivals keep their true arrival
        # order (the service builds `waiting` queue-first, in order).
        order = sorted(waiting, key=lambda w: w.enqueued_dispatch)
        return Plan(admit=[w.query_id for w in order[:free_slots]],
                    preempt=[])


class PriorityScheduler:
    """Priority classes with wait/violation aging and optional preemption.

    ``aging`` converts dispatches waited into effective priority (any
    positive value bounds starvation); ``violation_boost`` converts a
    tenant's recorded SLO violations likewise, so a query that is failing
    its SLO *because* it cannot get a slot climbs the queue.
    ``preempt_margin`` is the gap (in priority units) a waiting query's
    effective priority must clear a victim's class before the victim is
    suspended — at 0 equal-class queries would thrash slots.
    """

    def __init__(self, aging: float = 0.25, violation_boost: float = 0.5,
                 preempt: bool = True, preempt_margin: float = 1.0):
        if aging < 0 or violation_boost < 0:
            raise ValueError("aging/violation_boost must be >= 0")
        self.aging = aging
        self.violation_boost = violation_boost
        self.preempt = preempt
        self.preempt_margin = preempt_margin

    def effective(self, w: WaitingView, now_dispatch: int) -> float:
        waited = max(0, now_dispatch - w.enqueued_dispatch)
        return (w.priority + self.aging * waited
                + self.violation_boost * w.violations)

    def plan(self, active: List[ActiveView], waiting: List[WaitingView],
             free_slots: int, now_dispatch: int) -> Plan:
        if not waiting:
            return Plan(admit=[], preempt=[])
        # Stable sort: equal effective priorities fall back to arrival
        # order (the service builds `waiting` queue-first, in order).
        order = sorted(
            waiting,
            key=lambda w: (-self.effective(w, now_dispatch),
                           w.enqueued_dispatch))
        admit = [w.query_id for w in order[:free_slots]]
        preempts: List[str] = []
        if self.preempt:
            # Victims: lowest class first; ties broken against the most
            # recently activated (it has the least sunk convergence work).
            victims = sorted(active, key=lambda a: (a.priority,
                                                    -a.activated_dispatch,
                                                    a.query_id))
            for cand in order[free_slots:]:
                if not victims:
                    break
                v = victims[0]
                if (self.effective(cand, now_dispatch)
                        < v.priority + self.preempt_margin):
                    break  # candidates only get weaker from here
                victims.pop(0)
                preempts.append(v.query_id)
                admit.append(cand.query_id)
        return Plan(admit=admit, preempt=preempts)
