"""Per-tenant service-level objectives: specs, evaluation, violation books.

Copy of ``src/repro/service/controlplane/slo.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

A tenant attaches an :class:`SLOSpec` to its :class:`~repro_torch.service.query.
QuerySpec`; the :class:`SLOTracker` evaluates every per-dispatch telemetry
record the service emits against it — no extra device work, the numbers
are the ones the observation pass already computes:

* ``target_accuracy`` within ``within_cycles`` — once the query has been
  *submitted* (not activated: queue wait burns the budget, which is what
  makes the scheduler's priority classes mean something) for at least
  ``within_cycles`` simulator cycles, every dispatch whose accuracy falls
  below the target is a violation.
* ``max_msgs_per_link`` — a per-dispatch-window communication budget in
  the paper's own cost unit (messages per link); a window that sends more
  is a violation.

The tracker keeps per-tenant violation counts and attainment (fraction of
evaluated windows that met the SLO); the scheduler's violation-aware
aging reads the counts, and the service folds the per-window fields into
each telemetry record so the sink carries the SLO trail.

Given a :class:`repro_torch.obs.MetricsRegistry`, the tracker also *publishes*
its books as shared metrics — ``slo_attainment`` / ``slo_evaluated``
gauges and a ``slo_violations_total`` counter, all labeled by query — so
control-plane policies (e.g. :class:`~repro_torch.service.controlplane.
eviction.SLOEvictionPolicy`) and dashboards consume the one metrics
interface instead of reaching into private accounting.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

__all__ = ["SLOSpec", "SLOTracker"]


class SLOSpec(NamedTuple):
    """A tenant's quality target.  All fields optional; ``None`` = don't
    care.  ``priority`` lives on the QuerySpec, not here: scheduling
    class and quality target are orthogonal (a low-priority tenant may
    still declare a target so its attainment is tracked)."""

    target_accuracy: Optional[float] = None  # fraction of peers correct
    within_cycles: Optional[int] = None  # grace cycles after submission
    max_msgs_per_link: Optional[float] = None  # per dispatch window

    def evaluate(self, record: dict, elapsed_cycles: int) -> Dict[str, bool]:
        """Per-window checks -> {check name: ok}.  Empty when nothing is
        due yet (inside the grace window with no msgs budget)."""
        checks: Dict[str, bool] = {}
        if self.target_accuracy is not None:
            due = (self.within_cycles is None
                   or elapsed_cycles >= self.within_cycles)
            if due:
                checks["accuracy_ok"] = (
                    record["accuracy"] >= self.target_accuracy)
        if self.max_msgs_per_link is not None:
            checks["msgs_ok"] = (
                record["msgs_per_link"] <= self.max_msgs_per_link)
        return checks


class _Book(NamedTuple):
    slo: SLOSpec
    submitted_t: int  # cycle count at submission (queue wait counts)


class SLOTracker:
    """Violation / attainment bookkeeping for every tenant with an SLO.

    Bounded: books of retired tenants are kept (attainment stays
    queryable) but the oldest are evicted past ``cap`` entries, mirroring
    the service's terminal-status bound.
    """

    def __init__(self, cap: int = 1 << 16, registry=None):
        self.cap = cap
        self.registry = registry  # optional repro_torch.obs.MetricsRegistry
        self._books: Dict[str, _Book] = {}
        self._violations: Dict[str, int] = {}
        self._evaluated: Dict[str, int] = {}
        self._met: Dict[str, int] = {}

    def _publish(self, query_id: str) -> None:
        """Mirror one tenant's book into the shared metrics registry."""
        if self.registry is None:
            return
        self.registry.gauge(
            "slo_attainment",
            "fraction of evaluated SLO windows met, per query").set(
                self.attainment(query_id), query=query_id)
        self.registry.gauge(
            "slo_evaluated",
            "SLO windows evaluated, per query").set(
                self._evaluated.get(query_id, 0), query=query_id)

    def submit(self, query_id: str, slo: Optional[SLOSpec],
               now_cycles: int) -> None:
        """Start a tenant's SLO clock (at admission, even if queued)."""
        if slo is None:
            return
        self._books[query_id] = _Book(slo, int(now_cycles))
        self._violations[query_id] = 0
        self._evaluated[query_id] = 0
        self._met[query_id] = 0
        for d in (self._books, self._violations, self._evaluated, self._met):
            while len(d) > self.cap:
                d.pop(next(iter(d)))
        self._publish(query_id)

    def observe(self, query_id: str, record: dict) -> Optional[dict]:
        """Evaluate one per-dispatch record; returns the SLO fields to
        fold into it (None when the tenant declared no SLO)."""
        book = self._books.get(query_id)
        if book is None:
            return None
        checks = book.slo.evaluate(record, record["t"] - book.submitted_t)
        ok = all(checks.values())
        if checks:
            self._evaluated[query_id] += 1
            if ok:
                self._met[query_id] += 1
            else:
                self._violations[query_id] += 1
                if self.registry is not None:
                    self.registry.counter(
                        "slo_violations_total",
                        "SLO window violations, per query").inc(
                            1, query=query_id)
            if self.registry is not None:
                # The instantaneous window state (1 = every declared
                # check passed), distinct from the cumulative attainment
                # ratio — this is the series alert rules sustain over.
                self.registry.gauge(
                    "slo_window_ok",
                    "most recent SLO window outcome (1 ok, 0 violated)"
                ).set(1.0 if ok else 0.0, query=query_id)
            self._publish(query_id)
        return {"slo_ok": ok, "slo_violations": self._violations[query_id],
                **checks}

    def observe_waiting(self, query_id: str, now_cycles: int) -> None:
        """Evaluate a tenant that holds NO slot this dispatch (queued or
        preempted).  A query past its accuracy deadline while waiting has
        accuracy 0 by definition — no peer is computing it — so the
        window counts as a violation; inside the grace window nothing is
        due and nothing is recorded.  This is what makes queue wait burn
        the SLO budget (and, through violation-aware aging, what pulls a
        deadline-blown tenant up the queue)."""
        book = self._books.get(query_id)
        if book is None or book.slo.target_accuracy is None:
            return
        elapsed = now_cycles - book.submitted_t
        if (book.slo.within_cycles is not None
                and elapsed < book.slo.within_cycles):
            return
        self._evaluated[query_id] += 1
        self._violations[query_id] += 1
        if self.registry is not None:
            self.registry.counter(
                "slo_violations_total",
                "SLO window violations, per query").inc(1, query=query_id)
        self._publish(query_id)

    def violations(self, query_id: str) -> int:
        return self._violations.get(query_id, 0)

    def attainment(self, query_id: str) -> float:
        """Fraction of evaluated windows that met the SLO (1.0 when none
        were due — an unevaluated SLO is unviolated)."""
        n = self._evaluated.get(query_id, 0)
        return self._met.get(query_id, 0) / n if n else 1.0

    def report(self) -> Dict[str, dict]:
        """Per-tenant summary for every tracked SLO."""
        return {
            qid: {
                "violations": self._violations[qid],
                "evaluated": self._evaluated[qid],
                "attainment": self.attainment(qid),
            }
            for qid in self._books
        }
