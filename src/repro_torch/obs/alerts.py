"""Alert rules over the metrics registry.

Copy of ``src/repro/obs/alerts.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

The registry's second policy consumer (after SLO-driven eviction): an
:class:`AlertRule` names a metric, a predicate, and a sustain window;
the :class:`AlertEngine` evaluates every rule against every matching
label series at observe boundaries (the service calls it once per
dispatch) and emits ``kind="alert"`` records on state *transitions*:

* ``state="firing"`` — the predicate has held for ``sustain``
  consecutive evaluations (a one-evaluation blip with ``sustain=2``
  never fires);
* ``state="resolved"`` — a firing series stopped matching.

No re-fire while already firing, so a sustained condition costs one
record, not one per dispatch.  Fired alerts also feed the service's
flight-recorder trigger (:mod:`repro_torch.obs.flight`), so the ring is dumped
exactly when the post-mortem context is hottest.

Everything is host-side Python over numbers the registry already holds —
evaluation never touches a device array, preserving the bitwise
tracking-on/off parity contract.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["AlertRule", "AlertEngine"]


class AlertRule(NamedTuple):
    """One alert rule.

    Attributes:
      name: unique rule name (appears in the record and alert key).
      metric: registry metric to watch.  Counter/gauge series are
        compared by value; histogram series by their running mean.
      above: fire when ``value > above``.
      below: fire when ``value < below``.
      predicate: arbitrary ``f(value) -> bool`` (composes with / replaces
        the threshold forms; any provided condition must hold).
      sustain: consecutive matching evaluations required before firing.
      labels: label filter — a series matches when it contains every
        ``(k, v)`` pair (empty = every series; a missing series never
        matches).
      percentile: for histogram metrics, watch this bucketed percentile
        (e.g. ``95.0``) instead of the running mean — tail-latency SLOs
        fire on the tail, not on an average a few fast samples can hide.
        Ignored for counters/gauges.
    """

    name: str
    metric: str
    above: Optional[float] = None
    below: Optional[float] = None
    predicate: Optional[Callable[[float], bool]] = None
    sustain: int = 1
    labels: Tuple[Tuple[str, str], ...] = ()
    percentile: Optional[float] = None

    def matches(self, value: float) -> bool:
        if self.above is not None and not value > self.above:
            return False
        if self.below is not None and not value < self.below:
            return False
        if self.predicate is not None and not self.predicate(value):
            return False
        return self.above is not None or self.below is not None \
            or self.predicate is not None

    def label_filter(self, labels: dict) -> bool:
        return all(labels.get(k) == v for k, v in self.labels)


def _series_values(inst, percentile: Optional[float] = None
                   ) -> Iterator[Tuple[dict, float]]:
    """(labels, scalar) per series: counters/gauges verbatim, histograms
    by running mean — or by the requested bucketed percentile."""
    if isinstance(inst, (Counter, Gauge)):
        yield from inst.series()
    elif isinstance(inst, Histogram):
        for labels, (counts, total) in inst.series():
            n = sum(counts)
            if not n:
                continue
            if percentile is not None:
                v = inst.percentile(percentile, **labels)
                if v is not None:
                    yield labels, v
            else:
                yield labels, total / n


_AlertKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class AlertEngine:
    """Evaluate a rule set against a registry; emit transition records.

    State per ``(rule, label-set)``: a streak counter while matching and
    below sustain, then ``firing`` until the series stops matching.
    """

    def __init__(self, rules, registry: MetricsRegistry):
        self.rules: Tuple[AlertRule, ...] = tuple(rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        self.registry = registry
        self._streak: Dict[_AlertKey, int] = {}
        self._firing: Dict[_AlertKey, bool] = {}
        self.fired_total = 0

    def firing(self) -> List[_AlertKey]:
        return sorted(k for k, on in self._firing.items() if on)

    def evaluate(self, **context) -> List[dict]:
        """One evaluation pass; returns the transition records (possibly
        empty).  ``context`` (e.g. ``dispatch=, t=``) is folded into each
        record."""
        out: List[dict] = []
        for rule in self.rules:
            inst = self.registry.get(rule.metric)
            series = (list(_series_values(inst, rule.percentile))
                      if inst is not None else [])
            seen = set()
            for labels, value in series:
                if not rule.label_filter(labels):
                    continue
                key = (rule.name, tuple(sorted(labels.items())))
                seen.add(key)
                if rule.matches(value):
                    streak = self._streak.get(key, 0) + 1
                    self._streak[key] = streak
                    if streak >= max(1, rule.sustain) \
                            and not self._firing.get(key, False):
                        self._firing[key] = True
                        self.fired_total += 1
                        out.append(self._record(rule, labels, value,
                                                "firing", context))
                else:
                    self._streak[key] = 0
                    if self._firing.get(key, False):
                        self._firing[key] = False
                        out.append(self._record(rule, labels, value,
                                                "resolved", context))
            # A series that disappeared (e.g. retired tenant scrubbed via
            # remove_labels) resolves silently: drop its state.
            for key in [k for k in self._streak
                        if k[0] == rule.name and k not in seen]:
                self._streak.pop(key, None)
                self._firing.pop(key, None)
        return out

    @staticmethod
    def _record(rule: AlertRule, labels: dict, value: float, state: str,
                context: dict) -> dict:
        rec = {"kind": "alert", "rule": rule.name, "metric": rule.metric,
               "value": float(value), "state": state,
               "sustain": int(rule.sustain),
               "labels": {k: str(v) for k, v in sorted(labels.items())}}
        if rule.percentile is not None:
            rec["percentile"] = float(rule.percentile)
        rec.update(context)
        rec.setdefault("dispatch", 0)
        rec.setdefault("t", 0)
        return rec
