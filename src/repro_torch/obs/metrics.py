"""Metrics registry: counters, gauges, histograms with label sets.

Copy of ``src/repro/obs/metrics.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

The registry is the *one* telemetry surface every layer shares: the
service publishes dispatch/boundary/convergence numbers into it, the
engine publishes its dispatch spans, the SLO tracker publishes violation
books, and the control-plane policies (SLO-driven eviction, bench
gating, dashboards) *read* it — nobody keeps private accounting.

Everything here is plain host-side Python over numbers the data plane
already computed; no instrument ever touches a device array.  Instruments
are label-aware (``counter.inc(1, query="q0001")`` keeps one series per
label set, Prometheus-style) and idempotent to create: calling
``registry.counter("x")`` twice returns the same object, so producers and
consumers need no shared setup order.

The text exposition (:meth:`MetricsRegistry.prometheus_text`) follows the
Prometheus text format (``# HELP`` / ``# TYPE`` / ``name{labels} value``,
histograms as cumulative ``_bucket``/``_sum``/``_count`` series) so a
scrape-style exporter is a string away.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_TIME_BUCKETS", "DEFAULT_COUNT_BUCKETS"]

# Wall-time buckets (seconds): spans range from ~us host drains to
# multi-second compiles.
DEFAULT_TIME_BUCKETS = (
    1e-5, 1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Small-integer buckets: correction-loop iterations, queue depths.
DEFAULT_COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                         128.0, 256.0)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: dict) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: _LabelKey, extra: Tuple[Tuple[str, str], ...] = ()
                ) -> str:
    items = key + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class _Instrument:
    """Shared label-series bookkeeping."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def remove(self, **labels) -> bool:
        """Drop one label series (e.g. a retired tenant's gauge).
        Returns True if the series existed."""
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({amount}))")
        k = _key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        """Current count for this label set (0.0 if never incremented)."""
        return self._values.get(_key(labels), 0.0)

    def series(self) -> Iterator[Tuple[dict, float]]:
        for k, v in self._values.items():
            yield dict(k), v

    def remove(self, **labels) -> bool:
        return self._values.pop(_key(labels), None) is not None

    def clear(self) -> None:
        self._values.clear()

    def _exposition(self) -> Iterator[str]:
        for k, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"


class Gauge(_Instrument):
    """Last-set value per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._values[_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = _key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> Optional[float]:
        """Current value for this label set (None if never set)."""
        return self._values.get(_key(labels))

    def series(self) -> Iterator[Tuple[dict, float]]:
        for k, v in self._values.items():
            yield dict(k), v

    def remove(self, **labels) -> bool:
        return self._values.pop(_key(labels), None) is not None

    def clear(self) -> None:
        self._values.clear()

    def _exposition(self) -> Iterator[str]:
        for k, v in sorted(self._values.items()):
            yield f"{self.name}{_fmt_labels(k)} {_fmt_value(v)}"


class Histogram(_Instrument):
    """Cumulative-bucket histogram per label set (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        # label key -> [per-bucket counts..., +Inf count], sum
        self._counts: Dict[_LabelKey, List[int]] = {}
        self._sums: Dict[_LabelKey, float] = {}

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        counts = self._counts.get(k)
        if counts is None:
            counts = self._counts[k] = [0] * (len(self.buckets) + 1)
            self._sums[k] = 0.0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sums[k] += float(value)

    def count(self, **labels) -> int:
        counts = self._counts.get(_key(labels))
        return sum(counts) if counts else 0

    def total(self, **labels) -> float:
        return self._sums.get(_key(labels), 0.0)

    def mean(self, **labels) -> Optional[float]:
        n = self.count(**labels)
        return self.total(**labels) / n if n else None

    def percentile(self, p: float, **labels) -> Optional[float]:
        """Prometheus-style bucketed quantile estimate for one label
        series (``0 < p < 100``), or None with no samples.

        The rank is resolved against the cumulative bucket counts and
        linearly interpolated within the chosen bucket (lower edge =
        previous bucket's upper bound, 0 below the first bucket) — the
        same estimate ``histogram_quantile()`` would produce from the
        text exposition, so alert thresholds tested here transfer to a
        real scrape stack.  Ranks landing in the +Inf bucket clamp to
        the highest finite bound: an over-range p99 reads as "at least
        the last bucket edge", never an invented value.
        """
        if not 0.0 < p < 100.0:
            raise ValueError(f"percentile must be in (0, 100), got {p}")
        counts = self._counts.get(_key(labels))
        n = sum(counts) if counts else 0
        if not n:
            return None
        rank = p / 100.0 * n
        cum = 0
        lo = 0.0
        for ub, c in zip(self.buckets, counts):
            prev = cum
            cum += c
            if cum >= rank:
                if not c:
                    return float(ub)
                frac = (rank - prev) / c
                return float(lo + (ub - lo) * min(max(frac, 0.0), 1.0))
            lo = ub
        return float(self.buckets[-1]) if self.buckets else None

    def p50(self, **labels) -> Optional[float]:
        return self.percentile(50.0, **labels)

    def p95(self, **labels) -> Optional[float]:
        return self.percentile(95.0, **labels)

    def p99(self, **labels) -> Optional[float]:
        return self.percentile(99.0, **labels)

    def series(self) -> Iterator[Tuple[dict, Tuple[List[int], float]]]:
        for k, counts in self._counts.items():
            yield dict(k), (list(counts), self._sums[k])

    def remove(self, **labels) -> bool:
        k = _key(labels)
        self._sums.pop(k, None)
        return self._counts.pop(k, None) is not None

    def clear(self) -> None:
        self._counts.clear()
        self._sums.clear()

    def _exposition(self) -> Iterator[str]:
        for k, counts in sorted(self._counts.items()):
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                yield (f"{self.name}_bucket"
                       f"{_fmt_labels(k, (('le', _fmt_value(ub)),))} {cum}")
            cum += counts[-1]
            yield f"{self.name}_bucket{_fmt_labels(k, (('le', '+Inf'),))} {cum}"
            yield f"{self.name}_sum{_fmt_labels(k)} {_fmt_value(self._sums[k])}"
            yield f"{self.name}_count{_fmt_labels(k)} {cum}"


def _fmt_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Named instruments, created on first use and shared thereafter."""

    def __init__(self):
        self._metrics: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._metrics.get(name)
        if inst is None:
            inst = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(inst, cls):
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def collect(self) -> Iterator[_Instrument]:
        for name in sorted(self._metrics):
            yield self._metrics[name]

    def remove_labels(self, **labels) -> int:
        """Drop one label series from EVERY instrument (e.g. scrub a
        retired tenant's per-query series).  Returns series removed."""
        return sum(1 for inst in self._metrics.values()
                   if inst.remove(**labels))

    def prometheus_text(self) -> str:
        """Text-exposition snapshot of every instrument (scrape format)."""
        lines: List[str] = []
        for inst in self.collect():
            if inst.help:
                lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            lines.extend(inst._exposition())
        return "\n".join(lines) + ("\n" if lines else "")
