"""Text convergence dashboards over a tracker's record stream.

Copy of ``src/repro/obs/dashboard.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

Turns the per-query records a :class:`~repro_torch.obs.tracker.Tracker`
retained (or any parsed JSONL list) into a fleet-level text view: one
row per tenant with an accuracy-trajectory sparkline, quiescence state,
message cost, and SLO standing, plus a control-activity tail, a
registry-histogram bar view (:func:`render_histogram`), and the causal
per-tenant timeline (:func:`trace_view`, over
:func:`repro_torch.obs.trace.assemble`).  Renderers are pure (records in,
string out) so they work equally on a live ``InMemoryTracker``, a
``JsonlTracker``, a flight-recorder dump, or a replayed file — and they
degrade to placeholders on empty or single-sample series instead of
raising.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Union

__all__ = ["sparkline", "render_dashboard", "render_fleet_header",
           "render_controls", "render_histogram", "render_audits",
           "trace_view"]

_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Iterable[float], width: int = 24,
              lo: Optional[float] = 0.0, hi: Optional[float] = 1.0) -> str:
    """Unicode block sparkline of a trajectory, resampled to ``width``.

    ``lo`` / ``hi`` fix the range (defaults suit 0..1 accuracies); pass
    ``None`` for either to auto-range on the data.  Degenerate series
    degrade instead of raising: empty input renders a placeholder and a
    flat (min == max) auto-ranged series renders mid-blocks.
    """
    vals = [float(v) for v in values]
    if not vals:
        return "·" * min(width, 3)
    if len(vals) > width:
        # Tail-biased resample: the most recent point always survives.
        step = len(vals) / width
        vals = [vals[min(int(i * step), len(vals) - 1)]
                for i in range(width - 1)] + [vals[-1]]
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    if not hi > lo:
        # Flat series: no slope to draw — a run of mid-blocks keeps the
        # row aligned without implying a trajectory.
        return _BLOCKS[len(_BLOCKS) // 2] * len(vals)
    span = hi - lo
    out = []
    for v in vals:
        frac = min(max((v - lo) / span, 0.0), 1.0)
        out.append(_BLOCKS[min(int(frac * len(_BLOCKS)), len(_BLOCKS) - 1)])
    return "".join(out)


def _by_query(records: Iterable[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for r in records:
        q = r.get("query")
        if q is not None:
            out.setdefault(q, []).append(r)
    return out


def render_fleet_header(records: List[dict]) -> str:
    """One-line fleet summary: tenants, quiesced fraction, msgs/link."""
    hist = _by_query(records)
    if not hist:
        return "fleet: no per-query records"
    last = {q: rs[-1] for q, rs in hist.items()}
    n = len(last)
    quiesced = sum(1 for r in last.values() if r.get("quiescent"))
    acc = sum(r.get("accuracy", 0.0) for r in last.values()) / n
    mpl = sum(r.get("msgs_per_link", 0.0) for r in last.values())
    t = max(r.get("t", 0) for r in last.values())
    return (f"fleet @ t={t}: {n} tenants, {quiesced}/{n} quiescent, "
            f"mean accuracy {acc:.3f}, msgs/link {mpl:.3f}")


def _quiesce_time(rs: List[dict]) -> Optional[int]:
    """Cycle count at which the tenant quiesced and stayed quiesced."""
    t = None
    for r in rs:
        if r.get("quiescent"):
            if t is None:
                t = r.get("t")
        else:
            t = None
    return t


def render_dashboard(records: List[dict], width: int = 24,
                     sort_by: str = "query") -> str:
    """Per-tenant table: accuracy sparkline + convergence/cost columns.

    ``sort_by``: ``"query"`` (id order) or ``"accuracy"`` (worst first).
    """
    hist = _by_query(records)
    if not hist:
        return "no per-query records"
    rows = []
    for q, rs in hist.items():
        last = rs[-1]
        accs = [r.get("accuracy", 0.0) for r in rs]
        qt = _quiesce_time(rs)
        slo = ""
        if "slo_ok" in last:
            slo = ("ok" if last["slo_ok"] else
                   f"VIOL x{last.get('slo_violations', 0)}")
        rows.append((q, last.get("accuracy", 0.0), sparkline(accs, width),
                     "yes" if last.get("quiescent") else "no",
                     "-" if qt is None else str(qt),
                     last.get("msgs_per_link", 0.0), slo))
    if sort_by == "accuracy":
        rows.sort(key=lambda r: r[1])
    else:
        rows.sort(key=lambda r: r[0])
    qw = max(5, max(len(r[0]) for r in rows))
    lines = [render_fleet_header(records),
             f"{'query':<{qw}}  {'accuracy':<{width}}  {'acc':>6}  "
             f"{'quiet':>5}  {'t_q':>6}  {'msg/lnk':>8}  slo"]
    for q, acc, spark, quiet, qt, mpl, slo in rows:
        lines.append(f"{q:<{qw}}  {spark:<{width}}  {acc:>6.3f}  "
                     f"{quiet:>5}  {qt:>6}  {mpl:>8.3f}  {slo}")
    return "\n".join(lines)


def render_controls(records: List[dict], tail: int = 5) -> str:
    """The last few control records as activity lines."""
    ctrl = [r for r in records if r.get("kind") == "control"]
    if not ctrl:
        return "control: no activity"
    lines = []
    for r in ctrl[-tail:]:
        bits = [f"dispatch {r.get('dispatch')}",
                f"queue {r.get('queue_depth')}",
                f"preempted {r.get('preempted_depth')}"]
        for key in ("activated", "resumed", "preempted", "evicted",
                    "epochs"):
            if r.get(key):
                bits.append(f"{key} {len(r[key])}")
        if r.get("spans"):
            busiest = max(r["spans"].items(), key=lambda kv: kv[1])
            bits.append(f"spans {len(r['spans'])} "
                        f"(max {busiest[0]} {busiest[1] * 1e3:.2f}ms)")
        lines.append("control: " + ", ".join(bits))
    return "\n".join(lines)


def render_audits(records: List[dict], tail: int = 5) -> str:
    """Audit-plane summary: window/violation counts + the last few
    verdicts (failing windows take precedence over clean ones)."""
    auds = [r for r in records if r.get("kind") == "audit"]
    if not auds:
        return "audit: no records"
    bad = [r for r in auds if not r.get("ok", True)]
    lines = [f"audit: {len(auds)} windows, {len(bad)} violations"]
    for r in (bad or auds)[-tail:]:
        failed = sorted(m for m, held in r.get("monitors", {}).items()
                        if not held)
        verdict = "ok" if r.get("ok", True) else "VIOL " + ",".join(failed)
        lines.append(f"  d{r.get('dispatch')} {r.get('query')}: {verdict}  "
                     f"resid {r.get('residual', 0.0):.2g}"
                     f"/{r.get('tol', 0.0):.2g}")
    return "\n".join(lines)


def render_histogram(hist, width: int = 32, **labels) -> str:
    """ASCII bar view of one registry histogram label series.

    Safe on degenerate input: a missing / empty series renders a
    placeholder line, an all-in-one-bucket series renders one full bar.
    """
    if hist is None:
        return "histogram: (none)"
    counts = None
    for lbls, (cts, _total) in hist.series():
        if lbls == {k: str(v) for k, v in labels.items()}:
            counts = cts
            break
    if counts is None or not sum(counts):
        return f"{hist.name}: no samples"
    peak = max(counts)
    edges = [f"<= {ub:g}" for ub in hist.buckets] + ["+Inf"]
    ew = max(len(e) for e in edges)
    lines = [f"{hist.name} ({sum(counts)} samples)"]
    for edge, c in zip(edges, counts):
        if not c:
            continue
        bar = "█" * max(1, round(width * c / peak))
        lines.append(f"  {edge:>{ew}}  {bar} {c}")
    return "\n".join(lines)


def _fmt_attrs(attrs: dict, limit: int = 4) -> str:
    shown = sorted(attrs.items())[:limit]
    body = ", ".join(f"{k}={v}" for k, v in shown)
    if len(attrs) > limit:
        body += ", …"
    return body


def trace_view(records_or_forest: Union[Iterable[dict], "object"],
               trace_id: Optional[str] = None, attrs_limit: int = 4) -> str:
    """Render per-tenant causal timelines from span records.

    Accepts a record iterable (tracker ``.records``, parsed JSONL, a
    flight dump) or an already-assembled
    :class:`~repro_torch.obs.trace.TraceForest`.  ``trace_id`` narrows to one
    tenant; default renders every tenant in first-seen order.
    """
    from . import trace as _trace

    forest = (records_or_forest
              if isinstance(records_or_forest, _trace.TraceForest)
              else _trace.assemble(records_or_forest))
    tids = [trace_id] if trace_id is not None else forest.trace_ids()
    if not tids:
        return "trace: no tenant spans"
    lines: List[str] = []
    for tid in tids:
        tt = forest.tenant(tid)
        if not tt.nodes:
            lines.append(f"trace {tid}: no spans")
            continue
        total_ms = sum(r.seconds for r in tt.roots) * 1e3
        lines.append(f"trace {tid} — {len(tt.nodes)} spans, "
                     f"{total_ms:.2f}ms")
        for root in tt.roots:
            for depth, node in root.walk():
                pad = "  " * depth
                line = f"{pad}└─ {node.name} {node.seconds * 1e3:.2f}ms"
                if node.attrs:
                    line += f"  [{_fmt_attrs(node.attrs, attrs_limit)}]"
                lines.append(line)
    if forest.orphans:
        lines.append(f"⚠ {len(forest.orphans)} orphan spans "
                     f"(parent never recorded)")
    return "\n".join(lines)
