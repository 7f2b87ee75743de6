"""First-violation forensics over a tracker's record stream.

Copy of ``src/repro/obs/forensics.py`` for the port:
host-side Python, kept apart because the port imports nothing of the
JAX package.

When an audit monitor fires, the interesting questions are causal, not
statistical: *which tenant*, *which dispatch span*, *what did the
control plane do just before*?  All of that is already in the record
stream — ``kind="audit"`` records carry the tenant ``trace_id`` and
dispatch ordinal, spans reconstruct into the causal forest
(:mod:`repro_torch.obs.trace`), and control records narrate the boundary.
This module joins them:

* :func:`first_violation` — the earliest failing audit record.
* :func:`provenance` — the join: failing monitors, the last clean audit
  window for the same tenant, the dispatch's span subtree (the tick /
  observe scopes stamped with the same dispatch ordinal), and the
  nearest preceding control-plane event.
* :func:`render` — a text post-mortem in the :mod:`dashboard` idiom.

CLI::

    python -m repro_torch.obs.forensics dump.jsonl [--query q] [--trace]

works on any JSONL record stream — a ``JsonlTracker`` file or a
flight-recorder dump (whose header line is skipped by kind).  Exit
status 1 when a violation was found, 0 on a clean stream, so CI can
gate on it directly.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Iterable, List, Optional

from . import trace as _trace

__all__ = ["audit_records", "first_violation", "provenance", "render",
           "main"]


def audit_records(records: Iterable[dict]) -> List[dict]:
    """The ``kind="audit"`` records of a stream, in stream order."""
    return [r for r in records if r.get("kind") == "audit"]


def first_violation(records: Iterable[dict],
                    query: Optional[str] = None) -> Optional[dict]:
    """The earliest failing audit record (optionally one tenant's).

    Stream order is dispatch order — trackers retain records in emission
    sequence — so the first failing record *is* the first violation.
    """
    for rec in audit_records(records):
        if query is not None and rec.get("query") != query:
            continue
        if not rec.get("ok", True):
            return rec
    return None


def provenance(records: Iterable[dict],
               violation: Optional[dict] = None,
               query: Optional[str] = None) -> Optional[dict]:
    """Join a violation with its causal context.  None = clean stream.

    Returns a dict: ``violation`` (the audit record), ``failed`` (monitor
    names that fired), ``last_clean`` (the tenant's most recent passing
    audit record before it), ``span`` (the root of the dispatch's span
    subtree — the ``tick`` scope stamped with the same dispatch ordinal,
    falling back to any same-dispatch span), ``control`` (the nearest
    preceding control record), and ``tenant`` (the
    :class:`~repro_torch.obs.trace.TenantTrace` timeline).
    """
    recs = list(records)
    if violation is None:
        violation = first_violation(recs, query=query)
    if violation is None:
        return None
    d = violation.get("dispatch")
    q = violation.get("query")
    tid = violation.get("trace_id", "")
    failed = sorted(name for name, held in
                    violation.get("monitors", {}).items() if not held)
    prior = [r for r in audit_records(recs)
             if r.get("query") == q and r.get("dispatch", 0) < d
             and r.get("ok")]
    forest = _trace.assemble(recs)
    tenant = forest.tenant(tid) if tid in forest.trace_ids() else None
    span = None
    pools = ([tenant.nodes] if tenant is not None else []) + [
        list(forest.nodes.values())]
    for pool in pools:
        hits = [n for n in pool if n.attrs.get("dispatch") == d]
        if hits:
            # Prefer the root scope of the dispatch (lowest span id).
            hits.sort(key=lambda n: (n.name != "tick", n.span_id))
            span = hits[0]
            break
    controls = [r for r in recs if r.get("kind") == "control"
                and r.get("dispatch", 0) <= d]
    return {
        "violation": violation,
        "failed": failed,
        "last_clean": prior[-1] if prior else None,
        "span": span,
        "control": controls[-1] if controls else None,
        "tenant": tenant,
    }


def _fmt_attrs(attrs: dict, limit: int = 4) -> str:
    shown = sorted(attrs.items())[:limit]
    body = ", ".join(f"{k}={v}" for k, v in shown)
    if len(attrs) > limit:
        body += ", …"
    return body


def render(prov: Optional[dict], show_trace: bool = False) -> str:
    """Text post-mortem of a :func:`provenance` join."""
    if prov is None:
        return "audit: no violations"
    v = prov["violation"]
    lines = [
        f"first violation: query {v.get('query')} slot {v.get('slot')} "
        f"@ dispatch {v.get('dispatch')} (t={v.get('t')})",
        f"  monitors fired: {', '.join(prov['failed']) or '(none listed)'}",
        f"  residual {v.get('residual', 0.0):.3g} "
        f"(tol {v.get('tol', 0.0):.3g})"
        + (f", edge_bad {v['edge_bad']}" if v.get("edge_bad") else "")
        + (f", stop_bad {v['stop_bad']}" if v.get("stop_bad") else "")
        + (f", seq_bad {v['seq_bad']}" if v.get("seq_bad") else "")
        + (f", ring_bad {v['ring_bad']}" if v.get("ring_bad") else ""),
    ]
    if "claimed_quiescent" in v:
        lines.append(f"  quiescent: claimed {v['claimed_quiescent']}, "
                     f"recomputed {v.get('quiescent')}")
    lc = prov["last_clean"]
    lines.append("  last clean window: "
                 + (f"dispatch {lc['dispatch']} (t={lc['t']})" if lc
                    else "(none — violated from the first audit)"))
    ctrl = prov["control"]
    if ctrl is not None:
        bits = [f"dispatch {ctrl.get('dispatch')}",
                f"queue {ctrl.get('queue_depth')}"]
        for key in ("activated", "resumed", "preempted", "evicted",
                    "epochs"):
            if ctrl.get(key):
                bits.append(f"{key} {len(ctrl[key])}")
        lines.append("  preceding boundary event: " + ", ".join(bits))
    span = prov["span"]
    if span is not None:
        lines.append(f"  dispatch span (trace {v.get('trace_id')}):")
        for depth, node in span.walk():
            pad = "    " + "  " * depth
            line = f"{pad}└─ {node.name} {node.seconds * 1e3:.2f}ms"
            if node.attrs:
                line += f"  [{_fmt_attrs(node.attrs)}]"
            lines.append(line)
    else:
        lines.append("  dispatch span: (no span records in stream)")
    if show_trace and prov["tenant"] is not None:
        from .dashboard import trace_view

        lines.append(trace_view(_forest_of(prov["tenant"]),
                                prov["tenant"].trace_id))
    return "\n".join(lines)


def _forest_of(tenant: "_trace.TenantTrace") -> "_trace.TraceForest":
    """Rebuild a one-tenant forest so trace_view can render it."""
    recs = [_trace._node_rec(n) for n in tenant.nodes]
    for r in recs:
        r["kind"] = "span"
    return _trace.assemble(recs)


def load_jsonl(path: str) -> List[dict]:
    """Parse a JSONL record file, skipping malformed lines."""
    out: List[dict] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.forensics",
        description="Reconstruct first-violation provenance from a JSONL "
                    "record stream (tracker file or flight dump).")
    ap.add_argument("path", help="JSONL record file")
    ap.add_argument("--query", default=None,
                    help="restrict to one tenant's audit records")
    ap.add_argument("--trace", action="store_true",
                    help="append the tenant's full causal timeline")
    args = ap.parse_args(argv)
    recs = load_jsonl(args.path)
    prov = provenance(recs, query=args.query)
    print(render(prov, show_trace=args.trace))
    return 1 if prov is not None else 0


if __name__ == "__main__":  # pragma: no cover - CLI entry
    sys.exit(main())
