"""Telemetry-contract validator: ``python -m repro_torch.obs.validate``.

Copy of ``src/repro/obs/validate.py`` for the port, its churn run served
by the port's :class:`~repro_torch.service.Service` on ``--device`` (the
card by default, as every entry point of the port; ``--device cpu`` runs
the plain PyTorch versions).  Two modes:

* ``python -m repro_torch.obs.validate path.jsonl`` — validate an
  existing telemetry stream (every line must satisfy
  :mod:`repro_torch.obs.schema`).
* ``python -m repro_torch.obs.validate [--device DEV]`` (no path) —
  self-contained contract check: serve a small churn workload (tenant admission, peer
  joins/links, streaming updates, a membership-capacity regrow epoch,
  an alert rule firing) through a :class:`~repro_torch.obs.JsonlTracker`,
  then validate the emitted stream AND assert (a) the host-boundary
  spans (``membership_drain``, ``admission_drain``, ``ingest_apply``,
  ``dispatch``, ``observe``) appear with nonzero timings in a control
  record, (b) the ``kind="span"`` records assemble into a complete
  causal trace forest — no orphan ``parent_id``, every tenant trace id
  rooted at an ``admission`` span with a ``dispatch`` descendant — and
  (c) the audit plane ran (``audit_every=1``): every audited window
  emitted ``kind="audit"`` records and the clean churn run produced
  ZERO invariant violations.

Exit status 0 on a clean stream, 1 with per-line diagnostics otherwise,
so a schema drift or a span that silently stops being emitted fails the
check, not a dashboard.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from typing import List, Optional, Tuple

from .schema import validate_stream

BOUNDARY_SPANS = ("membership_drain", "admission_drain", "ingest_apply",
                  "dispatch", "observe")


def validate_file(path: str) -> List[Tuple[int, str]]:
    """Validate every JSONL line in ``path``; returns (line, problem)."""
    records = []
    problems: List[Tuple[int, str]] = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                problems.append((i, f"not JSON: {e}"))
    problems.extend(validate_stream(records))
    return problems


def _churn_run(path: str, device: Optional[str] = None) -> None:
    """Small end-to-end churn workload emitting telemetry to ``path``,
    served on ``device`` (None: the card)."""
    import numpy as np

    from ..core import topology
    from ..service import Service, ServiceConfig, heterogeneous_tenants
    from . import AlertRule, JsonlTracker

    base = topology.grid(36)
    dyn = topology.DynTopology.from_topology(base, n_cap=base.n + 2,
                                             deg_cap=base.max_deg + 2)
    rng = np.random.default_rng(0)
    # A rule that always fires (depth >= 0) so the stream carries a
    # kind="alert" record through the schema check.
    rules = (AlertRule(name="queue-depth", metric="service_queue_depth",
                       above=-1.0, sustain=1),)
    with JsonlTracker(path, keep=False) as tracker:
        with Service(dyn, ServiceConfig(capacity=4, k_max=3, d=2,
                                        cycles_per_dispatch=4,
                                        profile_dispatch=True, alerts=rules,
                                        audit_every=1),
                     tracker=tracker, device=device) as svc:
            for spec in heterogeneous_tenants(dyn.n, 4):
                svc.admit(spec)
            svc.tick()
            # Churn: a regrow epoch makes room, then joins/links and
            # streaming updates exercise the other boundary paths.
            svc.grow_capacity(n_cap=dyn.n_cap + 8)
            for _ in range(3):
                p = svc.join_peer(value=rng.normal(size=2))
                svc.link_peers(p, int(rng.integers(base.n)))
            who = rng.choice(base.n, size=4, replace=False)
            svc.push_updates(who, rng.normal(size=(who.size, 2)),
                             mode="set")
            svc.tick()
            svc.tick()


def _check_boundary_spans(path: str) -> List[str]:
    """Every boundary span must show up with a nonzero timing."""
    seen = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if rec.get("kind") != "control":
                continue
            for name, secs in rec.get("spans", {}).items():
                seen[name] = max(seen.get(name, 0.0), float(secs))
    return [f"boundary span {name!r} missing or zero in control records "
            f"(saw {seen.get(name)!r})"
            for name in BOUNDARY_SPANS if seen.get(name, 0.0) <= 0.0]


def _check_trace_tree(path: str) -> List[str]:
    """The span records must reconstruct a complete causal forest: no
    orphan parent ids, at least one alert record, and every tenant trace
    rooted at its ``admission`` span with a ``dispatch`` in the tree."""
    from .trace import assemble

    records = [json.loads(line) for line in open(path) if line.strip()]
    problems: List[str] = []
    forest = assemble(records)
    if forest.orphans:
        problems.append(
            f"{len(forest.orphans)} span(s) with unknown parent_id: "
            + ", ".join(f"{n.name}#{n.span_id}" for n in forest.orphans[:5]))
    tids = forest.trace_ids()
    if not tids:
        problems.append("no tenant trace ids found in any span record")
    for tid in tids:
        tree = forest.tenant(tid)
        if not tree.spans_named("admission"):
            problems.append(f"trace {tid!r} has no admission span")
        elif not tree.has_ancestry("dispatch", "admission"):
            problems.append(
                f"trace {tid!r}: no dispatch span with an admission "
                "ancestor — causal chain broken")
    if not any(r.get("kind") == "alert" for r in records):
        problems.append("churn run emitted no kind=\"alert\" record")
    return problems


def _check_audit(path: str) -> List[str]:
    """The audit plane must have run (``audit_every=1``) and the clean
    churn workload must not trip a single invariant monitor — a
    violation here means the algebra itself broke under churn."""
    audits = [json.loads(line) for line in open(path)
              if line.strip() and '"audit"' in line]
    audits = [r for r in audits if r.get("kind") == "audit"]
    problems: List[str] = []
    if not audits:
        problems.append("churn run emitted no kind=\"audit\" record "
                        "(audit plane did not run)")
        return problems
    for r in audits:
        if not r.get("ok", False):
            failed = sorted(m for m, held in r.get("monitors", {}).items()
                            if not held)
            problems.append(
                f"audit violation on clean run: dispatch "
                f"{r.get('dispatch')} query {r.get('query')!r} monitors "
                f"{failed} (residual {r.get('residual')!r} / tol "
                f"{r.get('tol')!r})")
    return problems


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Validate a telemetry JSONL stream, or (no path) "
        "serve a churn run and check its telemetry contract.")
    ap.add_argument("path", nargs="?", help="JSONL stream to validate")
    ap.add_argument("--device", default=None,
                    help="where the churn run serves (default: the card)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.path:
        path, self_check = args.path, False
    else:
        tmp = tempfile.NamedTemporaryFile(suffix=".jsonl", delete=False)
        tmp.close()
        path, self_check = tmp.name, True
        _churn_run(path, args.device)

    problems = validate_file(path)
    messages = [f"line {i}: {msg}" for i, msg in problems]
    if self_check:
        messages.extend(_check_boundary_spans(path))
        messages.extend(_check_trace_tree(path))
        messages.extend(_check_audit(path))

    if messages:
        print(f"telemetry contract FAILED for {path}:", file=sys.stderr)
        for msg in messages:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    n = sum(1 for line in open(path) if line.strip())
    print(f"telemetry contract OK: {n} records validated"
          + (" (self-contained churn run)" if self_check else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
