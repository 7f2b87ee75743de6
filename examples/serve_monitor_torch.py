"""Multi-tenant monitor service on the PyTorch port: contention, SLOs, and
the control plane.

The twin of ``examples/serve_monitor.py``.  Admits 64 tenants onto a
service provisioned with fewer slots than tenants (contended on purpose):
Voronoi source-selection and halfspace threshold queries in three priority
classes, the high class carrying an accuracy-within-T SLO.  The priority
scheduler preempts and resumes low-priority tenants to keep the high class
inside its SLO; mid-run, a burst of peer joins exhausts the membership
capacity and the control plane regrows it (logged as an epoch).  Prints
per-class SLO attainment, the control-plane activity trail, and the
:mod:`repro_torch.obs` convergence dashboard.  On the GPU (the default)
the dispatch runs the CUDA kernels; ``--device cpu`` the plain PyTorch
formulas:

    PYTHONPATH=src python examples/serve_monitor_torch.py --n 4096 --queries 64
    PYTHONPATH=src python examples/serve_monitor_torch.py --device cpu --n 256 --queries 12 --slots 8 --dispatches 4 --k 4 --joins 6
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import topology
from repro_torch.obs import render_controls, render_dashboard
from repro_torch.service import (ControlPlaneConfig, SLOSpec, Service,
                                 ServiceConfig, TelemetrySink,
                                 heterogeneous_tenants)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--slots", type=int, default=48,
                    help="slot capacity (< queries: contended)")
    ap.add_argument("--dispatches", type=int, default=10)
    ap.add_argument("--k", type=int, default=8, help="cycles per dispatch")
    ap.add_argument("--joins", type=int, default=24,
                    help="peer joins at mid-run (forces a regrow epoch)")
    ap.add_argument("--jsonl", default=None, help="telemetry JSONL path")
    ap.add_argument("--kernels", action="store_true",
                    help="force the fused suite (the CUDA kernels; their "
                         "plain versions on the CPU); by default the "
                         "device picks it")
    ap.add_argument("--plain", action="store_true",
                    help="the reference formulas (no kernel) even on the "
                         "card: the suite the fused one is held to")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda, which raises without "
                         "a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    side = int(round(args.n ** 0.5))
    base = topology.grid(side * side)
    # Tight membership headroom: the mid-run join burst must outgrow it.
    dyn = topology.DynTopology.from_topology(
        base, n_cap=base.n + args.joins // 2, deg_cap=base.max_deg + 2)
    sink = TelemetrySink(path=args.jsonl)
    cp = ControlPlaneConfig(scheduler="priority", preempt=True, aging=0.2,
                            violation_boost=0.5, auto_regrow=True)
    svc = Service(dyn, ServiceConfig(capacity=args.slots, k_max=4, d=2,
                                     cycles_per_dispatch=args.k,
                                     admission_queue=args.queries,
                                     control=cp,
                                     use_kernels=(True if args.kernels
                                                  else False if args.plain
                                                  else None)),
                  telemetry=sink, device=dev)
    info = svc.dispatch_info()
    print(f"dispatch runs the {info['suite']!r} kernel suite"
          f" (fused={info['fused']})")

    # Three priority classes; the high class declares an accuracy SLO.
    slo = SLOSpec(target_accuracy=0.95, within_cycles=4 * args.k)
    classes = {0: [], 1: [], 2: []}
    t0 = time.perf_counter()
    for i, spec in enumerate(heterogeneous_tenants(dyn.n, args.queries)):
        prio = i % 3
        spec = dataclasses.replace(spec, priority=prio,
                                   slo=slo if prio == 2 else None)
        classes[prio].append(svc.admit(spec))
    admit_s = time.perf_counter() - t0
    print(f"admitted {args.queries} tenants into {args.slots} slots on a "
          f"{base.n}-peer grid ({admit_s:.2f}s) — "
          f"{svc.registry.num_active} active, {len(svc.admission)} queued")

    rng = np.random.default_rng(7)
    per_dispatch, walls = [], []
    n_cap = None
    _sync(dev)
    t0 = time.perf_counter()
    for step in range(args.dispatches):
        # Streaming updates land between dispatches (1% of peers).
        who = rng.choice(base.n, size=max(1, base.n // 100), replace=False)
        svc.push_updates(who, rng.normal(size=(who.size, 2)), mode="set")
        if step == args.dispatches // 2:
            # A join burst past n_cap: auto-regrow fires transparently.
            before = dyn.n_cap
            for _ in range(args.joins):
                p = svc.join_peer(value=rng.normal(size=2))
                svc.link_peers(p, int(rng.integers(base.n)))
            n_cap = (before, svc.topo.n_cap)
            print(f"  join burst: n_cap {before} -> {svc.topo.n_cap} "
                  f"(epochs: "
                  f"{[e['kind'] for e in svc.capman.epochs[1:]]})")
        t1 = time.perf_counter()
        records = svc.tick()
        _sync(dev)
        walls.append(time.perf_counter() - t1)
        per_dispatch.append(records)
        done = sum(r["quiescent"] for r in records)
        acc = np.mean([r["accuracy"] for r in records])
        print(f"dispatch {step + 1}: t={svc.cycles}  mean acc={acc:.3f}  "
              f"quiescent {done}/{len(records)}  "
              f"active {svc.registry.num_active}  "
              f"queued {len(svc.admission)}  "
              f"preempted {svc.num_preempted}")
    dt = time.perf_counter() - t0
    qc = args.queries * args.dispatches * args.k
    print(f"{args.dispatches} dispatches x {args.k} cycles x "
          f"{args.queries} tenants in {dt:.2f}s "
          f"({qc / dt:,.0f} query-cycles/s)")

    print("\nper-class mean SLO attainment / final accuracy:")
    last = sink.last_by_query()
    by_class = {}
    for prio, qids in classes.items():
        att = np.mean([svc.slo.attainment(q) for q in qids])
        accs = [last[q]["accuracy"] for q in qids if q in last]
        label = {0: "low", 1: "mid", 2: "high+SLO"}[prio]
        mean_acc = np.mean(accs) if accs else float("nan")
        by_class[prio] = {"attainment": float(att),
                          "accuracy": float(mean_acc),
                          "served": len(accs), "tenants": len(qids)}
        print(f"  class {prio} [{label:>8}] attainment={att:.2f}  "
              f"acc={mean_acc:.3f}  ({len(accs)}/{len(qids)} served)")

    print("\nhigh-class tenants (first 8):")
    report = svc.slo_report()
    for qid in classes[2][:8]:
        rep = report.get(qid, {})
        status = svc.admission_status(qid)
        print(f"  {qid} [{status:>9}] attainment="
              f"{rep.get('attainment', 1.0):.2f} "
              f"violations={rep.get('violations', 0)}")

    ctrl = sink.controls()
    n_pre = sum(len(c.get("preempted", [])) for c in ctrl)
    n_res = sum(len(c.get("resumed", [])) for c in ctrl)
    epochs = [dict(e) for e in svc.capman.epochs]
    print(f"\ncontrol plane: {n_pre} preemptions, {n_res} resumes, "
          f"epochs={[e['kind'] for e in epochs]}")

    # Convergence dashboard straight off the telemetry the service kept.
    print()
    print(render_dashboard(sink.records, sort_by="accuracy"))
    print()
    print(render_controls(sink.records))
    svc.close()  # flushes the (borrowed) sink
    sink.close()
    return {"suite": info["suite"], "fused": info["fused"], "peers": base.n,
            "queries": args.queries, "slots": args.slots, "k": args.k,
            "n_cap": n_cap, "admit_s": admit_s, "serve_s": dt,
            "walls": walls, "query_cycles_per_s": qc / dt,
            "records": per_dispatch, "classes": by_class,
            "slo_report": report, "preemptions": n_pre, "resumes": n_res,
            "epochs": epochs,
            # The control trail without its span timings.
            "controls": [{k: v for k, v in c.items() if k != "spans"}
                         for c in ctrl]}


if __name__ == "__main__":
    main()
