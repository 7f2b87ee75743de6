"""One run of one cell: set-up, the measured window, the traced run's
readings, and what the comparison that decides ``correct`` needs.

The window drives ``repro_torch.service.Service.tick()`` ticks back to
back (a closed loop: the next tick starts when the last one's records are
on the host), with the configuration's service knobs and the traffic's
``service`` ones on top.  Before each tick every feed of the traffic queues
its input (``bench/feeds/``).  The graph, the tenants and the feeds are
the generators the configuration and the traffic name.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import check
from . import trace as tr
from .gen import rng_for
from .spec import Cell, plugin

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RECORD_KEYS = ("accuracy", "quiescent", "region", "msgs")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _query_spec(psvc, pregions, t):
    if t.kind == "voronoi":
        region = pregions.VoronoiRegions(torch.from_numpy(t.centers))
    else:
        region = pregions.HalfspaceRegions(w=torch.from_numpy(t.w),
                                           b=torch.tensor(t.b))
    return psvc.QuerySpec(region=region, inputs=t.x, weights=t.weights,
                          beta=t.beta, ell=t.ell, seed=t.seed)


def _span_totals(psvc):
    """A telemetry sink that also sums the seconds of each span name."""
    class SpanTotals(psvc.TelemetrySink):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.totals = {}

        def _finish_span(self, sp):
            total, count = self.totals.get(sp.name, (0.0, 0))
            self.totals[sp.name] = (total + sp.seconds, count + 1)
            super()._finish_span(sp)
    return SpanTotals(max_records=1 << 16)


def _service_config(psvc, cfg, traffic, q):
    """The configuration's service knobs, the traffic's ``service`` ones
    on top (any ``ServiceConfig`` field: ``cycles_per_dispatch``,
    ``backend``, ``audit_every``, ...)."""
    knobs = dict(capacity=q, k_max=int(cfg["k"]), d=int(cfg["d"]),
                 policy=cfg["policy"], drop_rate=float(cfg["drop_rate"]),
                 beta=float(cfg["beta"]), ell=int(cfg["ell"]),
                 eps=float(cfg["eps"]), use_kernels=cfg["suite"],
                 backend="core", overlap=False)
    knobs.update(traffic.get("service", {}))
    return psvc.ServiceConfig(**knobs)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print):
    """Run ``cell`` once: set-up, the warm tick, ``seconds`` of ticks, and
    with ``trace`` the counting pass.  Returns ``(data, run)``: the
    window's readings, which the metric readers take, and what
    :func:`check.judge` compares."""
    from repro_torch import kernels as pk
    from repro_torch import service as psvc
    from repro_torch.core import lss as plss
    from repro_torch.core import regions as pregions
    from repro_torch.core import topology as ptopo
    from repro_torch.kernels import ops as pops

    cfg, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"
    if cuda:
        from repro_torch.kernels import _build
        _build.build()
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # The graph and the deployment.
    n, edges = plugin("topologies", cfg["topology"]["kind"]).edges(
        cfg["topology"])
    topo = ptopo.from_edges(n, edges)
    dyn = traffic.get("dynamic")
    if dyn:
        rows = n + int(n * float(dyn["spare_rows"]))
        svc_topo = ptopo.DynTopology.from_topology(
            topo, n_cap=rows, deg_cap=topo.max_deg + int(dyn["deg_slack"]))
        deg_cap = svc_topo.deg_cap
    else:
        rows, svc_topo, deg_cap = n, topo, topo.max_deg
    D = svc_topo.max_deg
    world = SimpleNamespace(n=n, rows=rows, edges=edges, d=int(cfg["d"]),
                            deg_cap=deg_cap, D=D)
    tenants = plugin("tenants", traffic["tenants"]["gen"]).make(
        cfg, traffic["tenants"], rows, seed)
    q = len(tenants)
    scfg = _service_config(psvc, cfg, traffic, q)
    k = int(scfg.cycles_per_dispatch)
    sink = _span_totals(psvc) if trace else None
    svc = psvc.Service(svc_topo, scfg, tracker=sink, device=device)
    slots = [svc.registry.slot_of(svc.admit(_query_spec(psvc, pregions, t)))
             for t in tenants]

    # The traffic: each feed queues its part of a tick's input.
    feed_specs = traffic.get("feeds", [])
    feeds = [plugin("feeds", f["gen"]).Feed(f, world, seed)
             for f in feed_specs]
    entries = []  # a tick's entries, one a feed, for the reference

    def feed(i):
        entries.append([f(svc, i) for f in feeds])

    records = []
    missing = 0

    def keep(recs):
        nonlocal missing
        by_slot = {r["slot"]: r for r in recs}
        missing += q - sum(s in by_slot for s in slots)
        got = [by_slot.get(s) for s in slots]
        records.append({key: np.array([r[key] if r else np.nan for r in got])
                        for key in RECORD_KEYS})

    # What the run checks, and where it keeps the states it needs.
    plan = check.Plan(rng_for(seed, 40), q, traffic["check"])
    fields = tuple(f for f in plss.LSSState._fields if f != "rng")
    snaps = check.Snapshots(fields)
    ranged = (lambda label: torch.profiler.record_function(f"bench::{label}")
              ) if trace else (lambda label: contextlib.nullcontext())

    def snapshot(key, who):
        with ranged("snapshot"):
            sync()
            t0 = time.perf_counter()
            snaps.take(svc.states, key, [slots[i] for i in who], who)
            return time.perf_counter() - t0

    # The warm tick, then the window.
    feed(0)
    keep(svc.tick())
    sync()
    snapshot(("post", 0), plan.warm)
    reports = [[f.report() for f in feeds]]
    counts = hooks = None
    prof = contextlib.nullcontext()
    if trace:
        hooks = tr.HostRanges(svc, plss)
        hooks.install()
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                          if cuda else [])
        prof = profile(activities=acts)
    sync()
    pk.reset_counts()
    plss.host_syncs = 0
    if sink is not None:
        sink.totals.clear()
    tick_s, checked_ticks = [], {0: 0}  # tick -> its check
    everyone = list(range(q))
    due = list(plan.at)

    with prof as profiler:
        setup_s = time.perf_counter() - t_start
        w0 = time.perf_counter()
        snap_s = 0.0  # the checked ticks' copies, left out of the window
        with ranged("window"):
            i = 1
            while True:
                j = None
                if due and time.perf_counter() - w0 - snap_s >= \
                        due[0] * seconds:
                    due.pop(0)
                    j = len(checked_ticks)
                    snap_s += snapshot(("pre", j), everyone)
                a = time.perf_counter()
                with ranged("traffic"):
                    feed(i)
                with ranged("tick"):
                    recs = svc.tick()
                b = time.perf_counter()
                tick_s.append(b - a)
                if j is not None:
                    snap_s += snapshot(("post", j), everyone)
                    checked_ticks[i] = j
                keep(recs)
                if b - w0 - snap_s >= seconds:
                    break
                i += 1
        window_s = b - w0 - snap_s
        ticks = len(tick_s)
        reports.append([f.report() for f in feeds])
        sync()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        launches = pk.counts()
        host_syncs = plss.host_syncs
        spans = dict(sink.totals) if sink is not None else None
        if trace:
            # The counting pass: the same ticks on, each kernel launch's
            # data-dependent work summed on the device, apart from the
            # window so that the counting costs it nothing.
            counts = tr.KernelCounts(pops, device)
            counts.install()
            pass_ticks, p0 = 0, time.perf_counter()
            with ranged("count_pass"):
                while (pass_ticks < 2 or time.perf_counter() - p0
                       < tr.PASS_SHARE * seconds):
                    i += 1
                    feed(i)
                    keep(svc.tick())
                    pass_ticks += 1
            counts.uninstall()
            sync()
    traced = None
    if trace:
        hooks.uninstall()
        live, viol = counts.totals()
        t_red = time.perf_counter()
        traced = tr.reduce_trace(profiler) if cuda else None
        log(f"[trace] reduced in {time.perf_counter() - t_red:.1f} s; "
            f"counting pass {pass_ticks} ticks, counted launches lss_state "
            f"{counts.n_live}, correction {counts.n_viol}, global "
            f"{counts.n_global}", file=sys.stderr)
    data = SimpleNamespace(
        q=q, k=k, n=rows, D=D, d=int(cfg["d"]), k_max=int(cfg["k"]),
        ticks=ticks, tick_s=tick_s, window_s=window_s, setup_s=setup_s,
        snapshot_s=snap_s, peak_bytes=peak, launches=launches,
        host_syncs=host_syncs, spans=spans, trace=traced)
    if trace:
        data.count_pass = SimpleNamespace(
            ticks=pass_ticks, live=live, viol=viol,
            msgs=int(sum(np.nansum(r["msgs"]) for r in records[ticks + 1:])),
            launches={"lss_state": counts.n_live,
                      "correction": counts.n_viol,
                      "global": counts.n_global})

    # Free the program's state before the reference runs.
    final_tables = None
    if dyn:
        final_tables = tuple(np.asarray(t.cpu()) for t in
                             svc.backend.topo_args())
    svc.close()
    del svc, hooks, prof, profiler
    gc.collect()
    if cuda:
        sync()
        torch.cuda.empty_cache()

    faults = {}
    for f in feeds:
        for name, v in f.faults().items():
            faults[name] = faults.get(name, 0) + v
    run = SimpleNamespace(
        tenants=tenants, world=world, records=records, entries=entries,
        feeds=[plugin("feeds", f["gen"]) for f in feed_specs],
        plan=plan, snaps=snaps, checked_ticks=checked_ticks, k=k,
        k_max=int(cfg["k"]), eps=float(cfg["eps"]), dynamic=bool(dyn),
        final_tables=final_tables, faults=faults, missing=missing,
        reports=reports)
    return data, run


def measure(cell: Cell, data, trace: bool):
    """The cell's metrics: its end-to-end ones, or with ``trace`` its
    per-layer ones, each from its reader; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = plugin("metrics", m["name"]).read(data)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(data):
    """The traced window's device time by operation and idle time by the
    host's activity, ten each, longest first."""
    t = data.trace
    ops = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(t["idle_by_label"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[label, s] for label, s in gaps]}
