"""The port's engine-backed monitor service against the JAX package's.

``repro_torch.service.Service(backend="engine")`` stacks Q tenants on a
leading axis of the sharded state, ``(Q, S, B, ...)``, and steps them
through one engine cycle a step (each kernel, or its plain version on the
CPU, called once for all of them).  It is driven in lockstep with
``repro.service.Service(backend="engine")`` through the same calls: static
graphs and ``DynTopology`` churn, the four halo wires, regrow and
rebalance epochs (forced, automatic and drift-triggered) and a
preemption.  Records must be equal as dicts; so must the per-slot
do-while iteration counts, the message totals and the control records
without their span timings.  Snapshots (the core layout) compare int and
bool fields exactly and float moments to rtol 1e-5 / atol 1e-5; ``rng``
is never compared (an epoch or a restore re-derives the per-shard drop
generators in both packages).  On the ``int8`` and ``bf16`` wires the halo
values are only ``allclose`` across the packages, so an int8 code could
flip by one quantum: the stacked states are compared after every dispatch
with such flips counted and printed, and the records must still be equal.

The port's engine backend is also held to its own core backend (records
exact, and the same kernel calls and host reads a dispatch), the epoch
schedule of ``test_controlplane.py::test_property_epochs_midserve_cycle_
exact`` (which fails in JAX, ROADMAP C.3) to the port's own epoch-free run
on fixed seeds, and the exchange's and the engine's tenant axis to
per-tenant calls, with Q == S and Q != S (a transpose of the wrong axes
would swap tenants with shards and still fit).  Drop rate 0 throughout.
"""

import numpy as np
import pytest
import torch

from repro.core import topology as j_top
from repro_torch import kernels
from repro_torch.core import lss as t_lss
from repro_torch.core import topology as t_top
from repro_torch.engine import EngineConfig, ShardedLSS
from repro_torch.engine import exchange as t_ex
from repro_torch.kernels import suite as t_suite
from repro_torch.service import ControlPlaneConfig as TControl
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from test_torch_formulas import assert_close, assert_exact
from test_torch_membership import REGROW, SCHEDULE, DynPair, _churn, \
    _events, _padded
from test_torch_service import _port_spec, _problem, _tenants, _voronoi
from test_torch_wire import _compare_quantized, _jax_fields, _quantum

ENGINE = dict(backend="engine", engine_shards=2)
GRAPHS = {"grid": (j_top.grid, t_top.grid, 36),
          "chord": (j_top.chord, t_top.chord, 48)}


class EnginePair(DynPair):
    """:class:`DynPair` over any pair of equal graphs (static or dynamic)
    built by the caller."""

    def __init__(self, jtopo, ttopo, suite="reference", **cfg):
        from repro.service import ControlPlaneConfig as JControl
        from repro.service import Service as JService
        from repro.service import ServiceConfig as JConfig

        control = cfg.pop("control", None)
        self.jdyn, self.tdyn = jtopo, ttopo
        self.j = JService(jtopo, JConfig(
            **cfg, **({"control": JControl(**control)} if control else {})))
        self.t = TService(ttopo, TConfig(
            **cfg, use_kernels=suite,
            **({"control": TControl(**control)} if control else {})),
            device="cpu")

    def tick(self):
        if self.t._present is not None:
            return super().tick()
        want, got = self.j.tick(), self.t.tick()
        assert got == want
        assert_exact(self.t._corr_iters, np.asarray(self.j._corr_iters),
                     "per-slot do-while iterations")
        return got


def _port_twin(graph, **cfg):
    """A port-only service over ``graph`` (the port's own references)."""
    control = cfg.pop("control", None)
    return TService(graph, TConfig(
        **cfg, **({"control": TControl(**control)} if control else {})),
        device="cpu")


def _dyn(n, n_cap, deg_cap, **kw):
    return t_top.DynTopology.from_topology(t_top.grid(n), n_cap=n_cap,
                                           deg_cap=deg_cap, **kw)


# -- the engine backend against JAX's ---------------------------------------

@pytest.mark.parametrize("graph,shards,q,wire,suite", [
    ("grid", 2, 2, "exact", "reference"),
    ("chord", 3, 4, "compact", "fused"),
])
def test_tenants_match_jax(graph, shards, q, wire, suite):
    """One tenant, then heterogeneous tenants with per-slot knobs (Q == S
    and Q != S; Q = 3 == S in the quantized cases), on the ``exact`` and
    ``compact`` wires: records,
    iterations, snapshots and totals equal JAX's at every dispatch, and a
    ``compact`` run gives the ``exact`` wire's records."""
    jmake, tmake, n = GRAPHS[graph]
    cfg = dict(capacity=q, k_max=4, d=2, cycles_per_dispatch=3,
               backend="engine", engine_shards=shards, engine_wire=wire)
    specs = _tenants(n, q)
    twin = _port_twin(tmake(n), **{**cfg, "engine_wire": "exact"})
    with EnginePair(jmake(n), tmake(n), suite, **cfg) as pair:
        qids = [pair.admit(specs[0])]
        twin.admit(_port_spec(specs[0]))
        for tick in range(6):
            if tick == 2:
                qids += [pair.admit(s) for s in specs[1:]]
                for s in specs[1:]:
                    twin.admit(_port_spec(s))
            recs = pair.tick()
            assert twin.tick() == recs
            pair.check_snapshots(qids, f"tick {tick}")
        assert len(recs) == q and "slo_ok" in recs[0]
        assert pair.t.slo_report() == pair.j.slo_report()
        assert pair.t.dispatch_info()["fused"] == (suite == "fused")
    twin.close()


@pytest.mark.parametrize("wire", ["int8", "bf16"])
def test_quantized_wires_match_jax(wire, capsys):
    """Three mixed tenants on an ``int8`` / ``bf16`` wire: records equal
    JAX's; the stacked states (error feedback included) equal JAX's after
    every dispatch, received halo values and error buffers within one
    quantum where not close (flips counted and printed)."""
    n = 49
    with EnginePair(j_top.grid(n), t_top.grid(n), capacity=3, k_max=4,
                    d=2, cycles_per_dispatch=3, backend="engine",
                    engine_shards=3, engine_wire=wire) as pair:
        qids = [pair.admit(s) for s in _tenants(n, 3)]
        flips = 0
        for tick in range(6):
            jfields = _jax_fields(pair.j.states)
            quantum = (_quantum(jfields) if wire == "int8" else
                       2.0 ** -8 * max(np.abs(jfields["out_m"]).max(), 1.0))
            pair.tick()
            got = {f: getattr(pair.t.states, f).numpy()
                   for f in _jax_fields(pair.j.states)}
            flips += _compare_quantized(got, _jax_fields(pair.j.states),
                                        quantum, f"{wire} tick {tick}")
        pair.check_snapshots(qids)
        assert float(pair.t.states.wire_err_m.abs().max()) > 0
    with capsys.disabled():
        print(f"\n[service {wire}] quantum flips over 18 cycles: {flips}")


def test_membership_schedule_matches_jax_and_core():
    """tests/test_membership.py:275 on the engine backend, with a later
    unlink whose freed slot a link claims again: records, iterations,
    snapshots, tables and control records equal JAX's at every dispatch,
    and the records equal the port's core backend's."""
    n_cap, k = 40, 3
    centers, x = _problem(n_cap, seed=4)
    core = _port_twin(_dyn(36, n_cap, 6, strict=True), capacity=3, k_max=3,
                      d=2, cycles_per_dispatch=k)
    with DynPair(36, n_cap, 6, strict=True, capacity=3, k_max=3, d=2,
                 cycles_per_dispatch=k, **ENGINE) as pair:
        qa = pair.admit(_voronoi(centers, x, seed=0))
        qb = pair.admit(_tenants(n_cap, 2)[1])
        core.admit(_port_spec(_voronoi(centers, x, seed=0)))
        core.admit(_port_spec(_tenants(n_cap, 2)[1]))
        for disp in range(7):
            _events(pair, SCHEDULE.get(disp, []))
            _events(_Single(core), SCHEDULE.get(disp, []))
            assert pair.tick() == core.tick()
            pair.check_snapshots([qa, qb], f"dispatch {disp}")
            pair.check_topology()
        controls = pair.check_controls()
    core.close()
    drained = [c["dispatch"] for c in controls
               if c.get("boundary", {}).get("membership_events")]
    assert drained == [2, 3, 5, 6]


class _Single:
    """One service in the pair protocol of :func:`_events` and
    :func:`_churn`."""

    def __init__(self, svc):
        self.svc = self.t = svc

    def both(self, method, *args, **kw):
        return getattr(self.svc, method)(*args, **kw)

    def tick(self):
        return self.svc.tick()


def test_auto_regrow_midserve_matches_jax_and_large():
    """tests/test_controlplane.py:333 on the engine backend: the service
    that outgrows n_cap mid-serve (an auto-regrow epoch: re-partition and
    migration) equals JAX's through the epoch and emits what a port
    service provisioned large from the start emits."""
    n1, n2 = 26, 29
    centers, x = _problem(n1, seed=7)

    def spec(n):
        from repro.core import regions as j_regions
        from repro.service import QuerySpec as JSpec
        xx, w = _padded(x, n)
        return JSpec(region=j_regions.VoronoiRegions(centers), inputs=xx,
                     weights=w, seed=0)

    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2, **ENGINE)
    large = _port_twin(_dyn(25, n2, 5), **cfg)
    large.admit(_port_spec(spec(n2)))
    with DynPair(25, n1, 5, control={"auto_regrow": True,
                                     "grow_factor": 1.12}, **cfg) as a:
        qa = a.admit(spec(n1))
        for disp in range(5):
            _events(a, REGROW.get(disp, []))
            _events(_Single(large), REGROW.get(disp, []))
            (ra,) = a.tick()
            (rb,) = large.tick()
            assert (ra["msgs"], ra["quiescent"]) == (rb["msgs"],
                                                     rb["quiescent"]), disp
            assert abs(ra["accuracy"] - rb["accuracy"]) <= 1e-7
        assert a.t.topo.n_cap >= 29
        assert [e["kind"] for e in a.t.capman.epochs] == ["init", "regrow"]
        assert any(c.get("epochs") for c in a.check_controls())
        a.check_snapshots([qa])
        a.check_topology()
        sa = a.t.snapshot(qa)
        sb = large.snapshot(next(iter(large.registry._slot_of)))
        n, D = min(sa.alive.shape[0], 29), min(sa.out_c.shape[-1], 5)
        assert_close(sa.out_m[:n, :D], sb.out_m[:n, :D])
        assert torch.equal(sa.alive[:n], sb.alive[:n])
        assert torch.equal(sa.pending[:n, :D], sb.pending[:n, :D])
    large.close()


def _rebalance_run(pair, epochs):
    """tests/test_controlplane.py:379's schedule with links across the
    shards at dispatch 1 (they raise the cut fraction): churn at dispatch
    2, the forced epoch at 3 (with ``epochs``); returns the records."""
    out = []
    for disp in range(6):
        if disp == 1:
            _events(pair, [("link", (0, 35), None), ("link", (5, 30), None),
                           ("link", (2, 33), None)])
        if disp == 2:
            _events(pair, [("join", (36,), [0.2, 0.2]),
                           ("link", (36, 7), None), ("leave", (12,), None)])
        if disp == 3 and epochs:
            ev = pair.both("rebalance_now")
            assert ev["kind"] == "rebalance" and ev["staged"] is False
        out.append(pair.tick())
        if epochs:
            assert pair.both("drift") == pair.j.drift()
    return out


def test_rebalance_epochs_match_jax_and_epoch_free_run():
    """Rebalance epochs mid-serve: ``control.rebalance_drift`` fires one by
    itself at a boundary (after the membership drain, as in JAX) once the
    cross-shard links raise the drift, and ``rebalance_now`` forces
    another.  Records, drift, epoch records and snapshots equal JAX's,
    and the records equal the same run without epochs (its snapshot
    allclose)."""
    centers, x = _problem(40, seed=9)
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2, **ENGINE)
    plain = _Single(_port_twin(_dyn(36, 40, 6), **cfg))
    qb = plain.svc.admit(_port_spec(_voronoi(centers, x, seed=0)))
    recs_b = _rebalance_run(plain, False)
    with DynPair(36, 40, 6, control={"rebalance_drift": 0.01,
                                     "rebalance_check_every": 1},
                 **cfg) as pair:
        qa = pair.admit(_voronoi(centers, x, seed=0))
        recs_a = _rebalance_run(pair, True)
        pair.check_snapshots([qa])
        assert any(c.get("epochs") for c in pair.check_controls())
        kinds = [e["kind"] for e in pair.t.capman.epochs]
        assert kinds == [e["kind"] for e in pair.j.capman.epochs]
        assert kinds[0] == "init" and kinds.count("rebalance") >= 2
        spans = [r["name"] for r in pair.t.telemetry.records
                 if r.get("kind") == "span"]
        sa = pair.t.snapshot(qa)
    assert spans.count("epoch_rebalance") == kinds.count("rebalance")
    assert recs_a == recs_b
    sb = plain.svc.snapshot(qb)
    for f in t_lss.LSSState._fields:
        if f in ("rng", "msgs"):
            continue
        (assert_close if getattr(sa, f).is_floating_point()
         else assert_exact)(getattr(sa, f), getattr(sb, f), f)
    plain.svc.close()


def test_preempt_resume_matches_jax():
    """tests/test_controlplane.py:163 on the engine backend: the priority
    scheduler preempts a tenant (snapshotted in the core layout), it
    resumes where it stopped when the slot frees, and its trajectory then
    equals an uninterrupted run's; records and snapshots equal JAX's."""
    from repro.core import topology as jt

    centers, x = _problem(25, seed=5)
    cfg = dict(capacity=1, k_max=3, d=2, cycles_per_dispatch=2,
               control={"scheduler": "priority", "preempt": True}, **ENGINE)
    with EnginePair(jt.grid(25), t_top.grid(25), **cfg) as pair:
        a = pair.admit(_voronoi(centers, x, seed=0, priority=0))
        pair.tick()
        pair.tick()
        snap0 = pair.t.snapshot(a)
        b = pair.admit(_voronoi(centers, x, seed=1, priority=5))
        pair.tick()  # boundary: b preempts a
        assert pair.both("admission_status", a) == "preempted"
        pair.check_snapshots([a, b], "suspended")
        pair.both("retire", b)  # a resumes at once
        back = pair.t.snapshot(a)
        for f in t_lss.LSSState._fields:
            if f != "rng":
                assert torch.equal(getattr(back, f), getattr(snap0, f)), f
        recs = [pair.tick()[0] for _ in range(3)]
        pair.check_snapshots([a], "resumed")
        pair.check_controls()
    ref = _port_twin(t_top.grid(25), **cfg)
    ref.admit(_port_spec(_voronoi(centers, x, seed=0)))
    ref.serve(2)
    for r, rr in zip(recs, [ref.tick()[0] for _ in range(3)]):
        assert (r["msgs"], r["quiescent"], r["accuracy"]) == \
            (rr["msgs"], rr["quiescent"], rr["accuracy"])
    ref.close()


# -- the engine backend against the port's core backend ---------------------

@pytest.mark.parametrize("suite", ["reference", "fused"])
def test_engine_backend_equals_core_backend(suite):
    """Three mixed tenants on a churned DynTopology (a fifth of the rows
    spare, seeded joins / leaves / unlinks, a regrow of the degree slots):
    the engine backend's records equal the core backend's exactly, and
    their snapshots agree."""
    n_cap = 49 + 9
    svcs = [_port_twin(_dyn(49, n_cap, 6), capacity=3, k_max=4, d=2,
                       cycles_per_dispatch=3, use_kernels=suite,
                       control={"auto_regrow": True}, **kw)
            for kw in ({}, dict(backend="engine", engine_shards=3))]
    qids = [[s.admit(_port_spec(sp)) for sp in _tenants(n_cap, 3)]
            for s in svcs]
    rngs = [np.random.default_rng(5) for _ in svcs]
    for disp in range(6):
        for svc, rng in zip(svcs, rngs):
            _churn(_Single(svc), rng, 4)
            if disp == 3:
                svc.grow_capacity(deg_cap=svc.topo.deg_cap + 2)
        assert svcs[1].tick() == svcs[0].tick()
    for qa, qb in zip(*qids):
        sa, sb = svcs[0].snapshot(qa), svcs[1].snapshot(qb)
        for f in t_lss.LSSState._fields:
            if f != "rng":
                (assert_close if getattr(sa, f).is_floating_point()
                 else assert_exact)(getattr(sb, f), getattr(sa, f), f)
    for svc in svcs:
        svc.close()


def test_kernel_calls_and_host_reads_per_dispatch_equal_core(monkeypatch):
    """Each dispatch calls the suite's hooks once per step for all Q
    tenants, not once per tenant: the reference suite's ``status_viol`` /
    ``corrected`` calls, the fused suite's wrapper calls (their plain
    versions here) and ``lss.host_syncs`` per dispatch equal the core
    backend's on the same workload."""
    calls = {"status_viol": 0, "corrected": 0}
    ref = t_suite.get_suite("reference")
    for name in calls:
        orig = getattr(type(ref), name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(type(ref), name, counted)

    books = []
    for suite in ("reference", "fused"):
        for kw in ({}, dict(backend="engine", engine_shards=3)):
            svc = _port_twin(t_top.grid(49), capacity=4, k_max=4, d=2,
                             cycles_per_dispatch=4, use_kernels=suite, **kw)
            for spec in _tenants(49, 4):
                svc.admit(_port_spec(spec))
            per = []
            for _ in range(4):
                for key in calls:
                    calls[key] = 0
                kernels.reset_counts()
                t_lss.host_syncs = 0
                svc.tick()
                per.append((dict(calls), dict(kernels.counts()),
                            t_lss.host_syncs))
            books.append(per)
            svc.close()
    core_ref, eng_ref, core_fused, eng_fused = books
    assert eng_ref == core_ref and eng_fused == core_fused
    # One status/violations pass at loop entry per cycle (4) at least.
    assert all(c["status_viol"] >= 4 for c, _, _ in core_ref)
    assert all(k["lss_state_ref"] >= 5 and k["region_decide_ref"] == 1
               for _, k, _ in core_fused)


@pytest.mark.parametrize("seed", [0, 1, 2, 131])
def test_epoch_property_schedule_against_epoch_free_run(seed):
    """tests/test_controlplane.py::test_property_epochs_midserve_cycle_
    exact's schedule (random churn, a grow, a rebalance or both at a
    random dispatch; seeds 0, 1, 2 draw rebalance, both, grow; 131 is the
    example hypothesis reports against JAX), which fails in JAX (ROADMAP
    C.3), held against the port's own epoch-free run: records (msgs and
    quiescent exact, accuracy within 1e-7) and the state.  Where the
    epoch grows the capacity, the epoch-free run is provisioned at the
    grown capacity from the start (zero-weight padding rows), as in the
    auto-regrow test: at the old capacity it refuses a join the grown
    service takes, the schedules part, and the records differ (at seed
    131 by 37 against 35 messages in the last dispatch, JAX's numbers)."""
    rng = np.random.default_rng(seed)
    centers, x = _problem(20, seed=int(rng.integers(100)))
    epoch_at = int(rng.integers(1, 4))
    epoch_kind = ["grow", "rebalance", "both"][int(rng.integers(3))]
    grows = epoch_kind != "rebalance"

    def run(with_epochs):
        n_cap, deg_cap = (26, 6) if grows and not with_epochs else (20, 5)
        svc = _port_twin(_dyn(16, n_cap, deg_cap), capacity=2, k_max=3,
                         d=2, cycles_per_dispatch=2, **ENGINE)
        xx, w = _padded(x, n_cap)
        q = svc.admit(_port_spec(_voronoi(centers, xx, weights=w, seed=1)))
        ev_rng = np.random.default_rng(seed + 1)
        out = []
        for disp in range(5):
            for _ in range(2):
                op = ev_rng.integers(3)
                try:
                    if op == 0:
                        p = svc.join_peer()
                        svc.link_peers(int(p), int(ev_rng.choice(
                            np.flatnonzero(svc.topo.present))))
                    elif op == 1:
                        svc.leave_peer(int(ev_rng.choice(
                            np.flatnonzero(svc.topo.present))))
                    else:
                        edges = svc.topo.edge_list()
                        if edges:
                            svc.unlink_peers(
                                *edges[ev_rng.integers(len(edges))])
                except (ValueError, RuntimeError):
                    pass
            if with_epochs and disp == epoch_at:
                if epoch_kind in ("grow", "both"):
                    svc.grow_capacity(n_cap=26, deg_cap=6)
                if epoch_kind in ("rebalance", "both"):
                    svc.rebalance_now()
            out.append(svc.tick()[0])
        snap = svc.snapshot(q)
        kinds = [e["kind"] for e in svc.capman.epochs]
        svc.close()
        return out, snap, kinds

    recs_a, snap_a, kinds = run(True)
    recs_b, snap_b, _ = run(False)
    assert len(kinds) == 1 + (epoch_kind == "both") + 1
    for ra, rb in zip(recs_a, recs_b):
        assert (ra["msgs"], ra["quiescent"]) == (rb["msgs"], rb["quiescent"])
        assert abs(ra["accuracy"] - rb["accuracy"]) <= 1e-7
    for f in t_lss.LSSState._fields:
        if f not in ("rng", "msgs"):
            (assert_close if getattr(snap_a, f).is_floating_point()
             else assert_exact)(getattr(snap_a, f), getattr(snap_b, f), f)


# -- the tenant axis of the exchange and the engine -------------------------

def _halo_case(q, s, seed):
    """Random (Q, S, B, D) state buffers and real halo tables of an
    S-shard grid engine (int8 wire: error feedback present)."""
    eng = ShardedLSS(t_top.grid(36), torch.zeros((3, 2)),
                     ecfg=EngineConfig(num_shards=s, wire="int8"),
                     device="cpu")
    g = torch.Generator().manual_seed(seed)
    S, B, D = eng.S, eng.B, eng.D

    def randn(*shape):
        return torch.randn(*shape, generator=g)

    st = dict(out_m=randn(q, S, B, D, 2), out_c=randn(q, S, B, D),
              in_m=randn(q, S, B, D, 2), in_c=randn(q, S, B, D),
              err_m=randn(q, S, B, D, 2), err_c=randn(q, S, B, D),
              delivered=torch.rand(q, S, B, D, generator=g) < 0.5)
    return eng, st


@pytest.mark.parametrize("q,s", [(3, 3), (2, 4)])
def test_exchange_tenant_axis_equals_per_tenant_calls(q, s):
    """Gather, transpose, scatter and the error-feedback moves with a
    leading tenant axis equal the unbatched calls tenant by tenant, with
    per-tenant flags (each tenant's discarded entries land in the one
    dummy row, never in the next tenant's first slot)."""
    eng, st = _halo_case(q, s, seed=q * 10 + s)
    halo = eng._tables.halo
    bufs = t_ex.gather_halo(st["out_m"], st["out_c"], st["delivered"], halo,
                            batch=1)
    moved = [t_ex.transpose_all_to_all(b, batch=1) for b in bufs]
    new_in = t_ex.scatter_halo(st["in_m"], st["in_c"], *moved, halo, batch=1)
    errs = t_ex.gather_err(st["err_m"], st["err_c"], halo, batch=1)
    new_err = t_ex.scatter_err(st["err_m"], st["err_c"], bufs[0] * 2.0,
                               bufs[1] * 2.0, halo, batch=1)
    for t in range(q):
        one = t_ex.gather_halo(st["out_m"][t], st["out_c"][t],
                               st["delivered"][t], halo)
        for got, want in zip(bufs, one):
            assert torch.equal(got[t], want)
        tr = [t_ex.transpose_all_to_all(b) for b in one]
        for got, want in zip(moved, tr):
            assert torch.equal(got[t], want)
        for got, want in zip(new_in, t_ex.scatter_halo(
                st["in_m"][t], st["in_c"][t], *tr, halo)):
            assert torch.equal(got[t], want)
        for got, want in zip(errs, t_ex.gather_err(st["err_m"][t],
                                                   st["err_c"][t], halo)):
            assert torch.equal(got[t], want)
        for got, want in zip(new_err, t_ex.scatter_err(
                st["err_m"][t], st["err_c"][t], one[0] * 2.0, one[1] * 2.0,
                halo)):
            assert torch.equal(got[t], want)
    # Undelivered entries: every tenant's in-slots outside what it was
    # sent stay as they were (the dummy row took the rest).
    assert not torch.equal(new_in[0], st["in_m"])
    idx = t_ex._tenant_rows(torch.tensor([[0, 5], [5, 2]]), 2, 5)
    assert idx.tolist() == [0, 10, 10, 7]


@pytest.mark.parametrize("wire", ["exact", "int8"])
def test_engine_cycle_and_layout_moves_per_tenant(wire):
    """The engine's stacked cycle (with per-tenant knobs and gate), scrub,
    core-layout round trip and migration equal the unbatched engine's
    tenant by tenant (Q == S)."""
    from repro_torch.kernels import ops
    from repro_torch.service import heterogeneous_tenants
    from repro_torch.service.query import QueryParams

    topo = t_top.grid(36)
    mk = lambda s: ShardedLSS(  # noqa: E731
        topo, torch.zeros((1, 2)), ecfg=EngineConfig(num_shards=s,
                                                     wire=wire),
        device="cpu")
    eng, other = mk(3), mk(2)
    specs = heterogeneous_tenants(36, 3)
    ones = [eng.init_sync(s.input_wv("cpu"), seed=s.seed) for s in specs]
    stack = ones[0]._replace(
        **{f: torch.stack([getattr(o, f) for o in ones])
           for f in ones[0]._fields
           if f != "rng" and getattr(ones[0], f) is not None},
        rng=tuple(o.rng for o in ones))
    params = QueryParams.empty(3, 4, 2, t_lss.LSSConfig(), "cpu")
    for i, spec in enumerate(specs):
        params = params.set_slot(i, spec, t_lss.LSSConfig())
    gate = torch.tensor([True, False, True])
    params = params._replace(active=gate)
    cfg = t_lss.LSSConfig()._replace(beta=params.beta, ell=params.ell,
                                     eps=params.eps)
    tables = ops.prep_slots(params.regions, params.eps, params.beta)
    for _ in range(5):
        stack, iters = eng._cycle_full(stack, eng._tables, True, cfg=cfg,
                                       gate=gate, regions=tables)
        for i, spec in enumerate(specs):
            one_cfg = t_lss.LSSConfig(beta=params.beta[i],
                                      ell=params.ell[i], eps=params.eps[i])
            ones[i], it = eng._cycle_full(
                ones[i], eng._tables, True, cfg=one_cfg,
                gate=gate[i:i + 1],
                regions=ops.prep_slots(params.regions.slot(i),
                                       params.eps[i], params.beta[i]))
            assert int(iters[i]) == it
    rows, slots = np.array([0, 7, 14]), np.array([1, 0, 2])
    stack = eng.clear_slots(stack, rows, slots)
    ones = [eng.clear_slots(o, rows, slots) for o in ones]
    core = eng.to_lss_state(stack)
    moved = other.migrate_from(eng, stack)
    placed = eng.place_lss_state(core)
    for i, one in enumerate(ones):
        want = eng.to_lss_state(one)
        mig = other.migrate_from(eng, one)
        for f in t_lss.LSSState._fields:
            if f != "rng":
                assert torch.equal(getattr(core, f)[i], getattr(want, f)), f
        for f in one._fields:
            if f == "rng":
                continue
            if getattr(one, f) is None:
                assert getattr(moved, f) is None
                continue
            assert torch.equal(getattr(moved, f)[i], getattr(mig, f)), f
            if f not in ("msgs", "wire_err_m", "wire_err_c"):
                assert torch.equal(getattr(placed, f)[i], getattr(one, f)), f
    assert len(moved.rng) == 3 and len(moved.rng[0]) == other.S


def test_engine_decide_override_runs_the_reference_formulas():
    """An opaque ``decide`` override of the cycle and the observe runs the
    reference formulas (the engine's own Voronoi family gives the same
    trajectory and numbers); with the fused suite it raises, as the JAX
    twin's fused path cannot honor one either."""
    from repro_torch.core import regions as t_regions
    from repro_torch.core import wvs

    centers, x = _problem(36, seed=3)
    cen = torch.tensor(centers)
    inputs = wvs.from_vector(torch.tensor(x), torch.ones(36))
    decide = lambda v: t_regions.decide_voronoi(v, cen)  # noqa: E731
    eng = ShardedLSS(t_top.grid(36), cen,
                     ecfg=EngineConfig(num_shards=3, use_kernels=False),
                     device="cpu")
    own = over = eng.init_sync(inputs, seed=0)
    for _ in range(8):
        own = eng._cycle_full(own, eng._tables)
        over = eng._cycle_full(over, eng._tables, decide=decide)
    for f in t_lss.LSSState._fields:
        if f != "rng":
            assert torch.equal(getattr(eng.to_lss_state(own), f),
                               getattr(eng.to_lss_state(over), f)), f
    for a, b in zip(eng._metrics_impl(own), eng._metrics_impl(
            over, decide=decide)):
        assert torch.equal(a, b)
    fused = ShardedLSS(t_top.grid(36), cen,
                       ecfg=EngineConfig(num_shards=3, use_kernels=True),
                       device="cpu")
    st = fused.init_sync(inputs, seed=0)
    with pytest.raises(ValueError, match="opaque"):
        fused._cycle_full(st, fused._tables, decide=decide)
    with pytest.raises(ValueError, match="opaque"):
        fused._metrics_impl(st, decide=decide)
