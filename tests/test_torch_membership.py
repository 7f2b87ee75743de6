"""The port's service under membership churn against the JAX package's.

``repro_torch.service.Service`` on a ``DynTopology`` (core backend,
synchronous mode) is driven in lockstep with ``repro.service.Service``
(``backend="core"``) through the same joins, leaves, links, unlinks,
regrow epochs and preemptions, on the same numpy tenants.  Per-query
records must be equal as dicts; so must the per-slot do-while iteration
counts and the control records without their span timings.  Snapshots
compare int and bool fields (``alive``, ``pending``, ``last_send``,
``msgs``, ``t``) exactly and float moments to rtol 1e-5 / atol 1e-5.  The
port runs its reference suite and, where parametrized, its fused suite
(the kernels' plain versions on the CPU).

Seeds are fixed; every service is closed by its ``with`` block.  The
``MembershipQueue`` copy is held to the JAX queue on seeded random event
sequences (returned rows, errors, drained topology and books).
"""

import numpy as np
import pytest
import torch

from repro.core import topology as j_top
from repro.service import ControlPlaneConfig as JControl
from repro.service import Service as JService
from repro.service import ServiceConfig as JConfig
from repro.service.membership import MembershipQueue as JQueue
from repro_torch.core import lss as t_lss
from repro_torch.core import topology as t_top
from repro_torch.service import ControlPlaneConfig as TControl
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from repro_torch.service.membership import MembershipQueue as TQueue
from test_torch_formulas import assert_exact
from test_torch_lss import _assert_state
from test_torch_service import _port_spec, _problem, _tenants, _voronoi

SUITES = ["reference", "fused"]


def _no_spans(records):
    return [{k: v for k, v in r.items() if k != "spans"} for r in records]


class DynPair:
    """A JAX service and the port's, each on its own ``DynTopology`` built
    from the same grid, driven in lockstep; a context manager that closes
    both."""

    def __init__(self, n, n_cap, deg_cap, suite="reference",
                 strict=False, **cfg):
        control = cfg.pop("control", None)
        jcfg = JConfig(**cfg, **({"control": JControl(**control)}
                                 if control else {}))
        tcfg = TConfig(**cfg, use_kernels=suite,
                       **({"control": TControl(**control)}
                          if control else {}))
        self.jdyn = j_top.DynTopology.from_topology(
            j_top.grid(n), n_cap=n_cap, deg_cap=deg_cap, strict=strict)
        self.tdyn = t_top.DynTopology.from_topology(
            t_top.grid(n), n_cap=n_cap, deg_cap=deg_cap, strict=strict)
        self.j = JService(self.jdyn, jcfg)
        self.t = TService(self.tdyn, tcfg, device="cpu")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.j.close()
        self.t.close()
        return False

    def admit(self, spec, **kw):
        a = self.j.admit(spec, **kw)
        assert self.t.admit(_port_spec(spec), **kw) == a
        return a

    def both(self, method, *args, **kw):
        """Call ``method`` on both services: equal results, or the same
        exception type from both (re-raised)."""
        try:
            want = getattr(self.j, method)(*args, **kw)
        except (ValueError, RuntimeError) as e:
            with pytest.raises(type(e)):
                getattr(self.t, method)(*args, **kw)
            raise
        got = getattr(self.t, method)(*args, **kw)
        assert got == want, method
        return got

    def tick(self):
        want = self.j.tick()
        got = self.t.tick()
        assert got == want
        assert_exact(self.t._corr_iters, np.asarray(self.j._corr_iters),
                     "per-slot do-while iterations")
        assert self.t.topo_version == self.j.topo_version
        assert_exact(self.t._present, self.j._present, "present")
        return got

    def check_snapshots(self, qids, msg=""):
        for qid in qids:
            js = self.j.snapshot(qid)
            _assert_state(self.t.snapshot(qid),
                          {f: np.asarray(getattr(js, f))
                           for f in js._fields if f != "rng"},
                          f"{msg} {qid}")
            assert self.t.total_msgs(qid) == self.j.total_msgs(qid)

    def check_topology(self):
        for f in ("nbr", "mask", "rev", "present"):
            assert_exact(getattr(self.t.topo, f), getattr(self.j.topo, f), f)
        assert self.t.topo.version == self.j.topo.version

    def check_controls(self):
        got = _no_spans(self.t.telemetry.controls())
        assert got == _no_spans(self.j.telemetry.controls())
        return got


def _events(pair, events):
    """Queue ``(kind, args, value)`` events on both services."""
    for kind, args, value in events:
        if kind == "join":
            pair.both("join_peer", *args, value=value)
        elif kind == "leave":
            pair.both("leave_peer", *args)
        elif kind == "link":
            pair.both("link_peers", *args)
        else:
            pair.both("unlink_peers", *args)


# tests/test_membership.py::test_service_membership_parity_with_manual_loop,
# with a later unlink whose freed slot a link claims again.
SCHEDULE = {
    1: [("join", (36,), np.array([0.5, -0.25], np.float32)),
        ("link", (36, 0), None), ("link", (36, 7), None)],
    2: [("leave", (14,), None)],
    4: [("join", (37,), None), ("link", (37, 36), None),
        ("unlink", (0, 1), None)],
    5: [("link", (0, 20), None), ("unlink", (36, 7), None)],
}


def _manual_loop(centers, x, n_cap, k, dispatches):
    """The port's own hand-rolled single-query core loop under SCHEDULE
    (pure ``lss.clear_slots``): (accuracy, quiescent, msgs) per dispatch
    and the final state."""
    ref = t_top.DynTopology.from_topology(t_top.grid(36), n_cap=n_cap,
                                          deg_cap=6)
    ta = t_lss.TopoArrays.from_topology(ref, "cpu")
    spec = _port_spec(_voronoi(centers, x, seed=0))
    st = t_lss.init_state(ta, spec.input_wv("cpu"), seed=0,
                          alive=ref.present.copy())
    cen = torch.tensor(centers)
    out = []
    for disp in range(dispatches):
        ver = ref.version
        for kind, args, value in SCHEDULE.get(disp, []):
            {"join": ref.add_peer, "leave": ref.remove_peer,
             "link": ref.add_edge, "unlink": ref.remove_edge}[kind](*args)
        evs = ref.events_since(ver)
        if evs:
            ta = t_lss.TopoArrays.from_topology(ref, "cpu")
            rows = [r for e in evs if e.kind in ("link", "unlink")
                    for r in (e.a, e.b)]
            slots = [s for e in evs if e.kind in ("link", "unlink")
                     for s in (e.slot_a, e.slot_b)]
            if rows:
                st = t_lss.clear_slots(st, rows, slots)
            for kind, args, value in SCHEDULE.get(disp, []):
                p = args[0]
                alive, x_m = st.alive.clone(), st.x_m.clone()
                x_c, last = st.x_c.clone(), st.last_send.clone()
                alive[p] = kind == "join"
                if kind == "join":
                    x_m[p] = torch.as_tensor(
                        np.zeros(2, np.float32) if value is None else value)
                    x_c[p] = 1.0
                    last[p] = t_lss.COLD_TIMER
                if kind in ("join", "leave"):
                    st = st._replace(alive=alive, x_m=x_m, x_c=x_c,
                                     last_send=last)
        msgs0 = int(st.msgs)
        for _ in range(k):
            st, _ = t_lss.cycle(st, ta, cen, t_lss.LSSConfig())
        acc, quiescent, _ = t_lss.metrics(st, ta, cen)
        out.append((float(acc), bool(quiescent), int(st.msgs) - msgs0))
    return out, st


@pytest.mark.parametrize("suite", SUITES)
def test_membership_schedule_matches_jax(suite):
    """One Voronoi and one halfspace tenant under joins, a leave, links
    and unlinks (a freed slot claimed again): records, iterations,
    snapshots, topology tables and control records equal JAX's at every
    dispatch, and the Voronoi tenant equals the port's hand-rolled loop."""
    n_cap, k = 40, 3
    centers, x = _problem(n_cap, seed=4)
    with DynPair(36, n_cap, 6, suite, strict=True, capacity=3, k_max=3,
                 d=2, cycles_per_dispatch=k) as pair:
        qa = pair.admit(_voronoi(centers, x, seed=0))
        qb = pair.admit(_tenants(n_cap, 2)[1])
        recs = []
        for disp in range(7):
            _events(pair, SCHEDULE.get(disp, []))
            recs.append(pair.tick())
            pair.check_snapshots([qa, qb], f"dispatch {disp}")
            pair.check_topology()
        controls = pair.check_controls()
        manual, st = _manual_loop(centers, x, n_cap, k, 7)
        assert [(r[0]["accuracy"], r[0]["quiescent"], r[0]["msgs"])
                for r in recs] == manual
        _assert_state(pair.t.snapshot(qa), {
            f: t.numpy() for f, t in st._asdict().items()
            if f not in ("rng", "msgs")}, "hand-rolled loop")
        assert pair.t.total_msgs(qa) == int(st.msgs)
        spans = {r["name"] for r in pair.t.telemetry.records
                 if r.get("kind") == "span"}
    assert {"membership_drain", "admission_drain", "dispatch"} <= spans
    # Dispatches 2, 3, 5 and 6 drained events; the boundary map says so.
    drained = [c["dispatch"] for c in controls
               if c.get("boundary", {}).get("membership_events")]
    assert drained == [2, 3, 5, 6]
    assert recs[-1][0]["topo_version"] == pair.tdyn.version


def _churn(pair, rng, count):
    """``count`` seeded join+link / leave / unlink events, picked from the
    port's topology and queued on both services (a refused event must be
    refused by both)."""
    dyn = pair.t.topo
    for _ in range(count):
        op = rng.integers(3)
        try:
            if op == 0:
                p = pair.both("join_peer",
                              value=rng.normal(size=2).astype(np.float32))
                partner = int(rng.choice(np.flatnonzero(dyn.present)))
                pair.both("link_peers", p, partner)
            elif op == 1:
                pair.both("leave_peer",
                          int(rng.choice(np.flatnonzero(dyn.present))))
            else:
                edges = dyn.edge_list()
                pair.both("unlink_peers", *edges[rng.integers(len(edges))])
        except (ValueError, RuntimeError):
            pass


@pytest.mark.parametrize("suite", SUITES)
@pytest.mark.parametrize("seed", [0, 1])
def test_spare_rows_and_seeded_churn_match_jax(suite, seed):
    """A fifth of the rows spare (n_cap = 49 + 9): the dead spare rows stay
    out of the global decision and the accuracy; three mixed tenants
    (Voronoi, halfspace, Voronoi with an SLO) under seeded churn, four
    events a dispatch, equal JAX's record by record."""
    n_cap = 49 + int(49 * 0.2)
    with DynPair(49, n_cap, 6, suite, capacity=3, k_max=4, d=2,
                 cycles_per_dispatch=4) as pair:
        qids = [pair.admit(s) for s in _tenants(n_cap, 3)]
        assert not pair.t.states.alive[:, 49:].any()
        rng = np.random.default_rng(seed)
        for _ in range(5):
            _churn(pair, rng, 4)
            pair.tick()
        pair.check_snapshots(qids)
        pair.check_topology()
        pair.check_controls()
        assert pair.t.slo_report() == pair.j.slo_report()
        assert pair.tdyn.version > 0


def test_membership_preserves_other_tenants_convergence():
    """A join with two links does not reset an in-flight tenant: it keeps
    its timeline and re-converges, in both packages alike."""
    n_cap = 40
    centers, x = _problem(n_cap, seed=6)
    with DynPair(36, n_cap, 6, capacity=3, k_max=3, d=2,
                 cycles_per_dispatch=4) as pair:
        qa = pair.admit(_voronoi(centers, x, seed=0))
        for _ in range(10):
            (rec,) = pair.tick()
            if rec["quiescent"]:
                break
        assert rec["quiescent"]
        p = pair.both("join_peer", value=x[36])
        pair.both("link_peers", p, 5)
        pair.both("link_peers", p, 11)
        recs = [pair.tick()[0] for _ in range(12)]
        assert recs[0]["t"] == rec["t"] + 4
        assert recs[0]["topo_version"] == pair.tdyn.version
        assert recs[-1]["quiescent"] and recs[-1]["accuracy"] == 1.0
        pair.check_snapshots([qa])


def test_membership_drain_survives_bad_event():
    """A queued link raced by a direct DynTopology edit fails at the
    boundary, is dropped and recorded, and the join queued behind it still
    lands with its value; eager validation refuses plain duplicates."""
    centers, x = _problem(18, seed=1)
    with DynPair(16, 18, 6, capacity=2, k_max=3, d=2,
                 cycles_per_dispatch=1) as pair:
        qa = pair.admit(_voronoi(centers, x, seed=0))
        pair.both("link_peers", 0, 5)
        pair.jdyn.add_edge(0, 5)
        pair.tdyn.add_edge(0, 5)
        p = pair.both("join_peer", value=[2.5, -1.5])
        pair.both("link_peers", p, 3)
        pair.tick()
        (ev, msg), = pair.t.membership.failures
        assert ev.kind == "link" and "exists" in msg
        assert [(e.kind, e.peer, e.peer_b, m) for e, m in
                pair.j.membership.failures] == [(ev.kind, ev.peer,
                                                 ev.peer_b, msg)]
        assert pair.tdyn.present[p] and pair.tdyn.has_edge(p, 3)
        snap = pair.t.snapshot(qa)
        np.testing.assert_allclose(snap.x_m[p].numpy(), [2.5, -1.5])
        assert bool(snap.alive[p])
        pair.check_snapshots([qa])
        for args in ((p, 3), (0, 1)):
            with pytest.raises(ValueError, match="exists"):
                pair.t.link_peers(*args)


def _padded(spec_inputs, n2):
    """tests/test_controlplane.py::_padded_spec's inputs: zero-weight
    padding rows up to ``n2``."""
    n1 = spec_inputs.shape[0]
    xx = np.zeros((n2, spec_inputs.shape[1]), np.float32)
    xx[:n1] = spec_inputs
    w = np.zeros((n2,), np.float32)
    w[:n1] = 1.0
    return xx, w


# tests/test_controlplane.py::_churn_schedule(25, 3): joins past capacity.
REGROW = {
    1: [("join", (25,), [0.5, -0.5]), ("link", (25, 0), None)],
    2: [("join", (26,), None), ("link", (26, 3), None),
        ("leave", (5,), None)],
    3: [("join", (27,), [1.0, 0.0]), ("link", (27, 25), None)],
}


@pytest.mark.parametrize("suite", SUITES)
def test_auto_regrow_midserve_cycle_exact(suite):
    """A service that outgrows n_cap mid-serve (the auto-regrow epoch)
    emits what a service provisioned large from the start emits, and what
    the JAX service emits through the same epoch."""
    from repro.service import QuerySpec as JSpec
    from repro.core import regions as j_regions
    import jax.numpy as jnp

    n1, n2 = 26, 29
    centers, x = _problem(n1, seed=7)

    def spec(n):
        xx, w = _padded(x, n)
        return JSpec(region=j_regions.VoronoiRegions(jnp.asarray(centers)),
                     inputs=xx, weights=w, seed=0)

    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2)
    grow = {"auto_regrow": True, "grow_factor": 1.12}
    with DynPair(25, n1, 5, suite, control=grow, **cfg) as a, \
            DynPair(25, n2, 5, suite, **cfg) as b:
        qa = a.admit(spec(n1))
        qb = b.admit(spec(n2))
        for disp in range(5):
            _events(a, REGROW.get(disp, []))
            _events(b, REGROW.get(disp, []))
            (ra,) = a.tick()
            (rb,) = b.tick()
            assert ra["msgs"] == rb["msgs"], disp
            assert ra["quiescent"] == rb["quiescent"]
            np.testing.assert_allclose(ra["accuracy"], rb["accuracy"],
                                       atol=1e-7)
        assert a.t.topo.n_cap >= 29
        assert [e["kind"] for e in a.t.capman.epochs] == ["init", "regrow"]
        controls = a.check_controls()
        assert any(c.get("epochs") for c in controls)
        a.check_snapshots([qa])
        a.check_topology()
        sa, sb = a.t.snapshot(qa), b.t.snapshot(qb)
        n = min(sa.alive.shape[0], sb.alive.shape[0])
        D = min(sa.out_c.shape[-1], sb.out_c.shape[-1])
        np.testing.assert_allclose(sa.out_m[:n, :D], sb.out_m[:n, :D],
                                   atol=1e-6)
        assert torch.equal(sa.alive[:n], sb.alive[:n])
        assert torch.equal(sa.pending[:n, :D], sb.pending[:n, :D])
        spans = [r for r in a.t.telemetry.records
                 if r.get("kind") == "span" and r["name"] == "epoch_regrow"]
    assert len(spans) == 1 and spans[0]["attrs"]["n_cap"] == a.t.topo.n_cap


@pytest.mark.parametrize("grow", [False, True])
def test_preempt_resume_reconciled_across_membership(grow):
    """A preempted tenant whose topology moved while it held no slot
    (joins, a leave, a link, and with ``grow`` a regrow epoch) resumes
    reconciled: messaging scrubbed, alive snapped to the present set, the
    joined peers knowledge-initialized; its records and state equal the
    JAX service's through the suspension and after it."""
    n_cap = 30
    centers, x = _problem(n_cap, seed=5)
    with DynPair(25, n_cap, 5, capacity=1, k_max=3, d=2,
                 cycles_per_dispatch=2,
                 control={"scheduler": "priority", "preempt": True}) as pair:
        a = pair.admit(_voronoi(centers, x, seed=0, priority=0))
        pair.tick()
        pair.tick()
        b = pair.admit(_voronoi(centers, x, seed=1, priority=5))
        pair.tick()  # boundary: b preempts a
        assert pair.both("admission_status", a) == "preempted"
        suspended = pair.t.snapshot(a)
        _events(pair, [("join", (25,), [0.3, 0.1]), ("link", (25, 2), None),
                       ("leave", (7,), None), ("link", (1, 8), None)])
        if grow:
            pair.both("grow_capacity", n_cap=34, deg_cap=6)
        pair.tick()
        pair.check_snapshots([a, b], "suspended")
        assert_exact(pair.t.snapshot(a).alive, suspended.alive, "paused")
        pair.both("retire", b)  # a resumes at once, reconciled
        resumed = pair.t.snapshot(a)
        assert resumed.alive.shape[0] == (34 if grow else n_cap)
        assert_exact(resumed.alive, pair.t.topo.present, "alive snapped")
        assert not resumed.pending.any() and not resumed.out_c.any()
        assert resumed.x_c[25] == 1.0 and not resumed.x_m[25].any()
        pair.check_snapshots([a], "resumed")
        for _ in range(4):
            pair.tick()
        pair.check_snapshots([a])
        controls = pair.check_controls()
        resume = [r for r in pair.t.telemetry.records
                  if r.get("kind") == "span" and r["name"] == "resume"]
    assert resume[-1]["attrs"]["reconciled"] is True
    assert any(c.get("resumed") == [a] for c in controls)


def test_resume_without_membership_change_is_exact():
    """No membership moved while suspended: the restore is bitwise."""
    centers, x = _problem(30, seed=5)
    with DynPair(25, 30, 5, capacity=1, k_max=3, d=2,
                 cycles_per_dispatch=2,
                 control={"scheduler": "priority", "preempt": True}) as pair:
        a = pair.admit(_voronoi(centers, x, seed=0, priority=0))
        pair.tick()
        snap0 = pair.t.snapshot(a)
        b = pair.admit(_voronoi(centers, x, seed=1, priority=5))
        pair.tick()
        pair.both("retire", b)
        back = pair.t.snapshot(a)
        for f in t_lss.LSSState._fields:
            if f != "rng":
                assert torch.equal(getattr(back, f), getattr(snap0, f)), f
        pair.tick()
        pair.check_snapshots([a])


def _port_service(n_cap=18, deg_cap=4, **control):
    dyn = t_top.DynTopology.from_topology(t_top.grid(16), n_cap=n_cap,
                                          deg_cap=deg_cap)
    return TService(dyn, TConfig(capacity=1, k_max=3, d=2,
                                 control=TControl(**control)), device="cpu")


def test_membership_eager_degree_capacity_error():
    with _port_service() as svc:
        svc.link_peers(0, 3)
        svc.link_peers(0, 12)
        with pytest.raises(t_top.CapacityError, match="degree capacity"):
            svc.link_peers(0, 15)
        svc.tick()
        assert not svc.membership.failures


def test_membership_eager_degree_capacity_autogrows():
    centers, x = _problem(18, seed=1)
    with _port_service(auto_regrow=True) as svc:
        svc.admit(_port_spec(_voronoi(centers, x, seed=0)))
        svc.tick()
        svc.link_peers(0, 3)
        svc.link_peers(0, 12)
        svc.link_peers(0, 15)  # past deg_cap=4: one regrow epoch
        assert svc.topo.deg_cap > 4
        assert svc.states.out_c.shape[-1] == svc.topo.deg_cap
        svc.tick()
        assert not svc.membership.failures
        assert svc.topo.has_edge(0, 15)


def test_membership_noop_unlink_keeps_degree_projection():
    with _port_service() as svc:
        svc.link_peers(0, 3)
        svc.link_peers(0, 12)
        svc.unlink_peers(0, 15)  # no such edge: no-op
        svc.unlink_peers(0, 1)  # real: frees one slot
        svc.unlink_peers(0, 1)  # duplicate: no-op
        assert svc.membership.projected_degree(0) == 3
        svc.link_peers(0, 15)
        with pytest.raises(t_top.CapacityError, match="degree capacity"):
            svc.link_peers(0, 13)
        svc.tick()
        assert not svc.membership.failures
        assert svc.topo.has_edge(0, 15) and not svc.topo.has_edge(0, 1)


def test_grow_carries_version_forward():
    dyn = t_top.DynTopology.from_topology(t_top.grid(16), strict=True)
    dyn.remove_edge(0, 1)
    v = dyn.version
    grown = dyn.grow(n_cap=20)
    assert grown.version == v
    with pytest.raises(ValueError, match="journal floor"):
        grown.events_since(0)
    assert grown.events_since(v) == []


def test_membership_requires_dyn_topology():
    with TService(t_top.grid(16), TConfig(capacity=1, k_max=3, d=2),
                  device="cpu") as svc:
        with pytest.raises(RuntimeError, match="DynTopology"):
            svc.join_peer()
        with pytest.raises(RuntimeError, match="DynTopology"):
            svc.grow_capacity(n_cap=20)
    with _port_service() as svc:
        with pytest.raises(ValueError, match="d=3"):
            svc.join_peer(value=[1.0, 2.0, 3.0])


def _queue_ops(q, dyn, rng, count):
    """Seeded queue calls; returns what each returned or raised."""
    out = []
    for _ in range(count):
        op = int(rng.integers(6))
        a, b = (int(v) for v in rng.integers(0, dyn.n_cap + 2, size=2))
        try:
            if op == 0:
                out.append(q.join(value=rng.normal(size=2)))
            elif op == 1:
                out.append(q.join(a, weight=0.5))
            elif op == 2:
                out.append(q.leave(a))
            elif op in (3, 4):
                out.append(q.link(a, b))
            else:  # unlink validates nothing: keep it inside the rows
                out.append(q.unlink(a % dyn.n_cap, b % dyn.n_cap))
        except (ValueError, RuntimeError, IndexError) as e:
            out.append((type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_membership_queue_matches_jax(seed):
    """The queue copy on seeded random joins / leaves / links / unlinks
    (many refused): the same rows, errors, degree projections, drains,
    drain books and resulting tables as the JAX queue."""
    jdyn = j_top.DynTopology.from_topology(j_top.grid(16), n_cap=20,
                                           deg_cap=5, strict=True)
    tdyn = t_top.DynTopology.from_topology(t_top.grid(16), n_cap=20,
                                           deg_cap=5, strict=True)
    jq, tq = JQueue(jdyn), TQueue(tdyn)
    for rnd in range(3):
        want = _queue_ops(jq, jdyn, np.random.default_rng([seed, rnd]), 30)
        got = _queue_ops(tq, tdyn, np.random.default_rng([seed, rnd]), 30)
        assert got == want
        assert [tq.projected_degree(p) for p in range(20)] == \
            [jq.projected_degree(p) for p in range(20)]
        jin, tin = jq.drain_into(jdyn), tq.drain_into(tdyn)
        assert tin.keys() == jin.keys()
        for p, (v, w) in tin.items():
            assert w == jin[p][1]
            assert (v is None) == (jin[p][0] is None)
            if v is not None:
                assert_exact(v, jin[p][0], "join value")
        assert tq.last_drain_stats == jq.last_drain_stats
        assert tq.applied_events == jq.applied_events
        assert [(e.kind, e.peer, e.peer_b, m) for e, m in tq.failures] == \
            [(e.kind, e.peer, e.peer_b, m) for e, m in jq.failures]
        for f in ("nbr", "mask", "rev", "present"):
            assert_exact(getattr(tdyn, f), getattr(jdyn, f), f)
        assert tdyn.version == jdyn.version


def test_lossy_churn_with_regrow_is_seeded_and_converges():
    """At drop_rate > 0 the loss draws differ from JAX's by design, so the
    port is held to seeded reproducibility and convergence through a
    regrow epoch: two runs give equal records, and the tenant reaches
    accuracy 1.0 and quiesces."""
    centers, x = _problem(26, seed=7)

    def run():
        dyn = t_top.DynTopology.from_topology(t_top.grid(25), n_cap=26,
                                              deg_cap=5)
        with TService(dyn, TConfig(capacity=2, k_max=3, d=2,
                                   cycles_per_dispatch=4, drop_rate=0.2,
                                   control=TControl(auto_regrow=True)),
                      device="cpu") as svc:
            svc.admit(_port_spec(_voronoi(centers, x, seed=3)))
            recs = []
            for disp in range(16):
                for kind, args, value in REGROW.get(disp, []):
                    {"join": lambda p, v=value: svc.join_peer(p, value=v),
                     "leave": svc.leave_peer,
                     "link": svc.link_peers}[kind](*args)
                recs.append(svc.tick())
            return recs, svc.topo.n_cap

    recs, n_cap = run()
    assert run() == (recs, n_cap) and n_cap > 26
    assert recs[-1][0]["accuracy"] == 1.0 and recs[-1][0]["quiescent"]


def test_regrow_pads_state_and_carries_generators():
    """``grow_capacity`` pads every slot to init values (dead rows, empty
    slots, cold timers) and keeps each slot's generator state."""
    centers, x = _problem(18, seed=2)
    with _port_service(n_cap=18, deg_cap=4) as svc:
        svc.admit(_port_spec(_voronoi(centers, x, seed=5)))
        svc.tick()
        before = svc.states
        gens = [g.get_state() for g in before.rng]
        svc.grow_capacity(n_cap=22, deg_cap=6)
        st = svc.states
        assert st.out_m.shape == (1, 22, 6, 2) and st.alive.shape == (1, 22)
        assert torch.equal(st.out_m[:, :18, :4], before.out_m)
        assert not st.alive[:, 18:].any() and not st.pending[:, :, 4:].any()
        assert (st.last_send[:, 18:] == t_lss.COLD_TIMER).all()
        assert not st.x_c[:, 18:].any() and not st.in_c[:, :, 4:].any()
        assert all(torch.equal(g.get_state(), s)
                   for g, s in zip(st.rng, gens))
        assert svc.backend.ta.nbr.shape == svc.backend.ta.mask.shape \
            == (22, 6)
        assert svc.backend.cut_frac() is None
        (rec,) = svc.tick()
        assert rec["topo_version"] == svc.topo_version
