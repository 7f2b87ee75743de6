"""The port's sharded engine (``repro_torch.engine``) against the JAX
package's, and against the port's own core loop.

Partition and halo tables, the bit packing and the wire byte models must
be array-equal to ``repro.engine``'s.  The engine runs on the CPU through
the reference formulas (the fused suite's plain versions in one case) and
is compared with the JAX ``ShardedLSS`` gather fallback dispatch by
dispatch: ints, bools, ``pending``, ``last_send``, ``t`` and ``msgs``
exactly, floats to rtol 1e-5 / atol 1e-5, as in ``test_torch_lss.py``.
Against the port's own core it must be equal bitwise: the same per-row
arithmetic on permuted rows.  ``drop_rate`` stays 0 where JAX is compared
(its drop stream is threefry), and the port is held to seeded
reproducibility and convergence under loss instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import regions as j_regions
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro.engine import exchange as j_ex
from repro.engine import partition as j_part
from repro_torch import convert
from repro_torch.core import lss as t_lss
from repro_torch.core import regions as t_regions
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top
from repro_torch.core import wvs as t_wvs
from repro_torch.engine import EngineConfig, ShardedLSS
from repro_torch.engine import exchange as t_ex
from repro_torch.engine import partition as t_part
from repro_torch.engine.engine import DeviceTopo
from repro_torch.kernels import get_suite
from repro_torch.obs import InMemoryTracker
from test_torch_formulas import assert_close, assert_exact

TOPOS = {"grid": lambda m: m.grid(64),
         "chord": lambda m: m.chord(60),
         "ba": lambda m: m.barabasi_albert(80, m=2, seed=3)}
FLOATS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c")
STATIC_KEYS = ("n", "cycles_95", "cycles_100", "quiesced_at",
               "final_accuracy", "quiescent", "msgs_per_link", "total_msgs",
               "engine_shards", "cut_edges")


def _assert_tables_equal(got, want):
    """Two ShardedTopos (or Partitions) field by field, arrays exactly."""
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if hasattr(w, "_asdict"):
            _assert_tables_equal(g, w)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, name
            assert np.array_equal(g, w), name
        else:
            assert g == w, name


# ---------------------------------------------------------------------------
# partition and halo tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slack", [1.0, 1.5])
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
@pytest.mark.parametrize("method", ["bfs", "stride"])
@pytest.mark.parametrize("topo_name", list(TOPOS))
def test_partition_matches_jax(topo_name, method, shards, slack):
    jt, tt = TOPOS[topo_name](j_top), TOPOS[topo_name](t_top)
    jp = j_part.make_partition(jt, shards, method)
    tp = t_part.make_partition(tt, shards, method)
    _assert_tables_equal(tp, jp)
    want = j_part.shard_topology(jt, jp, halo_slack=slack)
    got = t_part.shard_topology(tt, tp, halo_slack=slack)
    _assert_tables_equal(got, want)
    assert got.cut_edges() == want.cut_edges()


def test_partition_rejects_bad_args():
    topo = t_top.grid(16)
    with pytest.raises(ValueError):
        t_part.make_partition(topo, 0)
    with pytest.raises(ValueError):
        t_part.make_partition(topo, 17)
    with pytest.raises(KeyError):
        t_part.make_partition(topo, 2, method="metis")


def _edit(dyn):
    """The same membership edits on either package's DynTopology."""
    dyn.remove_peer(5)
    dyn.remove_edge(10, 11)
    dyn.add_edge(0, 63)
    dyn.add_edge(12, 50)
    p = dyn.add_peer()
    dyn.add_edge(p, 20)
    dyn.add_edge(p, 40)


def test_repair_sharded_topo_matches_jax():
    """Repair after DynTopology edits (one that regrows the halo width) ==
    JAX's repair == a full rebuild at the same width."""
    out = {}
    for mod, part in ((j_top, j_part), (t_top, t_part)):
        dyn = mod.DynTopology.from_topology(mod.grid(64), n_cap=72,
                                            deg_cap=6)
        p = part.make_partition(dyn, 3)
        st = part.shard_topology(dyn, p)
        v0 = dyn.version
        _edit(dyn)
        rep = part.repair_sharded_topo(st, dyn, dyn.changed_rows_since(v0))
        full = part.shard_topology(dyn, p, halo_width=rep.halo_width)
        # A re-partition epoch's row map: bfs at 3 shards -> stride at 4.
        moved = part.migrate_rows(p, part.make_partition(dyn, 4, "stride"))
        out[mod] = (rep, full, st.halo_width, moved)
    (jrep, _, jw, jmoved), (trep, tfull, tw, tmoved) = out[j_top], out[t_top]
    assert jw == tw and trep.halo_width > tw  # the edits regrew the halo
    _assert_tables_equal(trep, jrep)
    _assert_tables_equal(trep, tfull)
    for a, b in zip(tmoved, jmoved):
        assert a.dtype == b.dtype
        assert_exact(a, b)


# ---------------------------------------------------------------------------
# exchange: bit packing, byte models, block halves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 7, 8, 13, 64])
def test_pack_bits_matches_jax(width):
    flag = np.random.default_rng(width).random((3, 4, width)) < 0.4
    packed = t_ex.pack_bits(torch.tensor(flag))
    assert packed.dtype == torch.uint8
    assert_exact(packed, j_ex.pack_bits(jnp.asarray(flag)))
    assert_exact(t_ex.unpack_bits(packed, width), flag)


@pytest.mark.parametrize("wire", ["exact", "compact"])
def test_pair_bytes_match_jax(wire):
    counts = np.random.default_rng(0).integers(0, 40, (5, 5))
    for d in (2, 6):
        assert_exact(t_ex.get_wire(wire).pair_bytes(counts, 48, d),
                     j_ex.get_wire(wire).pair_bytes(counts, 48, d))


def test_block_halves_match_jax():
    """gather_block / scatter_block on one shard, and the all-shard
    wrappers on the stacked tables, against JAX's (padding dropped)."""
    jt = j_top.chord(60)
    st = j_part.shard_topology(jt, j_part.make_partition(jt, 3))
    S, B, D, d = 3, st.part.block, st.D, 2
    rng = np.random.default_rng(1)
    out_m = rng.standard_normal((S, B, D, d)).astype(np.float32)
    out_c = rng.standard_normal((S, B, D)).astype(np.float32)
    deliv = rng.random((S, B, D)) < 0.5
    in_m = rng.standard_normal((S, B, D, d)).astype(np.float32)
    in_c = rng.standard_normal((S, B, D)).astype(np.float32)
    h = st.halo
    th = t_part.HaloTables(*(torch.tensor(a) for a in h))
    T = lambda a: torch.tensor(a)  # noqa: E731
    got = t_ex.gather_halo(T(out_m), T(out_c), T(deliv), th)
    want = j_ex.gather_halo(jnp.asarray(out_m), jnp.asarray(out_c),
                            jnp.asarray(deliv), h)
    for g, w in zip(got, want):
        assert_exact(g, w)
    one = t_ex.gather_block(T(out_m[1]), T(out_c[1]), T(deliv[1]),
                            th.send_row[1], th.send_slot[1], th.send_ok[1])
    for g, w in zip(one, got):
        assert_exact(g, w[1])
    bufs = [t_ex.transpose_all_to_all(g) for g in got]
    got_in = t_ex.scatter_halo(T(in_m), T(in_c), *bufs, th)
    want_in = j_ex.scatter_halo(
        jnp.asarray(in_m), jnp.asarray(in_c),
        *(j_ex.transpose_all_to_all(w) for w in want), h)
    for g, w in zip(got_in, want_in):
        assert_exact(g, w)
    one_in = t_ex.scatter_block(T(in_m[2]), T(in_c[2]), bufs[0][2],
                                bufs[1][2], bufs[2][2], th.recv_row[2],
                                th.recv_slot[2])
    for g, w in zip(one_in, got_in):
        assert_exact(g, w[2])


# ---------------------------------------------------------------------------
# ShardedLSS against JAX's, dispatch by dispatch
# ---------------------------------------------------------------------------


def _inputs(n, seed=0):
    x = np.random.default_rng(seed).standard_normal((n, 2)).astype(
        np.float32)
    return (j_wvs.from_vector(jnp.asarray(x), jnp.ones((n,), jnp.float32)),
            t_wvs.from_vector(torch.tensor(x), torch.ones(n)))


def _regions(fam):
    """(JAX region, port region) — a halfspace threshold away from the
    data mean (ROADMAP C: the mean is a rounding tie for ``want``)."""
    rng = np.random.default_rng(4)
    if fam == "voronoi":
        c = rng.standard_normal((3, 2)).astype(np.float32)
        return (j_regions.VoronoiRegions(jnp.asarray(c)),
                t_regions.VoronoiRegions(torch.tensor(c)))
    w = np.array([1.0, 0.5], np.float32)
    b = np.float32(0.3)
    return (j_regions.HalfspaceRegions(w=jnp.asarray(w), b=jnp.asarray(b)),
            t_regions.HalfspaceRegions(w=torch.tensor(w), b=torch.tensor(b)))


def _engines(topo_name, shards, k, fam="voronoi", use_kernels=None):
    """The JAX engine (reference formulas) and the port's, with
    ``use_kernels`` on the port's side."""
    jt, tt = TOPOS[topo_name](j_top), TOPOS[topo_name](t_top)
    centers = np.random.default_rng(5).standard_normal((3, 2)).astype(
        np.float32)
    jreg, treg = _regions(fam)
    jeng = JShardedLSS(jt, jnp.asarray(centers), j_lss.LSSConfig(),
                       JEngineConfig(num_shards=shards,
                                     cycles_per_dispatch=k),
                       region=jreg)
    teng = ShardedLSS(tt, torch.tensor(centers), t_lss.LSSConfig(),
                      EngineConfig(num_shards=shards, cycles_per_dispatch=k,
                                   use_kernels=use_kernels),
                      region=treg, device="cpu")
    return jeng, teng


def _assert_core_fields(got, want, msg):
    got = convert.state_to_numpy(got)
    for name in got:
        w = np.asarray(getattr(want, name))
        if name in FLOATS:
            assert_close(got[name], w, f"{msg}: {name}")
        else:
            assert_exact(got[name], w, f"{msg}: {name}")


def _assert_metrics(tm, jm, msg):
    assert float(tm[0]) == float(jm[0]) and bool(tm[1]) == bool(jm[1]), msg
    assert_exact(tm[2], jm[2], msg)


@pytest.mark.parametrize("topo_name,shards,k,fam", [
    ("grid", 2, 1, "voronoi"),
    ("chord", 3, 7, "voronoi"),
    ("ba", 3, 1, "halfspace"),
    ("grid", 2, 7, "halfspace"),
])
def test_engine_matches_jax_dispatch_by_dispatch(topo_name, shards, k, fam):
    jeng, teng = _engines(topo_name, shards, k, fam)
    jin, tin = _inputs(jeng.n)
    jst, tst = jeng.init(jin, seed=0), teng.init(tin, seed=0)
    for step in range(42 // k):
        jst, tst = jeng.run(jst, k), teng.run(tst, k)
        msg = f"dispatch {step}"
        _assert_core_fields(teng.to_lss_state(tst), jeng.to_lss_state(jst),
                            msg)
        _assert_metrics(teng.metrics(tst), jeng.metrics(jst), msg)
    assert bool(teng.metrics(tst)[1])  # a genuine stopping state


def test_engine_resumes_from_a_jax_state():
    """Both engines continue from one mid-run JAX state, carried across
    with ``convert.sharded_state_from_jax_numpy``; the fused suite (its
    plain versions on the CPU) steps the port's side, cycle by cycle, with
    the do-while's iteration count (``_cycle_full(with_stats=True)``)."""
    jeng, teng = _engines("chord", 3, 1, use_kernels=True)
    assert teng.suite.name == "fused"
    jin, _ = _inputs(jeng.n)
    jst = jeng.run(jeng.init(jin, seed=0), 3)
    fields = {f: np.asarray(getattr(jst, f)) for f in jst._fields
              if getattr(jst, f) is not None}
    tst = convert.sharded_state_from_jax_numpy(fields, "cpu", seed=1)
    back = convert.state_to_numpy(tst)
    for name in back:
        assert_exact(back[name], fields[name], name)
    assert len(tst.rng) == 3
    for c in range(8):
        jst, j_iters = jeng._cycle_full(jst, jeng._tables, with_stats=True)
        tst, iters = teng._cycle_full(tst, teng._tables, with_stats=True)
        _assert_core_fields(teng.to_lss_state(tst), jeng.to_lss_state(jst),
                            f"cycle {c}")
        _assert_metrics(teng.metrics(tst), jeng.metrics(jst), f"cycle {c}")
        assert iters == int(j_iters), f"cycle {c}: do-while iterations"


# ---------------------------------------------------------------------------
# ShardedLSS against the port's own core
# ---------------------------------------------------------------------------


def _assert_bitwise(got, want, msg=""):
    for name in t_lss.LSSState._fields:
        if name != "rng":
            assert torch.equal(getattr(got, name), getattr(want, name)), \
                f"{msg}: {name}"


@pytest.mark.parametrize("shards,method,wire", [
    (1, "bfs", "exact"), (3, "stride", "exact"), (3, "bfs", "compact"),
    (5, "bfs", "compact")])
def test_engine_equals_core_bitwise(shards, method, wire):
    """S = 1, the stride partition and the compact wire: the port's engine
    gives the port's core state bitwise, and the same metrics."""
    topo = t_top.barabasi_albert(90, m=2, seed=1)
    spec = t_sim.ProblemSpec(n=topo.n)
    centers, _, _, inputs = t_sim._setup(topo, spec, "cpu")
    eng = ShardedLSS(topo, centers, t_lss.LSSConfig(),
                     EngineConfig(num_shards=shards, cycles_per_dispatch=4,
                                  method=method, wire=wire), device="cpu")
    est = eng.init(inputs, seed=0)
    ta = t_lss.TopoArrays.from_topology(topo, "cpu")
    core = t_lss.init_state(ta, inputs, seed=0)
    suite = get_suite("reference")
    for step in range(6):
        est = eng.run(est, 4)
        for _ in range(4):
            core, _ = t_lss.cycle(core, ta, centers, t_lss.LSSConfig(),
                                  suite=suite)
        _assert_bitwise(eng.to_lss_state(est), core, f"dispatch {step}")
        acc, q, correct = t_lss.metrics(core, ta, centers)
        e_acc, e_q, e_correct = eng.metrics(est)
        assert float(acc) == float(e_acc) and bool(q) == bool(e_q)
        assert torch.equal(correct, e_correct)


def test_compact_wire_trims_and_matches_exact():
    topo = t_top.grid(144)
    centers, _, _, inputs = t_sim._setup(topo, t_sim.ProblemSpec(n=144),
                                         "cpu")
    ex, co = (ShardedLSS(topo, centers, t_lss.LSSConfig(),
                         EngineConfig(num_shards=4, halo_slack=1.5,
                                      wire=w), device="cpu")
              for w in ("exact", "compact"))
    assert co._tables.halo.send_ok.shape[-1] % 8 == 0
    assert co._tables.halo.send_ok.shape[-1] < ex.stopo.halo_width
    assert co.wire_pair_bytes(2).sum() < ex.wire_pair_bytes(2).sum()
    a, b = ex.run(ex.init(inputs), 24), co.run(co.init(inputs), 24)
    for name in ("out_m", "out_c", "in_m", "in_c", "pending", "last_send",
                 "msgs", "t"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


# ---------------------------------------------------------------------------
# the driver's engine route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,check_every", [
    (2, 1), ("cfg-k1", 1), ("cfg-k5", 3)], ids=["int", "cfg-k1", "cfg-k5"])
@pytest.mark.parametrize("topo_name", ["grid", "chord"])
def test_run_static_engine_route(topo_name, engine, check_every):
    """engine=2 / EngineConfig == engine=None observed at the same grain
    (``max(check_every, cycles_per_dispatch)``; 8 for ``engine=2``), and
    == JAX's engine route."""
    grain = {2: 8, "cfg-k1": 1, "cfg-k5": 5}[engine]

    def ecfg(mod):
        if engine == 2:
            return 2
        return mod.EngineConfig(num_shards=3, cycles_per_dispatch=grain)

    import repro.engine as j_engine
    import repro_torch.engine as t_engine
    jt, tt = TOPOS[topo_name](j_top), TOPOS[topo_name](t_top)
    spec = dict(n=jt.n, seed=2)
    want = j_sim.run_static(jt, j_sim.ProblemSpec(**spec), max_cycles=120,
                            check_every=check_every, engine=ecfg(j_engine))
    got = t_sim.run_static(tt, t_sim.ProblemSpec(**spec), max_cycles=120,
                           check_every=check_every, engine=ecfg(t_engine),
                           device="cpu")
    core = t_sim.run_static(tt, t_sim.ProblemSpec(**spec), max_cycles=120,
                            check_every=max(check_every, grain),
                            device="cpu")
    assert got["quiesced_at"] is not None
    for key in STATIC_KEYS:
        assert got[key] == want[key], key
        if key in core:
            assert got[key] == core[key], key


@pytest.mark.parametrize("dyn", [False, True], ids=["alive-mask", "dyntopo"])
def test_run_dynamic_engine_route(dyn):
    import repro.engine as j_engine
    import repro_torch.engine as t_engine

    def topo(mod):
        t = mod.grid(256)
        return mod.DynTopology.from_topology(t) if dyn else t

    # Seed 2 never draws an already-dead peer for churn (ROADMAP C.4).
    kw = dict(cycles=60, noise_ppmc=20_000.0, churn_ppmc=1_500.0, warmup=10)
    spec = dict(n=256, seed=2)
    want = j_sim.run_dynamic(topo(j_top), j_sim.ProblemSpec(**spec),
                             engine=j_engine.EngineConfig(num_shards=3),
                             **kw)
    got = t_sim.run_dynamic(topo(t_top), t_sim.ProblemSpec(**spec),
                            engine=t_engine.EngineConfig(num_shards=3),
                            device="cpu", **kw)
    core = t_sim.run_dynamic(topo(t_top), t_sim.ProblemSpec(**spec),
                             device="cpu", **kw)
    assert got["alive_frac"] < 1.0
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key
        assert got[key] == core[key], key


def test_run_dynamic_engine_dyntopology_rekill_raises_in_both():
    """ROADMAP C.4 on the engine route: a churn draw that picks a dead
    peer makes ``remove_peer`` raise in both packages."""
    kw = dict(cycles=60, noise_ppmc=20_000.0, churn_ppmc=3_000.0, warmup=10)
    for mod, sim_mod, extra in ((j_top, j_sim, {}),
                                (t_top, t_sim, {"device": "cpu"})):
        dyn = mod.DynTopology.from_topology(mod.grid(256))
        with pytest.raises(ValueError, match="not present"):
            sim_mod.run_dynamic(dyn, sim_mod.ProblemSpec(n=256), engine=2,
                                **kw, **extra)


# ---------------------------------------------------------------------------
# state placement, migration, hooks, options
# ---------------------------------------------------------------------------


def _engine(topo, shards, method="bfs", **kw):
    centers, _, _, inputs = t_sim._setup(topo, t_sim.ProblemSpec(n=topo.n),
                                         "cpu")
    eng = ShardedLSS(topo, centers, t_lss.LSSConfig(**kw),
                     EngineConfig(num_shards=shards, method=method,
                                  cycles_per_dispatch=3), device="cpu")
    return eng, inputs


def test_place_and_migrate_between_shard_counts():
    topo = t_top.chord(60)
    e2, inputs = _engine(topo, 2)
    e3, _ = _engine(topo, 3, method="stride")
    st2 = e2.run(e2.init(inputs, seed=0), 9)
    snap = e2.to_lss_state(st2)
    placed = e2.place_lss_state(snap)
    _assert_bitwise(e2.to_lss_state(placed), snap, "round trip")
    assert int(placed.msgs[0]) == int(snap.msgs) and \
        int(placed.msgs[1:].sum()) == 0
    st3 = e3.migrate_from(e2, st2)
    _assert_bitwise(e3.to_lss_state(st3), snap, "migrated")
    # Both layouts go on to the same states.
    a, b = e2.run(st2, 12), e3.run(st3, 12)
    _assert_bitwise(e3.to_lss_state(b), e2.to_lss_state(a), "after")


def test_migrate_carries_drop_generators_between_equal_shard_counts():
    topo = t_top.grid(64)
    ea, inputs = _engine(topo, 2, drop_rate=0.2)
    eb, _ = _engine(topo, 2, method="stride", drop_rate=0.2)
    st = ea.run(ea.init(inputs, seed=7), 4)
    moved = eb.migrate_from(ea, st)
    for g, h in zip(moved.rng, st.rng):
        assert g is not h and torch.equal(g.get_state(), h.get_state())


def test_dynamic_hooks_use_original_ids():
    topo = t_top.grid(36)
    eng, inputs = _engine(topo, 3)
    est = eng.init(inputs, seed=0)
    who = np.array([0, 7, 35])
    vals = np.full((3, 2), 9.5, np.float32)
    est = eng.set_inputs(est, who, vals)
    est = eng.kill_peers(est, np.array([5, 11]))
    est = eng.set_alive(est, np.array([11]), True)
    est = eng.run(est, 6)
    est = eng.clear_slots(est, np.array([3, 20]), np.array([1, 0]))
    un = eng.to_lss_state(est)
    assert_exact(un.x_m[who], vals)
    alive = un.alive.numpy()
    assert not alive[5] and alive[11] and alive.sum() == 35
    assert float(un.out_c[3, 1]) == 0.0 and not bool(un.pending[20, 0])


@pytest.mark.parametrize("what", ["use_mesh", "auto_plan"])
def test_unported_options_raise(what):
    topo = t_top.grid(16)
    item = {"use_mesh": "A.5", "auto_plan": "A.8"}[what]
    centers = torch.zeros((3, 2))
    with pytest.raises(NotImplementedError, match=item):
        if what == "auto_plan":
            ShardedLSS(topo, centers, ecfg=EngineConfig(auto_plan=True),
                       device="cpu")
        else:
            ShardedLSS(topo, centers, device="cpu").use_mesh(None, "shards")
    with pytest.raises(ValueError, match="unknown wire"):
        t_ex.get_wire("fp4")


@pytest.mark.parametrize("what", ["audit", "profile"])
def test_audit_and_profile_options_run(what):
    """``ShardedLSS.audit`` and ``EngineConfig(profile=True)`` run (A.7):
    the audit returns Python scalars that pass every monitor on a clean
    state, and the profiled engine publishes its gauges and steps the
    same state as the unprofiled one."""
    from repro_torch.obs import InMemoryTracker
    from repro_torch.obs import audit as t_audit

    topo = t_top.grid(36)
    eng, inputs = _engine(topo, 3)
    est = eng.run(eng.init(inputs, seed=0), 6)
    if what == "audit":
        raw = eng.audit(est)
        assert all(isinstance(v, (bool, int, float)) for v in raw.values())
        assert t_audit.evaluate(raw).ok and raw["edge_checked"] > 0
        return
    tr = InMemoryTracker()
    prof = ShardedLSS(topo, eng.centers, eng.cfg,
                      eng.ecfg._replace(profile=True), tracker=tr,
                      device="cpu")
    pst = prof.run(prof.init(inputs, seed=0), 6)
    for a, b in zip(pst, est):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert prof._profiled.calls == 2  # two dispatches of K = 3
    assert tr.registry.gauge("host_overhead_frac").value(
        backend="engine") is not None


def test_opaque_decide_cannot_ride_the_fused_suite():
    topo = t_top.grid(16)
    custom = lambda v: (v[..., 0] > 0).to(torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="opaque"):
        ShardedLSS(topo, torch.zeros((3, 2)),
                   ecfg=EngineConfig(use_kernels=True), decide=custom,
                   device="cpu")
    eng = ShardedLSS(topo, torch.zeros((3, 2)), decide=custom, device="cpu")
    assert not eng.use_kernels and eng.suite.name == "reference"
    asked = ShardedLSS(topo, torch.zeros((3, 2)), decide=custom,
                       ecfg=EngineConfig(use_kernels=False), device="cpu")
    assert asked.suite.name == "reference"
    _, inputs = _engine(topo, 2)
    est = eng.run(eng.init(inputs), 8)
    assert int(eng.total_msgs(est)) > 0


def test_message_loss_is_seeded_and_converges():
    topo = t_top.grid(144)
    spec = t_sim.ProblemSpec(n=144)
    cfg = t_lss.LSSConfig(drop_rate=0.2)
    runs = [t_sim.run_static(topo, spec, cfg, max_cycles=600, engine=3,
                             device="cpu") for _ in range(2)]
    assert runs[0] == runs[1]
    assert runs[0]["final_accuracy"] == 1.0 and runs[0]["quiescent"]
    lossless = t_sim.run_static(topo, spec, max_cycles=600, engine=3,
                                device="cpu")
    assert runs[0]["total_msgs"] != lossless["total_msgs"]


def test_dispatch_spans_and_halo_counters():
    topo = t_top.grid(64)
    centers, _, _, inputs = t_sim._setup(topo, t_sim.ProblemSpec(n=64),
                                         "cpu")
    tracker = InMemoryTracker()
    eng = ShardedLSS(topo, centers, ecfg=EngineConfig(
        num_shards=3, cycles_per_dispatch=4, wire="compact"),
        tracker=tracker, device="cpu")
    eng.run(eng.init(inputs), 10)
    spans = tracker.spans_named("engine.dispatch")
    assert [sp.attrs["k"] for sp in spans] == [4, 4, 2]
    pair = eng.wire_pair_bytes(2)
    for sp in spans:
        assert sp.attrs["mode"] == "sync"
        assert sp.attrs["transport"] == "gather"
        assert sp.attrs["suite"] == "reference" and not sp.attrs["fused"]
        assert sp.attrs["wire"] == "compact"
        assert sp.attrs["cut_edges"] == eng.stopo.cut_edges()
        assert sp.attrs["halo_bytes"] == int(pair.sum()) * sp.attrs["k"]
        assert "recompiled" not in sp.attrs
    text = tracker.prometheus_text()
    for name in ("engine_shard_halo_bytes_total", "engine_shard_cut_edges",
                 "engine_halo_padding_frac"):
        assert name in text


def test_apply_membership_matches_a_fresh_engine():
    """Engine tables repaired after DynTopology edits equal those of an
    engine built on the edited topology with the same partition."""
    dyn = t_top.DynTopology.from_topology(t_top.grid(64), n_cap=72,
                                          deg_cap=6)
    eng, _ = _engine(dyn, 3)
    v0 = dyn.version
    _edit(dyn)
    assert eng.apply_membership(dyn) is True  # the halo width regrew
    assert eng._topo_version == dyn.version and v0 < dyn.version
    full = t_part.shard_topology(dyn, eng.part,
                                 halo_width=eng.stopo.halo_width)
    _assert_tables_equal(eng.stopo, full)
    want = DeviceTopo.from_sharded(full, "cpu")
    for name, a in eng._tables._asdict().items():
        for g, w in (zip(a, getattr(want, name)) if name == "halo"
                     else ((a, getattr(want, name)),)):
            assert g.dtype == w.dtype and torch.equal(g, w), name
    assert eng.apply_membership(dyn) is False


def test_sharded_state_layout():
    """Per-shard fields, padding rows dead, one generator per shard."""
    eng, inputs = _engine(t_top.grid(49), 4)  # B = 13: three padding rows
    st = eng.init(inputs, seed=3)
    assert st.out_m.shape == (4, 13, eng.D, 2) and st.msgs.shape == (4,)
    assert int(st.alive.sum()) == 49 and len(st.rng) == 4
    assert st.msgs.dtype == torch.int64 and st.t.dtype == torch.int32
    assert len({g.initial_seed() for g in st.rng}) == 4
    again = eng.init(inputs, seed=3)
    assert [g.initial_seed() for g in again.rng] == \
        [g.initial_seed() for g in st.rng]
