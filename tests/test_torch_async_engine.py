"""The port's async engine mode (``EngineConfig(async_mode=True)``: the
bounded-staleness halo ring) against the port's sync engine and the JAX
package's async engine.

* staleness 0 is bitwise the port's sync engine, at drop 0 and under
  loss (the drop generators are untouched: delays are drawn only when
  staleness > 0), and equals the JAX async engine dispatch by dispatch at
  drop 0, books included (ints exactly, floats at rtol = atol = 1e-5);
* the ring functions equal JAX's on random per-shard clocks and read
  slots (JAX's delay draws are threefry, so at staleness > 0 the cycle
  itself is held to convergence instead, as ROADMAP C says of loss);
* staleness 2 converges on grid(64) at drop 0 while the sequence guard
  fires, and the realized delay stays within the budget.  At drop 0.2
  the JAX reference itself quiesces on a wrong answer (ROADMAP C.3), so
  loss is held only where JAX passes (``test_torch_wire.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro.engine import exchange as j_ex
from repro_torch import convert
from repro_torch.core import lss as t_lss
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top
from repro_torch.engine import (AsyncShardedState, EngineConfig, ShardedLSS,
                                ShardedState)
from repro_torch.engine import exchange as t_ex
from repro_torch.obs import InMemoryTracker
from test_torch_formulas import assert_close, assert_exact

BOOKS = ("clock", "out_seq", "last_seq", "ring_flag", "ring_seq",
         "stale_drops", "applied", "delay_sum")
FLOATS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c", "ring_m", "ring_c")


def _engine(topo, seed=0, drop=0.0, shards=4, k=2, **ecfg_kw):
    spec = t_sim.ProblemSpec(n=topo.n, seed=seed)
    centers, _, _, inputs = t_sim._setup(topo, spec, "cpu")
    eng = ShardedLSS(topo, centers, t_lss.LSSConfig(drop_rate=drop),
                     EngineConfig(num_shards=shards, cycles_per_dispatch=k,
                                  **ecfg_kw), device="cpu")
    return eng, inputs


def _jax_engine(topo, seed=0, shards=4, k=2, **ecfg_kw):
    spec = j_sim.ProblemSpec(n=topo.n, seed=seed)
    centers, sample, _, _ = j_sim.make_problem(spec)
    x = sample(np.random.default_rng(seed + 1), topo.n)
    inputs = j_wvs.from_vector(jnp.asarray(x),
                               jnp.ones((topo.n,), jnp.float32))
    eng = JShardedLSS(topo, centers, j_lss.LSSConfig(),
                      JEngineConfig(num_shards=shards, cycles_per_dispatch=k,
                                    **ecfg_kw))
    return eng, inputs


def _jax_fields(state):
    """A JAX engine state's fields as numpy (``rng`` and ``None``s
    dropped; an async state's sync fields under ``"sync"``)."""
    return {f: (_jax_fields(v) if f == "sync" else np.asarray(v))
            for f, v in state._asdict().items()
            if f != "rng" and v is not None}


def _assert_fields(got: dict, want: dict, msg):
    for name, w in want.items():
        if name == "sync":
            _assert_fields(got[name], w, msg)
        elif name in FLOATS:
            assert_close(got[name], w, f"{msg}: {name}")
        else:
            assert_exact(got[name], w, f"{msg}: {name}")


def _assert_bitwise(a, b, msg):
    """Two port states (either kind), every tensor field exactly."""
    fa, fb = convert.state_to_numpy(a), convert.state_to_numpy(b)
    fa, fb = fa.get("sync", fa), fb.get("sync", fb)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert_exact(fa[name], fb[name], f"{msg}: {name}")


# ---------------------------------------------------------------------------
# staleness 0
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop", [0.0, 0.3])
def test_async_staleness0_bitwise_equals_sync(drop):
    """R = 1 reproduces the sync engine bit for bit, drop stream included,
    and the metrics agree (nothing lingers in the ring)."""
    topo = t_top.grid(64)
    sync, inputs = _engine(topo, drop=drop)
    asyn, _ = _engine(topo, drop=drop, async_mode=True, staleness=0)
    s = sync.init(inputs, seed=7)
    a = asyn.init(inputs, seed=7)
    assert isinstance(a, AsyncShardedState) and a.ring_m.shape[0] == 1
    for i in range(3):
        s, a = sync.run(s, 4), asyn.run(a, 4)
        _assert_bitwise(s, a, f"round {i}")
        for g, h in zip(s.rng, a.sync.rng):
            assert torch.equal(g.get_state(), h.get_state())
    lag = asyn.async_lag_stats(a)
    assert lag["stale_drops"] == 0 and lag["mean_delay"] == 0.0
    assert lag["applied"] > 0
    assert not bool(asyn.async_in_flight(a))
    for x, y in zip(sync.metrics(s), asyn.metrics(a)):
        assert torch.equal(x, y)
    assert sync.total_msgs(s) == asyn.total_msgs(a)


@pytest.mark.parametrize("topo_name,shards,k", [("grid", 4, 2),
                                                ("chord", 3, 5),
                                                ("ba", 3, 1)])
def test_async_staleness0_matches_jax_dispatch_by_dispatch(topo_name,
                                                           shards, k):
    make = {"grid": lambda m: m.grid(64), "chord": lambda m: m.chord(60),
            "ba": lambda m: m.barabasi_albert(80, m=2, seed=3)}[topo_name]
    kw = dict(shards=shards, k=k, async_mode=True, staleness=0)
    jeng, jin = _jax_engine(make(j_top), **kw)
    teng, tin = _engine(make(t_top), **kw)
    jst, tst = jeng.init(jin, seed=0), teng.init(tin, seed=0)
    for step in range(30 // k):
        jst, tst = jeng.run(jst, k), teng.run(tst, k)
        _assert_fields(convert.state_to_numpy(tst), _jax_fields(jst),
                       f"dispatch {step}")
        tm, jm = teng.metrics(tst), jeng.metrics(jst)
        assert float(tm[0]) == float(jm[0]) and bool(tm[1]) == bool(jm[1])
        assert_exact(tm[2], jm[2])
    assert teng.async_lag_stats(tst) == jeng.async_lag_stats(jst)
    assert bool(teng.metrics(tst)[1])  # a genuine stopping state


def test_run_static_async_route_matches_jax():
    """``run_static(engine=EngineConfig(async_mode=True))`` through the
    driver: the same results as JAX's and as the port's sync engine."""
    import repro.engine as j_engine
    import repro_torch.engine as t_engine

    spec = dict(n=64, seed=2)
    res = {}
    for name, mod, sim_mod, top, extra in (
            ("jax", j_engine, j_sim, j_top, {}),
            ("port", t_engine, t_sim, t_top, {"device": "cpu"})):
        for mode in (False, True):
            res[name, mode] = sim_mod.run_static(
                top.grid(64), sim_mod.ProblemSpec(**spec), max_cycles=120,
                engine=mod.EngineConfig(num_shards=3, cycles_per_dispatch=4,
                                        async_mode=mode), **extra)
    assert res["port", True] == res["port", False]
    for key, want in res["jax", True].items():
        assert res["port", True][key] == want, key


# ---------------------------------------------------------------------------
# the ring functions
# ---------------------------------------------------------------------------


def _ring_case(seed, R=3, S=3, H=5, d=2):
    rng = np.random.default_rng(seed)
    ring = (rng.normal(size=(R, S, S, H, d)).astype(np.float32),
            rng.normal(size=(R, S, S, H)).astype(np.float32),
            rng.random((R, S, S, H)) < 0.5,
            rng.integers(0, 9, (R, S, S, H)).astype(np.int32))
    bufs = (rng.normal(size=(S, S, H, d)).astype(np.float32),
            rng.normal(size=(S, S, H)).astype(np.float32),
            rng.random((S, S, H)) < 0.5,
            rng.integers(0, 9, (S, S, H)).astype(np.int32))
    clock = rng.integers(0, 20, S).astype(np.int32)  # per-shard clocks
    delay = rng.integers(0, R, (S, S)).astype(np.int32)
    return ring, bufs, clock, delay


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_ring_publish_and_read_match_jax(seed):
    ring, bufs, clock, delay = _ring_case(seed, R=2 + seed % 2)
    R = ring[0].shape[0]
    T = lambda a: torch.tensor(a)  # noqa: E731
    jr = j_ex.ring_publish(*map(jnp.asarray, ring), jnp.asarray(clock % R),
                           *map(jnp.asarray, bufs))
    mine = tuple(T(a) for a in ring)
    tr = t_ex.ring_publish(*mine, T(clock % R).long(), *map(T, bufs))
    assert all(g is m for g, m in zip(tr, mine))  # written in place
    for g, w in zip(tr, jr):
        assert_exact(g, w)
    rslot = (clock[None, :] - np.minimum(delay, clock[None, :])) % R
    for g, w in zip(t_ex.ring_read(*tr, T(rslot)),
                    j_ex.ring_read(*jr, jnp.asarray(rslot))):
        assert g.shape == w.shape
        assert_exact(g, w)
    # Delay 0 reads the transpose of what was just published.
    now = t_ex.ring_read(*tr, T(np.broadcast_to(clock % R, (3, 3)).copy()))
    for g, b in zip(now, bufs):
        assert_exact(g, np.swapaxes(b, 0, 1))


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_seq_matches_jax(seed):
    jt = j_top.chord(60)
    from repro.engine import partition as j_part
    st = j_part.shard_topology(jt, j_part.make_partition(jt, 3))
    S, B, D, H = 3, st.part.block, st.D, st.halo_width
    rng = np.random.default_rng(seed)
    last = rng.integers(0, 5, (S, B, D)).astype(np.int32)
    seq = rng.integers(0, 9, (S, S, H)).astype(np.int32)
    ok = rng.random((S, S, H)) < 0.5
    h = st.halo
    want = j_ex.scatter_seq(jnp.asarray(last), jnp.asarray(seq),
                            jnp.asarray(ok), jnp.asarray(h.recv_row),
                            jnp.asarray(h.recv_slot))
    got = t_ex.scatter_seq(torch.tensor(last), torch.tensor(seq),
                           torch.tensor(ok),
                           torch.tensor(h.recv_row).long(),
                           torch.tensor(h.recv_slot).long())
    assert got.dtype == torch.int32
    assert_exact(got, want)


def test_async_in_flight_matches_jax_on_the_same_books():
    """Both packages flag the same ring as in flight, clock by clock (the
    slot they treat as aged out is ROADMAP C's reference fault)."""
    jeng, jin = _jax_engine(j_top.grid(64), async_mode=True, staleness=2)
    teng, _ = _engine(t_top.grid(64), async_mode=True, staleness=2)
    jst = jeng.init(jin, seed=1)
    seen = set()
    for c in range(12):
        jst = jeng.run(jst, 1)
        tst = convert.async_state_from_jax_numpy(_jax_fields(jst), "cpu")
        got = bool(teng.async_in_flight(tst))
        assert got == bool(jeng.async_in_flight(jst)), f"cycle {c}"
        seen.add(got)
        # Clearing the ring empties the flight, in both.
        flags = np.zeros(np.asarray(jst.ring_flag).shape, bool)
        assert not bool(teng.async_in_flight(
            tst._replace(ring_flag=torch.tensor(flags))))
    assert seen == {True, False}


# ---------------------------------------------------------------------------
# staleness > 0
# ---------------------------------------------------------------------------


def test_async_bounded_staleness_converges_and_guards():
    """A 2-cycle staleness budget at drop 0: halo reads lag, reordering
    happens (the seq guard fires), and the protocol still reaches full
    agreement and quiesces."""
    eng, inputs = _engine(t_top.grid(64), seed=3, async_mode=True,
                          staleness=2)
    a = eng.init(inputs, seed=7)
    assert a.ring_m.shape[:2] == (3, 4)
    acc = quiescent = None
    for _ in range(30):
        a = eng.run(a, 4)
        acc, quiescent, _ = eng.metrics(a)
        if float(acc) == 1.0 and bool(quiescent):
            break
    assert float(acc) == 1.0 and bool(quiescent)
    lag = eng.async_lag_stats(a)
    assert lag["applied"] > 0
    assert lag["stale_drops"] > 0  # reordering actually happened
    assert 0.0 < lag["mean_delay"] <= 2.0
    # Seeded: the same run again gives the same state.
    b = eng.init(inputs, seed=7)
    for _ in range(int(a.clock[0]) // 4):
        b = eng.run(b, 4)
    _assert_bitwise(a, b, "rerun")
    assert eng.async_lag_stats(b) == lag


def test_async_run_is_pure_and_draws_delays_apart_from_drops():
    """run() never writes into the state it is given (the ring is copied
    once a call), and at staleness > 0 the drop generators advance
    exactly as the sync engine's do."""
    topo = t_top.grid(64)
    eng, inputs = _engine(topo, drop=0.2, async_mode=True, staleness=2)
    sync, _ = _engine(topo, drop=0.2)
    a1 = eng.run(eng.init(inputs, seed=5), 6)
    s = sync.run(sync.init(inputs, seed=5), 6)
    for g, h in zip(s.rng, a1.sync.rng):
        assert torch.equal(g.get_state(), h.get_state())
    snap = convert.state_to_numpy(a1)
    eng.run(a1, 6)  # advances a1's generators in place, and nothing else
    again = convert.state_to_numpy(a1)
    for name in ("ring_m", "ring_flag", "ring_seq", "last_seq", "out_seq"):
        assert_exact(again[name], snap[name], name)


def test_async_run_publishes_staleness_gauges():
    """Non-noop trackers get the engine_async_* gauges after run()."""
    tr = InMemoryTracker()
    topo = t_top.grid(36)
    spec = t_sim.ProblemSpec(n=36, seed=4)
    centers, _, _, inputs = t_sim._setup(topo, spec, "cpu")
    eng = ShardedLSS(topo, centers, t_lss.LSSConfig(),
                     EngineConfig(num_shards=2, cycles_per_dispatch=2,
                                  async_mode=True, staleness=1),
                     tracker=tr, device="cpu")
    a = eng.run(eng.init(inputs, seed=1), 8)
    lag = eng.async_lag_stats(a)
    reg = tr.registry
    assert reg.gauge("engine_async_applied_total").value() == \
        float(lag["applied"])
    assert reg.gauge("engine_async_stale_drops_total").value() == \
        float(lag["stale_drops"])
    assert reg.gauge("engine_async_staleness_mean").value() == \
        pytest.approx(lag["mean_delay"])
    assert all(sp.attrs["mode"] == "async"
               for sp in tr.spans_named("engine.dispatch"))


# ---------------------------------------------------------------------------
# state kinds
# ---------------------------------------------------------------------------


def test_async_state_rejected_by_the_sync_hooks_in_both():
    """set_inputs / set_alive / kill_peers / clear_slots take a sync state
    in both packages; the port says so."""
    jeng, jin = _jax_engine(j_top.grid(36), async_mode=True)
    with pytest.raises(AttributeError):
        jeng.set_inputs(jeng.init(jin), np.array([0]),
                        np.zeros((1, 2), np.float32))
    teng, tin = _engine(t_top.grid(36), async_mode=True)
    a = teng.init(tin)
    for call in (lambda: teng.set_inputs(a, [0], np.zeros((1, 2))),
                 lambda: teng.kill_peers(a, [0]),
                 lambda: teng.set_alive(a, [0], True),
                 lambda: teng.clear_slots(a, [0], [0])):
        with pytest.raises(TypeError, match="AsyncShardedState"):
            call()
    # The sync half takes them, and re-wraps.
    s = teng.set_inputs(a.sync, [0], np.zeros((1, 2), np.float32))
    assert isinstance(teng.wrap_async(s), AsyncShardedState)


def test_init_sync_init_async_and_the_either_kind_methods():
    topo = t_top.grid(49)
    eng, inputs = _engine(topo, async_mode=True, staleness=1,
                          wire="compact")
    s = eng.init_sync(inputs, seed=3)
    a = eng.init(inputs, seed=3)
    assert isinstance(s, ShardedState) and isinstance(a, AsyncShardedState)
    W = int(eng._tables.halo.send_ok.shape[-1])
    assert W == eng._wire_w <= eng.stopo.halo_width  # the wire's width
    assert a.ring_m.shape == (2, eng.S, eng.S, W, 2)
    assert a.clock.dtype == torch.int32 and torch.equal(a.clock,
                                                       torch.zeros(eng.S))
    assert len(a.delay_rng) == eng.S
    a = eng.run(a, 5)
    assert torch.equal(a.clock, torch.full((eng.S,), 5, dtype=torch.int32))
    drained, total = eng.drain_msgs(a)
    assert isinstance(drained, AsyncShardedState)
    assert total == int(eng.total_msgs(a)) > 0
    assert int(eng.total_msgs(drained)) == 0
    assert torch.equal(eng.to_lss_state(a).out_m,
                       eng.to_lss_state(a.sync).out_m)
    back = convert.async_state_from_jax_numpy(convert.state_to_numpy(a),
                                              "cpu")
    _assert_bitwise(back, a, "round trip")
    for name in BOOKS + ("ring_m", "ring_c"):
        assert torch.equal(getattr(back, name), getattr(a, name)), name
