"""The port's engine autotuner (``repro_torch.engine.autotune``) and its
cost counter (``repro_torch.launch.cost``) against the JAX package's
``repro.engine.autotune`` and ``repro.launch.hlo_cost``.

The candidate grid and the wire byte model must equal JAX's exactly; the
plan table and ``auto_plan`` are held to the twins of
``tests/test_wire.py:395`` and ``:417``, and the counter to the twin of
``tests/test_hlo_cost.py:10`` (a scanned matmul scales with its trip
count).  The counted flops and bytes have no JAX twin to equal: JAX
reads them from compiled HLO, the port counts the ops it runs.  On the
CPU the model's constants are JAX's.
"""

import math

import numpy as np
import pytest
import torch

from repro.core import lss as j_lss
from repro.core import topology as j_top
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro.engine import autotune as j_autotune
from repro_torch.core import lss, sim, topology, wvs
from repro_torch.engine import EngineConfig, ShardedLSS, autotune
from repro_torch.launch import cost

BASES = (EngineConfig(), EngineConfig(num_shards=4, cycles_per_dispatch=1),
         EngineConfig(cycles_per_dispatch=10, wire="int8"),
         EngineConfig(num_shards=3, cycles_per_dispatch=3, wire="compact",
                      halo_slack=1.5))
WIRE_CANDS = tuple(autotune.Candidate(s, 1.5, 2, w) for s in (2, 4)
                   for w in ("exact", "compact", "int8", "bf16"))


def _centers():
    return np.random.default_rng(0).standard_normal((3, 2)).astype(
        np.float32)


@pytest.mark.parametrize("base", BASES, ids=range(len(BASES)))
def test_default_candidates_match_jax(base):
    jbase = JEngineConfig(**base._asdict())
    assert ([tuple(c) for c in autotune.default_candidates(base)]
            == [tuple(c) for c in j_autotune.default_candidates(jbase)])


def test_constants_and_rates():
    for name in ("FLOPS_PER_S", "HBM_BYTES_PER_S", "NET_BYTES_PER_S",
                 "DISPATCH_US"):
        assert getattr(autotune, name) == getattr(j_autotune, name)
    assert autotune.rates("cpu") == (j_autotune.FLOPS_PER_S,
                                     j_autotune.HBM_BYTES_PER_S)
    assert autotune.rates("cuda") == (67e12, 3.35e12)  # the H100's


def test_wire_bytes_match_jax():
    """Every candidate's ``wire_bytes`` is JAX's ``wire_pair_bytes(d)
    .sum()`` for the same plan, exactly (grid(400), S = 2 and 4, the four
    wires, ranked by the model alone)."""
    centers = _centers()
    res = autotune.plan(topology.grid(400), centers, candidates=WIRE_CANDS,
                        measure=False, device="cpu")
    assert [e.cand for e in res.table] == list(WIRE_CANDS)
    jt = j_top.grid(400)
    for e in res.table:
        jeng = JShardedLSS(jt, centers, j_lss.LSSConfig(),
                           JEngineConfig(num_shards=e.cand.num_shards,
                                         halo_slack=e.cand.halo_slack,
                                         cycles_per_dispatch=e.cand.k,
                                         wire=e.cand.wire))
        assert e.wire_bytes == int(jeng.wire_pair_bytes(2).sum()), e.cand
        assert math.isnan(e.measured_us)
        assert e.flops > 0 and e.hbm_bytes > 0 and e.collective_bytes == 0
    best = min(res.table, key=lambda e: e.modeled_us)
    assert res.chosen == best.cand


def test_autotune_plan_table_and_acceptance():
    """The twin of ``tests/test_wire.py:395``: the adopted plan is the
    measured argmin, compact ships fewer bytes than exact and the model
    ranks it at or below exact at equal K."""
    topo = topology.grid(400)
    centers = torch.tensor(_centers())
    cands = [autotune.Candidate(2, 1.5, k, w)
             for k in (2, 8) for w in ("exact", "compact")]
    res = autotune.plan(topo, centers, candidates=cands, repeats=2,
                        device="cpu")
    assert len(res.table) == 4
    best = min(e.measured_us for e in res.table)
    chosen = next(e for e in res.table if e.cand == res.chosen)
    assert chosen.measured_us == best
    assert res.config.auto_plan is False
    assert res.config.cycles_per_dispatch == res.chosen.k
    assert res.config.wire == res.chosen.wire
    by_wire = {(e.cand.k, e.cand.wire): e for e in res.table}
    assert by_wire[(8, "compact")].wire_bytes < \
        by_wire[(8, "exact")].wire_bytes
    assert by_wire[(8, "compact")].modeled_us <= \
        by_wire[(8, "exact")].modeled_us
    assert all(e.build_s > 0 for e in res.table)
    table = autotune.format_table(res)
    assert "chosen" in table and table.count("\n") == 6


def test_auto_plan_constructs_and_runs():
    """The twin of ``tests/test_wire.py:417``."""
    topo = topology.grid(100)
    centers = torch.tensor(_centers())
    eng = ShardedLSS(topo, centers, lss.LSSConfig(),
                     EngineConfig(num_shards=2, cycles_per_dispatch=4,
                                  auto_plan=True), device="cpu")
    assert eng.ecfg.auto_plan is False  # plan adopted, no re-planning
    x = torch.randn((topo.n, 2), generator=torch.Generator().manual_seed(1))
    st = eng.run(eng.init(wvs.WV(m=x, c=torch.ones((topo.n,)))), 8)
    assert int(st.t) == 8


def test_run_static_auto_plan_equals_adopted_config(monkeypatch):
    """``run_static(engine=EngineConfig(auto_plan=True))`` gives the result
    of a run at the configuration its plan adopted."""
    planned = []
    plan = autotune.plan

    def record(*args, **kw):
        planned.append(plan(*args, **kw))
        return planned[-1]

    monkeypatch.setattr(autotune, "plan", record)
    topo, spec = topology.grid(36), sim.ProblemSpec(n=36, seed=2)
    got = sim.run_static(topo, spec, engine=EngineConfig(
        num_shards=3, cycles_per_dispatch=2, auto_plan=True), device="cpu")
    (res,) = planned
    assert res.config.num_shards == 3 and not res.config.auto_plan
    assert got == sim.run_static(topo, spec, engine=res.config,
                                 device="cpu")


# -- the cost counter ------------------------------------------------------

def test_analyze_scan_flops_scale_with_trip_count():
    """The twin of ``tests/test_hlo_cost.py:10``: a looped matmul counts
    its body's flops times the trip count."""
    D = 64
    w, x = torch.zeros((D, D)), torch.zeros((8, D))

    def f(w, x, k):
        for _ in range(k):
            x = torch.tanh(x @ w)
        return x

    per_mm = 2 * 8 * D * D
    res = cost.analyze(f, w, x, 7)
    assert 6.5 * per_mm <= res["flops"] <= 9 * per_mm, res["flops"]
    one = cost.analyze(f, w, x, 1)
    assert res["hbm_bytes"] == pytest.approx(7 * one["hbm_bytes"])
    assert res["collective_bytes"] == {"all-to-all": 0.0,
                                       "all-gather": 0.0, "all-reduce": 0.0,
                                       "reduce-scatter": 0.0, "total": 0.0}


def test_analyze_engine_dispatch_k_multiplier():
    """The twin of ``tests/test_hlo_cost.py:83``: a K-cycle dispatch
    counts about K times one cycle (the do-while's iterations follow the
    data, so the ratio is not exact), and the suites count the same: the
    kernel hooks count by shape and pause the torch ops inside them."""
    topo = topology.grid(64)
    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=64), "cpu")

    def counted(k, use_kernels):
        eng = ShardedLSS(topo, centers, lss.LSSConfig(),
                         EngineConfig(num_shards=2, cycles_per_dispatch=k,
                                      use_kernels=use_kernels),
                         device="cpu")
        return cost.analyze(eng.run, eng.init(inputs, seed=0), k)

    c2, c12 = counted(2, None), counted(12, None)
    assert c2["hbm_bytes"] > 0
    assert 4.0 <= c12["hbm_bytes"] / c2["hbm_bytes"] <= 8.0
    fused = counted(12, True)
    assert (fused["hbm_bytes"], fused["flops"]) == (c12["hbm_bytes"],
                                                    c12["flops"])
    assert not cost.counting()


def test_analyze_counts_kernels_once():
    """A suite hook counts its kernel model and none of its own torch ops;
    nested hooks add nothing while paused."""
    with_hook = {}

    def body():
        with cost.kernel(100, 7):
            torch.ones(1000) + 1  # not counted
            with cost.kernel(5, 5):  # paused: not counted
                pass
        with_hook["counting"] = cost.counting()

    res = cost.analyze(body)
    assert (res["hbm_bytes"], res["flops"]) == (100, 7)
    assert with_hook["counting"] and not cost.counting()
