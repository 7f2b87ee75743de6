"""The port's monitor service (``repro_torch.service``) against the JAX
package's ``repro.service.Service``, on the same numpy tenants.

Both services are driven in lockstep through the same calls.  Per-query
records (``dispatch, t, query, slot, accuracy, quiescent, region, msgs,
msgs_per_link, topo_version, trace_id`` and the SLO fields) must be equal
as dicts, which holds the floats exactly too; so must the per-slot
do-while iteration counts and the control records (without their span
timings).  Snapshots compare int and bool fields exactly and float moments
to rtol 1e-5 / atol 1e-5.  The port runs its reference suite and, where
parametrized, its fused suite (the kernels' plain versions on the CPU).
The tenants keep their halfspace thresholds away from the data mean:
``heterogeneous_tenants`` puts ``b`` at the mean, where the global decision
is a rounding tie that differs between any two summation orders.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import regions as j_regions
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.service import ControlPlaneConfig as JControl
from repro.service import QuerySpec as JSpec
from repro.service import Service as JService
from repro.service import ServiceConfig as JConfig
from repro.service import SLOSpec as JSLO
from repro.service import TelemetrySink as JSink
from repro_torch import convert
from repro_torch.core import topology as t_top
from repro_torch.core.lss import COLD_TIMER
from repro_torch.service import ControlPlaneConfig as TControl
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from repro_torch.service import TelemetrySink as TSink
from repro_torch.service import heterogeneous_tenants
from test_torch_formulas import assert_exact
from test_torch_lss import _assert_state

SUITES = ["reference", "fused"]


def _problem(n, seed):
    centers, sample, _, _ = j_sim.make_problem(j_sim.ProblemSpec(n=n,
                                                                 seed=seed))
    return np.asarray(centers), sample(np.random.default_rng(seed + 1), n)


def _voronoi(centers, x, **kw):
    return JSpec(region=j_regions.VoronoiRegions(jnp.asarray(centers)),
                 inputs=x, **kw)


def _port_spec(spec: JSpec):
    region = {f: np.asarray(v) for f, v in spec.region._asdict().items()}
    return convert.query_spec_from_numpy(
        region, spec.inputs, weights=spec.weights, beta=spec.beta,
        ell=spec.ell, eps=spec.eps, seed=spec.seed, priority=spec.priority,
        slo=None if spec.slo is None else spec.slo._asdict())


class Pair:
    """A JAX service and the port's, built alike and driven in lockstep."""

    def __init__(self, n, suite="reference", jtel=None, ttel=None, **cfg):
        control = cfg.pop("control", None)
        jcfg = JConfig(**cfg, **({"control": JControl(**control)}
                                 if control else {}))
        tcfg = TConfig(**cfg, use_kernels=suite,
                       **({"control": TControl(**control)}
                          if control else {}))
        self.j = JService(j_top.grid(n), jcfg, telemetry=jtel)
        self.t = TService(t_top.grid(n), tcfg, telemetry=ttel, device="cpu")

    def admit(self, spec, **kw):
        a = self.j.admit(spec, **kw)
        b = self.t.admit(_port_spec(spec), **kw)
        assert a == b
        return a

    def replace(self, qid, spec):
        self.j.replace(qid, spec)
        self.t.replace(qid, _port_spec(spec))

    def both(self, method, *args, **kw):
        a = getattr(self.j, method)(*args, **kw)
        b = getattr(self.t, method)(*args, **kw)
        return a, b

    def tick(self):
        want, got = self.both("tick")
        assert got == want
        assert_exact(self.t._corr_iters, np.asarray(self.j._corr_iters),
                     "per-slot do-while iterations")
        return got

    def check_snapshots(self, qids, msg=""):
        for qid in qids:
            js = self.j.snapshot(qid)
            _assert_state(self.t.snapshot(qid),
                          {f: np.asarray(getattr(js, f))
                           for f in js._fields if f != "rng"},
                          f"{msg} {qid}")
            if qid in self.t.registry._slot_of or qid in self.t._preempted:
                assert self.t.total_msgs(qid) == self.j.total_msgs(qid)


@pytest.mark.parametrize("suite", SUITES)
def test_one_query_matches_jax_for_40_ticks(suite):
    """The acceptance gate of the JAX service, held across the packages:
    one tenant in a 4-slot service, one cycle per tick, 40 ticks."""
    centers, x = _problem(64, seed=0)
    pair = Pair(64, suite, capacity=4, k_max=3, d=2, cycles_per_dispatch=1)
    qid = pair.admit(_voronoi(centers, x, seed=0))
    quiesced = False
    for tick in range(40):
        (rec,) = pair.tick()
        pair.check_snapshots([qid], f"tick {tick}")
        quiesced = rec["quiescent"]
    assert quiesced and rec["accuracy"] == 1.0
    assert pair.t.dispatch_info() == {"suite": suite, "fused": suite ==
                                      "fused", "recompiles": 0,
                                      "step_cache_size": None}


def _tenants(n, q):
    """tests/test_service.py::test_batched_queries_match_sequential_runs:
    alternating Voronoi / halfspace tenants with per-slot beta and ell;
    the first also carries an SLO."""
    rng = np.random.default_rng(9)
    specs = []
    for i in range(q):
        centers, x = _problem(n, seed=10 + i)
        if i % 2 == 0:
            fam = j_regions.VoronoiRegions(jnp.asarray(centers))
        else:
            w = jnp.asarray(rng.normal(size=2).astype(np.float32))
            fam = j_regions.HalfspaceRegions(w=w, b=jnp.float32(0.1))
        slo = (JSLO(target_accuracy=0.9, within_cycles=7,
                    max_msgs_per_link=3.0) if i == 0 else None)
        specs.append(JSpec(region=fam, inputs=x, seed=i,
                           beta=1e-3 if i % 3 else 2e-3, ell=1 + i % 2,
                           slo=slo))
    return specs


@pytest.mark.parametrize("suite", SUITES)
def test_heterogeneous_tenants_match_jax(suite):
    """Six mixed tenants with per-slot knobs over 4 dispatches of 7 cycles:
    records, do-while iterations, snapshots, totals and SLO books."""
    pair = Pair(49, suite, capacity=6, k_max=4, d=2, cycles_per_dispatch=7)
    qids = [pair.admit(s) for s in _tenants(49, 6)]
    for _ in range(4):
        recs = pair.tick()
        assert len(recs) == 6 and "slo_ok" in recs[0]
    pair.check_snapshots(qids)
    assert pair.t.slo_report() == pair.j.slo_report()
    # The JAX service's stacked states carry over as the port's.
    jstates = {f: np.asarray(getattr(pair.j.states, f))
               for f in pair.j.states._fields if f != "rng"}
    carried = convert.states_from_jax_numpy(jstates, "cpu", range(6))
    assert len(carried.rng) == 6
    _assert_state(carried, convert.state_to_numpy(pair.t.states),
                  "stacked states")


def test_padding_slots_send_zero():
    """Padding slots are no-ops: zero sends, nothing pending, message
    buffers untouched, while an active slot works beside them."""
    centers, x = _problem(36, seed=3)
    pair = Pair(36, capacity=5, k_max=3, d=2, cycles_per_dispatch=4)
    qid = pair.admit(_voronoi(centers, x, seed=0))
    for _ in range(5):
        pair.tick()
        assert not pair.t._corr_iters[1:].any()  # no padding peer corrects
    st = pair.t.states
    assert not st.pending[1:].any()
    assert bool((st.last_send[1:] == COLD_TIMER).all())  # none ever sent
    assert float(st.out_m[1:].abs().max()) == 0.0
    assert float(st.in_m[1:].abs().max()) == 0.0
    assert pair.t.total_msgs(qid) > 0


def test_admission_queue_retire_replace_and_slot_reuse():
    centers, x = _problem(25, seed=1)
    pair = Pair(25, capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
                admission_queue=2)
    half = JSpec(region=j_regions.HalfspaceRegions(w=jnp.asarray([1.0, 0.0]),
                                                   b=jnp.asarray(0.0)),
                 inputs=x)
    a = pair.admit(_voronoi(centers, x))
    b = pair.admit(half)
    c = pair.admit(_voronoi(centers, x, seed=4))
    assert pair.both("admission_status", c) == ("queued", "queued")
    pair.tick()
    pair.both("retire", a)  # c activates in a's slot at once
    assert pair.t.registry.slot_of(c) == pair.j.registry.slot_of(c) == 0
    assert pair.both("admission_status", a) == ("retired", "retired")
    pair.replace(b, _voronoi(centers, x, seed=9))
    assert int(pair.t.snapshot(b).t) == 0  # a fresh timeline
    pair.tick()
    pair.tick()
    pair.check_snapshots([b, c])
    with pytest.raises(KeyError):
        pair.t.retire("nope")
    full = TService(t_top.grid(25), TConfig(capacity=1, k_max=3, d=2,
                                            admission_queue=0), device="cpu")
    full.admit(_port_spec(_voronoi(centers, x)))
    with pytest.raises(RuntimeError):
        full.admit(_port_spec(_voronoi(centers, x)))


def test_ingest_set_and_delta():
    centers, x = _problem(25, seed=2)
    pair = Pair(25, capacity=3, k_max=3, d=2, cycles_per_dispatch=1)
    qa = pair.admit(_voronoi(centers, x, seed=0))
    qb = pair.admit(_voronoi(centers, x, seed=1))
    pair.both("push_updates", [0, 3], [[2.0, 2.0], [4.0, 4.0]], mode="set")
    pair.both("push_updates", [7], [[5.0, 5.0]], mode="set", query_ids=[qb])
    pair.tick()
    np.testing.assert_allclose(pair.t.snapshot(qb).x_m[[0, 3, 7]],
                               [[2, 2], [4, 4], [5, 5]])
    pair.both("push_updates", [0, 0], [[1.0, -1.0], [0.5, 0.5]],
              weights=[0.5, 0.25], mode="delta")
    pair.both("push_updates", [3], [[9.0, 9.0]], mode="set", query_ids=[])
    pair.tick()
    np.testing.assert_allclose(pair.t.snapshot(qa).x_m[0], [3.5, 1.5])
    np.testing.assert_allclose(pair.t.snapshot(qa).x_c[0], [1.75])
    for _ in range(3):
        pair.tick()
    pair.check_snapshots([qa, qb])


def test_priority_preemption_and_resume():
    """A high-priority arrival preempts; the suspended snapshot is exact,
    resume restores it bitwise, and everything matches the JAX service."""
    centers, x = _problem(25, seed=5)
    pair = Pair(25, capacity=1, k_max=3, d=2, cycles_per_dispatch=2,
                control={"scheduler": "priority", "preempt": True})
    a = pair.admit(_voronoi(centers, x, seed=0, priority=0))
    pair.tick()
    pair.tick()
    snap0 = pair.t.snapshot(a)
    b = pair.admit(_voronoi(centers, x, seed=1, priority=5))
    pair.tick()  # boundary: b preempts a
    assert pair.both("admission_status", a) == ("preempted", "preempted")
    assert pair.t.num_preempted == 1
    pair.check_snapshots([a, b])
    pair.both("push_updates", [2], [[1.0, 1.0]], mode="set", query_ids=[a])
    pair.tick()  # the update parks for a
    assert pair.t.ingest.num_parked(a) == 1
    pair.both("retire", b)  # a resumes at once, its update replayed
    assert pair.both("admission_status", a) == ("active", "active")
    resumed = convert.state_to_numpy(pair.t.snapshot(a))
    for name, value in convert.state_to_numpy(snap0).items():
        if name != "x_m":
            assert_exact(resumed[name], value, name)
    np.testing.assert_allclose(resumed["x_m"][2], [1.0, 1.0])
    for _ in range(3):
        pair.tick()
    pair.check_snapshots([a])
    controls = [{k: v for k, v in r.items() if k != "spans"}
                for r in pair.t.telemetry.controls()]
    assert controls == [{k: v for k, v in r.items() if k != "spans"}
                        for r in pair.j.telemetry.controls()]
    assert any(r.get("preempted") for r in controls)


def test_telemetry_jsonl_round_trip(tmp_path):
    """The port's sink writes the JAX sink's per-query and control
    records, byte for byte apart from span timings and ids."""
    centers, x = _problem(25, seed=6)
    paths = [tmp_path / "jax.jsonl", tmp_path / "port.jsonl"]
    with JSink(str(paths[0])) as jtel, TSink(str(paths[1])) as ttel:
        pair = Pair(25, capacity=2, k_max=3, d=2, cycles_per_dispatch=3,
                    admission_queue=2, jtel=jtel, ttel=ttel)
        for seed in range(3):  # the third waits in the queue
            pair.admit(_voronoi(centers, x, seed=seed,
                                slo=JSLO(max_msgs_per_link=1.0)))
        pair.both("push_updates", [1], [[0.5, 0.5]])
        for _ in range(3):
            pair.tick()
        kept = ttel.records
    lines = [[json.loads(line) for line in p.read_text().splitlines()]
             for p in paths]
    assert lines[1] == kept
    spans = {r["name"] for r in lines[1] if r.get("kind") == "span"}
    assert {"tick", "admission", "activate", "admission_drain",
            "ingest_apply", "dispatch", "observe"} <= spans

    def strip(records):
        return [{k: v for k, v in r.items() if k != "spans"}
                for r in records if r.get("kind") != "span"]

    assert strip(lines[1]) == strip(lines[0])
    assert any(r.get("kind") == "control" for r in strip(lines[1]))


def test_workload_matches_jax():
    """``heterogeneous_tenants`` builds the JAX twin's tenants."""
    from repro.service import heterogeneous_tenants as j_tenants
    for js, ts in zip(j_tenants(40, 4), heterogeneous_tenants(40, 4)):
        assert_exact(ts.inputs, js.inputs)
        assert (ts.beta, ts.ell, ts.seed) == (js.beta, js.ell, js.seed)
        for f, v in js.region._asdict().items():
            assert_exact(getattr(ts.region, f), np.asarray(v), f)


def test_unported_parts_raise_and_cpu_needs_asking():
    from repro_torch.obs import AlertRule, InMemoryTracker

    topo = t_top.grid(16)
    # The observability knobs construct and serve (A.7 is ported).
    rule = AlertRule(name="always", metric="service_queue_depth",
                     above=-1.0)
    for kw, kind in (({"profile_dispatch": True}, None),
                     ({"alerts": (rule,)}, "alert"),
                     ({"audit_every": 1}, "audit")):
        tr = InMemoryTracker()
        with TService(topo, TConfig(capacity=2, **kw), tracker=tr,
                      device="cpu") as svc:
            svc.admit(heterogeneous_tenants(topo.n, 1)[0])
            (rec,) = svc.tick()
        assert rec["dispatch"] == 1
        if kind is None:
            assert tr.registry.gauge("dispatch_host_ms").value(
                backend="core") >= 0.0
        else:
            assert [r["kind"] for r in tr.records
                    if r.get("kind") == kind] == [kind]
    # The overlapped boundary constructs and serves one tick late on both
    # backends, static and dynamic.
    dyn = t_top.DynTopology.from_topology(topo, n_cap=20)
    for graph in (topo, dyn):
        for backend in ("core", "engine"):
            with TService(graph, TConfig(backend=backend, capacity=2,
                                         overlap=True),
                          device="cpu") as svc:
                qid = svc.admit(heterogeneous_tenants(graph.n, 1)[0])
                assert svc.tick() == []
                (rec,) = svc.tick()
                assert rec["query"] == qid and rec["dispatch"] == 1
                (rec,) = svc.flush()
                assert rec["dispatch"] == 2 and svc._pending is None
    with TService(dyn, TConfig(), device="cpu") as svc:
        assert svc.membership is not None and svc.topo_version == 0
        assert svc.rebalance_now() is None and svc.drift() == 0.0
    # backend="engine" constructs and serves, static and dynamic alike.
    for graph in (topo, dyn):
        with TService(graph, TConfig(backend="engine", capacity=2),
                      device="cpu") as svc:
            qid = svc.admit(heterogeneous_tenants(graph.n, 1)[0])
            (rec,) = svc.tick()
            assert rec["query"] == qid and rec["dispatch"] == 1
            assert svc.dispatch_info()["suite"] == "reference"
            assert svc.rebalance_now()["kind"] == "rebalance"
            assert svc.drift() == 0.0
    with pytest.raises(ValueError, match="backend"):
        TService(topo, TConfig(backend="nope"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TService(topo, TConfig())
