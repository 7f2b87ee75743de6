"""The port's observability plane (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and the service's alerts, profiling and flight
triggers against JAX's service.

The host-side modules (``schema``, ``trace``, ``alerts``, ``push``,
``dashboard``, ``forensics``, ``validate``) are copies: each is fed the
same inputs as its JAX twin (the same records, the same registry series,
the same calls) and must give equal results: validator errors, assembled
forests, rendered strings, alert transitions, pushed payloads, forensic
joins, exactly.  The record streams come from the port's own service under
churn, with the audit, alerts and profiling on; they pass both packages'
validators.

The service's observability knobs run on both backends, synchronous and
overlapped: ``ProfiledDispatch`` publishes its gauges (fenced by a CUDA
event on the card, nothing to fence here), ``profiler_dir`` writes a
Chrome trace, alert records equal JAX's, the flight recorder dumps on the
same triggers and under the same names as JAX's (SLO violation, alert,
epoch, crash), the engine backend counts ``engine_halo_bytes_total`` as
JAX's does, and records and states are bitwise equal with every knob on
and off.
"""

import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import topology as j_top
from repro.obs import forensics as j_forensics
from repro.obs import validate as j_validate
from repro.service import Service as JService
from repro.service import ServiceConfig as JConfig
from repro.service import SLOSpec as JSLO
import repro_torch.obs as tobs
from repro_torch.core import lss as t_lss
from repro_torch.core import topology as t_top
from repro_torch.engine import EngineConfig, ShardedLSS
from repro_torch.obs import forensics as t_forensics
from repro_torch.obs import validate as t_validate
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from repro_torch.service import SLOSpec as TSLO
from repro_torch.service import heterogeneous_tenants
import test_trace as jt
from test_torch_audit import _port_fault
from test_torch_service import _port_spec

MODES = [("core", False), ("engine", False), ("core", True),
         ("engine", True)]
MODE_IDS = ["core", "engine", "core-overlap", "engine-overlap"]


def _rule(pkg):
    return (pkg.AlertRule(name="always", metric="service_queue_depth",
                          above=-1.0),)


def _config(backend="core", **cfg_kw):
    """``test_trace._serve``'s configuration."""
    kw = dict(capacity=3, k_max=3, d=2, cycles_per_dispatch=2)
    if backend == "engine":
        kw.update(backend="engine", engine_shards=2)
    kw.update(cfg_kw)
    return kw


def _jax_serve(tracker=None, ticks=3, graph=None, slo=None, **cfg_kw):
    svc = JService(graph if graph is not None else j_top.grid(36),
                   JConfig(**cfg_kw), tracker=tracker)
    for s in jt._specs(36, 3):
        svc.admit(s if slo is None else dataclasses.replace(s, slo=slo))
    return svc, [r for _ in range(ticks) for r in svc.tick()]


def _port_serve(tracker=None, ticks=3, graph=None, slo=None,
                overlap=False, **cfg_kw):
    """``test_trace._serve`` on the port (its tenants carried across);
    an overlapped service is flushed, so its records are all landed."""
    svc = TService(graph if graph is not None else t_top.grid(36),
                   TConfig(**cfg_kw, overlap=overlap), tracker=tracker,
                   device="cpu")
    for s in jt._specs(36, 3):
        svc.admit(_port_spec(s if slo is None
                             else dataclasses.replace(s, slo=slo)))
    out = [r for _ in range(ticks) for r in svc.tick()]
    return svc, out + svc.flush()


# ---------------------------------------------------------------------------
# record streams of the port's service
# ---------------------------------------------------------------------------


def _churn(svc, dyn, rng):
    """A regrow epoch, joins, links and updates between ticks."""
    svc.tick()
    svc.grow_capacity(n_cap=dyn.n_cap + 8)
    for _ in range(3):
        p = svc.join_peer(value=rng.normal(size=2))
        svc.link_peers(p, int(rng.integers(36)))
    who = rng.choice(36, size=4, replace=False)
    svc.push_updates(who, rng.normal(size=(who.size, 2)), mode="set")
    svc.tick()
    svc.tick()


@functools.lru_cache(maxsize=None)
def _stream(backend="core", overlap=False, fault=False):
    """The port's service under churn with the audit, alerts and
    profiling on, as its tracker recorded it (``fault``: a corrupted
    knowledge vector, observed by two zero-cycle ticks)."""
    base = t_top.grid(36)
    dyn = t_top.DynTopology.from_topology(base, n_cap=base.n + 2,
                                          deg_cap=base.max_deg + 2)
    tr = tobs.InMemoryTracker()
    cfg = _config(backend, capacity=2, cycles_per_dispatch=4,
                  profile_dispatch=True, alerts=_rule(tobs), audit_every=1)
    with TService(dyn, TConfig(**cfg, overlap=overlap), tracker=tr,
                  device="cpu") as svc:
        for spec in heterogeneous_tenants(dyn.n, 3):
            svc.admit(spec)
        _churn(svc, dyn, np.random.default_rng(0))
        if fault:
            svc.flush()
            snap = svc.backend.snapshot(svc.states, 0)
            bad = _port_fault("corrupt_knowledge", snap,
                              t_lss.TopoArrays.from_topology(svc.topo, "cpu"),
                              None)
            svc.states = svc.backend.restore_slot(svc.states, 0, bad)
            svc.tick(cycles=0)
            svc.tick(cycles=0)
    return tuple(tr.records)


# ---------------------------------------------------------------------------
# the copied host modules, held to JAX's
# ---------------------------------------------------------------------------


GOLDEN = [
    {"dispatch": 1, "t": 2, "query": "q0", "slot": 0, "accuracy": 1.0,
     "quiescent": True, "region": 1, "msgs": 3, "msgs_per_link": 0.1,
     "topo_version": 0, "trace_id": "t00001:q0"},
    {"kind": "control", "dispatch": 1, "t": 2, "queue_depth": 0,
     "preempted_depth": 0, "spans": {"dispatch": 0.1},
     "boundary": {"epochs": 1}},
    {"kind": "span", "name": "dispatch", "span_id": 3, "seconds": 0.1,
     "parent_id": 1, "trace": ["t00001:q0"], "attrs": {"k": 2}},
    {"kind": "alert", "rule": "r", "metric": "m", "value": 1.0,
     "state": "firing", "dispatch": 0, "t": 0, "sustain": 2, "labels": {}},
    {"kind": "flight", "reason": "crash", "records": 9, "error": "boom"},
    {"kind": "audit", "dispatch": 2, "t": 4, "query": "q0", "slot": 0,
     "ok": False, "violations": 1, "residual": 3.0, "tol": 1e-5,
     "trace_id": "t00001:q0", "monitors": {"conservation": False},
     "mag": 2.0, "quiescent": False, "edge_bad": 0},
]
BROKEN = [
    {**GOLDEN[0], "accuracy": "high"}, {**GOLDEN[0], "mystery": 1},
    {**GOLDEN[0], "quiescent": 1}, {"kind": "martian"},
    {k: v for k, v in GOLDEN[1].items() if k != "queue_depth"},
    {**GOLDEN[2], "span_id": "three"}, {"kind": "span", "name": "x"},
    {**GOLDEN[5], "monitors": "all good"},
]


def test_schema_matches_jax():
    for name in ("PER_QUERY_REQUIRED", "PER_QUERY_OPTIONAL",
                 "CONTROL_REQUIRED", "CONTROL_OPTIONAL", "SPAN_REQUIRED",
                 "SPAN_OPTIONAL", "ALERT_REQUIRED", "ALERT_OPTIONAL",
                 "FLIGHT_REQUIRED", "FLIGHT_OPTIONAL", "AUDIT_REQUIRED",
                 "AUDIT_OPTIONAL"):
        assert getattr(tobs, name) == getattr(jobs, name), name
    for rec in GOLDEN + BROKEN:
        assert tobs.validate_record(rec) == jobs.validate_record(rec), rec
    for rec in GOLDEN:
        assert tobs.validate_record(rec) == [], rec
    for rec in BROKEN:
        assert tobs.validate_record(rec), rec
    stream = GOLDEN + BROKEN
    assert tobs.validate_stream(stream) == jobs.validate_stream(stream)


@pytest.mark.parametrize("backend,overlap", MODES, ids=MODE_IDS)
def test_port_stream_passes_both_validators(backend, overlap):
    records = list(_stream(backend, overlap))
    kinds = {r.get("kind", "query") for r in records}
    assert {"query", "control", "span", "alert", "audit"} <= kinds
    assert tobs.validate_stream(records) == []
    assert jobs.validate_stream(records) == []
    assert all(r["ok"] for r in records if r.get("kind") == "audit")


@pytest.mark.parametrize("overlap", [False, True])
def test_assemble_and_trace_view_match_jax(overlap):
    records = list(_stream("core", overlap))
    got, want = tobs.assemble(records), jobs.assemble(records)

    def nodes(forest):
        return [(n.span_id, n.name, n.parent_id, n.trace, n.seconds,
                 n.attrs, [c.span_id for c in n.children])
                for n in sorted(forest.nodes.values(),
                                key=lambda n: n.span_id)]

    assert nodes(got) == nodes(want)
    assert [n.span_id for n in got.roots] == [n.span_id for n in want.roots]
    assert got.orphans == want.orphans == []
    assert got.trace_ids() == want.trace_ids() and len(got.trace_ids()) == 3
    for tid in got.trace_ids():
        a, b = got.tenant(tid), want.tenant(tid)
        assert ([n.span_id for n in a.nodes]
                == [n.span_id for n in b.nodes])
        for pair in (("dispatch", "admission"), ("observe", "admission"),
                     ("epoch_regrow", "admission")):
            assert a.has_ancestry(*pair) == b.has_ancestry(*pair)
        assert tobs.trace_view(records, trace_id=tid) == jobs.trace_view(
            records, trace_id=tid)
    assert tobs.trace_view(records) == jobs.trace_view(records)
    assert tobs.trace_view([{"query": "q0"}]) == jobs.trace_view(
        [{"query": "q0"}])


def test_renderers_match_jax():
    records = list(_stream("engine", False, fault=True))
    for fn in ("render_dashboard", "render_controls", "render_audits",
               "render_fleet_header"):
        assert getattr(tobs, fn)(records) == getattr(jobs, fn)(records), fn
    for values, kw in (([], {}), ([0.0, 0.5, 1.0], {"width": 3}),
                       ([0.7, 0.7], {"lo": None, "hi": None}),
                       (list(np.linspace(-1.0, 3.0, 40)), {"width": 12})):
        assert tobs.sparkline(values, **kw) == jobs.sparkline(values, **kw)
    hists = []
    for pkg in (tobs, jobs):
        h = pkg.MetricsRegistry().histogram("lat", buckets=(0.1, 1.0))
        hists.append((pkg, h, pkg.render_histogram(h)))
        for v in (0.05, 0.5, 0.5, 5.0):
            h.observe(v, span="tick")
    (_, th, t_empty), (_, jh, j_empty) = hists
    assert t_empty == j_empty and "no samples" in t_empty
    assert (tobs.render_histogram(th, span="tick")
            == jobs.render_histogram(jh, span="tick"))


def _alert_series(pkg, case):
    """One scripted registry series through ``pkg``'s AlertEngine;
    returns every evaluation's records and the firing keys."""
    reg = pkg.MetricsRegistry()
    out = []
    if case == "percentile":
        h = reg.histogram("lat", buckets=(1.0, 10.0))
        for _ in range(9):
            h.observe(0.5, span="x")
        h.observe(50.0, span="x")
        eng = pkg.AlertEngine(
            [pkg.AlertRule("mean_hi", "lat", above=8.0),
             pkg.AlertRule("tail_hi", "lat", above=8.0, percentile=95.0)],
            reg)
        out.append(eng.evaluate(dispatch=1, t=1))
        return out, eng.firing()
    if case == "label":
        eng = pkg.AlertEngine([pkg.AlertRule(
            name="q-acc", metric="tenant_accuracy", below=0.5,
            labels=(("query", "q1"),))], reg)
        g = reg.gauge("tenant_accuracy")
        g.set(0.1, query="q1")
        g.set(0.1, query="q2")
        out.append(eng.evaluate())
        reg.remove_labels(query="q1")
        out.append(eng.evaluate())
        return out, eng.firing()
    sustain = 3 if case == "sustain" else 2
    eng = pkg.AlertEngine([pkg.AlertRule(name="hot", metric="temp",
                                         above=10.0, sustain=sustain)], reg)
    g = reg.gauge("temp")
    series = ((50.0, 50.0, 50.0, 50.0, 5.0, 50.0) if case == "sustain"
              else (50.0, 5.0, 50.0, 5.0))
    for i, v in enumerate(series):
        g.set(v)
        out.append(eng.evaluate(dispatch=i, t=2 * i))
    return out, eng.firing()


@pytest.mark.parametrize("case", ["sustain", "blip", "label",
                                  "percentile"])
def test_alert_engine_transitions_match_jax(case):
    got, want = _alert_series(tobs, case), _alert_series(jobs, case)
    assert got == want
    fired = [r for batch in got[0] for r in batch]
    assert all(tobs.validate_record(r) == [] for r in fired)
    if case != "blip":
        assert fired


def _push_calls(pkg):
    tr = pkg.PushTracker(flush_every=3)
    steps = [tr.log({"a": 1}), tr.log({"a": 2}), tr.log({"a": 3}),
             tr.log({"a": 4}, step=10), tr.log({"b": 5}, step=10)]
    with pytest.raises(ValueError):
        tr.log({"a": 5}, step=3)
    tr.log_metrics({"depth": 2.0}, backend="core")
    tr.log_record({"kind": "control", "dispatch": 1})
    before = [list(b) for b in tr.pushed]
    tr.close()
    return (steps, before, tr.pushed,
            tr.registry.gauge("depth").value(backend="core"))


def test_push_tracker_matches_jax():
    assert _push_calls(tobs) == _push_calls(jobs)


def test_forensics_matches_jax_on_one_stream(tmp_path):
    records = list(_stream("core", False, fault=True))
    got, want = (t_forensics.provenance(records),
                 j_forensics.provenance(records))
    assert got["violation"] == want["violation"]
    assert got["violation"] is t_forensics.first_violation(records)
    for key in ("failed", "last_clean", "control"):
        assert got[key] == want[key], key
    assert (got["span"].span_id, got["span"].name) == (
        want["span"].span_id, want["span"].name)
    assert "conservation" in got["failed"]
    for trace in (False, True):
        assert (t_forensics.render(got, show_trace=trace)
                == j_forensics.render(want, show_trace=trace))
    assert t_forensics.render(None) == j_forensics.render(None)
    qid = got["violation"]["query"]
    assert (t_forensics.first_violation(records, query=qid)
            == j_forensics.first_violation(records, query=qid))
    path = tmp_path / "stream.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    assert t_forensics.main([str(path)]) == j_forensics.main([str(path)]) \
        == 1
    assert t_forensics.load_jsonl(str(path)) == j_forensics.load_jsonl(
        str(path))


def test_validate_cli_on_the_port(tmp_path, capsys):
    """``python -m repro_torch.obs.validate --device cpu`` serves its churn
    run and passes; its stream passes JAX's file checks too."""
    assert t_validate.main(["--device", "cpu"]) == 0
    assert "telemetry contract OK" in capsys.readouterr().out
    path = str(tmp_path / "churn.jsonl")
    t_validate._churn_run(path, "cpu")
    assert j_validate.validate_file(path) == []
    assert t_validate.validate_file(path) == []
    for check in ("_check_boundary_spans", "_check_trace_tree",
                  "_check_audit"):
        assert getattr(j_validate, check)(path) == []
        assert getattr(t_validate, check)(path) == []
    assert t_validate.main([path]) == 0
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "martian"}\nnot json\n')
    assert t_validate.main([str(bad)]) == j_validate.main([str(bad)]) == 1


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_profiled_dispatch_unit_semantics():
    tr = tobs.InMemoryTracker()
    fn = tobs.ProfiledDispatch(lambda x: x * 2, tr, backend="unit")
    out = fn(torch.arange(4.0))
    assert torch.equal(out, torch.tensor([0.0, 2.0, 4.0, 6.0]))
    assert fn.calls == fn.sampled == 1
    last = fn.last
    assert last["host_ms"] >= 0 and last["device_ms"] >= 0
    assert last["total_ms"] == pytest.approx(last["host_ms"]
                                             + last["device_ms"])
    assert tr.registry.gauge("dispatch_host_ms").value(backend="unit") \
        == pytest.approx(last["host_ms"])
    # Publishing goes through log_metrics only: a Noop tracker drops it.
    noop = tobs.NoopTracker()
    tobs.ProfiledDispatch(lambda x: x, noop, backend="unit")(1)
    assert noop.registry.names() == []
    # sample_every=3 fences and publishes calls 0 and 3 of 5.
    every = tobs.ProfiledDispatch(lambda x: x, tobs.InMemoryTracker(),
                                  sample_every=3)
    for i in range(5):
        assert every(i) == i
    assert (every.calls, every.sampled) == (5, 2)
    assert len(every.tracker.metrics) == 2


@pytest.mark.parametrize("backend,overlap", MODES, ids=MODE_IDS)
def test_profiled_dispatch_gauges_on_both_backends(backend, overlap):
    tr = tobs.InMemoryTracker()
    svc, _ = _port_serve(tracker=tr, ticks=3, overlap=overlap,
                         profile_dispatch=True, profile_sample_every=2,
                         **_config(backend))
    reg = tr.registry
    for name in ("dispatch_host_ms", "dispatch_device_ms",
                 "host_overhead_frac"):
        val = reg.gauge(name).value(backend=backend)
        assert val is not None and val >= 0.0, (backend, name)
    assert 0.0 <= reg.gauge("host_overhead_frac").value(
        backend=backend) <= 1.0
    prof = svc._dispatch_call
    assert (prof.calls, prof.sampled) == (3, 2)
    assert len(tr.metrics) == 2  # published once per sampled dispatch
    svc.close()


@pytest.mark.parametrize("overlap", [False, True])
def test_profiler_dir_writes_a_chrome_trace(tmp_path, overlap):
    svc, _ = _port_serve(ticks=2, overlap=overlap, profile_dispatch=True,
                         profiler_dir=str(tmp_path), **_config())
    svc.close()
    traces = [f for f in os.listdir(tmp_path)
              if f.endswith(".pt.trace.json")]
    assert len(traces) == 2  # one session a dispatch
    trace = json.loads((tmp_path / traces[0]).read_text())
    assert trace["traceEvents"]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_engine_profile_flag_bitwise_parity(mode):
    """``EngineConfig(profile=True)`` on ``test_trace.py``'s engine: the
    same state as unprofiled, one sampled ``engine`` attribution a
    dispatch."""
    topo = t_top.grid(25)
    centers, sample, _, _ = jt.sim.make_problem(jt.sim.ProblemSpec(n=25,
                                                                   seed=0))
    x = sample(np.random.default_rng(0), topo.n)
    from repro_torch.core import wvs as t_wvs

    inputs = t_wvs.from_vector(torch.tensor(np.asarray(x)),
                               torch.ones((topo.n,)))
    outs = []
    for profile, tracker in ((False, None), (True, tobs.InMemoryTracker())):
        eng = ShardedLSS(topo, torch.tensor(np.asarray(centers)),
                         t_lss.LSSConfig(),
                         EngineConfig(num_shards=2, cycles_per_dispatch=4,
                                      profile=profile,
                                      async_mode=mode == "async",
                                      staleness=1 if mode == "async" else 0),
                         tracker=tracker, device="cpu")
        outs.append(eng.run(eng.init(inputs, seed=0), 8))
    base = lambda s: s.sync if mode == "async" else s  # noqa: E731
    for a, b in zip(base(outs[0]), base(outs[1])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert eng._profiled.sampled == 2
    assert tracker.registry.gauge("host_overhead_frac").value(
        backend="engine") is not None


# ---------------------------------------------------------------------------
# alerts and flight triggers in the service, against JAX's
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_alerts(backend):
    tr = jobs.InMemoryTracker()
    svc, recs = _jax_serve(tracker=tr, ticks=2, alerts=_rule(jobs),
                           **_config(backend))
    svc.close()
    return recs, [r for r in tr.records if r.get("kind") == "alert"]


@pytest.mark.parametrize("backend,overlap", MODES, ids=MODE_IDS)
def test_service_alerts_match_jax(backend, overlap):
    tr = tobs.InMemoryTracker()
    svc, recs = _port_serve(tracker=tr, ticks=2, overlap=overlap,
                            alerts=_rule(tobs), **_config(backend))
    svc.close()
    jrecs, jalerts = _jax_alerts(backend)
    alerts = [r for r in tr.records if r.get("kind") == "alert"]
    assert alerts == jalerts and len(alerts) == 1
    assert alerts[0]["rule"] == "always" and alerts[0]["dispatch"] == 1
    assert recs == jrecs
    assert tobs.validate_stream(tr.records) == []


@pytest.mark.parametrize("overlap", [False, True])
def test_flight_dump_triggered_by_slo_violation_like_jax(tmp_path, overlap):
    """An impossible SLO violates at the first observe: the same dumps
    as JAX's, with the offending records and spans in the ring."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jsvc, _ = _jax_serve(ticks=2, slo=JSLO(target_accuracy=1.5),
                         flight_dump_dir=str(jdir), **_config())
    jsvc.close()
    svc, _ = _port_serve(ticks=2, slo=TSLO(target_accuracy=1.5),
                         overlap=overlap, flight_dump_dir=str(tdir),
                         **_config())
    svc.close()
    dumps = sorted(os.listdir(tdir))
    assert dumps == sorted(os.listdir(jdir))
    assert dumps and all("slo_violation" in d for d in dumps)
    lines = [json.loads(line) for line in open(tdir / dumps[0])]
    assert lines[0]["kind"] == "flight"
    assert lines[0]["reason"] == "slo_violation"
    assert any(r.get("slo_ok") is False for r in lines[1:])
    assert any(r.get("kind") == "span" for r in lines[1:])
    assert tobs.validate_stream(lines) == []


@pytest.mark.parametrize("overlap", [False, True])
def test_flight_dump_triggered_by_alert_and_manual_api(tmp_path, overlap):
    svc, _ = _port_serve(ticks=1, overlap=overlap, alerts=_rule(tobs),
                         flight_dump_dir=str(tmp_path), **_config())
    dumps = os.listdir(tmp_path)
    assert dumps == ["flight-d000001-alert.jsonl"]
    path = svc.dump_flight_recorder(reason="because")
    assert os.path.basename(path).endswith("because.jsonl")
    assert json.loads(open(path).readline())["reason"] == "because"
    svc.close()


@pytest.mark.parametrize("overlap", [False, True])
def test_flight_dump_on_crash(tmp_path, overlap):
    svc, _ = _port_serve(ticks=1, overlap=overlap,
                         flight_dump_dir=str(tmp_path), **_config())
    svc._dispatch_call = None  # break the dispatch path
    with pytest.raises(TypeError):
        svc.tick()
        svc.flush()
    assert any("crash" in d for d in os.listdir(tmp_path))
    svc.close()


def test_no_auto_dump_without_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    svc, _ = _port_serve(ticks=1, slo=TSLO(target_accuracy=1.5),
                         **_config())
    svc.close()
    assert os.listdir(".") == []  # violation happened, no dump


def _epoch_dumps(pkg_service, top, tmp, backend, overlap=None):
    """Serve, grow capacity between ticks, serve on; the dump names."""
    dyn = top.DynTopology.from_topology(top.grid(36), n_cap=38, deg_cap=6)
    cfg = _config(backend, capacity=2, flight_dump_dir=str(tmp))
    if overlap is None:
        svc = pkg_service(dyn, JConfig(**cfg))
        specs = jt._specs(dyn.n, 2)
    else:
        svc = pkg_service(dyn, TConfig(**cfg, overlap=overlap),
                          device="cpu")
        specs = [_port_spec(s) for s in jt._specs(dyn.n, 2)]
    for s in specs:
        svc.admit(s)
    svc.tick()
    svc.grow_capacity(n_cap=44)
    svc.tick()
    svc.tick()
    svc.flush()
    svc.close()
    return sorted(os.listdir(tmp))


@pytest.mark.parametrize("backend,overlap", MODES[:3], ids=MODE_IDS[:3])
def test_epoch_flight_dump_matches_jax(tmp_path, backend, overlap):
    """A grow epoch between ticks dumps ``flight-d<N>-epoch.jsonl`` at the
    window that carried it, in both packages."""
    want = _epoch_dumps(JService, j_top, tmp_path / "jax", backend)
    got = _epoch_dumps(TService, t_top, tmp_path / "port", backend, overlap)
    assert got == want == ["flight-d000002-epoch.jsonl"]
    header = json.loads(open(tmp_path / "port" / got[0]).readline())
    assert header["reason"] == "epoch" and header["dispatch"] == 2


@pytest.mark.parametrize("wire", ["exact", "compact"])
def test_engine_halo_bytes_counter_matches_jax(wire):
    jtr, ttr = jobs.InMemoryTracker(), tobs.InMemoryTracker()
    cfg = _config("engine", engine_wire=wire)
    jsvc, _ = _jax_serve(tracker=jtr, ticks=2, **cfg)
    tsvc, _ = _port_serve(tracker=ttr, ticks=2, **cfg)
    jsvc.close()
    tsvc.close()
    got = ttr.registry.get("engine_halo_bytes_total")
    want = jtr.registry.get("engine_halo_bytes_total")
    assert got is not None and got.value() == want.value() > 0
    assert ttr.registry.prometheus_text().count(
        "engine_halo_bytes_total") == jtr.registry.prometheus_text().count(
            "engine_halo_bytes_total")
    assert tobs.validate_stream(ttr.records) == []


def test_core_backend_has_no_halo_counter():
    tr = tobs.InMemoryTracker()
    svc, _ = _port_serve(tracker=tr, ticks=1, **_config())
    svc.close()
    assert tr.registry.get("engine_halo_bytes_total") is None
    assert svc.backend.halo_bytes_per_cycle() == 0
    assert svc.backend.capacity_slots() == 36 * 4


# ---------------------------------------------------------------------------
# tracking is a pure observer
# ---------------------------------------------------------------------------


def _run(tracker, backend, overlap, **cfg_kw):
    svc, out = _port_serve(tracker=tracker, ticks=4, overlap=overlap,
                           **_config(backend, **cfg_kw))
    states = svc.states
    svc.close()
    return out, states


def _assert_same_states(a, b):
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)


@pytest.mark.parametrize("backend", ["core", "engine"])
def test_push_tracker_service_parity(backend):
    rec_off, st_off = _run(tobs.NoopTracker(), backend, False)
    push = tobs.PushTracker(flush_every=4)
    rec_on, st_on = _run(push, backend, False)
    assert rec_on == rec_off
    _assert_same_states(st_on, st_off)
    recs = [p["record"] for batch in push.pushed for p in batch
            if "record" in p]
    assert recs and tobs.validate_stream(recs) == []


@pytest.mark.parametrize("backend,overlap", MODES, ids=MODE_IDS)
def test_full_instrumentation_bitwise_parity(tmp_path, backend, overlap):
    """Profiling, alerts, the audit, flight auto-dumps and tracing all on,
    against a bare NoopTracker run: records and states bitwise equal."""
    rec_off, st_off = _run(tobs.NoopTracker(), backend, overlap)
    rec_on, st_on = _run(tobs.InMemoryTracker(), backend, overlap,
                         profile_dispatch=True, alerts=_rule(tobs),
                         audit_every=1, flight_capacity=64,
                         flight_dump_dir=str(tmp_path))
    assert rec_on == rec_off  # floats exactly equal, trace ids included
    _assert_same_states(st_on, st_off)
    assert os.listdir(tmp_path)  # the alert dumped the ring


def test_jsonl_stream_round_trips_through_both_validators():
    buf = io.StringIO()
    with tobs.JsonlTracker(buf) as tr:
        svc, _ = _port_serve(tracker=tr, ticks=3, audit_every=2,
                             alerts=_rule(tobs), **_config("engine"))
        svc.close()
        recs = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert tobs.validate_stream(recs) == jobs.validate_stream(recs) == []
    assert sorted({r["dispatch"] for r in recs
                   if r.get("kind") == "audit"}) == [1, 3]
