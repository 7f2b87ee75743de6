"""The port's audit plane (``repro_torch.obs.audit``, ``lss.audit_impl``,
``ShardedLSS.audit`` and the service's ``audit_every``) against the JAX
package's, on the same states.

The JAX states come from ``tests/test_audit.py``'s fixtures and are carried
into the port with ``repro_torch.convert``, so both packages audit one
state: the integer reductions (``edge_bad``, ``edge_checked``,
``stop_bad``, ``live_slots``, ``msgs``, ``t``, the async books), the
quiescence bit and every monitor's verdict must be equal; ``tol`` and
``mag`` are held to ``allclose(rtol=1e-5)``; ``resid`` is rounding noise,
compared only through its verdict against ``tol`` in each package.  The
faults are injected by each package's ``AuditFaults`` into its own copy of
the state.  ``corrupt_knowledge`` fires ``edge`` beside ``conservation``
on these states, in JAX as in the port (its docstring calls the edge
check blind, which float32 rounding belies), so the port is held to
JAX's verdicts, not to the docstring.

The service is driven in lockstep with JAX's (``tests/test_audit.py``'s
service, tenants carried across): audit records match JAX's on both
backends, sampling picks the same windows, the audit is a pure observer
(records and states bitwise equal with it on and off, synchronous and
overlapped), an injected fault raises the same failing records, counter
and flight dump, and forensics finds the same first violation.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_audit as ja
from repro.core import lss as j_lss
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro.obs import AuditFaults as JFaults
from repro.obs import InMemoryTracker as JInMemory
from repro.obs import audit as j_audit
from repro.obs import forensics as j_forensics
from repro.obs import validate_stream as j_validate_stream
from repro.service import Service as JService
from repro.service import ServiceConfig as JConfig
from repro_torch import convert
from repro_torch.core import lss as t_lss
from repro_torch.core import regions as t_regions
from repro_torch.core import topology as t_top
from repro_torch.engine import EngineConfig, ShardedLSS
from repro_torch.obs import AuditFaults, InMemoryTracker, validate_stream
from repro_torch.obs import audit as t_audit
from repro_torch.obs import forensics as t_forensics
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from test_torch_service import _port_spec

INTS = ("edge_bad", "edge_checked", "stop_bad", "quiescent", "live_slots",
        "msgs", "t")
BOOKS = ("seq_bad", "ring_bad", "stale_drops", "in_flight")


def _assert_raw(got: dict, want: dict, msg=""):
    """Port raw reductions against JAX's on the same state."""
    assert set(got) == set(want), msg
    for key in INTS + BOOKS:
        if key in want:
            assert int(got[key]) == int(want[key]), f"{msg}: {key}"
    for key in ("tol", "mag"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=f"{msg}: {key}")
    assert (float(got["resid"]) <= float(got["tol"])) == \
        (float(want["resid"]) <= float(want["tol"])), f"{msg}: resid"


def _jax_fields(state):
    """A JAX state's fields as numpy (``rng`` and ``None``s dropped; an
    async state's sync fields under ``"sync"``)."""
    return {f: (_jax_fields(v) if f == "sync" else np.asarray(v))
            for f, v in state._asdict().items()
            if f != "rng" and v is not None}


def _port_topo(topo):
    return convert.topo_from_numpy(topo.nbr, topo.mask, topo.rev, "cpu")


def _port_decide(centers):
    c = torch.tensor(np.asarray(centers))
    return lambda v: t_regions.decide_voronoi(v, c)  # noqa: E731


def _port_fault(fault, state, ta, delta):
    """The port's twin of ``test_audit._apply_fault``; ``delta`` is the
    skew JAX's ``_flip_delta`` computed on the same state."""
    if fault == "corrupt_knowledge":
        return AuditFaults.corrupt_knowledge(state, ta, row=0, delta=5.0)
    if fault == "drop_halo_message":
        return AuditFaults.drop_halo_message(state, ta, row=0, delta=5.0)
    return AuditFaults.skew_migration(state, np.asarray(delta), row=0)


def _failed(rep):
    return {m for m, held in rep.monitors.items() if not held}


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_core(cycles):
    centers, x = ja._problem()
    topo = j_top.grid(36)
    return (centers, topo) + ja._core_state(topo, centers, x,
                                            cycles=cycles)[:3]


def _core_pair(cycles=6):
    centers, topo, st, ta, decide = _jax_core(cycles)
    tst = convert.state_from_jax_numpy(_jax_fields(st), "cpu")
    return centers, topo, (st, ta, decide), (tst, _port_topo(topo),
                                            _port_decide(centers))


@pytest.mark.parametrize("cycles", [6, 46])
def test_core_clean_state_matches_jax(cycles):
    """Mid-convergence (6 cycles) and quiescent (46): every monitor holds
    in both, with equal reductions."""
    _, _, (st, ta, decide), (tst, tta, tdecide) = _core_pair(cycles)
    want = j_audit.audit_core(st, ta, decide)
    got = t_audit.audit_core(tst, tta, tdecide)
    _assert_raw(got, want)
    assert all(isinstance(v, (bool, int, float)) for v in got.values())
    assert got["edge_checked"] > 0
    assert bool(got["quiescent"]) == (cycles == 46)
    n, D = tta.nbr.shape
    for max_sent in (None, cycles * n * D):
        rep = t_audit.evaluate(got, max_sent=max_sent)
        assert rep.ok and rep.monitors == j_audit.evaluate(
            want, max_sent=max_sent).monitors


@pytest.mark.parametrize("fault", ja.FAULTS)
def test_core_fault_matches_jax(fault):
    centers, _, (st, ta, decide), (tst, tta, tdecide) = _core_pair()
    delta = (ja._flip_delta(st, ta, centers, row=0)
             if fault == "skew_migration" else None)
    jbad = ja._apply_fault(fault, st, ta, centers)
    tbad = _port_fault(fault, tst, tta, delta)
    for name, w in _jax_fields(jbad).items():  # the same edit, bitwise
        assert np.array_equal(getattr(tbad, name).numpy(), w), name
    claimed = True if fault == "skew_migration" else None
    want = j_audit.evaluate(j_audit.audit_core(jbad, ta, decide),
                            claimed_quiescent=claimed)
    got = t_audit.evaluate(t_audit.audit_core(tbad, tta, tdecide),
                           claimed_quiescent=claimed)
    _assert_raw(got.raw, want.raw, fault)
    assert got.monitors == want.monitors and got.ok is want.ok is False
    expect = {ja.FIRES[fault]}
    if fault == "corrupt_knowledge":
        expect.add("edge")  # float32 rounding: not blind (module doc)
    assert _failed(got) == expect


def test_core_edge_sampling_rotates_like_jax():
    centers, _, (st, ta, decide), (tst, tta, tdecide) = _core_pair()
    jbad = JFaults.drop_halo_message(st, ta, row=0, delta=5.0)
    tbad = AuditFaults.drop_halo_message(tst, tta, row=0, delta=5.0)
    mod, checked, hits = 4, 0, 0
    for phase in range(mod):
        got = t_audit.audit_core(tbad, tta, tdecide, sample_mod=mod,
                                 sample_phase=phase)
        want = j_audit.audit_core(jbad, ta, decide, sample_mod=mod,
                                  sample_phase=phase)
        _assert_raw(got, want, f"phase {phase}")
        checked += got["edge_checked"]
        hits += got["edge_bad"]
    full = t_audit.audit_core(tbad, tta, tdecide)
    assert checked == full["edge_checked"]
    assert hits == full["edge_bad"] > 0


def test_counter_monitor_bounds_the_exact_send_count_like_jax():
    _, _, (st, ta, decide), (tst, tta, tdecide) = _core_pair(cycles=4)
    got = t_audit.audit_core(tst, tta, tdecide)
    want = j_audit.audit_core(st, ta, decide)
    n, D = tta.nbr.shape
    assert t_audit.evaluate(got, max_sent=4 * n * D).ok
    rep = t_audit.evaluate(got, max_sent=0)
    assert _failed(rep) == {"counter"}
    assert rep.monitors == j_audit.evaluate(want, max_sent=0).monitors


def test_batched_audit_equals_unbatched_slot_by_slot():
    """``audit_impl`` over Q stacked slots (each its own family and eps)
    equals the unbatched call on each slot: ints exactly, floats to
    rtol 1e-5 and the residual's verdict."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.suite import get_suite

    centers, x = ja._problem()
    topo = j_top.grid(36)
    states = [ja._core_state(topo, centers, x, cycles=c, seed=s)[0]
              for c, s in ((3, 1), (6, 7), (40, 2))]
    fields = [_jax_fields(s) for s in states]
    stacked = convert.states_from_jax_numpy(
        {f: np.stack([fl[f] for fl in fields]) for f in fields[0]}, "cpu",
        seeds=[0, 1, 2])
    ta = _port_topo(topo)
    c = torch.tensor(np.asarray(centers))
    fams = t_regions.PackedRegions.pack(
        [t_regions.VoronoiRegions(c), t_regions.VoronoiRegions(c[:2]),
         t_regions.HalfspaceRegions(torch.tensor([1.0, -0.5]),
                                    torch.tensor(0.3))])
    slots = [fams.slot(q) for q in range(3)]
    eps = torch.tensor([1e-9, 1e-6, 1e-9])
    tables = ops.prep_slots(fams, eps)
    ref = get_suite("reference")
    raw = t_lss.audit_impl(stacked, ta, lambda v: ref.decide(v, tables),
                           eps=eps)
    for q, slot in enumerate(slots):
        one = convert.state_from_jax_numpy(fields[q], "cpu")
        want = t_lss.audit_impl(one, ta, slot.decide, eps=float(eps[q]))
        got = {k: v[q] for k, v in raw.items()}
        _assert_raw(got, want, f"slot {q}")
    assert all(v.shape == (3,) for v in raw.values())


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_engine(kind):
    """JAX's engine (``test_audit._engine``, or its int8-wire twin) after
    3 dispatches."""
    centers, x = ja._problem(n=64, seed=0)
    topo = j_top.grid(64)
    if kind != "int8":
        return (centers, topo) + ja._engine(
            topo, centers, x, async_mode=kind != "sync",
            staleness=2 if kind == "async2" else 0)
    jeng = JShardedLSS(topo, jnp.asarray(centers), j_lss.LSSConfig(),
                       JEngineConfig(num_shards=4, cycles_per_dispatch=2,
                                     wire="int8"))
    return centers, topo, jeng, jeng.run(jeng.init(j_wvs.from_vector(
        jnp.asarray(x), jnp.ones((topo.n,))), seed=7), 3)


def _engine_pair(kind="sync"):
    """JAX's engine and state (:func:`_jax_engine`), and the port's engine
    over the same partition holding the same state."""
    centers, topo, jeng, jst = _jax_engine(kind)
    ecfg = EngineConfig(num_shards=4, cycles_per_dispatch=2,
                        async_mode=kind.startswith("async"),
                        staleness=2 if kind == "async2" else 0,
                        wire="int8" if kind == "int8" else "exact")
    teng = ShardedLSS(t_top.grid(64), torch.tensor(np.asarray(centers)),
                      t_lss.LSSConfig(), ecfg, device="cpu")
    load = (convert.async_state_from_jax_numpy if kind.startswith("async")
            else convert.sharded_state_from_jax_numpy)
    tst = load(_jax_fields(jst), "cpu")
    return centers, topo, (jeng, jst), (teng, tst)


@pytest.mark.parametrize("kind", ["sync", "async0", "async2", "int8"])
def test_engine_clean_state_matches_jax(kind):
    _, _, (jeng, jst), (teng, tst) = _engine_pair(kind)
    want = jeng.audit(jst)
    got = teng.audit(tst)
    _assert_raw(got, want, kind)
    assert all(isinstance(v, (bool, int, float)) for v in got.values())
    metric = (teng.async_lag_stats(tst)["stale_drops"]
              if kind.startswith("async") else None)
    rep = t_audit.evaluate(got, stale_drops_metric=metric)
    assert rep.ok, (rep.monitors, got)
    assert rep.monitors == j_audit.evaluate(
        want, stale_drops_metric=metric).monitors
    assert ("seq" in rep.monitors) == kind.startswith("async")


@pytest.mark.parametrize("kind", ["sync", "async2"])
@pytest.mark.parametrize("fault", ja.FAULTS)
def test_engine_fault_matches_jax(kind, fault):
    centers, topo, (jeng, jst), (teng, tst) = _engine_pair(kind)
    ta = j_lss.TopoArrays.from_topology(topo)
    tta = _port_topo(topo)
    snap = jeng.to_lss_state(jst)
    delta = (ja._flip_delta(snap, ta, centers, row=0)
             if fault == "skew_migration" else None)
    jbad = JFaults.on_engine(
        jeng, jst, lambda s, *_: ja._apply_fault(fault, s, ta, centers))
    tbad = AuditFaults.on_engine(
        teng, tst, lambda s, *_: _port_fault(fault, s, tta, delta))
    claimed = True if fault == "skew_migration" else None
    want = j_audit.evaluate(jeng.audit(jbad), claimed_quiescent=claimed)
    got = t_audit.evaluate(teng.audit(tbad), claimed_quiescent=claimed)
    _assert_raw(got.raw, want.raw, f"{kind} {fault}")
    assert got.monitors == want.monitors
    assert ja.FIRES[fault] in _failed(got)
    assert _failed(got) <= {ja.FIRES[fault], "edge"}


def test_async_engine_seq_regression_fires_seq_like_jax():
    _, _, (jeng, jst), (teng, tst) = _engine_pair("async2")
    want = jeng.audit(JFaults.regress_seq(jst, jeng._tables, amount=1000))
    got = teng.audit(AuditFaults.regress_seq(tst, teng._tables,
                                             amount=1000))
    _assert_raw(got, want)
    rep = t_audit.evaluate(got)
    assert _failed(rep) == {"seq"}
    assert rep.monitors == j_audit.evaluate(want).monitors
    assert got["seq_bad"] > 0 or got["ring_bad"] > 0


def test_async_stale_drop_mismatch_fires_seq_like_jax():
    _, _, (jeng, jst), (teng, tst) = _engine_pair("async2")
    got, want = teng.audit(tst), jeng.audit(jst)
    rep = t_audit.evaluate(got, stale_drops_metric=got["stale_drops"] + 3)
    assert _failed(rep) == {"seq"}
    assert rep.monitors == j_audit.evaluate(
        want, stale_drops_metric=want["stale_drops"] + 3).monitors


# ---------------------------------------------------------------------------
# service: audit_every on both backends, synchronous and overlapped
# ---------------------------------------------------------------------------


def _config(backend, **cfg_kw):
    """``test_audit._service``'s configuration."""
    kw = dict(capacity=3, k_max=3, d=2, cycles_per_dispatch=2)
    if backend == "engine":
        kw.update(backend="engine", engine_shards=2)
    kw.update(cfg_kw)
    return kw


def _jax_service(backend, tracker, **cfg_kw):
    svc = JService(j_top.grid(36), JConfig(**_config(backend, **cfg_kw)),
                   tracker=tracker)
    centers, specs = ja._specs(36, 3)
    for s in specs:
        svc.admit(s)
    return svc, centers


def _port_service(backend, tracker, overlap=False, **cfg_kw):
    """The port's twin of ``test_audit._service`` (its tenants carried
    across)."""
    svc = TService(t_top.grid(36), TConfig(**_config(backend, **cfg_kw),
                                           overlap=overlap),
                   tracker=tracker, device="cpu")
    centers, specs = ja._specs(36, 3)
    for s in specs:
        svc.admit(_port_spec(s))
    return svc, centers


def _tick(svc, n, cycles=None):
    out = []
    for _ in range(n):
        out.extend(svc.tick(cycles))
    return out + svc.flush()


@functools.lru_cache(maxsize=None)
def _jax_serve(backend, audit_every, ticks):
    """JAX's records and tracker stream over ``ticks`` clean ticks."""
    tr = JInMemory()
    svc, _ = _jax_service(backend, tr, audit_every=audit_every)
    recs = _tick(svc, ticks)
    svc.close()
    return recs, tr.records


def _audits(records):
    return [r for r in records if r.get("kind") == "audit"]


def _assert_audit_records(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for key in ("dispatch", "t", "query", "slot", "ok", "violations",
                    "monitors", "quiescent", "claimed_quiescent",
                    "trace_id") + INTS:
            assert g.get(key) == w.get(key), (key, g, w)
        for key in ("tol", "mag"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5)
        assert (g["residual"] <= g["tol"]) == (w["residual"] <= w["tol"])


@pytest.mark.parametrize("backend", ["core", "engine"])
@pytest.mark.parametrize("overlap", [False, True])
def test_service_clean_run_matches_jax(backend, overlap):
    ttr = InMemoryTracker()
    tsvc, _ = _port_service(backend, ttr, overlap=overlap, audit_every=1)
    trec = _tick(tsvc, 4)
    tsvc.close()
    jrec, jrecords = _jax_serve(backend, 1, 4)
    assert trec == jrec
    _assert_audit_records(_audits(ttr.records), _audits(jrecords))
    assert len(_audits(ttr.records)) == 4 * 3
    assert all(r["ok"] for r in _audits(ttr.records))
    assert validate_stream(ttr.records) == []
    assert j_validate_stream(ttr.records) == []
    assert ttr.registry.counter("audit_violations_total").value() == 0.0


@pytest.mark.parametrize("backend", ["core", "engine"])
@pytest.mark.parametrize("overlap", [False, True])
def test_service_audit_every_samples_windows_like_jax(backend, overlap):
    ttr = InMemoryTracker()
    tsvc, _ = _port_service(backend, ttr, overlap=overlap, audit_every=3)
    _tick(tsvc, 7)
    tsvc.close()
    audited = {r["dispatch"] for r in _audits(ttr.records)}
    assert audited == {r["dispatch"]
                       for r in _audits(_jax_serve(backend, 3, 7)[1])}
    assert audited == {1, 4, 7}


def _port_run(backend, overlap, audit_every):
    svc, _ = _port_service(backend, InMemoryTracker(), overlap=overlap,
                           audit_every=audit_every)
    recs = _tick(svc, 4)
    snaps = {qid: svc.snapshot(qid)
             for qid, _slot, _spec in svc.registry.active_items()}
    states = svc.states
    svc.close()
    return recs, snaps, states


@pytest.mark.parametrize("backend", ["core", "engine"])
@pytest.mark.parametrize("overlap", [False, True])
def test_service_audit_is_a_pure_observer(backend, overlap):
    """Records and states bitwise equal with the audit on and off."""
    recs_off, snaps_off, st_off = _port_run(backend, overlap, 0)
    recs_on, snaps_on, st_on = _port_run(backend, overlap, 1)
    assert recs_on == recs_off
    for qid, snap in snaps_off.items():
        for name in t_lss.LSSState._fields:
            if name != "rng":
                assert torch.equal(getattr(snap, name),
                                   getattr(snaps_on[qid], name)), name
    for a, b in zip(st_on, st_off):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def _inject(svc, fault, slot, centers, backend_ta, package):
    """Fault one slot of a service mid-serve through snapshot ->
    fault -> restore_slot (JAX's or the port's)."""
    snap = svc.backend.snapshot(svc.states, slot)
    if package == "jax":
        bad = ja._apply_fault(fault, snap, backend_ta, centers)
    else:
        bad = _port_fault(fault, snap, backend_ta, None)
    svc.states = svc.backend.restore_slot(svc.states, slot, bad)


@pytest.mark.parametrize("backend", ["core", "engine"])
@pytest.mark.parametrize("fault", ["corrupt_knowledge",
                                   "drop_halo_message"])
def test_service_detects_injected_fault_like_jax(tmp_path, backend, fault):
    """The zero-cycle tick after the fault audits the faulted state: the
    same failing records, the same ``audit_violations_total`` and the same
    ``audit_violation`` flight dump as JAX's service."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtr, ttr = JInMemory(), InMemoryTracker()
    jsvc, centers = _jax_service(backend, jtr, audit_every=1,
                                 flight_dump_dir=str(jdir))
    tsvc, _ = _port_service(backend, ttr, audit_every=1,
                            flight_dump_dir=str(tdir))
    jsvc.tick()
    tsvc.tick()
    _inject(jsvc, fault, 1, centers,
            j_lss.TopoArrays.from_topology(j_top.grid(36)), "jax")
    _inject(tsvc, fault, 1, centers, _port_topo(j_top.grid(36)), "port")
    jsvc.tick(cycles=0)
    tsvc.tick(cycles=0)
    jsvc.close()
    tsvc.close()
    _assert_audit_records(_audits(ttr.records), _audits(jtr.records))
    bad = [r for r in _audits(ttr.records) if not r["ok"]]
    assert bad and all(r["dispatch"] == 2 and r["slot"] == 1 for r in bad)
    assert all(r["monitors"][ja.FIRES[fault]] is False for r in bad)
    qid = bad[0]["query"]
    for m in t_audit.MONITORS:
        assert (ttr.registry.counter("audit_violations_total").value(
                    query=qid, monitor=m)
                == jtr.registry.counter("audit_violations_total").value(
                    query=qid, monitor=m)), m
    assert validate_stream(ttr.records) == []
    assert j_validate_stream(ttr.records) == []
    dumps = sorted(os.listdir(tdir))
    assert dumps == sorted(os.listdir(jdir))
    assert "flight-d000002-audit_violation.jsonl" in dumps
    header = json.loads(open(tdir / "flight-d000002-audit_violation.jsonl")
                        .readline())
    assert header["reason"] == "audit_violation" and header["dispatch"] == 2


def test_forensics_finds_the_first_violation_like_jax(tmp_path):
    jtr, ttr = JInMemory(), InMemoryTracker()
    jsvc, centers = _jax_service("core", jtr, audit_every=1)
    tsvc, _ = _port_service("core", ttr, audit_every=1)
    jsvc.tick()
    tsvc.tick()
    _inject(jsvc, "corrupt_knowledge", 0, centers,
            j_lss.TopoArrays.from_topology(j_top.grid(36)), "jax")
    _inject(tsvc, "corrupt_knowledge", 0, centers,
            _port_topo(j_top.grid(36)), "port")
    for _ in range(2):  # both windows fail; forensics picks the FIRST
        jsvc.tick(cycles=0)
        tsvc.tick(cycles=0)
    jsvc.close()
    tsvc.close()
    jprov = j_forensics.provenance(jtr.records)
    prov = t_forensics.provenance(ttr.records)
    first = t_forensics.first_violation(ttr.records)
    assert prov["violation"] is first and first["dispatch"] == 2
    assert first["dispatch"] == jprov["violation"]["dispatch"]
    assert prov["failed"] == jprov["failed"]
    assert "conservation" in prov["failed"]
    assert prov["last_clean"]["dispatch"] == jprov["last_clean"][
        "dispatch"] == 1
    assert prov["span"].attrs.get("dispatch") == 2
    assert "conservation" in t_forensics.render(prov, show_trace=True)
    # The CLI joins the same over a JSONL file; exit 1 iff a violation.
    path = tmp_path / "stream.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in ttr.records))
    assert t_forensics.main([str(path)]) == 1
    clean = tmp_path / "clean.jsonl"
    clean.write_text("".join(json.dumps(r) + "\n" for r in ttr.records
                             if r.get("kind") != "audit"))
    assert t_forensics.main([str(clean)]) == 0
