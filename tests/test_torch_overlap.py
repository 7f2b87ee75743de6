"""The port's overlapped service boundary against the JAX package's.

``repro_torch.service.Service(ServiceConfig(overlap=True))`` runs each
dispatch on a worker thread while the main thread runs the next
boundary's host work (the membership drain and the engine's partition
repair) and finishes the previous window; ``tick()`` returns the previous
dispatch's records.  Each test drives the port and
``repro.service.Service`` with the same ``ServiceConfig`` on the same
numpy inputs (tests/test_overlap.py's workloads) and compares: records as
dicts (floats, ints, bools, regions and message counts exact), snapshots
with int and bool fields exact and float moments to rtol 1e-5 /
atol 1e-5; the port's overlapped run is also held to its own synchronous
run, snapshots bitwise.  Staged epoch builds (``StagedBuild`` threads)
are waited on with ``take()``, never on a clock, so adoption does not
depend on thread timing; every service is closed (its worker joined)
before the comparison that follows it.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from repro.core import regions as j_regions
from repro.core import topology as j_top
from repro.obs import InMemoryTracker as JTracker
from repro.service import ControlPlaneConfig as JControl
from repro.service import QuerySpec as JSpec
from repro.service import Service as JService
from repro.service import ServiceConfig as JConfig
from repro.service.overlap import StagedBuild as JStagedBuild
from repro_torch.core import lss as t_lss
from repro_torch.core import topology as t_top
from repro_torch.obs import InMemoryTracker as TTracker
from repro_torch.service import ControlPlaneConfig as TControl
from repro_torch.service import Service as TService
from repro_torch.service import ServiceConfig as TConfig
from repro_torch.service.overlap import StagedBuild
from test_torch_formulas import assert_exact
from test_torch_lss import _assert_state
from test_torch_membership import _padded
from test_torch_service import _port_spec, _problem, _voronoi

ENGINE = dict(backend="engine", engine_shards=2)


def _services(graphs, **cfg):
    """A JAX service and the port's over ``graphs`` (JAX's, the port's)."""
    control = cfg.pop("control", None)
    tracker = cfg.pop("tracker", False)
    j = JService(graphs[0], JConfig(
        **cfg, **({"control": JControl(**control)} if control else {})),
        **({"tracker": JTracker()} if tracker else {}))
    t = TService(graphs[1], TConfig(
        **cfg, **({"control": TControl(**control)} if control else {})),
        device="cpu", **({"tracker": TTracker()} if tracker else {}))
    return j, t


def _dyns(n, n_cap, deg_cap):
    return (j_top.DynTopology.from_topology(j_top.grid(n), n_cap=n_cap,
                                            deg_cap=deg_cap),
            t_top.DynTopology.from_topology(t_top.grid(n), n_cap=n_cap,
                                            deg_cap=deg_cap))


def _padded_spec(centers, x, n_cap, seed=0):
    xx, w = _padded(x, n_cap)
    return JSpec(region=j_regions.VoronoiRegions(centers), inputs=xx,
                 weights=w, seed=seed)


def _jax_fields(snap):
    return {f: np.asarray(getattr(snap, f)) for f in snap._fields
            if f != "rng"}


def _same_state(a, b, msg=""):
    """Two port snapshots bitwise (the generator aside)."""
    for f in t_lss.LSSState._fields:
        if f != "rng":
            assert torch.equal(getattr(a, f), getattr(b, f)), f"{msg} {f}"


def _settle(*services):
    """Wait for every staged build of each service (JAX's or the port's)."""
    for svc in services:
        for entry in svc._staged.values():
            entry[0]._thread.join(timeout=120)
            assert entry[0].ready(), "a staged build did not finish"
            entry[0].take()


# -- record parity: overlap == sync == JAX overlap ---------------------------

def _run_churny(svc, port, ticks=6):
    """tests/test_overlap.py::_run_churny on one service: two tenants,
    streaming ingest, a leave and a join mid-serve.  Returns (records,
    snapshots)."""
    centers, x = _problem(36, seed=11)
    specs = [_padded_spec(centers, x, 40, seed=s) for s in (0, 1)]
    qids = [svc.admit(_port_spec(s) if port else s) for s in specs]
    records = []
    for t in range(ticks):
        if t == 1:
            svc.push_updates([3, 5], [[0.9, 0.1], [0.2, 0.7]])
        if t == 2:
            svc.leave_peer(7)
        if t == 4:
            svc.join_peer(7, value=[0.4, 0.4])
            svc.link_peers(7, 8)
        records.extend(svc.tick())
    records.extend(svc.flush())
    snaps = {q: svc.snapshot(q) for q in qids}
    svc.close()
    return records, snaps


@pytest.mark.parametrize("backend", ["core", "engine"])
def test_overlap_record_parity_under_churn_and_ingest(backend):
    """Under ingest, a leave and a join, the port's overlapped records
    equal its synchronous records and the JAX overlapped service's, and
    the final slot states equal both."""
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
               backend=backend, engine_shards=2)
    sync_recs, sync_snaps = _run_churny(TService(
        _dyns(36, 40, 6)[1], TConfig(**cfg), device="cpu"), True)
    j, t = _services(_dyns(36, 40, 6), overlap=True, **cfg)
    over_recs, over_snaps = _run_churny(t, True)
    jax_recs, jax_snaps = _run_churny(j, False)
    assert len(over_recs) == 12
    assert over_recs == sync_recs == jax_recs
    for q, snap in over_snaps.items():
        _same_state(snap, sync_snaps[q], q)
        _assert_state(snap, _jax_fields(jax_snaps[q]), q)


# -- deferred emission --------------------------------------------------------

def test_overlap_defers_emission_one_tick():
    """tick() returns the previous window's records (``[]`` first), one
    tick late; flush() drains the last window and is idempotent; serve()
    drains itself; close() flushes a pending window into the sink.  Each
    step equals JAX's."""
    centers, x = _problem(25, seed=3)
    cfg = dict(capacity=1, k_max=3, d=2, cycles_per_dispatch=2,
               overlap=True)
    j, t = _services((j_top.grid(25), t_top.grid(25)), **cfg)
    for svc, spec in ((j, _voronoi(centers, x)),
                      (t, _port_spec(_voronoi(centers, x)))):
        svc.admit(spec)
    assert t.tick() == j.tick() == []
    (r1,) = t.tick()
    assert [r1] == j.tick() and r1["dispatch"] == 1
    (r2,) = t.flush()
    assert [r2] == j.flush() and r2["dispatch"] == 2
    assert t.flush() == j.flush() == []
    j.close()
    t.close()

    def serve(svc, spec):
        svc.admit(spec)
        recs = svc.serve(4)
        assert svc._pending is None
        svc.close()
        return recs

    j, t = _services((j_top.grid(25), t_top.grid(25)), **cfg)
    recs = serve(t, _port_spec(_voronoi(centers, x)))
    assert [r["dispatch"] for r in recs] == [4]
    assert recs == serve(j, _voronoi(centers, x))

    # close() finishes the window still in flight: its record reaches the
    # tracker, in both packages.
    j, t = _services((j_top.grid(25), t_top.grid(25)), tracker=True, **cfg)
    logged = []
    for svc, spec in ((j, _voronoi(centers, x)),
                      (t, _port_spec(_voronoi(centers, x)))):
        svc.admit(spec)
        svc.tick()
        svc.tick()
        svc.close()
        assert svc._pending is None
        logged.append([r for r in svc.tracker.records
                       if r.get("kind") is None])
    assert [r["dispatch"] for r in logged[1]] == [1, 2]
    assert logged[1] == logged[0]
    assert t._pool is None  # the worker thread is gone


# -- churn inside capacity keeps the operands' shapes -------------------------

def test_overlap_churn_within_capacity_keeps_operand_shapes():
    """A leave, a join and a link within capacity on the engine backend
    under overlap: every dispatch's operands pass the double buffer's
    shape check (five swaps, no declared reshape), as in JAX, and the
    records equal JAX's."""
    centers, x = _problem(36, seed=5)
    j, t = _services(_dyns(36, 40, 6), capacity=2, k_max=3, d=2,
                     cycles_per_dispatch=2, overlap=True, **ENGINE)
    recs = []
    for svc, port in ((t, True), (j, False)):
        spec = _padded_spec(centers, x, 40)
        svc.admit(_port_spec(spec) if port else spec)
        out = svc.tick()
        for step in range(4):
            if step == 0:
                svc.leave_peer(11)
            if step == 2:
                svc.join_peer(11, value=[0.3, 0.3])
                svc.link_peers(11, 12)
            out += svc.tick()
        out += svc.flush()
        assert svc._buffers.swaps == 5 and svc._buffers.epochs == 0
        svc.close()
        recs.append(out)
    assert len(recs[0]) == 5 and recs[0] == recs[1]


# -- staged epochs adopt what the in-line rebuild gives -----------------------

def _staged_rebalance_run(svc, port, staged):
    """tests/test_overlap.py:273: a rebalance forced after churn, adopting
    a build staged just before it (or rebuilt in line)."""
    centers, x = _problem(40, seed=9)
    spec = _padded_spec(centers, x, 40)
    q = svc.admit(_port_spec(spec) if port else spec)
    out = []
    for disp in range(6):
        if disp == 2:
            svc.join_peer(36, value=[0.2, 0.2])
            svc.link_peers(36, 7)
            svc.leave_peer(12)
        if disp == 3:
            if staged:
                svc._staged["rebalance"] = svc.backend.stage_rebalance(
                    svc._dyn)
            ev = svc.rebalance_now()
            assert ev["staged"] is staged
        out.extend(svc.tick())
    snap = svc.snapshot(q)
    svc.close()
    return out, snap


def test_staged_rebalance_adopts_prebuilt_engine_bitwise():
    """A rebalance epoch that adopts a background-staged partition build
    emits what the in-line rebuild emits, with the same final state, and
    what JAX's staged epoch emits."""
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2, **ENGINE)
    plain, snap_plain = _staged_rebalance_run(TService(
        _dyns(36, 40, 6)[1], TConfig(**cfg), device="cpu"), True, False)
    j, t = _services(_dyns(36, 40, 6), **cfg)
    staged, snap = _staged_rebalance_run(t, True, True)
    want, jsnap = _staged_rebalance_run(j, False, True)
    assert len(staged) == 6 and staged == plain == want
    _same_state(snap, snap_plain)
    _assert_state(snap, _jax_fields(jsnap), "staged rebalance")


def _staged_regrow_run(svc, port, staged):
    """tests/test_overlap.py:311: a regrow staged BEFORE an unlink, so the
    adoption replays the unlink onto the prebuilt tables from the old
    topology's journal."""
    centers, x = _problem(26, seed=7)
    x26 = np.zeros((26, 2), np.float32)
    x26[:25] = x[:25]
    spec = JSpec(region=j_regions.VoronoiRegions(centers), inputs=x26,
                 weights=np.r_[np.ones(25), 0.0].astype(np.float32), seed=0)
    q = svc.admit(_port_spec(spec) if port else spec)
    out = [*svc.tick()]
    if staged:
        build, ver = svc.backend.stage_regrow(svc._dyn, n_cap=30, deg_cap=5)
        svc._staged["regrow"] = (build, ver, {"n_cap": 30, "deg_cap": 5})
    svc.unlink_peers(3, 4)
    out.extend(svc.tick())
    svc.grow_capacity(n_cap=30, deg_cap=5)
    assert svc.capman.epochs[-1]["kind"] == "regrow"
    assert svc.capman.epochs[-1]["staged"] is staged
    svc.join_peer(26, value=[0.1, 0.1])
    svc.link_peers(26, 5)
    out.extend(svc.tick())
    out.extend(svc.tick())
    snap = svc.snapshot(q)
    svc.close()
    return out, snap


def test_staged_regrow_adopts_with_journal_catchup():
    """A regrow adopting a build staged before further churn catches the
    prebuilt engine up from the journal and gives the in-line rebuild's
    records and state, and JAX's."""
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2, **ENGINE)
    plain, snap_plain = _staged_regrow_run(TService(
        _dyns(25, 26, 5)[1], TConfig(**cfg), device="cpu"), True, False)
    j, t = _services(_dyns(25, 26, 5), **cfg)
    staged, snap = _staged_regrow_run(t, True, True)
    want, jsnap = _staged_regrow_run(j, False, True)
    assert len(staged) == 4 and staged == plain == want
    _same_state(snap, snap_plain)
    _assert_state(snap, _jax_fields(jsnap), "staged regrow")


# -- epochs staged by the service itself, under overlap -----------------------

def _lockstep(j, t, events, ticks):
    """Drive both services through ``events`` (dispatch -> calls), every
    staged build waited for after each tick; returns the port's records
    (equal to JAX's at every tick)."""
    out = []
    for disp in range(ticks):
        for method, args, kw in events.get(disp, []):
            assert getattr(t, method)(*args, **kw) == \
                getattr(j, method)(*args, **kw), method
        got, want = t.tick(), j.tick()
        assert got == want, disp
        out.extend(got)
        _settle(j, t)
    got, want = t.flush(), j.flush()
    assert got == want
    return out + got


def test_drift_triggered_staged_rebalance_under_overlap():
    """``control.rebalance_drift`` under overlap on the engine backend:
    the drift check stages the partition build on a ``StagedBuild``
    thread and a later boundary adopts it (``staged: true``).  Records
    equal JAX's, dispatch by dispatch, and the synchronous port run's."""
    centers, x = _problem(40, seed=9)
    spec = _voronoi(centers, x, seed=0)
    events = {1: [("link_peers", (0, 35), {}), ("link_peers", (5, 30), {}),
                  ("link_peers", (2, 33), {})],
              2: [("join_peer", (36,), {"value": [0.2, 0.2]}),
                  ("link_peers", (36, 7), {}), ("leave_peer", (12,), {})]}
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
               control={"rebalance_drift": 0.01, "rebalance_check_every": 1},
               **ENGINE)
    j, t = _services(_dyns(36, 40, 6), overlap=True, **cfg)
    qid = t.admit(_port_spec(spec))
    j.admit(spec)
    recs = _lockstep(j, t, events, 7)
    kinds = [(e["kind"], e.get("staged")) for e in t.capman.epochs]
    assert kinds == [(e["kind"], e.get("staged")) for e in j.capman.epochs]
    assert ("rebalance", True) in kinds
    assert any(r["name"] == "epoch_stage" for r in t.tracker.records
               if r.get("kind") == "span")
    _assert_state(t.snapshot(qid), _jax_fields(j.snapshot(qid)), "drift")
    j.close()
    t.close()
    sync = TService(_dyns(36, 40, 6)[1], TConfig(**{
        **cfg, "control": TControl(**cfg["control"])}), device="cpu")
    sync.admit(_port_spec(spec))
    want = []
    for disp in range(7):
        for method, args, kw in events.get(disp, []):
            getattr(sync, method)(*args, **kw)
        want.extend(sync.tick())
    sync.close()
    assert recs == want


def _serve_events(svc, events, ticks):
    """One service through ``events`` (dispatch -> calls), every staged
    build waited for after each tick; returns its records, the trailing
    window flushed."""
    out = []
    for disp in range(ticks):
        for method, args, kw in events.get(disp, []):
            getattr(svc, method)(*args, **kw)
        out.extend(svc.tick())
        _settle(svc)
    return out + svc.flush()


def test_auto_regrow_adopts_staged_growth_under_overlap():
    """``control.auto_regrow`` under overlap on the engine backend: once
    the free rows run out, the boundary stages the grown partition in the
    background (``epoch_stage``); an unlink drained after the staging is
    caught up from the journal when the next join hits the wall, and the
    regrow adopts the build (``staged: true``).  Records and the final
    state equal JAX's synchronous service's (which regrows in line) and
    the port's synchronous run's.

    JAX's overlapped service cannot take this path: its ``grow_capacity``
    reads ``caps["deg_cap"]`` from the staged caps, which for a growth of
    the rows hold only ``n_cap``, and raises ``KeyError`` at the wall
    (``src/repro/service/service.py:1146``; ROADMAP C).  The port reads a
    missing cap as the one the topology has."""
    centers, x = _problem(30, seed=7)
    spec = _padded_spec(centers, x[:25], 26)
    events = {1: [("join_peer", (25,), {"value": [0.5, -0.5]}),
                  ("link_peers", (25, 0), {})],
              2: [("unlink_peers", (3, 4), {})],
              3: [("join_peer", (26,), {}), ("link_peers", (26, 3), {}),
                  ("leave_peer", (5,), {})]}
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
               control={"auto_regrow": True, "grow_factor": 1.12}, **ENGINE)
    j, t = _services(_dyns(25, 26, 5), overlap=True, **cfg)
    j_sync, t_sync = _services(_dyns(25, 26, 5), **cfg)
    runs = []
    for svc, port in ((t, True), (t_sync, True), (j_sync, False)):
        qid = svc.admit(_port_spec(spec) if port else spec)
        runs.append(_serve_events(svc, events, 6))
    assert len(runs[0]) == 6 and runs[0] == runs[1] == runs[2]
    epochs = [(e["kind"], e.get("staged")) for e in t.capman.epochs]
    assert epochs == [("init", None), ("regrow", True)]
    assert t_sync.capman.epochs[-1]["staged"] is False
    assert t.topo.n_cap == j_sync.topo.n_cap == 30
    assert any(r["name"] == "epoch_stage" for r in t.tracker.records
               if r.get("kind") == "span")
    _assert_state(t.snapshot(qid), _jax_fields(j_sync.snapshot(qid)),
                  "regrow")
    _same_state(t.snapshot(qid), t_sync.snapshot(qid))
    j.admit(spec)
    with pytest.raises(KeyError, match="deg_cap"):
        _serve_events(j, events, 6)
    assert "regrow" not in j._staged
    for svc in (j, t, j_sync, t_sync):
        svc.close()


def test_staged_build_surfaces_build_errors_at_take():
    """take() joins and re-raises the build's error, as JAX's does."""
    def boom():
        raise RuntimeError("partition build failed")

    for cls in (StagedBuild, JStagedBuild):
        sb = cls(boom, label="rebalance")
        with pytest.raises(RuntimeError, match="partition build failed"):
            sb.take()
        assert sb.ready()
        assert cls(lambda: "engine", label="regrow").take() == "engine"


# -- calls between ticks join the worker --------------------------------------

@pytest.mark.parametrize("backend", ["core", "engine"])
def test_calls_between_ticks_join_the_worker(backend):
    """admit (a free slot and a queued one), retire (the queue refills the
    slot), replace, snapshot, total_msgs, grow_capacity and rebalance_now
    between overlapped ticks, each while a dispatch is in flight: records,
    totals, epochs and snapshots equal JAX's overlapped service's."""
    centers, x = _problem(40, seed=4)
    specs = [_padded_spec(centers, x[:36], 40, seed=s) for s in range(4)]
    cfg = dict(capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
               admission_queue=2, overlap=True, backend=backend,
               engine_shards=2)
    j, t = _services(_dyns(36, 40, 6), **cfg)
    qids = [t.admit(_port_spec(specs[0]))]
    assert j.admit(specs[0]) == qids[0]
    for disp in range(7):
        assert t._inflight is not None or disp == 0
        if disp == 1:  # a free slot, then the queue
            for s in specs[1:3]:
                qids.append(t.admit(_port_spec(s)))
                assert j.admit(s) == qids[-1]
        if disp == 2:
            t.retire(qids[0])
            j.retire(qids[0])
            _assert_state(t.snapshot(qids[1]),
                          _jax_fields(j.snapshot(qids[1])), "snapshot")
        if disp == 3:
            t.replace(qids[1], _port_spec(specs[3]))
            j.replace(qids[1], specs[3])
            assert t.total_msgs(qids[2]) == j.total_msgs(qids[2])
        if disp == 4:
            t.grow_capacity(n_cap=44)
            j.grow_capacity(n_cap=44)
        if disp == 5:
            ev = t.rebalance_now()
            assert ev == j.rebalance_now() and (ev is None) == (
                backend == "core")
        assert t.tick() == j.tick(), disp
    assert t.flush() == j.flush()
    for q in qids[1:]:
        _assert_state(t.snapshot(q), _jax_fields(j.snapshot(q)), q)
        assert t.total_msgs(q) == j.total_msgs(q)
    assert [t.admission_status(q) for q in qids] == \
        [j.admission_status(q) for q in qids]
    assert_exact(t._corr_iters, np.asarray(j._corr_iters), "iterations")
    j.close()
    t.close()


# -- spans and failures -------------------------------------------------------

def _span_book(svc):
    spans = [r for r in svc.tracker.records if r.get("kind") == "span"]
    ticks = {s["span_id"]: s for s in spans if s["name"] == "tick"}
    observes = [(s["attrs"]["dispatch"],
                 ticks[s["parent_id"]]["attrs"]["dispatch"],
                 bool(ticks[s["parent_id"]]["attrs"].get("flush")))
                for s in spans if s["name"] == "observe"]
    roots = [t["attrs"]["dispatch"]
             for t in sorted(ticks.values(), key=lambda s: s["span_id"])]
    dispatch = sorted(ticks[s["parent_id"]]["attrs"]["dispatch"]
                      for s in spans if s["name"] == "dispatch")
    return observes, roots, dispatch


def test_overlap_spans_carry_the_window_dispatch():
    """Each observe span carries its window's dispatch, one behind the
    tick root that finished it, and the flush root the window it drained
    (tests/test_overlap.py:402, the span half); each dispatch span hangs
    under the tick that launched it.  The book equals JAX's."""
    centers, x = _problem(25, seed=3)
    j, t = _services((j_top.grid(25), t_top.grid(25)), capacity=1, k_max=3,
                     d=2, cycles_per_dispatch=2, overlap=True, tracker=True)
    books = []
    for svc, spec in ((j, _voronoi(centers, x)),
                      (t, _port_spec(_voronoi(centers, x)))):
        svc.admit(spec)
        for _ in range(3):
            svc.tick()
        svc.flush()
        svc.close()
        books.append(_span_book(svc))
    observes, roots, dispatch = books[1]
    assert observes == [(1, 2, False), (2, 3, False), (3, 3, True)]
    assert roots == [1, 2, 3, 3] and dispatch == [1, 2, 3]
    assert books[1] == books[0]


def test_worker_exception_propagates_and_service_stays_joinable():
    """A dispatch that fails on the worker thread raises at the next
    tick(), through the crash dump, and leaves nothing in flight: flush()
    and close() then return cleanly.  JAX's service has no worker thread;
    the records before the failure equal its records."""
    centers, x = _problem(25, seed=3)
    j, t = _services((j_top.grid(25), t_top.grid(25)), capacity=1, k_max=3,
                     d=2, cycles_per_dispatch=2, overlap=True)
    qid = t.admit(_port_spec(_voronoi(centers, x)))
    j.admit(_voronoi(centers, x))
    assert t.tick() == j.tick() == []
    assert t.tick() == j.tick()
    t.total_msgs(qid)  # joins dispatch 2 before its step is swapped out
    step = t.backend.step

    def broken(*args, **kw):
        raise FloatingPointError("dispatch failed on the worker")

    t.backend.step = broken
    assert t.tick() == j.tick()  # window 2; the failing dispatch 3 runs
    with pytest.raises(FloatingPointError, match="on the worker"):
        t.tick()
    assert t._inflight is None and t._pending is None
    assert t.flush() == []
    t.backend.step = step
    t.close()
    assert t._pool is None
    j.close()


def test_concurrent_overlapped_services_under_fast_thread_switching():
    """Six overlapped services (their six worker threads and the six
    threads driving them: more threads than this host's cores) tick at
    once under a 10 µs interpreter switch interval, with churn, ingest and
    calls between ticks: each gives the records of the synchronous
    service on the same calls.  A dispatch or a boundary that read state
    another thread was writing would show here.  Every thread is joined
    with a timeout."""
    centers, x = _problem(20, seed=6)
    specs = [_port_spec(_padded_spec(centers, x[:16], 20, seed=s))
             for s in range(3)]

    def run(overlap, seed, out):
        svc = TService(t_top.DynTopology.from_topology(
            t_top.grid(16), n_cap=20, deg_cap=5), TConfig(
                capacity=2, k_max=3, d=2, cycles_per_dispatch=2,
                overlap=overlap), device="cpu")
        rng = np.random.default_rng(seed)
        qids = [svc.admit(specs[0]), svc.admit(specs[1])]
        recs = []
        for disp in range(8):
            svc.push_updates([int(rng.integers(16))], [rng.normal(size=2)])
            if disp == 2:
                svc.leave_peer(int(rng.integers(16)))
            if disp == 3:
                svc.join_peer(16 + seed % 4, value=[0.1, 0.2])
            if disp == 5:
                svc.retire(qids[0])
                qids.append(svc.admit(specs[2]))
            recs += svc.tick()
            out.setdefault("totals", []).append(svc.total_msgs(qids[1]))
        out["records"] = recs + svc.flush()
        svc.close()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outs = [{} for _ in range(6)]
        threads = [threading.Thread(target=run, args=(True, i, outs[i]))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for i, out in enumerate(outs):
        want = {}
        run(False, i, want)
        assert out["records"] == want["records"] and len(want["records"])
        # total_msgs joins the worker first: the totals read between
        # ticks trail the synchronous ones by one window.
        assert out["totals"][1:] == want["totals"][:-1]
