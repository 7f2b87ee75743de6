"""Rank bodies for the port's multi-process tests (``launch.spawn`` runs
them in fresh interpreters, one a rank) and the single-process halves
they are compared with.

No JAX here: a spawned rank imports this module, and only torch, numpy
and ``repro_torch``.  The test files import it too and hold the results
against the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.core import lss, monitor, sim, topology, wvs
from repro_torch.engine import (AsyncShardedState, EngineConfig, ShardedLSS,
                                ShardedState)
from repro_torch.launch import cost
from repro_torch.obs import InMemoryTracker

# -- the collective engine ---------------------------------------------------

ENGINE_K = 4  # cycles a dispatch
ENGINE_DISPATCHES = 6
# The async ring on a mesh: (topology, staleness, wire, drop rate).
ASYNC_CASES = (("grid", 0, "exact", 0.0), ("grid", 0, "int8", 0.0),
               ("grid", 2, "exact", 0.0), ("grid", 2, "int8", 0.0),
               ("chord", 2, "exact", 0.1))
# The layout moves on a mesh: (topology, drop rate, wire).
LAYOUT_CASES = (("grid", 0.1, "int8"), ("chord", 0.0, "exact"))
LAYOUT_CYCLES = 10  # cycles after a move
COST_KS = (1, 4)  # cycles of the dispatches cost.analyze counts


def engine_case(topo: str, shards: int, drop: float, wire: str):
    """The engine on the CPU, its inputs and its graph: grid(64) or
    chord(64) with ``sim``'s problem, or for ``topo="dyn"`` the membership
    schedule's capacity-padded grid (``tests/test_membership.py:208``)."""
    if topo == "dyn":
        graph = topology.DynTopology.from_topology(topology.grid(64),
                                                   n_cap=68, deg_cap=6)
        centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=68,
                                                                 seed=0))
        x = sample(np.random.default_rng(1), graph.n)
        ecfg = EngineConfig(num_shards=shards, cycles_per_dispatch=2,
                            halo_slack=2.0, wire=wire)
    else:
        graph = getattr(topology, topo)(64)
        centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=64,
                                                                 seed=0))
        x = sample(np.random.default_rng(1), graph.n)
        ecfg = EngineConfig(num_shards=shards,
                            cycles_per_dispatch=ENGINE_K, wire=wire)
    inputs = wvs.from_vector(torch.tensor(x), torch.ones(graph.n))
    eng = ShardedLSS(graph, centers, lss.LSSConfig(drop_rate=drop), ecfg,
                     device="cpu")
    return eng, inputs, graph


def async_case(topo: str, staleness: int, wire: str, drop: float,
               shards: int):
    """:func:`engine_case`'s engine in async mode at ``staleness``."""
    eng, inputs, graph = engine_case(topo, shards, drop, wire)
    eng = ShardedLSS(graph, eng.centers, eng.cfg,
                     eng.ecfg._replace(async_mode=True, staleness=staleness),
                     device="cpu")
    return eng, inputs


def checkpoint(eng: ShardedLSS, state) -> dict:
    """What a run is held to at a dispatch boundary: every
    :class:`ShardedState` field (the full state; gathered under a mesh),
    the metrics, the send total and the unpermuted core state; for an
    async state also its books and rings (gathered) and the lag stats."""
    full = eng.gather_state(state)
    base = eng._base(full)
    acc, quiescent, correct = eng.metrics(state)
    core = eng.to_lss_state(state)
    out = {
        "state": {f: getattr(base, f) for f in ShardedState._fields
                  if f != "rng" and getattr(base, f) is not None},
        "metrics": (float(acc), bool(quiescent), correct),
        "total_msgs": int(eng.total_msgs(state)),
        "lss": {f: getattr(core, f) for f in lss.LSSState._fields
                if f != "rng"},
    }
    if isinstance(full, AsyncShardedState):
        out["books"] = {f: getattr(full, f)
                        for f in AsyncShardedState._fields
                        if f not in ("sync", "delay_rng")}
        out["lag"] = eng.async_lag_stats(state)
    return out


def drive_async(eng: ShardedLSS, inputs) -> dict:
    """``ENGINE_DISPATCHES`` async dispatches with a checkpoint after
    each, then the audit of the last state."""
    state = eng.init(inputs, seed=0)
    runs = []
    for _ in range(ENGINE_DISPATCHES):
        state = eng.run(state, eng.ecfg.cycles_per_dispatch)
        runs.append(checkpoint(eng, state))
    return {"runs": runs, "audit": eng.audit(state)}


def drive_layout(case, shards: int, mesh=None) -> list:
    """The layout moves of ``case`` at ``shards`` shards (on ``mesh`` when
    given): two dispatches on the BFS partition, ``migrate_from`` onto a
    stride partition (a rebalance with the same S), ``LAYOUT_CYCLES``
    cycles; then ``place_lss_state`` of a core snapshot every rank builds
    alike (a single-process engine's, two dispatches in), and as many
    cycles.  A checkpoint and the audit after each move and each run."""
    topo, drop, wire = case
    old, inputs, graph = engine_case(topo, shards, drop, wire)
    ref = ShardedLSS(graph, old.centers, old.cfg, old.ecfg, device="cpu")
    new = ShardedLSS(graph, old.centers, old.cfg,
                     old.ecfg._replace(method="stride"), device="cpu")
    if mesh is not None:
        old.use_mesh(mesh, "shards")
        new.use_mesh(mesh, "shards")
    k2 = 2 * old.ecfg.cycles_per_dispatch
    moved = new.migrate_from(old, old.run(old.init(inputs, seed=0), k2))
    snap = ref.to_lss_state(ref.run(ref.init(inputs, seed=0), k2))
    out = []
    for state in (moved, new.place_lss_state(snap)):
        for _ in range(2):
            out.append({**checkpoint(new, state), "audit": new.audit(state)})
            state = new.run(state, LAYOUT_CYCLES)
    return out


def drive_engine(eng: ShardedLSS, inputs, graph) -> list:
    """The run every case takes, with a checkpoint after each dispatch:
    ``ENGINE_DISPATCHES`` dispatches of K cycles, or the membership
    schedule (6 cycles, a join with two links and a leave, 8 cycles)."""
    if not isinstance(graph, topology.DynTopology):
        state = eng.init(inputs, seed=0)
        out = []
        for _ in range(ENGINE_DISPATCHES):
            state = eng.run(state, eng.ecfg.cycles_per_dispatch)
            out.append(checkpoint(eng, state))
        out[-1]["audit"] = eng.audit(state)
        return out
    state = eng.init(inputs, seed=0, alive=graph.present.copy())
    state = eng.run(state, 6)
    out = [checkpoint(eng, state)]
    ver = graph.version
    p = graph.add_peer()
    graph.add_edge(p, 0)
    graph.add_edge(p, 37)
    graph.remove_peer(22)
    rows, slots = [], []
    for ev in graph.events_since(ver):
        if ev.kind in ("link", "unlink"):
            rows += [ev.a, ev.b]
            slots += [ev.slot_a, ev.slot_b]
    eng.apply_membership(graph)
    state = eng.clear_slots(state, rows, slots)
    state = eng.set_alive(state, [p], True)
    state = eng.set_alive(state, [22], False)
    out.append(checkpoint(eng, state))
    state = eng.run(state, 8)
    out.append({**checkpoint(eng, state), "audit": eng.audit(state)})
    return out


def engine_mesh_body(rank, world, cases):
    """Every case of ``cases`` (``(topo, drop, wire)``), of
    :data:`ASYNC_CASES` and of :data:`LAYOUT_CASES` on this rank's shard
    of a ``("shards",)`` mesh; returns ``{case: checkpoints}`` of each
    kind, the first case's dispatch span attributes, the errors a
    mis-sized mesh and a migration between a mesh and no mesh raise, the
    profiled engine's gauge label, and the all-to-all bytes
    :func:`repro_torch.launch.cost.analyze` counts in a dispatch of each
    of :data:`COST_KS` cycles."""
    torch.set_num_threads(1)  # several ranks share the host's cores
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
    runs, spans = {}, None
    for case in cases:
        topo, drop, wire = case
        eng, inputs, graph = engine_case(topo, world, drop, wire)
        if spans is None:
            eng.tracker = InMemoryTracker()
        runs[case] = drive_engine(eng.use_mesh(mesh, "shards"), inputs,
                                  graph)
        if spans is None:
            spans = [dict(sp.attrs)
                     for sp in eng.tracker.spans_named("engine.dispatch")]
    async_runs = {}
    for case in ASYNC_CASES:
        eng, inputs = async_case(*case, world)
        async_runs[case] = drive_async(eng.use_mesh(mesh, "shards"), inputs)
    layout = {case: drive_layout(case, world, mesh) for case in LAYOUT_CASES}
    errors = {}
    eng, inputs, _ = engine_case("grid", world + 1, 0.0, "exact")
    try:
        eng.use_mesh(mesh, "shards")
    except ValueError as e:
        errors["mis-sized"] = str(e)
    eng, inputs, graph = engine_case("grid", world, 0.0, "exact")
    state = eng.use_mesh(mesh, "shards").init(inputs)
    try:
        ShardedLSS(graph, eng.centers, eng.cfg, eng.ecfg,
                   device="cpu").migrate_from(eng, state)
    except ValueError as e:
        errors["migrate"] = str(e)
    a2a = {k: cost.analyze(eng.run, state, k)["collective_bytes"]
           for k in COST_KS}
    tracker = InMemoryTracker()
    prof = ShardedLSS(topology.grid(64), eng.centers, eng.cfg,
                      eng.ecfg._replace(profile=True), tracker=tracker,
                      device="cpu").use_mesh(mesh, "shards")
    prof.run(prof.init(inputs), eng.ecfg.cycles_per_dispatch)
    return {"runs": runs, "async": async_runs, "layout": layout,
            "spans": spans, "errors": errors, "collective_bytes": a2a,
            "block": tuple(state.out_m.shape), "msgs": tuple(
                state.msgs.shape),
            "profile": (prof._profiled.backend, prof._profiled.calls,
                        tracker.registry.gauge("host_overhead_frac").value(
                            backend="engine-mesh"))}


# -- the mesh monitor --------------------------------------------------------

def monitor_stats(case: str) -> tuple:
    """``(mesh shape, mesh axis names, monitor axes, centers, rounds,
    steps)`` and the per-peer statistics of each phase of a case: the
    statistics of ``tests/test_distributed.py:66`` (a 4x2 torus), ``:91``
    (an 8-ring whose mean crosses the boundary), ``:264`` (the
    ``('pod', 'data')`` axes of a 2x2x2 mesh), a ring of 2, and the first
    two on 4 ranks (a 4-ring, a 2x2 torus)."""
    if case == "torus":
        vals = np.array([[0.95, 0.9]] * 5 + [[0.1, 0.05]] * 3, np.float32)
        return ((4, 2), ("data", "model"), ("data", "model"),
                [[0., 0.], [1., 1.]], 2, [(vals, 8)])
    if case == "ring8":
        return ((8,), ("data",), ("data",), [[0.], [10.]], 2,
                [(np.full((8, 1), 2.0, np.float32), 6),
                 (np.full((8, 1), 9.0, np.float32), 10)])
    if case == "pod":
        return ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"),
                [[0.], [10.]], 2, [(np.full((4, 1), 8.5, np.float32), 6)])
    if case == "ring2":  # one neighbor on both slots
        vals = np.array([[0.9, 0.8], [0.4, 0.3]], np.float32)
        return ((2,), ("data",), ("data",), [[0., 0.], [1., 1.]], 1,
                [(vals, 5)])
    if case == "ring4":  # the 8-ring's flip on 4 ranks
        return ((4,), ("data",), ("data",), [[0.], [10.]], 2,
                [(np.full((4, 1), 2.0, np.float32), 6),
                 (np.full((4, 1), 9.0, np.float32), 10)])
    if case == "torus2x2":  # the 4x2 torus's two statistics on 2x2
        vals = np.array([[0.95, 0.9]] * 3 + [[0.1, 0.05]], np.float32)
        return ((2, 2), ("data", "model"), ("data", "model"),
                [[0., 0.], [1., 1.]], 2, [(vals, 8)])
    raise KeyError(case)


def monitor_body(rank, world, case):
    """A case of :func:`monitor_stats` on this rank (a gloo mesh): every
    step's gathered ``(decision, s_vec)``, the final gathered state and
    the rank's peer index."""
    shape, names, axes, centers, rounds, phases = monitor_stats(case)
    torch.set_num_threads(1)  # several ranks share the host's cores
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    mon = monitor.MeshMonitor(mesh, axes, centers,
                              monitor.MonitorConfig(rounds=rounds),
                              device="cpu")
    st = mon.init()
    steps = []
    for vals, n_steps in phases:
        stat = wvs.from_vector(torch.tensor(vals[mon.peer:mon.peer + 1]),
                               torch.ones(1))
        for _ in range(n_steps):
            st, dec, s_vec = mon.step(st, stat)
            steps.append((mon.gather(dec), mon.gather(s_vec)))
    return {"steps": steps,
            "state": monitor.MonitorState(*(mon.gather(a) for a in st)),
            "peer": mon.peer}


# -- the launcher -------------------------------------------------------------

def raise_on_rank(rank, world, bad):
    """Rank ``bad`` raises; the others block in a collective with it."""
    import torch.distributed as dist

    if rank == bad:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def hang_on_rank(rank, world, bad):
    """Rank ``bad`` never returns; the others return at once."""
    if rank == bad:
        while True:
            time.sleep(1.0)
    return rank


def sum_ranks(rank, world):
    """An all-reduce of the ranks, as a tensor (comes back as numpy)."""
    import torch.distributed as dist

    x = torch.tensor([float(rank)])
    dist.all_reduce(x)
    return {"sum": x, "rank": rank}
