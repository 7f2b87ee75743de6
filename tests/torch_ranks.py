"""Rank bodies for the port's multi-process tests (``launch.spawn`` runs
them in fresh interpreters, one a rank) and the single-process halves
they are compared with.

No JAX here: a spawned rank imports this module, and only torch, numpy
and ``repro_torch``.  The test files import it too and hold the results
against the JAX package.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.utils._python_dispatch import TorchDispatchMode

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


# -- the multi-process training substrate (A.10c part 1) ----------------------

@contextlib.contextmanager
def one_rank_group():
    """A gloo process group of one rank in this process (for a one-device
    mesh in a test), destroyed on exit."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


LOCALSGD_TAU = 0.5  # tests/test_distributed.py::test_localsgd_gate
LOCALSGD_HOLD = 6  # gate calls at a drift of 0.05 (no sync)
LOCALSGD_FEED = 10  # gate calls from a drift of arange(R), params fed back
LOCALSGD_RESUME_AT = 4  # "ring4_resume" starts from JAX's state after this
# case: (mesh shape, axis names, data_axes, {leaf: (shape after R, dtype)})
LOCALSGD_CASES = {
    "ring4": ((4,), ("data",), ("data",), {"w": ((8,), "float32")}),
    "dm2x2": ((2, 2), ("data", "model"), ("data",),
              {"w": ((8,), "float32")}),
    "pod": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data"),
            {"b": ((8,), "bfloat16"), "w": ((2, 4), "float32")}),
}


def localsgd_inputs(case: str):
    """``(R, params0, hold, feed)`` of a case, as float32 numpy (R, ...)
    trees: the replica-stacked zeros, the held input (+0.05) and the first
    fed input (+ arange(R) along the replicas: drifts 8 i^2 and up, far
    from tau = 0.5).  Each package casts them to the leaf's dtype."""
    shape, names, data_axes, leaves = LOCALSGD_CASES[case]
    R = int(np.prod([n for n, a in zip(shape, names) if a in data_axes]))
    zeros = {k: np.zeros((R, *s), np.float32) for k, (s, _) in leaves.items()}
    hold = {k: v + np.float32(0.05) for k, v in zeros.items()}
    feed = {k: v + np.arange(R, dtype=np.float32).reshape(
        R, *([1] * (v.ndim - 1))) for k, v in zeros.items()}
    return R, zeros, hold, feed


def _f32(t):
    return t.float() if t.dtype == torch.bfloat16 else t


def localsgd_body(rank, world, cases, resume=None):
    """Each LocalSGD case of ``cases`` on a gloo mesh: at every gate call
    the synced flag, the sync count, the gathered (R, ...) params, anchor
    and monitor fields (bf16 as float32) and this rank's own params.
    ``resume``: JAX's state as numpy after ``LOCALSGD_RESUME_AT`` calls of
    "ring4" and its params then, to run the rest from ("ring4_resume")."""
    from repro_torch import convert
    from repro_torch.training import localsgd

    torch.set_num_threads(1)
    out = {}
    for case in cases:
        base = "ring4" if case == "ring4_resume" else case
        shape, names, data_axes, leaves = LOCALSGD_CASES[base]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        cfg = localsgd.LocalSGDConfig(tau=LOCALSGD_TAU, monitor_rounds=2)
        init_fn, gate = localsgd.make_localsgd(mesh, data_axes, cfg,
                                               device="cpu")
        peer = gate.mon.peer
        R, zeros, hold, feed = localsgd_inputs(base)

        def row(tree):
            return {k: torch.tensor(v[peer:peer + 1]).to(
                getattr(torch, leaves[k][1])) for k, v in tree.items()}

        calls = [False] * LOCALSGD_HOLD + [True] * LOCALSGD_FEED
        p_feed = row(feed)
        if case == "ring4_resume":
            jstate, jparams = resume
            state = convert.localsgd_state_from_jax_numpy(jstate, peer, "cpu")
            p_feed = {k: torch.tensor(np.asarray(v, np.float32)[peer:peer + 1])
                      for k, v in jparams.items()}
            calls = calls[LOCALSGD_RESUME_AT:]
        else:
            state = init_fn(row(zeros))
        records = []
        for fed in calls:
            p = p_feed if fed else row(hold)
            state, p2, synced = gate(state, p)
            if fed:
                p_feed = p2
            records.append({
                "synced": synced, "syncs": int(state.syncs),
                "params": {k: _f32(v) for k, v in gate.gather(p2).items()},
                "anchor": {k: _f32(v)
                           for k, v in gate.gather(state.anchor).items()},
                "mon": {f: gate.mon.gather(getattr(state.mon, f))
                        for f in state.mon._fields},
                "local": {k: _f32(v) for k, v in p2.items()}})
        out[case] = {"peer": peer, "records": records}
    return out


PIPE_CASES = ((4, 8, 2, 16), (4, 2, 2, 16), (2, 8, 2, 16))  # (S, M, B, D)


def pipeline_inputs(S, M, B, D, seed=0):
    """Numpy ``Ws`` (S, D, D) / sqrt(D) and ``xs`` (M, B, D), float32."""
    rng = np.random.default_rng([seed, S, M])
    ws = (rng.standard_normal((S, D, D)) / np.sqrt(D)).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return ws, xs


def _stage_fn(w, x):
    return torch.tanh(x @ w)


def pipeline_body(rank, world, cases):
    """Each ``(S, M, B, D)`` of ``cases`` through ``pipeline`` on a gloo
    mesh (``("stage",)`` when S is the world, else ``("data", "stage")``),
    with full and (S = world) DTensor-placed stacked params, beside the
    same stages applied in sequence one microbatch at a time."""
    from repro_torch.distributed import pipeline, sharding

    torch.set_num_threads(1)
    out = {}
    for S, M, B, D in cases:
        if S == world:
            mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("stage",))
        else:
            mesh = init_device_mesh("cpu", (world // S, S),
                                    mesh_dim_names=("data", "stage"))
        ws, xs = (torch.tensor(a) for a in pipeline_inputs(S, M, B, D))
        apply = pipeline.pipeline(_stage_fn, mesh, "stage")
        got = {"full": apply(ws, xs)}
        ticks = apply.ticks
        if S == world:
            placed = sharding.device_put(
                ws, sharding.NamedSharding(mesh, ("stage",)))
            got["dtensor"] = apply(placed, xs)
        seq = []
        for m in range(M):
            x = xs[m]
            for s in range(S):
                x = _stage_fn(ws[s], x)
            seq.append(x)
        out[(S, M, B, D)] = {**got, "seq": torch.stack(seq),
                             "active": [a for _, _, a in ticks],
                             "stage": int(mesh.get_local_rank("stage"))}
    out["no_axis"] = _raises(lambda: pipeline.pipeline(_stage_fn, mesh, "pp"))
    return out


# Elastic: an 8-rank save restored by a 4-rank launch; at world 3 a mesh
# over ranks [0, 1] leaves rank 2 out (JAX's remesh never reports a spare:
# its model axis halves down to a divisor of the count).
ELASTIC_W = np.arange(64, dtype=np.float32).reshape(8, 8)
RESHARD_SPECS = {"a": (("pod", "data"), None), "blk": {"b": (None, "model"),
                                                         "c": (None,)}}
BATCH_SOURCE = dict(vocab=1000, seq_len=16, global_batch=8, seed=3,
                    frames_dim=4, enc_len=3)


def reshard_tree() -> dict:
    """The reshard case's values (numpy): a dim on ("pod", "data"), one on
    "model", one replicated."""
    rng = np.random.default_rng(5)
    return {"a": rng.standard_normal((8, 3)).astype(np.float32),
            "blk": {"b": rng.standard_normal((3, 4)).astype(np.float32),
                    "c": np.arange(5, dtype=np.int32)}}


def cross_tree() -> dict:
    """The tree the port saves from DTensor leaves on 4 ranks and JAX
    loads: a sharded float32 matrix, a replicated int vector, a tuple."""
    rng = np.random.default_rng(9)
    return {"p": {"w": rng.standard_normal((8, 6)).astype(np.float32),
                  "n": np.arange(4, dtype=np.int32)},
            "t": (rng.standard_normal((4,)).astype(np.float32),)}


CROSS_SPECS = {"p": {"w": ("data", "model"), "n": (None,)}, "t": ((None,),)}


def _coord(mesh):
    c = mesh.get_coordinate()
    return None if c is None else tuple(int(i) for i in c)


def _mesh_info(mesh):
    return (tuple(mesh.mesh_dim_names), tuple(int(n) for n in mesh.shape))


def _raises(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return f"ValueError: {e}"
    return "no error"


def elastic_body(rank, world, ckpt_dir):
    """The elastic cases of a launch of ``world`` ranks (1, 3, 4 or 8)."""
    from repro_torch import checkpoint
    from repro_torch.data import TokenSource, make_batch_fn
    from repro_torch.distributed import elastic, sharding
    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    out = {"host_mesh": _mesh_info(mesh_lib.make_host_mesh()),
           "host_mesh_1axis": _mesh_info(
               mesh_lib.make_host_mesh(axes=("data",))),
           "production": [_raises(lambda mp=mp: mesh_lib.make_production_mesh(
               multi_pod=mp)) for mp in (False, True)],
           "bad_shape": _raises(lambda: mesh_lib.make_host_mesh(
               (world + 1, 1)))}
    if world == 1:
        mesh, info = elastic.remesh(model_axis=1)
        out.update(remesh=info, remesh_mesh=_mesh_info(mesh))
    elif world == 3:  # rank 2 outside the mesh: a spare
        mesh, info = elastic.remesh([0, 1], model_axis=2)
        x = sharding.device_put(torch.tensor(ELASTIC_W[:4]),
                                sharding.NamedSharding(mesh, ("data",
                                                              "model")))
        out.update(remesh=info, coord=_coord(mesh),
                   local_numel=x.to_local().numel(),
                   full=sharding.full_tensor(x))
    elif world == 8:
        mesh8, info = elastic.remesh(model_axis=2)
        t8 = sharding.device_put(torch.tensor(ELASTIC_W),
                                 sharding.NamedSharding(mesh8,
                                                        ("data", "model")))
        checkpoint.save(ckpt_dir + "/elastic", 1, {"w": t8})
        cube = mesh_lib.make_host_mesh((2, 2, 2), ("pod", "data", "model"))
        placed = elastic.reshard(
            {k: (torch.tensor(v) if not isinstance(v, dict) else
                 {kk: torch.tensor(vv) for kk, vv in v.items()})
             for k, v in reshard_tree().items()}, RESHARD_SPECS, cube)
        batch = make_batch_fn(TokenSource(**BATCH_SOURCE), mesh=cube,
                              device="cpu")(7)
        out.update(
            remesh=info, coord8=_coord(mesh8), local8=t8.to_local(),
            cube_coord=_coord(cube),
            reshard={"a": placed["a"].to_local(),
                     "b": placed["blk"]["b"].to_local(),
                     "c": placed["blk"]["c"].to_local()},
            placements={"a": [str(p) for p in placed["a"].placements],
                        "b": [str(p) for p in placed["blk"]["b"].placements]},
            indivisible=_raises(lambda: sharding.device_put(
                torch.zeros(3, 4), sharding.NamedSharding(cube, ("data",)))),
            batch={f: getattr(batch, f).to_local()
                   for f in ("tokens", "labels", "frames")},
            batch_full=sharding.full_tensor(batch.tokens))
    elif world == 4:
        mesh4, info = elastic.remesh(model_axis=2)
        sh = {"w": sharding.NamedSharding(mesh4, ("data", "model"))}
        t4 = checkpoint.load(ckpt_dir + "/elastic", 1,
                             {"w": torch.zeros(8, 8)}, shardings=sh)
        grid = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        cross = {"p": {k: torch.tensor(v) for k, v in
                       cross_tree()["p"].items()},
                 "t": tuple(torch.tensor(v) for v in cross_tree()["t"])}
        checkpoint.save(ckpt_dir + "/cross", 2,
                        elastic.reshard(cross, CROSS_SPECS, grid))
        out.update(remesh=info, coord4=_coord(mesh4),
                   local4=t4["w"].to_local(),
                   mesh4=_mesh_info(t4["w"].device_mesh),
                   full4=sharding.full_tensor(t4["w"]),
                   latest=checkpoint.latest_step(ckpt_dir + "/cross"))
    return out


def card_substrate_body(rank, world, tmp):
    """The card test of the substrate on ``world`` ranks of one card
    (gloo): a LocalSGD ring's gate calls on the card and on the CPU (the
    synced flags and the gathered params), and a DTensor checkpoint round
    trip with its leaves on the card (the local shards before the save and
    after the load, as uint8 bytes, and the gathered whole)."""
    from repro_torch import checkpoint
    from repro_torch.distributed import elastic, sharding
    from repro_torch.training import localsgd

    torch.cuda.set_device(0)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for where in ("cuda", "cpu"):
        init_fn, gate = localsgd.make_localsgd(
            mesh, ("data",), localsgd.LocalSGDConfig(tau=LOCALSGD_TAU),
            device=where)
        zeros = torch.zeros((1, 2, 4), device=where)
        state = init_fn({"w": zeros})
        p_feed = {"w": zeros + gate.mon.peer}
        calls = []
        for i in range(LOCALSGD_HOLD + LOCALSGD_FEED):
            fed = i >= LOCALSGD_HOLD
            state, p2, synced = gate(state, p_feed if fed
                                     else {"w": zeros + 0.05})
            if fed:
                p_feed = p2
            calls.append((synced, gate.gather(p2)["w"]))
        out[where] = calls
    g = torch.Generator(device="cuda").manual_seed(3)
    tree = {"w": torch.randn((4, 6), generator=g, device="cuda"),
            "b": torch.randn((6, 2), generator=g,
                             device="cuda").to(torch.bfloat16)}
    specs = {"w": ("data", None), "b": (None,)}
    placed = elastic.reshard(tree, specs, mesh)
    checkpoint.save(tmp, 1, placed)
    back = checkpoint.load(tmp, 1, tree,
                           shardings=sharding.shardings_like(tree, specs,
                                                             mesh))

    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)

    out["ckpt"] = {k: (raw(placed[k].to_local()), raw(back[k].to_local()),
                       back[k].to_local().device.type,
                       raw(sharding.full_tensor(back[k])), raw(tree[k]))
                   for k in tree}
    return out


# -- the steps across a multi-device mesh (A.10c part 2) ----------------------

STEP_MESH = ((2, 2), ("data", "model"))
STEP_L = 32  # tokens a row of the train cells (tests/torch_train_parity.py)
STEP_2X2_L = 64  # tests/test_distributed.py::test_train_step_sharded_2x2
SERVE_PROMPT, SERVE_DECODE = 12, 3  # a prefill, then greedy decode steps
SERVE_LEN = 16  # the caches' length: the KV sequence splits over "data"
SERVE_ARCHS = ("yi-9b", "zamba2-2.7b")
MOE_ARCH = "qwen3-moe-235b-a22b"


def step_variant(arch: str, variant: str):
    """The smoke config of ``arch`` (float32): as it is (``"smoke"``), or
    with FSDP on the data axes and remat on (``"fsdp_remat"``)."""
    import dataclasses

    from repro_torch import configs

    cfg = configs.get_smoke(arch)
    if variant == "fsdp_remat":
        cfg = dataclasses.replace(cfg, fsdp=True, remat=True)
    return cfg


def case_cfg(case: dict):
    """:func:`step_variant` of a case (``variant`` "smoke" by default),
    with its ``n_heads`` / ``n_kv`` / ``n_experts`` overrides, where
    set."""
    import dataclasses

    cfg = step_variant(case["arch"], case.get("variant", "smoke"))
    if case.get("n_heads"):
        cfg = dataclasses.replace(cfg, n_heads=case["n_heads"])
    if case.get("n_kv"):
        cfg = dataclasses.replace(cfg, n_kv=case["n_kv"])
    if case.get("n_experts"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=case["n_experts"]))
    return cfg


def step_params(cfg, params_np=None):
    """The parameters of a case: JAX's (numpy, by path) or the port's own
    from seed 0, on the CPU."""
    from repro_torch import convert
    from repro_torch.models import build

    if params_np is not None:
        return convert.model_params_from_jax_numpy(cfg, params_np, "cpu")
    return build(cfg, "cpu").init(torch.Generator().manual_seed(0))


def step_batch(cfg, rows: int, length: int, seed: int) -> dict:
    """Token and label rows (numpy int32) from ``seed``."""
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab, (rows, length)).astype(np.int32)
            for k in ("tokens", "labels")}


def _skew_loss(model, mesh, skew: float):
    """Scale ``model``'s loss by ``1 + skew`` times this rank's coordinate
    on ``"model"``: ranks that hold the same replica of a leaf then compute
    grads that differ, as the CUDA backward's atomics make them differ at
    round-off."""
    k = 1.0 + skew * mesh.get_coordinate()[
        mesh.mesh_dim_names.index("model")]
    inner = model.loss

    def loss(*args, **kwargs):
        lo, aux = inner(*args, **kwargs)
        return lo * k, aux

    model.loss = loss


def train_case(case: dict, mesh=None) -> dict:
    """``case["steps"]`` train steps of a case on ``mesh`` (None: one
    process; ``case["skew"]``, if set, through :func:`_skew_loss`): the
    metrics of each step, and after the last the parameters,
    moments and step (gathered whole), each output's placement and whether
    every local shard is bitwise its slice of the gathered value (by
    tree)."""
    from repro_torch import configs, tree
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    if case.get("skew") and mesh is not None:
        _skew_loss(model, mesh, case["skew"])
    params = step_params(cfg, case.get("params"))
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    rows, length = batch["tokens"].shape
    step, _, out_specs, _ = build_for_cell(
        model, mesh, configs.ShapeCell("t", "train", length, rows),
        TrainHParams(lr=1e-3, warmup=0, accum_steps=case["accum"]))
    opt = adamw_init(params)
    metrics = []
    for _ in range(case["steps"]):
        params, opt, m = step(params, opt, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics}
    if mesh is None:
        out.update(params=tree.plain(params), m=opt.m, v=opt.v,
                   step=int(opt.step))
        return out
    trees = {"params": params, "m": opt.m, "v": opt.v}
    specs = {"params": out_specs[0], "m": out_specs[1].m,
             "v": out_specs[1].v}
    bitwise, placed = {}, []
    for key, t in trees.items():
        bitwise[key] = True
        flat = tree.leaves(t)
        full = [sharding.full_tensor(x) for x in flat]
        for x, whole, spec in zip(flat, full,
                                  tree.prefix_leaves(t, specs[key])):
            sl = sharding.local_slices(tuple(whole.shape),
                                       dict(zip(mesh.mesh_dim_names,
                                                tuple(mesh.shape))),
                                       spec, dict(zip(mesh.mesh_dim_names,
                                                      mesh.get_coordinate())))
            bitwise[key] = bitwise[key] and torch.equal(x.to_local(),
                                                        whole[sl])
            placed.append((sharding._spec_of(x), spec))
        out[key] = tree.unflatten_like(t, full)
    out.update(step=int(sharding.full_tensor(opt.step)), bitwise=bitwise,
               placements=[(tuple(a), tuple(b) + (None,) * (len(a) - len(b)))
                           for a, b in placed],
               model_gathered=sorted(step.plan.model_gathered))
    return out


def moe_grads(case: dict, mesh=None) -> dict:
    """The loss and the router grads of a MoE case's accumulated step (the
    grads before clipping), on ``mesh`` or in one process."""
    from repro_torch import tree
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import build
    from repro_torch.training import steps

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = step_params(cfg)
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    A = case["accum"]
    if mesh is None:
        loss, _, grads = steps.loss_and_grads(model, params, batch, A)
        return {"loss": loss, "router": grads["blocks"]["moe"]["router"]}
    from repro_torch.models import common

    plan = spmd.MeshPlan(mesh)
    with common.axis_env(mesh):
        pspecs = model.param_specs()
    placed = sharding.put_tree(params, pspecs, mesh, "cpu")
    specs = tree.prefix_leaves(placed, pspecs)
    batch_spec = {k: ("data", None) for k in batch}
    loss, _, grads = steps._mesh_loss_and_grads(model, plan, placed, specs,
                                                batch, batch_spec, A)
    names = tree.leaves_with_names(placed)[0]
    router = grads[names.index("['blocks']['moe']['router']")]
    assert specs[names.index("['blocks']['moe']['router']")] == \
        (None, None, None)  # replicated: the local grad is the whole one
    return {"loss": loss, "router": router}


def serve_case(arch: str, rows: int, mesh=None) -> np.ndarray:
    """A prefill of ``SERVE_PROMPT`` tokens and ``SERVE_DECODE`` greedy
    steps of ``arch``'s smoke model (port's seed-0 parameters) on ``rows``
    rows (1: ``long_ctx``), on ``mesh`` or in one process: the tokens
    (rows, 1 + SERVE_DECODE)."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cfg = configs.get_smoke(arch)
    model = build(cfg, "cpu")
    params = step_params(cfg)
    toks = torch.tensor(step_batch(cfg, rows, SERVE_PROMPT, 11)["tokens"])
    cache = model.init_cache(rows, SERVE_LEN)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", SERVE_PROMPT, rows))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", SERVE_LEN, rows))[0]
    tok, cache = prefill(params, toks, cache)
    out = [tok]
    for _ in range(SERVE_DECODE):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.stack([sharding.full_tensor(t) for t in out], 1)


def step_specs(archs, mesh) -> dict:
    """Every kind of cell's ``in_specs`` and ``out_specs`` for each arch's
    smoke config on ``mesh`` (tests/torch_train_parity.py's cells)."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cells = (configs.ShapeCell("t", "train", STEP_L, 2),
             configs.ShapeCell("p", "prefill", SERVE_PROMPT, 2),
             configs.ShapeCell("l", "prefill", SERVE_PROMPT, 1),
             configs.ShapeCell("d", "decode", SERVE_LEN, 2),
             configs.ShapeCell("dl", "decode", SERVE_LEN, 1))
    out = {}
    for arch in archs:
        model = build(configs.get_smoke(arch), "meta")
        out[arch] = {c.name: build_for_cell(model, mesh, c)[1:3]
                     for c in cells}
    return out


def mesh_steps_body(rank, world, cases):
    """The train, MoE-grad and serve cases of ``cases`` on a (2, 2)
    ("data", "model") gloo mesh, and the spec trees."""
    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", STEP_MESH[0], mesh_dim_names=STEP_MESH[1])
    out = {"train": {name: train_case(c, mesh)
                     for name, c in cases["train"].items()},
           "moe": moe_grads(cases["moe"], mesh),
           "serve": {(arch, rows): serve_case(arch, rows, mesh)
                     for arch in SERVE_ARCHS for rows in (4, 1)}}
    if rank == 0:
        out["specs"] = step_specs(cases["spec_archs"], mesh)
    return out


# -- the dry-run's count against a real run ----------------------------------

DRYRUN_LAYERS = 4  # past the 3 depths the dry-run traces: it extrapolates
DRYRUN_CELLS = (("t", "train", STEP_L, 16, 4),  # (name, kind, L, B, accum)
                ("d", "decode", SERVE_LEN, 2, 1))


def dryrun_cfg():
    """yi-9b smoke at ``DRYRUN_LAYERS`` layers with FSDP and remat."""
    import dataclasses

    return dataclasses.replace(step_variant("yi-9b", "fsdp_remat"),
                               n_layers=DRYRUN_LAYERS)


def dryrun_real_body(rank, world):
    """Each ``DRYRUN_CELLS`` step on the (2, 2) mesh, on real CPU tensors
    (the port's seed-0 parameters, ``input_specs()``'s shapes placed at
    ``in_specs``), counted by ``cost.analyze``."""
    from repro_torch import configs, tree
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.training import TrainHParams, build_for_cell

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", STEP_MESH[0], mesh_dim_names=STEP_MESH[1])
    cfg = dryrun_cfg()
    model = build(cfg, "cpu")
    out = {}
    for name, kind, length, rows, accum in DRYRUN_CELLS:
        cell = configs.ShapeCell(name, kind, length, rows)
        fn, in_specs, _, input_specs = build_for_cell(
            model, mesh, cell, TrainHParams(accum_steps=accum))
        shapes = input_specs()
        gen = torch.Generator().manual_seed(0)

        def real(t):
            if t.is_floating_point():
                return torch.randn(t.shape, generator=gen).to(t.dtype) * 0.02
            return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                 dtype=t.dtype)

        args = tuple(tree.map(real, a) for a in shapes)
        if kind == "decode":  # an empty cache: positions start at 0
            args = (args[0], args[1], model.init_cache(rows, length))
        placed = tuple(sharding.put_tree(a, s, mesh, "cpu")
                       for a, s in zip(args, in_specs))
        out[name] = cost.analyze(fn, *placed)
    return out


# -- tensor-parallel compute on "model" (A.10d part 1) ------------------------

TP_MESHES = ((2, 2), (1, 4))  # ("data", "model")
TP_TRAIN_ARCHS = ("yi-9b", "whisper-large-v3")
# yi-9b smoke on (1, 4): kv 2 < 4, the d_head-split cache; command-r smoke:
# 6 heads over 4, 1 or 2 a rank in train and prefill; whisper smoke with 6
# heads (the port's own parameters, held to one process):
# the self and cross caches split on d_head, the prompt's cross attention
# on the gathered heads.
WHISPER_6H = "whisper-large-v3/6-heads"
TP_SERVE_ARCHS = {(2, 2): ("yi-9b", "whisper-large-v3"),
                  (1, 4): ("yi-9b", "command-r-plus-104b",
                           "whisper-large-v3", WHISPER_6H)}
TP_FLOPS_ARCH = "yi-9b"


class MatmulFlops(TorchDispatchMode):
    """Counts the flops of the matrix products (``mm`` / ``bmm`` /
    ``addmm`` / ``baddbmm``, ``2 m n k``) run inside the block."""

    flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in ("mm", "bmm", "addmm", "baddbmm"):
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self.flops += 2 * out.numel() * a.shape[-1]
        return out


def tp_serve(case: dict, mesh=None) -> np.ndarray:
    """A prefill of ``case["tokens"]`` and ``case["decode"]`` greedy steps
    of the arch's smoke model (``case["n_heads"]`` heads, if set) from
    ``case["params"]`` (numpy, JAX's paths; None: the port's seed 0), on
    ``mesh`` or in one process: the tokens (rows, 1 + decode).  An
    enc-dec's encoder and cache are made in this process, the steps run
    on the mesh."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import EncDecConfig, build
    from repro_torch.training import build_for_cell

    cfg = configs.get_smoke(case["arch"])
    if case.get("n_heads"):
        cfg = dataclasses.replace(cfg, n_heads=case["n_heads"])
    model = build(cfg, "cpu")
    params = step_params(cfg, case["params"])
    toks = torch.tensor(case["tokens"])
    rows, prompt = toks.shape
    length = prompt + case["decode"]
    if isinstance(cfg, EncDecConfig):
        with torch.no_grad():
            enc = model.encode(params, torch.tensor(case["frames"]))
            cache = model.init_cache(params, enc, rows, length)
    else:
        cache = model.init_cache(rows, length)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", prompt, rows))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", length, rows))[0]
    tok, cache = prefill(params, toks, cache)
    out = [tok]
    for _ in range(case["decode"]):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return torch.stack([sharding.full_tensor(t) for t in out], 1).numpy()


def tp_vocab(mesh, seed: int = 5) -> dict:
    """The vocab-parallel helpers on ``mesh``'s "model" ranks against the
    whole-vocab functions on the gathered logits: the NLL and its grad
    (largest abs differences), and the argmax with ties placed across a
    shard boundary and inside a shard (equal or not)."""
    from repro_torch.distributed import spmd
    from repro_torch.models.transformer import _nll

    plan = spmd.MeshPlan(mesh)
    m, r = plan.tp_size, plan.tp_rank
    n = 8
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((2, 5, m * n), generator=gen) * 3
    labels = torch.randint(0, m * n, (2, 5), generator=gen)
    whole = logits.clone().requires_grad_(True)
    want = _nll(whole, labels)
    want.backward()
    part = logits[..., r * n:(r + 1) * n].clone().requires_grad_(True)
    got = plan.vocab_nll(part, labels)
    got.backward()
    grad_err = float((part.grad - whole.grad[..., r * n:(r + 1) * n])
                     .abs().max())
    rows = torch.randn((6, m * n), generator=gen)
    top = float(rows.max()) + 1
    for i, b in enumerate((n, 2 * n if m > 2 else n, m * n - n)):
        rows[2 * i, b - 1] = rows[2 * i, b] = top  # across a boundary
    rows[1, 1] = rows[1, 3] = top  # inside a shard
    rows[3, 0] = rows[3, m * n - 1] = top  # first and last
    got_arg = plan.vocab_argmax(rows[:, r * n:(r + 1) * n].contiguous())
    return {"nll_err": abs(float(got) - float(want)), "nll": float(got),
            "grad_err": grad_err,
            "argmax": got_arg.numpy(),
            "argmax_want": torch.argmax(rows, dim=-1).to(torch.int32).numpy()}


ROW_PRODUCT_TOL = {  # of max |reference|: the forward's, the grads'
    torch.bfloat16: (1e-5, 2.0 ** -7),  # float32 sums; one bf16 rounding
    torch.float32: (1e-12, 1e-6),  # float64 sums; float32 sums
}


def row_product_errors(dtype, device, seed: int = 11) -> dict:
    """A row-parallel partial (``spmd._RowProduct``, what
    ``MeshPlan.row_product`` returns) of ``dtype`` operands on ``device``
    and its grads, against autograd of the float64 ``einsum`` of the same
    operands with the upstream grad rounded to ``dtype`` (as the backward
    takes it): each error over the largest reference value, and the
    result's dtype.  The shapes are all different, so a transposed grad
    cannot pass."""
    from repro_torch.distributed import spmd

    gen = np.random.default_rng(seed)
    h = torch.tensor(gen.standard_normal((2, 3, 24)), dtype=dtype,
                     device=device, requires_grad=True)
    w = torch.tensor(gen.standard_normal((24, 5)) / 5, dtype=dtype,
                     device=device, requires_grad=True)
    out = spmd._RowProduct.apply(h, w)
    up = torch.tensor(gen.standard_normal(out.shape), dtype=out.dtype,
                      device=device)
    out.backward(up)
    h64 = h.detach().double().requires_grad_()
    w64 = w.detach().double().requires_grad_()
    ref = torch.einsum("blf,fd->bld", h64, w64)
    ref.backward(up.to(dtype).double())

    def err(got, want):
        return float((got.double() - want).abs().max() / want.abs().max())

    return {"dtype": out.dtype, "out": err(out.detach(), ref.detach()),
            "h": err(h.grad, h64.grad), "w": err(w.grad, w64.grad),
            "grad_dtypes": (h.grad.dtype, w.grad.dtype)}


def tp_matmul_flops(case: dict, mesh=None) -> int:
    """The matrix-product flops of one train step of ``case`` (as
    :func:`train_case`'s) on this rank of ``mesh``, or in one process."""
    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = step_params(cfg, case.get("params"))
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    rows, length = batch["tokens"].shape
    step = build_for_cell(model, mesh, configs.ShapeCell(
        "t", "train", length, rows), TrainHParams(
            lr=1e-3, warmup=0, accum_steps=case["accum"]))[0]
    opt = adamw_init(params)
    with MatmulFlops() as counted:
        step(params, opt, batch)
    return counted.flops


def tp_body(rank, world, cases):
    """Every case of ``cases`` on each ``TP_MESHES`` mesh of the 4 ranks:
    the train steps, the served tokens, the vocab helpers, and on (1, 4)
    the matrix-product flops of a train step."""
    torch.set_num_threads(1)
    out = {}
    for shape in TP_MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {"train": {key: train_case(c, mesh)
                         for key, c in cases["train"].items()},
               "serve": {arch: tp_serve(cases["serve"][arch], mesh)
                         for arch in TP_SERVE_ARCHS[shape]},
               "vocab": tp_vocab(mesh)}
        if shape == (1, 4):
            res["flops"] = tp_matmul_flops(cases["flops"], mesh)
        out[shape] = res
    return out


# -- experts on "model" and the KV sequence on "data" (A.10d part 2) ----------

EP_MESHES = ((2, 2), (1, 4))  # ("data", "model"): the train and MoE cases
LONG_MESHES = ((2, 2), (4, 1))  # long_ctx: "data" splits the sequence
EP_ARCHS = ("qwen3-moe-235b-a22b", "mixtral-8x7b")  # E, d_ff on "model"
EP_WHOLE_EXPERTS = 6  # qwen3-moe smoke with 6 experts: 4 do not divide them
EP_PROMPT, EP_DECODE, EP_LEN = 12, 3, 16  # a prefill, greedy steps, cache
CACHE_FILL_SEED = 23  # the long_ctx caches start as noise, not zeros
# The long_ctx cases (batch 1, the port's seed-0 parameters): the prompt,
# the cache's length, the meshes, overrides.  "yi-9b/masked": the slices
# above position 12 of 32 stay masked after the prefill (a (4, 1) rank's
# whole slice; on (2, 2) the upper half); "yi-9b/1-kv": one kv head, so
# "model" splits d_head while "data" splits the sequence; mixtral's 46
# tokens pass its 32 window: the ring wraps across slice boundaries, and
# the decode steps write slots 14, 15, 16, across the one at 16.
LONG_CASES = {
    "yi-9b": dict(arch="yi-9b", prompt=12, length=16, meshes=LONG_MESHES),
    "yi-9b/masked": dict(arch="yi-9b", prompt=12, length=32,
                         meshes=LONG_MESHES),
    "yi-9b/1-kv": dict(arch="yi-9b", prompt=12, length=16, n_kv=1,
                       meshes=((2, 2),)),
    "zamba2-2.7b": dict(arch="zamba2-2.7b", prompt=12, length=16,
                        meshes=LONG_MESHES),
    "mixtral-8x7b": dict(arch="mixtral-8x7b", prompt=46, length=49,
                         meshes=LONG_MESHES),
}


def fill_cache(cache, seed: int = CACHE_FILL_SEED):
    """``cache`` (an ``LMCache``) with its KV caches' k and v drawn from
    ``seed`` (standard normal): slots no step writes must come out as
    they went in, and noise in the masked ones must not leak."""
    gen = torch.Generator().manual_seed(seed)
    kv = cache.kv
    return cache._replace(kv=kv._replace(
        k=torch.randn(kv.k.shape, generator=gen).to(kv.k.dtype),
        v=torch.randn(kv.v.shape, generator=gen).to(kv.v.dtype)))


def initial_cache(case: dict, model=None):
    """The cache a :func:`seq_serve` case starts from: empty, or noise
    (:func:`fill_cache`) where ``case["fill"]``."""
    from repro_torch.models import build

    model = build(case_cfg(case), "cpu") if model is None else model
    cache = model.init_cache(len(case["tokens"]), case["length"])
    return fill_cache(cache) if case.get("fill") else cache


def seq_serve(case: dict, mesh=None) -> dict:
    """A prefill of ``case["tokens"]`` (rows, prompt) and ``case["decode"]``
    greedy steps of ``case_cfg(case)`` from ``case["params"]`` (numpy,
    JAX's paths; None: the port's seed 0) against a cache of
    ``case["length"]`` (filled by :func:`fill_cache` where ``case["fill"]``),
    on ``mesh`` or in one process: the tokens (rows, 1 + decode) and,
    after the prefill and each step, the KV caches' k and v (on a mesh:
    this rank's shard and its spec), and on a mesh the bytes the steps'
    collectives took (``plan.sent``) and this rank's coordinate."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = step_params(cfg, case.get("params"))
    toks = torch.tensor(case["tokens"])
    rows, prompt = toks.shape
    cache = initial_cache(case, model)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", prompt, rows))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", case["length"], rows))[0]

    def kv_state(c):
        if mesh is None:
            return {f: getattr(c.kv, f).numpy() for f in ("k", "v")}
        return {f: (sharding._spec_of(getattr(c.kv, f)),
                    getattr(c.kv, f).to_local().numpy()) for f in ("k", "v")}

    tok, cache = prefill(params, toks, cache)
    out, kv = [tok], [kv_state(cache)]
    for _ in range(case["decode"]):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
        kv.append(kv_state(cache))
    res = {"tokens": torch.stack([sharding.full_tensor(t) for t in out],
                                 1).numpy(), "kv": kv}
    if mesh is not None:
        res.update(sent_prefill=dict(prefill.plan.sent),
                   sent_decode=dict(decode.plan.sent),
                   sizes=dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
                   coord=dict(zip(mesh.mesh_dim_names,
                                  mesh.get_coordinate())))
    return res


def ep_body(rank, world, cases):
    """The cases of ``cases`` on each mesh of the 4 ranks: on
    ``EP_MESHES`` the MoE train steps, the router grads and the MoE
    serving cases; on (1, 4) also the 6-expert step and the
    matrix-product flops; the long_ctx cases on their meshes."""
    torch.set_num_threads(1)
    out = {}
    for shape in dict.fromkeys(EP_MESHES + LONG_MESHES):
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {"serve": {name: seq_serve(c, mesh)
                         for name, c in cases["serve"].items()
                         if shape in c["meshes"]}}
        if shape in EP_MESHES:
            res["train"] = {key: train_case(c, mesh)
                            for key, c in cases["train"].items()}
            res["router"] = {arch: moe_grads(c, mesh)
                             for arch, c in cases["router"].items()}
        if shape == (1, 4):
            res["whole"] = train_case(cases["whole"], mesh)
            res["flops"] = {arch: tp_matmul_flops(c, mesh)
                            for arch, c in cases["flops"].items()}
        out[shape] = res
    return out


# -- the SSD's heads and uneven attention heads on "model" (A.10d part 3) -----

SSD_MESHES = ((2, 2), (1, 4))  # ("data", "model")
SSD_ARCHS = ("mamba2-370m", "zamba2-2.7b")  # H = 8 heads of the SSD
# qwen3 smoke with 6 heads (2 kv heads): 4 ranks on "model" divide neither,
# qwen3-14b's case (40 heads, 8 kv) at the production "model" of 16.
UNEVEN = "qwen3-14b/6-heads"
UNEVEN_CASE = dict(arch="qwen3-14b", n_heads=6)
UNEVEN_FLOPS_ARCH = "command-r-plus-104b"  # 6 heads over 4 as it is


def _ssd_leaves(grads) -> dict:
    """The SSD's leaves of a grad tree (numpy, stacked over the layers)."""
    return {k: np.asarray(v) for k, v in grads["blocks"]["ssm"].items()}


def ssd_grads(case: dict, mesh=None) -> dict:
    """The SSD's grads (before clipping, whole) of a case's accumulated
    step, on ``mesh`` (each local grad gathered whole) or in one
    process."""
    from repro_torch import tree
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import build, common
    from repro_torch.training import steps

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = step_params(cfg, case.get("params"))
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    A = case["accum"]
    if mesh is None:
        return _ssd_leaves(steps.loss_and_grads(model, params, batch, A)[2])
    plan = spmd.MeshPlan(mesh)
    with common.axis_env(mesh):
        pspecs = model.param_specs()
    placed = sharding.put_tree(params, pspecs, mesh, "cpu")
    specs = tree.prefix_leaves(placed, pspecs)
    batch_spec = {k: ("data", None) for k in batch}
    grads = steps._mesh_loss_and_grads(model, plan, placed, specs, batch,
                                       batch_spec, A)[2]
    whole = [plan.gather(g, plan.dim_axes(s, g.ndim))
             for g, s in zip(grads, specs)]
    return _ssd_leaves(tree.unflatten_like(common.as_tree(params), whole))


def ssd_serve(case: dict, mesh=None) -> dict:
    """:func:`tp_serve`'s prefill and greedy steps of ``case_cfg(case)``,
    with the SSM state after each step (None without one): ``ssm`` and
    ``conv`` (on a mesh: (spec, this rank's shard)); on a mesh also the
    bytes the decode steps' collectives took and the leaves gathered over
    "model"."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = step_params(cfg, case["params"])
    toks = torch.tensor(case["tokens"])
    rows, prompt = toks.shape
    length = prompt + case["decode"]
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", prompt, rows))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", length, rows))[0]

    def state(c):
        if c.ssm is None:
            return None
        if mesh is None:
            return {f: getattr(c.ssm, f).numpy() for f in ("ssm", "conv")}
        return {f: (sharding._spec_of(getattr(c.ssm, f)),
                    getattr(c.ssm, f).to_local().numpy())
                for f in ("ssm", "conv")}

    tok, cache = prefill(params, toks, model.init_cache(rows, length))
    out, states = [tok], [state(cache)]
    for _ in range(case["decode"]):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
        states.append(state(cache))
    res = {"tokens": torch.stack([sharding.full_tensor(t) for t in out],
                                 1).numpy(), "states": states}
    if mesh is not None:
        res.update(sent_decode=dict(decode.plan.sent),
                   gathered=sorted(prefill.plan.model_gathered
                                   | decode.plan.model_gathered),
                   decode_gathered=sorted(decode.plan.model_gathered),
                   sizes=dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))),
                   coord=dict(zip(mesh.mesh_dim_names,
                                  mesh.get_coordinate())))
    return res


def ssd_flops(case: dict, mesh=None, rows: int = 2, seed: int = 3) -> int:
    """The matrix-product flops of the SSD of layer 0 of ``case``'s model,
    forward and backward (the grad of the sum of squares of its output
    on (rows, 32) inputs from ``seed``, the grads of the input and of
    every leaf), on this rank of ``mesh`` (its leaves placed at their
    specs, within ``tensor_parallel``) or in one process."""
    from repro_torch import tree
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import build, common, ssm

    cfg = case_cfg(case)
    model = build(cfg, "cpu")
    params = common.as_tree(step_params(cfg, case.get("params")))
    x = torch.randn((rows, STEP_L, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    x.requires_grad_(True)
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in
              common.tree_index(params["blocks"]["ssm"], 0).items()}
    plan = None
    if mesh is not None:
        plan = spmd.MeshPlan(mesh)
        with common.axis_env(mesh):
            specs = model.param_specs()["blocks"]["ssm"]
        placed = sharding.put_tree(params["blocks"]["ssm"], specs, mesh,
                                   "cpu")
        names, flat = tree.leaves_with_names(placed)
        leaves = common.tree_index(tree.unflatten_like(placed, [
            plan.leaf(p, s, n) for p, s, n in zip(
                flat, tree.prefix_leaves(placed, specs), names)]), 0)
        for leaf in tree.leaves(placed):
            spmd.local(leaf).requires_grad_(True)
    with MatmulFlops() as counted, common.tensor_parallel(
            None if plan is None else plan.tp):
        out = ssm.fwd_train(leaves, cfg.ssm, x, with_state=False)[0]
        (out.float() ** 2).sum().backward()
    return counted.flops


def gather_from_model_case(mesh, width: int = 8) -> dict:
    """``common.gather_from_model`` of a seeded bf16 (2, 3, ``width``)
    share a rank over "model" and the backward of a seeded bf16
    cotangent a rank: whether the value is every rank's share in rank
    order, whether the grad is the float32 sum of every rank's cotangent
    slice cast to bf16 (its dtype beside), and the bytes the backward's
    reduce-scatter sent against a float32 full (2, 3, m ``width``)."""
    from repro_torch.distributed import spmd
    from repro_torch.models import common

    plan = spmd.MeshPlan(mesh)
    m, r = plan.tp_size, plan.tp_rank

    def draw(seed, *shape):
        gen = torch.Generator().manual_seed(seed)
        return torch.randn(*shape, generator=gen).to(torch.bfloat16)

    shares = [draw(100 + i, 2, 3, width) for i in range(m)]
    cots = [draw(200 + i, 2, 3, width * m) for i in range(m)]
    x = shares[r].clone().requires_grad_()
    with common.tensor_parallel(plan.tp):
        y = common.gather_from_model(x, -1)
        before = plan.sent["tp"]
        y.backward(cots[r])
    want = sum(c.float() for c in cots)[..., r * width:(r + 1) * width]
    return {"value": bool(torch.equal(y.detach(), torch.cat(shares, -1))),
            "grad": bool(torch.equal(x.grad, want.to(torch.bfloat16))),
            "grad_dtype": str(x.grad.dtype),
            "sent": plan.sent["tp"] - before, "want_sent": 2 * 3 * width * m
            * 4}


def ssd_body(rank, world, cases):
    """Every case of ``cases`` on each ``SSD_MESHES`` mesh of the 4 ranks:
    the train steps, the SSD's grads, the served tokens and states,
    :func:`gather_from_model_case`, and on (1, 4) the flops of the SSD
    alone and of the uneven-head step."""
    torch.set_num_threads(1)
    out = {}
    for shape in SSD_MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        res = {"train": {key: train_case(c, mesh)
                         for key, c in cases["train"].items()},
               "grads": {arch: ssd_grads(c, mesh)
                         for arch, c in cases["grads"].items()},
               "serve": {arch: ssd_serve(c, mesh)
                         for arch, c in cases["serve"].items()},
               "gather": gather_from_model_case(mesh)}
        if shape == (1, 4):
            res["flops"] = {"ssd": ssd_flops(cases["flops"]["ssd"], mesh),
                            "uneven": tp_matmul_flops(
                                cases["flops"]["uneven"], mesh)}
        out[shape] = res
    return out
