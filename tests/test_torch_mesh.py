"""The port's collective engine transport (``ShardedLSS.use_mesh``: one
shard a rank, the halo over ``all_to_all`` on a ``torch.distributed``
group) against the port's own gather fallback, and against JAX's engine.

Each world size (2 and 4, gloo on the CPU) is one ``launch.spawn`` that
runs every case on a ``("shards",)`` device mesh and returns, after each
dispatch, every ``ShardedState`` field of the gathered state, the metrics,
the send total and ``to_lss_state`` (and the audit of the last state);
the fallback runs the same case at the same S in this process.  They must
be bitwise equal (equal bytes): the mesh changes how many rows a launch
holds, never a row's arithmetic, and the drop streams are the fallback's
per-shard generators.  Cases: grid(64) and chord(64) at drop 0 and 0.1 on
the four wires, and the membership schedule of
``tests/test_membership.py:208`` (a join with two links and a leave
between 6 and 8 cycles) on each wire at drop 0 and 0.1.  The async ring
(staleness 0 and 2 on ``exact`` and ``int8``, chord at drop 0.1) is held
the same way, its books and ring columns gathered, and the layout moves
(``migrate_from`` onto another partition, ``place_lss_state``) with the
cycles after them.  At drop 0 the mesh is also allclose (rtol = atol =
1e-5, as ``tests/test_torch_engine.py``) to JAX's single-device engine,
whose own collective tests fail on this tree (ROADMAP C.2); so is the
async ring at staleness 0 to JAX's async engine.  The spawned ranks also
count a dispatch with ``repro_torch.launch.cost.analyze``, the twin of
``tests/test_hlo_cost.py:110``.
"""

import functools
import time

import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import ShardedLSS as JShardedLSS
from repro_torch.distributed import launch
from test_torch_formulas import assert_close, assert_exact

WORLDS = (2, 4)
TOPOS = ("grid", "chord")
DROPS = (0.0, 0.1)
WIRES = ("exact", "compact", "int8", "bf16")
CASES = ([(t, p, w) for t in TOPOS for p in DROPS for w in WIRES]
         + [("dyn", p, w) for p in DROPS for w in WIRES])
FLOATS = ("out_m", "out_c", "in_m", "in_c", "x_m", "x_c")
SPAWN_TIMEOUT_S = 150


@functools.lru_cache(maxsize=None)
def _mesh_runs(world: int) -> list:
    """Every case at ``world`` ranks: each rank's result."""
    return launch.spawn(torch_ranks.engine_mesh_body, world,
                        timeout_s=SPAWN_TIMEOUT_S, args=(tuple(CASES),))


@functools.lru_cache(maxsize=None)
def _fallback(world: int, case) -> list:
    topo, drop, wire = case
    eng, inputs, graph = torch_ranks.engine_case(topo, world, drop, wire)
    return launch.to_numpy(torch_ranks.drive_engine(eng, inputs, graph))


@functools.lru_cache(maxsize=None)
def _async_fallback(world: int, case) -> dict:
    eng, inputs = torch_ranks.async_case(*case, world)
    return launch.to_numpy(torch_ranks.drive_async(eng, inputs))


def _assert_bitwise(got, want, what):
    """Equal structure, shapes, dtypes and bytes."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), what
        for k in want:
            _assert_bitwise(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_bitwise(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), what
        assert got.shape == want.shape and got.dtype == want.dtype, what
        assert got.tobytes() == want.tobytes(), what
    else:
        assert got == want, what


def _case_id(case):
    return "-".join(str(c) for c in case)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_matches_gather_fallback_bitwise(world, case):
    ranks = _mesh_runs(world)
    want = _fallback(world, case)
    for r, res in enumerate(ranks):
        _assert_bitwise(res["runs"][case], want, f"rank {r} {case}")
    last = want[-1]
    assert last["metrics"][0] > 0.9  # a real run, not a stuck one
    assert last["total_msgs"] > 0


@pytest.mark.parametrize("case", torch_ranks.ASYNC_CASES,
                         ids=[_case_id(c) for c in torch_ranks.ASYNC_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_async_matches_gather_fallback_bitwise(world, case):
    """The async ring with one shard a rank: after every dispatch every
    field of the gathered state, the books and the ring columns in the
    fallback's ``(R, S, S, H)`` layout, the metrics, the send total and
    the lag stats are the single-process async engine's at the same S;
    the audit of the last state is its dict, every check clean."""
    want = _async_fallback(world, case)
    for r, res in enumerate(_mesh_runs(world)):
        _assert_bitwise(res["async"][case], want, f"rank {r} {case}")
    last = want["runs"][-1]
    assert last["metrics"][0] > 0.9 and last["total_msgs"] > 0
    audit = want["audit"]
    assert audit["seq_bad"] == audit["ring_bad"] == audit["stop_bad"] == 0
    assert audit["t"] == torch_ranks.ENGINE_DISPATCHES * torch_ranks.ENGINE_K
    if case[1] > 0:  # the ring delays
        assert 0.0 < last["lag"]["mean_delay"] <= case[1]


@pytest.mark.parametrize("case", torch_ranks.LAYOUT_CASES,
                         ids=[_case_id(c) for c in torch_ranks.LAYOUT_CASES])
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout_moves_match_gather_fallback_bitwise(world, case):
    """``migrate_from`` onto a stride partition with the same S (the
    rank's generator carried over) and ``place_lss_state`` of a core
    snapshot: each moved state, its audit, and the state after
    ``LAYOUT_CYCLES`` more cycles are the fallback's."""
    want = launch.to_numpy(torch_ranks.drive_layout(case, world))
    for r, res in enumerate(_mesh_runs(world)):
        _assert_bitwise(res["layout"][case], want, f"rank {r} {case}")
    assert want[-1]["metrics"][0] == 1.0


def _jax_engine(world, topo, **kw):
    jt = getattr(j_top, topo)(64)
    centers, sample, _, _ = j_sim.make_problem(j_sim.ProblemSpec(n=64,
                                                                 seed=0))
    x = sample(np.random.default_rng(1), jt.n)
    jeng = JShardedLSS(jt, centers, j_lss.LSSConfig(),
                       JEngineConfig(num_shards=world,
                                     cycles_per_dispatch=torch_ranks.
                                     ENGINE_K, **kw))
    return jeng, jeng.init(j_wvs.from_vector(jnp.asarray(x),
                                             jnp.ones((jt.n,), jnp.float32)),
                           seed=0)


def _held_to_jax(got, jeng, jst):
    """Dispatch by dispatch, the checkpoints ``got`` against JAX's engine
    stepped from ``jst``."""
    for i, cp in enumerate(got):
        jst = jeng.run(jst, torch_ranks.ENGINE_K)
        want = jeng.to_lss_state(jst)
        for name, g in cp["lss"].items():
            w = np.asarray(getattr(want, name))
            if name in FLOATS:
                assert_close(g, w, f"dispatch {i}: {name}")
            else:
                assert_exact(g, w, f"dispatch {i}: {name}")
        acc, quiescent, correct = jeng.metrics(jst)
        assert cp["metrics"][0] == float(acc)
        assert cp["metrics"][1] == bool(quiescent)
        assert_exact(cp["metrics"][2], correct, f"dispatch {i}: correct")
        assert cp["total_msgs"] == int(jeng.total_msgs(jst))


@pytest.mark.parametrize("topo", TOPOS)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_matches_jax_engine(world, topo):
    """Drop 0, exact wire: dispatch by dispatch, the gathered mesh state
    (unpermuted) is JAX's gather-fallback engine's at the same S."""
    _held_to_jax(_mesh_runs(world)[0]["runs"][(topo, 0.0, "exact")],
                 *_jax_engine(world, topo))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_async0_matches_jax_engine(world):
    """The async ring at staleness 0, drop 0, exact wire, one shard a
    rank: dispatch by dispatch JAX's async engine's at the same S."""
    _held_to_jax(
        _mesh_runs(world)[0]["async"][("grid", 0, "exact", 0.0)]["runs"],
        *_jax_engine(world, "grid", async_mode=True, staleness=0))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_block_layout_spans_and_errors(world):
    """A rank holds its shard's (1, B, ...) block and a (1,) counter; the
    dispatch span says ``transport="all_to_all"`` with JAX's attributes
    (no ``staged_bytes``: gloo moved CPU tensors); a mis-sized mesh is a
    ValueError, and so is a migration between an engine on the mesh and
    one without (the async ring and the audit run under a mesh: the
    tests above); ``EngineConfig(profile=True)`` profiles as backend
    ``engine-mesh``."""
    res = _mesh_runs(world)[0]
    assert res["block"][0] == 1 and res["msgs"] == (1,)
    spans = res["spans"]
    assert len(spans) == torch_ranks.ENGINE_DISPATCHES
    for sp in spans:
        assert sp["transport"] == "all_to_all" and sp["mode"] == "sync"
        assert sp["k"] == torch_ranks.ENGINE_K and sp["wire"] == "exact"
        assert "staged_bytes" not in sp
    errors = res["errors"]
    assert f"has size {world}, engine has {world + 1} shards" in \
        errors["mis-sized"]
    assert "same process group" in errors["migrate"]
    backend, calls, frac = res["profile"]
    assert backend == "engine-mesh" and calls == 1 and 0.0 <= frac <= 1.0


def test_mesh_collective_bytes_scale():
    """The twin of ``tests/test_hlo_cost.py:110``: on the mesh the halo's
    all-to-alls show up in ``cost.analyze``'s collective bytes,
    multiplied by K, and grow with the shard count S (more ordered pairs
    cross the transport)."""
    def a2a(world, k):
        return _mesh_runs(world)[0]["collective_bytes"][k]["all-to-all"]

    b_s2_k1, b_s2_k4, b_s4_k1 = a2a(2, 1), a2a(2, 4), a2a(4, 1)
    assert b_s2_k1 > 0, b_s2_k1
    assert 3.5 <= b_s2_k4 / b_s2_k1 <= 4.5, (b_s2_k4, b_s2_k1)
    assert b_s4_k1 > b_s2_k1, (b_s4_k1, b_s2_k1)
    for world in WORLDS:  # the alive all-gather, once a cycle
        assert _mesh_runs(world)[0]["collective_bytes"][4]["all-gather"] \
            == 4 * _mesh_runs(world)[0]["collective_bytes"][1]["all-gather"]


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------


def test_spawn_returns_rank_results_as_numpy():
    out = launch.spawn(torch_ranks.sum_ranks, 3, timeout_s=60)
    assert [r["rank"] for r in out] == [0, 1, 2]
    for r in out:
        assert isinstance(r["sum"], np.ndarray) and r["sum"][0] == 3.0


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_spawn_fails_within_its_timeout(how):
    """A raising rank (the others blocked in a barrier with it) and a
    hanging rank each fail the launch, and no rank outlives it."""
    if how == "raise":
        fn, timeout, err, msg = (torch_ranks.raise_on_rank, 60.0,
                                 launch.RankError, "rank 1 of 3 raised")
    else:
        fn, timeout, err, msg = (torch_ranks.hang_on_rank, 12.0,
                                 TimeoutError, "of 3 ranks returned within")
    t0 = time.monotonic()
    with pytest.raises(err, match=msg):
        launch.spawn(fn, 3, timeout_s=timeout, args=(1,))
    assert time.monotonic() - t0 < timeout + 15
