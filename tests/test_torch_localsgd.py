"""The port's LSS-gated LocalSGD (``repro_torch.training.localsgd``, one
replica a rank over ``torch.distributed``) against the JAX package's
(replica-stacked params over fake host devices).

Twins of ``tests/test_distributed.py::test_localsgd_gate``: that test's
schedule (6 gate calls at a drift of 0.05, then 10 from a drift of
``arange(R)`` with the params fed back, tau = 0.5) on the 4-ring
``('data',)``, on a ``(data 2, model 2)`` mesh with ``data_axes=('data',)``
and on ``('pod', 'data')`` of a ``(2, 2, 2)`` mesh (a float32 and a bf16
leaf), and the 4-ring resumed from JAX's state after 4 calls through
``convert.localsgd_state_from_jax_numpy``.  At every gate call ``synced``
and ``syncs`` must equal JAX's exactly; the gathered params, anchor and
every ``MonitorState`` field ``allclose`` (rtol 1e-5, atol 1e-6: JAX jits
the gate, the port runs it op by op); replicas of one peer bitwise equal
at every call, and every rank's replica bitwise equal after a sync.  JAX
runs in one subprocess with 8 host devices, the port's ranks under
``launch.spawn`` on gloo (one launch a world size: 4 and 8).
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch.core.monitor import MonitorState
from repro_torch.distributed import launch

RTOL, ATOL = 1e-5, 1e-6
SPAWN_TIMEOUT_S = 150
WORLD4 = ("ring4", "dm2x2", "ring4_resume")
WORLD8 = ("pod",)

_JAX_LOCALSGD = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.training.localsgd import LocalSGDConfig, make_localsgd
SPEC = json.loads(SPEC)
def lists(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32).tolist(), tree)
out = {}
for case, (shape, names, data_axes, leaves, zeros, hold, feed) in SPEC["cases"].items():
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(names), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(names))
    init_fn, gate_fn = make_localsgd(mesh, tuple(data_axes),
                                     LocalSGDConfig(tau=SPEC["tau"], monitor_rounds=2))
    gate = jax.jit(gate_fn)
    def cast(t):
        return {k: jnp.asarray(np.asarray(v, np.float32), dtype=leaves[k][1])
                for k, v in t.items()}
    state = init_fn(cast(zeros))
    p_feed = cast(feed)
    recs, snap = [], None
    calls = [False] * SPEC["hold"] + [True] * SPEC["feed"]
    for i, fed in enumerate(calls):
        p = p_feed if fed else cast(hold)
        state, p2, synced = gate(state, p)
        if fed:
            p_feed = p2
        recs.append({"synced": bool(synced), "syncs": int(state.syncs),
                     "params": lists(p2), "anchor": lists(state.anchor),
                     "mon": {f: lists(getattr(state.mon, f))
                             for f in state.mon._fields}})
        if i + 1 == SPEC["resume_at"]:
            snap = {"anchor": lists(state.anchor),
                    "mon": {f: lists(getattr(state.mon, f)) for f in state.mon._fields},
                    "syncs": int(state.syncs), "params": lists(p_feed)}
    out[case] = {"records": recs, "snap": snap}
print("RESULT" + json.dumps(out))
"""


def _spec() -> dict:
    cases = {}
    for case, (shape, names, data_axes, leaves) in \
            torch_ranks.LOCALSGD_CASES.items():
        _, zeros, hold, feed = torch_ranks.localsgd_inputs(case)
        cases[case] = (shape, names, data_axes, leaves,
                       *({k: v.tolist() for k, v in t.items()}
                         for t in (zeros, hold, feed)))
    return {"cases": cases, "tau": torch_ranks.LOCALSGD_TAU,
            "hold": torch_ranks.LOCALSGD_HOLD,
            "feed": torch_ranks.LOCALSGD_FEED,
            "resume_at": torch_ranks.LOCALSGD_RESUME_AT}


@functools.lru_cache(maxsize=None)
def _jax_future():
    """Every case through JAX's gate, in one subprocess started on a
    thread beside the port's ranks."""
    from conftest import run_with_devices

    code = f"SPEC = {json.dumps(json.dumps(_spec()))}\n" + _JAX_LOCALSGD
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_with_devices, code, 8, 600)
    pool.shutdown(wait=False)
    return future


@functools.lru_cache(maxsize=None)
def _jax_runs() -> dict:
    out = _jax_future().result(timeout=660)
    return json.loads(out.split("RESULT", 1)[1])


@functools.lru_cache(maxsize=None)
def _world8_future():
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(launch.spawn, torch_ranks.localsgd_body, 8,
                         timeout_s=SPAWN_TIMEOUT_S, args=(WORLD8,))
    pool.shutdown(wait=False)
    return future


def _resume_from_jax():
    """JAX's ring-4 state after ``LOCALSGD_RESUME_AT`` calls, as numpy."""
    snap = _jax_runs()["ring4"]["snap"]
    as_np = {k: np.asarray(v, np.float32) for k, v in snap["anchor"].items()}
    mon = MonitorState(**{f: np.asarray(v, np.float32)
                          for f, v in snap["mon"].items()})
    params = {k: np.asarray(v, np.float32) for k, v in snap["params"].items()}
    return (as_np, mon, np.int32(snap["syncs"])), params


@functools.lru_cache(maxsize=None)
def _port_run(case: str) -> list:
    """Every rank's records of ``case``: the 8-rank launch runs beside
    JAX's subprocess, the 4-rank one (which resumes from JAX's state)
    after it."""
    _jax_future()
    if case in WORLD8:
        ranks = _world8_future().result(timeout=SPAWN_TIMEOUT_S + 60)
    else:
        _world8_future()
        ranks = _world4_ranks()
    return [r[case] for r in ranks]


@functools.lru_cache(maxsize=None)
def _world4_ranks() -> list:
    return launch.spawn(torch_ranks.localsgd_body, 4,
                        timeout_s=SPAWN_TIMEOUT_S,
                        args=(WORLD4, _resume_from_jax()))


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


def _jax_records(case):
    if case == "ring4_resume":
        return _jax_runs()["ring4"]["records"][
            torch_ranks.LOCALSGD_RESUME_AT:]
    return _jax_runs()[case]["records"]


@pytest.mark.parametrize("case", WORLD4 + WORLD8)
def test_localsgd_matches_jax(case):
    ranks = _port_run(case)
    want = _jax_records(case)
    got = ranks[0]["records"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        tag = f"{case} call {i}"
        assert g["synced"] == w["synced"], tag
        assert g["syncs"] == w["syncs"], tag
        for k in w["params"]:
            _close(g["params"][k], w["params"][k], f"{tag}: params {k}")
            _close(g["anchor"][k], w["anchor"][k], f"{tag}: anchor {k}")
        for f, v in w["mon"].items():
            _close(g["mon"][f], v, f"{tag}: mon.{f}")
    # Every rank gathers the same global arrays.
    for r in ranks[1:]:
        for g, g0 in zip(r["records"], got):
            for k in g0["params"]:
                assert np.array_equal(g["params"][k], g0["params"][k])


@pytest.mark.parametrize("case", WORLD4 + WORLD8)
def test_localsgd_replicas_bitwise(case):
    """Replicas of one peer hold the same bits at every call; after a
    sync every rank holds the same bits, and the anchor is the params."""
    ranks = _port_run(case)
    n_calls = len(ranks[0]["records"])
    for i in range(n_calls):
        by_peer = {}
        for r in ranks:
            by_peer.setdefault(r["peer"], []).append(r["records"][i]["local"])
        for peer, reps in by_peer.items():
            for rep in reps[1:]:
                for k in rep:
                    assert np.array_equal(rep[k], reps[0][k]), (case, i, peer)
        rec0 = ranks[0]["records"][i]
        if rec0["synced"]:
            for r in ranks[1:]:
                for k, v in r["records"][i]["local"].items():
                    assert np.array_equal(v, rec0["local"][k]), (case, i)
            for k in rec0["params"]:
                assert np.array_equal(rec0["anchor"][k], rec0["params"][k])


@pytest.mark.parametrize("case", ["ring4", "dm2x2", "pod"])
def test_localsgd_gate_fires_and_averages(case):
    """``test_localsgd_gate``'s own claims on the port: quiet at the small
    drift, fired at the large one, and after a sync every replica is the
    mean of the fed inputs."""
    recs = _port_run(case)[0]["records"]
    hold = torch_ranks.LOCALSGD_HOLD
    assert recs[hold - 1]["syncs"] == 0
    assert any(r["synced"] for r in recs[hold:])
    _, _, _, feed = torch_ranks.localsgd_inputs(case)
    first = next(r for r in recs[hold:] if r["synced"])
    for k, v in first["params"].items():
        want = feed[k].mean(0, keepdims=True)
        np.testing.assert_allclose(v, np.broadcast_to(want, v.shape),
                                   atol=1e-5)


def test_stack_params_matches_jax():
    import jax.numpy as jnp

    from repro.training.localsgd import stack_params as j_stack
    from repro_torch.training import stack_params

    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "blk": {"b": rng.standard_normal((5,)).astype(np.float32)}}
    got = stack_params({"w": torch.tensor(tree["w"]),
                        "blk": {"b": torch.tensor(tree["blk"]["b"])
                                .to(torch.bfloat16)}}, 4)
    want = j_stack({"w": jnp.asarray(tree["w"]),
                    "blk": {"b": jnp.asarray(tree["blk"]["b"],
                                             jnp.bfloat16)}}, 4)
    assert got["w"].shape == (4, 3, 4) and got["blk"]["b"].shape == (4, 5)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(got["blk"]["b"].float().numpy(),
                          np.asarray(want["blk"]["b"], np.float32))
    # A stacked leaf is a copy: a rank's step may write its row in place.
    got["w"][0].add_(1.0)
    assert np.array_equal(got["w"][1].numpy(), tree["w"])
