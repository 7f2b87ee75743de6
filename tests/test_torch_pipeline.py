"""The port's stage pipeline (``repro_torch.distributed.pipeline``, one
stage a rank, activations hopping by ``batch_isend_irecv``) against the
JAX package's (``shard_map`` + ``ppermute`` over fake host devices).

Twin of ``tests/test_distributed.py::test_pipeline_matches_sequential``:
S = 4 stages, M = 8 microbatches of (B = 2, D = 16), ``tanh(x @ w)``,
with numpy ``Ws`` and ``xs``; and M = 2 < S, and S = 2 (two pipelines
side by side on a ``("data", "stage")`` mesh of the 4 ranks).  Every
rank's output must be ``allclose`` (atol 1e-5, JAX's test's) to JAX's,
and bitwise the port's own stages applied in sequence one microbatch at a
time on the CPU (the same ops on the same shapes; a hop moves bytes, the
final SUM over the axis adds zeros).  Stacked params placed on the axis
as a DTensor give the same bits.  JAX runs in one subprocess with 4 host
devices beside the port's one 4-rank launch.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_ranks
from repro_torch.distributed import launch

CASES = torch_ranks.PIPE_CASES
SPAWN_TIMEOUT_S = 150

_JAX_PIPELINE = """
import json, numpy as np, jax, jax.numpy as jnp
from repro.distributed.pipeline import pipeline
out = {}
for key, (S, ws, xs) in json.loads(CASES).items():
    mesh = jax.make_mesh((S,), ('stage',), devices=jax.devices()[:S],
                         axis_types=(jax.sharding.AxisType.Auto,))
    def stage_fn(w, x):
        return jnp.tanh(x @ w)
    apply = pipeline(stage_fn, mesh, 'stage')
    got = jax.jit(apply)(jnp.asarray(np.asarray(ws, np.float32)),
                         jnp.asarray(np.asarray(xs, np.float32)))
    out[key] = np.asarray(got).tolist()
print("RESULT" + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax_future():
    from conftest import run_with_devices

    cases = {}
    for S, M, B, D in CASES:
        ws, xs = torch_ranks.pipeline_inputs(S, M, B, D)
        cases[str((S, M, B, D))] = (S, ws.tolist(), xs.tolist())
    code = f"CASES = {json.dumps(json.dumps(cases))}\n" + _JAX_PIPELINE
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_with_devices, code, 4, 600)
    pool.shutdown(wait=False)
    return future


@functools.lru_cache(maxsize=None)
def _jax_runs() -> dict:
    out = _jax_future().result(timeout=660)
    return json.loads(out.split("RESULT", 1)[1])


@functools.lru_cache(maxsize=None)
def _port_run() -> list:
    _jax_future()  # JAX's subprocess runs beside the ranks
    return launch.spawn(torch_ranks.pipeline_body, 4,
                        timeout_s=SPAWN_TIMEOUT_S, args=(CASES,))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_pipeline_matches_jax(case):
    ranks = _port_run()
    want = np.asarray(_jax_runs()[str(case)], np.float32)
    for r in ranks:
        got = r[case]["full"]
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_pipeline_bitwise_to_sequential(case):
    for r in _port_run():
        out = r[case]
        assert np.array_equal(out["full"], out["seq"])
        if "dtensor" in out:  # stacked params as a DTensor on the axis
            assert np.array_equal(out["dtensor"], out["seq"])
    assert any("dtensor" in r[case] for r in _port_run()) == (case[0] == 4)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_pipeline_fill_drain_schedule(case):
    """M + S - 1 ticks; stage s holds a microbatch at ticks s .. s + M - 1,
    so each stage idles (S - 1) / (M + S - 1) of the ticks."""
    S, M, _, _ = case
    ranks = _port_run()
    assert sorted({r[case]["stage"] for r in ranks}) == list(range(S))
    for r in ranks:
        s, active = r[case]["stage"], r[case]["active"]
        assert len(active) == M + S - 1
        assert active == [0 <= t - s < M for t in range(M + S - 1)]
        assert active.count(False) / len(active) == (S - 1) / (M + S - 1)


def test_pipeline_refuses_a_missing_axis():
    for r in _port_run():
        assert r["no_axis"].startswith("ValueError: mesh has no axis 'pp'")
