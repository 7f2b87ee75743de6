"""The port's mesh monitor (``repro_torch.core.monitor.MeshMonitor``, one
rank a peer over ``torch.distributed`` point-to-point sends) against the
JAX package's (``shard_map`` + ``ppermute`` over fake host devices).

Both run the same statistics step by step: the 4x2 torus, the 8-ring
whose mean crosses the boundary and the ``('pod', 'data')`` axes of a
2x2x2 mesh (``tests/test_distributed.py:66/91/264``), a ring of 2 (one
neighbor on both slots), and the first two on 4 ranks (a 4-ring and a 2x2
torus, the shapes the card runs).  Decisions must be equal at every step;
``s_vec`` and the send counters allclose (rtol 1e-5, atol 1e-5: JAX
compiles the round, the port runs it op by op).  JAX runs in one
subprocess with 8 host devices (``tests/conftest.py::run_with_devices``),
the port's ranks under ``repro_torch.distributed.launch.spawn`` on gloo.
"""

import functools
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_ranks
from repro_torch.distributed import launch
from test_torch_formulas import assert_close

CASES = {"torus": 8, "ring8": 8, "pod": 8, "ring2": 2, "ring4": 4,
         "torus2x2": 4}
SPAWN_TIMEOUT_S = 150

_JAX_MONITOR = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import monitor, wvs
out = {}
for case, (shape, names, axes, centers, rounds, phases) in json.loads(CASES).items():
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    mon = monitor.MeshMonitor(Mesh(devs, tuple(names)), tuple(axes),
                              jnp.asarray(centers, jnp.float32),
                              monitor.MonitorConfig(rounds=rounds))
    st = mon.init()
    step = jax.jit(mon.step)
    steps = []
    for vals, n_steps in phases:
        vals = np.asarray(vals, np.float32)
        stat = wvs.from_vector(jnp.asarray(vals), jnp.ones((vals.shape[0],)))
        for _ in range(n_steps):
            st, dec, svec = step(st, stat)
            steps.append((np.asarray(dec).tolist(),
                          np.asarray(svec).tolist()))
    out[case] = {"steps": steps,
                 "state": {f: np.asarray(getattr(st, f)).tolist()
                           for f in st._fields}}
print("RESULT" + json.dumps(out))
"""


@functools.lru_cache(maxsize=None)
def _jax_future():
    """Every case through JAX's monitor, in one subprocess started on a
    thread, so that it runs beside the port's ranks; ``.result()`` is the
    stdout."""
    from conftest import run_with_devices

    cases = {}
    for case in CASES:
        shape, names, axes, centers, rounds, phases = \
            torch_ranks.monitor_stats(case)
        cases[case] = (shape, names, axes, centers, rounds,
                       [(v.tolist(), n) for v, n in phases])
    code = f"CASES = {json.dumps(json.dumps(cases))}\n" + _JAX_MONITOR
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(run_with_devices, code, 8, 600)
    pool.shutdown(wait=False)
    return future


@functools.lru_cache(maxsize=None)
def _jax_runs() -> dict:
    out = _jax_future().result(timeout=660)
    return json.loads(out.split("RESULT", 1)[1])


@functools.lru_cache(maxsize=None)
def _port_run(case: str) -> list:
    return launch.spawn(torch_ranks.monitor_body, CASES[case],
                        timeout_s=SPAWN_TIMEOUT_S, args=(case,))


@pytest.mark.parametrize("case", list(CASES))
def test_monitor_matches_jax(case):
    _jax_future()  # JAX's subprocess runs beside the ranks
    ranks = _port_run(case)
    want = _jax_runs()[case]
    got = ranks[0]
    assert len(got["steps"]) == len(want["steps"])
    for i, ((dec, svec), (jdec, jsvec)) in enumerate(zip(got["steps"],
                                                        want["steps"])):
        assert dec.dtype == np.int32
        np.testing.assert_array_equal(dec, np.asarray(jdec),
                                      err_msg=f"{case} step {i}")
        assert_close(svec, np.asarray(jsvec, np.float32),
                     f"{case} step {i}: s_vec")
    for name, jval in want["state"].items():
        assert_close(getattr(got["state"], name),
                     np.asarray(jval, np.float32), f"{case}: {name}")
    # Every rank gathers the same global arrays.
    for r in ranks[1:]:
        for (dec, svec), (d0, s0) in zip(r["steps"], got["steps"]):
            assert np.array_equal(dec, d0) and np.array_equal(svec, s0)
    # The paper's saving: fewer effective than physical sends.
    state = got["state"]
    assert state.eff_sends.sum() < state.phys_sends.sum()


@pytest.mark.parametrize("case", ["torus", "ring8", "pod"])
def test_monitor_reaches_the_global_decision(case):
    """The JAX tests' own claims on the port: after the last step every
    peer holds the region of the global mean (the 8-ring's after its
    flip)."""
    _, _, _, centers, _, phases = torch_ranks.monitor_stats(case)
    gmean = phases[-1][0].mean(0)
    want = int(((gmean - np.asarray(centers)) ** 2).sum(1).argmin())
    dec = _port_run(case)[0]["steps"][-1][0]
    assert (dec == want).all(), (dec, want)


def test_monitor_peer_order_and_replicas():
    """Peers are row-major over the monitor axes; on the 2x2x2 mesh the
    two ranks that differ only on ``model`` are replicas of one peer."""
    ranks = _port_run("pod")
    # init_device_mesh lays ranks out row-major over (pod, data, model).
    assert [r["peer"] for r in ranks] == [0, 0, 1, 1, 2, 2, 3, 3]
    torus = _port_run("torus")
    assert [r["peer"] for r in torus] == list(range(8))
    assert torus[0]["state"].out_m.shape == (8, 4, 2)


def test_monitor_rejects_three_axes_and_unknown_axes():
    from repro_torch.core import monitor

    class _Mesh:  # the two checks run before the mesh is used
        mesh_dim_names = ("a", "b", "c")
        shape = (1, 1, 1)

    with pytest.raises(ValueError, match="1 \\(ring\\) or 2"):
        monitor.MeshMonitor(_Mesh(), ("a", "b", "c"), [[0.0]],
                            device="cpu")
    with pytest.raises(ValueError, match="no axis 'x'"):
        monitor.MeshMonitor(_Mesh(), ("x",), [[0.0]], device="cpu")
