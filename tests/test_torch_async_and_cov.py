"""The port's event-driven simulator (``repro_torch.core.async_sim``, host
numpy in both packages) and covariance-weighted vector space
(``repro_torch.core.wvs_cov``, on tensors) against the JAX package's.

``AsyncLSS`` is a copy on both sides over each package's own topology,
so on the cases of ``tests/test_async_and_cov.py`` every peer's state,
the event heap and the counters must be equal exactly.  ``wvs_cov`` runs
``torch.linalg`` where JAX runs ``jnp.linalg``: allclose at rtol 1e-5,
atol 1e-5 (``test_torch_formulas``'s tolerance), and it keeps the device
and dtype of its inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_sim as j_async
from repro.core import topology as j_top
from repro.core import wvs_cov as j_cov
from repro_torch.core import async_sim as t_async
from repro_torch.core import topology as t_top
from repro_torch.core import wvs_cov as t_cov
from test_torch_formulas import assert_close


def _problem(n, seed=0, bias_point=(0.6, 0.7)):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [1.0, 1.0], [2.0, 0.0]])
    inputs = rng.normal(loc=bias_point, scale=0.8, size=(n, 2))
    return centers, inputs


def _pair(topo_name, n, data_seed, **kw):
    """The same simulation in both packages."""
    centers, inputs = _problem(n, seed=data_seed)
    sims = []
    for top, mod in ((j_top, j_async), (t_top, t_async)):
        topo = getattr(top, topo_name)(n)
        sims.append(mod.AsyncLSS(topo, inputs, centers, **kw))
    return sims


def _assert_same(jsim, tsim):
    assert tsim.now == jsim.now
    assert tsim.messages_sent == jsim.messages_sent
    assert tsim.messages_delivered_stale == jsim.messages_delivered_stale
    assert len(tsim.peers) == len(jsim.peers)
    for i, (tp, jp) in enumerate(zip(tsim.peers, jsim.peers)):
        for f in ("x_m", "out_m", "out_c", "in_m", "in_c", "last_seq_in"):
            assert np.array_equal(getattr(tp, f), getattr(jp, f)), (i, f)
        for f in ("x_c", "seq", "last_send", "next_wake"):
            assert getattr(tp, f) == getattr(jp, f), (i, f)
    assert len(tsim.events) == len(jsim.events)
    for te, je in zip(sorted(tsim.events, key=lambda e: e[1]),
                      sorted(jsim.events, key=lambda e: e[1])):
        assert te[:3] == je[:3]
    assert tsim.accuracy() == jsim.accuracy()
    assert tsim.quiescent() == jsim.quiescent()


@pytest.mark.parametrize("topo_name", ["grid", "chord"])
def test_async_reordering_run_equals_jax(topo_name):
    """``test_async_converges_with_reordering``: 90 % latency jitter."""
    jsim, tsim = _pair(topo_name, 36, 1, mean_latency=1.0, jitter=0.9,
                       seed=2)
    for until in (5.0, 40.0, 300.0):
        jsim.run(until=until)
        tsim.run(until=until)
        _assert_same(jsim, tsim)
    assert tsim.accuracy()[0] == 1.0 and tsim.quiescent()
    assert tsim.messages_delivered_stale > 0


def test_async_message_loss_equals_jax():
    jsim, tsim = _pair("grid", 36, 3, drop_rate=0.02, seed=4)
    jsim.run(until=500.0)
    tsim.run(until=500.0)
    _assert_same(jsim, tsim)
    assert tsim.accuracy()[0] >= 0.95


def test_async_zero_jitter_equals_jax():
    jsim, tsim = _pair("grid", 25, 9, mean_latency=1.0, jitter=0.0, seed=10)
    jsim.run(until=300.0)
    tsim.run(until=300.0)
    _assert_same(jsim, tsim)
    assert tsim.messages_delivered_stale == 0 and tsim.quiescent()


def test_async_seq_guard_equals_jax():
    """``test_async_seq_guard_drops_stale_in_place``'s injected
    out-of-order deliveries, in both packages."""
    sims = _pair("grid", 9, 7, seed=8)
    for sim in sims:
        for p in sim.peers:
            p.last_send = 1e18
        sim._schedule(1.0, "msg", (4, 0, np.array([5.0, 5.0]), 2.0, 2))
        sim._schedule(2.0, "msg", (4, 0, np.array([-3.0, -3.0]), 1.0, 1))
        sim.run(until=2.5)
        sim._schedule(3.0, "msg", (4, 0, np.array([5.0, 5.0]), 2.0, 2))
        sim.run(until=3.5)
    _assert_same(*sims)
    assert sims[1].messages_delivered_stale == 1
    assert sims[1].peers[4].last_seq_in[0] == 2


def _estimates(rng, d, n):
    out = []
    for _ in range(n):
        a = rng.normal(size=(d, d))
        out.append((rng.normal(size=d), a @ a.T + np.eye(d)))
    return out


@pytest.mark.parametrize("d", [2, 3])
def test_cov_fusion_matches_jax(d):
    rng = np.random.default_rng(d)
    (v1, w1), (v2, w2) = _estimates(rng, d, 2)
    jz = j_cov.add(j_cov.from_estimate(jnp.asarray(v1), jnp.asarray(w1)),
                   j_cov.from_estimate(jnp.asarray(v2), jnp.asarray(w2)))
    tz = t_cov.add(t_cov.from_estimate(torch.tensor(v1, dtype=torch.float32),
                                       torch.tensor(w1, dtype=torch.float32)),
                   t_cov.from_estimate(torch.tensor(v2, dtype=torch.float32),
                                       torch.tensor(w2, dtype=torch.float32)))
    assert_close(tz.m, np.asarray(jz.m), "m")
    assert_close(tz.W, np.asarray(jz.W), "W")
    assert_close(t_cov.vec(tz), np.asarray(j_cov.vec(jz)), "vec")
    want = np.linalg.solve(w1 + w2, w1 @ v1 + w2 @ v2)
    np.testing.assert_allclose(t_cov.vec(tz).numpy(), want, atol=1e-5)


def test_cov_algebra_matches_jax():
    """sub/smul/zero/mahalanobis on a batch, and the float64 dtype kept."""
    rng = np.random.default_rng(7)
    est = _estimates(rng, 2, 4)
    v = np.stack([e[0] for e in est])
    w = np.stack([e[1] for e in est])
    jx = j_cov.from_estimate(jnp.asarray(v, jnp.float32),
                             jnp.asarray(w, jnp.float32))
    tx = t_cov.from_estimate(torch.tensor(v, dtype=torch.float32),
                             torch.tensor(w, dtype=torch.float32))
    s = np.array([0.5, 2.0, 1.0, 3.0], np.float32)
    for jy, ty in ((j_cov.smul(jnp.asarray(s), jx),
                    t_cov.smul(torch.tensor(s), tx)),
                   (j_cov.smul(jnp.asarray(0.25), jx),
                    t_cov.smul(0.25, tx)),
                   (j_cov.sub(jx, j_cov.smul(0.5, jx)),
                    t_cov.sub(tx, t_cov.smul(0.5, tx)))):
        assert_close(ty.m, np.asarray(jy.m))
        assert_close(ty.W, np.asarray(jy.W))
        assert_close(t_cov.vec(ty), np.asarray(j_cov.vec(jy)))
    c = np.array([0.3, -0.2], np.float32)
    assert_close(t_cov.mahalanobis(tx, torch.tensor(c)),
                 np.asarray(j_cov.mahalanobis(jx, jnp.asarray(c))))
    assert float(t_cov.mahalanobis(tx, t_cov.vec(tx)).abs().max()) < 1e-6
    tz, jz = t_cov.zero(2, (3,)), j_cov.zero(2, (3,))
    assert tuple(tz.m.shape) == jz.m.shape and tuple(tz.W.shape) == jz.W.shape
    x64 = t_cov.from_estimate(torch.tensor(v[0]), torch.tensor(w[0]))
    assert t_cov.vec(x64).dtype == torch.float64
    with pytest.raises(NotImplementedError):
        t_cov.smul(torch.ones(4, 2, 2), tx)
