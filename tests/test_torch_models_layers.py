"""The port's model layers (``repro_torch.models``: common, mlp, attention,
moe, ssm) against the JAX package's, on the same inputs and the same
parameters (drawn by JAX, carried across as numpy).

Tolerance: float32 ``allclose(atol=1e-4, rtol=1e-4)`` unless a test says
otherwise.  The MoE routing (``top_e``, ``keep``, ``dst``) must be equal.
The chunked attention path is reached by making ``CHUNK_Q``, ``CHUNK_KV``
and ``DENSE_MAX`` small in both packages; the window ring cache by a
prefill longer than the window followed by decode steps.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import mlp as j_mlp
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro_torch.models import attention, common, mlp, moe, ssm

TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a, dtype=None):
    """A JAX or numpy array as a CPU tensor (bfloat16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(a.copy())
    return t if dtype is None else t.to(dtype)


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _tree(params):
    return jax.tree.map(_t, params)


def _close(got, want, **tol):
    np.testing.assert_allclose(_n(got), _n(want), **(tol or TOL))


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_norms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = _randn(rng, 2, 5, 3, 16)
    w, b = _randn(rng, 16), _randn(rng, 16)
    _close(common.rms_norm(_t(x), _t(w)), j_common.rms_norm(x, w))
    _close(common.layer_norm(_t(x), _t(w), _t(b)),
           j_common.layer_norm(x, w, b))
    pos = np.arange(7, 12)[None, :]
    for theta in (10_000.0, 1_000_000.0, 75_000_000.0):
        jc, js = j_common.rope(jnp.asarray(pos), 16, theta)
        tc, ts = common.rope(_t(pos), 16, theta)
        _close(tc, jc, atol=1e-6, rtol=1e-5)
        _close(ts, js, atol=1e-6, rtol=1e-5)
        _close(common.apply_rope(_t(x), tc, ts),
               j_common.apply_rope(x, jc, js))


SPEC_AXES = [(None,), ("model",), ("model", None), (j_common.DATA, "model"),
             ("model", j_common.DATA), (None, None, "data"),
             (("data", "model"), None), (None, j_common.DATA, "model", None)]


@pytest.mark.parametrize("env", [None, ("data", "model"),
                                 ("pod", "data", "model"), ("model",)])
def test_pspec_matches_jax(env):
    def both():
        for axes in SPEC_AXES:
            assert common.pspec(*axes) == tuple(j_common.pspec(*axes)), axes
        assert common.axis_size("model") == j_common.axis_size("model")

    if env is None:
        both()
        return
    with j_common.axis_env(env), common.axis_env(env):
        both()
    assert common.pspec("model") == (None,)


def test_axis_env_reads_mesh_sizes():
    jmesh = types.SimpleNamespace(axis_names=("data", "model"),
                                  shape={"data": 2, "model": 4})
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                  shape=(2, 4))
    with j_common.axis_env(jmesh), common.axis_env(tmesh):
        for name in ("data", "model", ("data", "model"), j_common.DATA,
                     "pod"):
            assert common.axis_size(name) == j_common.axis_size(name)
    x = torch.ones(3)
    assert common.shard(x, "data") is x


def test_param_tree_paths_and_no_grad():
    tree = {"a": torch.zeros(2), "b": {"c": torch.ones(3, 4),
                                       "self": {"d": torch.ones(1)}}}
    pt = common.ParamTree(tree)
    assert sorted(n for n, _ in pt.named_parameters()) == [
        "a", "b.c", "b.self.d"]
    assert not any(p.requires_grad for p in pt.parameters())
    got = pt.tree()
    assert got["b"]["c"] is pt.b.c and got["b"]["self"]["d"].shape == (1,)
    assert common.as_tree(got) is got
    stacked = common.tree_index({"w": torch.arange(6).reshape(3, 2)}, 1)
    assert stacked["w"].tolist() == [2, 3]


# ---------------------------------------------------------------------------
# mlp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["swiglu", "gelu", "gelu-nobias"])
def test_mlp_matches_jax(kind):
    key = jax.random.PRNGKey(1)
    x = _randn(np.random.default_rng(1), 2, 5, 32)
    if kind == "swiglu":
        jp = j_mlp.init_swiglu(key, 32, 48)
        want, got = j_mlp.swiglu(jp, x), mlp.swiglu(_tree(jp), _t(x))
    else:
        jp = j_mlp.init_gelu(key, 32, 48, bias=kind == "gelu")
        if kind == "gelu":  # nonzero biases, so they are exercised
            jp = {**jp, "b1": jnp.full((48,), 0.1), "b2": jnp.full((32,), -0.2)}
        want, got = j_mlp.gelu_mlp(jp, x), mlp.gelu_mlp(_tree(jp), _t(x))
    _close(got, want)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

ATTN = {
    "gqa-qknorm": j_attn.AttnConfig(d_model=32, n_heads=4, n_kv=2, d_head=8,
                                    qk_norm=True),
    "mha-bias": j_attn.AttnConfig(d_model=32, n_heads=4, n_kv=4, d_head=8,
                                  bias=True, rope_theta=1e6),
    "window": j_attn.AttnConfig(d_model=32, n_heads=4, n_kv=2, d_head=8,
                                window=6),
    "encoder": j_attn.AttnConfig(d_model=32, n_heads=4, n_kv=4, d_head=8,
                                 bias=True, causal=False),
}


def _attn_params(cfg, seed=2):
    jp = j_attn.init(jax.random.PRNGKey(seed), cfg)
    if cfg.bias:  # nonzero biases
        rng = np.random.default_rng(seed)
        jp = {k: (jnp.asarray(_randn(rng, *v.shape, scale=0.1))
                  if k.startswith("b") else v) for k, v in jp.items()}
    return jp, _tree(jp)


def _port_cfg(cfg):
    return attention.AttnConfig(**{f: getattr(cfg, f)
                                   for f in cfg.__dataclass_fields__})


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_dense_matches_jax(name):
    jcfg = ATTN[name]
    jp, tp = _attn_params(jcfg)
    x = _randn(np.random.default_rng(3), 2, 11, 32)
    _close(attention.fwd_train(tp, _port_cfg(jcfg), _t(x)),
           j_attn.fwd_train(jp, jcfg, x))


def test_cross_attention_matches_jax():
    jcfg = j_attn.AttnConfig(d_model=32, n_heads=4, n_kv=4, d_head=8,
                             bias=True, cross=True)
    tcfg = _port_cfg(jcfg)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(4)
    x, enc = _randn(rng, 2, 5, 32), _randn(rng, 2, 9, 32)
    jk, jv = j_attn.cross_kv(jp, jcfg, enc)
    tk, tv = attention.cross_kv(tp, tcfg, _t(enc))
    _close(tk, jk)
    _close(tv, jv)
    enc_len = np.array([9, 4], np.int32)
    _close(attention.fwd_cross_decode(tp, tcfg, _t(x), tk, tv, _t(enc_len)),
           j_attn.fwd_cross_decode(jp, jcfg, x, jk, jv, enc_len))
    _close(attention.fwd_train(tp, tcfg, _t(x), kv_src=_t(enc)),
           j_attn.fwd_train(jp, jcfg, x, kv_src=enc))


@pytest.fixture
def small_chunks(monkeypatch):
    """CHUNK_Q = 8, CHUNK_KV = 16, DENSE_MAX = 16 in both packages, so a
    48-token sequence runs 6 x 3 blocks of the chunked path."""
    for mod in (j_attn, attention):
        monkeypatch.setattr(mod, "CHUNK_Q", 8)
        monkeypatch.setattr(mod, "CHUNK_KV", 16)
        monkeypatch.setattr(mod, "DENSE_MAX", 16)
    calls = []
    real = attention._attend_chunked
    monkeypatch.setattr(attention, "_attend_chunked",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


@pytest.mark.parametrize("name", sorted(ATTN))
def test_attention_chunked_matches_jax(name, small_chunks, monkeypatch):
    jcfg = ATTN[name]
    jp, tp = _attn_params(jcfg)
    x = _randn(np.random.default_rng(5), 2, 48, 32)
    got = attention.fwd_train(tp, _port_cfg(jcfg), _t(x))
    assert small_chunks, "the chunked path did not run"
    _close(got, j_attn.fwd_train(jp, jcfg, x))
    # and the chunked path equals the dense one on the same inputs
    monkeypatch.setattr(attention, "DENSE_MAX", 4096)
    _close(got, attention.fwd_train(tp, _port_cfg(jcfg), _t(x)),
           atol=1e-5, rtol=1e-5)


def test_attention_chunked_bf16_matches_jax(small_chunks):
    """bf16 storage, float32 scores: the port's float32 dots on bf16
    operands against JAX's ``preferred_element_type`` dots, held at the
    float32 tolerance though the outputs are bf16 (the largest difference
    measured on the CPU is 0: the bf16 outputs are equal)."""
    jcfg = ATTN["window"]
    jp, _ = _attn_params(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    x = jnp.asarray(_randn(np.random.default_rng(6), 2, 48, 32),
                    jnp.bfloat16)
    rng = np.random.default_rng(7)
    q, k, v = (jnp.asarray(_randn(rng, 2, 48, h, 8), jnp.bfloat16)
               for h in (4, 2, 2))
    off = jnp.zeros((2,), jnp.int32)
    want = j_attn._attend_chunked(q, k, v, causal=True, window=6,
                                  q_offset=off, kv_len=None)
    got = attention._attend_chunked(_t(q), _t(k), _t(v), causal=True,
                                    window=6, q_offset=_t(off), kv_len=None)
    assert got.dtype == torch.bfloat16
    _close(got, want)
    y = attention.fwd_train(_tree(jp), _port_cfg(jcfg), _t(x))
    _close(y, j_attn.fwd_train(jp, jcfg, x))


@pytest.mark.parametrize("prompt", [3, 6, 13])
def test_window_ring_prefill_then_decode_matches_jax(prompt):
    """A window-6 ring: a prompt shorter than, equal to and longer than
    the ring (13 rolls it by 13 % 6), then 8 decode steps that wrap it."""
    jcfg = ATTN["window"]
    tcfg = _port_cfg(jcfg)
    jp, tp = _attn_params(jcfg)
    rng = np.random.default_rng(prompt)
    x = _randn(rng, 2, prompt + 8, 32)
    jc = j_attn.init_cache(jcfg, 2, 6, jnp.float32)
    tc = attention.init_cache(tcfg, 2, 6, torch.float32)
    jy, jc = j_attn.fwd_prefill(jp, jcfg, x[:, :prompt], jc)
    ty, tc = attention.fwd_prefill(tp, tcfg, _t(x[:, :prompt]), tc)
    _close(ty, jy)
    for step in range(8):
        for a, b in zip(tc, jc):
            _close(a, b)
        assert tc.length.tolist() == np.asarray(jc.length).tolist()
        xt = x[:, prompt + step: prompt + step + 1]
        jy, jc = j_attn.fwd_decode(jp, jcfg, xt, jc)
        ty, tc = attention.fwd_decode(tp, tcfg, _t(xt), tc)
        _close(ty, jy)


def test_decode_without_window_matches_jax():
    jcfg = ATTN["gqa-qknorm"]
    tcfg = _port_cfg(jcfg)
    jp, tp = _attn_params(jcfg)
    x = _randn(np.random.default_rng(8), 2, 9, 32)
    jc = j_attn.init_cache(jcfg, 2, 12, jnp.float32)
    tc = attention.init_cache(tcfg, 2, 12, torch.float32)
    jy, jc = j_attn.fwd_prefill(jp, jcfg, x[:, :5], jc)
    ty, tc2 = attention.fwd_prefill(tp, tcfg, _t(x[:, :5]), tc)
    assert not tc.k.any(), "the cache passed in was written"
    _close(ty, jy)
    for t in range(5, 9):
        jy, jc = j_attn.fwd_decode(jp, jcfg, x[:, t:t + 1], jc)
        ty, tc2 = attention.fwd_decode(tp, tcfg, _t(x[:, t:t + 1]), tc2)
        _close(ty, jy)
    _close(tc2.k, jc.k)
    _close(tc2.v, jc.v)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

MOE = {
    "cf1.25": (j_moe.MoEConfig(d_model=32, d_ff=48, n_experts=4, top_k=2,
                               capacity_factor=1.25), False, False),
    "drops": (j_moe.MoEConfig(d_model=32, d_ff=48, n_experts=4, top_k=2,
                              capacity_factor=0.5), False, False),
    "ties": (j_moe.MoEConfig(d_model=32, d_ff=48, n_experts=8, top_k=3,
                             capacity_factor=1.0), False, True),
    "dropless": (j_moe.MoEConfig(d_model=32, d_ff=48, n_experts=8, top_k=2,
                                 capacity_factor=0.25), True, False),
}


def _jax_routing(jp, cfg, x, dropless):
    """JAX's routing as ``moe.fwd`` computes it, and its dispatch."""
    B, L, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    probs = jax.nn.softmax(jnp.einsum("bld,de->ble", x, jp["router"]), -1)
    top_p, top_e = jax.lax.top_k(probs, K)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    C = min(L if dropless else (int(cfg.capacity_factor * L * K / E) or 1),
            L * K)
    _, dst, keep, _, w = jax.vmap(
        lambda xg, te, tp: j_moe._dispatch_group(xg, te, tp, E, C))(
            x, top_e, top_p)
    return top_e, dst, keep, w, C


@pytest.mark.parametrize("name", sorted(MOE))
def test_moe_matches_jax(name):
    jcfg, dropless, ties = MOE[name]
    tcfg = moe.MoEConfig(**{f: getattr(jcfg, f)
                            for f in jcfg.__dataclass_fields__})
    jp = j_moe.init(jax.random.PRNGKey(9), jcfg)
    if ties:  # every router probability equal: top-k must pick 0..K-1
        jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    x = _randn(np.random.default_rng(10), 2, 12, 32)
    tp = _tree(jp)
    jy, jaux = j_moe.fwd(jp, jcfg, x, dropless=dropless)
    ty, taux = moe.fwd(tp, tcfg, _t(x), dropless=dropless)
    _close(ty, jy)
    _close(taux["aux_loss"], jaux["aux_loss"])

    je, jdst, jkeep, jw, jC = _jax_routing(jp, jcfg, x, dropless)
    te, tpr, _, tC = moe.route(tp, tcfg, _t(x), dropless)
    _, tdst, tkeep, _, tw = moe.dispatch(_t(x), te, tpr, tcfg.n_experts, tC)
    assert tC == jC
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
    _close(tw, jw)
    if ties:
        assert (te == torch.arange(3)).all()
    if name == "drops":
        assert not tkeep.all(), "capacity dropped no token"
    if dropless:
        assert tkeep.all()


def test_moe_aux_loss_and_routing():
    """Twin of ``tests/test_models.py::test_moe_aux_loss_and_routing`` on
    the port alone, from the port's own init."""
    cfg = moe.MoEConfig(d_model=32, d_ff=64, n_experts=4, top_k=2,
                        capacity_factor=2.0)
    gen = torch.Generator().manual_seed(0)
    params = moe.init(gen, cfg)
    x = torch.randn((2, 16, 32), generator=gen)
    y, aux = moe.fwd(params, cfg, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(aux["aux_loss"]) >= 1.0 - 1e-3  # >= 1 by Cauchy-Schwarz


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

SSM_CFG = dict(d_model=32, d_state=8, headdim=8, expand=2, n_groups=2,
               chunk=8)


def _ssm_params():
    jcfg = j_ssm.SSMConfig(**SSM_CFG)
    jp = j_ssm.init(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(11)  # nonzero A_log, dt_bias, conv_b
    jp = {**jp, "A_log": jnp.asarray(_randn(rng, jcfg.n_heads, scale=0.5)),
          "dt_bias": jnp.asarray(_randn(rng, jcfg.n_heads, scale=0.5)),
          "conv_b": jnp.asarray(_randn(rng, jcfg.conv_dim, scale=0.1))}
    return jcfg, ssm.SSMConfig(**SSM_CFG), jp, _tree(jp)


@pytest.mark.parametrize("L", [32, 30])
def test_ssm_matches_jax(L):
    """fwd_train from no state and from a carried state (30: the chunk
    falls back to 6, the largest divisor of 30 below 8), then decode."""
    jcfg, tcfg, jp, tp = _ssm_params()
    x = _randn(np.random.default_rng(L), 2, L + 4, 32, scale=0.5)
    jy, js = j_ssm.fwd_train(jp, jcfg, x[:, :L // 2])
    ty, ts = ssm.fwd_train(tp, tcfg, _t(x[:, :L // 2]))
    _close(ty, jy)
    jy, js = j_ssm.fwd_train(jp, jcfg, x[:, L // 2:L], js)
    ty, ts = ssm.fwd_train(tp, tcfg, _t(x[:, L // 2:L]), ts)
    _close(ty, jy)
    for t in range(L, L + 4):
        for a, b in zip(ts, js):
            _close(a, b)
        jy, js = j_ssm.fwd_decode(jp, jcfg, x[:, t:t + 1], js)
        ty, ts = ssm.fwd_decode(tp, tcfg, _t(x[:, t:t + 1]), ts)
        _close(ty, jy)
    assert ts.pos.dtype == torch.int32 and ts.pos.tolist() == [L + 4] * 2


def test_ssm_chunked_equals_stepwise():
    """Twin of ``tests/test_models.py::test_ssm_chunked_equals_stepwise``
    on the port alone (its tolerances), from the port's own init."""
    cfg = ssm.SSMConfig(d_model=32, d_state=8, headdim=8, expand=2,
                        n_groups=1, chunk=8)
    gen = torch.Generator().manual_seed(0)
    params = ssm.init(gen, cfg)
    B, L = 2, 32
    x = torch.randn((B, L, 32), generator=gen) * 0.5
    y_chunk, final = ssm.fwd_train(params, cfg, x)
    st = ssm.init_state(cfg, B)
    ys = []
    for t in range(L):
        y_t, st = ssm.fwd_decode(params, cfg, x[:, t:t + 1], st)
        ys.append(y_t)
    y_step = torch.cat(ys, dim=1)
    np.testing.assert_allclose(_n(y_chunk), _n(y_step), atol=2e-3, rtol=2e-2)
    np.testing.assert_allclose(_n(final.ssm), _n(st.ssm), atol=2e-3,
                               rtol=2e-2)
