"""The port's encoder-decoder (whisper) against the JAX package's, and the
port's configs, parameter trees and sharding specs against JAX's.

Whisper's smoke config (float32) runs once per module on the JAX side
(``_jax_side``): the encoder, the loss over a decoder sequence longer than
``max_dec`` (the position table tiled), the cross K/V cache, a 40-token
prefill and three decode steps.  The port, from JAX's parameters, must
give the same; started from JAX's prefilled cache, the same decode logits
and caches.  Tolerance: ``allclose(atol=1e-4, rtol=1e-4)``.

Every ``full()`` / ``smoke()`` config equals JAX's field by field (dtypes
by name), ``param_count`` / ``active_param_count`` are equal, the port's
``init`` gives JAX's paths, shapes and dtypes (and, drawn from its own
generator, JAX's scales), and every ``param_specs()`` / ``cache_specs()``
equals JAX's as tuples, with no axis environment and under
``axis_env(("data", "model"))`` and ``("pod", "data", "model")``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.configs as j_cfgs
import repro_torch.configs as cfgs
from repro.models import build as j_build
from repro.models import common as j_common
from repro_torch import convert
from repro_torch.models import build, common

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "whisper-large-v3"
B, PROMPT, MAX_LEN, DECODE, LONG = 2, 40, 48, 3, 70


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_side():
    cfg = j_cfgs.get_smoke(ARCH)
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab, (B, LONG)).astype(np.int32)
    enc = model.encode(params, frames)
    loss, parts = model.loss(params, frames, toks, np.roll(toks, -1, 1))
    cache = model.init_cache(params, enc, B, MAX_LEN)
    caches = [_np_tree(cache)]
    logits_pf, cache = model.prefill(params, toks[:, :PROMPT], cache)
    caches.append(_np_tree(cache))
    steps = []
    decode = jax.jit(model.decode_step)  # one compile for the steps
    for t in range(PROMPT, PROMPT + DECODE):
        lg, cache = decode(params, toks[:, t], cache)
        steps.append(np.asarray(lg))
        caches.append(_np_tree(cache))
    return dict(params=_np_tree(params), frames=frames, toks=toks,
                enc=np.asarray(enc), loss=float(loss),
                nll=float(parts["nll"]), prefill=np.asarray(logits_pf),
                caches=caches, steps=steps)


def _port():
    cfg = cfgs.get_smoke(ARCH)
    return build(cfg, "cpu"), convert.model_params_from_jax_numpy(
        cfg, _jax_side()["params"], "cpu")


def _same_cache(got, want):
    for name, g, w in [("kv." + f, g, w) for f, g, w in
                       zip(got.kv._fields, got.kv, want.kv)] + [
            ("cross_k", got.cross_k, want.cross_k),
            ("cross_v", got.cross_v, want.cross_v)]:
        if name == "kv.length":
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(_n(g), _n(w), **TOL, err_msg=name)


def test_whisper_encode_and_loss_match_jax():
    want = _jax_side()
    model, params = _port()
    frames = torch.from_numpy(want["frames"])
    np.testing.assert_allclose(_n(model.encode(params, frames)), want["enc"],
                               **TOL)
    toks = torch.from_numpy(want["toks"])
    loss, parts = model.loss(params, frames, toks, torch.roll(toks, -1, 1))
    np.testing.assert_allclose(float(loss), want["loss"], **TOL)
    np.testing.assert_allclose(float(parts["nll"]), want["nll"], **TOL)
    assert float(parts["aux"]) == 0.0


def test_whisper_prefill_matches_jax():
    want = _jax_side()
    model, params = _port()
    enc = model.encode(params, torch.from_numpy(want["frames"]))
    cache = model.init_cache(params, enc, B, MAX_LEN)
    _same_cache(cache, want["caches"][0])
    logits, cache = model.prefill(
        params, torch.from_numpy(want["toks"][:, :PROMPT]), cache)
    np.testing.assert_allclose(_n(logits), want["prefill"], **TOL)
    _same_cache(cache, want["caches"][1])


def test_whisper_decode_from_jax_cache_matches_jax():
    want = _jax_side()
    model, params = _port()
    cache = convert.encdec_cache_from_jax_numpy(want["caches"][1], "cpu")
    toks = torch.from_numpy(want["toks"])
    for i, t in enumerate(range(PROMPT, PROMPT + DECODE)):
        logits, cache = model.decode_step(params, toks[:, t], cache)
        np.testing.assert_allclose(_n(logits), want["steps"][i], **TOL)
        _same_cache(cache, want["caches"][i + 2])


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _as_dict(cfg):
    """A config's fields, nested configs as dicts, dtypes by name."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = _as_dict(v)
        elif f.name == "dtype":
            v = (str(v).removeprefix("torch.") if isinstance(v, torch.dtype)
                 else jnp.dtype(v).name)
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_configs_match_jax(arch):
    mod, j_mod = cfgs._mod(arch), j_cfgs._mod(arch)
    for maker in ("full", "smoke"):
        got, want = getattr(mod, maker)(), getattr(j_mod, maker)()
        assert type(got).__name__ == type(want).__name__
        assert _as_dict(got) == _as_dict(want), maker
        assert got.param_count() == want.param_count()
        if hasattr(want, "active_param_count"):
            assert got.active_param_count() == want.active_param_count()
    assert _as_dict(cfgs.get(arch)) == _as_dict(j_cfgs.get(arch))
    smoke = cfgs.get_smoke(arch)
    assert _as_dict(smoke) == _as_dict(j_cfgs.get_smoke(arch))
    assert smoke.dtype == torch.float32
    assert cfgs.get(arch).dtype == torch.bfloat16


def test_registry_matches_jax():
    assert cfgs.ARCH_IDS == j_cfgs.ARCH_IDS
    assert [dataclasses.astuple(s) for s in cfgs.SHAPES] == [
        dataclasses.astuple(s) for s in j_cfgs.SHAPES]
    for arch in cfgs.ARCH_IDS:
        for shape in cfgs.SHAPES:
            assert (cfgs.skip_reason(arch, shape.name)
                    == j_cfgs.skip_reason(arch, shape.name))
    with pytest.raises(KeyError):
        cfgs.get("gpt-2")


def _spec_tuples(tree):
    """JAX's spec tree with every PartitionSpec as a plain tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def _cache_specs(specs):
    """A cache spec NamedTuple as nested dicts (None parts dropped)."""
    return {k: (_cache_specs(v) if hasattr(v, "_fields") else v)
            for k, v in specs._asdict().items() if v is not None}


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_specs_match_jax(arch):
    tmodel = build(cfgs.get(arch), "meta")
    jmodel = j_build(j_cfgs.get(arch))
    for env in (None, ("data", "model"), ("pod", "data", "model")):
        with (j_common.axis_env(env or ()), common.axis_env(env or ())):
            assert tmodel.param_specs() == _spec_tuples(
                jmodel.param_specs()), env
            for long_ctx in (False, True):
                got = _cache_specs(tmodel.cache_specs(long_ctx))
                want = _cache_specs(_spec_tuples(jmodel.cache_specs(long_ctx)))
                assert got == want, (env, long_ctx)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_init_matches_jax_tree_and_scales(arch):
    """Full config: the port's parameter tree on ``meta`` has JAX's paths,
    shapes and dtypes.  Smoke config: drawn from the port's generator,
    each weight's standard deviation is within 15 % of JAX's draw."""
    jfull = j_build(j_cfgs.get(arch)).init_abstract()
    want = jax.tree.map(lambda s: (tuple(s.shape), jnp.dtype(s.dtype).name),
                        jfull)
    assert _shapes(build(cfgs.get(arch), "meta").init().tree()) == want

    jp = _np_tree(j_build(j_cfgs.get_smoke(arch)).init(
        jax.random.PRNGKey(0)))
    tp = build(cfgs.get_smoke(arch), "cpu").init(
        torch.Generator().manual_seed(0))
    for path, leaf in tp.named_parameters():
        j = functools.reduce(lambda t, k: t[k], path.split("."), jp)
        assert tuple(leaf.shape) == j.shape, path
        js, ts = float(np.std(j)), float(leaf.float().std())
        if js == 0.0:  # zeros and ones, as JAX's
            np.testing.assert_array_equal(_n(leaf), np.asarray(j, np.float32))
        else:
            assert abs(ts - js) < 0.15 * js, (path, ts, js)


def test_build_runs_on_cuda_unless_told():
    cfg = cfgs.get_smoke("qwen3-14b")
    assert build(cfg, "cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert build(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build(cfg)


def test_convert_rejects_another_tree():
    cfg = cfgs.get_smoke("qwen3-14b")
    tree = _np_tree(j_build(j_cfgs.get_smoke("qwen3-14b")).init(
        jax.random.PRNGKey(0)))
    params = convert.model_params_from_jax_numpy(cfg, tree, "cpu")
    assert params.blocks.attn.wq.shape == tree["blocks"]["attn"]["wq"].shape
    wide = dataclasses.replace(cfg, d_ff=cfg.d_ff * 2)
    with pytest.raises(ValueError, match="blocks.mlp.w[gud]: shape"):
        convert.model_params_from_jax_numpy(wide, tree, "cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.model_params_from_jax_numpy(
            dataclasses.replace(cfg, tie_embed=True), tree, "cpu")
