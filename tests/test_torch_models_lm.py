"""The port's decoder-only LMs (``repro_torch.models.LM``) against the JAX
package's, for the nine LM archs' smoke configs (float32), from JAX's
parameters carried across by ``convert.model_params_from_jax_numpy``.

Each arch's JAX side runs once per module (``_jax_side``): logits, loss,
a 40-token prefill (past mixtral-smoke's 32-slot window, so its ring
cache is rolled) and three decode steps.  The port must give the same
logits, loss and aux loss, the same caches after prefill, and, started
from JAX's prefilled cache (``convert.lm_cache_from_jax_numpy``), the
same decode logits and caches; cache lengths and SSM positions exactly.
Tolerance: ``allclose(atol=1e-4, rtol=1e-4)`` (the largest difference
measured is 6.4e-5, zamba2's logits; below 1e-5 for the other archs).

The twins of ``tests/test_models.py``'s forward and teacher-forcing tests
run on the port alone, from the port's own init.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as j_cfgs
import repro_torch.configs as cfgs
from repro.models import build as j_build
from repro_torch import convert
from repro_torch.models import EncDecConfig, build

LM_ARCHS = [a for a in cfgs.ARCH_IDS if a != "whisper-large-v3"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, PROMPT, MAX_LEN, DECODE = 2, 40, 48, 3


def _n(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _fields(cache):
    """(name, array) of every tensor of an LMCache."""
    for part in ("kv", "ssm"):
        sub = getattr(cache, part)
        if sub is not None:
            for name, val in zip(sub._fields, sub):
                yield f"{part}.{name}", val


def _same_cache(got, want):
    want = dict(_fields(want))
    got = dict(_fields(got))
    assert sorted(got) == sorted(want)
    for name, val in want.items():
        if name in ("kv.length", "ssm.pos"):
            assert got[name].dtype == torch.int32, name
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(val),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(_n(got[name]), _n(val), **TOL,
                                       err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    cfg = j_cfgs.get_smoke(arch)
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, cfg.vocab, (B, PROMPT + DECODE)).astype(np.int32)
    logits, aux = model.logits_train(params, toks)
    loss, parts = model.loss(params, toks, np.roll(toks, -1, axis=1))
    logits_pf, cache = model.prefill(params, toks[:, :PROMPT],
                                     model.init_cache(B, MAX_LEN))
    caches, steps = [_np_tree(cache)], []
    decode = jax.jit(model.decode_step)  # one compile for the steps
    for t in range(PROMPT, PROMPT + DECODE):
        lg, cache = decode(params, toks[:, t], cache)
        steps.append(np.asarray(lg))
        caches.append(_np_tree(cache))
    return dict(params=_np_tree(params), toks=toks, logits=np.asarray(logits),
                aux=float(aux), loss=float(loss), nll=float(parts["nll"]),
                prefill=np.asarray(logits_pf), caches=caches, steps=steps)


def _port(arch):
    cfg = cfgs.get_smoke(arch)
    model = build(cfg, "cpu")
    params = convert.model_params_from_jax_numpy(cfg, _jax_side(arch)["params"],
                                                 "cpu")
    return model, params


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logits_and_loss_match_jax(arch):
    want = _jax_side(arch)
    model, params = _port(arch)
    toks = torch.from_numpy(want["toks"])
    logits, aux = model.logits_train(params, toks)
    np.testing.assert_allclose(_n(logits), want["logits"], **TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **TOL)
    loss, parts = model.loss(params, toks, torch.roll(toks, -1, dims=1))
    np.testing.assert_allclose(float(loss), want["loss"], **TOL)
    np.testing.assert_allclose(float(parts["nll"]), want["nll"], **TOL)
    if cfgs.get_smoke(arch).block == "moe":
        assert float(aux) >= 1.0 - 1e-3


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_matches_jax(arch):
    want = _jax_side(arch)
    model, params = _port(arch)
    logits, cache = model.prefill(
        params, torch.from_numpy(want["toks"][:, :PROMPT]),
        model.init_cache(B, MAX_LEN))
    np.testing.assert_allclose(_n(logits), want["prefill"], **TOL)
    _same_cache(cache, want["caches"][0])


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_from_jax_cache_matches_jax(arch):
    want = _jax_side(arch)
    model, params = _port(arch)
    cache = convert.lm_cache_from_jax_numpy(want["caches"][0], "cpu")
    toks = torch.from_numpy(want["toks"])
    for i, t in enumerate(range(PROMPT, PROMPT + DECODE)):
        logits, cache = model.decode_step(params, toks[:, t], cache)
        np.testing.assert_allclose(_n(logits), want["steps"][i], **TOL)
        _same_cache(cache, want["caches"][i + 1])


@pytest.mark.parametrize("arch", cfgs.ARCH_IDS)
def test_arch_smoke_forward_and_shapes(arch):
    """Twin of ``tests/test_models.py::test_arch_smoke_forward_and_shapes``
    on the port alone, from its own init."""
    cfg = cfgs.get_smoke(arch)
    model = build(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    L = 32
    toks = torch.randint(0, cfg.vocab, (B, L), generator=gen)
    if isinstance(cfg, EncDecConfig):
        frames = torch.randn((B, cfg.enc_len, cfg.d_model), generator=gen)
        loss, aux = model.loss(params, frames, toks, toks)
    else:
        logits, _ = model.logits_train(params, toks)
        assert logits.shape == (B, L, cfg.vocab)
        assert bool(torch.isfinite(logits.float()).all())
        loss, aux = model.loss(params, toks, toks)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss))
    # rough sanity: loss close to uniform log(vocab) at init
    assert abs(float(loss) - np.log(cfg.vocab)) < 2.5


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b", "mamba2-370m",
                                  "zamba2-2.7b"])
def test_decode_matches_teacher_forcing(arch):
    """Twin of ``tests/test_models.py::test_decode_matches_teacher_forcing``
    on the port alone (its tolerances), from the port's own init."""
    cfg = cfgs.get_smoke(arch)
    model = build(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    L = 16
    toks = torch.randint(0, cfg.vocab, (B, L + 1), generator=gen)
    logits_tf, _ = model.logits_train(params, toks)
    cache = model.init_cache(B, 64)
    logits_pf, cache = model.prefill(params, toks[:, :L], cache)
    np.testing.assert_allclose(_n(logits_pf), _n(logits_tf[:, L - 1]),
                               atol=2e-2, rtol=2e-2)
    logits_dec, _ = model.decode_step(params, toks[:, L], cache)
    np.testing.assert_allclose(_n(logits_dec), _n(logits_tf[:, L]),
                               atol=2e-2, rtol=2e-2)
