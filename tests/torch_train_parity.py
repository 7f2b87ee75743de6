"""Shared by ``test_torch_train_step_lm.py`` and
``test_torch_train_step_rest.py``: the port's train, prefill and decode
steps (``repro_torch.training.steps``) against the JAX package's, for the
ten archs' smoke configs in float32, from the same parameters and batches.

Each arch's JAX side runs once per module (``jax_side``, under a
one-device ``("data", "model")`` mesh as ``tests/test_models.py`` runs
it): ``jax.grad`` of ``model.loss`` jitted once at the microbatch shape,
the train step with ``accum_steps`` 1 and 2 (``warmup=0``: the schedule
gives 0 at step 0 of a warm-up, and a step that moves nothing checks
nothing), a prefill and three greedy decode steps.

Tolerances, against JAX:

* loss and nll rtol 1e-5; gnorm rtol 1e-4; lr rtol 1e-6; ``opt.step``
  exactly 1;
* the float32 grads, leaf by leaf against ``jax.grad`` (with A = 2 the
  mean of the two microbatches' grads, accumulated as JAX's scan does):
  rtol 1e-4, atol 1e-6, or 1e-4 of the leaf's largest |g| where that is
  larger.  The leaf-relative term is zamba2's: its grads are ill
  conditioned in float32 (sums of large terms of both signs through the
  SSD's decays), and JAX's own jitted and eager grads of zamba2-smoke
  differ by up to 3.9e-5 of a leaf's largest |g|, the port's from JAX's
  jitted ones by up to 3.1e-5;
* ``m`` and ``v`` after the step: rtol 1e-4, atol 1e-4 of the leaf's
  largest value plus 1e-9;
* the parameters after the step: rtol 1e-5, atol 1e-6 (the LR is 1e-3),
  only where JAX's |g| exceeds ten times the grads' atol of its leaf.
  AdamW's first update is m̂ / (√v̂ + ε), about ±1 wherever |g| ≫ ε, so
  a coordinate whose grad lies within the cross-framework noise may flip
  sign and move by 2 lr.  The other coordinates are counted (mostly
  embedding rows of tokens the batch does not hold, whose grad is 0) and
  at least half of each arch's parameters are compared;
* the tokens of the prefill and decode steps: equal.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

import repro.configs as j_cfgs
import repro_torch.configs as cfgs
from repro.models import EncDecConfig as JEncDecConfig
from repro.models import build as j_build
from repro.optim import adamw_init as j_adamw_init
from repro.training.steps import TrainHParams as JTrainHParams
from repro.training.steps import build_for_cell as j_build_for_cell
from repro_torch import convert, tree
from repro_torch.models import EncDecConfig, build
from repro_torch.optim import adamw_init
from repro_torch.training import TrainHParams, build_for_cell, loss_and_grads

B, L = 2, 32  # rows of a microbatch, tokens a row
LR = 1e-3
PROMPT, DECODE = 12, 3
AXES = ("data", "model")
LOSS_RTOL, GNORM_RTOL, LR_RTOL = 1e-5, 1e-4, 1e-6
GRAD_RTOL, GRAD_ATOL, GRAD_LEAF_ATOL = 1e-4, 1e-6, 1e-4
MOM_RTOL, MOM_LEAF_ATOL, MOM_ATOL = 1e-4, 1e-4, 1e-9
PARAM_RTOL, PARAM_ATOL, NOISE_FACTOR = 1e-5, 1e-6, 10.0


def _mesh():
    return jax.make_mesh((1, 1), AXES,
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _batch(cfg, rng, rows):
    out = {"tokens": rng.integers(0, cfg.vocab, (rows, L)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (rows, L)).astype(np.int32)}
    if isinstance(cfg, JEncDecConfig):
        out["frames"] = rng.standard_normal(
            (rows, cfg.enc_len, cfg.d_model)).astype(np.float32)
    return out


def _rows(batch, n):
    return {k: v[:n] for k, v in batch.items()}


def _hp(accum):
    return dict(lr=LR, warmup=0, accum_steps=accum)


@functools.lru_cache(maxsize=None)
def jax_inputs(arch):
    """JAX's parameters and batch of ``arch`` as :func:`jax_side` makes
    them (without its steps, so that ranks can start first): (params,
    batch)."""
    cfg = j_cfgs.get_smoke(arch)
    batch = _batch(cfg, np.random.default_rng(len(arch)), 2 * B)
    with _mesh():
        params = _np_tree(j_build(cfg).init(jax.random.PRNGKey(0)))
    return params, batch


@functools.lru_cache(maxsize=None)
def jax_side(arch):
    cfg = j_cfgs.get_smoke(arch)
    model = j_build(cfg)
    rng = np.random.default_rng(len(arch))
    batch = _batch(cfg, rng, 2 * B)
    is_encdec = isinstance(cfg, JEncDecConfig)
    out = {"batch": batch, "train": {}}
    with _mesh() as mesh:
        params = _np_tree(model.init(jax.random.PRNGKey(0)))
        out["params"] = params

        def loss(p, b):
            if is_encdec:
                return model.loss(p, b["frames"], b["tokens"],
                                  b["labels"])[0]
            return model.loss(p, b["tokens"], b["labels"])[0]

        grad_fn = jax.jit(jax.grad(loss))
        micro = [_np_tree(grad_fn(params, {k: v[i * B:(i + 1) * B]
                                           for k, v in batch.items()}))
                 for i in range(2)]
        out["grads"] = {1: micro[0], 2: jax.tree.map(
            lambda a, b: (np.float32(0) + a / np.float32(2))
            + b / np.float32(2), *micro)}
        for accum in (1, 2):
            cell = j_cfgs.ShapeCell("t", "train", L, accum * B)
            step = j_build_for_cell(model, mesh, cell,
                                    JTrainHParams(**_hp(accum)))[0]
            p = jax.tree.map(jnp.asarray, params)  # donated
            p2, o2, metrics = step(p, j_adamw_init(p), _rows(batch,
                                                             accum * B))
            out["train"][accum] = dict(
                params=_np_tree(p2), m=_np_tree(o2.m), v=_np_tree(o2.v),
                step=int(o2.step),
                metrics={k: float(v) for k, v in metrics.items()})
        prefill = j_build_for_cell(model, mesh, j_cfgs.ShapeCell(
            "p", "prefill", PROMPT, B))[0]
        decode = j_build_for_cell(model, mesh, j_cfgs.ShapeCell(
            "d", "decode", PROMPT + DECODE, B))[0]
        toks = batch["tokens"][:B, :PROMPT]
        if is_encdec:
            enc = model.encode(params, batch["frames"][:B])
            cache = model.init_cache(params, enc, B, PROMPT + DECODE)
        else:
            cache = model.init_cache(B, PROMPT + DECODE)
        tok, cache = prefill(params, toks, cache)
        served = [np.asarray(tok)]
        for _ in range(DECODE):
            tok, cache = decode(params, tok, cache)
            served.append(np.asarray(tok))
        out["served"] = np.stack(served, 1)
    return out


def _port(arch):
    cfg = cfgs.get_smoke(arch)
    model = build(cfg, "cpu")
    params = convert.model_params_from_jax_numpy(cfg, jax_side(arch)["params"],
                                                 "cpu")
    return cfg, model, params


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _n(x):
    return x.detach().float().numpy()


def _leafwise(got, want, what, rtol, leaf_atol, atol):
    names, g = tree.leaves_with_names(got)
    w = tree.leaves(want)
    assert len(g) == len(w)
    for name, a, b in zip(names, g, w):
        b = np.asarray(b, np.float32)
        tol = max(atol, leaf_atol * float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(_n(a), b, rtol=rtol, atol=tol,
                                   err_msg=f"{what}{name}")


def check_train_step(arch, accum):
    want = jax_side(arch)
    cfg, model, params = _port(arch)
    batch = _t(_rows(want["batch"], accum * B))
    grads = loss_and_grads(model, params, batch, accum)[2]
    g_want = want["grads"][accum]
    _leafwise(grads, g_want, "grad ", GRAD_RTOL, GRAD_LEAF_ATOL, GRAD_ATOL)

    cell = cfgs.ShapeCell("t", "train", L, accum * B)
    step = build_for_cell(model, AXES, cell, TrainHParams(**_hp(accum)))[0]
    opt = adamw_init(params)
    params2, opt2, metrics = step(params, opt, batch)
    w = want["train"][accum]
    for key, rtol in (("loss", LOSS_RTOL), ("nll", LOSS_RTOL),
                      ("gnorm", GNORM_RTOL), ("lr", LR_RTOL)):
        assert metrics[key].shape == () and metrics[key].dtype == torch.float32
        np.testing.assert_allclose(float(metrics[key]), w["metrics"][key],
                                   rtol=rtol, err_msg=key)
    assert int(opt2.step) == w["step"] == 1
    assert opt2.step.dtype == torch.int32
    _leafwise(opt2.m, w["m"], "m ", MOM_RTOL, MOM_LEAF_ATOL, MOM_ATOL)
    _leafwise(opt2.v, w["v"], "v ", MOM_RTOL, MOM_LEAF_ATOL, MOM_ATOL)

    names, got = tree.leaves_with_names(params2)
    kept = total = 0
    for name, p, p_want, g in zip(names, got, tree.leaves(w["params"]),
                                  tree.leaves(g_want)):
        g = np.abs(np.asarray(g, np.float32))
        noise = max(GRAD_ATOL, GRAD_LEAF_ATOL * float(g.max(initial=0.0)))
        sure = g > NOISE_FACTOR * noise
        np.testing.assert_allclose(_n(p)[sure], np.asarray(p_want)[sure],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"params {name}")
        kept += int(sure.sum())
        total += g.size
    print(f"{arch} accum {accum}: parameters compared at {kept} of {total} "
          f"coordinates; {total - kept} within the grads' noise")
    assert kept >= total // 2


def _spec_items(node, path):
    """(name, spec) of a port spec tree: dicts and NamedTuples are inner
    nodes, a plain tuple is a spec, None is empty."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [it for k in sorted(node)
                for it in _spec_items(node[k], f"{path}[{k!r}]")]
    if hasattr(node, "_fields"):
        return [it for f in node._fields
                for it in _spec_items(getattr(node, f), f"{path}.{f}")]
    return [(path, node)]


def _port_specs(specs):
    return [it for i, s in enumerate(specs) for it in _spec_items(s, f"[{i}]")]


def _jax_specs(shardings):
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))[0]
    return [(jax.tree_util.keystr(p), tuple(s.spec)) for p, s in flat]


def _cells():
    return (cfgs.ShapeCell("t", "train", L, B),
            cfgs.ShapeCell("p", "prefill", PROMPT, B),
            cfgs.ShapeCell("l", "prefill", PROMPT, 1),  # long_ctx
            cfgs.ShapeCell("d", "decode", PROMPT + DECODE, B),
            cfgs.ShapeCell("dl", "decode", PROMPT + DECODE, 1))


def _dtype(x):
    return str(x.dtype).removeprefix("torch.")


def check_specs(arch):
    """``in_specs``, ``out_specs`` and ``input_specs()`` of every kind of
    cell equal JAX's (spec tuples, shapes, dtypes, names)."""
    cfg = cfgs.get_smoke(arch)
    model = build(cfg, "cpu")
    j_model = j_build(j_cfgs.get_smoke(arch))
    with _mesh() as mesh:
        for cell in _cells():
            j_cell = j_cfgs.ShapeCell(*dataclasses.astuple(cell))
            _, j_in, j_out, j_inputs = j_build_for_cell(j_model, mesh,
                                                        j_cell)
            _, t_in, t_out, t_inputs = build_for_cell(model, AXES, cell)
            assert _port_specs(t_in) == _jax_specs(j_in), cell.kind
            assert _port_specs(t_out) == _jax_specs(j_out), cell.kind
            names, got = tree.leaves_with_names(t_inputs())
            j_flat = jax.tree_util.tree_flatten_with_path(j_inputs())[0]
            assert names == [jax.tree_util.keystr(p) for p, _ in j_flat]
            for name, t, (_, s) in zip(names, got, j_flat):
                assert t.device.type == "meta", name
                assert (tuple(t.shape), _dtype(t)) == (s.shape, str(s.dtype)), (
                    cell.name, name)


@torch.no_grad()
def check_served_tokens(arch):
    want = jax_side(arch)
    cfg, model, params = _port(arch)
    prefill = build_for_cell(model, AXES, cfgs.ShapeCell(
        "p", "prefill", PROMPT, B))[0]
    decode = build_for_cell(model, AXES, cfgs.ShapeCell(
        "d", "decode", PROMPT + DECODE, B))[0]
    batch = _t(want["batch"])
    if isinstance(cfg, EncDecConfig):
        enc = model.encode(params, batch["frames"][:B])
        cache = model.init_cache(params, enc, B, PROMPT + DECODE)
    else:
        cache = model.init_cache(B, PROMPT + DECODE)
    tok, cache = prefill(params, batch["tokens"][:B, :PROMPT], cache)
    served = [tok]
    for _ in range(DECODE):
        tok, cache = decode(params, tok, cache)
        served.append(tok)
    got = torch.stack(served, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want["served"])
