"""Train / prefill / decode steps with their sharding spec trees.

Port of ``repro/training/steps.py``.  ``build_*`` returns ``(fn, in_specs,
out_specs, input_specs)`` for a given (model, shape cell, mesh axes), as
JAX's returns ``(jitted, in_shardings, out_shardings, input_specs)``:

* ``fn`` is a plain function (no ``jit``, no ``torch.compile``);
* the spec trees hold :func:`~repro_torch.models.common.pspec` tuples,
  entry for entry JAX's ``tuple(sharding.spec)`` (batch dims on
  ``("pod", "data")``, heads / ffn / vocab on ``"model"``, parameters
  also on the data axes with ``fsdp``);
* ``input_specs()`` gives ``meta`` tensors of JAX's shapes and dtypes.

The models run on one device: ``mesh`` is None, a sequence of axis names
or a one-device ``DeviceMesh``, and only names the axes of the specs.
Running a step across a larger mesh waits for ROADMAP A.10c part 2.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import tree as tree_lib
from ..configs import ShapeCell
from ..models import EncDec, common
from ..models.common import DATA
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm, cosine_schedule)

__all__ = ["TrainHParams", "build_train_step", "build_prefill_step",
           "build_decode_step", "build_for_cell", "loss_and_grads"]


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10_000
    adamw: AdamWConfig = AdamWConfig()
    aux_weight: float = 0.01
    # Gradient accumulation: microbatch count per step (activation memory
    # scales with the live microbatch; grads accumulate in float32).
    accum_steps: int = 1


def _axes(mesh):
    """What :func:`common.axis_env` takes for ``mesh``."""
    if mesh is None:
        return ()
    size = getattr(mesh, "size", None)
    if callable(size) and size() > 1:
        raise NotImplementedError(
            "a train / serve step across a DeviceMesh of more than one "
            "device waits for ROADMAP A.10c part 2")
    return mesh


def _meta(model):
    """The same model on the ``meta`` device (shapes and dtypes alone)."""
    return type(model)(model.cfg, "meta")


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def _loss_fn(model, params, micro):
    if isinstance(model, EncDec):
        return model.loss(params, micro["frames"], micro["tokens"],
                          micro["labels"])
    return model.loss(params, micro["tokens"], micro["labels"])


def _grads(model, params, flat, micro):
    loss, aux = _loss_fn(model, params, micro)
    grads = torch.autograd.grad(loss, flat)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def loss_and_grads(model, params, batch, accum_steps: int = 1):
    """``(loss, aux, grads)`` of ``model.loss`` on ``batch``, as JAX's train
    step takes them: with ``accum_steps`` A > 1 the batch is cut into A
    microbatches of its leading rows, the grads are accumulated in
    float32 as the sum of each microbatch's grads / A, the loss is the
    mean and ``aux`` is ``{"nll": loss, "aux": 0}`` (JAX's scan).  ``grads``
    is a tree of ``params``' structure (nested dicts); with A = 1 each
    leaf is in its parameter's dtype.  ``requires_grad`` is on only
    while the grads are taken."""
    flat = tree_lib.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        A = accum_steps
        if A <= 1:
            loss, aux, grads = _grads(model, params, flat, batch)
        else:
            micro_all = {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])
                         for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in flat]
            loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
            for i in range(A):
                micro = {k: v[i] for k, v in micro_all.items()}
                lo, _, g = _grads(model, params, flat, micro)
                for acc, gi in zip(grads, g):
                    acc.add_(gi.float() / A)
                del g
                loss = loss + lo / A
            aux = {"nll": loss, "aux": torch.zeros_like(loss)}
    finally:
        for p in flat:
            p.requires_grad_(False)
    return loss, aux, tree_lib.unflatten_like(common.as_tree(params), grads)


def build_train_step(model, mesh, cell: ShapeCell,
                     hp: TrainHParams = TrainHParams()):
    cfg = model.cfg
    is_encdec = isinstance(model, EncDec)

    with common.axis_env(_axes(mesh)):
        pspecs = model.param_specs()
        batch_spec = {
            "tokens": common.pspec(DATA, None),
            "labels": common.pspec(DATA, None),
        }
        if is_encdec:
            batch_spec["frames"] = common.pspec(DATA, None, None)
    opt_spec_tree = AdamWState(m=pspecs, v=pspecs, step=())

    def train_step(params, opt, batch):
        """``(params', opt', metrics)``: one AdamW step on ``batch`` (a
        dict of ``tokens``, ``labels`` and, for the enc-dec, ``frames``).
        ``params`` and ``opt`` are updated in place (JAX donates them)."""
        loss, aux, grads = loss_and_grads(model, params, batch,
                                          hp.accum_steps)
        gnorm, grads = clip_by_global_norm(grads, hp.adamw.clip_norm)
        lr = cosine_schedule(opt.step, hp.lr, hp.warmup, hp.total_steps)
        params2, opt2 = adamw_update(params, grads, opt, lr, hp.adamw)
        metrics = {"loss": loss, "nll": aux["nll"], "gnorm": gnorm, "lr": lr}
        return params2, opt2, metrics

    in_specs = (pspecs, opt_spec_tree, batch_spec)
    out_specs = (pspecs, opt_spec_tree, None)

    def input_specs():
        B, L = cell.global_batch, cell.seq_len
        params = _meta(model).init()
        opt = adamw_init(params)
        meta = torch.device("meta")
        batch = {
            "tokens": torch.empty((B, L), dtype=torch.int32, device=meta),
            "labels": torch.empty((B, L), dtype=torch.int32, device=meta),
        }
        if is_encdec:
            batch["frames"] = torch.empty((B, cfg.enc_len, cfg.d_model),
                                          dtype=torch.float32, device=meta)
        return params, opt, batch

    return train_step, in_specs, out_specs, input_specs


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def _serve_param_specs(model, mesh):
    # Serving replicates params across the data axes by default (no FSDP
    # all-gather in the token loop); model-axis TP sharding is kept.
    # Archs whose 1/model-axis slice exceeds device memory opt into
    # serve_fsdp (weights sharded over data, gathered per layer).
    fsdp = getattr(model.cfg, "serve_fsdp", False)
    m2 = type(model)(dataclasses.replace(model.cfg, fsdp=fsdp), "meta")
    with common.axis_env(_axes(mesh)):
        return m2.param_specs()


def _serve_cache(model, B, L):
    """``meta`` cache of batch ``B`` and length ``L``, as JAX's
    ``input_specs`` builds it (an enc-dec's from a ``meta`` encoder
    output)."""
    meta = _meta(model)
    cfg = model.cfg
    if isinstance(model, EncDec):
        enc_out = torch.empty((B, cfg.enc_len, cfg.d_model), dtype=cfg.dtype,
                              device="meta")
        return meta.init_cache(meta.init(), enc_out, B, L)
    return meta.init_cache(B, L)


def _argmax(logits):
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_step(model, mesh, cell: ShapeCell):
    long_ctx = cell.global_batch == 1

    pspecs = _serve_param_specs(model, mesh)
    with common.axis_env(_axes(mesh)):
        cache_specs = model.cache_specs(long_ctx)
        tok_spec = common.pspec(None if long_ctx else DATA, None)
        next_spec = common.pspec(None if long_ctx else DATA)

    @torch.no_grad()
    def prefill_step(params, tokens, cache):
        """``(next tokens (B,) int32, cache')`` after ``tokens`` (B, L)."""
        logits, cache2 = model.prefill(params, tokens, cache)
        return _argmax(logits), cache2

    in_specs = (pspecs, tok_spec, cache_specs)
    out_specs = (next_spec, cache_specs)

    def input_specs():
        B, L = cell.global_batch, cell.seq_len
        tokens = torch.empty((B, L), dtype=torch.int32, device="meta")
        return _meta(model).init(), tokens, _serve_cache(model, B, L)

    return prefill_step, in_specs, out_specs, input_specs


def build_decode_step(model, mesh, cell: ShapeCell):
    long_ctx = cell.global_batch == 1

    pspecs = _serve_param_specs(model, mesh)
    with common.axis_env(_axes(mesh)):
        cache_specs = model.cache_specs(long_ctx)
        tok_spec = common.pspec(None if long_ctx else DATA)

    @torch.no_grad()
    def decode_step(params, token, cache):
        """``(next tokens (B,) int32, cache')`` after ``token`` (B,)."""
        logits, cache2 = model.decode_step(params, token, cache)
        return _argmax(logits), cache2

    in_specs = (pspecs, tok_spec, cache_specs)
    out_specs = (tok_spec, cache_specs)

    def input_specs():
        # Decode against a cache already holding S tokens (window-capped
        # for SWA archs by init_cache itself).
        B, S = cell.global_batch, cell.seq_len
        token = torch.empty((B,), dtype=torch.int32, device="meta")
        return _meta(model).init(), token, _serve_cache(model, B, S)

    return decode_step, in_specs, out_specs, input_specs


def build_for_cell(model, mesh, cell: ShapeCell,
                   hp: TrainHParams = TrainHParams()):
    if cell.kind == "train":
        return build_train_step(model, mesh, cell, hp)
    if cell.kind == "prefill":
        return build_prefill_step(model, mesh, cell)
    return build_decode_step(model, mesh, cell)
