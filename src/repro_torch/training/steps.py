"""Train / prefill / decode steps with their sharding spec trees.

Port of ``repro/training/steps.py``.  ``build_*`` returns ``(fn, in_specs,
out_specs, input_specs)`` for a given (model, shape cell, mesh), as JAX's
returns ``(jitted, in_shardings, out_shardings, input_specs)``:

* ``fn`` is a plain function (no ``jit``, no ``torch.compile``);
* the spec trees hold :func:`~repro_torch.models.common.pspec` tuples,
  entry for entry JAX's ``tuple(sharding.spec)`` (batch dims on
  ``("pod", "data")``, heads / ffn / vocab on ``"model"``, parameters
  also on the data axes with ``fsdp``; a cache's KV heads on ``"model"``
  where the axis divides them, by the mesh's sizes);
* ``input_specs()`` gives ``meta`` tensors of JAX's global shapes and
  dtypes.

``mesh`` is None, a sequence of axis names, or a ``DeviceMesh``.  Without
a mesh of more than one device the step runs the model on one device, on
plain tensors.  On a ``DeviceMesh`` of more than one device over the
default group it runs on every rank of the mesh
(:mod:`repro_torch.distributed.spmd`), as JAX's jit does with the
shardings:

* each input is a DTensor at its ``in_specs`` placement
  (:func:`~repro_torch.distributed.sharding.device_put`,
  ``shardings_like``) or a whole tensor on every rank, which the step
  places itself (onto the model's device); the outputs are DTensors at
  ``out_specs``, the metrics plain 0-d tensors with the same value on
  every rank;
* each rank computes its own rows of the batch, and where ``"model"``
  has more than one rank, its part of the heads, the ffn and the vocab of
  the dense layers (:func:`~repro_torch.models.common.tensor_parallel`);
  a parameter is gathered from its shards where the model uses it (a
  tensor-parallel weight over the data axes only), and its grad reduced
  over the data axes back onto its shard, and averaged over the other
  axes that hold the same shard (so that its replicas stay the same bits:
  the CUDA backward's atomics would part them);
* with ``accum_steps`` A > 1, microbatch ``i`` is the global rows ``[i B/A,
  (i+1) B/A)``, as JAX reshapes the global batch, each rank computing its
  part of it (so the MoE load-balancing statistics, which are global
  means, see the same rows as JAX's);
* the global grad norm is the whole tree's, and AdamW updates the local
  shards of the parameters and moments in place (JAX donates them).

Such a step carries its :class:`~repro_torch.distributed.spmd.MeshPlan` as
``fn.plan`` (``fn.plan.staged``: the bytes it copied to the host, by
purpose).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .. import tree as tree_lib
from ..configs import ShapeCell
from ..distributed import sharding, spmd
from ..models import EncDec, common
from ..models.common import DATA
from ..optim import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                     clip_by_global_norm, cosine_schedule)
from ..optim.adamw import clip_to_norm

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
    return () if mesh is None else mesh


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


def _accumulate(model, tree, flat, micros):
    """``(loss, aux, grads of flat)`` of ``model.loss`` over the
    microbatches ``micros``, as JAX's train step takes them: one
    microbatch gives its own (the grads in the leaves' dtypes); A > 1 give
    the grads accumulated in float32 as the sum of each one's / A, the
    mean loss and ``aux = {"nll": loss, "aux": 0}`` (JAX's scan).
    ``requires_grad`` is on for ``flat`` only while the grads are
    taken."""
    for p in flat:
        p.requires_grad_(True)
    try:
        A = len(micros)
        if A == 1:
            return _grads(model, tree, flat, micros[0])
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in flat]
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        for micro in micros:
            lo, _, g = _grads(model, tree, flat, micro)
            for acc, gi in zip(grads, g):
                acc.add_(gi.float() / A)
            del g
            loss = loss + lo / A
        return loss, {"nll": loss, "aux": torch.zeros_like(loss)}, grads
    finally:
        for p in flat:
            p.requires_grad_(False)


def loss_and_grads(model, params, batch, accum_steps: int = 1):
    """``(loss, aux, grads)`` of ``model.loss`` on ``batch``, as JAX's train
    step takes them: with ``accum_steps`` A > 1 the batch is cut into A
    microbatches of its leading rows (:func:`_accumulate`).  ``grads`` is
    a tree of ``params``' structure (nested dicts); with A = 1 each leaf
    is in its parameter's dtype."""
    A = accum_steps
    micros = [batch] if A <= 1 else [
        {k: v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
         for k, v in batch.items()} for i in range(A)]
    loss, aux, grads = _accumulate(model, params, tree_lib.leaves(params),
                                   micros)
    return loss, aux, tree_lib.unflatten_like(common.as_tree(params), grads)


def _microbatches(plan, batch, batch_spec, A: int, device):
    """This rank's part of each of the ``A`` global microbatches: a list
    of dicts of its rows (every dim but the rows whole)."""
    keep = plan.data_axes
    if A <= 1:
        return [{k: plan.view(v, batch_spec[k], keep, device)
                 for k, v in batch.items()}]
    whole = {k: plan.view(v, batch_spec[k], (), device)
             for k, v in batch.items()}
    micro = []
    for i in range(A):
        part = {}
        for k, v in whole.items():
            rows = v.reshape(A, v.shape[0] // A, *v.shape[1:])[i]
            part[k] = plan.view(rows, batch_spec[k], keep, device)
        micro.append(part)
    return micro


def _mesh_loss_and_grads(model, plan, params, specs, batch, batch_spec,
                         A: int):
    """:func:`loss_and_grads` on this rank's rows, the grads those of its
    parameter shards (the DTensor tree ``params`` at ``specs``, one a
    leaf), averaged over the data axes; the loss and nll are the global
    batch's."""
    names, leaves = tree_lib.leaves_with_names(params)
    flat = [spmd.local(p) for p in leaves]
    tree = tree_lib.unflatten_like(params, [
        plan.leaf(p, s, n) for p, s, n in zip(leaves, specs, names)])
    micros = _microbatches(plan, batch, batch_spec, A, model.device)
    with common.data_parallel(plan.data_mean), \
            common.tensor_parallel(plan.tp):
        loss, aux, grads = _accumulate(model, tree, flat, micros)
    return plan.data_mean(loss), plan.data_mean(aux["nll"]), grads


def _mesh_train_step(model, plan, hp: TrainHParams, pspecs, batch_spec):
    """The train step on this rank of ``plan``'s mesh (module
    docstring)."""
    dev = model.device

    def train_step(params, opt, batch):
        """``(params', opt', metrics)`` on this rank: ``params'`` and the
        moments are DTensors at ``pspecs`` whose local shards were updated
        in place; ``metrics`` the global batch's, on every rank."""
        params = sharding.put_tree(params, pspecs, plan.mesh, dev)
        m = sharding.put_tree(opt.m, pspecs, plan.mesh, dev)
        v = sharding.put_tree(opt.v, pspecs, plan.mesh, dev)
        step = sharding.put_tree(opt.step, (), plan.mesh, dev)
        specs = tree_lib.prefix_leaves(params, pspecs)
        loss, nll, grads = _mesh_loss_and_grads(
            model, plan, params, specs, batch, batch_spec, hp.accum_steps)
        gnorm = torch.sqrt(plan.global_sq_norm(grads, specs))
        local = functools.partial(tree_lib.map, spmd.local)
        grads = clip_to_norm(tree_lib.unflatten_like(params, grads), gnorm,
                             hp.adamw.clip_norm)
        step0 = spmd.local(step)
        lr = cosine_schedule(step0, hp.lr, hp.warmup, hp.total_steps)
        _, opt2 = adamw_update(local(params), grads,
                               AdamWState(m=local(m), v=local(v),
                                          step=step0), lr, hp.adamw)
        metrics = {"loss": loss, "nll": nll, "gnorm": gnorm, "lr": lr}
        return params, AdamWState(m=m, v=v, step=plan.place(
            opt2.step, (), ())), metrics

    train_step.plan = plan
    return train_step


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

    if spmd.is_multi_device(mesh):
        train_step = _mesh_train_step(model, spmd.MeshPlan(mesh), hp,
                                      pspecs, batch_spec)

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


def _model_split(cache) -> list[bool]:
    """Per leaf of ``cache``, whether the serving step keeps it at its
    ``"model"`` split: the leaves of the fields, or ``"field.sub-field"``s
    of a field that is itself a NamedTuple, that its type names in
    ``MODEL_SPLIT`` (the attention caches, the SSM state's heads)."""
    split = type(cache).MODEL_SPLIT
    unknown = {s for s in split if s.split(".")[0] not in cache._fields}
    if unknown:
        raise ValueError(f"{type(cache).__name__} has no field {unknown}")
    out = []
    for f in cache._fields:
        node = getattr(cache, f)
        if f in split or not hasattr(node, "_fields"):
            out += [f in split] * len(tree_lib.leaves(node))
        else:
            out += [f"{f}.{g}" in split for g in node._fields
                    for _ in tree_lib.leaves(getattr(node, g))]
    return out


def _mesh_serve_step(model, plan, method, in_specs, out_specs,
                     long_ctx: bool):
    """A prefill or decode step (``method``: ``model.prefill`` /
    ``model.decode_step``) on this rank of ``plan``'s mesh: its rows of
    the batch (none split with ``long_ctx``: every rank computes the one
    row) and, where ``"model"`` computes, its part of the dense layers;
    the KV caches kept at their ``"model"`` split and, with ``long_ctx``,
    at their sequence split over the data axes (the attention on this
    rank's slice of the sequence: :func:`~.common.seq_parallel`), every
    other cache leaf gathered whole but for the rows; the outputs placed
    at ``out_specs``.  Where the data axes do not divide a ``long_ctx``
    cache's length its KV sequence is gathered whole, as it was before
    the sequence split (and placing the output raises, as JAX's
    placement does)."""
    pspecs, tok_spec, cache_specs = in_specs
    next_spec = out_specs[0]
    keep = () if long_ctx else plan.data_axes
    model_keep = (spmd.TP_AXIS,) if plan.tp is not None else ()
    dev = model.device

    @torch.no_grad()
    def serve_step(params, tokens, cache):
        """``(next tokens (B,) int32, cache')`` as DTensors at
        ``out_specs``."""
        params = sharding.put_tree(params, pspecs, plan.mesh, dev)
        names, leaves = tree_lib.leaves_with_names(params)
        tree = tree_lib.unflatten_like(params, [
            plan.leaf(p, s, n) for p, s, n in zip(
                leaves, tree_lib.prefix_leaves(params, pspecs), names)])
        leaves = tree_lib.leaves(cache)
        specs = tree_lib.prefix_leaves(cache, cache_specs)
        split = _model_split(cache)
        sp = None
        if long_ctx:  # the KV sequence split over the data axes
            sp = next((plan.seq_slice(s, c.shape) for c, s, m in zip(
                leaves, specs, split) if m and c.ndim > 2), None)
        kv_keep = keep + model_keep + (plan.data_axes if sp else ())
        keeps = [kv_keep if m else keep for m in split]
        view = tree_lib.unflatten_like(cache, [
            plan.view(c, s, k, dev, "kv" if m else "gather")
            for c, s, k, m in zip(leaves, specs, keeps, split)])
        with common.tensor_parallel(plan.tp), common.seq_parallel(sp):
            logits, cache2 = method(
                tree, plan.view(tokens, tok_spec, keep, dev), view)
            nxt = (_argmax(logits) if plan.tp is None
                   else plan.vocab_argmax(logits))
        out = tree_lib.unflatten_like(cache2, [
            plan.place(c, s, k) for c, s, k in zip(
                tree_lib.leaves(cache2), specs, keeps)])
        return plan.place(nxt, next_spec, keep), out

    serve_step.plan = plan
    return serve_step


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
    if spmd.is_multi_device(mesh):
        prefill_step = _mesh_serve_step(model, spmd.MeshPlan(mesh),
                                        model.prefill, in_specs, out_specs,
                                        long_ctx)

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
    if spmd.is_multi_device(mesh):
        decode_step = _mesh_serve_step(model, spmd.MeshPlan(mesh),
                                       model.decode_step, in_specs,
                                       out_specs, long_ctx)

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
