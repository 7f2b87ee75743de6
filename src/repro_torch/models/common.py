"""Shared model building blocks: norms, RoPE, init, parameter trees and the
sharding helpers.

Port of ``repro/models/common.py``.  Models are plain functions over
parameter trees, as in JAX: nested dicts of tensors whose paths, shapes
and orientation are JAX's (``wq`` is (D, H*dh) and is used as ``x @ w``).
:class:`ParamTree` holds such a tree as an ``nn.Module``, so its
``named_parameters()`` are the JAX paths joined by dots (``blocks.attn.wq``)
and ``state_dict()`` / ``.to()`` / optimizers work on it.

**Sharding helpers.**  JAX expresses sharding as ``PartitionSpec``s over
the mesh axes that :func:`axis_env` installs.  Here:

* :func:`axis_env` records the axis names and sizes of a ``DeviceMesh``
  (``mesh_dim_names``, ``mesh.shape``) or of a bare sequence of names
  (sizes 1), for the current thread, as JAX's does;
* :func:`pspec` returns a plain tuple with the absent axes dropped, entry
  for entry ``tuple(P(...))`` of JAX's (a one-name group collapses to the
  name, as ``PartitionSpec`` normalises it);
* :func:`shard` is the identity: each rank runs the model on its own
  rows.  The training substrate maps these tuples onto ``DeviceMesh``
  placements.

**Across a mesh** (:mod:`repro_torch.distributed.spmd`) a parameter leaf
may be a :class:`ShardedLeaf`, this rank's shard of it: the models call
:func:`gathered` on a block's parameters inside the block body (inside
:func:`remat`, so a checkpointed backward gathers them again) and on a
top-level leaf where they use it; :func:`data_mean` is the mean over the
data-parallel ranks of a quantity that is not a per-row one (the MoE
load-balancing statistics).  Both are the identity outside
:func:`data_parallel`'s block and on plain tensors.

**Tensor parallelism.**  Within :func:`tensor_parallel`'s block (the mesh
steps install it where ``"model"`` has more than one rank) the dense
layers compute their part of the heads, the ffn and the vocab, as
Megatron splits them: :func:`model_part` is a leaf's ``"model"`` shard
(the weight of a column- or row-parallel product), :func:`model_share` a
leaf used whole inside such a layer (its grad is each rank's share),
:func:`head_range` a rank's balanced range of heads and
:func:`model_slice` a leaf's slice for it, :func:`copy_to_model` /
:func:`reduce_from_model` bracket the split computation
(:func:`rms_norm_split` totals the SSD's gated norm's statistic by the
two in turn), :func:`gather_from_model` gathers a split activation that every
rank reads whole (the SSD's B and C), :func:`row_product` is a
row-parallel partial,
:func:`gather_model` moves a serving step's small tensors between splits,
and :func:`vocab_lookup` / :func:`vocab_nll` work on a vocab split over
``"model"`` (the serving steps take its greedy tokens by
:meth:`~repro_torch.distributed.spmd.MeshPlan.vocab_argmax`).  Outside
it :func:`model_size` is 1 and each of them is what one device computes:
the identity, a plain lookup, the whole product.

**Sequence parallelism.**  Within :func:`seq_parallel`'s block (the mesh
serving steps install it at ``long_ctx``, where ``"data"`` splits the KV
sequence as JAX's ``cache_specs(long_ctx=True)`` stores it) the attention
caches hold this rank's slice of the sequence: :func:`seq_split` is the
hook (the slice's offset and length, the whole length, and the max and
sum over the ranks that split the sequence), None outside.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any

import torch
from torch import nn

__all__ = [
    "axis_env",
    "axis_size",
    "shard",
    "pspec",
    "DATA",
    "WIDER",
    "rms_norm",
    "rms_norm_split",
    "layer_norm",
    "rope",
    "apply_rope",
    "normal_init",
    "init_device",
    "ParamTree",
    "as_tree",
    "tree_index",
    "stack_layers",
    "stack_specs",
    "stack",
    "layer",
    "default_generator",
    "remat",
    "ShardedLeaf",
    "gathered",
    "computed_whole",
    "data_mean",
    "data_parallel",
    "tensor_parallel",
    "model_size",
    "model_rank",
    "model_part",
    "model_share",
    "head_range",
    "model_slice",
    "copy_to_model",
    "gather_from_model",
    "reduce_from_model",
    "row_product",
    "gather_model",
    "vocab_lookup",
    "vocab_nll",
    "seq_parallel",
    "seq_split",
    "Params",
]

Params = Any  # nested dict of tensors, or a ParamTree

# Batch-sharding axes: pod (if present) composes with data.
DATA = ("pod", "data")
# Partials summed over "model" one precision up: 16-bit in float32, float32
# in float64 (each is exact in the wider type).
WIDER = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
         torch.float32: torch.float64}

_env = threading.local()


@contextlib.contextmanager
def axis_env(mesh_or_names):
    """Install the available mesh axes (and sizes) for shard()/pspec().

    Accepts a ``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``) or a
    bare sequence of axis names (sizes default to 1).
    """
    prev = getattr(_env, "axes", None)
    prev_sizes = getattr(_env, "sizes", None)
    names = getattr(mesh_or_names, "mesh_dim_names", None)
    if names is not None:
        _env.axes = tuple(names)
        _env.sizes = dict(zip(_env.axes, tuple(mesh_or_names.shape)))
    else:
        _env.axes = tuple(mesh_or_names)
        _env.sizes = {a: 1 for a in _env.axes}
    try:
        yield
    finally:
        _env.axes = prev
        _env.sizes = prev_sizes


def _avail() -> tuple[str, ...]:
    return getattr(_env, "axes", None) or ()


def axis_size(name) -> int:
    """Product of mesh sizes of the given axis name(s); 1 if absent."""
    sizes = getattr(_env, "sizes", None) or {}
    if isinstance(name, str):
        name = (name,)
    out = 1
    for a in name:
        out *= sizes.get(a, 1)
    return out


def _filter(axis):
    """Drop axis names absent from the current mesh; () -> None."""
    avail = _avail()
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis if axis in avail else None
    kept = tuple(a for a in axis if a in avail)
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def pspec(*axes) -> tuple:
    """The spec tuple with unavailable axes dropped (None-padded dims kept)."""
    return tuple(_filter(a) for a in axes)


def shard(x: torch.Tensor, *axes) -> torch.Tensor:
    """The identity on one device (see the module docstring)."""
    return x


class ShardedLeaf:
    """A parameter leaf held as this rank's shard; :meth:`full` gathers
    the whole value, :meth:`part` this rank's ``"model"`` shard (gathered
    over the other axes), :meth:`share` the whole value whose grad on this
    rank is its share of the whole grad, and ``leaf[i]`` is layer ``i`` of
    a stacked leaf."""

    def full(self, named: bool = False) -> torch.Tensor:
        raise NotImplementedError

    def part(self) -> torch.Tensor:
        raise NotImplementedError

    def share(self) -> torch.Tensor:
        raise NotImplementedError

    def __getitem__(self, i) -> "ShardedLeaf":
        raise NotImplementedError


def gathered(tree):
    """``tree`` (a nested dict, or one leaf) with every
    :class:`ShardedLeaf` replaced by its whole value; plain tensors pass
    through."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    return tree.full() if isinstance(tree, ShardedLeaf) else tree


def computed_whole(tree):
    """:func:`gathered`, for a layer that every ``"model"`` rank computes
    whole within :func:`tensor_parallel` because the axis does not divide
    it: its leaves are named among those gathered over ``"model"`` (the
    compute the split leaves undone)."""
    if isinstance(tree, dict):
        return {k: computed_whole(v) for k, v in tree.items()}
    return tree.full(named=True) if isinstance(tree, ShardedLeaf) else tree


@contextlib.contextmanager
def data_parallel(mean_fn):
    """Within the block, :func:`data_mean` is ``mean_fn(x)`` (the mean of
    ``x`` over the data-parallel ranks, differentiable)."""
    prev = getattr(_env, "data_mean", None)
    _env.data_mean = mean_fn
    try:
        yield
    finally:
        _env.data_mean = prev


def data_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the data-parallel ranks (within
    :func:`data_parallel`; else ``x``, the one rank's value)."""
    fn = getattr(_env, "data_mean", None)
    return x if fn is None else fn(x)


@contextlib.contextmanager
def tensor_parallel(tp):
    """Within the block the layers compute their part on ``"model"``
    through ``tp`` (a :class:`repro_torch.distributed.spmd.MeshPlan`, or
    None: every rank computes the whole layer)."""
    prev = getattr(_env, "tp", None)
    _env.tp = tp
    try:
        yield
    finally:
        _env.tp = prev


def _tp():
    return getattr(_env, "tp", None)


def model_size() -> int:
    """The ranks that split the dense layers (1 outside
    :func:`tensor_parallel`)."""
    tp = _tp()
    return 1 if tp is None else tp.tp_size


def model_rank() -> int:
    """This rank's index among them (0 outside)."""
    tp = _tp()
    return 0 if tp is None else tp.tp_rank


def model_part(leaf):
    """This rank's ``"model"`` shard of ``leaf`` (a plain tensor is
    itself)."""
    return leaf.part() if isinstance(leaf, ShardedLeaf) else leaf


def model_share(leaf):
    """``leaf`` whole, used by this rank's part of a split layer: its grad
    here is this rank's share (a plain tensor is itself)."""
    return leaf.share() if isinstance(leaf, ShardedLeaf) else leaf


def head_range(n: int) -> tuple[int, int]:
    """This rank's balanced range ``[lo, hi)`` of ``n`` heads over
    ``"model"``: rank r of m takes ``[floor(r n / m), floor((r + 1) n /
    m))`` (the even split where m divides ``n``; ``(0, n)`` outside
    :func:`tensor_parallel`)."""
    m, r = model_size(), model_rank()
    return r * n // m, (r + 1) * n // m


def model_slice(leaf, dim: int, lo: int, hi: int, n: int):
    """``[lo, hi)`` along ``dim`` (of ``n``) of ``leaf``, a leaf whose
    ``dim`` the specs split on ``"model"``, for this rank's part of a
    split layer: its ``"model"`` shard where the range is that shard (m
    divides ``n`` and the range is the even one), else the leaf whole
    through :func:`model_share` (each rank's grad its share), sliced."""
    m, r = model_size(), model_rank()
    if n % m == 0 and (lo, hi) == (r * n // m, (r + 1) * n // m):
        return model_part(leaf)
    return model_share(leaf).narrow(dim, lo, hi - lo)


def copy_to_model(x):
    """``x`` entering a split layer (its grad summed over ``"model"``)."""
    tp = _tp()
    return x if tp is None else tp.copy_to_model(x)


def reduce_from_model(x, dtype=None, widen: bool = True):
    """The sum over ``"model"`` of the partials ``x``, as ``dtype``
    (``x``'s by default), summed one precision above it where ``widen``
    (outside: ``x`` as ``dtype``)."""
    tp = _tp()
    if tp is None:
        return x if dtype is None else x.to(dtype)
    return tp.reduce_from_model(x, dtype, widen)


def gather_from_model(x, dim: int):
    """Every ``"model"`` rank's ``x`` concatenated along ``dim``, its grad
    reduce-scattered back (each rank's part of the sum: every rank's work
    reads the whole; outside: ``x``)."""
    tp = _tp()
    return x if tp is None else tp.gather_from_model(x, dim)


def row_product(h, w):
    """``einsum("blf,fd->bld", h, w)``; within :func:`tensor_parallel`
    this rank's partial, one precision above the operands (float32 for
    16-bit, float64 for float32)."""
    tp = _tp()
    if tp is None:
        return torch.einsum("blf,fd->bld", h, w)
    return tp.row_product(h, w)


def gather_model(x, dim: int):
    """Every ``"model"`` rank's ``x`` concatenated along ``dim`` (no
    grad; outside: ``x``)."""
    tp = _tp()
    return x if tp is None else tp.gather_model(x, dim)


def vocab_lookup(table, ids):
    """The rows ``ids`` of the embedding leaf ``table`` (vocab-parallel
    within :func:`tensor_parallel`)."""
    tp = _tp()
    if tp is None:
        return gathered(table)[ids.long()]
    return tp.vocab_lookup(model_part(table), ids)


def vocab_nll(logits, labels):
    """The vocab-parallel mean NLL of ``labels`` under this rank's vocab
    columns ``logits`` (within :func:`tensor_parallel`), or None outside:
    the caller computes it whole."""
    tp = _tp()
    return None if tp is None else tp.vocab_nll(logits, labels)


@contextlib.contextmanager
def seq_parallel(sp):
    """Within the block the attention caches hold the slice of the KV
    sequence that ``sp`` describes (a
    :class:`repro_torch.distributed.spmd.SeqSlice`, or None: the whole
    sequence)."""
    prev = getattr(_env, "sp", None)
    _env.sp = sp
    try:
        yield
    finally:
        _env.sp = prev


def seq_split():
    """The hook of :func:`seq_parallel`'s block (None outside)."""
    return getattr(_env, "sp", None)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w).to(dt)


def rms_norm_split(x, w, width: int, eps: float = 1e-6):
    """:func:`rms_norm` over a vector of ``width`` of which ``x`` (and
    ``w``) is this rank's slice within :func:`tensor_parallel`: the mean
    of squares divides the slices' sums, totalled over ``"model"``, by
    the whole ``width``; the same float32 arithmetic and ``eps``.  Each
    rank normalises its own slice by the total, so the total's grad is
    summed over ``"model"`` too (:func:`copy_to_model` after
    :func:`reduce_from_model`, whose backward alone passes it through).
    Outside: :func:`rms_norm` (``x`` is the whole vector)."""
    if _tp() is None:
        return rms_norm(x, w, eps)
    dt = x.dtype
    x = x.float()
    ss = copy_to_model(reduce_from_model(torch.sum(x * x, dim=-1,
                                                   keepdim=True)))
    x = x * torch.rsqrt(ss / width + eps)
    return (x * w).to(dt)


def layer_norm(x, w, b, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * w + b).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope(positions, d_head: int, theta: float = 10_000.0):
    """cos/sin tables for rotary embedding: (..., L, d_head/2) each."""
    half = d_head // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs  # (..., L, half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., L, H, d_head); cos/sin: (..., L, d_head/2), broadcast over H."""
    half = x.shape[-1] // 2
    c = cos.unsqueeze(-2)  # (..., L, 1, half)
    s = sin.unsqueeze(-2)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_device(gen: torch.Generator | None) -> torch.device:
    """Where the init functions put their tensors: the generator's device,
    or ``meta`` (shapes and dtypes alone) when ``gen`` is None."""
    return torch.device("meta") if gen is None else gen.device


def default_generator(device, seed: int = 0):
    """A seeded generator on ``device`` (None on ``meta``: shapes alone)."""
    if device.type == "meta":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def normal_init(gen, shape, dtype=torch.float32, scale: float | None = None):
    """``scale * N(0, 1)`` drawn in float32 from ``gen``, then cast; the
    scale defaults to 1/sqrt(fan_in), as JAX's.  JAX's threefry stream has
    no torch counterpart: the distribution is JAX's, the numbers are not."""
    fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=init_device(gen),
                    dtype=torch.float32)
    return (scale * x).to(dtype)


# ---------------------------------------------------------------------------
# Parameter trees
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors held as an ``nn.Module``: each dict a child
    module under its key, each tensor a parameter under its key, so the
    parameter names are the tree's paths.  Parameters are made with
    ``requires_grad=False`` (serving); a trainer turns it on."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> dict:
        """The nested dict of this module's parameters (no copies)."""
        out = {key: mod.tree() for key, mod in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


def as_tree(params: Params) -> dict:
    """A nested dict of tensors from a ParamTree or a nested dict."""
    return params.tree() if isinstance(params, ParamTree) else params


def tree_index(tree: dict, i) -> dict:
    """Layer ``i`` of a stacked tree (views of every leaf's leading axis)."""
    return {k: tree_index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def stack_layers(make, n: int):
    """``n`` like trees of tensors from ``make()`` as one tree, each leaf
    stacked on a new leading (layer) axis, holding the stack and one tree
    at a time: each tree is copied into the stacked leaves and dropped."""
    def empty(tree):
        return {k: empty(v) if isinstance(v, dict)
                else v.new_empty((n, *v.shape)) for k, v in tree.items()}

    def put(dst, tree, i):
        for k, v in tree.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    tree = make()
    out = empty(tree)
    for i in range(n):
        if i:
            tree = make()
        put(out, tree, i)
        del tree
    return out


def stack_specs(tree):
    """Blocks are stacked along a leading layer dim -> prepend None."""
    return {k: stack_specs(v) if isinstance(v, dict) else (None,) + v
            for k, v in tree.items()}


def stack(items):
    """A list of like NamedTuples of tensors (caches) -> one NamedTuple,
    each field stacked on a new leading axis."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def layer(tup, *idx):
    """Entry ``idx`` of every field of a stacked NamedTuple."""
    return type(tup)(*(f[idx] for f in tup))


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------


def _weight_product(func, *args, **kwargs) -> bool:
    """A matrix product without batch dims: ``mm`` (a row-parallel
    partial's ``out_dtype`` one too) / ``addmm``, or the batch-1 ``bmm``
    that ``einsum`` makes of a product with a weight."""
    aten = torch.ops.aten
    if func in (aten.mm.default, aten.mm.dtype, aten.addmm.default):
        return True
    return func is aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    return (CheckpointPolicy.MUST_SAVE if _weight_product(func, *args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, cfg):
    """A block body as JAX's ``jax.checkpoint`` makes it, in torch terms.

    When ``cfg.remat`` is set and grads are on, ``fn``'s activations are
    not kept for the backward pass but recomputed there
    (``torch.utils.checkpoint``, non-reentrant).  ``cfg.remat_policy ==
    "dots"`` keeps the outputs of the products with weights (JAX's
    ``checkpoint_dots_with_no_batch_dims``) through selective activation
    checkpointing.  The recompute runs under the
    :func:`tensor_parallel` and :func:`data_parallel` hooks of the
    forward.  Otherwise ``fn`` itself.
    """
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    from torch.utils import checkpoint

    kw = {}
    if getattr(cfg, "remat_policy", None) == "dots":
        kw["context_fn"] = functools.partial(
            checkpoint.create_selective_checkpoint_contexts, _dots_policy)

    def run(*args):
        # The recompute runs on autograd's thread for CUDA tensors: it
        # installs the hooks this thread had at the forward.
        tp, mean = _tp(), getattr(_env, "data_mean", None)

        def body(*a):
            with tensor_parallel(tp), data_parallel(mean):
                return fn(*a)

        return checkpoint.checkpoint(body, *args, use_reentrant=False, **kw)

    return run
