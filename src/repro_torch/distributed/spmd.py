"""The train, prefill and decode steps across a ``DeviceMesh`` of more than
one device: what JAX's jit does with the steps' ``in_shardings`` and
``out_shardings``, done by hand on each rank.

Each rank runs the single-device model code (:mod:`repro_torch.models`) on
its own rows of the batch: a dim split over the data axes (``("pod",
"data")``, :data:`repro_torch.models.common.DATA`) is split in JAX's order,
the first axis outermost
(:func:`repro_torch.distributed.sharding.local_slices`).

**Tensor parallelism on ``"model"``.**  Where JAX's ``shard()`` hints put
heads, the ffn and the vocab on ``"model"``, the ranks that differ only on
``"model"`` each compute their part (Megatron's column / row split, through
the hooks of :mod:`repro_torch.models.common`, which this plan installs
with :func:`~repro_torch.models.common.tensor_parallel` when the axis has
more than one rank):

* :meth:`MeshPlan.copy_to_model` (the identity, its backward the sum over
  ``"model"``) feeds a column-parallel product, whose weight is the
  rank's ``"model"`` shard (:meth:`_Leaf.part`: gathered over the data
  axes only); :meth:`MeshPlan.reduce_from_model` sums a row-parallel
  product's partials over ``"model"`` (the identity in its backward),
  computed and summed one precision up (:meth:`MeshPlan.row_product`:
  float32 for 16-bit activations, float64 for float32) and cast once;
* the vocab: :meth:`MeshPlan.vocab_lookup` (the ids outside the rank's
  rows masked, looked up locally, summed over ``"model"``),
  :meth:`MeshPlan.vocab_nll` (the max, the sum of exponentials and the
  gold logit reduced over ``"model"``) and :meth:`MeshPlan.vocab_argmax`
  (each rank's max and its first index gathered; the largest wins, the
  lowest index on ties, as ``torch.argmax``);
* the MoE layer (:mod:`repro_torch.models.moe`): each rank computes its
  experts (``shard_experts``) or every expert's part of the ffn, on the
  tokens that every ``"model"`` rank holds alike (no all-to-all), and its
  (B, L, D) partial of the combine is summed over ``"model"`` as a
  row-parallel product's;
* the SSD (:mod:`repro_torch.models.ssm`) and attention whose heads the
  axis does not divide compute a balanced range of heads a rank
  (:func:`~repro_torch.models.common.head_range`), from the leaves whole
  where the stored shards are not their columns
  (:meth:`_Leaf.share`); the gated norm's sum of squares is totalled
  over ``"model"`` and its grad summed there too
  (:func:`~repro_torch.models.common.rms_norm_split`);
* a MoE whose experts and ffn the axis does not divide is computed whole
  on every ``"model"`` rank, its leaves gathered whole
  (:meth:`_Leaf.full`), on inputs that are the same on those ranks after
  the reductions.
  :attr:`MeshPlan.model_gathered` names the leaves gathered over
  ``"model"`` (shares included), and those of a layer computed whole
  there (a MoE whose leaves stay whole on the axis:
  :func:`~repro_torch.models.common.computed_whole`).

**Sequence parallelism at ``long_ctx``.**  A serving step of batch 1
(``long_ctx``) keeps the KV caches split on their sequence dim over
``"data"``, as JAX's ``cache_specs(long_ctx=True)`` stores them: every
data rank computes the one row, a prefill the prompt whole, then keeps
its slice of the cache; a decode step writes the new token's k / v only
on the rank whose slice holds its slot, and attends over its slice, the
slices' float32 softmax statistics combined by log-sum-exp over the data
axes (:class:`SeqSlice`, installed with
:func:`~repro_torch.models.common.seq_parallel`).

**The grads.**  A parameter is held as this rank's shard (:meth:`MeshPlan.leaf`,
a :class:`~repro_torch.models.common.ShardedLeaf`).  The models gather a
leaf where they use it, inside the ``remat`` body, so that a checkpointed
backward gathers it again; the gather is an autograd function
(:class:`_Gather`) whose backward (:meth:`MeshPlan.reduce_grad`) first
cuts the grad to this rank's ``"model"`` slice (or, for a leaf used whole
inside a tensor-parallel layer, :meth:`_Leaf.share`, whose grad on each
rank is its share: reduce-scatters it over ``"model"``), then
reduce-scatters it over the data axes that split the leaf and all-reduces
it over the others, / the data ranks.  The ranks that hold the same slice
(they differ only on axes other than the data axes that the leaf's spec
does not name) compute its grad on the same rows, but not to the same
bits: on CUDA the backward's scatters (the embedding's, an index's) add
with atomics in no fixed order.  So the backward also averages the
slice's grad over those axes, and every replica of a leaf, and of its
AdamW moments, is updated to the same bits whatever the caller's
``torch.use_deterministic_algorithms``.  The forward adds no floats with
atomics (the MoE counts are integers), and gloo's reductions give every
rank the same bits, so the loss and the served tokens and caches are the
same bits on those ranks.

**Which grads are partial.**  A leaf used whole inside a split layer
(``wk`` / ``wv`` where ``"model"`` does not divide the kv heads, the qk
norms, ``wq`` / ``wo`` where it does not divide the heads, the SSD's
``in_proj``, conv and (H,) leaves, B and C's columns included) gets on
each rank its share of the grad, summed over ``"model"``
(:meth:`_Leaf.share`); a leaf used outside one (the norms, the MoE
router) gets the whole grad on each rank, averaged
(:meth:`_Leaf.full`).  So the MoE's router, its softmax, top-k and
load-balancing ``aux`` run outside the expert-parallel region, alike on
every ``"model"`` rank (inside it the router's grad would be summed m
times); the two tensors that enter the region, the tokens of the
dispatch and the combine weights, enter through
:meth:`MeshPlan.copy_to_model`, whose backward sums each rank's share of
their grads over ``"model"`` (a rank's dispatch and combine touch only
its own experts' slots); the load-balancing statistics stay means over
the data axes (:meth:`MeshPlan.data_mean`).

* :meth:`MeshPlan.data_mean` is the mean over the data axes of a value
  that is not a per-row one (the MoE load-balancing statistics), with the
  same mean in its backward.
* :meth:`MeshPlan.view` is a batch or cache input as this rank computes
  it (its rows, every other dim whole but the axes kept: the KV caches
  and the SSM state's heads stay split on ``"model"``, and at
  ``long_ctx`` the KV caches on their sequence over ``"data"``), from a
  DTensor at the input's spec (gathered over the storage axes) or from a
  whole tensor every rank holds (sliced); :meth:`MeshPlan.place` makes
  an output of it a DTensor at its spec.
  :func:`repro_torch.distributed.sharding.put_tree` places the
  parameters and moments.

Every collective goes through :mod:`repro_torch.distributed.collective`
(staged through pinned host memory on gloo with CUDA tensors, counted by
:func:`repro_torch.launch.cost.analyze`); :attr:`MeshPlan.staged` counts
the bytes a rank copies to the host, by purpose: ``"gather"`` (leaves,
and serving inputs other than the KV caches), ``"kv"`` (KV caches
gathered by :meth:`MeshPlan.view`), ``"reduce"`` (grads), ``"stats"``
(MoE and metric means), ``"tp"`` (the activations reduced or gathered
over ``"model"``) and ``"seq"`` (the log-sum-exp combine over the data
axes); :attr:`MeshPlan.sent` the bytes of this rank's tensors the
collectives take, by the same purposes, on any device (on the CPU nothing
is staged).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import common
from . import collective, sharding

__all__ = ["MeshPlan", "SeqSlice", "is_multi_device", "TP_AXIS"]

TP_AXIS = "model"  # the axis the dense layers compute on


def is_multi_device(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` of more than one device."""
    size = getattr(mesh, "size", None)
    return callable(size) and size() > 1


def local(x: DTensor) -> torch.Tensor:
    """The local shard of ``x`` itself (``to_local`` under grad mode returns
    a view made by an autograd function; the steps update the shard in
    place)."""
    return x._local_tensor


class _Leaf(common.ShardedLeaf):
    """This rank's shard ``local`` of a parameter whose dims are split over
    the mesh axes ``axes`` (one tuple a dim, outermost first); ``name``
    is its path, for :attr:`MeshPlan.model_gathered`."""

    def __init__(self, plan: "MeshPlan", local_: torch.Tensor, axes,
                 name: str = ""):
        self.plan, self.local, self.axes = plan, local_, tuple(axes)
        self.name = name

    def __getitem__(self, i) -> "_Leaf":
        if self.axes[0]:
            raise ValueError(f"the stacked dim is split over {self.axes[0]}")
        return _Leaf(self.plan, self.local[i], self.axes[1:], self.name)

    def _whole(self, share: bool, named: bool = False) -> torch.Tensor:
        if self.plan.tp_size > 1 and (named or any(TP_AXIS in ax
                                                   for ax in self.axes)):
            self.plan.model_gathered.add(self.name)
        return _Gather.apply(self.local, self.plan, self.axes, self.axes,
                             share)

    def full(self, named: bool = False) -> torch.Tensor:
        return self._whole(False, named)

    def share(self) -> torch.Tensor:
        return self._whole(True)

    def part(self) -> torch.Tensor:
        """This rank's ``"model"`` shard, gathered over the other axes
        (the whole leaf where ``"model"`` does not compute)."""
        if self.plan.tp is None:
            return self.full()
        kept = [tuple(a for a in ax if a != TP_AXIS) for ax in self.axes]
        return _Gather.apply(self.local, self.plan, self.axes, kept, False)


class _Gather(torch.autograd.Function):
    """``local_`` gathered over ``gathered`` (one tuple of axes a dim); the
    backward is :meth:`MeshPlan.reduce_grad`."""

    @staticmethod
    def forward(ctx, local_, plan, axes, gathered, share):
        ctx.plan, ctx.axes, ctx.gathered, ctx.share = (plan, axes, gathered,
                                                       share)
        out = plan.gather(local_, gathered)
        return out.view_as(out) if out is local_ else out

    @staticmethod
    def backward(ctx, g):
        part = ctx.plan.reduce_grad(g, ctx.axes, ctx.gathered, ctx.share)
        return (part.clone(memory_format=torch.contiguous_format), None,
                None, None, None)


class _DataMean(torch.autograd.Function):
    """The mean over the data axes, forward and backward."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan.mean_over_data(x, "stats")

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.mean_over_data(g, "stats"), None


class _CopyToModel(torch.autograd.Function):
    """The identity; its backward sums the grad over ``"model"``."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.model_sum(g), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over ``"model"`` as ``dtype`` (one precision above it
    where ``widen``); the identity in the backward."""

    @staticmethod
    def forward(ctx, x, plan, dtype, widen):
        ctx.dtype = x.dtype
        return plan.model_sum(x, dtype, widen)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None


class _GatherFromModel(torch.autograd.Function):
    """Every ``"model"`` rank's ``x`` concatenated along ``dim``; the
    backward reduce-scatters the grad (the sum of every rank's, this
    rank's part), summed one precision up as :meth:`MeshPlan.model_sum`
    sums."""

    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return plan._gather_dim(x, dim, TP_AXIS, "tp")

    @staticmethod
    def backward(ctx, g):
        wide = g.to(common.WIDER.get(g.dtype, g.dtype))
        return (ctx.plan._scatter(wide, ctx.dim, TP_AXIS, "tp").to(g.dtype),
                None, None)


def _mm_wide(a, b):
    """``a @ b`` (2-D) one precision above the operands
    (:data:`~repro_torch.models.common.WIDER`): 16-bit operands on the
    card (and ``meta``) into the product's own
    float32 accumulators (``torch.mm(..., out_dtype=torch.float32)``);
    elsewhere, and float32 ones, cast up first (exact)."""
    wide = common.WIDER[a.dtype]
    if wide is torch.float32 and a.device.type in ("cuda", "meta"):
        return torch.mm(a, b, out_dtype=wide)
    return torch.mm(a.to(wide), b.to(wide))


class _RowProduct(torch.autograd.Function):
    """``h @ w`` (``h`` (..., F), ``w`` (F, D)) one precision above the
    operands: a rank's partial of a row-parallel product, summed before
    one cast.  The backward is the products of the grad cast back to the
    operands' dtype, as one device's backward of ``h @ w``."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        out = _mm_wide(h.reshape(-1, h.shape[-1]), w)
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(h.dtype)
        gh = (g2 @ w.T).reshape(h.shape)
        gw = h.reshape(-1, h.shape[-1]).T @ g2
        return gh, gw


class _VocabNLL(torch.autograd.Function):
    """The mean negative log-likelihood of ``labels`` under logits whose
    vocab is split over ``"model"`` (``logits`` this rank's columns), in
    float32: the row max, the sum of exponentials and the gold logit
    reduced over ``"model"``."""

    @staticmethod
    def forward(ctx, logits, labels, plan):
        x = logits.float()
        n = x.shape[-1]
        mx = plan.model_max(x.amax(dim=-1))
        e = torch.exp(x - mx[..., None])
        total = plan.model_sum(e.sum(dim=-1))
        idx = labels.long() - plan.tp_rank * n
        ok = (idx >= 0) & (idx < n)
        idx = torch.where(ok, idx, 0)
        gold = torch.gather(x, -1, idx[..., None])[..., 0]
        gold = plan.model_sum(torch.where(ok, gold, 0.0))
        ctx.save_for_backward(e, total, idx, ok)
        ctx.dtype = logits.dtype
        return torch.mean(torch.log(total) + mx - gold)

    @staticmethod
    def backward(ctx, g):
        e, total, idx, ok = ctx.saved_tensors
        p = e / total[..., None]
        p = p.scatter_add(-1, idx[..., None], -ok[..., None].to(p.dtype))
        return (p * (g / total.numel())).to(ctx.dtype), None, None


class MeshPlan:
    """This rank's place on ``mesh`` and the collectives of a step there.

    ``mesh`` is a ``DeviceMesh`` over ranks of the default group whose axes
    are named (``mesh_dim_names``); this rank must be on it.
    """

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if len(names) != mesh.ndim:
            raise ValueError("the mesh's axes must be named")
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the mesh")
        self.mesh, self.names = mesh, names
        self.sizes = {a: int(n) for a, n in zip(names, tuple(mesh.shape))}
        self.coord = {a: int(c) for a, c in zip(names, coord)}
        self.groups = {a: mesh.get_group(a) for a in names}
        for a, g in self.groups.items():  # a group's ranks in mesh order
            if self.sizes[a] > 1 and dist.get_rank(g) != self.coord[a]:
                raise ValueError(f"axis {a!r}: group rank "
                                 f"{dist.get_rank(g)}, coordinate "
                                 f"{self.coord[a]}")
        self.data_axes = tuple(a for a in common.DATA if a in names)
        self.n_data = math.prod(self.sizes[a] for a in self.data_axes)
        self.tp_size = self.sizes.get(TP_AXIS, 1)
        self.tp_rank = self.coord.get(TP_AXIS, 0)
        self.staged = {"gather": 0, "kv": 0, "reduce": 0, "stats": 0,
                       "tp": 0, "seq": 0}
        self.sent = dict(self.staged)
        self.model_gathered: set[str] = set()

    @property
    def tp(self):
        """The hook :func:`~repro_torch.models.common.tensor_parallel`
        takes: this plan where ``"model"`` has more than one rank, else
        None (the models compute every row whole)."""
        return self if self.tp_size > 1 else None

    # -- specs ---------------------------------------------------------------
    def dim_axes(self, spec, ndim: int) -> list[tuple[str, ...]]:
        """The mesh axes each of ``ndim`` dims is split over under
        ``spec`` (JAX's checks)."""
        return sharding._dim_axes(self.names, tuple(spec), ndim)

    def _spec(self, axes) -> tuple:
        return tuple(None if not a else (a[0] if len(a) == 1 else a)
                     for a in axes)

    def slices(self, shape, axes) -> tuple:
        """This rank's slices of a ``shape`` value split over ``axes``
        (one tuple a dim); ``ValueError`` where a split does not divide."""
        return sharding.local_slices(tuple(shape), self.sizes,
                                     self._spec(axes), self.coord)

    # -- collectives ---------------------------------------------------------
    def _count(self, purpose: str, x, group) -> None:
        """Tally a collective of this rank's ``x`` over ``group``."""
        self.sent[purpose] += x.numel() * x.element_size()
        self.staged[purpose] += collective.staged_bytes(x, group)

    def _gather_dim(self, x, d: int, axis: str, purpose: str):
        group = self.groups[axis]
        moved = x.movedim(d, 0).contiguous()
        self._count(purpose, moved, group)
        return collective.all_gather(moved, group=group).movedim(0, d)

    def gather(self, x, axes, purpose: str = "gather"):
        """``x``, this rank's part of a value split over ``axes`` (one tuple
        a dim), all-gathered whole: a dim's innermost axis first."""
        for d, dim_axes in enumerate(axes):
            for a in reversed(dim_axes):
                if self.sizes[a] > 1:
                    x = self._gather_dim(x, d, a, purpose)
        return x

    def _scatter(self, x, d: int, axis: str, purpose: str):
        """The sum of ``x`` over ``axis``, cut along dim ``d``: this
        rank's part."""
        group = self.groups[axis]
        moved = x.movedim(d, 0).contiguous()
        self._count(purpose, moved, group)
        return collective.reduce_scatter(moved, group=group).movedim(0, d)

    def _chunk(self, x, d: int, axis: str):
        """This rank's part of ``x`` cut along dim ``d`` over ``axis``."""
        n = x.shape[d] // self.sizes[axis]
        return x.narrow(d, self.coord[axis] * n, n)

    def _all_reduce(self, x, axis: str, purpose: str,
                    op=dist.ReduceOp.SUM):
        group = self.groups[axis]
        self._count(purpose, x, group)
        return collective.all_reduce(x, op=op, group=group)

    def reduce_grad(self, g, axes, gathered, share: bool):
        """The grad of this rank's shard of a leaf split over ``axes`` (one
        tuple a dim), from ``g``, the grad of its value gathered over
        ``gathered``.

        ``"model"`` first: the rank's slice is cut out (or, with ``share``,
        where each rank's grad is its share of the whole one, the sum
        reduce-scattered; a leaf not split there is summed over it).
        Then the data axes: reduce-scattered where they split the leaf,
        all-reduced where they do not, / the data ranks.  Without
        ``share`` the slice is then averaged over the other axes that do
        not split the leaf (its replicas)."""
        data = set(self.data_axes)
        live = [tuple(a for a in ax if self.sizes[a] > 1) for ax in gathered]
        late = []
        for d, ax in enumerate(live):  # dims gathered over "model" alone
            if any(a in data for a in ax):
                late.append(d)
                continue
            for a in ax:
                g = (self._scatter(g, d, a, "reduce") if share
                     else self._chunk(g, d, a))
        for d in late:  # in the dim's order: the outer axis first
            for a in live[d]:
                g = (self._scatter(g, d, a, "reduce")
                     if a in data or share else self._chunk(g, d, a))
        named = {a for ax in axes for a in ax}
        others = [a for a in self.names if a not in data
                  and a not in named and self.sizes[a] > 1]
        if share:
            for a in others:
                g = self._all_reduce(g, a, "reduce")
        for a in self.data_axes:
            if self.sizes[a] > 1 and a not in named:
                g = self._all_reduce(g, a, "reduce")
        if self.n_data > 1:
            g = g / self.n_data
        return g if share else self.mean_over_replicas(g, axes)

    def mean_over_data(self, x, purpose: str):
        """The mean of ``x`` over the data axes (a sum over each axis's
        group, then / the ranks; every rank gets the same bits)."""
        if self.n_data == 1:
            return x
        for a in self.data_axes:
            if self.sizes[a] > 1:
                self._count(purpose, x, self.groups[a])
                x = collective.all_reduce(x, group=self.groups[a])
        return x / self.n_data

    def mean_over_replicas(self, x, axes):
        """The mean of ``x``, this rank's slice of a leaf split over
        ``axes`` (one tuple a dim), over the axes other than the data
        axes that do not split it: the ranks that hold the same slice."""
        named = {a for ax in axes for a in ax}
        over = [a for a in self.names if a not in self.data_axes
                and a not in named and self.sizes[a] > 1]
        for a in over:
            x = self._all_reduce(x, a, "reduce")
        return x / math.prod(self.sizes[a] for a in over) if over else x

    def data_mean(self, x):
        """:func:`repro_torch.models.common.data_mean` on this mesh."""
        return _DataMean.apply(x, self)

    def sum_over_mesh(self, x):
        """The sum of ``x`` over every rank of the mesh."""
        for a in self.names:
            if self.sizes[a] > 1:
                x = collective.all_reduce(x, group=self.groups[a])
        return x

    # -- tensor parallelism on "model" (the hooks of models.common) ----------
    def model_sum(self, x, dtype=None, widen: bool = True):
        """The sum of ``x`` over ``"model"`` as ``dtype`` (``x``'s by
        default); where ``widen``, summed one precision above ``dtype``
        (float32 for 16-bit, float64 for float32)."""
        dtype = x.dtype if dtype is None else dtype
        if widen:
            x = x.to(common.WIDER.get(dtype, dtype))
        return self._all_reduce(x, TP_AXIS, "tp").to(dtype)

    def model_max(self, x):
        """The max of ``x`` over ``"model"``."""
        return self._all_reduce(x, TP_AXIS, "tp", op=dist.ReduceOp.MAX)

    def gather_model(self, x, dim: int):
        """Every ``"model"`` rank's ``x`` concatenated along ``dim`` (no
        grad: the serving steps' moves between the head and the
        ``d_head`` split)."""
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("gather_model carries no grad")
        group = self.groups[TP_AXIS]
        moved = x.movedim(dim, 0).contiguous()
        self._count("tp", moved, group)
        return collective.all_gather(moved, group=group).movedim(0, dim)

    def copy_to_model(self, x):
        """``x``, the input of a column-parallel product (Megatron's
        ``f``)."""
        return _CopyToModel.apply(x, self)

    def reduce_from_model(self, x, dtype=None, widen: bool = True):
        """The sum of the partials ``x`` over ``"model"``, as ``dtype``
        (Megatron's ``g``; one precision above ``dtype`` where
        ``widen``)."""
        return _ReduceFromModel.apply(x, self, x.dtype if dtype is None
                                      else dtype, widen)

    def gather_from_model(self, x, dim: int):
        """Every ``"model"`` rank's ``x`` concatenated along ``dim``, its
        grad reduce-scattered back
        (:func:`~repro_torch.models.common.gather_from_model`)."""
        return _GatherFromModel.apply(x, self, dim)

    def row_product(self, h, w):
        """``h @ w`` (``h`` (B, L, F), ``w`` (F, D)): this rank's partial
        of a row-parallel product, one precision up (16-bit operands
        accumulate into float32, float32 ones are multiplied in
        float64)."""
        return _RowProduct.apply(h, w)

    def vocab_lookup(self, table, ids):
        """The rows ``ids`` of an embedding whose vocab rows are split over
        ``"model"`` (``table`` this rank's rows): the ids outside them
        masked, the rest looked up, the sum over ``"model"`` (exact: one
        rank holds each row)."""
        n = table.shape[0]
        idx = ids.long() - self.tp_rank * n
        ok = (idx >= 0) & (idx < n)
        rows = table[torch.where(ok, idx, 0)]
        rows = torch.where(ok[..., None], rows, torch.zeros(
            (), dtype=rows.dtype, device=rows.device))
        return self.reduce_from_model(rows, widen=False)

    def vocab_nll(self, logits, labels):
        """``models.transformer._nll`` of logits whose vocab is split over
        ``"model"`` (``logits`` this rank's columns)."""
        return _VocabNLL.apply(logits, labels, self)

    def vocab_argmax(self, logits):
        """``torch.argmax(logits, -1)`` (int32) of ``(B, V)`` logits whose
        vocab is split over ``"model"``: each rank's max and its first
        index gathered, the largest taken, the lowest index on ties."""
        n = logits.shape[-1]
        idx = torch.argmax(logits, dim=-1)
        val = torch.gather(logits, -1, idx[..., None])[..., 0]
        vals = self.gather_model(val[None], 0)
        idxs = self.gather_model(idx[None], 0)
        best = torch.argmax(vals, dim=0)
        top = torch.gather(idxs, 0, best[None])[0]
        return (best * n + top).to(torch.int32)

    # -- leaves, inputs and outputs ------------------------------------------
    def leaf(self, x: DTensor, spec, name: str = "") -> _Leaf:
        """The parameter ``x`` (a DTensor at ``spec``, at path ``name``) as
        the model takes it: its local shard, gathered where the model
        uses it."""
        return _Leaf(self, local(x), self.dim_axes(spec, x.ndim), name)

    def view(self, x, spec, keep, device,
             purpose: str = "gather") -> torch.Tensor:
        """This rank's part of the input ``x`` at ``spec`` under the axes
        ``keep`` (its rows), whole on every other axis: a DTensor at
        ``spec`` is gathered over the axes not kept (staged under
        ``purpose``), anything else is taken whole (a DTensor elsewhere
        gathered first) and sliced."""
        axes = self.dim_axes(spec, x.ndim)
        kept = [tuple(a for a in ax if a in keep) for ax in axes]
        for ax, k in zip(axes, kept):
            if k and k != ax:
                raise ValueError(f"spec {tuple(spec)}: a dim split over "
                                 f"{ax} keeps only {k}")
        if sharding.is_placed(x, self.mesh, spec):
            return self.gather(local(x), [() if k else ax
                                          for ax, k in zip(axes, kept)],
                               purpose)
        whole = sharding.full_tensor(x) if isinstance(x, DTensor) else x
        part = whole[self.slices(whole.shape, kept)]
        return part.to(device, copy=True,
                       memory_format=torch.contiguous_format)

    def seq_slice(self, spec, shape):
        """The :class:`SeqSlice` of a KV cache leaf of ``shape`` at
        ``spec`` whose sequence dim (2: layer, batch, sequence, ...) the
        data axes split, or None where they split none of it or do not
        divide it (the cache is then gathered whole)."""
        axes = self.dim_axes(spec, len(shape))
        seq = tuple(a for a in axes[2] if a in self.data_axes
                    and self.sizes[a] > 1)
        n = math.prod(self.sizes[a] for a in seq)
        if not seq or shape[2] % n:
            return None
        sl = self.slices(shape, [() if d != 2 else axes[2]
                                 for d in range(len(shape))])[2]
        return SeqSlice(self, seq, sl.start, sl.stop - sl.start, shape[2])

    def place(self, t, spec, keep) -> DTensor:
        """``t``, this rank's part of an output under the axes ``keep``
        (whole on the others), as a DTensor at ``spec``."""
        axes = self.dim_axes(spec, t.ndim)
        kept = [tuple(a for a in ax if a in keep) for ax in axes]
        shape = [n * math.prod(self.sizes[a] for a in k)
                 for n, k in zip(t.shape, kept)]
        drop = [tuple(a for a in ax if a not in keep) for ax in axes]
        if any(drop):  # a copy: the slice would hold all of ``t``
            part = t[self.slices(t.shape, drop)].clone(
                memory_format=torch.contiguous_format)
        else:
            part = t.contiguous()
        return sharding._dtensor(part, self.mesh,
                                 sharding.placements(self.mesh,
                                                     self._spec(axes)),
                                 shape)

    def global_sq_norm(self, grads, specs) -> torch.Tensor:
        """The squared global norm of the grads whose local shards are
        ``grads`` (float32 0-d, the same bits on every rank): each shard's
        sum of squares over the ranks that hold it, summed over the
        mesh."""
        world = math.prod(self.sizes.values())
        total = None
        for g, spec in zip(grads, specs):
            split = math.prod(self.sizes[a] for ax in
                              self.dim_axes(spec, g.ndim) for a in ax)
            part = torch.sum(torch.square(g.float())) / (world // split)
            total = part if total is None else total + part
        return self.sum_over_mesh(total)


class SeqSlice:
    """The hook of :func:`~repro_torch.models.common.seq_parallel`: this
    rank holds the positions ``[offset, offset + length)`` of a KV
    sequence of ``total`` positions split over the data axes ``axes`` (the
    ranks that hold the other slices of the same row)."""

    def __init__(self, plan: MeshPlan, axes, offset: int, length: int,
                 total: int):
        self.plan, self.axes = plan, tuple(axes)
        self.offset, self.length, self.total = offset, length, total

    def max(self, x):
        """The max of ``x`` over the slices (one all-reduce an axis)."""
        for a in self.axes:
            x = self.plan._all_reduce(x, a, "seq", op=dist.ReduceOp.MAX)
        return x

    def sum(self, x):
        """The sum of ``x`` over the slices."""
        for a in self.axes:
            x = self.plan._all_reduce(x, a, "seq")
        return x
