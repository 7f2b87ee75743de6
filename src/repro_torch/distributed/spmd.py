"""The train, prefill and decode steps across a ``DeviceMesh`` of more than
one device: what JAX's jit does with the steps' ``in_shardings`` and
``out_shardings``, done by hand on each rank.

Each rank runs the single-device model code (:mod:`repro_torch.models`) on
its own rows of the batch: a dim split over the data axes (``("pod",
"data")``, :data:`repro_torch.models.common.DATA`) is split in JAX's order,
the first axis outermost
(:func:`repro_torch.distributed.sharding.local_slices`).
Every other split is storage alone: ranks that differ only on ``"model"``
compute the same rows, and JAX's ``shard()`` hints (heads, ffn, experts and
vocab on ``"model"``, the long-context KV sequence on ``"data"``) change
where a value lives, not what is computed.

* A parameter is held as this rank's shard (:class:`MeshPlan.leaf`, a
  :class:`~repro_torch.models.common.ShardedLeaf`).  The models gather a
  block's leaves at the top of its body and a top-level leaf where they use
  it; the gather is an autograd function whose forward all-gathers over the
  mesh axes the leaf's spec names, and whose backward averages the whole
  grad over the data axes and keeps this rank's slice.  Under
  ``torch.utils.checkpoint`` (``remat``) the backward gathers the leaves
  again instead of holding every layer whole.
* The ranks that hold the same slice of a leaf (they differ only on axes
  other than the data axes that its spec does not name) compute its grad
  on the same rows, but not to the same bits: on CUDA the backward's
  scatters (the embedding's, an index's) add with atomics in no fixed
  order.  So the backward also averages the slice's grad over those
  axes, and every replica of a leaf, and of its AdamW moments, is updated
  to the same bits whatever the caller's
  ``torch.use_deterministic_algorithms``.  The forward adds no floats
  with atomics (the MoE counts are integers), so the loss and the served
  tokens and caches are the same bits on those ranks.
* :meth:`MeshPlan.data_mean` is the mean over the data axes of a value
  that is not a per-row one (the MoE load-balancing statistics), with the
  same mean in its backward.
* :meth:`MeshPlan.view` is a batch or cache input as this rank computes
  it (its rows, every other dim whole), from a DTensor at the input's
  spec (gathered over the storage axes) or from a whole tensor every rank
  holds (sliced); :meth:`MeshPlan.place` makes an output of it a DTensor
  at its spec.  :func:`repro_torch.distributed.sharding.put_tree` places
  the parameters and moments.

Every collective goes through :mod:`repro_torch.distributed.collective`
(staged through pinned host memory on gloo with CUDA tensors, counted by
:func:`repro_torch.launch.cost.analyze`); :attr:`MeshPlan.staged` counts
the bytes a rank copies to the host, by purpose.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import common
from . import collective, sharding

__all__ = ["MeshPlan", "is_multi_device"]


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
    the mesh axes ``axes`` (one tuple a dim, outermost first)."""

    def __init__(self, plan: "MeshPlan", local_: torch.Tensor, axes):
        self.plan, self.local, self.axes = plan, local_, tuple(axes)

    def __getitem__(self, i) -> "_Leaf":
        if self.axes[0]:
            raise ValueError(f"the stacked dim is split over {self.axes[0]}")
        return _Leaf(self.plan, self.local[i], self.axes[1:])

    def full(self) -> torch.Tensor:
        return _Gather.apply(self.local, self.plan, self.axes)


class _Gather(torch.autograd.Function):
    """The whole leaf from this rank's shard; the backward averages the
    grad over the data axes, keeps this rank's slice and averages that
    over the other axes the leaf is not split on."""

    @staticmethod
    def forward(ctx, local_, plan, axes):
        ctx.plan, ctx.axes = plan, axes
        out = plan.gather(local_, axes)
        return out.view_as(out) if out is local_ else out

    @staticmethod
    def backward(ctx, g):
        plan = ctx.plan
        g = plan.mean_over_data(g, "reduce")
        part = g[plan.slices(g.shape, ctx.axes)]
        part = plan.mean_over_replicas(part, ctx.axes)
        return part.clone(memory_format=torch.contiguous_format), None, None


class _DataMean(torch.autograd.Function):
    """The mean over the data axes, forward and backward."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return plan.mean_over_data(x, "stats")

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.mean_over_data(g, "stats"), None


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
        self.staged = {"gather": 0, "reduce": 0, "stats": 0}

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
    def _gather_dim(self, x, d: int, axis: str):
        group = self.groups[axis]
        moved = x.movedim(d, 0).contiguous()
        self.staged["gather"] += collective.staged_bytes(moved, group)
        return collective.all_gather(moved, group=group).movedim(0, d)

    def gather(self, x, axes):
        """``x``, this rank's part of a value split over ``axes`` (one tuple
        a dim), all-gathered whole: a dim's innermost axis first."""
        for d, dim_axes in enumerate(axes):
            for a in reversed(dim_axes):
                if self.sizes[a] > 1:
                    x = self._gather_dim(x, d, a)
        return x

    def mean_over_data(self, x, purpose: str):
        """The mean of ``x`` over the data axes (a sum over each axis's
        group, then / the ranks; every rank gets the same bits)."""
        if self.n_data == 1:
            return x
        for a in self.data_axes:
            if self.sizes[a] > 1:
                self.staged[purpose] += collective.staged_bytes(
                    x, self.groups[a])
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
            self.staged["reduce"] += collective.staged_bytes(
                x, self.groups[a])
            x = collective.all_reduce(x, group=self.groups[a])
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

    # -- leaves, inputs and outputs ------------------------------------------
    def leaf(self, x: DTensor, spec) -> _Leaf:
        """The parameter ``x`` (a DTensor at ``spec``) as the model takes
        it: its local shard, gathered where the model uses it."""
        return _Leaf(self, local(x), self.dim_axes(spec, x.ndim))

    def view(self, x, spec, keep, device) -> torch.Tensor:
        """This rank's part of the input ``x`` at ``spec`` under the axes
        ``keep`` (its rows), whole on every other axis: a DTensor at
        ``spec`` is gathered over the axes not kept, anything else is
        taken whole (a DTensor elsewhere gathered first) and sliced."""
        axes = self.dim_axes(spec, x.ndim)
        kept = [tuple(a for a in ax if a in keep) for ax in axes]
        for ax, k in zip(axes, kept):
            if k and k != ax:
                raise ValueError(f"spec {tuple(spec)}: a dim split over "
                                 f"{ax} keeps only {k}")
        if sharding.is_placed(x, self.mesh, spec):
            return self.gather(local(x), [() if k else ax
                                          for ax, k in zip(axes, kept)])
        whole = sharding.full_tensor(x) if isinstance(x, DTensor) else x
        part = whole[self.slices(whole.shape, kept)]
        return part.to(device, copy=True,
                       memory_format=torch.contiguous_format)

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
