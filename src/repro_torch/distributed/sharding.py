"""Named shardings on a ``DeviceMesh`` (the port's counterpart of
``jax.sharding.NamedSharding`` / ``jax.device_put``).

A spec is the plain tuple :func:`repro_torch.models.common.pspec` returns,
entry for entry JAX's ``tuple(PartitionSpec(...))``: one entry a tensor
dim, each ``None`` (replicated), an axis name, or a tuple of axis names
(the dim split over their product, the first name outermost, as JAX's
``P(("pod", "data"))``).  Missing trailing entries are ``None``.

:func:`placements` maps a spec onto DTensor placements, one a mesh dim:
``Shard(dim)`` on each mesh dim a tensor dim names, ``Replicate()`` on the
others.  DTensor splits the dims of several mesh dims in mesh-dim order,
so a dim's axes must be named in the mesh's order (JAX would also take
the other order; this refuses it).  Where JAX refuses a dim that its
axes' product does not divide, DTensor would split it unevenly as
``torch.chunk`` does: this refuses it with ``ValueError``, as JAX.

:func:`device_put` slices this rank's shard out of a value every rank
holds: it moves nothing between ranks.  The local shard stays on the
value's device (or ``device``), whatever the mesh's device type: a gloo
mesh is a ``"cpu"`` mesh and still carries CUDA shards.  DTensor's own
``from_local`` would move such a shard to the mesh's device type, and its
collectives (``full_tensor``, redistribution) would ask gloo for CUDA
ops, so the DTensor is built from its spec directly
(:func:`_dtensor`) and :func:`full_tensor` gathers through
:mod:`repro_torch.distributed.collective`'s staged path.  A rank outside
the mesh (a spare of :func:`repro_torch.distributed.elastic.remesh`)
holds an empty local tensor, as DTensor gives it.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._dtensor_spec import DTensorSpec, TensorMeta

from .. import tree as tree_lib
from . import collective

__all__ = ["NamedSharding", "placements", "local_slices", "device_put",
           "full_tensor", "shardings_like", "is_placed", "put_tree"]


class NamedSharding(NamedTuple):
    """A mesh and a spec tuple (``jax.sharding.NamedSharding``)."""
    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    spec: tuple = ()


def _dim_axes(names, spec, ndim: int) -> list[tuple[str, ...]]:
    """The mesh axes (of the mesh axis ``names``) each tensor dim is split
    over (``()``: replicated), after JAX's checks: known axes, each used
    once, no more entries than dims, a dim's axes in mesh order."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{ndim}-d value")
    out, seen = [], set()
    for entry in spec + (None,) * (ndim - len(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}; the mesh "
                                 f"has {names}")
            if a in seen:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            seen.add(a)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: the axes {axes} of one dim must "
                             f"be in the mesh's order {names}")
        out.append(axes)
    return out


def placements(mesh, spec) -> tuple:
    """``Shard(dim)`` / ``Replicate()`` for each mesh dim of ``mesh``."""
    names = tuple(mesh.mesh_dim_names or ())
    out = [Replicate()] * len(names)
    for d, axes in enumerate(_dim_axes(names, spec, len(tuple(spec)))):
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def local_slices(shape, mesh_shape: dict, spec, coord: dict) -> tuple:
    """The slices of a ``shape`` value that the mesh coordinate ``coord``
    (axis -> index) holds under ``spec`` on a mesh of ``mesh_shape`` (axis
    -> size, in mesh order).  ``ValueError`` where a dim's axes do not
    divide it (JAX's rule)."""
    out = []
    for d, axes in enumerate(_dim_axes(tuple(mesh_shape), spec, len(shape))):
        parts = math.prod(mesh_shape[a] for a in axes)
        if shape[d] % parts:
            raise ValueError(
                f"spec {tuple(spec)} splits dim {d} of shape {tuple(shape)} "
                f"over {parts} shards, which does not divide {shape[d]}")
        idx = int(np.ravel_multi_index(tuple(coord[a] for a in axes),
                                       tuple(mesh_shape[a] for a in axes))) \
            if axes else 0
        size = shape[d] // parts
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


def _mesh_shape(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _coord(mesh):
    """This rank's coordinate (axis -> index), or None outside the
    mesh."""
    c = mesh.get_coordinate()
    return None if c is None else dict(zip(mesh.mesh_dim_names, c))


def _dtensor(local, mesh, places, shape) -> DTensor:
    """A DTensor of global ``shape`` over ``local``, on ``local``'s device
    (see the module docstring: ``from_local`` would move it to the mesh's
    device type)."""
    shape = torch.Size(shape)
    stride, step = [], 1  # contiguous strides (no tensor made: a cost
    for n in reversed(shape):  # counter would count its bytes)
        stride.append(step)
        step *= max(int(n), 1)
    stride = tuple(reversed(stride))
    spec = DTensorSpec(mesh, tuple(places),
                       tensor_meta=TensorMeta(shape, stride, local.dtype))
    return DTensor(local, spec, requires_grad=False)


def device_put(x, sharding: NamedSharding, device=None) -> DTensor:
    """``x`` (a tensor, an array, or a DTensor: regathered first) placed
    with ``sharding``: this rank's shard of it, a copy on ``device`` (None:
    ``x``'s device, the CPU for an array).  Every rank holds all of ``x``;
    nothing moves between ranks."""
    if isinstance(x, DTensor):
        x = full_tensor(x)
    elif not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    dev = x.device if device is None else torch.device(device)
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    shape = tuple(x.shape)
    places = placements(mesh, spec + (None,) * (len(shape) - len(spec)))
    coord = _coord(mesh)
    if coord is None:
        local_slices(shape, _mesh_shape(mesh), spec,
                     dict.fromkeys(mesh.mesh_dim_names, 0))  # JAX's checks
        local = torch.empty(0, dtype=x.dtype, device=dev)
    else:
        sl = local_slices(shape, _mesh_shape(mesh), spec, coord)
        local = x[sl].to(dev, copy=True,
                           memory_format=torch.contiguous_format)
    return _dtensor(local, mesh, places, shape)


def _spec_of(x: DTensor) -> tuple:
    """The spec tuple of ``x``'s placements (the inverse of
    :func:`placements`)."""
    names = x.device_mesh.mesh_dim_names
    dims = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if isinstance(p, Shard):
            dims[p.dim].append(name)
        elif not isinstance(p, Replicate):
            raise ValueError(f"placement {p} is not Shard / Replicate")
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in dims)


def full_tensor(x, device=None) -> torch.Tensor:
    """The whole value of a DTensor on every rank, on ``device`` (None:
    its local shard's).  A collective over the default group (every rank
    of the world calls it, spares too): each rank's shard is all-gathered
    through :func:`collective.all_gather` (staged through pinned host
    memory on gloo when the shard is on CUDA and ``device`` is not the
    CPU) and laid out by the mesh coordinate of the rank that sent it.
    A plain tensor comes back as it is (moved to ``device``)."""
    if not isinstance(x, DTensor):
        return x if device is None else x.to(device)
    local = x.to_local()
    dev = local.device if device is None else torch.device(device)
    mesh, shape = x.device_mesh, tuple(x.shape)
    spec, sizes = _spec_of(x), _mesh_shape(mesh)
    first = local_slices(shape, sizes, spec, dict.fromkeys(sizes, 0))
    shard_shape = tuple(s.stop - s.start for s in first)
    if local.numel() == 0 and math.prod(shard_shape):  # a spare rank
        local = torch.zeros(shard_shape, dtype=x.dtype, device=local.device)
    rows = collective.all_gather(local.to(dev).reshape(1, *shard_shape))
    out = torch.empty(shape, dtype=x.dtype, device=dev)
    names = tuple(mesh.mesh_dim_names)
    grid = mesh.mesh.reshape(-1).tolist()
    for flat, rank in enumerate(grid):
        c = np.unravel_index(flat, tuple(mesh.shape))
        out[local_slices(shape, sizes, spec, dict(zip(names, c)))] = \
            rows[rank]
    return out


def shardings_like(tree, spec_tree, mesh):
    """A tree of ``tree``'s structure (``ParamTree`` nodes as dicts) holding
    the :class:`NamedSharding` of each leaf's spec in ``spec_tree`` on
    ``mesh``: JAX's ``tree.map(lambda s: NamedSharding(mesh, s), specs)``,
    what ``checkpoint.load(..., shardings=)`` takes."""
    specs = tree_lib.prefix_leaves(tree, spec_tree)
    return tree_lib.unflatten_like(tree_lib.plain(tree),
                                   [NamedSharding(mesh, s) for s in specs])


def is_placed(x, mesh, spec) -> bool:
    """Whether ``x`` is a DTensor on ``mesh`` split as ``spec`` splits it."""
    if not isinstance(x, DTensor) or x.device_mesh != mesh:
        return False
    names = tuple(mesh.mesh_dim_names)
    return (_dim_axes(names, _spec_of(x), x.ndim)
            == _dim_axes(names, tuple(spec), x.ndim))


def put_tree(tree, spec_tree, mesh, device=None):
    """Each leaf of ``tree`` at its spec in ``spec_tree`` on ``mesh``: a
    DTensor already there as it is, anything else through
    :func:`device_put` onto ``device``.  A tree of ``tree``'s structure
    (``ParamTree`` nodes as dicts)."""
    specs = tree_lib.prefix_leaves(tree, spec_tree)
    return tree_lib.unflatten_like(tree_lib.plain(tree), [
        x if is_placed(x, mesh, s)
        else device_put(x, NamedSharding(mesh, tuple(s)), device)
        for x, s in zip(tree_lib.leaves(tree), specs)])
