"""Elastic scaling: rebuild the mesh after membership changes and re-shard
(port of ``repro/distributed/elastic.py``).

Flow on failure/join (driven by the trainer):
  1. failure detected (heartbeat / collective timeout — here: injected);
  2. survivors agree on the new rank set;
  3. ``remesh`` builds the largest (data, model)-factorable mesh from the
     surviving ranks (model axis preserved when possible — TP groups are
     latency-critical; data axis absorbs the loss);
  4. state restores from the latest checkpoint via
     ``checkpoint.load(..., shardings=new)`` — each rank slices its shard
     of each leaf (:func:`repro_torch.distributed.sharding.device_put`);
  5. the data pipeline re-shards by construction (counter-indexed).

A lost rank breaks its process group, so the survivors are a new launch
(:func:`repro_torch.distributed.launch.spawn` with fewer ranks) that
restores from the checkpoint, as JAX's test restores onto fewer devices.

The paper's own churn experiment (§VI-F) is the P2P analogue: LSS keeps
being correct while peers leave because neighbor state is recomputed from
the remaining links — here, the monitor's neighbor set is remapped by the
new mesh and its weighted state re-enters from the survivors' inputs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .. import tree as tree_lib
from ..launch.mesh import mesh_device_type
from .sharding import NamedSharding, device_put

__all__ = ["remesh", "remesh_plan", "reshard"]


def remesh_plan(n: int, model_axis: int = 1) -> dict:
    """JAX's arithmetic alone: the model axis halved until it divides
    ``n``, the data axis what is left.  Returns JAX's info dict.  The
    halving stops at a divisor of ``n`` (1 at worst), so every rank fits
    and ``spares`` is always 0, in JAX's too."""
    model = model_axis
    while model > 1 and n % model:
        model //= 2
    data = n // model
    return {"devices_used": data * model, "spares": n - data * model,
            "shape": {"data": data, "model": model}}


def remesh(ranks=None, model_axis: int = 1, axes=("data", "model")):
    """Largest mesh over ``ranks`` (ranks of the current world; default:
    all of them) with the model axis preserved; returns ``(mesh, info)``.

    A collective: every rank of the world calls it with the same
    ``ranks``, those outside them too.  A rank outside the mesh (a spare
    kept hot, or a rank left out of ``ranks``) gets the same mesh back;
    its ``get_coordinate()`` is None, and a value placed on the mesh
    there holds an empty local shard.
    """
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    info = remesh_plan(len(ranks), model_axis)
    data, model = info["shape"]["data"], info["shape"]["model"]
    grid = torch.tensor(ranks[: data * model], dtype=torch.int64)
    mesh = DeviceMesh(mesh_device_type(), grid.reshape(data, model),
                      mesh_dim_names=tuple(axes))
    return mesh, info


def reshard(tree, spec_tree, mesh):
    """Every leaf of ``tree`` placed on ``mesh`` with its spec tuple
    (:func:`~repro_torch.distributed.sharding.device_put`; the spec tree
    has ``tree``'s structure as a prefix, a spec is taken whole, never
    descended into).  Returns a tree of DTensor leaves."""
    specs = tree_lib.prefix_leaves(tree, spec_tree)
    return tree_lib.unflatten_like(
        tree, [device_put(x, NamedSharding(mesh, s))
               for x, s in zip(tree_lib.leaves(tree), specs)])
