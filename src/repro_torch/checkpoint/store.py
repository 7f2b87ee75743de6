"""Checkpoint store implementation (numpy-npz backed, no external deps).

Port of ``repro/checkpoint/store.py``, in JAX's layout, so a checkpoint
written by one package loads into the other: the leaves of the tree are
visited in JAX's order under JAX's ``keystr`` names
(:mod:`repro_torch.tree`), stored as ``leaf_<i>`` of ``shard_0.npz`` with
``manifest.json`` beside them.

numpy has no bfloat16 (and the port does not depend on ``ml_dtypes``): a
bfloat16 leaf is stored as its uint16 bit pattern with ``"bfloat16"`` in
the manifest, and restored bitwise.  Such a leaf does not load into JAX,
whose ``load`` would convert the integers by value; float32 and integer
leaves load either way.  A bfloat16 leaf JAX wrote (raw two-byte records
to a reader without ``ml_dtypes``) loads here bitwise.

Across ranks (an initialised process group of more than one rank) a save
is a collective: every rank calls it, and every rank gathers each DTensor
leaf's whole value to the host
(:func:`repro_torch.distributed.sharding.full_tensor`); rank 0 alone
writes (a plain tensor leaf is rank 0's value), and ``save`` ends at a
barrier, so :func:`latest_step` is true on every rank when it returns.
``save_async`` takes the snapshot in line (the collective) and writes in
rank 0's thread; the other ranks start no thread.  ``load(...,
shardings=)`` places each leaf on its ``NamedSharding``: every rank reads
the file and keeps its own shard.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree as tree_lib
from ..distributed import sharding

__all__ = ["save", "save_async", "load", "latest_step", "wait_pending"]

_PENDING: list[threading.Thread] = []
_FINALIZE = threading.Lock()  # serializes rename + LATEST + GC across threads
_BF16 = "bfloat16"


def _ranks() -> tuple[int, int]:
    """(this rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _host(leaf):
    """(numpy copy of ``leaf`` on the host, its manifest dtype); a DTensor
    is gathered whole first (a collective)."""
    if isinstance(leaf, torch.Tensor):
        if isinstance(leaf, DTensor):
            leaf = sharding.full_tensor(leaf, device="cpu")
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        a = t.numpy()
    else:
        a = np.array(leaf)
    return a, str(a.dtype)


def _snapshot(tree):
    """Names, host copies and dtypes of every leaf: the copy is made now,
    so a later in-place update of the tree does not reach the writer."""
    names, leaves = tree_lib.leaves_with_names(tree)
    host = [_host(x) for x in leaves]
    return names, [a for a, _ in host], [d for _, d in host]


def save(ckpt_dir, step: int, tree: Any, max_keep: int = 3):
    """Synchronous atomic save (across ranks: a collective, rank 0
    writes, all leave together)."""
    snap = _snapshot(tree)
    rank, world = _ranks()
    if rank == 0:
        _write(pathlib.Path(ckpt_dir), step, *snap, max_keep)
    if world > 1:
        dist.barrier()


def save_async(ckpt_dir, step: int, tree: Any, max_keep: int = 3):
    """Snapshot to host RAM now; write in a daemon thread (across ranks:
    the snapshot is a collective, rank 0's thread writes, the others
    return None)."""
    args = (pathlib.Path(ckpt_dir), step, *_snapshot(tree), max_keep)
    if _ranks()[0] != 0:
        return None
    t = threading.Thread(target=_write, args=args, daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


def _write(root: pathlib.Path, step: int, names, host_leaves, dtypes,
           max_keep):
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {
        "step": step,
        "leaves": [
            {"name": n, "shape": list(a.shape), "dtype": d}
            for n, a, d in zip(names, host_leaves, dtypes)
        ],
    }
    np.savez(tmp / "shard_0.npz", **{f"leaf_{i}": a
                                     for i, a in enumerate(host_leaves)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    os.sync()
    with _FINALIZE:
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        latest = root / "LATEST"
        cur = int(latest.read_text()) if latest.exists() else -1
        if step > cur:  # concurrent async saves finish out of order
            tmp_latest = root / f"LATEST.tmp{step}"
            tmp_latest.write_text(str(step))
            tmp_latest.rename(latest)
        # GC old checkpoints (never the one LATEST points to).
        kept = sorted(p for p in root.glob("step_????????") if p.is_dir())
        for p in kept[:-max_keep]:
            shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    f = pathlib.Path(ckpt_dir) / "LATEST"
    if not f.exists():
        return None
    return int(f.read_text().strip())


def _device(like) -> torch.device:
    """Where a leaf like ``like`` lives (a DTensor: its local shard)."""
    if isinstance(like, DTensor):
        return like.to_local().device
    return like.device


def _tensor(a: np.ndarray, dtype: str, like, sh=None) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on its device; with a
    ``NamedSharding`` ``sh``, this rank's shard of it as a DTensor."""
    a = np.ascontiguousarray(a).reshape(a.shape)  # 0-d stays 0-d
    if dtype == _BF16:  # uint16 bits (or JAX's raw two-byte records)
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if sh is not None:
        return sharding.device_put(t.to(like.dtype), sh, _device(like))
    return t.to(device=like.device, dtype=like.dtype)


def load(ckpt_dir, step: int, like: Any, shardings: Any = None):
    """Restore into the structure of ``like``: each leaf on the device and
    in the dtype of the matching leaf of ``like`` (a ``ParamTree`` comes
    back as a new ``ParamTree``).

    ``shardings`` may be a tree of
    :class:`~repro_torch.distributed.sharding.NamedSharding` matching
    ``like`` — each leaf is placed with its sharding (a DTensor holding
    this rank's shard, on the device of ``like``'s leaf), which is how a
    checkpoint written on mesh A restores onto mesh B (elastic restart).
    """
    root = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((root / "manifest.json").read_text())
    dtypes = [leaf["dtype"] for leaf in manifest["leaves"]]
    flat_like = tree_lib.leaves(like)
    with np.load(root / "shard_0.npz") as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    if len(flat_like) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, target has "
                         f"{len(flat_like)}")
    flat_sh = (tree_lib.prefix_leaves(like, shardings)
               if shardings is not None else [None] * len(leaves))
    return tree_lib.unflatten_like(
        like, [_tensor(a, d, l, sh) for a, d, l, sh in zip(
            leaves, dtypes, flat_like, flat_sh)])
