"""Graph partitioning for the sharded simulation engine (a copy of
``repro/engine/partition.py``, which is numpy-only; importing it would
import the JAX package, and this module imports neither).

A :class:`Partition` renumbers the ``n`` peers of a :class:`~repro_torch.
core.topology.Topology` into ``S`` equal-size blocks of ``B = ceil(n / S)`` rows
(the tail of each block is padding: no peer, ``alive = False``, all slots
masked).  Peer ``old`` lives at flattened position ``p = new_of_old[old]``,
i.e. row ``p % B`` of shard ``p // B``.

The default partitioner is BFS region growing (a greedy edge-cut
heuristic): each shard is grown breadth-first from an unassigned seed until
it reaches capacity, so neighboring peers land in the same shard wherever
possible.  On the paper's topologies this keeps most edges shard-local —
grids partition into contiguous patches, Chord rings into arcs — which is
what makes the halo exchange small.  ``method="stride"`` (raw id stripes)
is kept as the worst-case baseline.

:class:`ShardedTopo` adds the per-shard local structure: for every slot the
owning shard and row of its target peer, plus the halo tables that drive
the cross-shard exchange (see :mod:`repro_torch.engine.exchange`).  Every valid
edge slot is either *intra* (both endpoints in one shard) or appears in
exactly one ``(src shard, dst shard)`` halo entry — the invariant
``tests/test_engine.py`` and ``tests/test_torch_engine.py`` assert.

All construction is host-side numpy (topologies are inputs); the engine
copies the arrays to torch tensors on its device once.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np

from ..core import topology

__all__ = ["Partition", "HaloTables", "ShardedTopo", "make_partition",
           "shard_topology", "repair_sharded_topo", "migrate_rows",
           "bfs_assignment", "stride_assignment"]


class Partition(NamedTuple):
    num_shards: int  # S
    block: int  # B = rows per shard (including padding)
    assignment: np.ndarray  # (n,)  shard id of each original peer
    new_of_old: np.ndarray  # (n,)  flattened position p = shard*B + row
    old_of_new: np.ndarray  # (S*B,) original peer id, -1 on padding rows
    sizes: np.ndarray  # (S,) occupied rows per shard


class HaloTables(NamedTuple):
    """Static cross-shard routing tables, padded to a common width H.

    ``send_*`` are src-major: entry ``[s, t, h]`` is the h-th boundary slot
    ``(row, slot)`` of shard ``s`` whose target lives in shard ``t``.
    ``recv_*`` are dst-major: entry ``[t, s, h]`` is where that same message
    lands — local ``(row, slot)`` inside shard ``t``.  The shared ``h``
    ordering is what lets the exchange be a plain (src, dst)-transpose of a
    dense ``(S, S, H)`` buffer.
    """

    send_row: np.ndarray  # int32 (S, S, H)
    send_slot: np.ndarray  # int32 (S, S, H)
    send_ok: np.ndarray  # bool  (S, S, H) — entry is real, not padding
    recv_row: np.ndarray  # int32 (S, S, H)
    recv_slot: np.ndarray  # int32 (S, S, H)


class ShardedTopo(NamedTuple):
    part: Partition
    D: int
    n: int
    num_edges: int
    # Local structure, (S, B, D), in shard layout:
    mask: np.ndarray  # bool — slot validity (padding rows all False)
    rev: np.ndarray  # int32 — reverse slot at the target (unchanged)
    tgt_shard: np.ndarray  # int32 — shard owning the slot's target peer
    tgt_row: np.ndarray  # int32 — target's row within tgt_shard
    tgt_pos: np.ndarray  # int32 — flattened target position (shard*B + row)
    intra: np.ndarray  # bool — valid slot with target in the same shard
    halo: HaloTables
    halo_width: int  # H

    @property
    def num_shards(self) -> int:
        return self.part.num_shards

    @property
    def block(self) -> int:
        return self.part.block

    def cut_edges(self) -> int:
        """Number of undirected edges crossing shards (halo pairs / 2)."""
        return int(np.sum(self.mask & ~self.intra)) // 2


def stride_assignment(topo: topology.Topology, num_shards: int) -> np.ndarray:
    """Baseline: contiguous id stripes (ignores the edge structure)."""
    block = -(-topo.n // num_shards)
    return (np.arange(topo.n) // block).astype(np.int32)


def bfs_assignment(topo: topology.Topology, num_shards: int) -> np.ndarray:
    """Greedy BFS region growing with per-shard capacity ``ceil(n/S)``.

    Grows one shard at a time breadth-first from the lowest-numbered
    unassigned peer; when the frontier empties (disconnected remainder) a
    fresh seed is picked.  Deterministic: neighbors expand in slot order.
    """
    n, cap = topo.n, -(-topo.n // num_shards)
    assignment = np.full(n, -1, dtype=np.int32)
    nbr, mask = topo.nbr, topo.mask
    next_seed = 0
    for s in range(num_shards):
        size = 0
        queue: collections.deque[int] = collections.deque()
        while size < cap:
            if not queue:
                while next_seed < n and assignment[next_seed] >= 0:
                    next_seed += 1
                if next_seed == n:
                    break
                assignment[next_seed] = s
                queue.append(next_seed)
                size += 1
                continue
            i = queue.popleft()
            for j in nbr[i][mask[i]]:
                if size == cap:
                    break
                if assignment[j] < 0:
                    assignment[j] = s
                    queue.append(int(j))
                    size += 1
    assert np.all(assignment >= 0)
    return assignment


def make_partition(topo: topology.Topology, num_shards: int,
                   method: str = "bfs") -> Partition:
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    if num_shards > topo.n:
        raise ValueError(f"num_shards={num_shards} > n={topo.n}")
    if method == "bfs":
        assignment = bfs_assignment(topo, num_shards)
    elif method == "stride":
        assignment = stride_assignment(topo, num_shards)
    else:
        raise KeyError(f"unknown partition method {method!r}")

    block = -(-topo.n // num_shards)
    sizes = np.bincount(assignment, minlength=num_shards)
    if sizes.max() > block:
        raise AssertionError("partitioner exceeded shard capacity")
    # Stable renumbering: peers of shard s keep their relative order.
    order = np.argsort(assignment, kind="stable")
    row = np.concatenate([np.arange(sz) for sz in sizes]) if topo.n else \
        np.zeros(0, np.int64)
    new_of_old = np.empty(topo.n, dtype=np.int64)
    new_of_old[order] = assignment[order] * block + row
    old_of_new = np.full(num_shards * block, -1, dtype=np.int64)
    old_of_new[new_of_old] = np.arange(topo.n)
    return Partition(num_shards, block, assignment.astype(np.int32),
                     new_of_old, old_of_new, sizes.astype(np.int64))


def shard_topology(topo: topology.Topology, part: Partition,
                   halo_width: int | None = None,
                   halo_slack: float = 1.0) -> ShardedTopo:
    """Build the per-shard local tables + halo routing for ``part``.

    ``halo_width`` pads the halo tables to a fixed width ``H`` larger than
    strictly needed (error if smaller); ``halo_slack`` > 1 instead derives
    the padding from the required width (``ceil(needed * slack) + 2``).
    Dynamic-membership consumers pass headroom one way or the other so
    edge churn that grows a shard pair's boundary stays a data-only
    update (same shapes) until the headroom is exhausted —
    see :func:`repair_sharded_topo` for the regrow path.
    """
    S, B, D = part.num_shards, part.block, topo.max_deg
    occ = part.old_of_new >= 0  # (S*B,)
    src = np.where(occ, part.old_of_new, 0)
    mask = np.where(occ[:, None], topo.mask[src], False)  # (S*B, D)
    rev = np.where(mask, topo.rev[src], 0).astype(np.int32)
    tgt_pos = np.where(mask, part.new_of_old[topo.nbr[src]], 0)
    tgt_shard = (tgt_pos // B).astype(np.int32)
    tgt_row = (tgt_pos % B).astype(np.int32)
    own_shard = (np.arange(S * B) // B)[:, None]
    intra = mask & (tgt_shard == own_shard)

    # Halo tables.  For each ordered (s, t != s): boundary slots of s with
    # target in t, in (row, slot) order; H pads all pairs to one width.
    rows3 = lambda a: a.reshape(S, B, D)
    m3, ts3, tr3, rv3 = rows3(mask), rows3(tgt_shard), rows3(tgt_row), \
        rows3(rev)
    cross3 = rows3(mask & ~intra)
    counts = np.zeros((S, S), dtype=np.int64)
    entries: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
    for s in range(S):
        rr, kk = np.nonzero(cross3[s])  # already sorted by (row, slot)
        for t in np.unique(ts3[s][rr, kk]) if rr.size else ():
            sel = ts3[s][rr, kk] == t
            entries[(s, int(t))] = (rr[sel], kk[sel])
            counts[s, int(t)] = int(sel.sum())
    needed = max(1, int(counts.max()) if counts.size else 1)
    if halo_width is not None and halo_width < needed:
        raise ValueError(f"halo_width={halo_width} < required {needed}")
    if halo_width is not None:
        H = int(halo_width)
    elif halo_slack > 1.0:
        H = int(np.ceil(needed * halo_slack)) + 2
    else:
        H = needed
    send_row = np.zeros((S, S, H), np.int32)
    send_slot = np.zeros((S, S, H), np.int32)
    send_ok = np.zeros((S, S, H), bool)
    recv_row = np.zeros((S, S, H), np.int32)
    recv_slot = np.zeros((S, S, H), np.int32)
    for (s, t), (rr, kk) in entries.items():
        h = rr.size
        send_row[s, t, :h] = rr
        send_slot[s, t, :h] = kk
        send_ok[s, t, :h] = True
        recv_row[t, s, :h] = tr3[s][rr, kk]
        recv_slot[t, s, :h] = rv3[s][rr, kk]

    return ShardedTopo(
        part=part, D=D, n=topo.n, num_edges=topo.num_edges,
        mask=m3, rev=rv3, tgt_shard=ts3, tgt_row=tr3,
        tgt_pos=rows3(tgt_pos.astype(np.int64)).astype(np.int32),
        intra=rows3(intra),
        halo=HaloTables(send_row, send_slot, send_ok, recv_row, recv_slot),
        halo_width=H,
    )


def migrate_rows(old_part: Partition,
                 new_part: Partition) -> tuple[np.ndarray, np.ndarray]:
    """Row-migration map between two partitions: ``(src, dst)``.

    ``src[i]``/``dst[i]`` are the flattened positions (``shard*B + row``)
    of original peer id ``i`` under the old and new partitions, for every
    id the old partition covers.  Re-partition *epochs* (capacity regrow,
    edge-cut rebalance) move state with one gather/scatter across this
    map: ``new_flat[dst] = old_flat[src]``, every new-layout position not
    in ``dst`` filled with the fresh-init value — which makes the
    migrated state bitwise-equal to re-placing the same logical rows into
    a fresh :func:`shard_topology` layout (:meth:`repro_torch.engine.
    ShardedLSS.place_lss_state` is that placement).

    The new partition may span a larger capacity (regrow): rows beyond
    the old capacity have no source and stay at their init values.
    """
    n1 = old_part.new_of_old.shape[0]
    if new_part.new_of_old.shape[0] < n1:
        raise ValueError(
            f"new partition covers {new_part.new_of_old.shape[0]} rows "
            f"< old {n1}; migration cannot drop peers")
    return (old_part.new_of_old.copy().astype(np.int64),
            new_part.new_of_old[:n1].copy().astype(np.int64))


def _rebuild_halo_pair(halo: HaloTables, s: int, t: int, mask3, ts3, tr3,
                       rv3) -> int:
    """Recompute halo entries for the ordered pair (s, t) in place.

    Scans shard ``s``'s cross slots targeting ``t`` in the same canonical
    (row, slot) order the full build uses, so a repaired table is
    bitwise-identical to a from-scratch :func:`shard_topology` at the same
    width.  Returns the entry count (caller checks it against H).
    """
    sel = mask3[s] & (ts3[s] == t)  # t != s, so these are cross slots
    rr, kk = np.nonzero(sel)
    h = rr.size
    H = halo.send_row.shape[-1]
    if h > H:
        return h  # overflow: caller regrows, then retries
    for a in (halo.send_row[s, t], halo.send_slot[s, t]):
        a[:] = 0
    halo.send_ok[s, t, :] = False
    halo.recv_row[t, s, :] = 0
    halo.recv_slot[t, s, :] = 0
    halo.send_row[s, t, :h] = rr
    halo.send_slot[s, t, :h] = kk
    halo.send_ok[s, t, :h] = True
    halo.recv_row[t, s, :h] = tr3[s][rr, kk]
    halo.recv_slot[t, s, :h] = rv3[s][rr, kk]
    return h


def repair_sharded_topo(st: ShardedTopo, topo, changed_rows,
                        halo_slack: float = 1.25) -> ShardedTopo:
    """Incrementally repair ``st`` after a membership delta.

    ``topo`` is the mutated (Dyn)topology — SAME capacity/partition as the
    one ``st`` was built from — and ``changed_rows`` the original peer ids
    whose adjacency rows changed.  Only those rows' local tables and the
    halo rows of their shards' affected (src, dst) pairs are recomputed;
    everything else is carried over untouched.  Cost is
    ``O(|changed rows| * D + |affected shard pairs| * B * D)`` versus the
    full build's ``O(S*B*D + n)`` — and, because every array keeps its
    shape (halo width included, as long as the headroom holds), the
    repaired tables are a data-only swap for the engine.

    When a shard pair outgrows the halo width the tables are rebuilt at
    ``ceil(needed * halo_slack) + 2`` — a shape change of the engine's
    tables; pad ``shard_topology(..., halo_width=...)`` with
    headroom up front to make this rare.

    The result is bitwise-identical to
    ``shard_topology(topo, st.part, halo_width=st.halo_width)``.
    """
    part = st.part
    S, B, D = part.num_shards, part.block, st.D
    rows = np.unique(np.asarray(changed_rows, np.int64))
    if rows.size == 0:
        return st
    pos = part.new_of_old[rows]  # flattened positions of changed rows
    own_shard = (pos // B).astype(np.int32)
    own_row = (pos % B).astype(np.int32)

    mask3 = st.mask.copy()
    rv3 = st.rev.copy()
    ts3 = st.tgt_shard.copy()
    tr3 = st.tgt_row.copy()
    tp3 = st.tgt_pos.copy()
    intra3 = st.intra.copy()

    # Affected (s, t) halo pairs: every cross target of the changed rows,
    # BEFORE and after the edit (removed edges vanish from the new tables
    # but their stale halo entries must still be rebuilt away).
    pairs = set()
    for s, r in zip(own_shard, own_row):
        old_cross = st.mask[s, r] & (st.tgt_shard[s, r] != s)
        for t in np.unique(st.tgt_shard[s, r][old_cross]):
            pairs.add((int(s), int(t)))

    # Local tables for the changed rows (same formulas as the full build).
    m = topo.mask[rows]  # (R, D)
    rv = np.where(m, topo.rev[rows], 0).astype(np.int32)
    tp = np.where(m, part.new_of_old[topo.nbr[rows]], 0)
    ts = (tp // B).astype(np.int32)
    tr = (tp % B).astype(np.int32)
    it = m & (ts == own_shard[:, None])
    mask3[own_shard, own_row] = m
    rv3[own_shard, own_row] = rv
    ts3[own_shard, own_row] = ts
    tr3[own_shard, own_row] = tr
    tp3[own_shard, own_row] = tp.astype(np.int32)
    intra3[own_shard, own_row] = it
    for i, s in enumerate(own_shard):
        new_cross = m[i] & (ts[i] != s)
        for t in np.unique(ts[i][new_cross]):
            pairs.add((int(s), int(t)))

    halo = HaloTables(*(a.copy() for a in st.halo))
    H = st.halo_width
    needed = 0
    for s, t in sorted(pairs):
        needed = max(needed,
                     _rebuild_halo_pair(halo, s, t, mask3, ts3, tr3, rv3))
        needed = max(needed,
                     _rebuild_halo_pair(halo, t, s, mask3, ts3, tr3, rv3))
    if needed > H:
        # Regrow with headroom: widen every pair's rows, then re-repair.
        H2 = int(np.ceil(needed * halo_slack)) + 2
        grown = HaloTables(*(
            np.zeros(a.shape[:2] + (H2,), a.dtype) for a in halo))
        for old, new in zip(st.halo, grown):
            new[..., :st.halo_width] = old
        halo = grown
        for s, t in sorted(pairs):
            _rebuild_halo_pair(halo, s, t, mask3, ts3, tr3, rv3)
            _rebuild_halo_pair(halo, t, s, mask3, ts3, tr3, rv3)
        H = H2

    return st._replace(
        num_edges=topo.num_edges, mask=mask3, rev=rv3, tgt_shard=ts3,
        tgt_row=tr3, tgt_pos=tp3, intra=intra3, halo=halo, halo_width=H)
