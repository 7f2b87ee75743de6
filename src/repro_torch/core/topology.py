"""Network topologies used by the paper's experiments (Sec. VI-A).

A copy of the JAX package's numpy-only ``core/topology.py``: importing
that module would import the JAX package, and this one imports neither.
The generators draw from numpy's RNG in the same order, so both packages
build identical ``nbr``/``mask``/``rev`` arrays from the same arguments.

Three generators, matching the paper's three target systems:

* ``barabasi_albert`` — unstructured P2P / Internet router graph [1].
* ``chord`` — structured P2P; the *symmetric* Chord variant (bidirectional
  finger links) the paper uses, degree ~ 2 log2(n).
* ``grid`` — wireless sensor network: peers on a bi-dimensional grid
  (optionally a torus).

All generators return a :class:`Topology`: a padded fixed-degree adjacency
``nbr[n, D]`` with a validity ``mask`` and a reverse-slot map ``rev`` such
that ``nbr[nbr[i, k], rev[i, k]] == i`` for every valid slot.  The reverse
map makes message delivery a single gather: the message peer ``i`` posts on
its slot ``k`` lands in slot ``rev[i, k]`` of peer ``nbr[i, k]``.

Generation is host-side numpy (topologies are inputs); the simulator
copies the arrays to torch tensors on its device once.

:class:`DynTopology` is the *dynamic-membership* form: the same padded
arrays, but capacity-padded (``n_cap`` peer rows, ``deg_cap`` degree
slots), mutable through versioned host-side ops (``add_peer`` /
``remove_peer`` / ``add_edge`` / ``remove_edge``), and journaled so
downstream consumers (the core simulator's :class:`~repro_torch.core.lss.
TopoArrays`, the engine's halo tables, the service) can catch up
incrementally.  Because membership edits within capacity only change
array *data* — never shapes — every jitted consumer keeps its compiled
program across joins/leaves.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["Topology", "DynTopology", "TopoEvent", "CapacityError",
           "barabasi_albert", "chord", "grid", "from_edges"]


class CapacityError(ValueError):
    """A mutation hit a capacity wall (``n_cap`` rows or ``deg_cap``
    slots).  Subclasses ``ValueError`` so existing callers keep working;
    the service control plane catches it specifically to drive the
    auto-regrow path (:meth:`DynTopology.grow`) instead of failing."""


class Topology(NamedTuple):
    nbr: np.ndarray  # int32 (n, D) neighbor ids; padding slots hold 0
    mask: np.ndarray  # bool  (n, D) slot validity
    rev: np.ndarray  # int32 (n, D) slot of i in nbr[nbr[i,k]]
    n: int
    max_deg: int

    @property
    def degrees(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    @property
    def num_edges(self) -> int:
        return int(self.mask.sum()) // 2

    def drop_peers(self, dead: np.ndarray) -> "Topology":
        """Churn: peer failure = failure of all its links (Sec. II-B).

        Freed slots are scrubbed back to the padding convention
        (``nbr``/``rev`` = 0): leaving them pointing at dead peers is
        harmless to the masked delivery math but violates the invariant
        :meth:`validate` checks, and stale ids resurface as real bugs the
        moment a slot is reused (dynamic membership) or the arrays are
        consumed positionally (halo table construction).
        """
        dead = np.asarray(dead)
        alive_slot = self.mask & ~dead[self.nbr]
        alive_slot[dead] = False
        return self._replace(
            mask=alive_slot,
            nbr=np.where(alive_slot, self.nbr, 0).astype(np.int32),
            rev=np.where(alive_slot, self.rev, 0).astype(np.int32),
        )

    def validate(self) -> None:
        """Check the padded-adjacency invariants; raises ``ValueError``.

        * shapes/dtypes: ``nbr``/``mask``/``rev`` all ``(n, max_deg)``;
        * range: valid-slot neighbor ids in ``[0, n)``, no self loops,
          no duplicate neighbors within a row;
        * involution: ``nbr[nbr[i,k], rev[i,k]] == i`` and
          ``rev[nbr[i,k], rev[i,k]] == k`` for every valid slot;
        * symmetry: the reverse slot of every valid slot is itself valid
          (``mask[nbr[i,k], rev[i,k]]``);
        * padding: masked slots hold ``nbr == 0`` and ``rev == 0``.
        """
        n, D = self.n, self.max_deg
        problems: List[str] = []
        for name, arr in (("nbr", self.nbr), ("mask", self.mask),
                          ("rev", self.rev)):
            if arr.shape != (n, D):
                problems.append(f"{name}.shape={arr.shape} != ({n}, {D})")
        if problems:
            raise ValueError("; ".join(problems))
        ii, kk = np.nonzero(self.mask)
        jj, rr = self.nbr[ii, kk], self.rev[ii, kk]
        if ii.size:
            id_ok = rev_ok = True
            if jj.min() < 0 or jj.max() >= n:
                problems.append("neighbor id out of range")
                id_ok = False
            if np.any(jj == ii):
                problems.append("self loop")
            if rr.min() < 0 or rr.max() >= D:
                problems.append("reverse slot out of range")
                rev_ok = False
            if id_ok and rev_ok:
                # Only index with (jj, rr) once both are in range — the
                # checker must report, not crash with an IndexError.
                if not np.all(self.mask[jj, rr]):
                    problems.append("asymmetric link (reverse slot masked)")
                if not np.all(self.nbr[jj, rr] == ii):
                    problems.append("broken involution (nbr[j, rev] != i)")
                if not np.all(self.rev[jj, rr] == kk):
                    problems.append("broken involution (rev[j, rev] != k)")
            # Duplicate neighbors within a row.
            flat = ii.astype(np.int64) * n + jj
            if np.unique(flat).size != flat.size:
                problems.append("duplicate neighbor in a row")
        pad = ~self.mask
        if np.any(self.nbr[pad] != 0) or np.any(self.rev[pad] != 0):
            problems.append("padding slots hold stale nbr/rev entries")
        if problems:
            raise ValueError("invalid topology: " + "; ".join(problems))


def from_edges(n: int, edges, max_deg: int | None = None) -> Topology:
    """Build a padded Topology from an undirected edge list."""
    adj = [[] for _ in range(n)]
    seen = set()
    for a, b in edges:
        a, b = int(a), int(b)
        if a == b:
            continue
        key = (min(a, b), max(a, b))
        if key in seen:
            continue
        seen.add(key)
        adj[a].append(b)
        adj[b].append(a)
    deg = np.array([len(a) for a in adj], dtype=np.int32)
    D = int(deg.max()) if max_deg is None else max_deg
    if deg.max() > D:
        raise ValueError(f"max_deg={D} < actual max degree {deg.max()}")
    nbr = np.zeros((n, D), dtype=np.int32)
    mask = np.zeros((n, D), dtype=bool)
    slot_of = {}  # (i, j) -> slot k with nbr[i, k] == j
    for i, neigh in enumerate(adj):
        for k, j in enumerate(neigh):
            nbr[i, k] = j
            mask[i, k] = True
            slot_of[(i, j)] = k
    rev = np.zeros((n, D), dtype=np.int32)
    for (i, j), k in slot_of.items():
        rev[i, k] = slot_of[(j, i)]
    return Topology(nbr=nbr, mask=mask, rev=rev, n=n, max_deg=D)


class TopoEvent(NamedTuple):
    """One journaled membership mutation.

    ``kind`` is ``"join"``/``"leave"`` (peer ``a``; ``b``/slots unused) or
    ``"link"``/``"unlink"`` (edge ``a``–``b`` occupying slot ``slot_a`` of
    ``a``'s row and ``slot_b`` of ``b``'s row).  The slot coordinates are
    what lets state owners scrub the messaging state of a reused slot
    without rebuilding anything.
    """

    kind: str
    a: int
    b: int = -1
    slot_a: int = -1
    slot_b: int = -1


class DynTopology:
    """Versioned, capacity-padded, mutable network topology.

    Arrays have fixed shape ``(n_cap, deg_cap)``; at most ``n_cap`` peers
    may be present at once and each may hold at most ``deg_cap`` links.
    Mutations are host-side, incremental (only the touched rows change),
    keep the ``nbr``/``mask``/``rev`` involution invariant, bump
    :attr:`version`, and append a :class:`TopoEvent` to the journal.
    Consumers remember the last version they applied and ask
    :meth:`events_since` / :meth:`changed_rows_since` to catch up — the
    engine uses the row set to repair its halo tables incrementally, the
    service uses the slot coordinates to scrub per-slot messaging state.

    Capacity is a hard wall by design: exceeding it raises, and the
    *regrow* path is :meth:`grow`, which returns a copy with larger
    capacity.  Growing changes array shapes, so every jitted consumer
    recompiles once — that is the documented price of outgrowing the
    padding, paid explicitly rather than silently per mutation.

    The class duck-types as a :class:`Topology` for every read-only
    consumer (``nbr``/``mask``/``rev``/``n``/``max_deg``/``degrees``/
    ``num_edges``), with ``n == n_cap``: absent rows are just isolated
    peers the caller keeps dead (``alive=False``) in simulator state.
    """

    def __init__(self, nbr: np.ndarray, mask: np.ndarray, rev: np.ndarray,
                 present: np.ndarray, version: int = 0,
                 strict: bool = False):
        self.nbr = np.ascontiguousarray(nbr, dtype=np.int32)
        self.mask = np.ascontiguousarray(mask, dtype=bool)
        self.rev = np.ascontiguousarray(rev, dtype=np.int32)
        self.present = np.ascontiguousarray(present, dtype=bool)
        self.version = int(version)
        # strict=True re-validates the FULL invariant set after every
        # mutation op (O(n*D) — tests/debugging); strict=False keeps the
        # per-op O(deg_cap) local checks only.
        self.strict = bool(strict)
        self._journal: List[Tuple[int, TopoEvent]] = []
        # Versions at/below this are no longer reconstructible from the
        # journal; consumers older than it must do a full refresh.
        self._journal_floor = int(version)

    # -- construction ------------------------------------------------------
    @classmethod
    def from_topology(cls, topo: Topology, n_cap: Optional[int] = None,
                      deg_cap: Optional[int] = None,
                      strict: bool = False) -> "DynTopology":
        """Wrap an immutable topology, padding to the given capacities."""
        n_cap = topo.n if n_cap is None else int(n_cap)
        deg_cap = topo.max_deg if deg_cap is None else int(deg_cap)
        if n_cap < topo.n:
            raise ValueError(f"n_cap={n_cap} < n={topo.n}")
        if deg_cap < topo.max_deg:
            raise ValueError(f"deg_cap={deg_cap} < max_deg={topo.max_deg}")
        nbr = np.zeros((n_cap, deg_cap), np.int32)
        mask = np.zeros((n_cap, deg_cap), bool)
        rev = np.zeros((n_cap, deg_cap), np.int32)
        nbr[:topo.n, :topo.max_deg] = topo.nbr
        mask[:topo.n, :topo.max_deg] = topo.mask
        rev[:topo.n, :topo.max_deg] = topo.rev
        present = np.zeros((n_cap,), bool)
        present[:topo.n] = True
        return cls(nbr, mask, rev, present, strict=strict)

    @classmethod
    def from_edges(cls, n: int, edges, n_cap: Optional[int] = None,
                   deg_cap: Optional[int] = None,
                   strict: bool = False) -> "DynTopology":
        return cls.from_topology(from_edges(n, edges, max_deg=deg_cap),
                                 n_cap=n_cap, deg_cap=deg_cap, strict=strict)

    # -- Topology duck-typing ----------------------------------------------
    @property
    def n(self) -> int:  # capacity: simulator arrays are sized by this
        return self.nbr.shape[0]

    @property
    def n_cap(self) -> int:
        return self.nbr.shape[0]

    @property
    def max_deg(self) -> int:
        return self.nbr.shape[1]

    @property
    def deg_cap(self) -> int:
        return self.nbr.shape[1]

    @property
    def num_present(self) -> int:
        return int(self.present.sum())

    @property
    def degrees(self) -> np.ndarray:
        return self.mask.sum(axis=1)

    @property
    def num_edges(self) -> int:
        return int(self.mask.sum()) // 2

    def snapshot(self) -> Topology:
        """An immutable :class:`Topology` copy of the current graph."""
        return Topology(nbr=self.nbr.copy(), mask=self.mask.copy(),
                        rev=self.rev.copy(), n=self.n_cap,
                        max_deg=self.deg_cap)

    def edge_list(self) -> List[Tuple[int, int]]:
        """Current undirected edges as sorted ``(i < j)`` pairs."""
        ii, kk = np.nonzero(self.mask)
        jj = self.nbr[ii, kk]
        sel = ii < jj
        return sorted(zip(ii[sel].tolist(), jj[sel].tolist()))

    def has_edge(self, i: int, j: int) -> bool:
        return bool(np.any(self.mask[i] & (self.nbr[i] == j)))

    # -- journal -----------------------------------------------------------
    def _log(self, ev: TopoEvent) -> None:
        self.version += 1
        self._journal.append((self.version, ev))
        if ev.kind in ("link", "unlink"):
            # Local invariant check on the touched slots (O(deg_cap)).
            for p, k in ((ev.a, ev.slot_a), (ev.b, ev.slot_b)):
                if self.mask[p, k]:
                    q, r = self.nbr[p, k], self.rev[p, k]
                    assert self.mask[q, r] and self.nbr[q, r] == p \
                        and self.rev[q, r] == k, "involution broken"
                else:
                    assert self.nbr[p, k] == 0 and self.rev[p, k] == 0, \
                        "freed slot not scrubbed"
        if self.strict:
            self.validate()

    def events_since(self, version: int) -> List[TopoEvent]:
        """Mutations after ``version``, oldest first.

        Raises ``ValueError`` when ``version`` predates the journal floor
        (the caller compacted past it) — the consumer must then do a full
        refresh instead of an incremental catch-up.
        """
        if version >= self.version:
            return []
        if version < self._journal_floor:
            raise ValueError(
                f"version {version} predates the journal floor "
                f"{self._journal_floor}; do a full refresh")
        return [ev for v, ev in self._journal if v > version]

    def changed_rows_since(self, version: int) -> np.ndarray:
        """Sorted unique peer rows whose adjacency changed after
        ``version`` (join/leave events touch only simulator ``alive``
        state, not the adjacency, so they do not contribute rows)."""
        rows = set()
        for ev in self.events_since(version):
            if ev.kind in ("link", "unlink"):
                rows.add(ev.a)
                rows.add(ev.b)
        return np.array(sorted(rows), dtype=np.int64)

    def compact(self, applied_version: int) -> None:
        """Drop journal entries at/below ``applied_version`` (call once
        every consumer has caught up to it)."""
        self._journal = [(v, e) for v, e in self._journal
                         if v > applied_version]
        self._journal_floor = max(self._journal_floor, applied_version)

    # -- mutation ops ------------------------------------------------------
    def add_peer(self, peer: Optional[int] = None,
                 edges: Iterable[int] = ()) -> int:
        """Join: claim a free row (lowest-numbered, or ``peer`` if given),
        optionally linking it to ``edges``; returns the peer id."""
        if peer is None:
            free = np.flatnonzero(~self.present)
            if free.size == 0:
                raise CapacityError(
                    f"peer capacity n_cap={self.n_cap} exhausted; "
                    "use grow(n_cap=...) to regrow (recompiles consumers)")
            peer = int(free[0])
        else:
            peer = int(peer)
            if not 0 <= peer < self.n_cap:
                raise ValueError(f"peer {peer} outside capacity "
                                 f"[0, {self.n_cap})")
            if self.present[peer]:
                raise ValueError(f"peer {peer} already present")
        self.present[peer] = True
        self._log(TopoEvent("join", peer))
        for j in edges:
            self.add_edge(peer, int(j))
        return peer

    def remove_peer(self, peer: int) -> List[int]:
        """Leave: drop all of the peer's links, then the peer itself
        (churn = failure of all links, Sec. II-B).  Returns the former
        neighbor ids."""
        peer = int(peer)
        if not self.present[peer]:
            raise ValueError(f"peer {peer} not present")
        neighbors = [int(j) for j in self.nbr[peer][self.mask[peer]]]
        for j in neighbors:
            self.remove_edge(peer, j)
        self.present[peer] = False
        self._log(TopoEvent("leave", peer))
        return neighbors

    def add_edge(self, i: int, j: int) -> Tuple[int, int]:
        """Link ``i``–``j``; returns the claimed ``(slot_i, slot_j)``."""
        i, j = int(i), int(j)
        if i == j:
            raise ValueError("self loops are not allowed")
        for p in (i, j):
            if not (0 <= p < self.n_cap and self.present[p]):
                raise ValueError(f"peer {p} not present")
        if self.has_edge(i, j):
            raise ValueError(f"edge ({i}, {j}) already exists")
        free_i = np.flatnonzero(~self.mask[i])
        free_j = np.flatnonzero(~self.mask[j])
        if free_i.size == 0 or free_j.size == 0:
            full = i if free_i.size == 0 else j
            raise CapacityError(
                f"peer {full} at degree capacity deg_cap={self.deg_cap}; "
                "use grow(deg_cap=...) to regrow (recompiles consumers)")
        ki, kj = int(free_i[0]), int(free_j[0])
        self.nbr[i, ki], self.rev[i, ki], self.mask[i, ki] = j, kj, True
        self.nbr[j, kj], self.rev[j, kj], self.mask[j, kj] = i, ki, True
        self._log(TopoEvent("link", i, j, ki, kj))
        return ki, kj

    def remove_edge(self, i: int, j: int) -> Tuple[int, int]:
        """Unlink ``i``–``j``; returns the freed ``(slot_i, slot_j)``.
        Freed slots are scrubbed back to the padding convention."""
        i, j = int(i), int(j)
        hit = np.flatnonzero(self.mask[i] & (self.nbr[i] == j))
        if hit.size == 0:
            raise ValueError(f"no edge ({i}, {j})")
        ki = int(hit[0])
        kj = int(self.rev[i, ki])
        for p, k in ((i, ki), (j, kj)):
            self.nbr[p, k], self.rev[p, k], self.mask[p, k] = 0, 0, False
        self._log(TopoEvent("unlink", i, j, ki, kj))
        return ki, kj

    # -- regrow + rebuild --------------------------------------------------
    def grow(self, n_cap: Optional[int] = None,
             deg_cap: Optional[int] = None) -> "DynTopology":
        """Copy with larger capacity (shape change: consumers recompile
        once).  The :attr:`version` carries over so downstream bookkeeping
        (telemetry ``topo_version``, applied-version cursors) stays
        monotone across a regrow; the journal does NOT carry over — the
        grown topology's journal floor starts at the carried version, so
        any consumer holding an older cursor gets the documented
        "do a full refresh" error instead of silently missing events."""
        n2 = self.n_cap if n_cap is None else int(n_cap)
        d2 = self.deg_cap if deg_cap is None else int(deg_cap)
        if n2 < self.n_cap or d2 < self.deg_cap:
            raise ValueError("grow() cannot shrink capacity")
        nbr = np.zeros((n2, d2), np.int32)
        mask = np.zeros((n2, d2), bool)
        rev = np.zeros((n2, d2), np.int32)
        nbr[:self.n_cap, :self.deg_cap] = self.nbr
        mask[:self.n_cap, :self.deg_cap] = self.mask
        rev[:self.n_cap, :self.deg_cap] = self.rev
        present = np.zeros((n2,), bool)
        present[:self.n_cap] = self.present
        return DynTopology(nbr, mask, rev, present, version=self.version,
                           strict=self.strict)

    def rebuild(self) -> "DynTopology":
        """From-scratch :func:`from_edges` build of the current graph at
        the same capacity (the parity-test reference: same edges, packed
        slot layout)."""
        fresh = DynTopology.from_edges(self.n_cap, self.edge_list(),
                                       deg_cap=self.deg_cap)
        fresh.present = self.present.copy()
        return fresh

    # -- invariants --------------------------------------------------------
    def validate(self) -> None:
        """:meth:`Topology.validate` plus the membership invariants:
        only present peers may hold links."""
        Topology(nbr=self.nbr, mask=self.mask, rev=self.rev, n=self.n_cap,
                 max_deg=self.deg_cap).validate()
        linked = self.mask.any(axis=1)
        bad = np.flatnonzero(linked & ~self.present)
        if bad.size:
            raise ValueError(
                f"absent peers hold links: {bad[:8].tolist()}")


def barabasi_albert(n: int, m: int = 2, seed: int = 0) -> Topology:
    """Barabási–Albert preferential attachment: each new node adds m edges."""
    if n <= m:
        raise ValueError("n must exceed m")
    rng = np.random.default_rng(seed)
    edges = []
    # Start from a star over the first m+1 nodes (connected seed graph).
    targets = list(range(m))
    repeated: list[int] = []  # node id repeated once per incident edge
    for i in range(m, n):
        chosen = set()
        for t in targets:
            if t != i:
                chosen.add(t)
        for t in chosen:
            edges.append((i, t))
            repeated.extend((i, t))
        # Preferential sample of m targets for the next node.
        if repeated:
            idx = rng.integers(0, len(repeated), size=m)
            targets = [repeated[j] for j in idx]
        else:
            targets = list(range(m))
    return from_edges(n, edges)


def chord(n: int, seed: int = 0) -> Topology:
    """Symmetric Chord: ring successors + bidirectional fingers at 2^j."""
    del seed  # deterministic
    edges = []
    b = max(1, int(np.ceil(np.log2(n))))
    for i in range(n):
        edges.append((i, (i + 1) % n))
        for j in range(1, b):
            f = (i + (1 << j)) % n
            if f != i:
                edges.append((i, f))
    return from_edges(n, edges)


def grid(n: int, wrap: bool = False, diag: bool = False) -> Topology:
    """Peers at locations of a bi-dimensional grid (optionally torus)."""
    side = int(np.round(np.sqrt(n)))
    if side * side != n:
        raise ValueError(f"grid needs a square n, got {n}")
    edges = []
    deltas = [(0, 1), (1, 0)]
    if diag:
        deltas += [(1, 1), (1, -1)]

    def nid(r, c):
        return r * side + c

    for r in range(side):
        for c in range(side):
            for dr, dc in deltas:
                rr, cc = r + dr, c + dc
                if wrap:
                    edges.append((nid(r, c), nid(rr % side, cc % side)))
                elif 0 <= rr < side and 0 <= cc < side:
                    edges.append((nid(r, c), nid(rr, cc)))
    return from_edges(n, edges)
