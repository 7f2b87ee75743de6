"""Slot tables of the reference, rebuilt from the benchmark's own edge list.

A peer's links occupy its degree slots; ``nbr[i, k]`` is the neighbour on
slot ``k`` of peer ``i``, ``rev[i, k]`` the slot of ``i`` in that
neighbour's row, ``mask`` the valid slots, and free slots hold 0 in
``nbr`` and ``rev``.  :func:`tables_from_edges` packs a fixed graph: each
peer's slots in the order its edges come in the list.  :class:`SlotBook`
keeps them under membership events: a join claims the lowest free row, a
link the lowest free slot of each endpoint, and an unlink or a leave frees
slots back to padding.
"""

from __future__ import annotations

import numpy as np


def tables_from_edges(n, edges, D=None):
    """(nbr, mask, rev) as int32 / bool / int32 (n, D) arrays of the
    undirected ``edges`` ((E, 2) ints, no duplicates, no self loops)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    # Directed in list order: (a, b) then (b, a) for every edge.
    src = np.stack([edges[:, 0], edges[:, 1]], axis=1).reshape(-1)
    dst = np.stack([edges[:, 1], edges[:, 0]], axis=1).reshape(-1)
    order = np.argsort(src, kind="stable")
    deg = np.bincount(src, minlength=n)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.empty_like(src)
    slot[order] = np.arange(src.size) - first[src[order]]
    D = int(deg.max()) if D is None else int(D)
    nbr = np.zeros((n, D), np.int32)
    mask = np.zeros((n, D), bool)
    rev = np.zeros((n, D), np.int32)
    nbr[src, slot] = dst
    mask[src, slot] = True
    # The reverse of directed pair p = (a, b) is its twin p ^ 1 = (b, a).
    twin = np.arange(src.size) ^ 1
    rev[src, slot] = slot[twin]
    return nbr, mask, rev


class SlotBook:
    """Slot tables under joins, leaves, links and unlinks (see module)."""

    def __init__(self, n_cap, edges, n_present, D):
        nbr, mask, rev = tables_from_edges(n_present, edges, D)
        self.nbr = np.zeros((n_cap, D), np.int32)
        self.mask = np.zeros((n_cap, D), bool)
        self.rev = np.zeros((n_cap, D), np.int32)
        self.nbr[:n_present], self.mask[:n_present] = nbr, mask
        self.rev[:n_present] = rev
        self.present = np.zeros(n_cap, bool)
        self.present[:n_present] = True

    def has_edge(self, i, j):
        return bool(np.any(self.mask[i] & (self.nbr[i] == j)))

    def link(self, i, j):
        """Claim the lowest free slot on each side; returns the touched
        (row, slot) pairs."""
        ki = int(np.flatnonzero(~self.mask[i])[0])
        kj = int(np.flatnonzero(~self.mask[j])[0])
        self.nbr[i, ki], self.rev[i, ki], self.mask[i, ki] = j, kj, True
        self.nbr[j, kj], self.rev[j, kj], self.mask[j, kj] = i, ki, True
        return [(i, ki), (j, kj)]

    def unlink(self, i, j):
        ki = int(np.flatnonzero(self.mask[i] & (self.nbr[i] == j))[0])
        kj = int(self.rev[i, ki])
        for p, k in ((i, ki), (j, kj)):
            self.nbr[p, k], self.rev[p, k], self.mask[p, k] = 0, 0, False
        return [(i, ki), (j, kj)]

    def leave(self, p):
        touched = []
        for j in [int(j) for j in self.nbr[p][self.mask[p]]]:
            touched += self.unlink(p, j)
        self.present[p] = False
        return touched

    def join(self, p):
        self.present[p] = True

    def apply(self, events):
        """Apply one boundary's events in order.  Returns the touched
        (row, slot) pairs, the rows that end the boundary joined and those
        that end it gone (the last join or leave of a row wins)."""
        touched, final = [], {}
        for ev in events:
            kind = ev[0]
            if kind == "join":
                self.join(ev[1])
                final[ev[1]] = "join"
            elif kind == "leave":
                touched += self.leave(ev[1])
                final[ev[1]] = "leave"
            elif kind == "link":
                touched += self.link(ev[1], ev[2])
            elif kind == "unlink" and self.has_edge(ev[1], ev[2]):
                touched += self.unlink(ev[1], ev[2])
        joins = [p for p, k in final.items() if k == "join"]
        leaves = [p for p, k in final.items() if k == "leave"]
        return touched, joins, leaves
