"""``membership_churn.py::_bench_serve``'s events: before a tick,
``events_per_tick`` draws from ``ops`` in equal parts (a join linked to
one present peer, a leave, an unlink), queued through the service's
membership calls.  ``{"gen": "membership", "events_per_tick": 8, "ops":
["join+link", "leave", "unlink"], "every": 1}``: on every ``every``-th
tick, counting the warm tick as 0.  Needs the traffic's ``dynamic``
topology.

The generator keeps its own books of the present peers, the edges, the
degrees and the free rows, so it names the row each join claims (the
lowest free one) before the service answers, and counts a join that lands
elsewhere as ``membership_mismatch``."""

import heapq

import numpy as np

from bench.harness.gen import rng_for
from bench.reference import lss as ref

STAGE = 0  # a boundary applies the membership events first, then updates


class Feed:
    def __init__(self, spec, world, seed):
        self.rng = rng_for(seed, 30)
        self.ops = tuple(spec["ops"])
        self.count = int(spec["events_per_tick"])
        self.every = int(spec.get("every", 1))
        self.deg_cap = int(world.deg_cap)
        self.present = list(range(world.n))
        self.pos = {p: i for i, p in enumerate(self.present)}
        self.adj = {p: set() for p in range(world.n)}
        self.edges, self.eidx = [], {}
        for a, b in np.asarray(world.edges).tolist():
            self._add_edge(a, b)
        self.free = list(range(world.n, world.rows))
        heapq.heapify(self.free)
        self.join_mismatch = 0  # joins whose row was not the predicted one
        self.refused = 0  # events the service refused

    def _add_edge(self, a, b):
        key = (min(a, b), max(a, b))
        self.eidx[key] = len(self.edges)
        self.edges.append(key)
        self.adj[a].add(b)
        self.adj[b].add(a)

    def _drop_edge(self, key):
        i = self.eidx.pop(key)
        last = self.edges.pop()
        if last != key:
            self.edges[i] = last
            self.eidx[last] = i
        self.adj[key[0]].discard(key[1])
        self.adj[key[1]].discard(key[0])

    def _pick(self):
        return self.present[self.rng.integers(len(self.present))]

    def _drop_present(self, p):
        i = self.pos.pop(p)
        last = self.present.pop()
        if last != p:
            self.present[i] = last
            self.pos[last] = i

    def _join(self, svc):
        partner = self._pick()
        if len(self.adj[partner]) >= self.deg_cap:
            return []
        want = self.free[0]
        row = int(svc.join_peer())
        if row == want:
            heapq.heappop(self.free)
        else:
            self.join_mismatch += 1
            self.free.remove(row)
            heapq.heapify(self.free)
        self.pos[row] = len(self.present)
        self.present.append(row)
        self.adj[row] = set()
        events = [("join", row)]
        try:
            svc.link_peers(row, partner)
        except (ValueError, RuntimeError):
            self.refused += 1
            return events
        self._add_edge(row, partner)
        return events + [("link", row, partner)]

    def _emit(self, svc):
        """Queue one drawn event; returns the events it queued ([] if the
        draw was refused)."""
        op = self.ops[self.rng.integers(len(self.ops))]
        try:
            if op == "join+link":
                return self._join(svc)
            if op == "leave":
                p = self._pick()
                svc.leave_peer(p)
                for j in list(self.adj[p]):
                    self._drop_edge((min(p, j), max(p, j)))
                self._drop_present(p)
                heapq.heappush(self.free, p)
                return [("leave", p)]
            if not self.edges:
                return []
            key = self.edges[self.rng.integers(len(self.edges))]
            svc.unlink_peers(*key)
            self._drop_edge(key)
            return [("unlink", key[0], key[1])]
        except (ValueError, RuntimeError):
            self.refused += 1
            return []

    def __call__(self, svc, tick):
        """Draw until ``events_per_tick`` draws were queued (at most eight
        times as many draws); returns the events in queue order."""
        if tick % self.every:
            return []
        out, taken, draws = [], 0, 0
        while taken < self.count and draws < 8 * self.count:
            draws += 1
            evs = self._emit(svc)
            if evs:
                out += evs
                taken += 1
        return out

    def report(self):
        return {"refused": self.refused, "present": len(self.present),
                "edges": len(self.edges)}

    def faults(self):
        return {"membership_mismatch": self.join_mismatch}


def edit(entry, book):
    """The reference's side of one tick's events: the slot book advanced,
    and the state edit (touched slots scrubbed, leaves dead, joins alive
    with the knowledge-init input)."""
    touched, joins, leaves = book.apply(entry)
    return lambda st: ref.apply_membership(st, touched, joins, leaves)
