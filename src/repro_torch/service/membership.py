"""Peer membership events: joins/leaves/rewires at dispatch boundaries.

A copy of the JAX package's numpy-only ``service/membership.py`` on the
port's :mod:`repro_torch.core.topology`: importing that module would
import the JAX package, and this one imports neither.

``sim.run_dynamic`` models membership change as permanent peer death
(churn); a long-lived serving deployment also sees the other direction —
peers *joining* the network, links re-wiring as the overlay heals.  A
:class:`MembershipQueue` queues such events while a dispatch is in
flight; the :class:`~repro_torch.service.service.Service` drains it at
the next inter-dispatch boundary, applies the mutations to its shared
:class:`~repro_torch.core.topology.DynTopology`, refreshes the execution
tables (same shapes within capacity), and edits the per-slot simulator
state:

* **join** — the peer's row comes alive in every query slot with its
  local input set per the paper's knowledge-init rule: the new peer
  knows only its own input (``S_i = X_ii``), all its message slots are
  empty, and the zero-weight-agreement clause of Alg. 1's violation set
  bootstraps its first exchange — so in-flight queries keep their
  convergence guarantees without any global reset.
* **leave** — churn: the peer dies with all its links (Sec. II-B).
* **link / unlink** — edge rewires; freed/claimed degree slots are
  scrubbed so a reused slot never resurrects a stale agreement.

Events are validated eagerly on ``push`` against the topology *plus the
already-queued events* (a join reserves its row immediately), so a bad
event fails at the call site, not mid-boundary.  Validation is O(1) per
event — set indices over the queued edits, never a scan of the queue —
so boundary deltas of 10^2..10^4 events stay linear; the queue-scan
implementation it replaces was quadratic and dominated the boundary cost
at high churn (``benchmarks/membership_churn.py`` tracks this).

Capacity walls surface eagerly as :class:`~repro_torch.core.topology.
CapacityError`: a join beyond ``n_cap``, or a link whose *projected*
endpoint degree (current + queued links - queued unlinks) hits
``deg_cap``.  The projection is conservative — a queued leave of a
neighbor would also free a slot, which it ignores — so the control
plane's auto-regrow may grow slightly early, never too late.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from ..core import topology

__all__ = ["MemberEvent", "MembershipQueue"]


class MemberEvent(NamedTuple):
    kind: str  # "join" | "leave" | "link" | "unlink"
    peer: int
    peer_b: int = -1  # link/unlink second endpoint
    value: Optional[np.ndarray] = None  # join: (d,) initial local vector
    weight: float = 1.0  # join: initial weight


class MembershipQueue:
    """Bounded queue of membership events, drained between dispatches."""

    def __init__(self, dyn: topology.DynTopology, max_pending: int = 10_000):
        self.dyn = dyn
        self.max_pending = max_pending
        self._queue: List[MemberEvent] = []
        # O(1) push-time validation indices over the queued edits — kept
        # in lockstep with _queue, cleared on drain:
        self._pending_joins: Set[int] = set()  # rows claimed by joins
        self._pending_leaves: Set[int] = set()  # rows released by leaves
        self._queued_links: Set[Tuple[int, int]] = set()  # normalized keys
        self._queued_unlinks: Set[Tuple[int, int]] = set()
        self._deg_delta: Dict[int, int] = {}  # net queued degree per peer
        # Lazily-built min-heap of candidate free rows (stale entries are
        # skipped at pop — _will_be_present is the truth): an auto-pick
        # join is O(log n) instead of an O(n_cap) scan per event.
        self._free_heap: Optional[List[int]] = None
        self.applied_events = 0
        # (event, error string) for events that still failed at the
        # boundary (eager validation is best-effort: races with direct
        # DynTopology mutation, or capacity walls that depend on other
        # queued events, surface here instead of killing the drain).
        self.failures: List = []
        # Per-kind breakdown of the most recent drain (joins / leaves /
        # links / unlinks applied + failures) — the service folds it into
        # the membership_drain span attrs, so the causal trace says WHAT
        # a boundary did, not just how long it took.
        self.last_drain_stats: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self._queue)

    def has_pending(self) -> bool:
        """True when a boundary drain would apply any queued event —
        the O(1) probe the service's hot boundary uses to skip the
        drain machinery entirely on quiet ticks."""
        return bool(self._queue)

    def _will_be_present(self, peer: int) -> bool:
        if peer in self._pending_joins:
            return True
        if peer in self._pending_leaves:
            return False
        return bool(self.dyn.present[peer])

    def _check_room(self) -> None:
        if len(self._queue) >= self.max_pending:
            raise RuntimeError(
                f"membership queue full ({self.max_pending} pending events)")

    def rebind(self, dyn: topology.DynTopology) -> None:
        """Point the queue at a regrown topology (the service's regrow
        epoch): queued events and validation state carry over — row ids
        are stable under ``grow()`` — but the cached free-row heap is
        rebuilt, since the new capacity has rows the old one lacked."""
        self.dyn = dyn
        self._free_heap = None

    def projected_degree(self, peer: int) -> int:
        """Current degree plus the net effect of queued links/unlinks.

        Conservative: queued leaves (of the peer's neighbors) would free
        slots too, but tracking that would cost a neighbor scan per
        event; over-estimating only makes a capacity wall fire early.
        """
        return int(self.dyn.mask[peer].sum()) + self._deg_delta.get(peer, 0)

    def _bump_deg(self, i: int, j: int, by: int) -> None:
        for p in (i, j):
            self._deg_delta[p] = self._deg_delta.get(p, 0) + by

    # -- event constructors ------------------------------------------------
    def join(self, peer: Optional[int] = None, value=None,
             weight: float = 1.0) -> int:
        """Queue a join; returns the peer row the join will claim."""
        self._check_room()
        if peer is None:
            if self._free_heap is None:
                self._free_heap = [
                    int(p) for p in np.flatnonzero(~self.dyn.present)
                    if p not in self._pending_joins]
                self._free_heap += list(self._pending_leaves)
                heapq.heapify(self._free_heap)
            avail = None
            while self._free_heap:
                cand = heapq.heappop(self._free_heap)
                if not self._will_be_present(cand):
                    avail = cand
                    break
            if avail is None:
                raise topology.CapacityError(
                    f"peer capacity n_cap={self.dyn.n_cap} exhausted "
                    "(including queued joins); grow the topology")
            peer = avail
        else:
            peer = int(peer)
            if peer < 0:
                raise ValueError(f"peer {peer} must be >= 0")
            if peer >= self.dyn.n_cap:
                # Growable: a larger n_cap would cover this row.
                raise topology.CapacityError(
                    f"peer {peer} outside capacity [0, {self.dyn.n_cap}); "
                    "grow the topology")
            if self._will_be_present(peer):
                raise ValueError(f"peer {peer} already present (or queued)")
        if value is not None:
            value = np.asarray(value, np.float32).reshape(-1)
        self._queue.append(MemberEvent("join", peer, value=value,
                                       weight=float(weight)))
        self._pending_joins.add(peer)
        self._pending_leaves.discard(peer)
        return peer

    def leave(self, peer: int) -> None:
        self._check_room()
        peer = int(peer)
        if not self._will_be_present(peer):
            raise ValueError(f"peer {peer} not present (or already leaving)")
        self._queue.append(MemberEvent("leave", peer))
        self._pending_leaves.add(peer)
        self._pending_joins.discard(peer)
        if self._free_heap is not None:
            heapq.heappush(self._free_heap, peer)

    def link(self, i: int, j: int) -> None:
        self._check_room()
        i, j = int(i), int(j)
        if i == j:
            raise ValueError("self loops are not allowed")
        for p in (i, j):
            if not self._will_be_present(p):
                raise ValueError(f"peer {p} not present (or leaving)")
        key = (min(i, j), max(i, j))
        exists_now = (self.dyn.has_edge(i, j)
                      and i not in self._pending_leaves
                      and j not in self._pending_leaves
                      and key not in self._queued_unlinks)
        if key in self._queued_links or exists_now:
            raise ValueError(f"edge ({i}, {j}) already exists (or queued)")
        for p in (i, j):
            # Joining peers start at degree 0 regardless of current mask.
            deg = (self._deg_delta.get(p, 0) if p in self._pending_joins
                   else self.projected_degree(p))
            if deg >= self.dyn.deg_cap:
                raise topology.CapacityError(
                    f"peer {p} at degree capacity deg_cap="
                    f"{self.dyn.deg_cap} (including queued links); "
                    "grow the topology")
        self._queue.append(MemberEvent("link", i, j))
        self._queued_links.add(key)
        self._queued_unlinks.discard(key)
        self._bump_deg(i, j, +1)

    def unlink(self, i: int, j: int) -> None:
        self._check_room()
        i, j = int(i), int(j)
        key = (min(i, j), max(i, j))
        self._queue.append(MemberEvent("unlink", i, j))
        # The degree projection only moves when this unlink will actually
        # remove an edge: it cancels a queued link, or it is the FIRST
        # unlink of a real edge.  A no-op unlink (absent edge, or a
        # duplicate) must not decrement, or projected_degree would
        # underestimate and the eager capacity wall (and with it the
        # auto-regrow trigger) would be silently bypassed.
        if key in self._queued_links:
            self._queued_links.discard(key)
            self._bump_deg(i, j, -1)
        elif self.dyn.has_edge(i, j) and key not in self._queued_unlinks:
            self._queued_unlinks.add(key)
            self._bump_deg(i, j, -1)
        else:
            self._queued_unlinks.add(key)

    # -- boundary application ---------------------------------------------
    def drain_into(self, dyn: topology.DynTopology) -> dict:
        """Apply every queued event to ``dyn`` in arrival order.

        Returns ``{peer: (value, weight)}`` for the joins, so the service
        can initialize the new peers' local inputs (knowledge-init).
        Leaves implicitly unlink (``remove_peer``); explicit ``unlink`` of
        an edge a leave already tore down is treated as satisfied.

        An event that still fails here (eager validation can be raced by
        direct DynTopology mutation, and capacity walls depend on the
        whole batch) is *dropped and recorded* in :attr:`failures` —
        never allowed to abort the drain, which would silently discard
        every event queued behind it.
        """
        events, self._queue = self._queue, []
        self._pending_joins.clear()
        self._pending_leaves.clear()
        self._queued_links.clear()
        self._queued_unlinks.clear()
        self._deg_delta.clear()
        self._free_heap = None  # present mask changes: rebuild lazily
        join_inits = {}
        stats = {"joins": 0, "leaves": 0, "links": 0, "unlinks": 0,
                 "failures": 0}
        for ev in events:
            try:
                if ev.kind == "join":
                    dyn.add_peer(ev.peer)
                    join_inits[ev.peer] = (ev.value, ev.weight)
                elif ev.kind == "leave":
                    dyn.remove_peer(ev.peer)
                    join_inits.pop(ev.peer, None)
                elif ev.kind == "link":
                    dyn.add_edge(ev.peer, ev.peer_b)
                elif ev.kind == "unlink":
                    if dyn.has_edge(ev.peer, ev.peer_b):
                        dyn.remove_edge(ev.peer, ev.peer_b)
                else:  # pragma: no cover - constructors gate the kinds
                    raise ValueError(
                        f"unknown membership event {ev.kind!r}")
            except ValueError as e:
                self.failures.append((ev, str(e)))
                del self.failures[:-1000]  # bounded record
                stats["failures"] += 1
                continue
            self.applied_events += 1
            stats[ev.kind + "s"] += 1
        self.last_drain_stats = {k: v for k, v in stats.items() if v}
        return join_inits
