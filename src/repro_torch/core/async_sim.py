"""Event-driven asynchronous simulator — the paper's real network model
(a copy of ``repro/core/async_sim.py``: host numpy in both packages).

The simulator in :mod:`repro_torch.core.lss` is cycle-driven (peersim's
model, also used by the paper's experiments).  This module adds an
event-driven simulation with per-message random latencies, so messages can
arrive **out of order** — which is exactly what Alg. 1's sequence numbers
(`seq_i`, `last_j`) guard against, and what a synchronous simulator can
never exercise.  It is host-side numpy (an event heap is inherently
sequential); sizes are test-scale.

Faithful pieces: per-peer state in the paper's (vector, weight) terms
(moment form), the Alg.-1 violation set + selective correction, the ell
timer in *time units*, sequence numbers with stale-message dropping, and
optional i.i.d. message loss.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

import numpy as np

from . import topology

__all__ = ["AsyncLSS"]


@dataclasses.dataclass
class _Peer:
    x_m: np.ndarray  # (d,)
    x_c: float
    out_m: np.ndarray  # (D, d)
    out_c: np.ndarray  # (D,)
    in_m: np.ndarray
    in_c: np.ndarray
    last_seq_in: np.ndarray  # (D,) newest seq seen per slot
    seq: int = 0
    last_send: float = -1e9
    next_wake: float = -1e9  # dedupe pending ell-timer wakes


class AsyncLSS:
    """Asynchronous LSS over a Topology with random message latencies."""

    def __init__(self, topo: topology.Topology, inputs: np.ndarray,
                 centers: np.ndarray, *, beta: float = 1e-3,
                 ell: float = 1.0, mean_latency: float = 1.0,
                 jitter: float = 0.9, drop_rate: float = 0.0, seed: int = 0):
        self.topo = topo
        self.centers = np.asarray(centers, np.float64)
        self.beta, self.ell = beta, ell
        self.mean_latency, self.jitter = mean_latency, jitter
        self.drop_rate = drop_rate
        self.rng = np.random.default_rng(seed)
        n, D = topo.nbr.shape
        d = inputs.shape[1]
        self.peers = [
            _Peer(x_m=inputs[i].astype(np.float64), x_c=1.0,
                  out_m=np.zeros((D, d)), out_c=np.zeros(D),
                  in_m=np.zeros((D, d)), in_c=np.zeros(D),
                  last_seq_in=np.full(D, -1))
            for i in range(n)
        ]
        self.events: list = []  # (time, tiebreak, kind, payload)
        self._counter = itertools.count()
        self.now = 0.0
        self.messages_sent = 0
        self.messages_delivered_stale = 0
        for i in range(n):
            self._schedule(0.0, "wake", i)

    # -- plumbing ---------------------------------------------------------
    def _schedule(self, t, kind, payload):
        heapq.heappush(self.events, (t, next(self._counter), kind, payload))

    def _decide(self, v):
        d2 = ((self.centers - v) ** 2).sum(1)
        return int(np.argmin(d2))

    def _status(self, i):
        p, msk = self.peers[i], self.topo.mask[i]
        s_m = p.x_m + (p.in_m[msk] - p.out_m[msk]).sum(0)
        s_c = p.x_c + (p.in_c[msk] - p.out_c[msk]).sum()
        return s_m, s_c

    def _vec(self, m, c, eps=1e-12):
        return m / c if abs(c) > eps else np.zeros_like(m)

    # -- Alg. 1 -----------------------------------------------------------
    def _violations(self, i):
        p, msk = self.peers[i], self.topo.mask[i]
        s_m, s_c = self._status(i)
        fs = self._decide(self._vec(s_m, s_c))
        bad = []
        for k in np.nonzero(msk)[0]:
            a_m = p.out_m[k] + p.in_m[k]
            a_c = p.out_c[k] + p.in_c[k]
            if abs(a_c) <= 1e-12:
                bad.append(k)
                continue
            if self._decide(self._vec(a_m, a_c)) != fs:
                bad.append(k)
                continue
            sa_c = s_c - a_c
            if abs(sa_c) > 1e-12 and self._decide(
                    self._vec(s_m - a_m, sa_c)) != fs:
                bad.append(k)
        return bad

    def _correct(self, i):
        """Selective correction (the fixed-point-growing V_i of Sec. IV-C2)."""
        p, msk = self.peers[i], self.topo.mask[i]
        v = set(self._violations(i))
        if not v:
            return False
        s_m0, s_c0 = self._status(i)
        a_m0 = p.out_m + p.in_m
        a_c0 = p.out_c + p.in_c
        for _ in range(int(msk.sum()) + 1):
            vs = sorted(v)
            t_m = s_m0 + a_m0[vs].sum(0)
            t_c = s_c0 + a_c0[vs].sum()
            if abs(t_c) <= 1e-12:
                break
            inc = (s_c0 - self.beta) / (2.0 * len(vs))
            new_out_m = p.out_m.copy()
            new_out_c = p.out_c.copy()
            for k in vs:
                w_new = a_c0[k] + inc
                scale = w_new / t_c
                new_out_m[k] = scale * t_m - p.in_m[k]
                new_out_c[k] = scale * t_c - p.in_c[k]
            # recompute violations with the would-be messages
            save = (p.out_m, p.out_c)
            p.out_m, p.out_c = new_out_m, new_out_c
            grew = set(self._violations(i)) - v
            p.out_m, p.out_c = save
            if not grew:
                break
            v |= grew
        # commit + send
        vs = sorted(v)
        t_m = s_m0 + a_m0[vs].sum(0)
        t_c = s_c0 + a_c0[vs].sum()
        if abs(t_c) <= 1e-12:
            return False
        inc = (s_c0 - self.beta) / (2.0 * len(vs))
        for k in vs:
            w_new = a_c0[k] + inc
            scale = w_new / t_c
            p.out_m[k] = scale * t_m - p.in_m[k]
            p.out_c[k] = scale * t_c - p.in_c[k]
            p.seq += 1
            self.messages_sent += 1
            if self.rng.random() >= self.drop_rate:
                lat = self.mean_latency * (
                    1.0 + self.jitter * (2 * self.rng.random() - 1))
                dst = int(self.topo.nbr[i, k])
                dslot = int(self.topo.rev[i, k])
                self._schedule(self.now + lat, "msg",
                               (dst, dslot, p.out_m[k].copy(),
                                float(p.out_c[k]), p.seq))
        p.last_send = self.now
        return True

    # -- driver ------------------------------------------------------------
    def run(self, until: float):
        while self.events and self.events[0][0] <= until:
            self.now, _, kind, payload = heapq.heappop(self.events)
            if kind == "msg":
                dst, dslot, m, c, seq = payload
                p = self.peers[dst]
                if seq < p.last_seq_in[dslot]:
                    self.messages_delivered_stale += 1
                    continue  # Alg. 1: ignore late arrivals
                p.last_seq_in[dslot] = seq
                p.in_m[dslot] = m
                p.in_c[dslot] = c
                self._maybe_act(dst)
            else:  # wake
                self._maybe_act(payload)
        self.now = until

    def _maybe_act(self, i):
        p = self.peers[i]
        if self.now - p.last_send < self.ell:
            # Strictly-future wake (float rounding at exactly
            # last_send + ell would otherwise re-fire at the same time
            # forever) and one pending wake per peer.
            t = max(p.last_send + self.ell, self.now + 1e-9)
            if p.next_wake <= self.now:  # no future wake pending
                p.next_wake = t
                self._schedule(t, "wake", i)
            return
        self._correct(i)

    # -- metrics -----------------------------------------------------------
    def accuracy(self):
        gx = np.mean([p.x_m for p in self.peers], axis=0)
        want = self._decide(gx)
        got = [self._decide(self._vec(*self._status(i)))
               for i in range(len(self.peers))]
        return float(np.mean([g == want for g in got])), want

    def quiescent(self):
        if any(k == "msg" for _, _, k, _ in self.events):
            return False
        return all(not self._violations(i) for i in range(len(self.peers)))
