"""The paper's algorithm with peers as processes (port of
``repro/core/monitor.py``, the hardware adaptation).

Peers = ranks of a ``torch.distributed`` device mesh; edges = ring links
along the chosen mesh axes; message passing = point-to-point sends
(``batch_isend_irecv``) in each axis's process group.  Each rank
contributes a statistic vector (grad-norm^2, loss, step-time, ...) with
weight 1; LSS maintains the rank's status S_i; the output is
``f(vec(S_i))`` — the region of the *global average* statistic, computed
with **neighbor-local traffic only** (no all-reduce, no global barrier
chain).

Topology: a ring over one axis (D = 2 slots) or a 2-D torus over two axes
(D = 4).  A torus has cycles — which is exactly why the paper's new
stopping rule (and not the older cycle-free ones) is required here.

Rounds are bulk-synchronous (one bidirectional exchange per axis per
round); a peer whose stopping rule holds sends a *masked* (ignored)
payload — its previous out-message, so the bytes still move — and the
monitor reports both physical and *effective* message counts, the latter
matching the paper's accounting.

JAX runs one program over all devices (``shard_map``) and returns global
``(n_peers, ...)`` arrays; here every rank runs :meth:`MeshMonitor.step`
on its own ``(1, ...)`` rows, and :meth:`MeshMonitor.gather` assembles the
global arrays in JAX's peer order (row-major over ``axis_names``).  Ranks
that differ only on mesh axes outside ``axis_names`` are replicas of one
peer.  On a gloo group with CUDA tensors the messages are staged through
pinned host memory.  The update math is the simulator's
(:mod:`repro_torch.core.stopping` / :mod:`repro_torch.core.correction`),
with one row a rank.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..distributed import collective
from . import correction, regions as regions_lib, stopping, wvs

__all__ = ["MonitorConfig", "MonitorState", "MeshMonitor"]


class MonitorConfig(NamedTuple):
    beta: float = 1e-3
    rounds: int = 1  # LSS rounds per .step() call
    eps: float = 1e-9


class MonitorState(NamedTuple):
    out_m: torch.Tensor  # (1, D, d) — this rank's row
    out_c: torch.Tensor  # (1, D)
    in_m: torch.Tensor
    in_c: torch.Tensor
    eff_sends: torch.Tensor  # (1,) cumulative effective (unmasked) sends
    phys_sends: torch.Tensor  # (1,) cumulative physical sends


class MeshMonitor:
    """LSS threshold monitor over one or two mesh axes.

    Args:
      mesh: a ``torch.distributed.device_mesh.DeviceMesh`` with named axes
        spanning the default process group; every rank constructs the
        monitor and calls :meth:`step` in step with the others.
      axis_names: 1 axis -> ring (D=2); 2 axes -> 2-D torus (D=4).
      centers: (k, d) Voronoi option points (region family of Sec. V).
      cfg: MonitorConfig.
      device: where this rank's rows live; None is CUDA (raising without a
        card).
    """

    def __init__(self, mesh, axis_names: Sequence[str], centers,
                 cfg: MonitorConfig = MonitorConfig(), device=None):
        if len(axis_names) not in (1, 2):
            raise ValueError("monitor runs on 1 (ring) or 2 (torus) axes")
        self.mesh = mesh
        self.axes = tuple(axis_names)
        self.device = resolve_device(device)
        self.centers = torch.as_tensor(centers, dtype=torch.float32,
                                       device=self.device)
        self.cfg = cfg
        self.sizes = tuple(collective.axis_size(mesh, a) for a in self.axes)
        self.n_peers = int(np.prod(self.sizes))
        self.D = 2 * len(self.axes)
        self.d = int(self.centers.shape[1])
        # Degenerate axes (size 1) have no distinct neighbors: mask them out.
        slot_ax = []
        for ax_i, _ in enumerate(self.sizes):
            slot_ax += [(ax_i, +1), (ax_i, -1)]
        self._slots = slot_ax
        self._slot_live = np.array(
            [self.sizes[ax] > 1 for ax, _ in slot_ax], dtype=bool)
        self._live = torch.as_tensor(self._slot_live,
                                     device=self.device)[None, :]
        self._groups = tuple(mesh.get_group(a) for a in self.axes)
        # Global ranks along each axis, in coordinate order.
        self._ranks = tuple(dist.get_process_group_ranks(g)
                            for g in self._groups)
        self.coords = tuple(int(mesh.get_local_rank(a)) for a in self.axes)
        self.peer = int(np.ravel_multi_index(self.coords, self.sizes))
        self._peer_ranks = self._ranks_in_peer_order()

    def _ranks_in_peer_order(self) -> torch.Tensor:
        """The global rank holding each peer (row-major over
        ``axis_names``), among the ranks that share this rank's
        coordinates on the other mesh axes."""
        names = tuple(self.mesh.mesh_dim_names)
        at = tuple(slice(None) if n in self.axes
                   else int(self.mesh.get_local_rank(n)) for n in names)
        sub = self.mesh.mesh[at]
        kept = [n for n in names if n in self.axes]
        sub = sub.permute(*[kept.index(a) for a in self.axes])
        return sub.reshape(-1).to(device=self.device, dtype=torch.int64)

    # -- state ------------------------------------------------------------
    def init(self, dtype=torch.float32) -> MonitorState:
        """This rank's zeroed ``(1, ...)`` rows."""
        D, d = self.D, self.d

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return MonitorState(out_m=z(1, D, d), out_c=z(1, D),
                            in_m=z(1, D, d), in_c=z(1, D),
                            eff_sends=z(1), phys_sends=z(1))

    def init_like(self, state: MonitorState) -> MonitorState:
        """Zeroed state with the same shapes, dtypes and device."""
        return MonitorState(*(torch.zeros_like(a) for a in state))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every peer's ``(1, ...)`` row of ``x`` -> ``(n_peers, ...)``, in
        JAX's peer order, on every rank (a collective over the default
        group: every rank calls it)."""
        rows = collective.all_gather(x)
        return rows[self._peer_ranks]

    # -- one monitor step (possibly several LSS rounds) --------------------
    def step(self, state: MonitorState, stat: wvs.WV):
        """Run ``cfg.rounds`` LSS rounds with this rank's statistic
        (``m`` (1, d), ``c`` (1,)).

        Returns (state', decision (1,) int32, s_vec (1, d)).  Every round
        exchanges messages with the ring neighbors on the monitor axes.
        """
        cfg = self.cfg

        def decide(v):
            return regions_lib.decide_voronoi(v, self.centers)

        live = self._live.expand(state.out_c.shape)
        x_m = stat.m.to(self.device)
        x_c = stat.c.to(self.device)

        out_m, out_c = state.out_m, state.out_c
        in_m, in_c = state.in_m, state.in_c
        eff, phys = state.eff_sends, state.phys_sends

        for _ in range(cfg.rounds):
            s = stopping.status(x_m, x_c, out_m, out_c, in_m, in_c, live)
            a = stopping.agreements(out_m, out_c, in_m, in_c)
            viol = stopping.violations_alg1(decide, s, a, live, cfg.eps)
            # Selective correction, do-while unrolled to D iterations
            # (degree is tiny here).
            v = viol
            for _ in range(self.D):
                nm, nc = correction.corrected_messages(
                    s, a, in_m, in_c, v, cfg.beta, cfg.eps)
                om2 = torch.where(v[..., None], nm, out_m)
                oc2 = torch.where(v, nc, out_c)
                s2 = stopping.status(x_m, x_c, om2, oc2, in_m, in_c, live)
                a2 = stopping.agreements(om2, oc2, in_m, in_c)
                w = stopping.violations_alg1(decide, s2, a2, live,
                                             cfg.eps) & ~v
                v = v | w
            send = v & torch.any(viol, dim=1)[:, None]
            nm, nc = correction.corrected_messages(
                s, a, in_m, in_c, send, cfg.beta, cfg.eps)
            out_m = torch.where(send[..., None], nm, out_m)
            out_c = torch.where(send, nc, out_c)
            eff = eff + torch.sum(send, dim=1).to(eff.dtype)
            phys = phys + torch.sum(live, dim=1).to(phys.dtype)
            # Bulk-synchronous exchange: everyone sends; non-senders'
            # payloads are their previous out-message (idempotent at the
            # receiver), i.e. masked traffic.
            in_m, in_c = self._exchange(out_m, out_c)

        s = stopping.status(x_m, x_c, out_m, out_c, in_m, in_c, live)
        s_vec = wvs.vec(s, cfg.eps)
        new_state = MonitorState(out_m, out_c, in_m, in_c, eff, phys)
        return new_state, decide(s_vec), s_vec

    # -- neighbor exchange --------------------------------------------------
    def _exchange(self, send_m, send_c):
        """Swap per-slot messages with the ring neighbors: slot ``k`` =
        (axis, +-1) goes to the neighbor at coordinate +-1 (mod n), which
        stores it in its opposite slot ``k ^ 1``.  One
        ``batch_isend_irecv`` per axis, a tag per slot (on a ring of 2
        both slots go to the same peer)."""
        d = self.d
        payload = torch.cat([send_m, send_c[..., None]], dim=-1)  # (1,D,d+1)
        recv_m = torch.zeros_like(send_m)
        recv_c = torch.zeros_like(send_c)
        for ax_i, group in enumerate(self._groups):
            ops, landed = [], []
            ranks, n, c = (self._ranks[ax_i], self.sizes[ax_i],
                           self.coords[ax_i])
            for k, (ax, sgn) in enumerate(self._slots):
                if ax != ax_i or not self._slot_live[k]:
                    continue
                out = payload[:, k].contiguous()
                through_host = collective.staged(out, group)
                if through_host:
                    out = collective.to_host(out)
                    got = collective.host_buffer(out.shape, out.dtype)
                else:
                    got = torch.empty_like(out)
                ops += [dist.P2POp(dist.isend, out, ranks[(c + sgn) % n],
                                   group=group, tag=k),
                        dist.P2POp(dist.irecv, got, ranks[(c - sgn) % n],
                                   group=group, tag=k)]
                landed.append((k ^ 1, got))
            if not ops:
                continue
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            for opp, got in landed:
                got = got.to(self.device, non_blocking=True)
                recv_m[:, opp] = got[:, :d]
                recv_c[:, opp] = got[:, d]
        return recv_m, recv_c
