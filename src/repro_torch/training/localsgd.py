"""LSS-gated LocalSGD — the paper's decision procedure gating gradient sync
(port of ``repro/training/localsgd.py``).

Data-parallel replicas take local optimizer steps and only synchronize
parameters when the *global average* replica-drift statistic crosses a
threshold.  Deciding "has the global mean crossed tau?" with neighbor-local
traffic is exactly the paper's thresholding problem:

  * peer = replica (rank group along the data axes);
  * input x_i = [ ||theta_i - anchor||^2 ]  (drift since last sync);
  * regions = the Voronoi pair of 1-D options {tau/2, 3tau/2}, whose cell
    boundary is exactly tau — a halfspace threshold as source selection;
  * replicas exchange LSS messages with ring / torus neighbors only
    (:class:`~repro_torch.core.monitor.MeshMonitor`); by Thm. 6 (which
    tolerates the torus's cycles) every replica's f(vec(S_i)) converges to
    the region of the *global mean* drift.

Representation: JAX stacks the replicas on a leading dim R of every leaf;
here every rank holds *its* replica, the ``(1, ...)`` row ``mon.peer`` of
JAX's stacked tree (:func:`stack_params` builds the stack on one process,
:meth:`LocalSGDGate.gather` assembles it from the ranks in JAX's peer
order).  Ranks that differ only on mesh axes outside the monitor's hold
the same replica.  The local optimizer step is the single-device train
step on the rank's own rows; on trigger every leaf becomes the mean over
the replicas (accumulated in float32 and cast back, as ``jnp.mean``) and
the drift anchor resets.

Traffic between triggers: the monitor's (d+1)-float neighbor messages,
plus one all-reduced int a gate call — ``jnp.any`` over every peer's
decision is the same cross-replica reduction in JAX's program.  JAX's
``cond`` branches on the device; here the flag is read on the host.  The
sync is one float32 all-reduce a leaf over the monitor axes' groups (an
axis at a time), staged through pinned host memory on gloo
(:func:`repro_torch.distributed.collective.all_reduce`).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from .. import tree as tree_lib
from ..core import monitor as monitor_lib
from ..core import wvs
from ..distributed import collective

__all__ = ["LocalSGDConfig", "LocalSGDState", "LocalSGDGate",
           "make_localsgd", "stack_params"]


class LocalSGDConfig(NamedTuple):
    tau: float = 1.0  # drift budget on mean ||theta - anchor||^2
    monitor_rounds: int = 2
    beta: float = 1e-3


class LocalSGDState(NamedTuple):
    anchor: Any  # this rank's replica's params at the last sync
    mon: monitor_lib.MonitorState
    syncs: torch.Tensor  # cumulative sync count, int32 0-d


def stack_params(params, n_replicas: int):
    """Broadcast a param tree to a replica-stacked tree (leading dim R), on
    one process; a rank's replica is row ``mon.peer`` of it."""
    return tree_lib.map(
        lambda p: p[None].expand(n_replicas, *p.shape).clone(), params)


class LocalSGDGate:
    """The gate of :func:`make_localsgd`, its parts callable alone (the
    card's smoke run times them).  Every rank of the mesh builds it and
    calls it in step with the others."""

    def __init__(self, mesh, data_axes, cfg: LocalSGDConfig, device=None):
        names = tuple(mesh.mesh_dim_names)
        axes = tuple(a for a in data_axes if a in names) or (names[0],)
        self.axes = axes[:2]
        self.cfg = cfg
        centers = [[cfg.tau * 0.5], [cfg.tau * 1.5]]  # boundary = tau
        self.mon = monitor_lib.MeshMonitor(
            mesh, self.axes, centers,
            monitor_lib.MonitorConfig(beta=cfg.beta,
                                      rounds=cfg.monitor_rounds),
            device=device)
        self.R = self.mon.n_peers
        self._groups = tuple(mesh.get_group(a) for a in self.axes)

    def init(self, params) -> LocalSGDState:
        return LocalSGDState(
            anchor=tree_lib.map(torch.clone, params),
            mon=self.mon.init(),
            syncs=torch.zeros((), dtype=torch.int32, device=self.mon.device))

    def drift(self, params, anchor) -> wvs.WV:
        """This replica's statistic: Σ over leaves (JAX's order) of
        Σ (p − a)² in float32, as a ``(1, 1)`` vector of weight 1."""
        d2 = sum((p.float() - a.float()).square().reshape(1, -1).sum(1)
                 for p, a in zip(tree_lib.leaves(params),
                                 tree_lib.leaves(anchor)))
        d2 = d2.to(self.mon.device)
        return wvs.from_vector(d2[:, None], torch.ones_like(d2))

    def _all_reduce(self, buf, op):
        for g in self._groups:
            buf = collective.all_reduce(buf, op, g)
        return buf

    def any_drifted(self, decision) -> bool:
        """JAX's ``jnp.any(decision == 1)`` over every peer: one int
        all-reduced (MAX) over the monitor axes."""
        flag = (decision == 1).any().to(torch.int32).reshape(1)
        return bool(self._all_reduce(flag, dist.ReduceOp.MAX).item())

    def sync(self, params):
        """Every leaf the mean over the replicas (float32 sum over the
        monitor axes, / R, cast back to the leaf's dtype)."""
        def mean(p):
            total = self._all_reduce(p.float(), dist.ReduceOp.SUM)
            return (total / self.R).to(p.dtype)

        return tree_lib.map(mean, params)

    def __call__(self, state: LocalSGDState, params):
        """``(state', params', synced)``: one monitor step on this
        replica's drift; on a sync the averaged params, a fresh anchor and
        monitor state.  ``synced`` is a Python bool."""
        stat = self.drift(params, state.anchor)
        mon_state, decision, _ = self.mon.step(state.mon, stat)
        # decision==1 -> "drifted"; ANY makes the convergence transient safe
        # (peers agree at quiescence; mid-flight a drifted peer must win).
        if not self.any_drifted(decision):
            return (LocalSGDState(state.anchor, mon_state, state.syncs),
                    params, False)
        params2 = self.sync(params)
        # Reset the monitor's message state after a sync: drift restarts
        # from zero and stale balances would bias the next decision window.
        return (LocalSGDState(anchor=tree_lib.map(torch.clone, params2),
                              mon=self.mon.init_like(mon_state),
                              syncs=state.syncs + 1),
                params2, True)

    def gather(self, tree):
        """Every peer's ``(1, ...)`` rows of ``tree`` -> JAX's ``(R, ...)``
        stacked tree, in JAX's peer order, on every rank (a collective over
        the default group)."""
        return tree_lib.map(self.mon.gather, tree)


def make_localsgd(mesh, data_axes, cfg: LocalSGDConfig, device=None):
    """Returns ``(init_fn, gate_fn)`` over this rank's replica's params.

    gate_fn(state, params) -> (state', params', synced bool).  ``gate_fn``
    is a :class:`LocalSGDGate` (``gate_fn.mon``, ``gate_fn.gather``).
    """
    gate = LocalSGDGate(mesh, data_axes, cfg, device)
    return gate.init, gate
