"""The service driver: Q query slots, one batched pass per cycle.

Port of ``repro/service/service.py``, on both backends.  Execution
model::

    admit (or queue) / retire --+                +--> telemetry (JSONL)
    membership joins/leaves ----+--> [boundary] -+
    stream updates -------------+
                                         |   ^
                                         v   |
                        one dispatch: a host loop of K cycles, each one
                        batched lss.cycle_impl over the Q query slots
                        (core backend), or one ShardedLSS cycle over the
                        Q x S stacked shard state (engine backend)

All Q queries advance in lockstep.  The JAX service ``vmap``s
``lss.cycle_impl`` (or ``ShardedLSS._cycle_full``) over its slots; here
the slots are the leading axis of one stacked state, with per-slot region
families, ``beta``/``ell``/``eps`` tensors and the active-slot gate, so
every step of a cycle launches its kernel once for all Q tenants.  On the
engine backend (``backend="engine"``) the state is
:class:`~repro_torch.engine.ShardedState` with a leading tenant axis,
``(Q, S, B, ...)``; its per-peer update runs on ``(Q, S*B, ...)`` rows,
the core backend's stacked layout.  Free slots ride along as masked
no-ops that send zero messages.  The observe pass, on the fused suite, is
one Q-batched ``lss_state`` launch (per-peer decisions and violations)
and one Q-batched ``region_decide`` launch over the Q global averages;
its numbers reach the host in one transfer.

The service owns its stacked state and edits slots in place between
dispatches (admit, retire, preempt, resume, ingest, membership);
snapshots are copies.

Built on a :class:`~repro_torch.core.topology.DynTopology`, the service
applies queued membership events
(:class:`~repro_torch.service.membership.MembershipQueue`) at dispatch
boundaries: the topology tables are copied to the device anew (same
shapes within capacity), the message slots that a link or unlink touched
are scrubbed in every tenant, and joining peers start from the paper's
knowledge-init state while in-flight tenants keep converging.  A regrow
epoch (:meth:`Service.grow_capacity`, or ``control.auto_regrow`` at a
capacity wall) pads every slot's state to the grown capacity; on the
engine backend it re-partitions the grown graph and migrates every
slot's state, as a rebalance epoch (:meth:`Service.rebalance_now`, or
``control.rebalance_drift``) does over the current graph.

The control plane (:mod:`repro_torch.service.controlplane`) runs as in
the JAX package: per-tenant SLOs folded into every record, the
admission/preemption scheduler (preempted queries are snapshotted in
the core layout and resume where they stopped, reconciled when membership
moved while they held no slot), SLO-driven queue eviction, the regrow and
rebalance epochs.

With ``ServiceConfig(overlap=True)`` the tick is re-cut around a worker
thread (:mod:`repro_torch.service.overlap`): dispatch K runs on the
service's one worker thread while the main thread drains the membership
queue and prepares the repaired tables for dispatch K+1 (host work only);
then it joins the worker, edits the state and launches dispatch K+1, and
finishes dispatch K's telemetry while K+1 runs.  Records are the
synchronous mode's; only their emission is one tick late
(:meth:`Service.flush` drains the last window).  On the engine backend
the epochs' partition builds can be staged on a background thread
(:class:`~repro_torch.service.overlap.StagedBuild`) and adopted at a later
boundary.  Every method that reads or writes the state between ticks
joins the worker first.

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: ``profile_dispatch``/``profiler_dir``, ``alerts`` and
``audit_every > 0`` (A.7).
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import lss, topology, wvs
from ..kernels import ops as kernel_ops
from ..kernels.suite import resolve_suite
from ..obs import FlightRecorder, Tracker, jit_cache_size
from ..obs import metrics as obs_metrics
from . import query as qmod
from .admission import AdmissionQueue
from .controlplane import (ActiveView, CapacityManager, ControlPlaneConfig,
                           SLOEvictionPolicy, SLOTracker, WaitingView,
                           make_scheduler)
from .ingest import StreamIngest, UpdateBatch
from .membership import MembershipQueue
from .overlap import DoubleBuffer, PendingWindow, StagedBuild
from .registry import QueryRegistry
from .telemetry import TelemetrySink

__all__ = ["ServiceConfig", "Service"]


class ServiceConfig(NamedTuple):
    """Service shape + the structural simulator knobs (the JAX fields).

    ``capacity``/``k_max``/``d`` fix every shape at construction; tenant
    churn then never reshapes.  ``policy``/``drop_rate``/
    ``max_corr_iters`` are structural LSS knobs shared by all slots;
    ``beta``/``ell``/``eps`` are the *defaults* for the per-query knobs
    (each :class:`~repro_torch.service.query.QuerySpec` may override them
    per tenant).  ``admission_queue``/``admission_overflow`` bound the
    admission backpressure queue; ``control`` selects the control-plane
    policies.  ``use_kernels`` picks the kernel suite: ``None`` = the
    CUDA kernels on a CUDA device and the reference formulas on the CPU,
    a bool, or a registered suite name.  ``flight_capacity`` /
    ``flight_dump_dir`` size and place the flight recorder.

    ``backend="engine"`` serves through
    :class:`~repro_torch.engine.ShardedLSS` with ``engine_shards``
    shards, the ``engine_method`` partitioner, ``engine_halo_slack``
    headroom in the halo tables and the ``engine_wire`` halo format
    (``exact``, ``compact``, ``int8``, ``bf16``).

    ``overlap=True`` runs each dispatch on a worker thread beside the next
    boundary's host work; ``tick()`` then returns the previous dispatch's
    records (``[]`` on the first tick) and ``flush()`` the last ones.
    Record content is the synchronous mode's.

    Fields of the JAX twin that select parts not ported yet are kept so
    configurations carry over, and the service raises on them:
    ``profile_dispatch``/``profiler_dir``/``profile_sample_every``,
    ``alerts`` and ``audit_every`` (ROADMAP A.7).
    """

    capacity: int = 64  # Q query slots
    k_max: int = 4  # max Voronoi centers per query
    d: int = 2  # statistic dimensionality
    cycles_per_dispatch: int = 8  # K cycles per dispatch
    policy: str = "selective"
    drop_rate: float = 0.0
    max_corr_iters: int = 0
    beta: float = 1e-3
    ell: int = 1
    eps: float = 1e-9
    backend: str = "core"  # "core" | "engine"
    engine_shards: int = 2  # engine backend: shard count
    engine_method: str = "bfs"  # engine backend: partitioner
    engine_halo_slack: float = 1.5  # halo-width headroom for membership
    engine_wire: str = "exact"  # engine halo wire: exact|compact|int8|bf16
    admission_queue: int = 16  # waiting specs bound (0 = fail fast)
    admission_overflow: str = "reject"  # "reject" | "evict-oldest"
    control: ControlPlaneConfig = ControlPlaneConfig()  # control plane
    use_kernels: Union[bool, str, None] = None  # kernel suite (see above)
    profile_dispatch: bool = False
    profiler_dir: Optional[str] = None
    alerts: Tuple = ()
    flight_capacity: int = 1024  # flight-recorder ring size (records)
    flight_dump_dir: Optional[str] = None  # auto-dump dir (None = manual)
    overlap: bool = False
    profile_sample_every: int = 1
    audit_every: int = 0


def _unported(scfg: ServiceConfig) -> Optional[str]:
    """What of ``scfg`` the port cannot serve yet, with its ROADMAP item,
    or None (either backend, a static topology and a ``DynTopology``
    alike)."""
    if scfg.backend not in ("core", "engine"):
        raise ValueError(f"unknown backend {scfg.backend!r}")
    if scfg.profile_dispatch or scfg.profiler_dir is not None:
        return "profile_dispatch/profiler_dir (ROADMAP A.7)"
    if scfg.alerts:
        return "alerts (ROADMAP A.7)"
    if scfg.audit_every > 0:
        return "audit_every > 0 (the audit plane, ROADMAP A.7)"
    return None


class _Preempted(NamedTuple):
    """A suspended tenant: its spec, its state snapshot, the topology
    version it was suspended at, and the bookkeeping the scheduler ages
    it by."""

    spec: qmod.QuerySpec
    state: lss.LSSState
    topo_version: int  # applied topology version at suspension
    enqueued_dispatch: int  # when it re-entered the waiting pool


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _grow_core_states(states: lss.LSSState, n2: int,
                      D2: int) -> lss.LSSState:
    """Pad core-layout states (leading slot axis or none) to a grown
    capacity.

    New rows and slots start at init values (dead, empty, cold timer),
    which is what a fresh init over the grown topology gives them; the
    counters and each slot's generator carry over.
    """
    n1 = states.alive.shape[-1]
    D1 = states.out_c.shape[-1]
    if (n1, D1) == (n2, D2):
        return states
    lead = tuple(states.alive.shape[:-1])
    d = states.x_m.shape[-1]

    def pad(a, tail, fill):
        out = a.new_full(lead + tail, fill)
        out[tuple(slice(0, s) for s in a.shape)] = a
        return out

    return states._replace(
        out_m=pad(states.out_m, (n2, D2, d), 0.0),
        out_c=pad(states.out_c, (n2, D2), 0.0),
        in_m=pad(states.in_m, (n2, D2, d), 0.0),
        in_c=pad(states.in_c, (n2, D2), 0.0),
        x_m=pad(states.x_m, (n2, d), 0.0),
        x_c=pad(states.x_c, (n2,), 0.0),
        pending=pad(states.pending, (n2, D2), False),
        last_send=pad(states.last_send, (n2,), lss.COLD_TIMER),
        alive=pad(states.alive, (n2,), False))


class _CoreBackend:
    """The query axis as the leading axis of one stacked state."""

    def __init__(self, topo, scfg: ServiceConfig, device):
        self.topo = topo
        self.device = device
        self.ta = lss.TopoArrays.from_topology(topo, device)
        self.suite = resolve_suite(scfg.use_kernels, device)

    def dispatch_info(self) -> dict:
        """What the dispatch runs (mirrors the engine's)."""
        return {"suite": self.suite.name, "fused": self.suite.fused}

    def topo_args(self):
        return self.ta

    def prepare_topology(self, dyn) -> lss.TopoArrays:
        """The host half of a membership drain: a copy of the mutated
        topology's three tables in (pinned, for a CUDA device) host
        memory."""
        host = lss.TopoArrays.from_topology(dyn, "cpu")
        if self.device.type == "cuda":
            host = lss.TopoArrays(*(t.pin_memory() for t in host))
        return host

    def install_topology(self, host: lss.TopoArrays) -> bool:
        """Upload the prepared tables and swap them in (same shapes:
        returns False, no shape changed)."""
        self.ta = lss.TopoArrays(*(t.to(self.device, non_blocking=True)
                                   for t in host))
        return False

    def init_states(self, q: int, d: int, alive=None) -> lss.LSSState:
        """Q padding slots: zero inputs, seed 0, the peers of ``alive``
        (default: every peer) alive."""
        n = self.topo.n
        zeros = wvs.WV(
            torch.zeros((q, n, d), dtype=torch.float32, device=self.device),
            torch.zeros((q, n), dtype=torch.float32, device=self.device))
        return lss.init_state(self.ta, zeros, seed=0, alive=alive)

    def init_slot(self, inputs: wvs.WV, seed: int,
                  alive=None) -> lss.LSSState:
        return lss.init_state(self.ta, inputs, seed=seed, alive=alive)

    def tables(self, params: qmod.QueryParams) -> kernel_ops.SlotTables:
        """The Q packed families with their kernel tables, prepared once
        per dispatch (the reference suite reads only the families)."""
        return kernel_ops.prep_slots(params.regions, params.eps, params.beta)

    def step(self, states, params: qmod.QueryParams, tables, k: int,
             cfg: lss.LSSConfig, topo: lss.TopoArrays):
        """K batched cycles over ``topo`` (the tables captured at launch);
        returns (states', per-slot do-while iterations summed over the K
        cycles)."""
        cfg = cfg._replace(beta=params.beta, ell=params.ell, eps=params.eps)
        iters = torch.zeros(params.active.shape, dtype=torch.int32,
                            device=self.device)
        for _ in range(k):
            states, _, it = lss.cycle_impl(
                states, topo, cfg, None, gate=params.active,
                suite=self.suite, regions=tables, with_stats=True)
            iters = iters + it
        return states, iters

    def metrics(self, states, params: qmod.QueryParams, tables,
                topo: lss.TopoArrays):
        """Per-slot (accuracy, quiescent, want)."""
        acc, quiescent, _, want = lss.metrics_impl(
            states, topo, lambda v: self.suite.decide(v, tables),
            params.eps, suite=self.suite, regions=tables)
        return acc, quiescent, want

    def msgs_device(self, states) -> torch.Tensor:
        """Per-slot sends since the last reset, (Q,), on the device."""
        return states.msgs

    def reset_msgs(self, states):
        return states._replace(msgs=torch.zeros_like(states.msgs))

    def x_moments(self, states):
        return states.x_m, states.x_c, None  # (Q, n, d), (Q, n), identity

    def with_x(self, states, x_m, x_c):
        return states._replace(x_m=x_m, x_c=x_c)

    def _index(self, who) -> torch.Tensor:
        return torch.as_tensor(np.asarray(who), dtype=torch.long,
                               device=self.device)

    def apply_leaves(self, states, who):
        """Mark rows ``who`` dead in every slot, in place."""
        states.alive[:, self._index(who)] = False
        return states

    def apply_joins(self, states, who, m, c):
        """Knowledge-init rows ``who`` in every slot, in place: alive,
        local input ``<m, c>`` ((k, d) and (k,)), cold send timer."""
        idx = self._index(who)
        states.alive[:, idx] = True
        states.x_m[:, idx] = torch.as_tensor(m, dtype=states.x_m.dtype,
                                             device=self.device)
        states.x_c[:, idx] = torch.as_tensor(c, dtype=states.x_c.dtype,
                                             device=self.device)
        states.last_send[:, idx] = lss.COLD_TIMER
        return states

    def clear_slots(self, states, rows, slots):
        """Scrub the ``(row, slot)`` message slots of every tenant in
        place: out/in moments to zero, nothing pending
        (:func:`lss.clear_slots` is the pure form, for one state)."""
        rows, slots = self._index(rows), self._index(slots)
        for f in ("out_m", "out_c", "in_m", "in_c"):
            getattr(states, f)[:, rows, slots] = 0.0
        states.pending[:, rows, slots] = False
        return states

    def snapshot(self, states, slot: int) -> lss.LSSState:
        """A copy of one slot's state (later edits leave it alone)."""
        fields = {f: getattr(states, f)[slot].clone()
                  for f in lss.LSSState._fields if f != "rng"}
        return lss.LSSState(**fields, rng=_copy_generator(states.rng[slot]))

    def restore_slot(self, states, slot: int,
                     snap: lss.LSSState) -> lss.LSSState:
        """Write ``snap`` into slot ``slot`` in place (the exact inverse of
        :meth:`snapshot`)."""
        for f in lss.LSSState._fields:
            if f != "rng":
                getattr(states, f)[slot] = getattr(snap, f)
        rng = list(states.rng)
        rng[slot] = _copy_generator(snap.rng)
        return states._replace(rng=tuple(rng))

    def cut_frac(self) -> Optional[float]:
        return None  # one device, no partition to drift

    def regrow(self, dyn, states, prebuilt=None, catchup_rows=None):
        """Adopt a grown topology and pad every slot's state to it.
        Returns (states', False): ``prebuilt``/``catchup_rows`` are the
        engine backend's staged-epoch protocol, and the core has no
        tables to pre-build (no ``stage_regrow``), so nothing is adopted."""
        self.topo = dyn
        self.ta = lss.TopoArrays.from_topology(dyn, self.device)
        return _grow_core_states(states, dyn.n, dyn.max_deg), False


def _copy_generators(gens: tuple) -> tuple:
    return tuple(_copy_generator(g) for g in gens)


class _EngineBackend:
    """The query axis composed with :class:`ShardedLSS`'s shard axis: one
    :class:`~repro_torch.engine.ShardedState` with a leading tenant axis,
    ``(Q, S, B, ...)``, stepped by the engine's cycle with the tenants'
    knobs, gate and tables as its per-call overrides."""

    def __init__(self, topo, scfg: ServiceConfig, device):
        self.topo = topo
        self.scfg = scfg
        self.device = device
        self.eng = self._build(topo)

    def _build(self, topo):
        from ..engine import EngineConfig, ShardedLSS  # lazy: no cycle

        scfg = self.scfg
        base = lss.LSSConfig(beta=scfg.beta, ell=scfg.ell,
                             drop_rate=scfg.drop_rate, policy=scfg.policy,
                             max_corr_iters=scfg.max_corr_iters, eps=scfg.eps)
        return ShardedLSS(
            topo, torch.zeros((1, scfg.d)), base,
            EngineConfig(num_shards=scfg.engine_shards,
                         cycles_per_dispatch=scfg.cycles_per_dispatch,
                         method=scfg.engine_method,
                         use_kernels=scfg.use_kernels,
                         halo_slack=scfg.engine_halo_slack,
                         wire=scfg.engine_wire),
            device=self.device)

    def dispatch_info(self) -> dict:
        return dict(self.eng.dispatch_info)

    def topo_args(self):
        return self.eng._tables

    def prepare_topology(self, dyn):
        """The host half of a membership drain: the engine's partition
        repair and its tables in host memory
        (:meth:`ShardedLSS.prepare_membership`)."""
        return self.eng.prepare_membership(dyn)

    def install_topology(self, rep) -> bool:
        """Upload and swap in the repaired tables; True when the halo
        width regrew (the dispatch's table shapes changed)."""
        return self.eng.install_membership(rep)

    def init_states(self, q: int, d: int, alive=None):
        """Q padding slots: zero inputs, seed 0, the peers of ``alive``
        (default: every peer) alive."""
        n = self.topo.n
        one = self.eng.init_sync(wvs.WV(
            torch.zeros((n, d), device=self.device),
            torch.zeros((n,), device=self.device)), seed=0, alive=alive)
        return one._replace(
            **{f: getattr(one, f).expand(q, *getattr(one, f).shape).clone()
               for f in one._fields
               if f != "rng" and getattr(one, f) is not None},
            rng=tuple(_copy_generators(one.rng) for _ in range(q)))

    def init_slot(self, inputs: wvs.WV, seed: int, alive=None):
        return self.eng.init_sync(inputs, seed=seed, alive=alive)

    def tables(self, params: qmod.QueryParams) -> kernel_ops.SlotTables:
        """The Q packed families with their kernel tables, prepared once
        per dispatch."""
        return kernel_ops.prep_slots(params.regions, params.eps, params.beta)

    def step(self, states, params: qmod.QueryParams, tables, k: int,
             cfg: lss.LSSConfig, topo):
        """K engine cycles over all Q tenants through ``topo`` (the engine's
        tables captured at launch; each kernel launched once a step for
        all of them); returns (states', per-slot do-while iterations
        summed over the K cycles)."""
        cfg = cfg._replace(beta=params.beta, ell=params.ell, eps=params.eps)
        iters = torch.zeros(params.active.shape, dtype=torch.int32,
                            device=self.device)
        eng = self.eng
        for _ in range(k):
            states, it = eng._cycle_full(
                states, topo, with_stats=True, cfg=cfg,
                gate=params.active, regions=tables)
            iters = iters + it
        return states, iters

    def metrics(self, states, params: qmod.QueryParams, tables, topo):
        """Per-slot (accuracy, quiescent, want); ``topo`` is the engine's
        own installed tables, which change only between dispatches."""
        acc, quiescent, _, want = self.eng._metrics_impl(
            states, params.eps, regions=tables)
        return acc, quiescent, want

    def msgs_device(self, states) -> torch.Tensor:
        """Per-slot sends since the last reset: the (Q, S) per-shard
        counters summed, on the device."""
        return states.msgs.sum(dim=-1)

    def reset_msgs(self, states):
        return states._replace(msgs=torch.zeros_like(states.msgs))

    def x_moments(self, states):
        """The inputs as (Q, S*B, d) / (Q, S*B) rows and the original-id ->
        row permutation ingest writes through."""
        q, d = states.x_m.shape[0], states.x_m.shape[-1]
        return (states.x_m.reshape(q, -1, d), states.x_c.reshape(q, -1),
                self.eng._pos)

    def with_x(self, states, x_m, x_c):
        return states._replace(x_m=x_m.reshape(states.x_m.shape),
                               x_c=x_c.reshape(states.x_c.shape))

    def _rows(self, who) -> torch.Tensor:
        return self.eng._positions(np.asarray(who))

    def apply_leaves(self, states, who):
        """Mark peers ``who`` dead in every slot, in place."""
        q = states.alive.shape[0]
        states.alive.view(q, -1)[:, self._rows(who)] = False
        return states

    def apply_joins(self, states, who, m, c):
        """Knowledge-init peers ``who`` in every slot, in place: alive,
        local input ``<m, c>`` ((k, d) and (k,)), cold send timer."""
        q, d = states.alive.shape[0], states.x_m.shape[-1]
        pos = self._rows(who)
        states.alive.view(q, -1)[:, pos] = True
        states.x_m.view(q, -1, d)[:, pos] = torch.as_tensor(
            m, dtype=states.x_m.dtype, device=self.device)
        states.x_c.view(q, -1)[:, pos] = torch.as_tensor(
            c, dtype=states.x_c.dtype, device=self.device)
        states.last_send.view(q, -1)[:, pos] = lss.COLD_TIMER
        return states

    def clear_slots(self, states, rows, slots):
        """Scrub the ``(peer, slot)`` message slots (and their error
        feedback) of every tenant in place."""
        return self.eng.scrub_slots(states, np.asarray(rows), slots)

    def snapshot(self, states, slot: int) -> lss.LSSState:
        """One slot's state in the core layout (a copy; ``rng`` a copy of
        its shard-0 generator)."""
        one = states._replace(
            **{f: getattr(states, f)[slot] for f in states._fields
               if f != "rng" and getattr(states, f) is not None},
            rng=states.rng[slot])
        snap = self.eng.to_lss_state(one)
        return snap._replace(t=snap.t.clone(),
                             rng=_copy_generator(snap.rng))

    def restore_slot(self, states, slot: int, snap):
        """Write one slot in place: ``snap`` is a core-layout snapshot
        (placed through :meth:`ShardedLSS.place_lss_state`, which re-seeds
        the per-shard drop generators from its generator and puts its
        send count on shard 0) or an engine-layout slot state from
        :meth:`init_slot`."""
        if isinstance(snap, lss.LSSState):
            snap = self.eng.place_lss_state(snap)
        for f in snap._fields:
            if f != "rng" and getattr(snap, f) is not None:
                getattr(states, f)[slot] = getattr(snap, f)
        rng = list(states.rng)
        rng[slot] = _copy_generators(snap.rng)
        return states._replace(rng=tuple(rng))

    def cut_frac(self) -> Optional[float]:
        """Fraction of edges crossing shards: the partition quality the
        drift metric is built on."""
        st = self.eng.stopo
        return st.cut_edges() / max(st.num_edges, 1)

    def _reshard(self, dyn, states, prebuilt=None, catchup_rows=None):
        """A fresh partition of ``dyn`` and every slot's state migrated
        across ``new_of_old``: the mechanics of both epoch kinds.  Returns
        (states', whether ``prebuilt`` was adopted).

        ``prebuilt`` is a staged background build (:meth:`stage_rebalance`
        / :meth:`stage_regrow`): an engine built over an earlier snapshot,
        caught up here by the incremental journal repair live membership
        uses (``catchup_rows`` gives the changed rows when ``dyn``'s own
        journal cannot reach back to the snapshot: the regrow case).  A
        catch-up that fails rebuilds in line, as the JAX service does."""
        if prebuilt is not None:
            try:
                if prebuilt._topo_version != getattr(dyn, "version", 0):
                    prebuilt.apply_membership(dyn, rows=catchup_rows)
            except Exception:
                prebuilt = None  # stale beyond repair: rebuild in line
        old = self.eng
        self.eng = prebuilt if prebuilt is not None else self._build(dyn)
        self.topo = dyn
        return self.eng.migrate_from(old, states), prebuilt is not None

    def regrow(self, dyn, states, prebuilt=None, catchup_rows=None):
        """Re-partition a grown topology (see :meth:`_reshard`)."""
        return self._reshard(dyn, states, prebuilt=prebuilt,
                             catchup_rows=catchup_rows)

    def rebalance(self, dyn, states, prebuilt=None):
        """Re-partition the current graph (a fresh edge cut over the
        churned adjacency; the halo width may change; see
        :meth:`_reshard`)."""
        return self._reshard(dyn, states, prebuilt=prebuilt)

    # -- staged epoch builds (overlap mode) --------------------------------
    def stage_rebalance(self, dyn):
        """Start a background partition and table build over an immutable
        snapshot of the current graph.  Returns ``(build, version)``; the
        adopter hands ``build.take()`` to :meth:`rebalance` at a later
        boundary and the catch-up repair covers what churned since
        ``version`` (the service keeps the journal back to it)."""
        snap = dyn.snapshot() if hasattr(dyn, "snapshot") else dyn
        ver = getattr(dyn, "version", 0)

        def build():
            eng = self._build(snap)
            eng._topo_version = ver  # a snapshot carries no version
            return eng

        return StagedBuild(build, label="rebalance"), ver

    def stage_regrow(self, dyn, n_cap=None, deg_cap=None):
        """Background build over a grown copy of ``dyn`` (``grow()`` runs
        here, on the caller's thread: array copies, so the build touches
        only its own product).  The grown copy carries ``dyn``'s version,
        so the returned version is what the adopter gives catch-up rows
        relative to (a fresh ``grow()`` product journals nothing)."""
        grown = dyn.grow(n_cap=n_cap, deg_cap=deg_cap)
        ver = getattr(dyn, "version", 0)
        return StagedBuild(lambda: self._build(grown),
                           label="regrow"), ver


class Service:
    """Long-running multi-tenant monitor over one network graph.

    Args:
      topo: the shared :class:`~repro_torch.core.topology.Topology`, or a
        :class:`~repro_torch.core.topology.DynTopology` to serve a network
        whose membership changes while queries are in flight
        (:meth:`join_peer` / :meth:`leave_peer` / :meth:`link_peers` /
        :meth:`unlink_peers`).
      scfg: :class:`ServiceConfig` (slot capacity, dispatch fusion, knobs).
      telemetry: optional :class:`TelemetrySink` (legacy spelling of
        ``tracker``; a sink IS a tracker).
      tracker: optional :class:`repro_torch.obs.Tracker` the service routes
        all observability through (records, spans, the metrics registry).
        Default: an owned, ring-buffered :class:`TelemetrySink` that
        :meth:`close` disposes of.  Mutually exclusive with ``telemetry``.
      device: where the slots' state lives and the cycles run; ``None`` is
        CUDA (and raises without a card), ``"cpu"`` runs the plain
        PyTorch versions.

    The service is a context manager: ``with Service(...) as svc: ...``
    closes the tracker it owns on exit.
    """

    # Bound on remembered terminal query statuses (retired ids) and, at
    # 2x, on retained per-query message totals.
    _STATUS_CAP = 1 << 16

    def __init__(self, topo,
                 scfg: ServiceConfig = ServiceConfig(),
                 telemetry: Optional[TelemetrySink] = None,
                 tracker: Optional[Tracker] = None,
                 device=None):
        if telemetry is not None and tracker is not None:
            raise ValueError(
                "pass either telemetry= (legacy) or tracker=, not both")
        missing = _unported(scfg)
        if missing is not None:
            raise NotImplementedError(
                f"the port's Service does not support {missing} yet")
        self.device = resolve_device(device)
        self.topo = topo
        self.scfg = scfg
        self.base_cfg = lss.LSSConfig(
            beta=scfg.beta, ell=scfg.ell, drop_rate=scfg.drop_rate,
            policy=scfg.policy, max_corr_iters=scfg.max_corr_iters,
            eps=scfg.eps)
        self.backend = (_EngineBackend if scfg.backend == "engine"
                        else _CoreBackend)(topo, scfg, self.device)
        self.registry = QueryRegistry(scfg.capacity, scfg.k_max, scfg.d,
                                      self.base_cfg, device=self.device)
        self.ingest = StreamIngest()
        self.admission = AdmissionQueue(scfg.admission_queue,
                                        scfg.admission_overflow,
                                        clock=lambda: self.dispatches)
        self._owns_tracker = telemetry is None and tracker is None
        if tracker is not None:
            self.tracker = tracker
        elif telemetry is not None:
            self.tracker = telemetry
        else:
            self.tracker = TelemetrySink(max_records=self._STATUS_CAP)
        self.telemetry = self.tracker  # legacy alias
        # All instrumentation routes through the flight-recorder tee.
        self._obs = FlightRecorder(self.tracker,
                                   capacity=max(1, scfg.flight_capacity))
        # Per-tenant causal trace ids, minted deterministically at admit.
        self._trace_seq = 0
        self._trace_ids: Dict[str, str] = {}
        cp = scfg.control
        self.cp = cp
        self.slo = SLOTracker(registry=self.tracker.registry)
        self.evictor = SLOEvictionPolicy(
            self.tracker.registry,
            attainment_below=cp.evict_attainment_below,
            min_windows=cp.evict_min_windows)
        self.scheduler = make_scheduler(cp)
        self.capman = CapacityManager(
            auto_regrow=cp.auto_regrow, grow_factor=cp.grow_factor,
            rebalance_drift=cp.rebalance_drift,
            rebalance_check_every=cp.rebalance_check_every)
        self._preempted: Dict[str, _Preempted] = {}
        self._enqueued_at: Dict[str, int] = {}  # qid -> dispatch queued
        self._activated_at: Dict[str, int] = {}  # qid -> dispatch activated
        self._ctrl_events: list = []  # boundary activity -> control record
        self._dyn = topo if isinstance(topo, topology.DynTopology) else None
        self.membership = (MembershipQueue(self._dyn)
                           if self._dyn is not None else None)
        self._applied_version = (self._dyn.version
                                 if self._dyn is not None else 0)
        self._present = (self._dyn.present.copy()
                         if self._dyn is not None else None)
        self.dispatches = 0
        self.cycles = 0
        self._edges = max(topo.num_edges, 1)
        self._boundary_spans: Dict[str, float] = {}
        self._boundary_counts: Dict[str, int] = {}
        self._recompiles = 0  # eager execution: nothing ever recompiles
        self._corr_iters = None  # (Q,) per-slot do-while iters last window
        self._last_k = scfg.cycles_per_dispatch  # cycles in last window
        self._quiesced_at: Dict[str, int] = {}  # qid -> first quiescent t
        self._total_msgs = {}  # query_id -> host-side exact total
        self._retired: dict = {}  # insertion-ordered set

        self.states = self.backend.init_states(scfg.capacity, scfg.d,
                                               alive=self._present)
        self._buffers = DoubleBuffer()
        # Overlap: the window launched and not yet finished, the worker's
        # future and dispatch span while that dispatch is in flight (the
        # worker then owns the state: self.states is None), and the one
        # worker thread, started at the first overlapped launch.
        self._pending: Optional[PendingWindow] = None
        self._inflight: Optional[tuple] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        # kind ("rebalance" | "regrow") -> (StagedBuild, version[, caps]).
        # While a build is in flight the membership journal is compacted
        # only up to the oldest staged version, so the catch-up repair at
        # adoption still finds the events it needs.
        self._staged: Dict[str, tuple] = {}
        self.capman.note_epoch("init", self.backend.cut_frac())

    @property
    def topo_version(self) -> int:
        """Version of the topology the device tables reflect (0 for a
        static topology)."""
        return self._applied_version

    @property
    def num_preempted(self) -> int:
        """Suspended queries currently waiting to resume."""
        return len(self._preempted)

    def dispatch_info(self) -> dict:
        """Which kernel suite the dispatch runs (``suite`` name + ``fused``
        flag) plus the compile books of the JAX twin: the port runs eagerly,
        so ``recompiles`` is 0 and ``step_cache_size`` None."""
        info = dict(self.backend.dispatch_info())
        info["recompiles"] = self._recompiles
        info["step_cache_size"] = jit_cache_size(self.backend.step)
        return info

    def close(self) -> None:
        """Finish a pending overlapped window (best effort), stop the
        worker thread, flush the tracker and close it when the service
        built it (borrowed trackers stay open).  Idempotent."""
        try:
            self.flush()
        except Exception:
            pass  # shutdown must not fail on a poisoned window
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._owns_tracker:
            self.tracker.close()
        else:
            self.tracker.flush()

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- admission (between dispatches) ------------------------------------
    def admit(self, spec: qmod.QuerySpec,
              query_id: Optional[str] = None) -> str:
        """Admit a tenant's query.

        With a free slot the query activates immediately; otherwise it
        waits in the bounded admission queue and activates as slots free
        (at retires and dispatch boundaries).  Check
        :meth:`admission_status` to distinguish ``"active"`` from
        ``"queued"``.  Raises ``RuntimeError`` only on queue overflow
        under the ``"reject"`` policy (or with queueing disabled).
        """
        if spec.inputs.shape[0] != self.topo.n:
            raise ValueError(
                f"query inputs cover {spec.inputs.shape[0]} peers, "
                f"graph has {self.topo.n}")
        if spec.inputs.shape[-1] != self.scfg.d:
            raise ValueError(
                f"query inputs have d={spec.inputs.shape[-1]}, "
                f"service is configured for d={self.scfg.d}")
        if query_id is not None and (query_id in self.admission
                                     or query_id in self.registry._slot_of
                                     or query_id in self._preempted):
            raise ValueError(f"query id {query_id!r} already admitted")
        qid = query_id if query_id is not None else self.registry.reserve_id()
        tid = self._mint_trace(qid)
        with self._obs.span("admission", trace=(tid,), query=qid,
                            dispatch=self.dispatches) as sp:
            if self.registry.num_free > 0:
                self.registry.admit(spec, qid)
                self.slo.submit(qid, spec.slo, self.cycles)
                self._activate(qid, spec)
                sp.set("status", "active")
                return qid
            evicted = self.admission.push(qid, spec)
            self.slo.submit(qid, spec.slo, self.cycles)
            self._enqueued_at[qid] = self.dispatches
            sp.set("status", "queued")
            if evicted is not None:
                self._enqueued_at.pop(evicted, None)
                self._note_eviction(evicted,
                                    self.admission.terminal_reason(evicted))
            return qid

    def _mint_trace(self, qid: str) -> str:
        """Deterministic per-admission trace id (tracker independent)."""
        self._trace_seq += 1
        tid = f"t{self._trace_seq:05d}:{qid}"
        self._trace_ids[qid] = tid
        return tid

    def _active_traces(self) -> tuple:
        """Trace ids of the tenants the next shared scope works for."""
        return tuple(self._trace_ids[qid]
                     for qid, _slot, _spec in self.registry.active_items()
                     if qid in self._trace_ids)

    def _note_eviction(self, qid: str, reason: Optional[str]) -> None:
        """Record one queue eviction: the control record, the causal
        trace, and the flight-recorder trigger set."""
        tid = self._trace_ids.get(qid)
        with self._obs.span("evict", trace=(tid,) if tid else (),
                            query=qid, reason=str(reason),
                            at=self.admission.terminal_at(qid)):
            pass
        self._ctrl_events.append(("evicted", (qid, reason)))

    def admission_status(self, query_id: str) -> str:
        """``"active"`` | ``"queued"`` | ``"preempted"`` | ``"retired"`` |
        ``"evicted"`` | ``"cancelled"`` | ``"rejected"``."""
        if query_id in self.registry._slot_of:
            return "active"
        if query_id in self.admission:
            return "queued"
        if query_id in self._preempted:
            return "preempted"
        status = self.admission.terminal_status(query_id)
        if status is not None:
            return status
        if query_id in self._retired:
            return "retired"
        raise KeyError(f"unknown query id {query_id!r}")

    def _activate(self, qid: str, spec: qmod.QuerySpec) -> None:
        """Host-side slot setup for a freshly admitted (not resumed) query
        whose registry slot is already claimed."""
        tid = self._trace_ids.get(qid)
        with self._obs.span("activate", trace=(tid,) if tid else (),
                            query=qid, slot=self.registry.slot_of(qid)):
            self._reset_slot(self.registry.slot_of(qid), spec)
        self._total_msgs[qid] = 0
        self._activated_at[qid] = self.dispatches
        self._enqueued_at.pop(qid, None)

    def _drain_admission(self) -> int:
        """One scheduler pass: preempt (if the policy says so), then fill
        free slots from the waiting pool — queued and previously preempted
        queries together, in policy order.  Returns activations."""
        waiting = [
            WaitingView(qid, spec.priority, self.slo.violations(qid),
                        self._enqueued_at.get(qid, self.dispatches), False)
            for qid, spec in self.admission.items()
        ] + [
            WaitingView(qid, e.spec.priority, self.slo.violations(qid),
                        e.enqueued_dispatch, True)
            for qid, e in self._preempted.items()
        ]
        if not waiting:
            return 0
        active = [ActiveView(qid, spec.priority, self.slo.violations(qid),
                             self._activated_at.get(qid, 0))
                  for qid, _slot, spec in self.registry.active_items()]
        plan = self.scheduler.plan(active, waiting, self.registry.num_free,
                                   self.dispatches)
        for qid in plan.preempt:
            self._preempt(qid)
        n = 0
        for qid in plan.admit:
            if self.registry.num_free == 0:
                break
            if qid in self._preempted:
                self._resume(qid)
            else:
                spec = self.admission.take(qid)
                self.registry.admit(spec, qid)
                self._activate(qid, spec)
                self._ctrl_events.append(("activated", qid))
            n += 1
        return n

    # -- preemption / resume (between dispatches) --------------------------
    def _preempt(self, query_id: str) -> None:
        """Suspend an active query: snapshot its slot, free the slot, and
        put it in the waiting pool to age back in."""
        slot = self.registry.slot_of(query_id)
        spec = self.registry._specs[slot]
        tid = self._trace_ids.get(query_id)
        with self._obs.span("preempt", trace=(tid,) if tid else (),
                            query=query_id, slot=slot):
            snap = self.backend.snapshot(self.states, slot)
            self.registry.retire(query_id)
            self._reset_slot(slot, None)
        self._preempted[query_id] = _Preempted(
            spec, snap, self._applied_version, self.dispatches)
        self._ctrl_events.append(("preempted", query_id))

    def _resume(self, query_id: str) -> None:
        """Reactivate a preempted query in a free slot, restoring its
        snapshot.  With an unchanged topology the restore is exact (the
        suspension was a pause); if membership moved on, the snapshot is
        padded and reconciled first (:meth:`_reconcile_snapshot`).  Then
        replay the updates parked while it held no slot."""
        e = self._preempted.pop(query_id)
        self.registry.admit(e.spec, query_id)
        slot = self.registry.slot_of(query_id)
        tid = self._trace_ids.get(query_id)
        moved = e.topo_version != self._applied_version
        with self._obs.span("resume", trace=(tid,) if tid else (),
                            query=query_id, slot=slot,
                            reconciled=moved) as sp:
            snap = self._pad_snapshot(e.state)
            if moved:
                snap = self._reconcile_snapshot(snap)
            self.states = self.backend.restore_slot(self.states, slot, snap)
            parked = self.ingest.take_parked(query_id)
            if parked:
                x_m, x_c, pos = self.backend.x_moments(self.states)
                slot_arr = np.array([slot], np.int32)
                for b in parked:
                    x_m, x_c = self.ingest.apply(x_m, x_c, b, slot_arr,
                                                 pos=pos)
                self.states = self.backend.with_x(self.states, x_m, x_c)
                sp.set("replayed_batches", len(parked))
        self._activated_at[query_id] = self.dispatches
        self._ctrl_events.append(("resumed", query_id))

    def _pad_snapshot(self, snap: lss.LSSState) -> lss.LSSState:
        """Pad a snapshot taken before a regrow epoch to the current
        capacity (the one init-value recipe of :func:`_grow_core_states`)."""
        return _grow_core_states(snap, self.topo.n, self.topo.max_deg)

    def _reconcile_snapshot(self, snap: lss.LSSState) -> lss.LSSState:
        """Catch a suspended query up with membership that changed while
        it held no slot.  Its link agreements are stale (edges may have
        been rewired through reused slots), so the messaging state is
        scrubbed wholesale and knowledge restarts from the current local
        statistics: Alg. 1 re-converges from ``S_i = X_ii``.  The alive
        mask snaps to the current present set; peers that joined during
        the suspension get the no-value knowledge-init (zero vector,
        weight 1), what :meth:`join_peer` gives an active slot."""
        present = torch.tensor(self._present, device=snap.alive.device)
        newly = present & ~snap.alive
        return snap._replace(
            out_m=torch.zeros_like(snap.out_m),
            out_c=torch.zeros_like(snap.out_c),
            in_m=torch.zeros_like(snap.in_m),
            in_c=torch.zeros_like(snap.in_c),
            pending=torch.zeros_like(snap.pending),
            last_send=torch.full_like(snap.last_send, lss.COLD_TIMER),
            alive=present,
            x_m=torch.where(newly[:, None], 0.0, snap.x_m),
            x_c=torch.where(newly, 1.0, snap.x_c))

    def retire(self, query_id: str) -> None:
        """Retire a query; its slot becomes a masked no-op padding slot
        (immediately refilled from the admission queue when non-empty).
        Retiring a still-queued query cancels it; retiring a preempted
        query discards its suspended state."""
        if self.admission.cancel(query_id):
            self._enqueued_at.pop(query_id, None)
            return
        if query_id in self._preempted:
            del self._preempted[query_id]
            self.ingest.discard_parked(query_id)
            self._record_retired(query_id)
            return
        slot = self.registry.retire(query_id)
        self._record_retired(query_id)
        self._reset_slot(slot, None)
        self._drain_admission()

    def _record_retired(self, query_id: str) -> None:
        self._retired[query_id] = None
        self._activated_at.pop(query_id, None)
        self._quiesced_at.pop(query_id, None)
        # Per-tenant metric series die with the tenant.
        self.tracker.registry.remove_labels(query=query_id)
        while len(self._retired) > self._STATUS_CAP:
            self._retired.pop(next(iter(self._retired)))
        for stale in list(self._total_msgs):
            if len(self._total_msgs) <= self._STATUS_CAP * 2:
                break
            if stale not in self.registry._slot_of:
                del self._total_msgs[stale]

    def replace(self, query_id: str, spec: qmod.QuerySpec) -> None:
        """Swap a tenant's predicate/inputs in place (fresh slot state)."""
        self.registry.replace(query_id, spec)
        self._reset_slot(self.registry.slot_of(query_id), spec)

    def _reset_slot(self, slot: int, spec: Optional[qmod.QuerySpec]):
        self._join()
        n = self.topo.n
        if spec is None:
            inputs = wvs.WV(torch.zeros((n, self.scfg.d), device=self.device),
                            torch.zeros((n,), device=self.device))
            seed = 0
        else:
            inputs, seed = spec.input_wv(self.device), spec.seed
            pad = n - inputs.m.shape[0]
            if pad:
                # A spec admitted before a regrow epoch: the rows beyond it
                # start as zero-weight inputs (absent peers; a later join
                # knowledge-inits them anyway).
                inputs = wvs.WV(
                    torch.cat([inputs.m, inputs.m.new_zeros(
                        (pad, inputs.m.shape[-1]))]),
                    torch.cat([inputs.c, inputs.c.new_zeros((pad,))]))
        self.states = self.backend.restore_slot(
            self.states, slot,
            self.backend.init_slot(inputs, seed, alive=self._present))

    # -- membership (between dispatches) -----------------------------------
    def _require_dyn(self) -> MembershipQueue:
        if self.membership is None:
            raise RuntimeError(
                "membership events need a DynTopology-backed service "
                "(construct with topology.DynTopology.from_topology(...))")
        return self.membership

    def join_peer(self, peer: Optional[int] = None, value=None,
                  weight: float = 1.0) -> int:
        """Queue a peer join (applied at the next dispatch boundary).

        The joining peer starts from the paper's knowledge-init state in
        every query slot: local input ``<weight * value, weight>`` (zeros
        if no value is given), empty message slots, send timer cold.
        Returns the peer row the join will claim.
        """
        if value is not None:
            value = np.asarray(value, np.float32).reshape(-1)
            if value.shape[0] != self.scfg.d:
                raise ValueError(f"join value has d={value.shape[0]}, "
                                 f"service is configured for d={self.scfg.d}")
        mq = self._require_dyn()
        try:
            return mq.join(peer, value, weight)
        except topology.CapacityError:
            if not self.capman.auto_regrow:
                raise
            caps = self.capman.grown_caps(self._dyn.n_cap,
                                          self._dyn.deg_cap, "rows")
            if peer is not None:  # grow at least far enough for the row
                caps["n_cap"] = max(caps["n_cap"], int(peer) + 1)
            self.grow_capacity(**caps)
            return self.membership.join(peer, value, weight)

    def leave_peer(self, peer: int) -> None:
        """Queue a peer leave (churn: all its links fail with it)."""
        self._require_dyn().leave(peer)

    def link_peers(self, i: int, j: int) -> None:
        """Queue an edge add between two present peers.  With
        ``auto_regrow``, an endpoint at degree capacity grows ``deg_cap``
        (one epoch) instead of raising."""
        mq = self._require_dyn()
        try:
            mq.link(i, j)
        except topology.CapacityError:
            if not self.capman.auto_regrow:
                raise
            self.grow_capacity(**self.capman.grown_caps(
                self._dyn.n_cap, self._dyn.deg_cap, "slots"))
            self.membership.link(i, j)

    def unlink_peers(self, i: int, j: int) -> None:
        """Queue an edge removal (no-op if a leave already tore it down)."""
        self._require_dyn().unlink(i, j)

    # -- capacity epochs (between dispatches) ------------------------------
    def grow_capacity(self, n_cap: Optional[int] = None,
                      deg_cap: Optional[int] = None) -> None:
        """Regrow epoch: larger membership capacity, in place.

        Drives :meth:`DynTopology.grow`, copies the grown tables to the
        device and pads every slot's state (new rows start dead at init
        values), or on the engine backend re-partitions the grown graph
        and migrates every slot's state; queued membership events and
        preempted snapshots survive.  With ``control.auto_regrow`` this
        runs when :meth:`join_peer` / :meth:`link_peers` hit the capacity
        wall.
        """
        dyn = self._dyn
        if dyn is None:
            raise RuntimeError(
                "grow_capacity needs a DynTopology-backed service")
        self._join()
        # A build staged by _maybe_stage_growth whose capacity covers the
        # request is adopted instead of rebuilding in line; its catch-up
        # rows come from the OLD dyn's journal, read before grow(), which
        # starts a fresh journal.  The staged caps name only the grown
        # dimension; the other kept the capacity it has now.
        prebuilt = catchup_rows = None
        staged = self._staged.pop("regrow", None)
        if staged is not None:
            build, ver, caps = staged
            have_n = caps.get("n_cap", dyn.n_cap)
            have_d = caps.get("deg_cap", dyn.deg_cap)
            if ((n_cap is None or have_n >= n_cap)
                    and (deg_cap is None or have_d >= deg_cap)):
                n_cap, deg_cap = have_n, have_d
                try:
                    catchup_rows = dyn.changed_rows_since(ver)
                    prebuilt = build.take()
                except Exception:
                    prebuilt = catchup_rows = None  # rebuild in line
        new_dyn = dyn.grow(n_cap=n_cap, deg_cap=deg_cap)
        self.topo = self._dyn = new_dyn
        self.membership.rebind(new_dyn)
        with self._obs.span("epoch_regrow", trace=self._active_traces(),
                            n_cap=new_dyn.n_cap,
                            deg_cap=new_dyn.deg_cap) as sp:
            self.states, staged = self.backend.regrow(
                new_dyn, self.states, prebuilt=prebuilt,
                catchup_rows=catchup_rows)
            sp.set("staged", staged)  # False unless the build was adopted
        self._buffers.invalidate()  # the declared shape change
        self._boundary_spans["epoch_regrow"] = sp.seconds
        self._boundary_counts["epochs"] = (
            self._boundary_counts.get("epochs", 0) + 1)
        self._present = new_dyn.present.copy()
        self._applied_version = new_dyn.version
        self._edges = max(new_dyn.num_edges, 1)
        ev = self.capman.note_epoch(
            "regrow", self.backend.cut_frac(),
            n_cap=new_dyn.n_cap, deg_cap=new_dyn.deg_cap, staged=staged)
        self._ctrl_events.append(("epoch", ev))

    def rebalance_now(self) -> Optional[dict]:
        """Explicit re-partition epoch (engine backend; ``None`` on the
        partitionless core backend).

        Long churn drifts shard occupancy away from the BFS edge-cut
        optimum; this rebuilds the partition over the current graph and
        migrates every slot's state across ``new_of_old``.  Returns the
        epoch record (drift and cut fractions).  Runs by itself when
        ``control.rebalance_drift`` > 0 and the drift crosses it.
        """
        before = self.backend.cut_frac()
        if before is None:
            return None
        self._join()
        prebuilt = None
        staged = self._staged.pop("rebalance", None)
        if staged is not None:
            try:
                prebuilt = staged[0].take()
            except Exception:
                prebuilt = None  # a failed build: rebuild in line
        drift = self.capman.drift(before)
        with self._obs.span("epoch_rebalance", trace=self._active_traces(),
                            drift=drift) as sp:
            self.states, staged = self.backend.rebalance(
                self.topo, self.states, prebuilt=prebuilt)
            sp.set("staged", staged)  # False unless the build was adopted
        self._buffers.invalidate()  # fresh tables may change halo width
        self._boundary_spans["epoch_rebalance"] = sp.seconds
        self._boundary_counts["epochs"] = (
            self._boundary_counts.get("epochs", 0) + 1)
        ev = self.capman.note_epoch(
            "rebalance", self.backend.cut_frac(),
            cut_before=before, drift=drift, staged=staged)
        self._ctrl_events.append(("epoch", ev))
        return ev

    def _maybe_rebalance(self) -> None:
        """The drift check of ``control.rebalance_drift``, every
        ``rebalance_check_every`` dispatches: a rebalance epoch when the
        drift crosses the threshold; in overlap mode on the engine backend
        a staged build, adopted as soon as it is ready."""
        # A staged build adopts once ready, and suppresses drift checks
        # while in flight.
        staged = self._staged.get("rebalance")
        if staged is not None:
            if staged[0].ready():
                self.rebalance_now()
            return
        # The early-outs skip the O(edges) cut_frac() host scan on every
        # off-cadence dispatch.
        if self.dispatches == 0 or self.capman.rebalance_drift <= 0.0:
            return
        if self.dispatches % self.capman.rebalance_check_every:
            return
        if self.capman.should_rebalance(self.dispatches,
                                        self.backend.cut_frac()):
            if self.scfg.overlap and hasattr(self.backend,
                                             "stage_rebalance"):
                src = self._dyn if self._dyn is not None else self.topo
                with self._obs.span("epoch_stage", kind="rebalance"):
                    self._staged["rebalance"] = \
                        self.backend.stage_rebalance(src)
            else:
                self.rebalance_now()

    def _maybe_stage_growth(self) -> None:
        """Overlap mode on the engine backend: when free membership rows
        run low, stage the regrow epoch's partition and table build in the
        background, so the capacity-wall epoch adopts a finished build
        instead of rebuilding in line."""
        if (not self.scfg.overlap or self._dyn is None
                or not self.capman.auto_regrow or self._staged
                or not hasattr(self.backend, "stage_regrow")):
            return
        free = int((~self._dyn.present).sum())
        if free >= max(1, self._dyn.n_cap // 16):
            return
        caps = self.capman.grown_caps(self._dyn.n_cap, self._dyn.deg_cap,
                                      "rows")
        with self._obs.span("epoch_stage", kind="regrow", **caps):
            build, ver = self.backend.stage_regrow(self._dyn, **caps)
        self._staged["regrow"] = (build, ver, caps)

    def drift(self) -> float:
        """Current partition drift (the engine's cut-fraction increase
        since the last epoch); 0.0 on the core backend."""
        return self.capman.drift(self.backend.cut_frac())

    def _prepare_membership(self) -> Optional[tuple]:
        """The host half of the membership drain: drain queued events into
        the DynTopology and prepare the backend's tables for it (the
        engine's partition repair).  Touches neither the state nor the
        installed tables, so the overlapped tick runs it beside the
        previous dispatch.  Returns ``(events, join inits, prepared
        tables)``, or None on a quiet tick."""
        if self._dyn is None:
            return None
        if (not self.membership.has_pending()
                and self._dyn.version == self._applied_version):
            return None  # quiet tick: skip the drain machinery entirely
        join_inits = self.membership.drain_into(self._dyn)
        events = self._dyn.events_since(self._applied_version)
        if not events:
            return None
        return events, join_inits, self.backend.prepare_topology(self._dyn)

    def _apply_membership(self, prepared: Optional[tuple]) -> int:
        """The state half of the membership drain: install the prepared
        tables, then the per-slot state edits.  Returns the topology
        events applied."""
        if prepared is None:
            return 0
        events, join_inits, tables = prepared
        if self.backend.install_topology(tables):
            # The halo width regrew: the declared reshape of the tables.
            self._buffers.invalidate()

        # 1. Scrub the messaging state of every touched (peer, slot),
        #    freed and claimed alike (idempotent; order-free).
        rows, slots = [], []
        for ev in events:
            if ev.kind in ("link", "unlink"):
                rows += [ev.a, ev.b]
                slots += [ev.slot_a, ev.slot_b]
        if rows:
            self.states = self.backend.clear_slots(self.states, rows, slots)

        # 2. Alive transitions: the LAST join/leave per peer wins.
        final = {}
        for ev in events:
            if ev.kind in ("join", "leave"):
                final[ev.a] = ev.kind
        joins = [p for p, k in final.items() if k == "join"]
        leaves = [p for p, k in final.items() if k == "leave"]
        if leaves:
            self.states = self.backend.apply_leaves(self.states, leaves)
        if joins:
            # Knowledge-init: X_ii = <w*v, w>, empty slots, cold timer.
            vals = np.zeros((len(joins), self.scfg.d), np.float32)
            wts = np.ones((len(joins),), np.float32)
            for idx, p in enumerate(joins):
                v, w = join_inits.get(int(p), (None, 1.0))
                if v is not None:
                    vals[idx] = v
                wts[idx] = w
            self.states = self.backend.apply_joins(
                self.states, joins, vals * wts[:, None], wts)

        self._present = self._dyn.present.copy()
        self._edges = max(self._dyn.num_edges, 1)
        self._applied_version = self._dyn.version
        # Staged epoch builds catch up from the journal at adoption time,
        # so compaction may only advance to the oldest staged version.
        floor = self._applied_version
        for entry in self._staged.values():
            floor = min(floor, entry[1])
        self._dyn.compact(floor)
        return len(events)

    # -- streaming ingest --------------------------------------------------
    def push_updates(self, who, values, weights=None, mode: str = "set",
                     query_ids=None) -> UpdateBatch:
        """Queue a per-peer update batch (applied at the next boundary)."""
        return self.ingest.push(who, values, weights, mode, query_ids)

    def _apply_ingest(self) -> int:
        batches = self.ingest.drain()
        if not batches:
            return 0
        x_m, x_c, pos = self.backend.x_moments(self.states)
        active = {qid: s for qid, s, _ in self.registry.active_items()}
        for b in batches:
            if b.query_ids is None:
                slots = np.fromiter(active.values(), np.int32,
                                    count=len(active))
            else:
                # Ids retired while the batch sat in the queue are dropped;
                # a PREEMPTED target parks the batch for replay at resume.
                for q in b.query_ids:
                    if q not in active and q in self._preempted:
                        self.ingest.park(q, b)
                slots = np.array([active[q] for q in b.query_ids
                                  if q in active], np.int32)
            x_m, x_c = self.ingest.apply(x_m, x_c, b, slots, pos=pos)
        self.states = self.backend.with_x(self.states, x_m, x_c)
        return len(batches)

    # -- the serving loop --------------------------------------------------
    def tick(self, cycles: Optional[int] = None) -> list:
        """One dispatch: apply queued membership events, drain the
        admission queue, apply queued updates, run K batched cycles over
        all Q slots, observe, emit per-tenant telemetry.  Returns this
        dispatch's records (active slots only).

        The boundary runs inside one ``tick`` root span with the
        ``membership_drain`` / ``admission_drain`` / ``ingest_apply`` /
        ``dispatch`` / ``observe`` spans under it (and ``epoch_regrow`` /
        ``epoch_rebalance`` when an epoch ran since the last tick,
        ``epoch_stage`` when one was staged).  An exception escaping the
        tick dumps the flight recorder (when ``flight_dump_dir`` is set)
        before propagating.

        Under ``scfg.overlap`` the records returned are the PREVIOUS
        dispatch's, finished while this one runs on the worker thread; the
        first tick returns ``[]`` and :meth:`flush` drains the last window.
        An exception of the worker's dispatch surfaces at the next tick
        (or flush).  Record content is the synchronous mode's either way.
        """
        try:
            # The root span is labeled with the dispatch this tick RUNS.
            with self._obs.span("tick", dispatch=self.dispatches + 1):
                k = (cycles if cycles is not None
                     else self.scfg.cycles_per_dispatch)
                self._host_boundary()
                window = self._launch(k)
                if not self.scfg.overlap:
                    return self._finish_window(window)
                prev, self._pending = self._pending, window
                return self._finish_window(prev) if prev is not None else []
        except Exception as e:
            # Leave no dispatch running on the worker (an error of its
            # own is dropped: this tick's propagates).
            try:
                self._join()
            except Exception:
                pass
            self._auto_flight_dump("crash", error=repr(e))
            raise

    def _host_boundary(self) -> None:
        """Everything the host does between dispatches: membership drain,
        the epoch checks and staging, SLO eviction, admission, ingest.  In
        overlap mode the drain's host half runs while the previous dispatch
        is still on the worker, which is joined before anything touches the
        state or the installed tables."""
        tr = self._obs
        sp = tr.start_span("membership_drain")
        prepared = self._prepare_membership()
        beside = sp.elapsed()
        t_join = time.perf_counter()
        self._join()
        waited = time.perf_counter() - t_join
        n_events = self._apply_membership(prepared)
        if n_events:
            for key, v in self.membership.last_drain_stats.items():
                sp.set(key, v)
        if self.scfg.overlap:
            sp.set("prepare_s", beside)  # the half beside the dispatch
        tr.end_span(sp, sp.elapsed() - waited)  # the join's wait excluded
        self._boundary_spans["membership_drain"] = sp.seconds
        self._boundary_counts["membership_events"] = n_events
        self._maybe_rebalance()
        self._maybe_stage_growth()
        self._evict_unrecoverable()
        with tr.span("admission_drain") as sp:
            n_act = self._drain_admission()
            sp.set("activations", n_act)
        self._boundary_spans["admission_drain"] = sp.seconds
        self._boundary_counts["activations"] = n_act
        with tr.span("ingest_apply") as sp:
            n_batches = self._apply_ingest()
        self._boundary_spans["ingest_apply"] = sp.seconds
        self._boundary_counts["ingest_batches"] = n_batches

    def _launch(self, k: int) -> PendingWindow:
        """Stage the dispatch operands (the double-buffer swap), capture
        the bookkeeping the window's records are built from, and run the
        K-cycle dispatch and its observe: here (sync mode; the window is
        returned landed) or on the worker thread (overlap mode; the window
        lands at the next join)."""
        params = self.registry.params
        topo = self.backend.topo_args()
        self._buffers.swap(params, topo)
        info = self.backend.dispatch_info()
        sp = self._obs.start_span(
            "dispatch", trace=self._active_traces(), k=k,
            backend=self.scfg.backend, suite=info.get("suite"),
            fused=info.get("fused"))
        self.dispatches += 1
        self.cycles += k
        self._last_k = k
        events, self._ctrl_events = self._ctrl_events, []
        spans, self._boundary_spans = self._boundary_spans, {}
        counts, self._boundary_counts = self._boundary_counts, {}
        window = PendingWindow(
            dispatch=self.dispatches, t=self.cycles, k=k,
            acc=None, quiescent=None, want=None, msgs=None, corr_iters=None,
            active=tuple((qid, slot) for qid, slot, _spec
                         in self.registry.active_items()),
            queued=tuple(self.admission.queued_ids()),
            preempted=tuple(self._preempted),
            topo_version=self._applied_version,
            edges=self._edges,
            events=events, spans=spans, counts=counts)
        if not self.scfg.overlap:
            return self._land(window, sp, self._dispatch(
                self.states, params, topo, k))
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="service-dispatch")
        # The worker owns the state until the join lands the dispatch, and
        # runs on this thread's CUDA stream (the current stream is per
        # thread), so its work stays ordered with the boundary's edits.
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        states, self.states = self.states, None
        self._inflight = (self._pool.submit(
            self._dispatch, states, params, topo, k, stream), sp)
        return window

    def _dispatch(self, states, params: qmod.QueryParams, topo, k: int,
                  stream=None):
        """The dispatch proper, on the operands captured at launch (and on
        ``stream``, when given): K cycles over every slot, the observe,
        and the observation rows' copy to the host started behind them.
        Reads nothing the boundary edits (so the worker thread can run it
        beside the next boundary's host work).  Returns (states', per-slot
        do-while iterations, the (5, Q) host rows, their copy's CUDA event
        or None, the ``perf_counter`` stamp at which the K cycles were
        enqueued)."""
        backend = self.backend
        with torch.cuda.stream(stream):  # a no-op for None
            tables = backend.tables(params)
            states, iters = backend.step(states, params, tables, k,
                                         self.base_cfg, topo)
            stepped = time.perf_counter()
            acc, quiescent, want = backend.metrics(states, params, tables,
                                                   topo)
            # ONE host transfer for the whole fleet: accuracy, quiescence,
            # region, message counts and do-while iterations as one
            # float64 (5, Q) tensor (every value is exact in float64).
            rows = torch.stack([acc.double(), quiescent.double(),
                                want.double(),
                                backend.msgs_device(states).double(),
                                iters.double()])
            host, ready = rows, None
            if rows.device.type == "cuda":
                # Into pinned memory, waited on by its own event: finishing
                # the window does not wait behind a later dispatch.
                host = torch.empty(rows.shape, dtype=rows.dtype,
                                   pin_memory=True)
                host.copy_(rows, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(rows.device))
            return backend.reset_msgs(states), iters, host, ready, stepped

    def _land(self, window: PendingWindow, sp, result) -> PendingWindow:
        """Take a finished dispatch back: the state and the per-slot
        iterations, the dispatch span (ended when its K cycles were
        enqueued), and the window's observation rows."""
        states, iters, host, ready, stepped = result
        self.states, self._corr_iters = states, iters
        self._obs.end_span(sp, sp.elapsed(stepped))
        window.spans["dispatch"] = sp.seconds
        acc, quiescent, want, msgs, corr_iters = host
        return window._replace(acc=acc, quiescent=quiescent, want=want,
                               msgs=msgs, corr_iters=corr_iters, ready=ready)

    def _join(self) -> None:
        """Wait for the dispatch in flight on the worker thread (overlap
        mode) and land its window; a no-op when none is in flight.  Every
        method that reads or writes the state or the installed tables
        calls it first.  The dispatch's exception propagates from here,
        and the service is left with nothing in flight."""
        if self._inflight is None:
            return
        future, sp = self._inflight
        self._inflight = None
        try:
            result = future.result()
        except BaseException:
            self._pending = None  # its dispatch failed: nothing to finish
            raise
        self._pending = self._land(self._pending, sp, result)

    def flush(self) -> list:
        """Finish the pending overlapped window without launching a new
        dispatch: joins the worker, brings the window's observation to the
        host and emits its telemetry.  No-op (empty list) in sync mode or
        when nothing is pending.  :meth:`serve` and :meth:`close` call it;
        call it after a manual :meth:`tick` loop when record delivery must
        be caught up."""
        if self._pending is None:
            return []
        try:
            with self._obs.span("tick", dispatch=self._pending.dispatch,
                                flush=True):
                self._join()
                w, self._pending = self._pending, None
                return self._finish_window(w)
        except Exception as e:
            self._auto_flight_dump("crash", error=repr(e))
            raise

    def _evict_unrecoverable(self) -> None:
        """SLO-driven eviction of *waiting* tenants whose published
        attainment says their SLO is already lost."""
        if not self.evictor.enabled:
            return
        for qid, reason in self.evictor.victims(self.admission.queued_ids()):
            if self.admission.evict(qid, reason):
                self._enqueued_at.pop(qid, None)
                self._note_eviction(qid, reason)

    def serve(self, dispatches: int) -> list:
        """Run ``dispatches`` ticks; returns the final tick's records
        (overlap mode flushes the trailing window first, so the return
        value is the final dispatch's records in both modes)."""
        records = []
        for _ in range(dispatches):
            records = self.tick()
        if self._pending is not None:
            records = self.flush()
        return records

    # -- observation -------------------------------------------------------
    def _finish_window(self, w: PendingWindow) -> list:
        """Wait for a landed window's observation rows to reach the host
        and emit its telemetry.  Sync mode calls this right after the
        dispatch; overlap mode a tick later, while the next dispatch runs
        on the worker."""
        with self._obs.span(
                "observe", dispatch=w.dispatch,
                trace=tuple(self._trace_ids[qid] for qid, _slot in w.active
                            if qid in self._trace_ids)) as sp:
            if w.ready is not None:
                w.ready.synchronize()
            acc, quiescent, want, msgs, corr_iters = (
                r.numpy() for r in (w.acc, w.quiescent, w.want, w.msgs,
                                    w.corr_iters))
        w.spans["observe"] = sp.seconds
        reg = self.tracker.registry
        corr_hist = self.tracker.histogram(
            "service_corr_iters",
            "correction do-while iterations per slot per dispatch window",
            buckets=obs_metrics.DEFAULT_COUNT_BUCKETS)
        records = []
        for qid, slot in w.active:
            sent = int(msgs[slot])
            self._total_msgs[qid] = self._total_msgs.get(qid, 0) + sent
            rec = {
                "dispatch": w.dispatch,
                "t": w.t,
                "query": qid,
                "slot": slot,
                "accuracy": float(acc[slot]),
                "quiescent": bool(quiescent[slot]),
                "region": int(want[slot]),
                "msgs": sent,
                "msgs_per_link": sent / w.edges,
                "topo_version": w.topo_version,
                "trace_id": self._trace_ids.get(qid, ""),
            }
            slo_fields = self.slo.observe(qid, rec)
            if slo_fields is not None:
                rec.update(slo_fields)
            reg.gauge("tenant_accuracy",
                      "fraction of live peers deciding correctly").set(
                          rec["accuracy"], query=qid)
            reg.gauge("tenant_msgs_per_link",
                      "sends per link in the last dispatch window").set(
                          rec["msgs_per_link"], query=qid)
            reg.counter("tenant_msgs_total",
                        "cumulative sends, per query").inc(sent, query=qid)
            if rec["quiescent"]:
                if qid not in self._quiesced_at:
                    self._quiesced_at[qid] = w.t
                    reg.gauge(
                        "tenant_quiesced_at_cycles",
                        "cycle count at which the tenant first "
                        "quiesced and stayed quiescent").set(
                            w.t, query=qid)
            else:
                if self._quiesced_at.pop(qid, None) is not None:
                    reg.gauge("tenant_quiesced_at_cycles").remove(query=qid)
            corr_hist.observe(int(corr_iters[slot]), query=qid)
            self._obs.log_record(rec)
            records.append(rec)
        reg.gauge("service_queue_depth",
                  "admission queue occupancy").set(len(self.admission))
        reg.gauge("service_preempted_depth",
                  "suspended queries waiting to resume").set(
                      len(self._preempted))
        reg.gauge("service_active_slots",
                  "occupied query slots").set(len(records))
        # Tenants holding no slot still burn their SLO deadline.
        for qid in w.queued:
            self.slo.observe_waiting(qid, w.t)
        for qid in w.preempted:
            self.slo.observe_waiting(qid, w.t)
        trigger = None
        if any(r.get("slo_ok") is False for r in records):
            trigger = "slo_violation"
        elif any(kind == "evicted" for kind, _ in w.events):
            trigger = "eviction"
        self._emit_control_record(w)
        if trigger is not None:
            self._auto_flight_dump(trigger, dispatch=w.dispatch, t=w.t)
        return records

    # -- flight recorder ---------------------------------------------------
    def dump_flight_recorder(self, path: Optional[str] = None,
                             reason: str = "manual",
                             dispatch: Optional[int] = None,
                             t: Optional[int] = None) -> str:
        """Write the flight-recorder ring (last ``flight_capacity`` records
        + spans) as JSONL and return the path.  Default path:
        ``flight-d<dispatch>-<reason>.jsonl`` under ``flight_dump_dir`` (or
        the working directory when unset)."""
        self._join()
        dispatch = self.dispatches if dispatch is None else dispatch
        t = self.cycles if t is None else t
        if path is None:
            base = self.scfg.flight_dump_dir or "."
            os.makedirs(base, exist_ok=True)
            path = os.path.join(
                base, f"flight-d{dispatch:06d}-{reason}.jsonl")
        return self._obs.dump(path, reason=reason, dispatch=dispatch, t=t)

    def _auto_flight_dump(self, reason: str, dispatch: Optional[int] = None,
                          t: Optional[int] = None,
                          **context) -> Optional[str]:
        """Automatic dump on SLO violation / eviction / crash — only when
        the service was configured with a dump dir."""
        base = self.scfg.flight_dump_dir
        if base is None:
            return None
        dispatch = self.dispatches if dispatch is None else dispatch
        t = self.cycles if t is None else t
        os.makedirs(base, exist_ok=True)
        path = os.path.join(
            base, f"flight-d{dispatch:06d}-{reason}.jsonl")
        return self._obs.dump(path, reason=reason, dispatch=dispatch, t=t,
                              **context)

    def _emit_control_record(self, w: PendingWindow) -> None:
        """One record per dispatch with the control plane's activity —
        only when there is any (idle services emit nothing extra): the
        scheduler's events, non-empty waiting pools, boundary work (ingest
        batches applied), with the boundary ``spans`` (seconds) and
        ``boundary`` (work counts) maps."""
        events, spans, counts = w.events, w.spans, w.counts
        boundary_work = (counts.get("membership_events", 0)
                         or counts.get("ingest_batches", 0)
                         or counts.get("epochs", 0))
        if (not events and not w.queued and not w.preempted
                and not boundary_work):
            return
        agg: dict = {"activated": [], "resumed": [], "preempted": [],
                     "evicted": [], "epochs": []}
        for kind, payload in events:
            if kind == "epoch":
                agg["epochs"].append(payload)
            elif kind == "evicted":
                agg["evicted"].append(
                    {"query": payload[0], "reason": payload[1]})
            else:
                agg[kind].append(payload)
        self._obs.log_record({
            "kind": "control",
            "dispatch": w.dispatch,
            "t": w.t,
            "queue_depth": len(w.queued),
            "preempted_depth": len(w.preempted),
            **{k: v for k, v in agg.items() if v},
            **({"spans": spans} if spans else {}),
            **({"boundary": {k: v for k, v in counts.items() if v}}
               if any(counts.values()) else {}),
        })

    def total_msgs(self, query_id: str) -> int:
        """Exact cumulative sends by this query (host-side accumulation;
        carries across preemption)."""
        self._join()
        return self._total_msgs[query_id]

    def snapshot(self, query_id: str) -> lss.LSSState:
        """A copy of this query's full simulator state — the parity-test /
        debugging view.  For a preempted query, the state it was suspended
        with."""
        self._join()
        if query_id in self._preempted:
            return self._preempted[query_id].state
        return self.backend.snapshot(self.states,
                                     self.registry.slot_of(query_id))

    def slo_report(self) -> Dict[str, dict]:
        """Per-tenant SLO summary: violations, evaluated windows,
        attainment — every tenant that declared an SLO."""
        return self.slo.report()
