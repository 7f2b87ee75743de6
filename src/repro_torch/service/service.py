"""The service driver: Q query slots, one batched pass per cycle.

Port of ``repro/service/service.py``: the core backend in synchronous
mode.  Execution model::

    admit (or queue) / retire --+                +--> telemetry (JSONL)
    stream updates -------------+--> [boundary] -+
                                         |   ^
                                         v   |
                        one dispatch: a host loop of K cycles, each one
                        batched lss.cycle_impl over the Q query slots

All Q queries advance in lockstep.  The JAX service ``vmap``s
``lss.cycle_impl`` over its slots; here the slots are the leading axis of
one stacked :class:`~repro_torch.core.lss.LSSState`, with per-slot region
families, ``beta``/``ell``/``eps`` tensors and the active-slot gate, so
every step of a cycle launches its kernel once for all Q tenants.  Free
slots ride along as masked no-ops that send zero messages.  The observe
pass, on the fused suite, is one Q-batched ``lss_state`` launch (per-peer
decisions and violations) and one Q-batched ``region_decide`` launch over
the Q global averages; its numbers reach the host in one transfer.

The service owns its stacked state and edits slots in place between
dispatches (admit, retire, preempt, resume, ingest); snapshots are copies.

The control plane (:mod:`repro_torch.service.controlplane`) runs as in
the JAX package: per-tenant SLOs folded into every record, the
admission/preemption scheduler (preempted queries are snapshotted and
resume bitwise where they stopped), SLO-driven queue eviction.

Not ported yet; each raises ``NotImplementedError`` naming its ROADMAP
item: ``backend="engine"``, ``overlap=True`` and a ``DynTopology``
with its membership events and regrow/rebalance epochs (A.6),
``profile_dispatch``/``profiler_dir``, ``alerts`` and ``audit_every > 0``
(A.7).
"""

from __future__ import annotations

import os
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
from .overlap import DoubleBuffer, PendingWindow
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

    Fields of the JAX twin that select parts not ported yet are kept so
    configurations carry over, and the service raises on them:
    ``backend="engine"`` and the ``engine_*`` fields and ``overlap``
    (ROADMAP A.6), ``profile_dispatch``/``profiler_dir``/
    ``profile_sample_every``, ``alerts`` and ``audit_every`` (A.7).
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
    backend: str = "core"  # "core" ("engine": ROADMAP A.6)
    engine_shards: int = 2
    engine_method: str = "bfs"
    engine_halo_slack: float = 1.5
    engine_wire: str = "exact"
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


def _unported(scfg: ServiceConfig, topo) -> Optional[str]:
    """What of ``scfg``/``topo`` the port cannot serve yet, with its
    ROADMAP item, or None."""
    if scfg.backend == "engine":
        return "backend='engine' (the service's engine backend, ROADMAP A.6)"
    if scfg.backend != "core":
        raise ValueError(f"unknown backend {scfg.backend!r}")
    if scfg.overlap:
        return "overlap=True (the overlapped host boundary, ROADMAP A.6)"
    if isinstance(topo, topology.DynTopology):
        return ("a DynTopology (membership events and regrow/rebalance "
                "epochs, ROADMAP A.6)")
    if scfg.profile_dispatch or scfg.profiler_dir is not None:
        return "profile_dispatch/profiler_dir (ROADMAP A.7)"
    if scfg.alerts:
        return "alerts (ROADMAP A.7)"
    if scfg.audit_every > 0:
        return "audit_every > 0 (the audit plane, ROADMAP A.7)"
    return None


class _Preempted(NamedTuple):
    """A suspended tenant: its spec, its state snapshot, and the
    bookkeeping the scheduler ages it by."""

    spec: qmod.QuerySpec
    state: lss.LSSState
    enqueued_dispatch: int  # when it re-entered the waiting pool


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


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

    def init_states(self, q: int, d: int) -> lss.LSSState:
        """Q padding slots: zero inputs, seed 0, every peer alive."""
        n = self.topo.n
        zeros = wvs.WV(
            torch.zeros((q, n, d), dtype=torch.float32, device=self.device),
            torch.zeros((q, n), dtype=torch.float32, device=self.device))
        return lss.init_state(self.ta, zeros, seed=0)

    def init_slot(self, inputs: wvs.WV, seed: int) -> lss.LSSState:
        return lss.init_state(self.ta, inputs, seed=seed)

    def tables(self, params: qmod.QueryParams) -> kernel_ops.SlotTables:
        """The Q packed families with their kernel tables, prepared once
        per dispatch (the reference suite reads only the families)."""
        return kernel_ops.prep_slots(params.regions, params.eps, params.beta)

    def step(self, states, params: qmod.QueryParams, tables, k: int,
             cfg: lss.LSSConfig):
        """K batched cycles; returns (states', per-slot do-while
        iterations summed over the K cycles)."""
        cfg = cfg._replace(beta=params.beta, ell=params.ell, eps=params.eps)
        iters = torch.zeros(params.active.shape, dtype=torch.int32,
                            device=self.device)
        for _ in range(k):
            states, _, it = lss.cycle_impl(
                states, self.ta, cfg, None, gate=params.active,
                suite=self.suite, regions=tables, with_stats=True)
            iters = iters + it
        return states, iters

    def metrics(self, states, params: qmod.QueryParams, tables):
        """Per-slot (accuracy, quiescent, want)."""
        acc, quiescent, _, want = lss.metrics_impl(
            states, self.ta, lambda v: self.suite.decide(v, tables),
            params.eps, suite=self.suite, regions=tables)
        return acc, quiescent, want

    def reset_msgs(self, states):
        return states._replace(msgs=torch.zeros_like(states.msgs))

    def x_moments(self, states):
        return states.x_m, states.x_c, None  # (Q, n, d), (Q, n), identity

    def with_x(self, states, x_m, x_c):
        return states._replace(x_m=x_m, x_c=x_c)

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


class Service:
    """Long-running multi-tenant monitor over one network graph.

    Args:
      topo: the shared :class:`~repro_torch.core.topology.Topology`.
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
        missing = _unported(scfg, topo)
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
        self.backend = _CoreBackend(topo, scfg, self.device)
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
        self._applied_version = 0  # a static topology never changes
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

        self.states = self.backend.init_states(scfg.capacity, scfg.d)
        self._buffers = DoubleBuffer()
        self.capman.note_epoch("init", self.backend.cut_frac())

    @property
    def topo_version(self) -> int:
        """Version of the topology the tables reflect (0: static)."""
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
        """Flush the tracker and close it when the service built it
        (borrowed trackers stay open).  Idempotent."""
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
        self._preempted[query_id] = _Preempted(spec, snap, self.dispatches)
        self._ctrl_events.append(("preempted", query_id))

    def _resume(self, query_id: str) -> None:
        """Reactivate a preempted query in a free slot, restoring its
        snapshot exactly (the topology is static, so the suspension was a
        pause), then replay the updates parked while it held no slot."""
        e = self._preempted.pop(query_id)
        self.registry.admit(e.spec, query_id)
        slot = self.registry.slot_of(query_id)
        tid = self._trace_ids.get(query_id)
        with self._obs.span("resume", trace=(tid,) if tid else (),
                            query=query_id, slot=slot,
                            reconciled=False) as sp:
            self.states = self.backend.restore_slot(self.states, slot,
                                                    e.state)
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
        if spec is None:
            n, d = self.topo.n, self.scfg.d
            inputs = wvs.WV(torch.zeros((n, d), device=self.device),
                            torch.zeros((n,), device=self.device))
            seed = 0
        else:
            inputs, seed = spec.input_wv(self.device), spec.seed
        self.states = self.backend.restore_slot(
            self.states, slot, self.backend.init_slot(inputs, seed))

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
        """One dispatch: drain the admission queue, apply queued updates,
        run K batched cycles over all Q slots, observe, emit per-tenant
        telemetry.  Returns this dispatch's records (active slots only).

        The boundary runs inside one ``tick`` root span with the
        ``admission_drain`` / ``ingest_apply`` / ``dispatch`` /
        ``observe`` spans under it.  An exception escaping the tick dumps
        the flight recorder (when ``flight_dump_dir`` is set) before
        propagating.
        """
        try:
            with self._obs.span("tick", dispatch=self.dispatches + 1):
                k = (cycles if cycles is not None
                     else self.scfg.cycles_per_dispatch)
                self._host_boundary()
                return self._finish_window(self._launch(k))
        except Exception as e:
            self._auto_flight_dump("crash", error=repr(e))
            raise

    def _host_boundary(self) -> None:
        """Everything the host does between dispatches: SLO eviction,
        admission, ingest."""
        tr = self._obs
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
        """Run the K-cycle dispatch and the observation pass behind it;
        returns the window its records are built from."""
        params = self.registry.params
        topo = self.backend.topo_args()
        self._buffers.swap(params, topo)
        info = self.backend.dispatch_info()
        tr = self._obs
        with tr.span("dispatch", trace=self._active_traces(), k=k,
                     backend=self.scfg.backend,
                     suite=info.get("suite"), fused=info.get("fused")) as sp:
            tables = self.backend.tables(params)
            self.states, self._corr_iters = self.backend.step(
                self.states, params, tables, k, self.base_cfg)
        self._boundary_spans["dispatch"] = sp.seconds
        self.dispatches += 1
        self.cycles += k
        self._last_k = k
        acc, quiescent, want = self.backend.metrics(self.states, params,
                                                    tables)
        msgs = self.states.msgs
        self.states = self.backend.reset_msgs(self.states)
        events, self._ctrl_events = self._ctrl_events, []
        spans, self._boundary_spans = self._boundary_spans, {}
        counts, self._boundary_counts = self._boundary_counts, {}
        return PendingWindow(
            dispatch=self.dispatches, t=self.cycles, k=k,
            acc=acc, quiescent=quiescent, want=want, msgs=msgs,
            corr_iters=self._corr_iters,
            active=tuple((qid, slot) for qid, slot, _spec
                         in self.registry.active_items()),
            queued=tuple(self.admission.queued_ids()),
            preempted=tuple(self._preempted),
            topo_version=self._applied_version,
            edges=self._edges,
            events=events, spans=spans, counts=counts)

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
        """Run ``dispatches`` ticks; returns the final tick's records."""
        records = []
        for _ in range(dispatches):
            records = self.tick()
        return records

    # -- observation -------------------------------------------------------
    def _finish_window(self, w: PendingWindow) -> list:
        """Bring a window's observation to the host and emit its
        telemetry."""
        with self._obs.span(
                "observe", dispatch=w.dispatch,
                trace=tuple(self._trace_ids[qid] for qid, _slot in w.active
                            if qid in self._trace_ids)) as sp:
            # ONE host transfer for the whole fleet: accuracy, quiescence,
            # region, message counts and do-while iterations as one
            # float64 (5, Q) tensor (every value is exact in float64).
            host = torch.stack([
                w.acc.double(), w.quiescent.double(), w.want.double(),
                w.msgs.double(), w.corr_iters.double()]).cpu().numpy()
            acc, quiescent, want, msgs, corr_iters = host
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
        return self._total_msgs[query_id]

    def snapshot(self, query_id: str) -> lss.LSSState:
        """A copy of this query's full simulator state — the parity-test /
        debugging view.  For a preempted query, the state it was suspended
        with."""
        if query_id in self._preempted:
            return self._preempted[query_id].state
        return self.backend.snapshot(self.states,
                                     self.registry.slot_of(query_id))

    def slo_report(self) -> Dict[str, dict]:
        """Per-tenant SLO summary: violations, evaluated windows,
        attainment — every tenant that declared an SLO."""
        return self.slo.report()
