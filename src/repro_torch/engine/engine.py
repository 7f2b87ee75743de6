"""ShardedLSS — the exact :mod:`repro_torch.core.lss` semantics over a
partitioned peer population (port of ``repro/engine/engine.py``, the
synchronous single-device path).

The peer population is partitioned into ``S`` blocks (:mod:`.partition`);
every state array carries a leading shard axis ``(S, B, ...)``.  One engine
cycle is::

    1. deliver   — pending out-messages land in in-slots: shard-local edges
                   by the core's reverse-slot gather, cross-shard edges
                   through the halo exchange (:mod:`.exchange`);
    2. update    — status / violations / the Eq.-10 correction do-while on
                   the flattened ``(S*B, ...)`` rows, through the same
                   :func:`repro_torch.core.lss.suite_hooks` and
                   :func:`~repro_torch.core.lss.correction_loop` the core
                   uses: the CUDA kernels on the card (the ``fused`` suite),
                   the reference formulas on the CPU.

Step 2 is peer-local and step 1 reproduces the core's "message (i, k) lands
at (nbr[i,k], rev[i,k])" delivery, so the engine is cycle-for-cycle the
core (up to the row permutation, and to the drop stream when
``drop_rate > 0``: the engine draws from one generator per shard).  Padding
rows are dead and have no valid slot.

Differences from the JAX twin: a dispatch of ``cycles_per_dispatch`` (K)
cycles is a host loop, not one compiled ``fori_loop`` with donated buffers:
K is the grain of one ``engine.dispatch`` span and of the driver's
bookkeeping.  Functions are pure (they return new states and never write
into the tensors they are given); the drop generators advance in place, as
in the core.  Not ported yet, each raising ``NotImplementedError`` naming
its ROADMAP item: the mesh transport (``use_mesh``, A.5), the async ring
and the quantized wires (A.4b), the audit plane and ``profile=True`` (A.7),
and ``auto_plan=True`` (A.8).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import lss, regions, stopping, topology, wvs
from ..core.sim import OBSERVE_EPS
from ..kernels import ops as kernel_ops
from ..kernels import suite as kernel_suite
from . import exchange, partition

__all__ = ["DeviceTopo", "EngineConfig", "ShardedState", "ShardedLSS"]


def _unported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class DeviceTopo(NamedTuple):
    """Device-side topology tables, built once from the host
    :class:`~repro_torch.engine.partition.ShardedTopo` and rebuilt only by
    :meth:`ShardedLSS.apply_membership`.

    The index tables are int64 here, once, so a cycle indexes without a
    cast: ``tgt_pos`` (the flattened target position, which is also the
    flat view's neighbor table), ``src`` (``tgt_pos * D + rev``: the flat
    source slot each in-slot receives from) and the halo rows and slots.
    """

    mask: torch.Tensor  # bool  (S, B, D)
    rev: torch.Tensor  # int32 (S, B, D)
    tgt_pos: torch.Tensor  # int64 (S, B, D) flattened target position
    src: torch.Tensor  # int64 (S, B, D) flat source slot, tgt_pos*D + rev
    intra: torch.Tensor  # bool  (S, B, D)
    halo: partition.HaloTables  # (S, S, H): int64 rows/slots, bool send_ok

    @classmethod
    def from_sharded(cls, st: partition.ShardedTopo, device) -> "DeviceTopo":
        def t(a, dtype):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        i64 = torch.int64
        tgt_pos = st.tgt_pos.astype(np.int64)
        h = st.halo
        return cls(
            mask=t(st.mask, torch.bool), rev=t(st.rev, torch.int32),
            tgt_pos=t(tgt_pos, i64), src=t(tgt_pos * st.D + st.rev, i64),
            intra=t(st.intra, torch.bool),
            halo=partition.HaloTables(
                t(h.send_row, i64), t(h.send_slot, i64),
                t(h.send_ok, torch.bool), t(h.recv_row, i64),
                t(h.recv_slot, i64)))

    def flat(self) -> lss.TopoArrays:
        """The core's view over all ``S*B`` rows: ``(nbr=tgt_pos, mask,
        rev)`` keeps the slot involution across shard boundaries."""
        S, B, D = self.mask.shape
        return lss.TopoArrays(nbr=self.tgt_pos.reshape(S * B, D),
                              mask=self.mask.reshape(S * B, D),
                              rev=self.rev.reshape(S * B, D))


class EngineConfig(NamedTuple):
    """Every field of the JAX ``EngineConfig``, with its default."""

    num_shards: int = 2
    cycles_per_dispatch: int = 8  # K cycles per dispatch (one span)
    method: str = "bfs"  # partitioner: "bfs" | "stride"
    # Kernel suite: None = auto (the CUDA kernels on a CUDA device, the
    # reference formulas on the CPU), bool, or a registered suite name.
    use_kernels: Union[bool, str, None] = None
    halo_slack: float = 1.0  # >1 pads halo width for membership headroom
    profile: bool = False  # not ported (ROADMAP A.7)
    async_mode: bool = False  # not ported (ROADMAP A.4b)
    staleness: int = 0  # the async ring's bound (ROADMAP A.4b)
    wire: str = "exact"  # "exact" | "compact" ("int8"/"bf16": A.4b)
    auto_plan: bool = False  # not ported (ROADMAP A.8)


class ShardedState(NamedTuple):
    """:class:`repro_torch.core.lss.LSSState`, blocked ``(S, B, ...)`` per
    shard.  (The JAX twin's ``wire_err_*`` fields belong to the quantized
    wires, ROADMAP A.4b.)"""

    out_m: torch.Tensor  # (S, B, D, d)
    out_c: torch.Tensor  # (S, B, D)
    in_m: torch.Tensor  # (S, B, D, d)
    in_c: torch.Tensor  # (S, B, D)
    x_m: torch.Tensor  # (S, B, d)
    x_c: torch.Tensor  # (S, B)
    pending: torch.Tensor  # (S, B, D) bool
    last_send: torch.Tensor  # (S, B) int32
    alive: torch.Tensor  # (S, B) bool — padding rows stay False
    t: torch.Tensor  # ()  current cycle
    msgs: torch.Tensor  # (S,) per-shard cumulative sends (int64)
    rng: tuple  # S torch.Generators: per-shard drop streams


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _shard_generators(device, seed: int, num: int) -> tuple:
    """``num`` drop streams derived from one seed."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(num)
    return tuple(lss._generator(device, s) for s in seeds)


class ShardedLSS:
    """Partitioned multi-shard LSS engine with halo exchange.

    Args:
      topo: host-side :class:`~repro_torch.core.topology.Topology` (or a
        :class:`~repro_torch.core.topology.DynTopology`).
      centers: (k, d) Voronoi option points.
      cfg: the simulator :class:`~repro_torch.core.lss.LSSConfig`.
      ecfg: :class:`EngineConfig` (shards, dispatch grain, suite, wire).
      decide: optional OPAQUE region decision fn (reference formulas only:
        with the fused suite, the auto choice on CUDA, it raises — pass
        ``region=`` instead, or ``use_kernels=False``).
      region: optional region family (``VoronoiRegions`` /
        ``HalfspaceRegions`` / :class:`~repro_torch.core.regions.
        PackedSlot`) replacing the default Voronoi-on-``centers``.
      tracker: optional :class:`repro_torch.obs.Tracker`; :meth:`run` wraps
        every dispatch in an ``engine.dispatch`` span.
      device: where the engine runs; None is CUDA (raising without a card).
    """

    def __init__(self, topo: topology.Topology, centers,
                 cfg: lss.LSSConfig = lss.LSSConfig(),
                 ecfg: EngineConfig = EngineConfig(), decide=None,
                 region=None, tracker=None, device=None):
        from ..obs import NoopTracker  # local: keep the engine import light

        if ecfg.async_mode:
            raise _unported("async_mode=True (the bounded-staleness ring)",
                            "A.4b")
        if ecfg.profile:
            raise _unported("profile=True (ProfiledDispatch)", "A.7")
        if ecfg.auto_plan:
            raise _unported("auto_plan=True (engine autotuning)", "A.8")
        self._wire = exchange.get_wire(ecfg.wire)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.tracker = tracker if tracker is not None else NoopTracker()
        self.centers = torch.as_tensor(centers).to(self.device)
        if region is not None:
            self.region_slot = regions.PackedSlot(*(
                f.to(self.device) for f in regions.as_packed_slot(region)))
            self.decide = decide or self.region_slot.decide
        elif decide is None:
            self.region_slot = regions.PackedSlot.voronoi(self.centers)
            self.decide = lambda v: regions.decide_voronoi(v, self.centers)
        else:
            self.region_slot = None  # opaque decide: not packable
            self.decide = decide
        self.suite = kernel_suite.resolve_suite(ecfg.use_kernels,
                                                self.device)
        if self.region_slot is None and self.suite.fused:
            # An opaque decide cannot feed the packed kernels, and on a CUDA
            # device the auto choice is the fused suite: the plain formulas
            # run only when the caller asks for them (use_kernels=False).
            raise ValueError(
                "the fused suite routes decisions through the packed CUDA "
                "kernels and cannot honor an opaque `decide` callable — "
                "pass `region=` (a region family) instead, or "
                "use_kernels=False for the reference formulas")
        self.use_kernels = self.suite.fused
        self.dispatch_info = {"suite": self.suite.name,
                              "fused": self.suite.fused}
        # The family's kernel tables, prepared once: with cfg.eps for the
        # cycles, with the observe's eps for metrics.
        self._slot_tables = {}
        if self.region_slot is not None:
            for eps in (cfg.eps, OBSERVE_EPS):
                self._tables_for(eps)

        part = partition.make_partition(topo, ecfg.num_shards, ecfg.method)
        self.stopo = partition.shard_topology(topo, part,
                                              halo_slack=ecfg.halo_slack)
        self.part = part
        self.S, self.B, self.D = part.num_shards, part.block, self.stopo.D
        self.n, self.num_edges = self.stopo.n, self.stopo.num_edges
        self._wire_w = self._wire_width()
        self._refresh_tables()
        # Version of the (Dyn)topology the tables reflect; apply_membership
        # catches up incrementally from here.
        self._topo_version = getattr(topo, "version", 0)
        self._pos = torch.tensor(part.new_of_old, dtype=torch.int64,
                                 device=self.device)  # (n,) orig -> flat

    def _tables_for(self, eps) -> kernel_ops.SlotTables:
        if eps not in self._slot_tables:
            self._slot_tables[eps] = kernel_ops.prep_slots(self.region_slot,
                                                           eps)
        return self._slot_tables[eps]

    def _refresh_tables(self) -> None:
        """Device tables (trimmed to the wire width) and the host-side
        halo statistics :meth:`run` reports, from ``self.stopo``."""
        st = self.stopo
        self._tables = self._wire_tables(DeviceTopo.from_sharded(
            st, self.device))
        self._flat_topo = self._tables.flat()
        self._pair_counts = np.asarray(st.halo.send_ok).sum(axis=-1)
        self._cuts = (st.mask & ~st.intra).reshape(self.S, -1).sum(axis=1)

    # -- unported surfaces -------------------------------------------------
    def use_mesh(self, mesh, axis_name: str):
        raise _unported("use_mesh (the collective all_to_all transport)",
                        "A.5")

    def init_async(self, inputs: wvs.WV, seed: int = 0, alive=None):
        raise _unported("init_async (the bounded-staleness ring)", "A.4b")

    def wrap_async(self, base: ShardedState):
        raise _unported("wrap_async (the bounded-staleness ring)", "A.4b")

    def audit(self, state, eps: float = 1e-9, sample_mod: int = 1,
              sample_phase: int = 0):
        raise _unported("ShardedLSS.audit (the audit plane)", "A.7")

    # -- state -------------------------------------------------------------
    def init(self, inputs: wvs.WV, seed: int = 0, alive=None) -> ShardedState:
        """Build sharded state from inputs in ORIGINAL peer order.

        ``alive`` (optional bool (n,), original order) seeds the churn mask
        — a capacity-padded DynTopology passes its ``present`` mask so spare
        rows start dead.
        """
        return self.init_sync(inputs, seed=seed, alive=alive)

    def init_sync(self, inputs: wvs.WV, seed: int = 0,
                  alive=None) -> ShardedState:
        """:meth:`init` (the engine has only the sync mode)."""
        S, B, D = self.S, self.B, self.D
        dev = self.device
        x_in = inputs.m.to(dev)
        d, dt = x_in.shape[-1], x_in.dtype
        x_m = torch.zeros((S * B, d), dtype=dt, device=dev)
        x_m[self._pos] = x_in
        x_c = torch.zeros((S * B,), dtype=dt, device=dev)
        x_c[self._pos] = inputs.c.to(dev)
        alive0 = (torch.ones((self.n,), dtype=torch.bool, device=dev)
                  if alive is None else
                  torch.tensor(np.asarray(alive), dtype=torch.bool,
                               device=dev))
        alive_flat = torch.zeros((S * B,), dtype=torch.bool, device=dev)
        alive_flat[self._pos] = alive0
        return ShardedState(
            out_m=torch.zeros((S, B, D, d), dtype=dt, device=dev),
            out_c=torch.zeros((S, B, D), dtype=dt, device=dev),
            in_m=torch.zeros((S, B, D, d), dtype=dt, device=dev),
            in_c=torch.zeros((S, B, D), dtype=dt, device=dev),
            x_m=x_m.reshape(S, B, d),
            x_c=x_c.reshape(S, B),
            pending=torch.zeros((S, B, D), dtype=torch.bool, device=dev),
            last_send=torch.full((S, B), lss.COLD_TIMER, dtype=torch.int32,
                                 device=dev),
            alive=alive_flat.reshape(S, B),
            t=torch.zeros((), dtype=torch.int32, device=dev),
            msgs=torch.zeros((S,), dtype=lss.counter_dtype(), device=dev),
            rng=_shard_generators(dev, seed, S),
        )

    # -- dynamic-data hooks (original peer ids) ------------------------------
    def _positions(self, who) -> torch.Tensor:
        return self._pos[torch.as_tensor(who, dtype=torch.int64,
                                         device=self.device)]

    def set_inputs(self, state: ShardedState, who, new_x) -> ShardedState:
        """Resample inputs: ``x_m[who] = new_x`` (moment form, weight kept)."""
        flat = state.x_m.reshape(self.S * self.B, -1).clone()
        flat[self._positions(who)] = torch.as_tensor(
            new_x, dtype=flat.dtype, device=self.device)
        return state._replace(x_m=flat.reshape(state.x_m.shape))

    def kill_peers(self, state: ShardedState, who) -> ShardedState:
        """Churn: permanently mark original ids ``who`` dead."""
        return self.set_alive(state, who, False)

    def set_alive(self, state: ShardedState, who, value: bool
                  ) -> ShardedState:
        """Set the churn mask of original ids ``who`` (True = join)."""
        flat = state.alive.reshape(self.S * self.B).clone()
        flat[self._positions(who)] = bool(value)
        return state._replace(alive=flat.reshape(state.alive.shape))

    def clear_slots(self, state: ShardedState, rows, slots) -> ShardedState:
        """Scrub the messaging state of ``(peer, slot)`` coordinates in
        ORIGINAL ids — the engine-layout counterpart of
        :func:`repro_torch.core.lss.clear_slots`."""
        pos = self._positions(rows)
        s_idx, b_idx = pos // self.B, pos % self.B
        k = torch.as_tensor(slots, dtype=torch.int64, device=self.device)

        def scrub(a, value):
            a = a.clone()
            a[s_idx, b_idx, k] = value
            return a

        return state._replace(
            out_m=scrub(state.out_m, 0.0), out_c=scrub(state.out_c, 0.0),
            in_m=scrub(state.in_m, 0.0), in_c=scrub(state.in_c, 0.0),
            pending=scrub(state.pending, False))

    # -- dynamic membership ------------------------------------------------
    def apply_membership(self, dyn, rows=None) -> bool:
        """Catch the halo/local tables up to a mutated
        :class:`~repro_torch.core.topology.DynTopology`.

        The partition is fixed at construction over the topology's full
        capacity, so membership edits never move peers: only the touched
        rows' tables and the halo rows of their shard pairs are repaired
        (:func:`repro_torch.engine.partition.repair_sharded_topo`), and the
        device tables are rebuilt.  Returns True when the halo width (or
        the wire width) regrew.  ``rows`` overrides the changed-row set.
        """
        if rows is None:
            rows = dyn.changed_rows_since(self._topo_version)
        self._topo_version = dyn.version
        if rows.size == 0:
            return False
        old_width = self.stopo.halo_width
        old_wire_w = self._wire_w
        self.stopo = partition.repair_sharded_topo(
            self.stopo, dyn, rows,
            halo_slack=max(self.ecfg.halo_slack, 1.25))
        self.num_edges = self.stopo.num_edges
        # The wire width only ever grows within an engine's lifetime.
        self._wire_w = max(old_wire_w, self._wire_width())
        self._refresh_tables()
        return (self.stopo.halo_width != old_width
                or self._wire_w != old_wire_w)

    # -- wire format -------------------------------------------------------
    def _wire_width(self) -> int:
        """Halo width the wire transport ships: the full padded ``H`` for
        non-trimming formats; otherwise the last occupied table position
        (+1) rounded up to a byte boundary (flags bit-pack evenly)."""
        H = self.stopo.halo_width
        if not self._wire.trims:
            return H
        ok = np.asarray(self.stopo.halo.send_ok)
        occupied = ok * (np.arange(H, dtype=np.int64) + 1)[None, None, :]
        needed = int(occupied.max()) if occupied.size else 0
        return max(1, min(H, -(-needed // 8) * 8))

    def _wire_tables(self, tables: DeviceTopo) -> DeviceTopo:
        """Slice the device halo tables to the wire width (entries beyond
        it are all ``send_ok``-False padding)."""
        W = self._wire_w
        halo = tables.halo
        if W >= halo.send_ok.shape[-1]:
            return tables
        return tables._replace(halo=partition.HaloTables(
            *(a[:, :, :W] for a in halo)))

    def wire_pair_bytes(self, d: int) -> np.ndarray:
        """Modeled wire bytes per cycle per ordered shard pair ``(S, S)``
        for ``d``-dimensional statistics, in the active format."""
        return self._wire.pair_bytes(self._pair_counts, self._wire_w, int(d))

    # -- per-peer update (flattened rows) ----------------------------------
    def _peer_update(self, flat: lss.LSSState, live):
        """Violation test + selective correction on flattened (S*B, ...)
        rows: the post-delivery half of :func:`repro_torch.core.lss.
        cycle_impl`, through the same hooks and do-while.

        Returns ``(out_m, out_c, pending, last_send, corr_iters)``.
        """
        cfg = self.cfg
        status_viol = corrected = None
        if self.region_slot is not None:
            status_viol, corrected, entry = lss.suite_hooks(
                self.suite, flat, live, self._tables_for(cfg.eps), cfg)
        else:
            s = stopping.status(flat.x_m, flat.x_c, flat.out_m, flat.out_c,
                                flat.in_m, flat.in_c, live)
            a = stopping.agreements(flat.out_m, flat.out_c, flat.in_m,
                                    flat.in_c)
            entry = (s, a, stopping.violations_alg1(self.decide, s, a, live,
                                                    cfg.eps))
        timer_ok = (flat.t - flat.last_send) >= cfg.ell
        active = flat.alive & timer_ok & torch.any(entry[2], dim=-1)
        out_m, out_c, v, did_send, corr_iters = lss.correction_loop(
            self.decide, flat, self._flat_topo, live, active, cfg,
            status_viol=status_viol, corrected=corrected, entry=entry)
        pending = v & did_send[:, None]
        new_last = torch.where(did_send, flat.t, flat.last_send)
        return out_m, out_c, pending, new_last, corr_iters

    # -- one cycle, gather fallback (full arrays, one device) ---------------
    def _cycle_full(self, state: ShardedState, tables: DeviceTopo,
                    with_stats=False):
        """One engine cycle on full ``(S, B, ...)`` arrays.

        ``with_stats=True`` returns ``(state', corr_iters)`` — the
        correction do-while's iteration count, as ``lss.cycle_impl(
        with_stats=True)`` reports it.
        """
        cfg = self.cfg
        S, B, D = self.S, self.B, self.D
        d = state.x_m.shape[-1]
        nbr_alive = state.alive.reshape(S * B)[tables.tgt_pos]
        live = tables.mask & state.alive[..., None] & nbr_alive
        send = state.pending & live
        if cfg.drop_rate > 0.0:
            keep = lss._uniform(state.rng, send.shape, send.device)
            delivered = send & (keep >= cfg.drop_rate)
        else:
            delivered = send
        sent = torch.sum(send, dim=(1, 2))

        # Shard-local edges: the core's receive-side gather (in-slot (j, r)
        # reads its unique source slot through ``src``).
        got = delivered.reshape(S * B * D)[tables.src] & tables.intra
        in_m = torch.where(got[..., None],
                           state.out_m.reshape(S * B * D, d)[tables.src],
                           state.in_m)
        in_c = torch.where(got, state.out_c.reshape(S * B * D)[tables.src],
                           state.in_c)

        # Cross-shard edges: halo gather -> wire encode -> transpose ->
        # wire decode -> scatter.
        wire = self._wire
        payload = wire.encode(*exchange.gather_halo(
            state.out_m, state.out_c, delivered, tables.halo))
        payload = tuple(exchange.transpose_all_to_all(p) for p in payload)
        buf_m, buf_c, flag = wire.decode(payload)
        in_m, in_c = exchange.scatter_halo(in_m, in_c, buf_m, buf_c, flag,
                                           tables.halo)

        # Peer-local update on flattened rows.
        fl = lambda a: a.reshape(S * B, *a.shape[2:])  # noqa: E731
        flat = lss.LSSState(
            out_m=fl(state.out_m), out_c=fl(state.out_c), in_m=fl(in_m),
            in_c=fl(in_c), x_m=fl(state.x_m), x_c=fl(state.x_c),
            pending=fl(live), last_send=fl(state.last_send),
            alive=fl(state.alive), t=state.t, msgs=state.msgs, rng=None)
        out_m, out_c, pending, last_send, corr_iters = self._peer_update(
            flat, fl(live))
        sh = lambda a: a.reshape(S, B, *a.shape[1:])  # noqa: E731
        state = state._replace(
            out_m=sh(out_m), out_c=sh(out_c), in_m=in_m, in_c=in_c,
            pending=sh(pending), last_send=sh(last_send), t=state.t + 1,
            msgs=state.msgs + sent.to(state.msgs.dtype))
        if with_stats:
            return state, corr_iters
        return state

    # -- driver ------------------------------------------------------------
    def run(self, state: ShardedState, cycles: int) -> ShardedState:
        """Advance ``cycles`` cycles, ``cycles_per_dispatch`` (K) per
        dispatch.

        Each dispatch is an ``engine.dispatch`` span in the tracker with
        the JAX attributes ``k``, ``suite``, ``mode``, ``transport``
        ("gather"), ``fused``, ``wire``, ``halo_bytes`` (the active wire's
        modeled bytes over the dispatch) and ``cut_edges``; a non-noop
        tracker also gets per-shard ``engine_shard_halo_bytes_total``
        counters, ``engine_shard_cut_edges`` gauges and per-pair
        ``engine_halo_padding_frac`` gauges.  There is no ``recompiled``
        attribute: the port compiles nothing per dispatch.
        """
        from ..obs import NoopTracker

        k = max(1, self.ecfg.cycles_per_dispatch)
        transport = "gather"
        pair = self.wire_pair_bytes(state.x_m.shape[-1])  # (S, S) per cycle
        shard_bytes = pair.sum(axis=1)  # per src shard
        total_bytes = int(pair.sum())
        cut_edges = int(self._cuts.sum()) // 2
        publish = not isinstance(self.tracker, NoopTracker)
        done = 0
        while done < cycles:
            step = min(k, cycles - done)
            with self.tracker.span("engine.dispatch", k=step,
                                   suite=self.suite.name, mode="sync",
                                   transport=transport) as sp:
                for _ in range(step):
                    state = self._cycle_full(state, self._tables)
                sp.set("fused", self.dispatch_info["fused"])
                sp.set("wire", self._wire.name)
                sp.set("halo_bytes", total_bytes * step)
                sp.set("cut_edges", cut_edges)
                if publish:
                    self._publish_halo(step, transport, shard_bytes, pair)
            done += step
        return state

    def _publish_halo(self, step, transport, shard_bytes, pair) -> None:
        halo_c = self.tracker.counter(
            "engine_shard_halo_bytes_total",
            "cross-shard halo traffic per shard in wire-format bytes "
            "(active EngineConfig.wire serialization of the send tables)")
        cut_g = self.tracker.gauge(
            "engine_shard_cut_edges",
            "directed cross-shard edge slots per shard")
        pad_g = self.tracker.gauge(
            "engine_halo_padding_frac",
            "fraction of the shipped halo width that is send_ok-masked "
            "padding, per ordered shard pair (waste the compact wire "
            "removes)")
        wire_w = int(self._tables.halo.send_ok.shape[-1])
        for s in range(self.S):
            halo_c.inc(int(shard_bytes[s]) * step, shard=str(s),
                       transport=transport)
            cut_g.set(int(self._cuts[s]), shard=str(s))
            for tdst in range(self.S):
                if tdst != s and pair[s, tdst] > 0:
                    pad_g.set(1.0 - self._pair_counts[s, tdst] / wire_w,
                              src=str(s), dst=str(tdst))

    def drain_msgs(self, state: ShardedState):
        """Read-and-reset the device send counter: (state', exact int)."""
        total = int(torch.sum(state.msgs))
        return state._replace(msgs=torch.zeros_like(state.msgs)), total

    def total_msgs(self, state: ShardedState) -> torch.Tensor:
        return torch.sum(state.msgs)

    # -- observers ---------------------------------------------------------
    def _flat_state(self, state: ShardedState) -> lss.LSSState:
        fl = lambda a: a.reshape(self.S * self.B, *a.shape[2:])  # noqa: E731
        return lss.LSSState(
            out_m=fl(state.out_m), out_c=fl(state.out_c),
            in_m=fl(state.in_m), in_c=fl(state.in_c),
            x_m=fl(state.x_m), x_c=fl(state.x_c),
            pending=fl(state.pending), last_send=fl(state.last_send),
            alive=fl(state.alive), t=state.t, msgs=torch.sum(state.msgs),
            rng=state.rng[0])

    def metrics(self, state: ShardedState, eps: float = OBSERVE_EPS):
        """(accuracy, quiescent, correct-mask in original order) — the same
        numbers :func:`repro_torch.core.lss.metrics` reports.

        :func:`repro_torch.core.lss.metrics_impl` on the flat ``S*B``-row
        view: with the fused suite one ``lss_state`` launch and one global
        decision launch (padding rows are dead).
        """
        flat = self._flat_state(state)
        if self.suite.fused and self.region_slot is not None:
            acc, quiescent, correct, _ = lss.metrics_impl(
                flat, self._flat_topo, None, eps, suite=self.suite,
                regions=self._tables_for(eps))
        else:
            acc, quiescent, correct, _ = lss.metrics_impl(
                flat, self._flat_topo, self.decide, eps)
        return acc, quiescent, correct[self._pos]

    def to_lss_state(self, state: ShardedState) -> lss.LSSState:
        """Unpermute into a core :class:`LSSState` (parity tests, debug);
        ``rng`` is shard 0's generator."""
        take = lambda a: a.reshape(  # noqa: E731
            self.S * self.B, *a.shape[2:])[self._pos]
        return lss.LSSState(
            out_m=take(state.out_m), out_c=take(state.out_c),
            in_m=take(state.in_m), in_c=take(state.in_c),
            x_m=take(state.x_m), x_c=take(state.x_c),
            pending=take(state.pending), last_send=take(state.last_send),
            alive=take(state.alive), t=state.t,
            msgs=torch.sum(state.msgs), rng=state.rng[0])

    def place_lss_state(self, snap: lss.LSSState) -> ShardedState:
        """Inverse of :meth:`to_lss_state`: place a core-layout state into
        this engine's shard layout (init values everywhere, then the logical
        rows through ``new_of_old``).  ``snap`` may cover fewer rows /
        degree slots than this engine's capacity; missing ones stay at
        init values.

        Not carried row-for-row: the aggregate send counter lands on shard
        0, and the per-shard drop generators are seeded from draws of a
        copy of ``snap.rng`` (:meth:`migrate_from` between equal shard
        counts carries them verbatim instead).
        """
        S, B, D = self.S, self.B, self.D
        dev = self.device
        n1 = snap.alive.shape[0]
        if n1 > self.n:
            raise ValueError(f"snapshot covers {n1} rows > capacity {self.n}")
        D1 = snap.out_c.shape[-1]
        if D1 > D:
            raise ValueError(f"snapshot has {D1} degree slots > {D}")
        pos = self._pos[:n1]
        d = snap.x_m.shape[-1]
        dt = snap.x_m.dtype

        def place(src, shape, fill, dtype, slots):
            out = torch.full((S * B,) + shape, fill, dtype=dtype, device=dev)
            if slots:
                out[pos, :D1] = src.to(device=dev, dtype=dtype)
            else:
                out[pos] = src.to(device=dev, dtype=dtype)
            return out.reshape((S, B) + shape)

        g = _copy_generator(snap.rng)
        seeds = torch.randint(0, 2 ** 62, (S,), generator=g,
                              device=g.device).tolist()
        msgs = torch.zeros((S,), dtype=lss.counter_dtype(), device=dev)
        msgs[0] = torch.as_tensor(snap.msgs, device=dev)
        return ShardedState(
            out_m=place(snap.out_m, (D, d), 0.0, dt, True),
            out_c=place(snap.out_c, (D,), 0.0, dt, True),
            in_m=place(snap.in_m, (D, d), 0.0, dt, True),
            in_c=place(snap.in_c, (D,), 0.0, dt, True),
            x_m=place(snap.x_m, (d,), 0.0, dt, False),
            x_c=place(snap.x_c, (), 0.0, dt, False),
            pending=place(snap.pending, (D,), False, torch.bool, True),
            last_send=place(snap.last_send, (), lss.COLD_TIMER, torch.int32,
                            False),
            alive=place(snap.alive, (), False, torch.bool, False),
            t=torch.as_tensor(snap.t, dtype=torch.int32, device=dev).clone(),
            msgs=msgs,
            rng=tuple(lss._generator(dev, s) for s in seeds),
        )

    def migrate_from(self, old: "ShardedLSS",
                     state: ShardedState) -> ShardedState:
        """Move ``old``'s state into THIS engine's layout (one epoch).

        Gather across :func:`repro_torch.engine.partition.migrate_rows`,
        then :meth:`place_lss_state`'s scatter.  With an equal shard count
        the per-shard drop generators carry over verbatim (copied), so a
        regrow / rebalance epoch does not touch the drop sequence.
        """
        src, _ = partition.migrate_rows(old.part, self.part)
        src = torch.as_tensor(src, device=old.device)

        def move(a):
            return a.reshape(old.S * old.B, *a.shape[2:])[src]

        snap = lss.LSSState(
            out_m=move(state.out_m), out_c=move(state.out_c),
            in_m=move(state.in_m), in_c=move(state.in_c),
            x_m=move(state.x_m), x_c=move(state.x_c),
            pending=move(state.pending), last_send=move(state.last_send),
            alive=move(state.alive), t=state.t,
            msgs=torch.sum(state.msgs), rng=state.rng[0])
        placed = self.place_lss_state(snap)
        if old.S == self.S:
            placed = placed._replace(
                rng=tuple(_copy_generator(g) for g in state.rng))
        return placed
