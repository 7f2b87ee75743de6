"""ShardedLSS — the exact :mod:`repro_torch.core.lss` semantics over a
partitioned peer population (port of ``repro/engine/engine.py``, the
single-device gather path, sync and async).

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

Async mode (``EngineConfig.async_mode`` / :meth:`ShardedLSS.init_async`):
every shard keeps its own clock, publishes its boundary sends into a
bounded-staleness ring (:func:`repro_torch.engine.exchange.ring_publish`)
and reads every peer shard at a receiver-chosen delay of up to
``EngineConfig.staleness`` cycles; Alg. 1's per-message sequence numbers
drop reordered and superseded deliveries.  At ``staleness=0`` the mode is
bitwise the sync engine, drop stream included: the delays come from a
second set of per-shard generators, drawn only when ``staleness > 0``.

**Tenant axis.**  The service's engine backend stacks Q tenants' states on
a leading axis (``out_m`` (Q, S, B, D, d), ``t`` (Q,), ``msgs`` (Q, S),
``rng`` Q tuples of S generators), which the JAX service gets from
``vmap`` over :meth:`ShardedLSS._cycle_full`.  The sync cycle, the
observe (:meth:`ShardedLSS._metrics_impl`), the slot scrub and the
layout moves (:meth:`~ShardedLSS.to_lss_state`,
:meth:`~ShardedLSS.place_lss_state`, :meth:`~ShardedLSS.migrate_from`)
take it; the per-peer update runs on ``(Q, S*B, ...)`` rows, the core's
stacked layout, so each kernel launches once for all Q tenants.  The
cycle's per-call overrides (``cfg`` with per-tenant ``beta``/``ell``/
``eps``, the active-tenant ``gate``, the tenants' prepared ``regions``
tables, or an opaque ``decide``) are keyword arguments.

Differences from the JAX twin: a dispatch of ``cycles_per_dispatch`` (K)
cycles is a host loop, not one compiled ``fori_loop`` with donated buffers:
K is the grain of one ``engine.dispatch`` span and of the driver's
bookkeeping.  Functions are pure (they return new states and never write
into the tensors they are given), apart from :meth:`ShardedLSS.scrub_slots`,
the in-place form of ``clear_slots`` the service's membership edits use;
the drop and delay generators advance in place, as in the core, and
:meth:`ShardedLSS.run` copies an async state's ring once per call and then
writes only the published slot each cycle.
``EngineConfig(profile=True)`` wraps each dispatch's K-cycle loop in a
:class:`~repro_torch.obs.ProfiledDispatch` (host/device split, fenced by a
CUDA event on the card).

**Collective transport** (:meth:`ShardedLSS.use_mesh`).  JAX drives S
devices from one program through global sharded arrays; here every
process is one rank of a ``torch.distributed`` group and holds one shard.
Each rank builds the same host tables (the partition is deterministic)
and cycles on its own shard's row of the device tables (the whole tables
serve the gathered observers); its state is the
shard's block, a :class:`ShardedState` whose shard axis has length 1 (the
drop stream is the gather fallback's generator of that shard, ``t`` is
replicated, ``msgs`` is ``(1,)``).  A cycle (:meth:`ShardedLSS.
_cycle_block`, the twin of JAX's) all-gathers ``alive``, delivers the
shard-local edges, gathers and encodes the boundary sends, moves each
payload tensor with :func:`~repro_torch.engine.exchange.
collective_all_to_all`, decodes and scatters, and updates the block's B
rows through the same hooks and do-while: bitwise the gather fallback's
rows, since no per-row result depends on how many rows a launch holds.
The observers (:meth:`~ShardedLSS.metrics`, :meth:`~ShardedLSS.
to_lss_state`, :meth:`~ShardedLSS.total_msgs`, :meth:`~ShardedLSS.audit`)
gather the blocks, so every rank reads the same global numbers; the data
and membership hooks take global peer ids and apply those of the rank's
shard.  The async ring runs on the block too (:meth:`ShardedLSS.
_cycle_async_block`): a rank keeps its own clock, sequence books and the
ring column of the messages addressed to it, and its delay generator is
the gather fallback's of its shard.  The layout moves
(:meth:`~ShardedLSS.place_lss_state`, :meth:`~ShardedLSS.migrate_from`)
build the fallback's layout on every rank and keep the rank's block.

``EngineConfig(auto_plan=True)`` plans the configuration at construction
(:mod:`.autotune`: probe engines counted by
:func:`repro_torch.launch.cost.analyze` and timed on the engine's device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import resolve_device
from ..core import lss, regions, stopping, topology, wvs
from ..core.sim import OBSERVE_EPS
from ..distributed import collective
from ..kernels import ops as kernel_ops
from ..kernels import suite as kernel_suite
from . import exchange, partition

__all__ = ["DeviceTopo", "EngineConfig", "MembershipRepair", "ShardedState",
           "AsyncShardedState", "ShardedLSS"]


class _MeshBinding(NamedTuple):
    """What :meth:`ShardedLSS.use_mesh` attaches: the mesh, its shard axis,
    that axis's process group and this process's shard on it."""

    mesh: object  # torch.distributed.device_mesh.DeviceMesh
    axis: str
    group: object  # torch.distributed.ProcessGroup
    rank: int  # this process's shard (its coordinate on ``axis``)


class _BlockTables(NamedTuple):
    """One shard's row of the :class:`DeviceTopo` tables, for a cycle on
    that shard's ``(1, B, ...)`` block.  ``src`` indexes the block's own
    ``B*D`` slots (meaningful on ``intra`` slots); ``tgt_pos`` stays the
    global flat position, for the all-gathered ``alive``; ``topo`` is the
    block's view for the do-while (which reads its slot count)."""

    mask: torch.Tensor  # bool  (B, D)
    tgt_pos: torch.Tensor  # int64 (B, D)
    src: torch.Tensor  # int64 (B, D)
    intra: torch.Tensor  # bool  (B, D)
    halo: partition.HaloTables  # (S, H) each
    topo: lss.TopoArrays  # (B, D)

    @classmethod
    def of(cls, tables: "DeviceTopo", r: int) -> "_BlockTables":
        B, D = tables.mask.shape[1:]
        tgt_pos, rev, mask = tables.tgt_pos[r], tables.rev[r], tables.mask[r]
        intra = tables.intra[r]
        local_row = torch.where(intra, tgt_pos - r * B, 0)
        return cls(mask=mask, tgt_pos=tgt_pos,
                   src=local_row * D + rev.to(torch.int64), intra=intra,
                   halo=partition.HaloTables(*(a[r] for a in tables.halo)),
                   topo=lss.TopoArrays(nbr=tgt_pos, mask=mask, rev=rev))


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
    def from_sharded(cls, st: partition.ShardedTopo, device,
                     pin: bool = False) -> "DeviceTopo":
        """The tables of ``st`` on ``device``; with ``pin``, in pinned host
        memory instead, for a later asynchronous :meth:`to`."""
        def t(a, dtype):
            if pin:
                src = torch.from_numpy(np.ascontiguousarray(a))
                return torch.empty(src.shape, dtype=dtype,
                                   pin_memory=True).copy_(src)
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

    def to(self, device) -> "DeviceTopo":
        """The tables copied to ``device``; from pinned host tables the
        copy is asynchronous, ordered on the current stream before the
        kernels that read it."""
        def mv(a):
            return a.to(device, non_blocking=True)

        return DeviceTopo(*(mv(a) for a in self[:-1]),
                          halo=partition.HaloTables(*(mv(a)
                                                      for a in self.halo)))

    def flat(self) -> lss.TopoArrays:
        """The core's view over all ``S*B`` rows: ``(nbr=tgt_pos, mask,
        rev)`` keeps the slot involution across shard boundaries."""
        S, B, D = self.mask.shape
        return lss.TopoArrays(nbr=self.tgt_pos.reshape(S * B, D),
                              mask=self.mask.reshape(S * B, D),
                              rev=self.rev.reshape(S * B, D))


class MembershipRepair(NamedTuple):
    """A membership repair prepared on the host
    (:meth:`ShardedLSS.prepare_membership`), installed by
    :meth:`ShardedLSS.install_membership`."""

    version: int  # the DynTopology version the repair catches up to
    stopo: Optional[partition.ShardedTopo]  # None: no adjacency changed
    wire_w: int  # the wire width after the repair
    tables: Optional[DeviceTopo]  # host tables, trimmed to wire_w


class EngineConfig(NamedTuple):
    """Every field of the JAX ``EngineConfig``, with its default."""

    num_shards: int = 2
    cycles_per_dispatch: int = 8  # K cycles per dispatch (one span)
    method: str = "bfs"  # partitioner: "bfs" | "stride"
    # Kernel suite: None = auto (the CUDA kernels on a CUDA device, the
    # reference formulas on the CPU), bool, or a registered suite name.
    use_kernels: Union[bool, str, None] = None
    halo_slack: float = 1.0  # >1 pads halo width for membership headroom
    profile: bool = False  # ProfiledDispatch around each dispatch
    async_mode: bool = False  # per-shard clocks + the bounded-stale ring
    staleness: int = 0  # halo reads may lag the sender by <= this many cycles
    wire: str = "exact"  # "exact" | "compact" | "int8" | "bf16"
    auto_plan: bool = False  # plan (S, slack, K, wire) at construction


class ShardedState(NamedTuple):
    """:class:`repro_torch.core.lss.LSSState`, blocked ``(S, B, ...)`` per
    shard (with a leading tenant axis Q for the service's stacked state:
    ``(Q, S, B, ...)``, ``t`` (Q,), ``msgs`` (Q, S), ``rng`` Q tuples).

    The two trailing ``wire_err_*`` fields exist only under a stateful
    (quantized) wire: per-out-slot error-feedback buffers in
    membership-stable ``(S, B, D, ...)`` coordinates, independent of the
    halo width.  ``None`` everywhere else.
    """

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
    wire_err_m: Optional[torch.Tensor] = None  # (S, B, D, d) quant error
    wire_err_c: Optional[torch.Tensor] = None  # (S, B, D)


class AsyncShardedState(NamedTuple):
    """Async-mode engine state: the sync per-shard state plus the
    bounded-staleness transport books.

    ``clock`` is per shard.  In this single-dispatcher engine all shards
    step together, so the clocks stay equal, but every timer, ring and
    sequence computation reads the per-shard value.  ``R = staleness + 1``
    ring slots of the wire's halo width keep a publication for exactly
    the read window that may still target it.  ``delay_rng`` (not in the
    JAX twin, whose delay keys split off ``rng``) holds the per-shard
    generators of the receivers' delay draws.  Under a mesh a rank holds
    its shard's part: books of length 1 on the shard axis, the ring column
    ``(R, S, 1, H, ...)`` of the messages addressed to it, its shard's
    delay generator.
    """

    sync: ShardedState  # the paper state, (S, B, ...)
    clock: torch.Tensor  # (S,) int32 per-shard local clocks
    out_seq: torch.Tensor  # (S, B, D) int32 — seq of the newest posting
    last_seq: torch.Tensor  # (S, B, D) int32 — newest applied seq
    ring_m: torch.Tensor  # (R, S, S, H, d) published halo payloads
    ring_c: torch.Tensor  # (R, S, S, H)
    ring_flag: torch.Tensor  # (R, S, S, H) bool
    ring_seq: torch.Tensor  # (R, S, S, H) int32
    stale_drops: torch.Tensor  # (S,) seq-guarded (reordered) drops
    applied: torch.Tensor  # (S,) cross-shard messages applied
    delay_sum: torch.Tensor  # (S,) total realized delay of applied messages
    delay_rng: tuple  # S torch.Generators: per-shard delay streams


# An async state's per-shard books and its rings (ring axis, src, dst, H).
_BOOKS = ("clock", "out_seq", "last_seq", "stale_drops", "applied",
          "delay_sum")
_RINGS = ("ring_m", "ring_c", "ring_flag", "ring_seq")


def _copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def _shard_generators(device, seed: int, num: int) -> tuple:
    """``num`` drop streams derived from one seed."""
    seeds = np.random.SeedSequence(int(seed)).generate_state(num)
    return tuple(lss._generator(device, s) for s in seeds)


def _delay_generators(rng: tuple) -> tuple:
    """One delay stream per shard, seeded from a draw of a COPY of that
    shard's drop generator (the drop streams themselves do not move)."""
    out = []
    for g in rng:
        seed = torch.randint(0, 2 ** 62, (1,), generator=_copy_generator(g),
                             device=g.device)
        out.append(lss._generator(g.device, int(seed)))
    return tuple(out)


def _lead(state) -> tuple:
    """The leading tenant axes of a sync state: ``()`` or ``(Q,)``."""
    return tuple(state.x_c.shape[:-2])


def _at(nl: int, *idx) -> tuple:
    """An index tuple that skips ``nl`` leading axes."""
    return (slice(None),) * nl + idx


def _uniform(rng, shape, device) -> torch.Tensor:
    """Drop draws, one ``shape[-2:]`` block per shard generator; for Q
    tenants' states (Q tuples of S generators) stacked per tenant."""
    if isinstance(rng[0], torch.Generator):
        return lss._uniform(rng, shape, device)
    return torch.stack([lss._uniform(r, shape[1:], device) for r in rng])


def _opaque_decide_error() -> ValueError:
    return ValueError(
        "the fused suite routes decisions through the packed CUDA "
        "kernels and cannot honor an opaque `decide` callable — "
        "pass `region=` (a region family) instead, or "
        "use_kernels=False for the reference formulas")


def _sync_only(state, what: str) -> None:
    """The dynamic-data hooks take a :class:`ShardedState`, as in JAX."""
    if isinstance(state, AsyncShardedState):
        raise TypeError(
            f"ShardedLSS.{what} takes a ShardedState, not an "
            "AsyncShardedState: edit `astate.sync` and re-wrap it with "
            "wrap_async")


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
        from ..obs import NoopTracker, ProfiledDispatch  # local: no cycle

        self.device = resolve_device(device)
        if ecfg.auto_plan:
            # Enumerate (S, slack, K, wire) candidates around this config,
            # count and time a probe dispatch of each on this device, adopt
            # the winner.  The probes build with auto_plan=False.
            from . import autotune  # local: autotune constructs engines

            ecfg = autotune.plan(topo, centers, cfg=cfg, base=ecfg,
                                 device=self.device).config
        self._wire = exchange.get_wire(ecfg.wire)
        self.cfg = cfg
        self.ecfg = ecfg
        self.tracker = tracker if tracker is not None else NoopTracker()
        self._profiled = (ProfiledDispatch(self._k_cycles, self.tracker,
                                           backend="engine")
                          if ecfg.profile else None)
        self._mesh = None  # a _MeshBinding once use_mesh attaches one
        self._block = None  # this rank's _BlockTables under a mesh
        self.staged_bytes = 0  # halo payload bytes staged through the host
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
            raise _opaque_decide_error()
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
        self._wire_w = self._wire_width(self.stopo)
        self._install_tables(self._wire_tables(
            DeviceTopo.from_sharded(self.stopo, self.device), self._wire_w))
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

    def _install_tables(self, tables: DeviceTopo) -> None:
        """Swap in device tables (trimmed to the wire width) and the
        host-side halo statistics :meth:`run` reports, from
        ``self.stopo``."""
        st = self.stopo
        self._tables = tables
        self._flat_topo = tables.flat()
        if self._mesh is not None:
            self._block = _BlockTables.of(tables, self._mesh.rank)
        self._pair_counts = np.asarray(st.halo.send_ok).sum(axis=-1)
        self._cuts = (st.mask & ~st.intra).reshape(self.S, -1).sum(axis=1)

    # -- mesh attachment ---------------------------------------------------
    def use_mesh(self, mesh, axis_name: str) -> "ShardedLSS":
        """Route the halo exchange through ``all_to_all`` over the process
        group of ``mesh``'s axis ``axis_name`` (a ``torch.distributed.
        device_mesh.DeviceMesh``): this process becomes the shard at its
        coordinate on that axis, whose size must equal ``num_shards``.

        Every rank of the group calls it, then :meth:`init` (which returns
        the rank's block, sync or async) and :meth:`run` in step with the
        others.
        """
        size = collective.axis_size(mesh, axis_name)
        if size != self.S:
            raise ValueError(
                f"mesh axis {axis_name!r} has size {size}, "
                f"engine has {self.S} shards")
        from ..obs import ProfiledDispatch  # local: no cycle

        self._mesh = _MeshBinding(mesh, axis_name,
                                  mesh.get_group(axis_name),
                                  int(mesh.get_local_rank(axis_name)))
        self._block = _BlockTables.of(self._tables, self._mesh.rank)
        if self.ecfg.profile:
            self._profiled = ProfiledDispatch(self._k_cycles, self.tracker,
                                              backend="engine-mesh")
        return self

    # -- state -------------------------------------------------------------
    def init(self, inputs: wvs.WV, seed: int = 0, alive=None):
        """Build sharded state from inputs in ORIGINAL peer order.

        ``alive`` (optional bool (n,), original order) seeds the churn mask
        — a capacity-padded DynTopology passes its ``present`` mask so spare
        rows start dead.  With ``EngineConfig.async_mode`` the result is an
        :class:`AsyncShardedState` (:meth:`init_sync` gives the bare sync
        state).
        """
        if self.ecfg.async_mode:
            return self.init_async(inputs, seed=seed, alive=alive)
        return self.init_sync(inputs, seed=seed, alive=alive)

    def init_sync(self, inputs: wvs.WV, seed: int = 0,
                  alive=None) -> ShardedState:
        """:meth:`init`'s sync-state half, mode flag ignored."""
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
        state = ShardedState(
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
        if self._wire.stateful:
            # Quantization error feedback, per out-slot.
            state = state._replace(
                wire_err_m=torch.zeros((S, B, D, d), dtype=torch.float32,
                                       device=dev),
                wire_err_c=torch.zeros((S, B, D), dtype=torch.float32,
                                       device=dev))
        if self._mesh is not None:
            state = self._block_of(state, self._mesh.rank)
        return state

    @staticmethod
    def _block_of(state: ShardedState, r: int) -> ShardedState:
        """Shard ``r``'s block of a full sync state: every per-shard field
        ``[r:r+1]`` (a copy), ``t`` as is, shard ``r``'s drop stream."""
        def take(a):
            if a is None or a.ndim == 0:
                return a
            return a[r:r + 1].clone()

        return ShardedState(*(take(a) for a in state[:-3]),
                            rng=(state.rng[r],),
                            wire_err_m=take(state.wire_err_m),
                            wire_err_c=take(state.wire_err_c))

    def gather_state(self, state):
        """Under a mesh, the full ``(S, B, ...)`` state from every rank's
        block (every rank gets it; ``rng`` stays this rank's one
        generator).  An async block also gathers its books and its ring
        column into the fallback's ``(R, S_src, S_dst, H, ...)`` ring
        (``delay_rng``: this rank's).  Without a mesh, ``state`` itself."""
        if self._mesh is None:
            return state
        full = self._full
        if isinstance(state, AsyncShardedState):
            return state._replace(
                sync=self.gather_state(state.sync),
                **{f: full(getattr(state, f)) for f in _BOOKS},
                **{f: self._full_ring(getattr(state, f)) for f in _RINGS})
        return ShardedState(*(full(a) for a in state[:-3]), rng=state.rng,
                            wire_err_m=full(state.wire_err_m),
                            wire_err_c=full(state.wire_err_c))

    def _full(self, a):
        """Every rank's per-shard ``a`` concatenated on the shard axis
        (None and scalars as they are)."""
        if a is None or a.ndim == 0:
            return a
        return collective.all_gather(a, self._mesh.group)

    def _full_ring(self, a):
        """Every rank's ring column ``(R, S, 1, H, ...)`` (the fallback's
        ``[:, :, r]``) as the fallback's ``(R, S_src, S_dst, H, ...)``."""
        return self._full(a.movedim(2, 0)).movedim(0, 2).contiguous()

    def init_async(self, inputs: wvs.WV, seed: int = 0,
                   alive=None) -> AsyncShardedState:
        """Async-mode init: the sync state wrapped with cold transport
        books (empty ring, zero clocks and sequence counters)."""
        return self.wrap_async(self.init_sync(inputs, seed=seed, alive=alive))

    def wrap_async(self, base: ShardedState) -> AsyncShardedState:
        """Wrap a sync state for async execution.  The ring starts empty,
        so the first async cycle is the sync cycle from the same state.
        The delay generators are seeded from the drop generators (which
        stay where they are).  Under a mesh ``base`` is the rank's block:
        the books are its shard's (``(1, ...)``), the ring its column
        ``(R, S, 1, H, ...)``, the delay generator the fallback's of its
        shard."""
        S, B, D = self.S, self.B, self.D
        own = base.x_c.shape[-2]  # S, or 1 for a rank's block
        dev = self.device
        # Ring slots follow the WIRE width (trimmed tables): the ring holds
        # what the transport ships.
        H = int(self._tables.halo.send_ok.shape[-1])
        R = max(1, int(self.ecfg.staleness) + 1)
        d = base.x_m.shape[-1]
        dt = base.x_m.dtype
        i32, cnt = torch.int32, lss.counter_dtype()

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return AsyncShardedState(
            sync=base,
            clock=base.t.to(i32).repeat(own),
            out_seq=zeros((own, B, D), i32),
            last_seq=zeros((own, B, D), i32),
            ring_m=zeros((R, S, own, H, d), dt),
            ring_c=zeros((R, S, own, H), dt),
            ring_flag=zeros((R, S, own, H), torch.bool),
            ring_seq=zeros((R, S, own, H), i32),
            stale_drops=zeros((own,), cnt), applied=zeros((own,), cnt),
            delay_sum=zeros((own,), cnt),
            delay_rng=_delay_generators(base.rng))

    # -- dynamic-data hooks (original peer ids) ------------------------------
    def _positions(self, who) -> torch.Tensor:
        return self._pos[torch.as_tensor(who, dtype=torch.int64,
                                         device=self.device)]

    def _rows(self, who):
        """Flat row positions of original ids ``who`` in a state, and which
        entries of ``who`` they are: all of them, or under a mesh those in
        this rank's shard (positions in its block)."""
        pos = self._positions(who)
        if self._mesh is None:
            return pos, slice(None)
        r = self._mesh.rank
        keep = (pos // self.B) == r
        return pos[keep] - r * self.B, keep

    def set_inputs(self, state: ShardedState, who, new_x) -> ShardedState:
        """Resample inputs: ``x_m[who] = new_x`` (moment form, weight kept)."""
        _sync_only(state, "set_inputs")
        pos, keep = self._rows(who)
        flat = state.x_m.reshape(-1, state.x_m.shape[-1]).clone()
        flat[pos] = torch.as_tensor(new_x, dtype=flat.dtype,
                                    device=self.device)[keep]
        return state._replace(x_m=flat.reshape(state.x_m.shape))

    def kill_peers(self, state: ShardedState, who) -> ShardedState:
        """Churn: permanently mark original ids ``who`` dead."""
        return self.set_alive(state, who, False)

    def set_alive(self, state: ShardedState, who, value: bool
                  ) -> ShardedState:
        """Set the churn mask of original ids ``who`` (True = join)."""
        _sync_only(state, "set_alive")
        flat = state.alive.reshape(-1).clone()
        flat[self._rows(who)[0]] = bool(value)
        return state._replace(alive=flat.reshape(state.alive.shape))

    @staticmethod
    def _slot_fields(state: ShardedState) -> tuple:
        """The per-slot messaging fields a scrub resets (the error
        feedback too under a stateful wire)."""
        fields = ("out_m", "out_c", "in_m", "in_c", "pending")
        if state.wire_err_m is not None:
            fields += ("wire_err_m", "wire_err_c")
        return fields

    def clear_slots(self, state: ShardedState, rows, slots) -> ShardedState:
        """Scrub the messaging state of ``(peer, slot)`` coordinates in
        ORIGINAL ids — the engine-layout counterpart of
        :func:`repro_torch.core.lss.clear_slots`; a slot's quantization
        debt dies with its message.  Every tenant of a stacked state is
        scrubbed.  Pure: :meth:`scrub_slots` is the in-place form."""
        _sync_only(state, "clear_slots")
        return self.scrub_slots(state._replace(**{
            f: getattr(state, f).clone() for f in self._slot_fields(state)}),
            rows, slots)

    def scrub_slots(self, state: ShardedState, rows, slots) -> ShardedState:
        """:meth:`clear_slots` written into ``state``'s own tensors."""
        pos, keep = self._rows(rows)
        at = _at(len(_lead(state)), pos // self.B, pos % self.B,
                 torch.as_tensor(slots, dtype=torch.int64,
                                 device=self.device)[keep])
        for f in self._slot_fields(state):
            getattr(state, f)[at] = False if f == "pending" else 0.0
        return state

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

        :meth:`prepare_membership` (the host work) then
        :meth:`install_membership` (the upload and the swap); the
        overlapped service runs the first while a dispatch still reads the
        installed tables.
        """
        return self.install_membership(self.prepare_membership(dyn, rows))

    def prepare_membership(self, dyn, rows=None) -> MembershipRepair:
        """The host half of :meth:`apply_membership`: the repaired
        :class:`~repro_torch.engine.partition.ShardedTopo`, its wire width
        and its tables in (pinned, for a CUDA engine) host memory.  Reads
        the engine and writes nothing of it."""
        if rows is None:
            rows = dyn.changed_rows_since(self._topo_version)
        if rows.size == 0:
            return MembershipRepair(dyn.version, None, self._wire_w, None)
        stopo = partition.repair_sharded_topo(
            self.stopo, dyn, rows,
            halo_slack=max(self.ecfg.halo_slack, 1.25))
        # The wire width only ever grows within an engine's lifetime.
        wire_w = max(self._wire_w, self._wire_width(stopo))
        host = DeviceTopo.from_sharded(stopo, "cpu",
                                       pin=self.device.type == "cuda")
        return MembershipRepair(dyn.version, stopo, wire_w,
                                self._wire_tables(host, wire_w))

    def install_membership(self, rep: MembershipRepair) -> bool:
        """The device half of :meth:`apply_membership`: upload ``rep``'s
        tables and swap them in.  Returns True when the halo width (or the
        wire width) regrew."""
        self._topo_version = rep.version
        if rep.stopo is None:
            return False
        grew = (rep.stopo.halo_width != self.stopo.halo_width
                or rep.wire_w != self._wire_w)
        self.stopo, self._wire_w = rep.stopo, rep.wire_w
        self.num_edges = rep.stopo.num_edges
        self._install_tables(rep.tables.to(self.device))
        return grew

    # -- wire format -------------------------------------------------------
    def _wire_width(self, stopo: partition.ShardedTopo) -> int:
        """Halo width the wire transport ships for ``stopo``'s tables: the
        full padded ``H`` for non-trimming formats; otherwise the last
        occupied table position (+1) rounded up to a byte boundary (flags
        bit-pack evenly)."""
        H = stopo.halo_width
        if not self._wire.trims:
            return H
        ok = np.asarray(stopo.halo.send_ok)
        occupied = ok * (np.arange(H, dtype=np.int64) + 1)[None, None, :]
        needed = int(occupied.max()) if occupied.size else 0
        return max(1, min(H, -(-needed // 8) * 8))

    @staticmethod
    def _wire_tables(tables: DeviceTopo, W: int) -> DeviceTopo:
        """Slice the halo tables to the wire width ``W`` (entries beyond
        it are all ``send_ok``-False padding)."""
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
    def _peer_update(self, flat: lss.LSSState, live, cfg=None, decide=None,
                     gate=None, regions=None, topo=None):
        """Violation test + selective correction on flattened (S*B, ...)
        rows, or (Q, S*B, ...) for stacked tenants: the post-delivery half
        of :func:`repro_torch.core.lss.cycle_impl`, through the same hooks
        and do-while.  ``flat.t`` broadcasts against ``last_send``.

        ``cfg``/``decide``/``gate``/``regions`` override the engine's own
        (the service passes per-tenant knobs, the active-tenant gate and
        the tenants' prepared tables; see :meth:`_cycle_full`); ``topo``
        is the rows' view (default: all ``S*B`` rows).  Returns
        ``(out_m, out_c, pending, last_send, corr_iters)``.
        """
        cfg = self.cfg if cfg is None else cfg
        if regions is None and decide is None:
            decide = self.decide
            if self.region_slot is not None:
                regions = self._tables_for(cfg.eps)
        status_viol = corrected = None
        if regions is not None:
            status_viol, corrected, entry = lss.suite_hooks(
                self.suite, flat, live, regions, cfg)
        else:
            if self.suite.fused:
                raise _opaque_decide_error()
            s = stopping.status(flat.x_m, flat.x_c, flat.out_m, flat.out_c,
                                flat.in_m, flat.in_c, live)
            a = stopping.agreements(flat.out_m, flat.out_c, flat.in_m,
                                    flat.in_c)
            entry = (s, a, stopping.violations_alg1(decide, s, a, live,
                                                    cfg.eps))
        timer_ok = ((flat.t - flat.last_send)
                    >= wvs.lead(cfg.ell, flat.last_send))
        active = flat.alive & timer_ok & torch.any(entry[2], dim=-1)
        if gate is not None:
            active = active & wvs.lead(gate, active)
        out_m, out_c, v, did_send, corr_iters = lss.correction_loop(
            decide, flat, self._flat_topo if topo is None else topo, live,
            active, cfg,
            status_viol=status_viol, corrected=corrected, entry=entry)
        pending = v & did_send[..., None]
        new_last = torch.where(did_send, flat.t, flat.last_send)
        return out_m, out_c, pending, new_last, corr_iters

    # -- one cycle, gather fallback (full arrays, one device) ---------------
    def _deliver_local(self, state: ShardedState, tables: DeviceTopo,
                       drop_rate=None):
        """A cycle's start, the same in both modes: live slots, the drop
        draw and the shard-local deliveries (the core's receive-side
        gather: in-slot (j, r) reads its unique source slot through
        ``src``), every tenant of a stacked state through the same
        tables.  Returns ``(live, delivered, sent, in_m, in_c)``."""
        S, B, D = self.S, self.B, self.D
        lead = _lead(state)
        d = state.x_m.shape[-1]
        drop_rate = self.cfg.drop_rate if drop_rate is None else drop_rate
        nbr_alive = state.alive.reshape(*lead, S * B)[..., tables.tgt_pos]
        live = tables.mask & state.alive[..., None] & nbr_alive
        send = state.pending & live
        if drop_rate > 0.0:
            keep = _uniform(state.rng, send.shape, send.device)
            delivered = send & (keep >= drop_rate)
        else:
            delivered = send
        sent = torch.sum(send, dim=(-2, -1))
        got = (delivered.reshape(*lead, S * B * D)[..., tables.src]
               & tables.intra)
        in_m = torch.where(
            got[..., None],
            state.out_m.reshape(*lead, S * B * D, d)[..., tables.src, :],
            state.in_m)
        in_c = torch.where(
            got, state.out_c.reshape(*lead, S * B * D)[..., tables.src],
            state.in_c)
        return live, delivered, sent, in_m, in_c

    def _encode_halo(self, state: ShardedState, tables: DeviceTopo,
                     delivered):
        """Gather the boundary sends and encode them in the active wire;
        a stateful wire reads and updates the per-out-slot error feedback.
        Returns ``(payload, wire_err_m, wire_err_c)``."""
        wire = self._wire
        nl = len(_lead(state))
        bufs = exchange.gather_halo(state.out_m, state.out_c, delivered,
                                    tables.halo, batch=nl)
        if not wire.stateful:
            payload, _, _ = wire.encode(*bufs)
            return payload, state.wire_err_m, state.wire_err_c
        payload, n_em, n_ec = wire.encode(*bufs, *exchange.gather_err(
            state.wire_err_m, state.wire_err_c, tables.halo, batch=nl))
        return (payload, *exchange.scatter_err(
            state.wire_err_m, state.wire_err_c, n_em, n_ec, tables.halo,
            batch=nl))

    def _update(self, state: ShardedState, live, in_m, in_c, t, **over):
        """The peer-local update on the flattened rows, reshaped back to
        ``(S, B, ...)`` (``(Q, S, B, ...)`` for stacked tenants, ``(1, B,
        ...)`` for one rank's block): ``(out_m, out_c, pending, last_send,
        corr_iters)``.  ``t`` is the scalar cycle, one clock per row, or one
        cycle per tenant shaped (Q, 1); ``over`` are :meth:`_peer_update`'s
        overrides."""
        lead = _lead(state)
        S, B = state.x_c.shape[-2:]
        nl = len(lead)
        fl = lambda a: a.reshape(*lead, S * B, *a.shape[nl + 2:])  # noqa: E731
        flat = lss.LSSState(
            out_m=fl(state.out_m), out_c=fl(state.out_c), in_m=fl(in_m),
            in_c=fl(in_c), x_m=fl(state.x_m), x_c=fl(state.x_c),
            pending=fl(live), last_send=fl(state.last_send),
            alive=fl(state.alive), t=t, msgs=state.msgs, rng=None)
        *out, corr_iters = self._peer_update(flat, fl(live), **over)
        return (*(a.reshape(*lead, S, B, *a.shape[nl + 1:]) for a in out),
                corr_iters)

    def _cycle_full(self, state: ShardedState, tables: DeviceTopo,
                    with_stats=False, *, cfg=None, decide=None, gate=None,
                    regions=None):
        """One engine cycle on full ``(S, B, ...)`` arrays, or on Q
        tenants' stacked ``(Q, S, B, ...)`` state.

        ``cfg`` (an :class:`~repro_torch.core.lss.LSSConfig` whose
        ``beta``/``ell``/``eps`` may be (Q,) tensors), ``gate`` (bool
        (Q,): a False tenant initiates no sends), ``regions`` (the Q
        tenants' :class:`~repro_torch.kernels.ops.SlotTables`, prepared
        with the same ``eps``/``beta``) and ``decide`` (an opaque decision
        for the reference formulas) override the engine's own: the JAX
        twin's per-call overrides, which its service ``vmap``s over the
        tenant axis.  ``with_stats=True`` returns ``(state', corr_iters)``
        — the correction do-while's iteration count (per tenant when
        stacked), as ``lss.cycle_impl(with_stats=True)`` reports it.
        """
        drop_rate = None if cfg is None else cfg.drop_rate
        live, delivered, sent, in_m, in_c = self._deliver_local(
            state, tables, drop_rate)
        # Cross-shard edges: halo gather -> wire encode -> transpose ->
        # wire decode -> scatter, each over the tenants' leading axis.
        nl = len(_lead(state))
        payload, err_m, err_c = self._encode_halo(state, tables, delivered)
        payload = tuple(exchange.transpose_all_to_all(p, batch=nl)
                        for p in payload)
        buf_m, buf_c, flag = self._wire.decode(payload)
        in_m, in_c = exchange.scatter_halo(in_m, in_c, buf_m, buf_c, flag,
                                           tables.halo, batch=nl)
        out_m, out_c, pending, last_send, corr_iters = self._update(
            state, live, in_m, in_c, state.t[..., None] if nl else state.t,
            cfg=cfg, decide=decide, gate=gate, regions=regions)
        state = state._replace(
            out_m=out_m, out_c=out_c, in_m=in_m, in_c=in_c,
            pending=pending, last_send=last_send, t=state.t + 1,
            msgs=state.msgs + sent.to(state.msgs.dtype),
            wire_err_m=err_m, wire_err_c=err_c)
        if with_stats:
            return state, corr_iters
        return state

    # -- one cycle, collective (this rank's block) --------------------------
    def _deliver_block(self, state: ShardedState, blk: _BlockTables):
        """A block cycle's start, the same in both modes: ``alive``
        all-gathered, the block's live slots, its drop draw (its shard's
        generator) and the shard-local deliveries through ``blk.src``.
        Returns ``(live, delivered, sent, in_m, in_c)`` of the B rows
        (``sent`` shaped (1,))."""
        B, D = self.B, self.D
        alive = state.alive[0]
        alive_all = collective.all_gather(alive, self._mesh.group)  # (S*B,)
        live = blk.mask & alive[:, None] & alive_all[blk.tgt_pos]
        send = state.pending[0] & live
        if self.cfg.drop_rate > 0.0:
            keep = torch.rand((B, D), generator=state.rng[0],
                              device=send.device)
            delivered = send & (keep >= self.cfg.drop_rate)
        else:
            delivered = send
        sent = torch.sum(send).reshape(1)

        out_m, out_c = state.out_m[0], state.out_c[0]
        d = out_m.shape[-1]
        got = delivered.reshape(B * D)[blk.src] & blk.intra
        in_m = torch.where(got[..., None],
                           out_m.reshape(B * D, d)[blk.src], state.in_m[0])
        in_c = torch.where(got, out_c.reshape(B * D)[blk.src],
                           state.in_c[0])
        return live, delivered, sent, in_m, in_c

    def _encode_block(self, state: ShardedState, blk: _BlockTables,
                      delivered):
        """The block's boundary sends gathered into ``(S_dst, H)`` buffers
        and encoded in the active wire; a stateful wire reads and updates
        the block's error feedback.  Returns ``(payload, wire_err_m,
        wire_err_c)``."""
        h = blk.halo
        bufs = exchange.gather_block(state.out_m[0], state.out_c[0],
                                     delivered, h.send_row, h.send_slot,
                                     h.send_ok)
        wire = self._wire
        if not wire.stateful:
            payload, _, _ = wire.encode(*bufs)
            return payload, state.wire_err_m, state.wire_err_c
        em, ec = state.wire_err_m[0], state.wire_err_c[0]
        payload, n_em, n_ec = wire.encode(
            *bufs, em[h.send_row, h.send_slot], ec[h.send_row, h.send_slot])
        em, ec = exchange.scatter_err_block(
            em, ec, n_em, n_ec, h.send_row, h.send_slot, h.send_ok)
        return payload, em[None], ec[None]

    def _all_to_all(self, payload) -> tuple:
        """Each tensor of ``payload`` through one
        :func:`~repro_torch.engine.exchange.collective_all_to_all`, the
        bytes staged through the host added to :attr:`staged_bytes`."""
        group = self._mesh.group
        self.staged_bytes += sum(collective.staged_bytes(p, group)
                                 for p in payload)
        return tuple(exchange.collective_all_to_all(p, group)
                     for p in payload)

    def _cycle_block(self, state: ShardedState,
                     blk: _BlockTables) -> ShardedState:
        """One cycle on this rank's ``(1, B, ...)`` block, the twin of
        JAX's ``_cycle_block``: ``alive`` all-gathered, shard-local
        deliveries through ``blk.src``, then the boundary sends gathered,
        encoded, moved by one :func:`~repro_torch.engine.exchange.
        collective_all_to_all` per payload tensor, decoded and scattered,
        then the peer update on the block's B rows.  Adds the payload
        bytes staged through the host to :attr:`staged_bytes`."""
        h = blk.halo
        live, delivered, sent, in_m, in_c = self._deliver_block(state, blk)
        payload, err_m, err_c = self._encode_block(state, blk, delivered)
        buf_m, buf_c, flag = self._wire.decode(self._all_to_all(payload))
        in_m, in_c = exchange.scatter_block(in_m, in_c, buf_m, buf_c, flag,
                                            h.recv_row, h.recv_slot)

        out_m, out_c, pending, last_send, _ = self._update(
            state, live[None], in_m[None], in_c[None], state.t,
            topo=blk.topo)
        return state._replace(
            out_m=out_m, out_c=out_c, in_m=in_m[None], in_c=in_c[None],
            pending=pending, last_send=last_send, t=state.t + 1,
            msgs=state.msgs + sent.to(state.msgs.dtype),
            wire_err_m=err_m, wire_err_c=err_c)

    def _cycle_async_block(self, astate: AsyncShardedState,
                           blk: _BlockTables) -> AsyncShardedState:
        """One async cycle on this rank's block: :meth:`_cycle_async`'s
        row of shard r, bitwise.

        The rank's boundary sends and their ``out_seq`` stamps go to every
        destination by one all-to-all per tensor (on a lossy wire the
        encoded payload crosses and the receiver decodes it: decoding is
        deterministic, so the values are the fallback's decode at the
        sender).  Each sender's rows land in the rank's ring column at the
        sender's ``clock % R`` (the clocks all-gathered); the rank reads
        each sender at ``(clock_src - delay) % R`` with its own delay draw
        (the fallback's row r), applies the sequence guard, scatters, and
        runs the peer update against its clock.  WRITES the published
        slots of ``astate``'s ring column in place (:meth:`run` hands it
        a copy it owns)."""
        state = astate.sync
        B = self.B
        staleness = int(self.ecfg.staleness)
        R = max(1, staleness + 1)
        h = blk.halo
        live, delivered, sent, in_m, in_c = self._deliver_block(state, blk)

        if self._wire.lossy:
            payload, err_m, err_c = self._encode_block(state, blk, delivered)
            state = state._replace(wire_err_m=err_m, wire_err_c=err_c)
        else:
            payload = exchange.gather_block(
                state.out_m[0], state.out_c[0], delivered, h.send_row,
                h.send_slot, h.send_ok)
        stamps = astate.out_seq[0][h.send_row, h.send_slot]  # (S_dst, H)
        *payload, seq = self._all_to_all((*payload, stamps))
        buf_m, buf_c, flag = (self._wire.decode(tuple(payload))
                              if self._wire.lossy else payload)
        clock = astate.clock  # (1,)
        clock_all = collective.all_gather(clock, self._mesh.group)  # (S,)
        ring = exchange.ring_publish(
            astate.ring_m, astate.ring_c, astate.ring_flag, astate.ring_seq,
            clock_all % R, buf_m[:, None], buf_c[:, None], flag[:, None],
            seq[:, None])

        if staleness > 0:
            g = astate.delay_rng[0]
            delay = torch.randint(0, staleness + 1, (self.S,), generator=g,
                                  device=g.device, dtype=torch.int32)
            delay = torch.minimum(delay, clock_all)  # (S_src,)
        else:
            delay = torch.zeros((self.S,), dtype=torch.int32,
                                device=clock.device)
        got_m, got_c, got_flag, got_seq = exchange.ring_read_column(
            *ring, (clock_all - delay) % R)

        cur = astate.last_seq[0][h.recv_row, h.recv_slot]  # (S_src, H)
        ok = got_flag & (got_seq >= cur)
        in_m, in_c = exchange.scatter_block(in_m, in_c, got_m, got_c, ok,
                                            h.recv_row, h.recv_slot)
        last_seq = exchange.scatter_seq_block(astate.last_seq[0], got_seq,
                                              ok, h.recv_row, h.recv_slot)
        cnt = astate.applied.dtype
        stale = torch.sum(got_flag & ~ok).to(cnt).reshape(1)
        applied = torch.sum(ok).to(cnt).reshape(1)
        lag = torch.sum(torch.where(ok, delay[:, None], 0)).to(cnt).reshape(1)

        out_m, out_c, pending, last_send, _ = self._update(
            state, live[None], in_m[None], in_c[None],
            clock.repeat_interleave(B), topo=blk.topo)
        state = state._replace(
            out_m=out_m, out_c=out_c, in_m=in_m[None], in_c=in_c[None],
            pending=pending, last_send=last_send, t=state.t + 1,
            msgs=state.msgs + sent.to(state.msgs.dtype))
        return astate._replace(
            sync=state, clock=clock + 1,
            out_seq=torch.where(pending, astate.out_seq + 1, astate.out_seq),
            last_seq=last_seq[None], ring_m=ring[0], ring_c=ring[1],
            ring_flag=ring[2], ring_seq=ring[3],
            stale_drops=astate.stale_drops + stale,
            applied=astate.applied + applied,
            delay_sum=astate.delay_sum + lag)

    # -- one cycle, asynchronous gossip mode -------------------------------
    def _cycle_async(self, astate: AsyncShardedState,
                     tables: DeviceTopo) -> AsyncShardedState:
        """One async-mode cycle: the sync cycle's shard-local delivery and
        peer update, but cross-shard messages go through the
        bounded-staleness ring with per-message sequence guards.

        At ``staleness=0`` it is the sync cycle bitwise: the same drop
        draws (the delay generators are drawn only when ``staleness > 0``),
        the ring write and read collapse to the transpose, and the seq
        guard passes every flagged message (sequence numbers are monotone
        per out-slot).  WRITES the published slot of ``astate``'s ring in
        place (:meth:`run` hands it a copy it owns).
        """
        state = astate.sync
        S, B = self.S, self.B
        staleness = int(self.ecfg.staleness)
        R = max(1, staleness + 1)
        halo = tables.halo
        live, delivered, sent, in_m, in_c = self._deliver_local(state,
                                                                tables)

        # Publish this cycle's boundary sends (+ their seq stamps) into each
        # shard's ring slot at its own clock.  A lossy wire quantizes at the
        # sender (encode -> decode before the ring), so the ring holds what
        # a quantized transport ships; its error feedback moves on publish.
        if self._wire.lossy:
            payload, err_m, err_c = self._encode_halo(state, tables,
                                                      delivered)
            buf_m, buf_c, flag = self._wire.decode(payload)
            state = state._replace(wire_err_m=err_m, wire_err_c=err_c)
        else:
            buf_m, buf_c, flag = exchange.gather_halo(
                state.out_m, state.out_c, delivered, halo)
        buf_seq, = exchange.gather_rows(halo.send_row, halo.send_slot,
                                        astate.out_seq)
        clock = astate.clock
        ring = exchange.ring_publish(
            astate.ring_m, astate.ring_c, astate.ring_flag, astate.ring_seq,
            clock % R, buf_m, buf_c, flag, buf_seq)

        # Read every (dst, src) pair at a bounded-stale sender clock: delay
        # in [0, staleness], capped by the sender's clock so early cycles
        # never reach before time 0.
        if staleness > 0:
            delay = torch.stack([
                torch.randint(0, staleness + 1, (S,), generator=g,
                              device=g.device, dtype=torch.int32)
                for g in astate.delay_rng])  # (S_dst, S_src)
            delay = torch.minimum(delay, clock[None, :])
        else:
            delay = torch.zeros((S, S), dtype=torch.int32,
                                device=clock.device)
        got_m, got_c, got_flag, got_seq = exchange.ring_read(
            *ring, (clock[None, :] - delay) % R)

        # Alg. 1's per-message guard: a delivery whose seq lags what its
        # in-slot already applied is a reordered stale message — drop it
        # (an equal seq re-applies the identical payload).
        cur, = exchange.gather_rows(halo.recv_row, halo.recv_slot,
                                    astate.last_seq)
        ok = got_flag & (got_seq >= cur)
        in_m, in_c = exchange.scatter_halo(in_m, in_c, got_m, got_c, ok, halo)
        last_seq = exchange.scatter_seq(astate.last_seq, got_seq, ok,
                                        halo.recv_row, halo.recv_slot)
        cnt = astate.applied.dtype
        stale = torch.sum(got_flag & ~ok, dim=(1, 2)).to(cnt)
        applied = torch.sum(ok, dim=(1, 2)).to(cnt)
        lag = torch.sum(torch.where(ok, delay[:, :, None], 0),
                        dim=(1, 2)).to(cnt)

        # Peer-local update against the per-shard clock, one per row.
        out_m, out_c, pending, last_send, _ = self._update(
            state, live, in_m, in_c, clock.repeat_interleave(B))
        state = state._replace(
            out_m=out_m, out_c=out_c, in_m=in_m, in_c=in_c,
            pending=pending, last_send=last_send, t=state.t + 1,
            msgs=state.msgs + sent.to(state.msgs.dtype))
        return astate._replace(
            sync=state, clock=clock + 1,
            # Fresh postings advance their out-slot's sequence number.
            out_seq=torch.where(pending, astate.out_seq + 1, astate.out_seq),
            last_seq=last_seq, ring_m=ring[0], ring_c=ring[1],
            ring_flag=ring[2], ring_seq=ring[3],
            stale_drops=astate.stale_drops + stale,
            applied=astate.applied + applied,
            delay_sum=astate.delay_sum + lag)

    def async_in_flight(self, astate: AsyncShardedState) -> torch.Tensor:
        """Conservative device-side bool: could a ring publication still be
        delivered by a future bounded-stale read?

        As the JAX twin: of the R ring slots, the one at index
        ``(clock + 1) % R`` counts as aged out; at staleness 0 nothing
        lingers.  (That slot holds the publication of ``clock + 1 - R``,
        which the next cycle may still read at delay ``staleness``, while
        the aged-out one sits at ``clock % R``: ROADMAP C lists this as a
        fault of the reference, kept here for parity.)  Under a mesh the
        clocks and ring flags are gathered first, so every rank reads the
        fallback's bit.
        """
        if self._mesh is not None:
            astate = astate._replace(
                clock=self._full(astate.clock),
                ring_flag=self._full_ring(astate.ring_flag))
        return self._in_flight(astate)

    @staticmethod
    def _in_flight(astate: AsyncShardedState) -> torch.Tensor:
        """:meth:`async_in_flight` on a full (gathered) state."""
        R = astate.ring_flag.shape[0]
        if R == 1:
            return torch.zeros((), dtype=torch.bool,
                               device=astate.ring_flag.device)
        oldest = (astate.clock + 1) % R  # (S,) per src shard
        live = (torch.arange(R, device=oldest.device)[:, None]
                != oldest[None, :])  # (R, S_src)
        return torch.any(astate.ring_flag & live[:, :, None, None])

    def _shard_sum(self, a) -> torch.Tensor:
        """The sum of a per-shard counter over all shards (over the ranks
        under a mesh)."""
        return torch.sum(a if self._mesh is None else self._full(a))

    def async_lag_stats(self, astate: AsyncShardedState) -> dict:
        """Host-side staleness summary (one device sync): applied
        cross-shard messages, their mean realized delay in cycles, and the
        cumulative seq-guarded stale-drop count (every shard's, under a
        mesh too)."""
        applied = int(self._shard_sum(astate.applied))
        return {
            "applied": applied,
            "stale_drops": int(self._shard_sum(astate.stale_drops)),
            "mean_delay": (float(self._shard_sum(astate.delay_sum)) / applied
                           if applied else 0.0),
        }

    # -- driver ------------------------------------------------------------
    def run(self, state, cycles: int):
        """Advance ``cycles`` cycles, ``cycles_per_dispatch`` (K) per
        dispatch.

        Accepts a :class:`ShardedState` (sync cycles) or an
        :class:`AsyncShardedState` (bounded-staleness cycles) and returns
        the same kind; an async state's ring is copied once here, so the
        caller's state is never written.  Each dispatch is an
        ``engine.dispatch`` span in the tracker with the JAX attributes
        ``k``, ``suite``, ``mode`` ("sync" / "async"), ``transport``
        ("gather", or "all_to_all" under a mesh), ``fused``, ``wire``,
        ``halo_bytes`` (the active wire's modeled bytes over the dispatch,
        all shard pairs) and ``cut_edges``, and ``staged_bytes`` when a
        gloo group moved this rank's payload through the host; a non-noop
        tracker also gets per-shard ``engine_shard_halo_bytes_total``
        counters, ``engine_shard_cut_edges`` gauges and per-pair
        ``engine_halo_padding_frac`` gauges, and after an async run the
        ``engine_async_staleness_mean``, ``engine_async_stale_drops_total``
        and ``engine_async_applied_total`` gauges (one host sync).  There
        is no ``recompiled`` attribute: the port compiles nothing per
        dispatch.  With ``EngineConfig(profile=True)`` each dispatch's K
        cycles run inside a :class:`~repro_torch.obs.ProfiledDispatch`
        (``backend="engine"`` gauges in the tracker, ``"engine-mesh"``
        under a mesh).
        """
        from ..obs import NoopTracker

        is_async = isinstance(state, AsyncShardedState)
        if is_async:
            state = state._replace(ring_m=state.ring_m.clone(),
                                   ring_c=state.ring_c.clone(),
                                   ring_flag=state.ring_flag.clone(),
                                   ring_seq=state.ring_seq.clone())
            cycle = (self._cycle_async if self._mesh is None
                     else self._cycle_async_block)
        elif self._mesh is not None:
            cycle = self._cycle_block
        else:
            cycle = self._cycle_full
        k = max(1, self.ecfg.cycles_per_dispatch)
        transport = "all_to_all" if self._mesh is not None else "gather"
        pair = self.wire_pair_bytes(self._base(state).x_m.shape[-1])
        shard_bytes = pair.sum(axis=1)  # per src shard
        total_bytes = int(pair.sum())
        cut_edges = int(self._cuts.sum()) // 2
        publish = not isinstance(self.tracker, NoopTracker)
        done = 0
        while done < cycles:
            step = min(k, cycles - done)
            with self.tracker.span("engine.dispatch", k=step,
                                   suite=self.suite.name,
                                   mode="async" if is_async else "sync",
                                   transport=transport) as sp:
                staged0 = self.staged_bytes
                state = (self._profiled or self._k_cycles)(
                    state, cycle, step)
                if self.staged_bytes > staged0:
                    sp.set("staged_bytes", self.staged_bytes - staged0)
                sp.set("fused", self.dispatch_info["fused"])
                sp.set("wire", self._wire.name)
                sp.set("halo_bytes", total_bytes * step)
                sp.set("cut_edges", cut_edges)
                if publish:
                    self._publish_halo(step, transport, shard_bytes, pair)
            done += step
        if is_async and publish:
            # Cumulative totals live in the state, so a fresh tracker
            # still sees them.
            lag = self.async_lag_stats(state)
            self.tracker.gauge(
                "engine_async_staleness_mean",
                "mean realized halo delay (cycles) of applied cross-shard "
                "messages, cumulative").set(lag["mean_delay"])
            self.tracker.gauge(
                "engine_async_stale_drops_total",
                "cross-shard deliveries dropped by the per-message seq "
                "guard (reordered/superseded), cumulative").set(
                    lag["stale_drops"])
            self.tracker.gauge(
                "engine_async_applied_total",
                "cross-shard messages applied, cumulative").set(
                    lag["applied"])
        return state

    def _k_cycles(self, state, cycle, k: int):
        """One dispatch: ``k`` cycles of ``cycle`` over the installed
        tables (this rank's row of them under a mesh)."""
        tables = self._tables if self._mesh is None else self._block
        for _ in range(k):
            state = cycle(state, tables)
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

    @staticmethod
    def _base(state) -> ShardedState:
        """The sync :class:`ShardedState` under either state kind."""
        return state.sync if isinstance(state, AsyncShardedState) else state

    def drain_msgs(self, state):
        """Read-and-reset the device send counter: (state', exact int)."""
        base = self._base(state)
        total = int(self.total_msgs(base))
        base = base._replace(msgs=torch.zeros_like(base.msgs))
        if isinstance(state, AsyncShardedState):
            return state._replace(sync=base), total
        return base, total

    def total_msgs(self, state) -> torch.Tensor:
        """All shards' cumulative sends (summed over the ranks under a
        mesh)."""
        return self._shard_sum(self._base(state).msgs)

    # -- observers ---------------------------------------------------------
    @staticmethod
    def _shard0(rng):
        """Shard 0's generator (one per tenant for a stacked state)."""
        if isinstance(rng[0], torch.Generator):
            return rng[0]
        return tuple(r[0] for r in rng)

    def _flat_state(self, state) -> lss.LSSState:
        """The core's view of a sync state: ``(S*B, ...)`` rows, or
        ``(Q, S*B, ...)`` for stacked tenants (``(B, ...)`` for a rank's
        block); ``msgs`` summed over the shards."""
        state = self._base(state)
        lead = _lead(state)
        nl = len(lead)
        rows = state.x_c.shape[-2] * self.B  # S*B, or B for a rank's block
        fl = lambda a: a.reshape(  # noqa: E731
            *lead, rows, *a.shape[nl + 2:])
        return lss.LSSState(
            out_m=fl(state.out_m), out_c=fl(state.out_c),
            in_m=fl(state.in_m), in_c=fl(state.in_c),
            x_m=fl(state.x_m), x_c=fl(state.x_c),
            pending=fl(state.pending), last_send=fl(state.last_send),
            alive=fl(state.alive), t=state.t,
            msgs=torch.sum(state.msgs, dim=-1), rng=self._shard0(state.rng))

    def _metrics_impl(self, state: ShardedState, eps=OBSERVE_EPS,
                      decide=None, regions=None):
        """The observe on a sync state, single or Q tenants stacked:
        :func:`repro_torch.core.lss.metrics_impl` on the flat ``S*B``-row
        view (padding rows are dead).  ``eps`` (one or (Q,)), ``regions``
        (prepared tables: the fused suite launches one ``lss_state`` and
        one global decision for all tenants) and ``decide`` (an opaque
        decision, reference formulas only) override the engine's own, as
        in the JAX twin.  Returns ``(acc, quiescent, correct-mask in
        original order, want)``, per tenant when stacked."""
        if regions is None and decide is None:
            if self.suite.fused and self.region_slot is not None:
                regions = self._tables_for(eps)
            else:
                decide = self.decide
        if regions is not None:
            decide = lambda v: self.suite.decide(v, regions)  # noqa: E731
        elif self.suite.fused:
            raise _opaque_decide_error()
        acc, quiescent, correct, want = lss.metrics_impl(
            self._flat_state(state), self._flat_topo, decide, eps,
            suite=self.suite if regions is not None else None,
            regions=regions)
        return acc, quiescent, correct[..., self._pos], want

    def metrics(self, state, eps: float = OBSERVE_EPS):
        """(accuracy, quiescent, correct-mask in original order) — the same
        numbers :func:`repro_torch.core.lss.metrics` reports.

        :meth:`_metrics_impl` with the engine's own family: with the fused
        suite one ``lss_state`` launch and one global decision launch.
        For an async state the quiescence bit also requires
        :meth:`async_in_flight` to be False: a message still deliverable by
        a bounded-stale read could wake a peer.  Under a mesh the blocks
        are gathered first, so every rank reads the same numbers.
        """
        acc, quiescent, correct, _ = self._metrics_impl(
            self.gather_state(self._base(state)), eps)
        if isinstance(state, AsyncShardedState):
            quiescent = quiescent & ~self.async_in_flight(state)
        return acc, quiescent, correct

    # -- audit plane -------------------------------------------------------
    def _audit_impl(self, state: ShardedState, tables: DeviceTopo, eps=1e-9,
                    decide=None, sample_mod=1, sample_phase=0):
        """The audit reductions on a sync state, single or Q tenants
        stacked: :func:`repro_torch.core.lss.audit_impl` on the flat
        ``S*B``-row view of ``tables`` (``tgt_pos`` is the flat neighbor
        table and ``rev`` the reverse slot at the target row, so the slot
        involution holds across shard boundaries).

        In async mode or on a lossy wire the halo slots' in/out pairing is
        relaxed (a stale read, a quantized value), so they move to the
        in-flight side of the ledger and out of the bitwise edge check
        (``settled_ok=intra``), and the rounding model widens by the
        wire's ``quant_eps``.  ``decide`` (default: the engine's own plain
        decision) and ``eps`` (one or (Q,)) may be per-tenant overrides,
        as in the JAX twin.
        """
        decide = decide if decide is not None else self.decide
        S, B = self.S, self.B
        relaxed = self.ecfg.async_mode or self._wire.lossy
        settled_ok = tables.intra.reshape(S * B, -1) if relaxed else None
        return lss.audit_impl(self._flat_state(state), tables.flat(),
                              decide, eps=eps, sample_mod=sample_mod,
                              sample_phase=sample_phase,
                              settled_ok=settled_ok,
                              tol_rel_extra=self._wire.quant_eps)

    def _audit_async_impl(self, astate: AsyncShardedState,
                          tables: DeviceTopo) -> dict:
        """Async-monotonicity reductions over the transport books.

        ``snd[src, dst, h]`` is the sender-side out-slot counter: no
        receiver's last applied seq may exceed it (``seq_bad``), and no
        live ring publication may carry a stamp beyond it (``ring_bad``).
        Also the cumulative ``stale_drops`` and :meth:`async_in_flight`.
        ``astate`` is a full (gathered) state.
        """
        S = self.S
        h = tables.halo
        shard = torch.arange(S, device=h.send_row.device)[:, None, None]
        snd = astate.out_seq[shard, h.send_row, h.send_slot]  # (Ss, Sd, H)
        cur = astate.last_seq[shard, h.recv_row, h.recv_slot]  # (Sd, Ss, H)
        ok = h.send_ok.transpose(0, 1)
        seq_bad = torch.sum(ok & (cur > snd.transpose(0, 1)))
        ring_bad = torch.sum(astate.ring_flag & h.send_ok[None]
                             & (astate.ring_seq > snd[None]))
        return dict(seq_bad=seq_bad, ring_bad=ring_bad,
                    stale_drops=torch.sum(astate.stale_drops),
                    in_flight=self._in_flight(astate))

    def audit(self, state, eps: float = 1e-9, sample_mod: int = 1,
              sample_phase: int = 0) -> dict:
        """Host-side audit read: the raw invariant reductions as a dict of
        Python scalars.  Accepts either state kind; an async state adds
        the seq-monotonicity counters and the cumulative stale-drop total
        (reconciled against ``engine_async_stale_drops_total`` by
        :mod:`repro_torch.obs.audit`).  Under a mesh every rank gathers
        the blocks (and an async state's books and ring columns) and reads
        the gather fallback's dict."""
        state = self.gather_state(state)
        raw = dict(self._audit_impl(self._base(state), self._tables,
                                    eps=eps, sample_mod=sample_mod,
                                    sample_phase=sample_phase))
        if isinstance(state, AsyncShardedState):
            raw.update(self._audit_async_impl(state, self._tables))
        return {k: v.item() for k, v in raw.items()}

    def to_lss_state(self, state) -> lss.LSSState:
        """Unpermute into a core :class:`LSSState` (parity tests, debug);
        ``rng`` is shard 0's generator.  Accepts either state kind (the
        async books and the error feedback are dropped), and Q tenants'
        stacked state (a stacked core state).  Under a mesh every rank
        gets the whole state (``rng``: this rank's generator)."""
        state = self.gather_state(self._base(state))
        lead = _lead(state)
        nl = len(lead)
        take = lambda a: a.reshape(  # noqa: E731
            *lead, self.S * self.B, *a.shape[nl + 2:])[_at(nl, self._pos)]
        return lss.LSSState(
            out_m=take(state.out_m), out_c=take(state.out_c),
            in_m=take(state.in_m), in_c=take(state.in_c),
            x_m=take(state.x_m), x_c=take(state.x_c),
            pending=take(state.pending), last_send=take(state.last_send),
            alive=take(state.alive), t=state.t,
            msgs=torch.sum(state.msgs, dim=-1), rng=self._shard0(state.rng))

    def place_lss_state(self, snap: lss.LSSState) -> ShardedState:
        """Inverse of :meth:`to_lss_state`: place a core-layout state into
        this engine's shard layout (init values everywhere, then the logical
        rows through ``new_of_old``).  ``snap`` may cover fewer rows /
        degree slots than this engine's capacity; missing ones stay at
        init values.  A stacked core state (a leading tenant axis, ``rng``
        one generator per tenant) places every tenant.

        Not carried row-for-row: the aggregate send counter lands on shard
        0, and the per-shard drop generators are seeded from draws of a
        copy of ``snap.rng`` (:meth:`migrate_from` between equal shard
        counts carries them verbatim instead).  Under a mesh every rank
        builds the fallback's layout from the same ``snap`` and keeps its
        block.
        """
        placed = self._place(snap)
        if self._mesh is not None:
            placed = self._block_of(placed, self._mesh.rank)
        return placed

    def _place(self, snap: lss.LSSState) -> ShardedState:
        """:meth:`place_lss_state` in the full ``(S, B, ...)`` layout."""
        S, B, D = self.S, self.B, self.D
        dev = self.device
        lead = tuple(snap.alive.shape[:-1])
        nl = len(lead)
        n1 = snap.alive.shape[-1]
        if n1 > self.n:
            raise ValueError(f"snapshot covers {n1} rows > capacity {self.n}")
        D1 = snap.out_c.shape[-1]
        if D1 > D:
            raise ValueError(f"snapshot has {D1} degree slots > {D}")
        pos = self._pos[:n1]
        d = snap.x_m.shape[-1]
        dt = snap.x_m.dtype

        def place(src, shape, fill, dtype, slots):
            out = torch.full(lead + (S * B,) + shape, fill, dtype=dtype,
                             device=dev)
            at = _at(nl, pos, slice(0, D1)) if slots else _at(nl, pos)
            out[at] = src.to(device=dev, dtype=dtype)
            return out.reshape(lead + (S, B) + shape)

        def generators(rng):
            g = _copy_generator(rng)
            seeds = torch.randint(0, 2 ** 62, (S,), generator=g,
                                  device=g.device).tolist()
            return tuple(lss._generator(dev, s) for s in seeds)

        msgs = torch.zeros(lead + (S,), dtype=lss.counter_dtype(), device=dev)
        msgs[..., 0] = torch.as_tensor(snap.msgs, device=dev)
        stateful = self._wire.stateful  # its debt restarts at zero
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
            rng=(tuple(generators(g) for g in snap.rng) if nl
                 else generators(snap.rng)),
            wire_err_m=(torch.zeros(lead + (S, B, D, d), dtype=torch.float32,
                                    device=dev) if stateful else None),
            wire_err_c=(torch.zeros(lead + (S, B, D), dtype=torch.float32,
                                    device=dev) if stateful else None),
        )

    def migrate_from(self, old: "ShardedLSS",
                     state: ShardedState) -> ShardedState:
        """Move ``old``'s state into THIS engine's layout (one epoch).

        Gather across :func:`repro_torch.engine.partition.migrate_rows`,
        then :meth:`place_lss_state`'s scatter.  With an equal shard count
        the per-shard drop generators carry over verbatim (copied), so a
        regrow / rebalance epoch does not touch the drop sequence.  Under
        a stateful wire the quantization debt rides along row for row: a
        peer's unshipped error must survive the epoch.  Every tenant of a
        stacked state moves (the service's regrow and rebalance epochs).

        Under a mesh both engines must be attached to the same process
        group (so their shard counts are equal): ``old``'s blocks are
        gathered, every rank builds the fallback's migrated layout and
        keeps its block, with a copy of its own shard's generator.
        """
        if (self._mesh is None) != (old._mesh is None) or (
                self._mesh is not None
                and self._mesh.group is not old._mesh.group):
            raise ValueError(
                "migrate_from: both engines must be attached to the same "
                "process group (use_mesh), or neither to one")
        state = old.gather_state(state)
        src, _ = partition.migrate_rows(old.part, self.part)
        src = torch.as_tensor(src, device=old.device)
        lead = _lead(state)
        nl = len(lead)

        def move(a):
            return a.reshape(*lead, old.S * old.B,
                             *a.shape[nl + 2:])[_at(nl, src)]

        snap = lss.LSSState(
            out_m=move(state.out_m), out_c=move(state.out_c),
            in_m=move(state.in_m), in_c=move(state.in_c),
            x_m=move(state.x_m), x_c=move(state.x_c),
            pending=move(state.pending), last_send=move(state.last_send),
            alive=move(state.alive), t=state.t,
            msgs=torch.sum(state.msgs, dim=-1), rng=self._shard0(state.rng))
        placed = self._place(snap)
        if self._wire.stateful and state.wire_err_m is not None:
            # Into the fresh zero buffers place_lss_state made.
            at = _at(nl, self._pos[:snap.alive.shape[-1]],
                     slice(0, state.wire_err_c.shape[-1]))
            for new, a in ((placed.wire_err_m, state.wire_err_m),
                           (placed.wire_err_c, state.wire_err_c)):
                new.reshape(*lead, self.S * self.B,
                            *new.shape[nl + 2:])[at] = move(a).to(new.device)
        if self._mesh is not None:  # state.rng: this rank's shard's
            placed = self._block_of(placed, self._mesh.rank)
        if old.S == self.S:
            copy = lambda gs: tuple(_copy_generator(g)  # noqa: E731
                                    for g in gs)
            placed = placed._replace(
                rng=tuple(copy(r) for r in state.rng) if nl
                else copy(state.rng))
        return placed
