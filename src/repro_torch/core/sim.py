"""Experiment driver reproducing the paper's Sec.-VI setup (port of
``repro/core/sim.py``).

Data model (Sec. VI-A): inputs are normal i.i.d. per dimension; one source is
picked as the *desired outcome* and its nearest neighbor is the *contender*;
the data mean sits at ``bias`` of the way from the desired outcome to the
contender, and the std is ``std`` times their distance.  Dynamics: at noise
rate ``rho`` (changed peers per million per cycle — ppmc) inputs are
resampled; churn kills peers at a ppmc rate.

Data, noise and churn draw from numpy's RNG in the JAX twin's order, so
both packages see identical inputs and event streams.  The driver runs on
``device`` (default: CUDA, see :func:`repro_torch.default_device`) and steps
Alg. 1 through the CUDA kernels on the card and the reference formulas on
the CPU (``use_kernels`` overrides that choice), either
on the single-device core loop or, with ``engine=``, on the sharded
:class:`repro_torch.engine.ShardedLSS`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops as kernel_ops
from ..kernels.suite import resolve_suite
from . import lss, regions, topology, wvs

__all__ = ["ProblemSpec", "make_problem", "run_static", "run_dynamic"]

# The observe pass's eps: ``lss.metrics``' default, as the JAX driver
# observes (its cycles use ``cfg.eps``).
OBSERVE_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    n: int = 10_000
    k: int = 3  # number of sources
    d: int = 2  # data dimensionality
    bias: float = 0.10  # mean position between desired outcome and contender
    std: float = 1.00  # data std in units of outcome-contender distance
    seed: int = 0


def make_problem(spec: ProblemSpec):
    """Returns (centers (k,d) CPU tensor, sample(rng, n) -> (n,d) numpy,
    desired, mean)."""
    rng = np.random.default_rng(spec.seed)
    centers = rng.normal(size=(spec.k, spec.d)).astype(np.float32)
    desired = rng.integers(spec.k)
    # Contender = nearest other center.
    dist = np.linalg.norm(centers - centers[desired], axis=1)
    dist[desired] = np.inf
    contender = int(np.argmin(dist))
    gap = float(np.linalg.norm(centers[contender] - centers[desired]))
    mean = (1 - spec.bias) * centers[desired] + spec.bias * centers[contender]
    sigma = spec.std * gap

    def sample(rng_np, size):
        return (mean + sigma * rng_np.standard_normal((size, spec.d))).astype(
            np.float32)

    return torch.from_numpy(centers), sample, desired, mean


def _setup(topo: topology.Topology, spec: ProblemSpec, device):
    centers, sample, _, _ = make_problem(spec)
    rng = np.random.default_rng(spec.seed + 1)
    x = sample(rng, topo.n)
    inputs = wvs.from_vector(torch.from_numpy(x).to(device),
                             torch.ones((topo.n,), dtype=torch.float32,
                                        device=device))
    return centers.to(device), sample, rng, inputs


def _drain_msgs(state: lss.LSSState):
    """Read-and-reset the device send counter (exact host accumulation)."""
    return state._replace(msgs=torch.zeros_like(state.msgs)), int(state.msgs)


def _make_engine(topo, centers, cfg, engine, device, use_kernels):
    """Resolve the ``engine=`` argument (shard count or EngineConfig); the
    driver's ``use_kernels`` applies where the EngineConfig leaves it
    None."""
    from ..engine import EngineConfig, ShardedLSS  # lazy: avoid a cycle

    ecfg = EngineConfig(num_shards=engine) if isinstance(engine, int) \
        else engine
    if ecfg.use_kernels is None:
        ecfg = ecfg._replace(use_kernels=use_kernels)
    return ShardedLSS(topo, centers, cfg, ecfg, device=device)


class _Driver:
    """One stepping interface over both execution paths.

    ``advance``/``observe``/``drain`` and the dynamic-data edits dispatch
    to either the single-device core loop or the sharded engine, so the
    cycles-to-accuracy / quiescence / message bookkeeping exists once.
    """

    def __init__(self, topo, centers, cfg, inputs, spec, device, use_kernels,
                 engine=None):
        self._centers, self._cfg = centers, cfg
        self._device = device
        self.extra: dict = {}
        # A DynTopology enables true membership ops (churn through
        # remove_peer instead of a bare alive-mask edit); spare capacity
        # rows start dead via the present mask.
        self._dyn = topo if isinstance(topo, topology.DynTopology) else None
        self._dyn_version = self._dyn.version if self._dyn else 0
        alive = self._dyn.present.copy() if self._dyn else None
        if engine is not None:
            self._eng = _make_engine(topo, centers, cfg, engine, device,
                                     use_kernels)
            self._st = self._eng.init(inputs, seed=spec.seed, alive=alive)
            self.chunk = max(1, self._eng.ecfg.cycles_per_dispatch)
            self.extra = {"engine_shards": self._eng.S,
                          "cut_edges": self._eng.stopo.cut_edges()}
            return
        self._eng = None
        self.chunk = 1
        self._suite = resolve_suite(use_kernels, device)
        # The family's kernel tables, prepared once: with cfg.eps for the
        # cycles' lss_state, with the observe's eps for metrics.
        slot = regions.PackedSlot.voronoi(centers)
        self._tables = kernel_ops.prep_slots(slot, cfg.eps)
        self._observe_tables = (
            self._tables if cfg.eps == OBSERVE_EPS else
            kernel_ops.prep_slots(slot, OBSERVE_EPS))
        self._ta = lss.TopoArrays.from_topology(topo, device)
        self._st = lss.init_state(self._ta, inputs, seed=spec.seed,
                                  alive=alive)

    def advance(self, k: int):
        if self._eng is not None:
            self._st = self._eng.run(self._st, k)
            return
        for _ in range(k):
            self._st, _ = lss.cycle(self._st, self._ta, self._centers,
                                    self._cfg, suite=self._suite,
                                    regions=self._tables)

    def observe(self):
        """(accuracy, quiescent) at the current cycle."""
        if self._eng is not None:
            acc, quiescent, _ = self._eng.metrics(self._st, eps=OBSERVE_EPS)
        else:
            acc, quiescent, _ = lss.metrics(
                self._st, self._ta, self._centers, eps=OBSERVE_EPS,
                suite=self._suite, regions=self._observe_tables)
        return float(acc), bool(quiescent)

    def drain(self) -> int:
        """Read-and-reset the device send counter (exact host int)."""
        if self._eng is not None:
            self._st, sent = self._eng.drain_msgs(self._st)
        else:
            self._st, sent = _drain_msgs(self._st)
        return sent

    def set_inputs(self, who, vals):
        if self._eng is not None:
            self._st = self._eng.set_inputs(self._st, who, vals)
            return
        x_m = self._st.x_m.clone()
        x_m[torch.as_tensor(who, device=self._device)] = torch.as_tensor(
            vals, device=self._device)
        self._st = self._st._replace(x_m=x_m)

    def kill_peers(self, who, alive_np):
        """Churn.  On a plain Topology this is the paper's alive-mask edit;
        on a DynTopology the peers *leave*: their links are torn out of the
        topology (``remove_peer``), the freed slots scrubbed, and the tables
        repaired — the same live-link set either way."""
        if self._dyn is not None:
            for p in np.asarray(who).ravel():
                self._dyn.remove_peer(int(p))
            self._sync_membership()
        if self._eng is not None:
            self._st = self._eng.kill_peers(self._st, who)
        else:
            self._st = self._st._replace(
                alive=torch.tensor(alive_np, dtype=torch.bool,
                                   device=self._device))

    def _sync_membership(self):
        """Catch the tables + slot state up to the DynTopology."""
        events = self._dyn.events_since(self._dyn_version)
        self._dyn_version = self._dyn.version
        rows, slots = [], []
        for ev in events:
            if ev.kind in ("link", "unlink"):
                rows += [ev.a, ev.b]
                slots += [ev.slot_a, ev.slot_b]
        if rows:
            rows, slots = lss.pad_bucket(np.asarray(rows, np.int32),
                                         np.asarray(slots, np.int32))
        if self._eng is not None:
            self._eng.apply_membership(self._dyn)
            if len(rows):
                self._st = self._eng.clear_slots(self._st, rows, slots)
        else:
            self._ta = lss.TopoArrays.from_topology(self._dyn, self._device)
            if len(rows):
                self._st = lss.clear_slots(self._st, rows, slots)


def _driver(topo, spec, cfg, engine, device, use_kernels):
    device = resolve_device(device)
    centers, sample, rng, inputs = _setup(topo, spec, device)
    drv = _Driver(topo, centers, cfg, inputs, spec, device, use_kernels,
                  engine)
    return drv, sample, rng


def run_static(
    topo: topology.Topology,
    spec: ProblemSpec,
    cfg: lss.LSSConfig = lss.LSSConfig(),
    max_cycles: int = 2_000,
    check_every: int = 1,
    engine=None,
    device=None,
    use_kernels=None,
):
    """Run until quiescence; return the paper's static-data metrics.

    ``engine``: None runs the single-device core loop; a shard count (int)
    or :class:`repro_torch.engine.EngineConfig` routes through the sharded
    :class:`repro_torch.engine.ShardedLSS`, which advances
    ``cycles_per_dispatch`` cycles per dispatch, so accuracy/quiescence are
    observed every ``max(check_every, cycles_per_dispatch)`` cycles (the
    cycle counts in the result quantize accordingly) and the result also
    carries ``engine_shards`` and ``cut_edges``.
    ``device``: None runs on CUDA (and raises without a card).
    ``use_kernels``: the suite knob of :func:`repro_torch.kernels.suite.
    resolve_suite` — None picks the CUDA kernels on a CUDA device.
    """
    drv, _, _ = _driver(topo, spec, cfg, engine, device, use_kernels)
    return _run_to_quiescence(drv, topo, max_cycles, check_every)


def _run_to_quiescence(drv, topo, max_cycles, check_every):
    """The loop of :func:`run_static` on a driver already set up."""
    edges = max(topo.num_edges, 1)
    chunk = max(check_every, drv.chunk)
    c95 = c100 = quiesced_at = None
    total_msgs = 0  # host-side exact accumulator (drained every check)
    t = 0
    acc = quiescent = None
    while t < max_cycles:
        step = min(chunk, max_cycles - t)
        drv.advance(step)
        t += step
        acc, quiescent = drv.observe()
        total_msgs += drv.drain()
        if c95 is None and acc >= 0.95:
            c95 = t
        if c100 is None and acc >= 1.0:
            c100 = t
        if quiescent:
            quiesced_at = t
            break
    if acc is None:  # max_cycles <= 0: observe the initial state
        acc, quiescent = drv.observe()
    return {
        "n": topo.n,
        "cycles_95": c95,
        "cycles_100": c100,
        "quiesced_at": quiesced_at,
        "final_accuracy": acc,
        "quiescent": quiescent,
        "msgs_per_link": total_msgs / edges,
        "total_msgs": float(total_msgs),
        **drv.extra,
    }


def run_dynamic(
    topo: topology.Topology,
    spec: ProblemSpec,
    cfg: lss.LSSConfig = lss.LSSConfig(),
    cycles: int = 2_000,
    noise_ppmc: float = 0.0,
    churn_ppmc: float = 0.0,
    warmup: int = 100,
    engine=None,
    device=None,
    use_kernels=None,
):
    """Dynamic data / churn run; returns average accuracy + msgs/link/cycle.

    Passing a :class:`~repro_torch.core.topology.DynTopology` routes churn
    through the real membership ops (dead peers *leave*); the live link set
    and so the reported dynamics are identical either way.  ``engine``,
    ``device`` and ``use_kernels`` as in :func:`run_static` (noise/churn
    edits land between cycles, so the engine route dispatches one cycle at
    a time).
    """
    drv, sample, rng = _driver(topo, spec, cfg, engine, device, use_kernels)
    edges = max(topo.num_edges, 1)
    n = topo.n
    accs, loads = [], []
    alive_np = np.ones(n, bool)
    for t in range(cycles):
        # Resample a noise_ppmc fraction of inputs.
        n_changes = rng.binomial(n, min(noise_ppmc * 1e-6, 1.0))
        if n_changes:
            who = rng.choice(n, size=n_changes, replace=False)
            drv.set_inputs(who, sample(rng, n_changes))
        # Churn: kill peers permanently.
        n_dead = rng.binomial(n, min(churn_ppmc * 1e-6, 1.0))
        if n_dead:
            cand = rng.choice(n, size=n_dead, replace=False)
            alive_np[cand] = False
            drv.kill_peers(cand, alive_np)
        drv.advance(1)
        sent = drv.drain()
        if t >= warmup:
            acc, _ = drv.observe()
            accs.append(acc)
            loads.append(sent / edges)
    return {
        "n": n,
        "avg_accuracy": float(np.mean(accs)) if accs else float("nan"),
        "avg_error": 1.0 - (float(np.mean(accs)) if accs else float("nan")),
        "msgs_per_link_per_cycle": float(np.mean(loads)) if loads else 0.0,
        "alive_frac": float(alive_np.mean()),
    }
