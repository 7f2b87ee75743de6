"""Cost-model autotuning for the sharded engine (port of
``repro/engine/autotune.py``).

Enumerates candidate execution plans — ``(num_shards, halo_slack,
cycles_per_dispatch, wire)`` — builds a probe engine for each, counts one
K-cycle probe dispatch with :func:`repro_torch.launch.cost.analyze` (the
torch stand-in for the JAX package's HLO reading: aten ops by their
tensors, the kernels by their byte models), combines the roofline terms
with the wire byte model (:meth:`ShardedLSS.wire_pair_bytes`), and picks
the plan minimizing modeled per-cycle dispatch cost.  With
``measure=True`` (default) every candidate's dispatch is also timed and
the measured wall decides — the model then serves as the printed
explanation, not the verdict.

Entry points:

* ``EngineConfig(auto_plan=True)`` — :class:`ShardedLSS` construction
  calls :func:`plan` over a small default grid around the given config
  (K halved/doubled x {exact, compact} wires) on the engine's device and
  adopts the winner.
* ``python -m repro_torch.engine.autotune --n 10000 --graph grid ...`` —
  CLI sweep printing the full plan table with the chosen row marked
  (``--device cuda`` by default).

Per-cycle cost, as in the JAX twin:

    flops / FLOPS + hbm_bytes / HBM_BW          (per dispatch, / K)
    + wire_bytes / NET_BW                       (per cycle)
    + DISPATCH_US / K                           (host boundary, / K)

The model only ranks plans; it does not predict walls.  On the CPU the
four constants are JAX's (so the CPU ranks match JAX's); on a CUDA device
``FLOPS`` and ``HBM_BW`` are the H100's float32 and memory rates
(:mod:`repro_torch.kernels.cost`), and the network and dispatch terms
keep JAX's values.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .. import resolve_device
from ..core import lss, wvs
from ..kernels import cost as kernel_cost
from ..launch import cost
from . import exchange
from .engine import EngineConfig, ShardedLSS

__all__ = ["Candidate", "PlanEntry", "PlanResult", "plan",
           "default_candidates", "format_table", "rates", "FLOPS_PER_S",
           "HBM_BYTES_PER_S", "NET_BYTES_PER_S", "DISPATCH_US"]

# Roofline constants (JAX's: one CPU/accelerator device + commodity
# interconnect).  Coarse on purpose: the model ranks plans, it does not
# predict absolute walls.
FLOPS_PER_S = 5e10
HBM_BYTES_PER_S = 2e10
NET_BYTES_PER_S = 1e9
DISPATCH_US = 50.0


def rates(device) -> Tuple[float, float]:
    """``(FLOPS_PER_S, HBM_BYTES_PER_S)`` the model uses on ``device``:
    JAX's on the CPU, the H100's on a CUDA device."""
    if torch.device(device).type == "cuda":
        return kernel_cost.F32_OPS_PER_S, kernel_cost.HBM_BYTES_PER_S
    return FLOPS_PER_S, HBM_BYTES_PER_S


class Candidate(NamedTuple):
    """One enumerable execution plan."""

    num_shards: int
    halo_slack: float
    k: int  # cycles_per_dispatch
    wire: str


class PlanEntry(NamedTuple):
    """One scored (and optionally timed) candidate."""

    cand: Candidate
    modeled_us: float  # modeled per-cycle cost
    measured_us: float  # measured per-cycle dispatch wall (nan = unmeasured)
    wire_bytes: int  # wire bytes per cycle, all shard pairs
    flops: float  # per dispatch (K cycles), counted
    hbm_bytes: float  # per dispatch, counted
    collective_bytes: float  # per dispatch, counted
    build_s: float  # not in the JAX twin: the probe engine's build, s


class PlanResult(NamedTuple):
    config: EngineConfig  # base config with the winner applied
    chosen: Candidate
    table: Tuple[PlanEntry, ...]  # every candidate, enumeration order


def default_candidates(base: EngineConfig) -> Tuple[Candidate, ...]:
    """The ``auto_plan=True`` grid: a small neighborhood around ``base``
    (construction-time tuning must stay cheap — every candidate is a probe
    engine).  K halved / as-is / doubled, crossed with the base wire plus
    ``compact`` (the always-lossless improvement; lossy wires are an
    accuracy decision the caller must opt into explicitly)."""
    k = max(1, base.cycles_per_dispatch)
    ks = sorted({max(1, k // 2), k, 2 * k})
    wires = sorted({base.wire, "compact"})
    return tuple(Candidate(base.num_shards, base.halo_slack, kk, w)
                 for kk in ks for w in wires)


def _probe_inputs(n: int, d: int, seed: int, device) -> wvs.WV:
    """Deterministic non-degenerate probe inputs from a seeded generator
    (all-zero inputs would skip the corrections real runs pay for)."""
    g = torch.Generator().manual_seed(int(seed))
    m = torch.randn((n, d), generator=g).to(device)
    return wvs.WV(m=m, c=torch.ones((n,), dtype=m.dtype, device=device))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _apply(base: EngineConfig, c: Candidate) -> EngineConfig:
    return base._replace(num_shards=c.num_shards, halo_slack=c.halo_slack,
                         cycles_per_dispatch=c.k, wire=c.wire,
                         auto_plan=False)


def _score(topo, centers, cfg, ecfg, c, inputs, seed, measure, repeats,
           device) -> PlanEntry:
    """One candidate's probe: build it, count one K-cycle dispatch and,
    with ``measure``, time one warm-up and ``repeats`` dispatches
    (synchronized, the state chained).  The probe dies on return."""
    t0 = time.perf_counter()
    eng = ShardedLSS(topo, centers, cfg=cfg, ecfg=ecfg, device=device)
    state = eng.init(inputs, seed=seed)
    _sync(device)
    build_s = time.perf_counter() - t0
    d = int(inputs.m.shape[-1])
    counted = cost.analyze(eng.run, state, c.k)
    wire_bytes = int(eng.wire_pair_bytes(d).sum())
    flops_s, hbm_s = rates(device)
    modeled_us = ((counted["flops"] / flops_s
                   + counted["hbm_bytes"] / hbm_s) * 1e6 / c.k
                  + wire_bytes / NET_BYTES_PER_S * 1e6
                  + DISPATCH_US / c.k)
    measured_us = math.nan
    if measure:
        state = eng.run(state, c.k)  # warm-up (loads the built kernels)
        _sync(device)
        best = math.inf
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            state = eng.run(state, c.k)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
        measured_us = best * 1e6 / c.k
    return PlanEntry(cand=c, modeled_us=modeled_us, measured_us=measured_us,
                     wire_bytes=wire_bytes, flops=float(counted["flops"]),
                     hbm_bytes=float(counted["hbm_bytes"]),
                     collective_bytes=float(
                         counted["collective_bytes"]["total"]),
                     build_s=build_s)


def plan(topo, centers, cfg: lss.LSSConfig = lss.LSSConfig(),
         base: EngineConfig = EngineConfig(),
         candidates: Optional[Sequence[Candidate]] = None,
         inputs: Optional[wvs.WV] = None, seed: int = 0,
         measure: bool = True, repeats: int = 3,
         device=None) -> PlanResult:
    """Enumerate, score, and (optionally) time candidate plans.

    Every candidate builds a probe :class:`ShardedLSS` on ``device``
    (``auto_plan`` forced off; the engine's own Voronoi family on
    ``centers``) and counts one K-cycle dispatch with
    :func:`repro_torch.launch.cost.analyze`.  With ``measure=True`` the
    probe is also run (one warm-up + ``repeats`` timed dispatches,
    chaining the returned state) and the minimum wall decides the winner;
    otherwise the modeled cost does.  Each probe is released before the
    next is built.

    Returns a :class:`PlanResult` whose ``config`` is ``base`` with the
    winning candidate's fields applied (and ``auto_plan=False``, so
    constructing an engine from it never re-plans).
    """
    device = resolve_device(device)
    cands = tuple(candidates) if candidates is not None \
        else default_candidates(base)
    if not cands:
        raise ValueError("no candidate plans to evaluate")
    d = int(torch.as_tensor(centers).shape[-1])
    if inputs is None:
        inputs = _probe_inputs(topo.n, d, seed, device)
    entries = tuple(_score(topo, centers, cfg, _apply(base, c), c, inputs,
                           seed, measure, repeats, device) for c in cands)
    key = ((lambda e: e.measured_us) if measure
           else (lambda e: e.modeled_us))
    chosen = min(entries, key=key).cand
    return PlanResult(config=_apply(base, chosen), chosen=chosen,
                      table=entries)


def format_table(result: PlanResult) -> str:
    """The CLI's plan table: one row per candidate, winner marked."""
    hdr = (f"{'':2} {'S':>3} {'slack':>5} {'K':>4} {'wire':>8} "
           f"{'wireB/cyc':>10} {'flops':>10} {'hbmB':>10} {'collB':>10} "
           f"{'model us':>9} {'meas us':>9}")
    lines = [hdr, "-" * len(hdr)]
    for e in result.table:
        mark = "*" if e.cand == result.chosen else ""
        meas = "-" if math.isnan(e.measured_us) else f"{e.measured_us:9.1f}"
        lines.append(
            f"{mark:2} {e.cand.num_shards:>3} {e.cand.halo_slack:>5.2f} "
            f"{e.cand.k:>4} {e.cand.wire:>8} {e.wire_bytes:>10} "
            f"{e.flops:>10.3g} {e.hbm_bytes:>10.3g} "
            f"{e.collective_bytes:>10.3g} {e.modeled_us:>9.1f} {meas:>9}")
    c = result.chosen
    lines.append(f"chosen: S={c.num_shards} slack={c.halo_slack} "
                 f"K={c.k} wire={c.wire}")
    return "\n".join(lines)


def _main(argv=None) -> int:
    import argparse

    from ..core import topology

    p = argparse.ArgumentParser(
        description="Enumerate engine execution plans, score them with "
        "the counted dispatch cost + wire byte model, time them, and "
        "print the plan table (winner marked with *).")
    p.add_argument("--n", type=int, default=10_000, help="peer count")
    p.add_argument("--graph", choices=("grid", "ba"), default="grid")
    p.add_argument("--k-centers", type=int, default=3,
                   help="Voronoi option points")
    p.add_argument("--d", type=int, default=2, help="statistic dimension")
    p.add_argument("--shards", default="2,4",
                   help="comma-separated shard counts")
    p.add_argument("--slacks", default="1.5",
                   help="comma-separated halo_slack values")
    p.add_argument("--ks", default="4,8,16",
                   help="comma-separated cycles_per_dispatch values")
    p.add_argument("--wires", default="exact,compact,int8",
                   help="comma-separated wire formats "
                   f"(known: {', '.join(sorted(exchange.WIRE_FORMATS))})")
    p.add_argument("--no-measure", action="store_true",
                   help="rank by the cost model only (no timed runs)")
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="where the probes run (default cuda; cpu runs the "
                   "plain versions of the kernels)")
    args = p.parse_args(argv)

    topo = (topology.grid(args.n) if args.graph == "grid"
            else topology.barabasi_albert(args.n, m=2, seed=args.seed))
    g = torch.Generator().manual_seed(args.seed)
    centers = torch.randn((args.k_centers, args.d), generator=g)
    cands = tuple(
        Candidate(s, sl, k, w)
        for s in (int(x) for x in args.shards.split(","))
        for sl in (float(x) for x in args.slacks.split(","))
        for k in (int(x) for x in args.ks.split(","))
        for w in args.wires.split(","))
    result = plan(topo, centers, candidates=cands, seed=args.seed,
                  measure=not args.no_measure, repeats=args.repeats,
                  device=args.device)
    print(f"graph={args.graph} n={topo.n} d={args.d} "
          f"candidates={len(cands)} device={args.device}")
    print(format_table(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
