#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, in parallel) and print the build time and the
   compiler's register report;
3. hold each kernel against its plain PyTorch version on the card, at the
   ``run_static`` path's shapes (grid, Chord and Barabási–Albert at 80,000
   peers, k = 3, d = 2) and at edge shapes (n not a block multiple,
   k = 243, d = 6; Voronoi, halfspace and padded-Voronoi families), and
   time both; then the query-batched ``lss_state`` / ``correction`` at the
   service's shapes (Q = 64 slots of mixed Voronoi, halfspace, padded and
   padding families with per-slot beta / eps, on grid and Chord) and
   ``region_decide`` at n = 80,000 (k = 3 and 243) and at the observe
   pass's (Q = 64, one vector each), and ``region_decide``'s second entry,
   the observe pass's global decision, at the service's shapes (Q = 64 on
   grid and Chord) and at ``run_static``'s (Q = 1), each timed beside its
   bound and its share of the bound, by CUDA events over back-to-back
   calls of its launcher and as device time a launch from
   ``torch.profiler`` (the two differ where the launcher, not the kernel,
   sets the pace); ``lss_state`` and ``correction`` are also held
   bitwise (equal values, rtol = atol = 0; ``viol`` and ``dec`` equal
   everywhere, near ties included) to their plain versions on inputs that
   are not dyadic, at the ``run_static`` shapes and at the service's
   (Q = 64, per-slot eps / beta, padding slots), and the global decision
   gives the plain ``want`` and, bitwise, its rounded global sums on
   non-dyadic inputs with dead peers, an all-dead slot, padding slots,
   per-slot eps and a halfspace threshold at the float32 mean;
4. run ``sim.run_static`` on the three topologies at 80,000 peers through
   the kernels, with the launch counters zeroed before each run and read
   after it; then time the same loop after its set-up, synchronized, over
   several repeats (median and spread of µs per cycle), and run it once
   more under ``torch.profiler`` to print the device time by kernel, the
   device kernels launched per cycle and the device's idle share of that
   profiled loop's own wall time;
5. at 4,096 peers, run ``run_static`` with the kernels and with the
   reference formulas on the card and require the same outcome;
6. serve ``benchmarks/service_throughput.py``'s workload with the port's
   ``Service`` (this slice's main path): 64 heterogeneous tenants, K = 16
   cycles per dispatch, 4 dispatches with an update of n/100 peers at
   each boundary, on grid (80,089 peers) and Chord (80,000), counters
   zeroed before and read after; print the dispatch wall, tenant-cycles
   per second, launches and host syncs per dispatch, peak memory, and one
   more dispatch under ``torch.profiler`` (device kernels per dispatch);
7. service parity: tenants 0 (Voronoi) and 1 (halfspace) of each run
   replayed alone through the single-query ``cycle_impl`` must give the
   served per-dispatch msgs and accuracy, and at grid 4,096 with Q = 8 the
   fused-suite and reference-suite services must give identical records;
8. the sharded engine: ``run_static(engine=EngineConfig(num_shards=8,
   cycles_per_dispatch=10))`` (``benchmarks/engine_scaleup.py``'s S and K)
   on the three topologies at 80,000 peers through the kernels, counters
   zeroed before each run and read after it.  Its results must equal the
   core's observed at the engine's grain (``check_every=10``) exactly, and
   phase 4's where the grain does not enter (``total_msgs``,
   ``msgs_per_link``, ``final_accuracy``, ``quiescent``; ``quiesced_at``
   rounded up to a multiple of 10).  Then the engine's loop is timed as
   phase 4 times the core's (set-up, the BFS partition included, outside
   the timed runs) and profiled once more, beside the core's loop
   observed at the engine's grain (the same cycles and observes), with
   the cut edges, the halo
   width and the modeled halo bytes per cycle of the ``exact`` and
   ``compact`` wires, and the three kernels' wrappers are held bitwise to
   their plain versions on the engine's own flat state; a grid run on the
   ``compact`` wire must give the
   ``exact`` wire's results; at 4,096 peers the engine through the kernels
   and through the reference formulas must give identical results; and
   ``engine.sweep_static`` on Chord at 80,000 peers (seeds 0-3, 40
   cycles, counters zeroed before and read after) must give each seed's
   sequential ``run_static(max_cycles=40)`` final accuracy and message
   count;
9. the engine's async ring and quantized wires, through the same route
   and configuration on the three topologies at 80,000 peers, each
   engine built once, counters zeroed before each run and read after it:
   (a) ``async_mode=True, staleness=0`` must give phase 8's sync results
   exactly, and on grid every ``ShardedState`` field bitwise after 20
   cycles at ``drop_rate`` 0 and 0.1; (b) ``staleness=2`` must quiesce
   within ``MAX_CYCLES`` with its realized mean delay in (0, 2] and
   reach 95 % accuracy (100 % on grid: on Barabási–Albert the JAX
   reference too quiesces below 100 %, because publications that no
   bounded-stale read picks age out of the ring, ROADMAP C.3); printed
   beside the sync engine's cycles and msgs per link with
   ``async_lag_stats``; (c) the ``int8`` and ``bf16`` wires must reach
   the exact wire's accuracy (1.0) and quiesce, with a nonzero error
   feedback; their modeled halo bytes per cycle are printed beside the
   lossless wires'; (d) ``int8`` at staleness 2 on grid must reach 1.0;
   (e) the three kernels are held bitwise to their plain versions on the
   async-2 and int8 engines' own state.  The async-2 and int8 loops are
   timed and profiled as phase 8's, and printed beside the exact sync
   engine's numbers from this run;
10. the service under membership churn
   (``benchmarks/membership_churn.py::_bench_serve`` at the paper's size):
   a ``DynTopology`` with a fifth of its rows spare and ``deg_cap`` = max
   degree + 2 over grid (80,089 peers, n_cap 96,106) and Chord (80,000,
   n_cap 96,000), 16 Voronoi tenants, K = 8, one untimed and 12 timed
   dispatches at 0, 8 and 128 seeded join+link / leave / rewire events a
   dispatch, counters zeroed before each run and read after it; prints
   µs per cycle (median, min, max), the ``membership_drain`` span's ms a
   dispatch, the events queued and applied, launches a dispatch, peak
   memory, and one more dispatch under ``torch.profiler`` (device events
   a dispatch, idle share), then the table refresh alone.  After each
   run the three kernels' wrappers are held bitwise to their plain
   versions on that service's own (Q, n_cap, D) state (dead spare rows,
   masks with holes), and timed beside their bounds after the 128-event
   runs; the same hold runs on the regrow run's and the grown
   suite-parity service's state.  A grid service
   whose joins hit ``n_cap`` mid-serve (an auto-regrow epoch) must give,
   dispatch by dispatch, the records of a service provisioned large
   (msgs and quiescent exact, accuracy within 1e-7), and at grid 4,096
   the fused-suite and reference-suite services must give identical
   records under churn through a regrow of the rows and of the degree
   slots;
11. the service on the sharded engine backend (``backend="engine"``,
   ``engine_shards=8``, BFS, exact wire: ``benchmarks/engine_scaleup.py``'s
   S), Q = 16 tenants stacked on the leading axis of the sharded state,
   on phase 10's workload at 0 and 128 events a dispatch, counters zeroed
   before each run and read after it: every record equal to phase 10's
   core-backed run of the same seeds, dispatch by dispatch (msgs,
   quiescent and region exact, accuracy within 1e-7), and each kernel's
   launches equal to the core's (one launch a step for all 16 tenants);
   the 128-event run takes a forced ``rebalance_now`` after its 6th timed
   dispatch (cut fraction before and after, drift, the epoch's ms) and
   its records still equal the core's; µs per cycle, ``membership_drain``
   ms, launches a dispatch, peak memory and a profiled dispatch (device
   events, idle share) printed beside phase 10's; the three kernels held
   bitwise to their plain versions on the service's own flat (Q, S·B, D)
   state after each run and timed beside their bounds after the
   128-event runs; at grid 4,096 the fused-suite and reference-suite
   engine-backed services must give identical records under churn
   through a regrow of the rows and of the degree slots;
12. the overlapped boundary (``ServiceConfig(overlap=True)``: each
   dispatch on the service's worker thread beside the next boundary's
   host work) beside the synchronous service, on phase 10's workload on
   Chord at 128 events a dispatch, on the core and on the engine backend
   (S = 8): one untimed dispatch each, then two interleaved rounds of six
   timed ticks (the events emitted inside the timed chunk, the overlapped
   chunk ending when its last dispatch is back), the counters zeroed
   before each chunk and read after it, and two more dispatches each
   under ``torch.profiler``; on the engine the second round opens with a
   rebalance, in line in the synchronous service and staged
   (``StagedBuild``) in the overlapped one, adopted by a later boundary.
   Every record must equal the synchronous service's, dispatch by
   dispatch (msgs, quiescent and region exact, accuracy within 1e-7), the
   launches must be equal, the staged epoch must say ``staged: true``,
   and the three kernels are held bitwise on the overlapped service's
   state.  It prints the wall a tick and ``wall_ratio``, the pipeline
   bubble (``host_overhead_frac`` and ``host_frac_ratio``, by
   ``benchmarks/async_overlap.py``'s definition from the service's own
   spans), ``membership_drain`` ms and its half beside the dispatch, the
   epoch ms staged and in line, device events and idle share.  Then
   phase 10's regrow run on grid on the engine backend, synchronous and
   overlapped: under overlap the regrow at the capacity wall adopts the
   build ``auto_regrow`` staged at the first boundary (``staged: true``),
   with records equal;
13. the observability and audit plane: (a) ``benchmarks/obs_overhead.py``
   on phase 6's workload (Chord, Q = 64, K = 16), five services that
   differ only in their tracker and knobs (``noop``, ``jsonl``, ``prom``
   with a scrape a dispatch, ``traced``: profiling and an always-firing
   alert, ``audited``: ``audit_every=1``), one untimed dispatch each and
   three round-robin timed ones: records equal across the five, every
   audit ``ok``, the median dispatch ms and ``overhead_frac`` of each;
   (b) phase 10's churn at 128 events on the core and (S = 8, a forced
   rebalance) the engine backend with ``audit_every=1``, counters zeroed
   before each run and read after it: records and launches equal to
   phase 10's unaudited runs, every audit ``ok``, the kernels held
   bitwise on the audited state; ``ShardedLSS.audit`` on phase 9's
   staleness-2 and int8 engines (grid, Chord) holds; (c) one fault of
   each ``AuditFaults`` kind at grid 4,096 (two through the service on
   both backends, the skew and the sequence regression on the engine):
   the verdicts equal the CPU's and forensics names the faulted window;
   (d) the overlapped engine service on phase 12's Chord churn with
   ``profile_dispatch=True`` and ``profile_sample_every=4``: records
   equal to the unprofiled service's, the sampled ``dispatch_host_ms``,
   ``dispatch_device_ms`` and ``host_overhead_frac`` printed, and one
   ``profiler_dir`` session on a small overlapped service writes a Chrome
   trace.

It prints a JSON line with one entry per kernel (its numbers at the
service's shape, ``by_shape`` for the others, ``launches`` summed over the
``run_static``, service, engine, sweep, async-engine, quantized-engine,
churned-service, engine-backed-service, overlapped-service and
audited-service runs, each path's in ``launches_by_path``;
``share_of_bound`` = bound / time beside each time, ``device_ms`` the
profiler's device time a launch, ``bitwise_values`` the values held
bitwise; ``correction``'s also carries
``bound_v_ms``, the bound of the violating-set part the main path keeps;
``region_decide``'s numbers are its second entry's, the one the main
paths launch, with the first entry's shapes in ``by_shape``),
then, as its last line, ``{"ok": true, "device": {...}}``.  Without CUDA,
or outside a checkout of the repository, it exits nonzero and prints no
result.

Tolerances: float outputs ``allclose(rtol=1e-5, atol=1e-5)``.  The
kernel-check inputs are multiples of 1/64 of moderate size, so every sum
is exact in float32 in any order; ``viol`` and ``dec`` must then match
exactly, except at rows where a decision is a near tie (best and
second-best Voronoi score, or v.w and b, within 1e-5 relative, absolute
below 1); those rows are counted and printed.  ``region_decide`` must
match exactly: the plain decision does the kernel's arithmetic; its second
entry must give equal ids and bitwise equal global sums (both sum in
float64 and round once).
``lss_state`` and ``correction`` must match bitwise on non-dyadic inputs
too: they sum each row's live or violating slots in the plain version's
order (``slot_sum``), and a sum rounded otherwise would show there.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Outside a checkout of the repository this import fails: no result.
from repro_torch import kernels, obs, service  # noqa: E402
from repro_torch.core import (lss, regions, sim, stopping,  # noqa: E402
                              topology, wvs)
from repro_torch.engine import EngineConfig, exchange  # noqa: E402
from repro_torch.engine import sweep as engine_sweep  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import correction as kcorr  # noqa: E402
from repro_torch.kernels import lss_state as kst  # noqa: E402
from repro_torch.kernels import region_decide as kdec  # noqa: E402
from repro_torch.obs import audit as obs_audit  # noqa: E402
from repro_torch.obs import forensics  # noqa: E402

N_MAIN = 80_000
N_SMALL = 4096
Q_SERVICE = 64  # benchmarks/service_throughput.py: 64 tenants, K = 16
K_SERVICE = 16
SERVICE_DISPATCHES = 4
SERVICE_TOPOS = ("grid", "chord")  # BA at Q = 64 would need ~96 GB
MAX_CYCLES = 600  # as benchmarks/common.py::timed_static
ENGINE = dict(num_shards=8, cycles_per_dispatch=10)  # engine_scaleup.py
SWEEP_SEEDS = (0, 1, 2, 3)
SWEEP_CYCLES = 40
KERNELS = ("region_decide", "lss_state", "correction")
RESULT_KEYS = ("cycles_95", "cycles_100", "quiesced_at", "total_msgs",
               "msgs_per_link", "final_accuracy", "quiescent")
TIMED_REPEATS = 7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
F64_OPS_PER_S = 34e12  # H100 SXM float64 outside the tensor cores
RTOL = ATOL = 1e-5
TIE_REL = 1e-5


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _topologies(n):
    side = int(round(n ** 0.5))  # as benchmarks/common.py::topo_factory
    return {"grid": topology.grid(side * side),
            "chord": topology.chord(n),
            "ba": topology.barabasi_albert(n, m=2, seed=1)}


# --- phase 3: kernels against their plain versions ------------------------


def _dyadic(t):
    """Round to a multiple of 1/64: sums of such values are exact."""
    return torch.round(t * 64.0) / 64.0


def _kernel_inputs(mask, d, gen, zero_frac=0.25):
    """Random moment-form inputs on ``mask``'s shape, (n, D) or with a
    leading slot axis (Q, n, D) (tests/test_kernels.py ``_mk`` on the card,
    rounded to multiples of 1/64)."""
    shape = tuple(mask.shape)
    dev = mask.device

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def pos(*s):
        return 0.05 + 1.95 * torch.rand(s, generator=gen, device=dev)

    keep = (torch.rand(shape, generator=gen, device=dev) >= zero_frac).float()
    x_m = _dyadic(randn(*shape[:-1], d))
    x_c = torch.ones(shape[:-1], device=dev)
    out_m = _dyadic(randn(*shape, d) * 0.3) * keep[..., None]
    out_c = _dyadic(pos(*shape)) * keep
    in_m = _dyadic(randn(*shape, d) * 0.3) * keep[..., None]
    in_c = _dyadic(pos(*shape)) * keep
    return x_m, x_c, out_m, out_c, in_m, in_c, mask.contiguous()


def _near_tie(v, slot):
    """Rows of ``v`` (..., d) whose packed decision is a near tie."""
    v = v.double()
    if int(slot.kind) == 0:
        c = slot.centers.double()
        scores = -2.0 * v @ c.T + (c * c).sum(-1)
        scores = torch.where(slot.cmask, scores, torch.inf)
        if scores.shape[-1] < 2:
            return torch.zeros(v.shape[:-1], dtype=torch.bool,
                               device=v.device)
        two = torch.topk(scores, 2, dim=-1, largest=False).values
        a, b = two[..., 0], two[..., 1]
    else:
        a = v @ slot.w.double()
        b = slot.b.double().expand_as(a)
    scale = torch.clamp(torch.maximum(a.abs(), b.abs()), min=1.0)
    return torch.isfinite(b) & ((b - a).abs() <= TIE_REL * scale)


def _tie_rows(args, s_m, s_c, slot, eps):
    """Peers whose f(S), or f(A) / f(S - A) on a live slot, is a near tie."""
    _, _, out_m, out_c, in_m, in_c, mask = args
    rows = _near_tie(wvs.vec(wvs.WV(s_m, s_c), eps), slot)
    ii, kk = torch.nonzero(mask, as_tuple=True)
    a_m = out_m[ii, kk] + in_m[ii, kk]
    a_c = out_c[ii, kk] + in_c[ii, kk]
    sa = wvs.WV(s_m[ii] - a_m, s_c[ii] - a_c)
    slot_tie = (_near_tie(wvs.vec(wvs.WV(a_m, a_c), eps), slot)
                | _near_tie(wvs.vec(sa, eps), slot))
    rows[ii[slot_tie]] = True
    return rows


def _time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps, match):
    """Device time a launch of the kernels whose name contains ``match``,
    from ``torch.profiler`` over ``reps`` calls of ``fn`` after a warm one;
    None where the profiler saw none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ivals = [(s, e) for name, s, e in _device_intervals(prof)
             if match in name]
    if not ivals:
        return None
    return sum(e - s for s, e in ivals) / len(ivals) / 1e3


def _lss_state_cost(args, k):
    """(bytes, operations) the fused status/violation function needs (n
    counts the peers of every slot of a batched call)."""
    x_m, x_c, out_m, _, _, _, mask = args
    D, d = out_m.shape[-2:]
    n = x_c.numel()
    live = int(mask.sum())
    nbytes = (4 * n * (d + 1)  # x_m, x_c
              + n * D  # mask
              + 4 * live * 2 * (d + 1)  # out and in moments, weights
              + 4 * n * (d + 1) + n * D + 4 * n)  # s_m, s_c, viol, dec
    decide = 2 * k * (d + 1)  # dot, scale and norm per candidate
    ops = (n * (d + 1 + d + decide)  # S, vec(S), f(S)
           + live * (4 * (d + 1) + 2 * d + 2 * decide))  # A, S-A, vecs, fs
    return nbytes, ops


def _correction_cost(args, v):
    """(bytes, operations) of the Eq.-10 correction on these inputs.

    The function returns a corrected message for every slot, so every
    slot's ``in`` and ``a_c`` is read and every slot of ``out'`` written,
    under the rule ``_lss_state_cost`` follows too: each input read where
    an output depends on it, each output written once."""
    _, s_c, a_m, _, _, _, _ = args
    D, d = a_m.shape[-2:]
    n = s_c.numel()
    nv = int(v.sum())
    nbytes = (4 * n * (d + 1)  # s_m, s_c
              + 4 * n * D  # a_c
              + 4 * nv * d  # a_m on the violating set
              + 4 * n * D * (d + 1)  # in_m, in_c
              + n * D  # v_set
              + 4 * n * D * (d + 1))  # out_m', out_c'
    ops = nv * (d + 1) + n * (d + 5) + n * D * (2 + 2 * (d + 1))
    return nbytes, ops


def _correction_cost_v(args, v):
    """(bytes, operations) of the part of the correction the main path
    keeps: ``lss.py`` blends ``out'`` in on the violating set V only, so
    this reads S, ``v_set``, and ``a`` and ``in`` on V, and writes V."""
    _, s_c, a_m, _, _, _, _ = args
    D, d = a_m.shape[-2:]
    n = s_c.numel()
    nv = int(v.sum())
    nbytes = (4 * n * (d + 1)  # s_m, s_c
              + n * D  # v_set
              + 4 * nv * 2 * (d + 1)  # a and in on V
              + 4 * nv * (d + 1))  # out_m', out_c' on V
    ops = nv * (d + 1) + n * (d + 5) + nv * (2 + 2 * (d + 1))
    return nbytes, ops


def _bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _share(bound, ms):
    """Share of the bound: the least time over the measured time."""
    return bound[0] / ms


def _fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def _fmt_share(bound, ms):
    return "not measured" if ms is None else f"{_share(bound, ms):.4f}"


def _check_correction_bitwise(label, v, beta, eps, gen):
    """``ops.correction`` against ``ref.correction_ref`` with rtol = atol = 0
    on non-dyadic inputs on V's shape ((n, D) or (Q, n, D)); S_c is 0 on
    every 7th peer, so the |T_c| <= eps guard is taken where V is empty
    there.  Returns the number of values compared."""
    shape, dev = tuple(v.shape), v.device

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def pos(*s):
        return 0.05 + 1.95 * torch.rand(s, generator=gen, device=dev)

    s_c = 3.0 * randn(*shape[:-1])
    s_c[..., ::7] = 0.0
    cargs = (randn(*shape[:-1], 2), s_c, 0.3 * randn(*shape, 2),
             pos(*shape), 0.3 * randn(*shape, 2), pos(*shape), v)
    got = ops.correction(*cargs, beta=beta, eps=eps)
    want = ref.correction_ref(*cargs, beta, eps)
    torch.cuda.synchronize()
    for name, g, w in zip(("out_m", "out_c"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: correction {name} differs from the plain version "
                f"on non-dyadic inputs at {int((g != w).sum())} values")
    return sum(g.numel() for g in got)


def _nondyadic_inputs(mask, d, gen):
    """Non-dyadic moment-form inputs on ``mask``'s shape ((n, D) or
    (Q, n, D)), with one live slot in ten dropped (dead slots anywhere in
    a row, as churn leaves them); dead slots hold values too."""
    shape, dev = tuple(mask.shape), mask.device

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def unif(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=gen, device=dev)

    live = mask & (torch.rand(shape, generator=gen, device=dev) >= 0.1)
    return (randn(*shape[:-1], d), unif(0.5, 2.0, *shape[:-1]),
            0.3 * randn(*shape, d), unif(-0.5, 2.0, *shape),
            0.3 * randn(*shape, d), unif(-0.5, 2.0, *shape),
            live.contiguous())


def _check_lss_state_bitwise(label, args, region, plain, eps):
    """``ops.lss_state`` against ``ref.lss_state_ref`` on ``args``: s_m and
    s_c with rtol = atol = 0, viol and dec equal everywhere.  Returns the
    number of values compared."""
    got = ops.lss_state(*args, region, eps=eps)
    want = ref.lss_state_ref(*args, plain, eps)
    torch.cuda.synchronize()
    for name, g, w in zip(("s_m", "s_c", "viol", "dec"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: lss_state {name} differs from the plain version "
                f"on non-dyadic inputs at {int((g != w).sum())} values")
    return sum(w.numel() for w in want)


def _check_case(label, args, slot, beta, eps, timed):
    """One kernel-vs-plain comparison of both kernels, through the public
    wrappers the main path calls; returns stats.  The bare launchers are
    used for timing only."""
    got = ops.lss_state(*args, slot, eps=eps)
    want = ref.lss_state_ref(*args, slot, eps)
    torch.cuda.synchronize()
    err_state = 0.0
    for name, g, w in zip(("s_m", "s_c"), got[:2], want[:2]):
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: lss_state {name} differs from "
                                 "the plain version")
        err_state = max(err_state, float((g - w).abs().max()))
    ties = _tie_rows(args, want[0], want[1], slot, eps)
    dec_bad = got[3] != want[3]
    viol_bad = (got[2] != want[2]).any(dim=1)
    if bool((dec_bad & ~ties).any()) or bool((viol_bad & ~ties).any()):
        raise AssertionError(
            f"{label}: lss_state dec/viol differ outside near ties "
            f"(dec rows {int((dec_bad & ~ties).sum())}, viol rows "
            f"{int((viol_bad & ~ties).sum())})")

    x_m, x_c, out_m, out_c, in_m, in_c, mask = args
    s_m, s_c, viol, _ = want
    a_m, a_c = out_m + in_m, out_c + in_c
    v = (viol & mask).contiguous()
    cargs = (s_m, s_c, a_m, a_c, in_m, in_c, v)
    cgot = ops.correction(*cargs, beta=beta, eps=eps)
    cwant = ref.correction_ref(*cargs, beta, eps)
    torch.cuda.synchronize()
    err_corr = 0.0
    for name, g, w in zip(("out_m", "out_c"), cgot, cwant):
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: correction {name} differs from "
                                 "the plain version")
        err_corr = max(err_corr, float((g - w).abs().max()))
    stats = {"label": label, "tie_rows": int(ties.sum()),
             "dec_tie_mismatch": int(dec_bad.sum()),
             "viol_tie_mismatch": int(viol_bad.sum()),
             "err_lss_state": err_state, "err_correction": err_corr}
    if timed:
        k = slot.centers.shape[0]
        table = [t[None] for t in ops.prep_slot(slot, eps=eps)]
        q_args = [a[None] for a in args]
        q_cargs = [a[None] for a in cargs]
        knobs = (torch.full((1,), beta, device=v.device),
                 torch.full((1,), eps, device=v.device))
        stats["lss_state_ms"] = _time_ms(
            lambda: kst.launch(*q_args, *table), 20)
        stats["lss_state_device_ms"] = _device_ms(
            lambda: kst.launch(*q_args, *table), 20, "lss_state")
        stats["lss_state_plain_ms"] = _time_ms(
            lambda: ref.lss_state_ref(*args, slot, eps), 5)
        stats["lss_state_bound"] = _bound_ms(*_lss_state_cost(args, k))
        stats["correction_ms"] = _time_ms(
            lambda: kcorr.launch(*q_cargs, *knobs), 20)
        stats["correction_device_ms"] = _device_ms(
            lambda: kcorr.launch(*q_cargs, *knobs), 20, "correction")
        stats["correction_plain_ms"] = _time_ms(
            lambda: ref.correction_ref(*cargs, beta, eps), 5)
        stats["correction_bound"] = _bound_ms(*_correction_cost(cargs, v))
        stats["correction_bound_v"] = _bound_ms(
            *_correction_cost_v(cargs, v))
        gen = torch.Generator(device=v.device)
        gen.manual_seed(2)
        stats["correction_bitwise"] = _check_correction_bitwise(
            label, v, beta, eps, gen)
        nd = _nondyadic_inputs(mask, x_m.shape[-1], gen)
        stats["lss_state_bitwise"] = _check_lss_state_bitwise(
            label, nd, slot, slot, eps)
    return stats


def _edge_family(fam, d, k, rng, dev):
    """tests/test_kernels.py::_packed_family, on the card."""

    def arr(*s):
        return torch.tensor(rng.standard_normal(s).astype(np.float32),
                            device=dev)

    if fam == "halfspace":
        return regions.as_packed_slot(regions.HalfspaceRegions(
            w=arr(d), b=torch.tensor(np.float32(rng.standard_normal()),
                                     device=dev)))
    vor = regions.VoronoiRegions(arr(k, d))
    if fam == "padded":
        return regions.PackedRegions.pack([vor], k_max=k + 3).slot(0)
    return regions.as_packed_slot(vor)


def phase_kernels(topos, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    centers = torch.randn((3, 2), generator=gen, device=dev)
    slot = regions.PackedSlot.voronoi(centers)
    main = {}
    for name, topo in topos.items():
        mask = torch.tensor(topo.mask, device=dev)
        args = _kernel_inputs(mask, 2, gen)
        st = _check_case(f"{name} n={topo.n} D={topo.max_deg}",
                         args, slot, 1e-3, 1e-9, timed=True)
        main[name] = st
        print(f"[kernels] {st['label']}: lss_state {st['lss_state_ms']:.4f} "
              f"ms (device {_fmt_ms(st['lss_state_device_ms'])} a launch; "
              f"plain {st['lss_state_plain_ms']:.4f}, bound "
              f"{st['lss_state_bound'][0]:.4f} by "
              f"{st['lss_state_bound'][1]}, share "
              f"{_share(st['lss_state_bound'], st['lss_state_ms']):.4f}; "
              f"bitwise on {st['lss_state_bitwise']} non-dyadic values); "
              f"correction {st['correction_ms']:.4f} ms (device "
              f"{_fmt_ms(st['correction_device_ms'])} a launch; plain "
              f"{st['correction_plain_ms']:.4f}, bound "
              f"{st['correction_bound'][0]:.4f} by "
              f"{st['correction_bound'][1]}, share "
              f"{_share(st['correction_bound'], st['correction_ms']):.4f}; "
              f"on V only {st['correction_bound_v'][0]:.4f}; bitwise on "
              f"{st['correction_bitwise']} non-dyadic values); near-tie rows "
              f"{st['tie_rows']} (dec differs on {st['dec_tie_mismatch']}, "
              f"viol on {st['viol_tie_mismatch']}); max|err| "
              f"{st['err_lss_state']:.3g} / {st['err_correction']:.3g}",
              flush=True)
    # Edge shapes of tests/test_kernels.py::SHAPES x the three families.
    shapes = [(64, 2, 2, 3), (200, 5, 3, 4), (130, 8, 6, 7), (1024, 4, 1, 2),
              (33, 3, 2, 243)]
    for n, D, d, k in shapes:
        for fam in ("voronoi", "halfspace", "padded"):
            for beta in (1e-3, 0.1):
                rng = np.random.default_rng(n * 7 + D)
                fslot = _edge_family(fam, d, k, rng, dev)
                mask = torch.tensor(rng.random((n, D)) > 0.2, device=dev)
                args = _kernel_inputs(mask, d, gen)
                st = _check_case(f"edge n={n} D={D} d={d} k={k} {fam} "
                                 f"beta={beta}", args, fslot, beta, 1e-9,
                                 timed=False)
                if st["tie_rows"]:
                    print(f"[kernels] {st['label']}: near-tie rows "
                          f"{st['tie_rows']}", flush=True)
    print(f"[kernels] edge shapes: {len(shapes) * 6} cases agree",
          flush=True)
    return main


# --- phase 3b: the query-batched kernels at the service's shapes ---------


def _service_regions(q, k_max, d, gen, dev):
    """Q slots cycling Voronoi (k_max centers), halfspace, padded Voronoi
    (k_max - 1 centers) and padding (every center masked)."""
    packed = regions.PackedRegions.empty(q, k_max, d, device=dev)
    for i in range(q):
        kind = i % 4
        if kind == 3:
            continue
        if kind == 1:
            fam = regions.HalfspaceRegions(
                torch.randn((d,), generator=gen, device=dev),
                torch.randn((), generator=gen, device=dev))
        else:
            fam = regions.VoronoiRegions(torch.randn(
                (k_max - (kind == 2), d), generator=gen, device=dev))
        packed = packed.set(i, fam)
    return packed


def _slot_ties(args, want, packed, eps, rows):
    """Near-tie peers of the slots in ``rows`` (bool (Q, n))."""
    ties = torch.zeros_like(rows)
    for q in torch.nonzero(rows.any(dim=1)).flatten().tolist():
        one = [a[q] for a in args]
        ties[q] = _tie_rows(one, want[0][q], want[1][q], packed.slot(q),
                            float(eps[q]))
    return ties


def _check_batched(label, args, packed, eps, beta, timed):
    """The Q-batched lss_state and correction through the wrappers against
    their plain versions (decisions exact off near ties), then timed."""
    tables = ops.prep_slots(packed, eps, beta)
    got = ops.lss_state(*args, tables, eps=eps)
    want = ref.lss_state_ref(*args, packed, eps)
    torch.cuda.synchronize()
    err_state = 0.0
    for name, g, w in zip(("s_m", "s_c"), got[:2], want[:2]):
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: batched lss_state {name} differs")
        err_state = max(err_state, float((g - w).abs().max()))
    bad = (got[3] != want[3]) | (got[2] != want[2]).any(dim=-1)
    ties = _slot_ties(args, want, packed, eps, bad) if bool(bad.any()) \
        else bad
    if bool((bad & ~ties).any()):
        raise AssertionError(f"{label}: batched dec/viol differ outside "
                             f"near ties ({int((bad & ~ties).sum())} rows)")
    padding = (packed.kind == regions.KIND_VORONOI) & ~packed.cmask.any(-1)
    if bool(got[3][padding].any()):
        raise AssertionError(f"{label}: a padding slot decided != 0")
    _, _, out_m, out_c, in_m, in_c, mask = args
    s_m, s_c, viol, _ = want
    v = (viol & mask).contiguous()
    cargs = (s_m, s_c, out_m + in_m, out_c + in_c, in_m, in_c, v)
    cgot = ops.correction(*cargs, beta=beta, eps=eps)
    cwant = ref.correction_ref(*cargs, beta, eps)
    torch.cuda.synchronize()
    err_corr = 0.0
    for name, g, w in zip(("out_m", "out_c"), cgot, cwant):
        if not torch.allclose(g, w, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"{label}: batched correction {name} "
                                 "differs")
        err_corr = max(err_corr, float((g - w).abs().max()))
    stats = {"label": label, "mismatch_rows": int(bad.sum()),
             "err_lss_state": err_state, "err_correction": err_corr}
    if timed:
        k = packed.k_max
        table = (tables.cthw, tables.cn, tables.meta)
        stats["lss_state_ms"] = _time_ms(lambda: kst.launch(*args, *table),
                                         10)
        stats["lss_state_device_ms"] = _device_ms(
            lambda: kst.launch(*args, *table), 10, "lss_state")
        stats["lss_state_plain_ms"] = _time_ms(
            lambda: ref.lss_state_ref(*args, packed, eps), 3)
        stats["lss_state_bound"] = _bound_ms(*_lss_state_cost(args, k))
        knobs = (beta.contiguous(), eps.contiguous())
        stats["correction_ms"] = _time_ms(
            lambda: kcorr.launch(*cargs, *knobs), 10)
        stats["correction_device_ms"] = _device_ms(
            lambda: kcorr.launch(*cargs, *knobs), 10, "correction")
        stats["correction_plain_ms"] = _time_ms(
            lambda: ref.correction_ref(*cargs, beta, eps), 3)
        stats["correction_bound"] = _bound_ms(*_correction_cost(cargs, v))
        stats["correction_bound_v"] = _bound_ms(
            *_correction_cost_v(cargs, v))
        gen = torch.Generator(device=v.device)
        gen.manual_seed(3)
        stats["correction_bitwise"] = _check_correction_bitwise(
            label, v, beta, eps, gen)
        nd = _nondyadic_inputs(mask, out_m.shape[-1], gen)
        stats["lss_state_bitwise"] = _check_lss_state_bitwise(
            label, nd, tables, packed, eps)
    return stats


def _region_decide_cost(v, packed):
    """(bytes, operations) of the packed decision of ``v`` (Q, m, d): each
    vector read, each id written, each slot's table read once; per vector
    d products, d - 1 sums, a scale, an add and a compare for each center
    of a Voronoi slot, d products, d - 1 sums and a compare for a
    halfspace."""
    q, m, d = v.shape
    k = packed.k_max
    nbytes = 4 * q * m * d + 4 * q * m + 4 * q * (d * (k + 1) + k + 4)
    centers = packed.cmask.sum(-1)
    per_vec = torch.where(packed.kind == regions.KIND_VORONOI,
                          centers * (2 * d + 2), 2 * d)
    return nbytes, int(per_vec.sum()) * m


def _check_region_decide(label, v, region, timed, library=None):
    """region_decide through its wrapper against its plain version; ids
    must agree exactly (the plain decision does the kernel's arithmetic)."""
    packed = region if isinstance(region, regions.PackedRegions) else \
        regions.PackedRegions(*(f[None] for f in region))
    got = ops.region_decide(v, region)
    want = ref.region_decide_ref(v, region)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: region_decide differs on "
                             f"{int((got != want).sum())} vectors")
    stats = {"label": label,
             "max_abs_err": float((got - want).abs().max()) if got.numel()
             else 0.0}
    if timed:
        vq = v if v.ndim == 3 else v[None]
        tables = ops.prep_slots(packed)
        table = (tables.cthw, tables.cn, tables.meta)
        stats["ms"] = _time_ms(lambda: kdec.launch(vq, *table), 20)
        stats["device_ms"] = _device_ms(lambda: kdec.launch(vq, *table), 20,
                                        "region_decide_kernel")
        stats["plain_ms"] = _time_ms(
            lambda: ref.region_decide_ref(v, region), 5)
        stats["bound"] = _bound_ms(*_region_decide_cost(vq, packed))
        stats["library_ms"] = None
    return stats


def phase_kernels_batched(topos, dev):
    """Q = 64 lss_state / correction at the service's shapes (grid and
    Chord at 80,000 peers, d = 2, k_max = 3, mixed slots with per-slot
    beta / eps), and region_decide at n = 80,000 (k = 3 and 243; Voronoi,
    padded Voronoi, halfspace) and at the observe pass's (64, 1, 2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {}
    eps = torch.tensor([1e-9, 1e-3] * (Q_SERVICE // 2), device=dev)
    beta = torch.tensor([1e-3, 0.1, 0.05, 1e-3] * (Q_SERVICE // 4),
                        device=dev)
    for name in SERVICE_TOPOS:
        topo = topos[name]
        mask = torch.tensor(topo.mask, device=dev).expand(
            Q_SERVICE, -1, -1)
        args = _kernel_inputs(mask, 2, gen)
        packed = _service_regions(Q_SERVICE, 3, 2, gen, dev)
        st = _check_batched(f"{name} Q={Q_SERVICE} n={topo.n} "
                            f"D={topo.max_deg}", args, packed, eps, beta,
                            timed=True)
        out[name] = st
        print(f"[kernels-q] {st['label']}: lss_state "
              f"{st['lss_state_ms']:.4f} ms (device "
              f"{_fmt_ms(st['lss_state_device_ms'])} a launch; plain "
              f"{st['lss_state_plain_ms']:.4f}, bound "
              f"{st['lss_state_bound'][0]:.4f} by "
              f"{st['lss_state_bound'][1]}, share "
              f"{_share(st['lss_state_bound'], st['lss_state_ms']):.4f}; "
              f"bitwise on {st['lss_state_bitwise']} non-dyadic values); "
              f"correction {st['correction_ms']:.4f} ms (device "
              f"{_fmt_ms(st['correction_device_ms'])} a launch; plain "
              f"{st['correction_plain_ms']:.4f}, bound "
              f"{st['correction_bound'][0]:.4f}, share "
              f"{_share(st['correction_bound'], st['correction_ms']):.4f}; "
              f"on V only {st['correction_bound_v'][0]:.4f}; bitwise on "
              f"{st['correction_bitwise']} non-dyadic values); rows "
              f"differing at "
              f"near ties {st['mismatch_rows']}; max|err| "
              f"{st['err_lss_state']:.3g} / {st['err_correction']:.3g}",
              flush=True)
        del args, mask
    decide = {}
    for k in (3, 243):
        v = torch.randn((N_MAIN, 2), generator=gen, device=dev)
        cent = torch.randn((k, 2), generator=gen, device=dev)
        fams = {"voronoi": regions.PackedSlot.voronoi(cent),
                "padded-voronoi": regions.PackedRegions.pack(
                    [regions.VoronoiRegions(cent)], k_max=k + 3).slot(0),
                "halfspace": regions.PackedSlot.halfspace(
                    torch.randn((2,), generator=gen, device=dev), 0.1)}
        for fam, slot in fams.items():
            if fam == "halfspace" and k != 3:
                continue
            st = _check_region_decide(f"n={N_MAIN} k={k} {fam}", v, slot,
                                      timed=True)
            decide[st["label"]] = st
    packed = _service_regions(Q_SERVICE, 3, 2, gen, dev)
    v = torch.randn((Q_SERVICE, 1, 2), generator=gen, device=dev)
    st = _check_region_decide(f"observe Q={Q_SERVICE} m=1", v, packed,
                              timed=True)
    decide["observe"] = st
    for st in decide.values():
        print(f"[kernels-q] region_decide {st['label']}: {st['ms']:.4f} ms "
              f"(device {_fmt_ms(st['device_ms'])} a launch; plain "
              f"{st['plain_ms']:.4f}, bound {st['bound'][0]:.5f} by "
              f"{st['bound'][1]}, share {_share(st['bound'], st['ms']):.5f}); "
              f"ids equal", flush=True)
    out["region_decide"] = decide
    out["global"] = phase_global(topos, dev, eps, gen)
    return out


def _global_inputs(q, n, gen, dev, dead=0.1):
    """Non-dyadic (q, n, 2) inputs of the global decision with the
    service's regions: weights in [0.5, 2), one peer in ten dead, every
    peer of slot 2 dead when q > 2, and slot 1 (a halfspace slot) with unit
    weights, every peer alive and its threshold at the float32 mean of its
    inputs, the rounding tie ``service.heterogeneous_tenants`` builds.
    Returns (x_m, x_c, alive, PackedRegions)."""
    x_m = torch.randn((q, n, 2), generator=gen, device=dev)
    x_c = 0.5 + 1.5 * torch.rand((q, n), generator=gen, device=dev)
    alive = torch.rand((q, n), generator=gen, device=dev) >= dead
    packed = _service_regions(q, 3, 2, gen, dev)
    if q > 2:
        alive[2] = False
        x_c[1] = 1.0
        alive[1] = True
        w = torch.randn((2,), generator=gen, device=dev)
        b = regions.dot(x_m[1].mean(0), w)
        packed = packed.set(1, regions.HalfspaceRegions(w, b))
    return x_m, x_c, alive, packed


def _global_cost(q, n, d, k):
    """(bytes, float64 adds) of the global decision: x_m, x_c and alive
    read once, each slot's table and eps read, want and gx written; d + 1
    adds a peer."""
    nbytes = (q * n * (4 * d + 5) + 4 * q * (d * (k + 1) + k + 4 + 1)
              + 4 * q * (d + 2))
    return nbytes, q * n * (d + 1)


def _check_global(label, x_m, x_c, alive, tables, plain, eps):
    """The global decision through its wrapper, with the tables prepared
    once as the main paths prepare them, against its plain version (want
    equal, gx_m / gx_c bitwise), then timed by CUDA events over
    back-to-back launcher calls and as device time a launch."""
    got = ops.global_decision(x_m, x_c, alive, tables, eps)
    want = ref.global_decision_ref(x_m, x_c, alive, plain, eps)
    torch.cuda.synchronize()
    for name, g, w in zip(("want", "gx_m", "gx_c"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{label}: global decision {name} differs from the plain "
                f"version at {int((g != w).sum())} values")
    batched = x_m.ndim == 3
    q_args = (x_m, x_c, alive) if batched else (x_m[None], x_c[None],
                                                 alive[None])
    knob = eps.contiguous() if isinstance(eps, torch.Tensor) else eps
    launch = lambda: kdec.launch_global(  # noqa: E731
        *q_args, tables.cthw, tables.cn, tables.meta, knob)
    q, n, d = q_args[0].shape
    return {"label": label, "max_abs_err": 0.0,
            "bitwise_values": sum(w.numel() for w in want),
            "ms": _time_ms(launch, 20),
            "device_ms": _device_ms(launch, 20, "global_decide"),
            "plain_ms": _time_ms(
                lambda: ref.global_decision_ref(x_m, x_c, alive, plain,
                                                eps), 5),
            "bound": _bound_ms(*_global_cost(q, n, d, tables.cn.shape[-1]),
                               ops_per_s=F64_OPS_PER_S)}


def phase_global(topos, dev, eps, gen):
    """``region_decide``'s second entry, the observe pass's global
    decision: at the service's shapes (Q = 64 on grid and Chord, per-slot
    eps) and at ``run_static``'s (Q = 1, one eps, a Voronoi slot of the
    driver's k = 3)."""
    out = {}
    for name in SERVICE_TOPOS:
        n = topos[name].n
        x_m, x_c, alive, packed = _global_inputs(Q_SERVICE, n, gen, dev)
        out[f"service {name}"] = _check_global(
            f"global {name} Q={Q_SERVICE} n={n}", x_m, x_c, alive,
            ops.prep_slots(packed, eps), packed, eps)
    cent = torch.randn((3, 2), generator=gen, device=dev)
    slot = regions.PackedSlot.voronoi(cent)
    for name in ("chord", "grid"):
        n = topos[name].n
        x_m, x_c, alive, _ = _global_inputs(1, n, gen, dev)
        out[f"run_static {name}"] = _check_global(
            f"global run_static {name} Q=1 n={n}", x_m[0], x_c[0], alive[0],
            ops.prep_slots(slot, 1e-9), slot, 1e-9)
    for st in out.values():
        print(f"[kernels-q] region_decide {st['label']}: {st['ms']:.4f} ms "
              f"by events, device {_fmt_ms(st['device_ms'])} a launch "
              f"(plain {st['plain_ms']:.4f}, bound {st['bound'][0]:.5f} by "
              f"{st['bound'][1]}, share of bound by events "
              f"{_share(st['bound'], st['ms']):.4f}, by device time "
              f"{_fmt_share(st['bound'], st['device_ms'])}); want and "
              f"{st['bitwise_values']} values equal bitwise", flush=True)
    return out


# --- phase 6: the monitor service (this slice's main path) ---------------


def _make_stream(n, cycles, k, seed=7):
    """benchmarks/service_throughput.py::make_stream: (cycle, who, values)
    updates of n/100 peers at every K boundary."""
    rng = np.random.default_rng(seed)
    out = {}
    for c in range(k, cycles, k):
        who = rng.choice(n, size=max(1, n // 100), replace=False)
        out[c] = (who.astype(np.int32),
                  rng.normal(size=(who.size, 2)).astype(np.float32))
    return out


def _serve(topo, specs, dev, use_kernels=None, dispatches=SERVICE_DISPATCHES,
           timed=False):
    """benchmarks/service_throughput.py::run_service on the port: admit the
    tenants, then ``dispatches`` ticks with the update stream pushed at
    each boundary.  Returns (service, records per tick, wall s per tick)."""
    svc = service.Service(topo, service.ServiceConfig(
        capacity=len(specs), k_max=3, d=2, cycles_per_dispatch=K_SERVICE,
        use_kernels=use_kernels), device=dev)
    for spec in specs:
        svc.admit(spec)
    updates = _make_stream(topo.n, dispatches * K_SERVICE, K_SERVICE)
    records, walls = [], []
    for i in range(dispatches):
        if i * K_SERVICE in updates:
            who, vals = updates[i * K_SERVICE]
            svc.push_updates(who, vals, mode="set")
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        records.append(svc.tick())
        if timed:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return svc, records, walls, updates


def _check_records(label, records, q):
    """Every tick gave ``q`` records of plausible values."""
    for recs in records:
        if len(recs) != q:
            raise AssertionError(f"{label}: {len(recs)} records")
        for r in recs:
            if (not 0.0 <= r["accuracy"] <= 1.0 or r["msgs"] < 0
                    or r["region"] not in (0, 1, 2)):
                raise AssertionError(f"{label}: implausible record {r}")


def phase_service(topos, dev):
    """The service at the paper's peer count: 64 heterogeneous tenants,
    K = 16, 4 dispatches with the update stream, on grid and Chord; the
    launch counters and the do-while's host-read counter are zeroed just
    before and read just after; one more dispatch under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    totals = {"region_decide": 0, "lss_state": 0, "correction": 0}
    runs = {}
    for name in SERVICE_TOPOS:
        topo = topos[name]
        specs = service.heterogeneous_tenants(topo.n, Q_SERVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        lss.host_syncs = 0
        svc, records, walls, updates = _serve(topo, specs, dev, timed=True)
        torch.cuda.synchronize()
        counts = kernels.counts()
        syncs = lss.host_syncs
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if any(counts[f"{k}_ref"] for k in totals):
            raise AssertionError(f"{name}: the service ran a plain version")
        for key in totals:
            if counts[key] <= 0:
                raise AssertionError(f"{name}: the service launched no "
                                     f"{key}")
            totals[key] += counts[key]
        _check_records(name, records, Q_SERVICE)
        steady = walls[1:]
        med = float(np.median(steady))
        vor = [r["accuracy"] for r in records[-1] if r["slot"] % 2 == 0]
        half = [r["accuracy"] for r in records[-1] if r["slot"] % 2 == 1]
        print(f"[service] {name} n={topo.n} D={topo.max_deg} Q={Q_SERVICE} "
              f"K={K_SERVICE}: dispatch wall ms "
              f"{[round(w * 1e3, 3) for w in walls]}; dispatches 2-"
              f"{len(walls)}: median {med * 1e3:.3f} min "
              f"{min(steady) * 1e3:.3f} max {max(steady) * 1e3:.3f}; "
              f"tenant-cycles/s {Q_SERVICE * K_SERVICE / med:.1f}; "
              f"launches per dispatch "
              f"{ {k: counts[k] / len(walls) for k in totals} }; host "
              f"syncs (do-while reads) per dispatch {syncs / len(walls)} "
              f"+ 1 observe transfer; peak memory {peak:.3f} GiB; last "
              f"dispatch accuracy Voronoi min {min(vor):.4f} mean "
              f"{np.mean(vor):.4f}, halfspace min {min(half):.4f} mean "
              f"{np.mean(half):.4f}; msgs {sum(r['msgs'] for r in records[-1])}",
              flush=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            svc.tick()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _print_profile(f"service {name}", prof, wall * 1e3, med * 1e3, 1,
                       "dispatch")
        runs[name] = (specs, records, updates)
        del svc
        torch.cuda.empty_cache()
    return totals, runs


def _replay(topo, spec, updates, dev, dispatches):
    """One tenant through the single-query ``cycle_impl`` on the fused
    suite, with the service's updates at the same boundaries; returns
    (msgs, accuracy, quiescent, region) per dispatch."""
    ta = lss.TopoArrays.from_topology(topo, dev)
    st = lss.init_state(ta, spec.input_wv(dev), seed=spec.seed)
    slot = regions.as_packed_slot(
        type(spec.region)(*(t.to(dev) for t in spec.region)))
    cfg = lss.LSSConfig(beta=spec.beta, ell=spec.ell)
    suite = kernels.get_suite("fused")
    out = []
    for i in range(dispatches):
        if i * K_SERVICE in updates:
            who, vals = updates[i * K_SERVICE]
            idx = torch.as_tensor(who, dtype=torch.long, device=dev)
            x_m, x_c = st.x_m.clone(), st.x_c.clone()
            x_m[idx] = torch.as_tensor(vals, device=dev)
            x_c[idx] = 1.0
            st = st._replace(x_m=x_m, x_c=x_c)
        for _ in range(K_SERVICE):
            st, _ = lss.cycle_impl(st, ta, cfg, None, suite=suite,
                                   regions=slot)
        acc, quiescent, _, want = lss.metrics_impl(st, ta, None, cfg.eps,
                                                   suite=suite, regions=slot)
        out.append((int(st.msgs), float(acc), bool(quiescent), int(want)))
        st = st._replace(msgs=torch.zeros_like(st.msgs))
    return out


def phase_service_parity(topos, dev, runs):
    """Tenants 0 (Voronoi) and 1 (halfspace) of each service run replayed
    alone must give its per-dispatch msgs and accuracy; at grid 4,096 with
    Q = 8 the fused-suite and reference-suite services must give identical
    records."""
    for name, (specs, records, updates) in runs.items():
        for q in (0, 1):
            alone = _replay(topos[name], specs[q], updates, dev,
                            len(records))
            served = [(r[q]["msgs"], r[q]["accuracy"], r[q]["quiescent"],
                       r[q]["region"]) for r in records]
            if alone != served:
                raise AssertionError(f"{name} tenant {q}: served {served} "
                                     f"!= alone {alone}")
            print(f"[service-parity] {name} tenant {q}: the service's "
                  f"(msgs, accuracy, quiescent, region) per dispatch equal "
                  f"the single-query run: {served}", flush=True)
    side = int(round(N_SMALL ** 0.5))
    topo = topology.grid(side * side)
    specs = service.heterogeneous_tenants(topo.n, 8)
    fused = _serve(topo, specs, dev, use_kernels=True)[1]
    plain = _serve(topo, specs, dev, use_kernels=False)[1]
    if fused != plain:
        diff = [(i, a, b) for i, (ra, rb) in enumerate(zip(fused, plain))
                for a, b in zip(ra, rb) if a != b]
        raise AssertionError(f"fused != reference service: {diff[:4]}")
    print(f"[service-parity] grid n={topo.n} Q=8: fused-suite and "
          f"reference-suite services gave identical records over "
          f"{len(fused)} dispatches ({sum(len(r) for r in fused)} records)",
          flush=True)


# --- phases 4 and 5: the main path --------------------------------------


def _counted_run(label, fn=sim.run_static, **kw):
    """``fn(**kw)`` (a main path's entry point) with the launch counters
    zeroed before it and read after it; fails unless every kernel launched
    and no plain version ran."""
    kernels.reset_counts()
    res = fn(**kw)
    torch.cuda.synchronize()
    counts = kernels.counts()
    if min(counts[key] for key in KERNELS) <= 0:
        raise AssertionError(f"{label}: the path launched no kernel")
    if any(counts[f"{key}_ref"] for key in KERNELS):
        raise AssertionError(f"{label}: the path ran a plain version")
    return res, counts


def phase_main_path(topos, dev):
    totals = {"region_decide": 0, "lss_state": 0, "correction": 0}
    cycles, results = {}, {}
    for name, topo in topos.items():
        res, counts = _counted_run(name, topo=topo,
                                   spec=sim.ProblemSpec(n=topo.n),
                                   max_cycles=MAX_CYCLES, device=dev)
        cycles[name] = res["quiesced_at"] or MAX_CYCLES
        results[name] = res
        print(f"[main] {name} n={topo.n} D={topo.max_deg}: cycles_95="
              f"{res['cycles_95']} cycles_100={res['cycles_100']} "
              f"quiesced_at={res['quiesced_at']} msgs_per_link="
              f"{res['msgs_per_link']!r} final_accuracy="
              f"{res['final_accuracy']!r} counts={counts}", flush=True)
        acc = res["final_accuracy"]
        if not 0.0 <= acc <= 1.0 or res["msgs_per_link"] <= 0:
            raise AssertionError(f"{name}: implausible result {res}")
        for key in totals:
            totals[key] += counts[key]
    return totals, cycles, results


def _set_up(topo, dev, engine=None):
    """``run_static``'s set-up (tables, state and inputs on the card; with
    ``engine``, the partition and the engine's tables too)."""
    drv, _, _ = sim._driver(topo, sim.ProblemSpec(n=topo.n), lss.LSSConfig(),
                            engine, dev, None)
    torch.cuda.synchronize()
    return drv


def _timed_loop(drv, topo, check_every=1):
    """Wall seconds of ``run_static``'s loop on a driver set up already."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sim._run_to_quiescence(drv, topo, MAX_CYCLES, check_every)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res


def phase_timing(topos, dev, cycles):
    """µs per cycle of the main path's loop, set-up excluded: median and
    spread over TIMED_REPEATS runs, each from a fresh set-up."""
    medians = {}
    for name, topo in topos.items():
        setups, us = [], []
        for _ in range(TIMED_REPEATS):
            t0 = time.perf_counter()
            drv = _set_up(topo, dev)
            setups.append(time.perf_counter() - t0)
            wall, res = _timed_loop(drv, topo)
            if (res["quiesced_at"] or MAX_CYCLES) != cycles[name]:
                raise AssertionError(f"{name}: a timed run took another "
                                     "number of cycles")
            us.append(wall / cycles[name] * 1e6)
        medians[name] = float(np.median(us))
        print(f"[timing] {name}: us_per_cycle median {medians[name]:.1f} "
              f"min {min(us):.1f} max {max(us):.1f} over {len(us)} runs of "
              f"{cycles[name]} cycles, set-up excluded (set-up median "
              f"{np.median(setups) * 1e3:.1f} ms); all "
              f"{[round(u, 1) for u in us]}", flush=True)
    return medians


def _device_intervals(prof):
    """(name, start_us, end_us) of every device-side event of a trace."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cuda]


def _busy_us(intervals):
    busy, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _print_profile(label, prof, wall_ms, unprofiled_ms, steps=None,
                   step="cycle"):
    """Device busy time, idle share of the profiled wall, the device time
    by kernel and the device kernels launched (per ``step`` over ``steps``
    of them) of one torch.profiler trace.  Returns ``{"events": events per
    step, "idle": idle share}``, None where the profiler saw no device
    event."""
    ivals = _device_intervals(prof)
    if not ivals:
        print(f"[profile] {label}: device time not measured (the profiler "
              "saw no device events)", flush=True)
        return None
    copies = sum(name.startswith(("Memcpy", "Memset")) for name, _, _ in
                 ivals)
    if steps:
        print(f"[profile] {label}: device events {len(ivals)} = "
              f"{len(ivals) - copies} kernels + {copies} memcpy/memset over "
              f"{steps} {step}(s): {len(ivals) / steps:.2f} events, "
              f"{(len(ivals) - copies) / steps:.2f} kernels per {step}",
              flush=True)
    by_name = {}
    for kname, s, e in ivals:
        by_name[kname] = by_name.get(kname, 0.0) + (e - s)
    busy_ms = _busy_us(ivals) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"[profile] {label}: device busy {busy_ms:.3f} ms of the profiled "
          f"run's {wall_ms:.3f} ms wall (idle share "
          f"{1.0 - busy_ms / wall_ms:.3f}); unprofiled median "
          f"{unprofiled_ms:.3f} ms; device events {len(ivals)}", flush=True)
    for kname, us in top:
        print(f"[profile] {label}:   {us / 1e3:9.3f} ms "
              f"{100.0 * us / 1e3 / busy_ms:5.1f}%  {kname[:90]}",
              flush=True)
    return {"events": len(ivals) / steps if steps else None,
            "idle": 1.0 - busy_ms / wall_ms}


def phase_profile(topos, dev, medians, cycles):
    """Where the time goes: the main path's loop once more, set up outside
    the trace, under torch.profiler; device time by kernel, and the
    device's idle share of that profiled loop's own wall time."""
    from torch.profiler import ProfilerActivity, profile

    for name, topo in topos.items():
        drv = _set_up(topo, dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, _ = _timed_loop(drv, topo)
        _print_profile(name, prof, wall * 1e3,
                       medians[name] * cycles[name] / 1e3, cycles[name])


def phase_parity(dev):
    side = int(round(N_SMALL ** 0.5))
    for name, topo in (("grid", topology.grid(side * side)),
                       ("ba", topology.barabasi_albert(N_SMALL, m=2,
                                                       seed=1))):
        spec = sim.ProblemSpec(n=topo.n)
        fused = sim.run_static(topo, spec, max_cycles=MAX_CYCLES,
                               device=dev, use_kernels=True)
        plain = sim.run_static(topo, spec, max_cycles=MAX_CYCLES,
                               device=dev, use_kernels=False)
        if (fused["final_accuracy"] != plain["final_accuracy"]
                or fused["quiescent"] != plain["quiescent"]):
            raise AssertionError(f"{name}: fused {fused} != reference {plain}")
        diffs = {k: (fused[k], plain[k]) for k in
                 ("cycles_95", "cycles_100", "quiesced_at", "total_msgs")
                 if fused[k] != plain[k]}
        print(f"[parity] {name} n={topo.n}: final_accuracy="
              f"{fused['final_accuracy']!r} quiescent={fused['quiescent']} "
              f"differences (fused, reference): {diffs or 'none'}",
              flush=True)


# --- phase 8: the sharded engine and the sweep --------------------------


def _engine_cfg(**kw):
    return EngineConfig(**ENGINE, **kw)


def _diffs(got, want, keys=RESULT_KEYS):
    return {k: (got[k], want[k]) for k in keys if got[k] != want[k]}


def _halo_line(name, eng, res):
    """Cut edges, halo width and the modeled halo bytes per cycle of both
    lossless wires (the engine runs ``exact``)."""
    exact = int(eng.wire_pair_bytes(2).sum())
    compact = int(exchange.get_wire("compact").pair_bytes(
        eng._pair_counts, eng.stopo.halo_width, 2).sum())
    print(f"[engine] {name}: S={eng.S} B={eng.B} D={eng.D} cut_edges="
          f"{res['cut_edges']} of {eng.num_edges} halo_width="
          f"{eng.stopo.halo_width} halo bytes per cycle: exact {exact} "
          f"compact {compact}", flush=True)


def phase_engine(topos, dev, core_results):
    """The engine route of ``run_static`` at 80,000 peers through the
    kernels; returns (launch totals, cycles run, results)."""
    K = ENGINE["cycles_per_dispatch"]
    totals = {key: 0 for key in KERNELS}
    cycles, results = {}, {}
    for name, topo in topos.items():
        spec = sim.ProblemSpec(n=topo.n)
        res, counts = _counted_run(f"engine {name}", topo=topo, spec=spec,
                                   max_cycles=MAX_CYCLES,
                                   engine=_engine_cfg(), device=dev)
        for key in totals:
            totals[key] += counts[key]
        cycles[name] = res["quiesced_at"] or MAX_CYCLES
        results[name] = res
        print(f"[engine] {name} n={topo.n}: cycles_95={res['cycles_95']} "
              f"cycles_100={res['cycles_100']} quiesced_at="
              f"{res['quiesced_at']} msgs_per_link={res['msgs_per_link']!r}"
              f" final_accuracy={res['final_accuracy']!r} counts={counts}",
              flush=True)
        # The core observed at the engine's grain gives the same results.
        grain = sim.run_static(topo, spec, max_cycles=MAX_CYCLES,
                               check_every=K, device=dev)
        diffs = _diffs(res, grain)
        # Phase 4's run observes every cycle: the keys the grain does not
        # enter are equal, and quiescence rounds up to the grain.
        core = core_results[name]
        diffs.update(_diffs(res, core, ("total_msgs", "msgs_per_link",
                                         "final_accuracy", "quiescent")))
        if core["quiesced_at"] is not None and \
                res["quiesced_at"] != -(-core["quiesced_at"] // K) * K:
            diffs["quiesced_at vs phase 4"] = (res["quiesced_at"],
                                               core["quiesced_at"])
        if diffs:
            raise AssertionError(f"engine {name}: (engine, core) {diffs}")
        print(f"[engine] {name}: equal to the core at check_every={K} and "
              "to phase 4's results", flush=True)
    return totals, cycles, results


def _replay_state(st):
    """``st`` with copies of its drop and delay generators, so that a run
    from it draws what any other run from ``st`` draws."""
    from repro_torch.engine.engine import AsyncShardedState, _copy_generator

    def copy(gs):
        return tuple(_copy_generator(g) for g in gs)

    if isinstance(st, AsyncShardedState):
        return st._replace(sync=_replay_state(st.sync),
                           delay_rng=copy(st.delay_rng))
    return st._replace(rng=copy(st.rng)) if isinstance(st.rng, tuple) else st


def _check_engine_kernels(name, eng, st0):
    """The three kernels' wrappers on the engine's own flat ``S*B``-row
    state three cycles in (padding rows included), bitwise against their
    plain versions: ``lss_state`` and ``correction`` (V = every live slot)
    with the cycles' tables, the global decision with the observe's."""
    flat = eng._flat_state(eng.run(_replay_state(st0), 3))
    live = lss._live_mask(eng._flat_topo, flat.alive)
    cfg, tables = eng.cfg, eng._tables_for(eng.cfg.eps)
    args = (flat.x_m, flat.x_c, flat.out_m, flat.out_c, flat.in_m,
            flat.in_c, live)
    state = ops.lss_state(*args, tables, eps=cfg.eps)
    checks = [("lss_state", state, ref.lss_state_ref(
        *args, tables.regions, cfg.eps))]
    s_m, s_c, _, _ = state
    cargs = (s_m, s_c, flat.out_m + flat.in_m, flat.out_c + flat.in_c,
             flat.in_m, flat.in_c, live)
    checks.append(("correction",
                   ops.correction(*cargs, beta=cfg.beta, eps=cfg.eps),
                   ref.correction_ref(*cargs, cfg.beta, cfg.eps)))
    observe = eng._tables_for(sim.OBSERVE_EPS)
    gargs = (flat.x_m, flat.x_c, flat.alive)
    checks.append(("region_decide",
                   ops.global_decision(*gargs, observe, sim.OBSERVE_EPS),
                   ref.global_decision_ref(*gargs, observe.regions,
                                           sim.OBSERVE_EPS)))
    torch.cuda.synchronize()
    for kname, got, want in checks:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"engine {name}: {kname} differs from its plain version "
                    f"at the engine's shape in {int((g != w).sum())} values")
    print(f"[engine] {name}: lss_state, correction and the global decision "
          f"bitwise equal to their plain versions on the engine's "
          f"{flat.alive.shape[0]} rows x D={eng.D} (V: all "
          f"{int(live.sum())} live slots)", flush=True)


def _time_from(label, drv, topo, cycles, check_every):
    """µs per cycle of ``run_static``'s loop on ``drv``: median and spread
    over TIMED_REPEATS runs from the driver's initial state (the engine's
    and the core's functions are pure, so each run starts from the same
    state, with copies of its generators), then one more run under
    torch.profiler.  Returns the median, min, max and the profile's
    summary."""
    from torch.profiler import ProfilerActivity, profile

    st0 = drv._st
    us = []
    for _ in range(TIMED_REPEATS):
        drv._st = _replay_state(st0)
        wall, res = _timed_loop(drv, topo, check_every)
        if (res["quiesced_at"] or MAX_CYCLES) != cycles:
            raise AssertionError(f"{label}: a timed run took another "
                                 "number of cycles")
        us.append(wall / cycles * 1e6)
    median = float(np.median(us))
    print(f"[engine-timing] {label}: us_per_cycle median {median:.1f} min "
          f"{min(us):.1f} max {max(us):.1f} over {len(us)} runs of {cycles}"
          f" cycles; all {[round(u, 1) for u in us]}", flush=True)
    drv._st = _replay_state(st0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _timed_loop(drv, topo, check_every)
    summary = _print_profile(label, prof, wall * 1e3, median * cycles / 1e3,
                             cycles)
    return {"median": median, "min": min(us), "max": max(us),
            **(summary or {"events": None, "idle": None})}


def phase_engine_timing(topos, dev, cycles):
    """The engine route's loop timed and profiled (its set-up, the
    partition included, outside the timed runs), beside the core's loop
    observed at the engine's grain (``check_every=10``): the same cycles
    and the same observes, so the difference is the engine's own."""
    K = ENGINE["cycles_per_dispatch"]
    timings = {}
    for name, topo in topos.items():
        t0 = time.perf_counter()
        drv = _set_up(topo, dev, _engine_cfg())
        print(f"[engine-timing] {name}: engine set-up (partition, tables, "
              f"state) {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
        _halo_line(name, drv._eng, drv.extra)
        _check_engine_kernels(name, drv._eng, drv._st)
        timings[name] = _time_from(f"engine {name}", drv, topo, cycles[name],
                                   1)
        _time_from(f"core {name} check_every={K}", _set_up(topo, dev), topo,
                   cycles[name], K)
    return timings


def phase_engine_parity(dev, grid):
    """The compact wire against the exact one at 80,000 peers; the kernels
    against the reference formulas through the engine at 4,096."""
    spec = sim.ProblemSpec(n=grid.n)
    runs = [sim.run_static(grid, spec, max_cycles=MAX_CYCLES,
                           engine=_engine_cfg(wire=w), device=dev)
            for w in ("exact", "compact")]
    diffs = _diffs(runs[1], runs[0], RESULT_KEYS + ("cut_edges",))
    if diffs:
        raise AssertionError(f"compact wire: (compact, exact) {diffs}")
    print(f"[engine-parity] grid n={grid.n}: compact wire equal to exact",
          flush=True)
    side = int(round(N_SMALL ** 0.5))
    for name, topo in (("grid", topology.grid(side * side)),
                       ("ba", topology.barabasi_albert(N_SMALL, m=2,
                                                       seed=1))):
        spec = sim.ProblemSpec(n=topo.n)
        fused, plain = (sim.run_static(topo, spec, max_cycles=MAX_CYCLES,
                                       engine=_engine_cfg(use_kernels=u),
                                       device=dev)
                        for u in (True, False))
        if fused != plain:
            raise AssertionError(f"engine {name}: fused {fused} != "
                                 f"reference {plain}")
        print(f"[engine-parity] {name} n={topo.n}: fused equal to reference"
              f" (quiesced_at={fused['quiesced_at']}, total_msgs="
              f"{fused['total_msgs']!r})", flush=True)


def phase_sweep(dev, chord):
    """``sweep_static`` on Chord at 80,000 peers against sequential runs;
    returns the sweep's launch counts."""
    t0 = time.perf_counter()
    res, counts = _counted_run(
        "sweep", engine_sweep.sweep_static, topo=chord,
        spec=sim.ProblemSpec(n=chord.n), seeds=SWEEP_SEEDS,
        cycles=SWEEP_CYCLES, device=dev)
    wall = time.perf_counter() - t0
    for i, seed in enumerate(SWEEP_SEEDS):
        seq = sim.run_static(chord, sim.ProblemSpec(n=chord.n, seed=seed),
                             max_cycles=SWEEP_CYCLES, device=dev)
        got = (float(res["accuracy"][i, -1]), float(res["msgs"][i, -1]))
        if got != (seq["final_accuracy"], seq["total_msgs"]):
            raise AssertionError(f"sweep seed {seed}: (accuracy, msgs) "
                                 f"{got} != sequential {seq}")
        q = seq["quiesced_at"]
        if q is not None and not res["quiescent"][i, q - 1]:
            raise AssertionError(f"sweep seed {seed}: not quiescent at {q}")
    print(f"[sweep] chord n={chord.n} seeds={list(SWEEP_SEEDS)} "
          f"{SWEEP_CYCLES} cycles in {wall * 1e3:.1f} ms (set-up included):"
          f" final accuracy {res['accuracy'][:, -1].tolist()} msgs "
          f"{res['msgs'][:, -1].tolist()}, equal to sequential runs; "
          f"counts={counts}", flush=True)
    return counts


# --- phase 9: the async ring and the quantized wires ---------------------


STALENESS = 2  # tests/test_async_engine.py's budget
QUANT_WIRES = ("int8", "bf16")
BITWISE_CYCLES = 20


def _engine_run(label, topo, dev, **kw):
    """``run_static``'s engine route with ``EngineConfig(**ENGINE, **kw)``:
    set up once (timed apart), then its loop run once from a copy of the
    initial state, counters zeroed before it and read after it.  Returns
    (driver, initial state, result, counts)."""
    t0 = time.perf_counter()
    drv = _set_up(topo, dev, _engine_cfg(**kw))
    setup_ms = (time.perf_counter() - t0) * 1e3
    st0 = drv._st
    drv._st = _replay_state(st0)
    res, counts = _counted_run(label, lambda: sim._run_to_quiescence(
        drv, topo, MAX_CYCLES, 1))
    print(f"[async-quant] {label}: set-up {setup_ms:.1f} ms; cycles_95="
          f"{res['cycles_95']} cycles_100={res['cycles_100']} quiesced_at="
          f"{res['quiesced_at']} msgs_per_link={res['msgs_per_link']!r} "
          f"final_accuracy={res['final_accuracy']!r} counts={counts}",
          flush=True)
    return drv, st0, res, counts


def _beside(res, sync):
    keys = ("cycles_95", "cycles_100", "quiesced_at", "msgs_per_link")
    return ", ".join(f"{k} {res[k]!r} (sync {sync[k]!r})" for k in keys)


def _check_async0_bitwise(grid, dev):
    """Staleness 0 against the sync engine on grid, every ShardedState
    field (and the drop generators) after the same cycles, lossless and
    under loss."""
    from repro_torch.engine import ShardedLSS, ShardedState

    centers, _, _, inputs = sim._setup(grid, sim.ProblemSpec(n=grid.n), dev)
    for drop in (0.0, 0.1):
        cfg = lss.LSSConfig(drop_rate=drop)
        sync, asyn = (ShardedLSS(grid, centers, cfg, _engine_cfg(**kw),
                                 device=dev)
                      for kw in ({}, {"async_mode": True}))
        s = sync.run(sync.init(inputs, seed=0), BITWISE_CYCLES)
        a = asyn.run(asyn.init(inputs, seed=0), BITWISE_CYCLES).sync
        for name in ShardedState._fields:
            x, y = getattr(s, name), getattr(a, name)
            same = (all(torch.equal(g.get_state(), h.get_state())
                        for g, h in zip(x, y)) if name == "rng"
                    else (x is None and y is None) or torch.equal(x, y))
            if not same:
                raise AssertionError(f"async-0 grid drop {drop}: {name} "
                                     "differs from the sync engine")
        print(f"[async-quant] grid n={grid.n} drop_rate={drop}: async "
              f"staleness 0 bitwise equal to the sync engine on every "
              f"ShardedState field after {BITWISE_CYCLES} cycles "
              f"(msgs {int(sync.total_msgs(s))})", flush=True)


def _timing_line(name, rows):
    for label, t in rows:
        events = "not measured" if t["events"] is None else \
            f"{t['events']:.2f}"
        idle = "not measured" if t["idle"] is None else f"{t['idle']:.3f}"
        print(f"[async-quant-timing] {name} {label}: us_per_cycle median "
              f"{t['median']:.1f} (min {t['min']:.1f} max {t['max']:.1f}); "
              f"device events per cycle {events}; idle share {idle}",
              flush=True)


def phase_async_quantized(topos, dev, sync_results, sync_timings):
    """The async ring and the quantized wires through ``run_static``'s
    engine route at 80,000 peers; returns the launch totals of the two
    paths."""
    totals = {path: {key: 0 for key in KERNELS}
              for path in ("engine_async", "engine_quantized")}

    def add(path, counts):
        for key in KERNELS:
            totals[path][key] += counts[key]

    for name, topo in topos.items():
        sync = sync_results[name]
        rows = [("exact sync", sync_timings[name])]
        # (a) staleness 0 is the sync engine.
        _, _, res, counts = _engine_run(f"async-0 {name}", topo, dev,
                                        async_mode=True)
        add("engine_async", counts)
        diffs = _diffs(res, sync)
        if diffs:
            raise AssertionError(f"async-0 {name}: (async, sync) {diffs}")
        print(f"[async-quant] async-0 {name}: equal to phase 8's sync "
              "engine on every result key", flush=True)
        # (b) staleness 2: bounded-stale reads, the sequence guard.
        label = f"async-{STALENESS} {name}"
        drv, st0, res, counts = _engine_run(label, topo, dev,
                                            async_mode=True,
                                            staleness=STALENESS)
        add("engine_async", counts)
        lag = drv._eng.async_lag_stats(drv._st)
        print(f"[async-quant] {label}: {_beside(res, sync)}; final_accuracy "
              f"{res['final_accuracy']!r}; async_lag_stats {lag}",
              flush=True)
        if not (res["quiescent"] and res["cycles_95"] is not None
                and lag["applied"] > 0
                and 0.0 < lag["mean_delay"] <= STALENESS):
            raise AssertionError(f"{label}: {res} {lag}")
        if name == "grid" and res["final_accuracy"] != 1.0:
            raise AssertionError(f"{label}: accuracy {res}")
        _check_engine_kernels(label, drv._eng, st0)
        drv._st = st0
        rows.append((f"async staleness {STALENESS}",
                     _time_from(f"engine {label}", drv, topo,
                                res["quiesced_at"] or MAX_CYCLES, 1)))
        # (c) the quantized wires, sync.
        for wire in QUANT_WIRES:
            label = f"{wire} {name}"
            drv, st0, res, counts = _engine_run(label, topo, dev, wire=wire)
            add("engine_quantized", counts)
            eng, st = drv._eng, drv._st
            err = max(float(st.wire_err_m.abs().max()),
                      float(st.wire_err_c.abs().max()))
            compact = int(exchange.get_wire("compact").pair_bytes(
                eng._pair_counts, eng._wire_w, 2).sum())
            exact = int(exchange.get_wire("exact").pair_bytes(
                eng._pair_counts, eng.stopo.halo_width, 2).sum())
            print(f"[async-quant] {label}: {_beside(res, sync)}; modeled "
                  f"halo bytes per cycle {int(eng.wire_pair_bytes(2).sum())}"
                  f" (compact {compact}, exact {exact}); max|wire_err| "
                  f"{err!r}", flush=True)
            if not (res["final_accuracy"] == sync["final_accuracy"] == 1.0
                    and res["quiescent"] and err > 0.0):
                raise AssertionError(f"{label}: {res} max|err| {err}")
            if wire == "int8":
                _check_engine_kernels(label, eng, st0)
                drv._st = st0
                rows.append(("int8 sync", _time_from(
                    f"engine {label}", drv, topo,
                    res["quiesced_at"] or MAX_CYCLES, 1)))
        _timing_line(name, rows)
    # (d) int8 under bounded staleness.
    grid = topos["grid"]
    _, _, res, counts = _engine_run(f"int8 async-{STALENESS} grid", grid,
                                    dev, wire="int8", async_mode=True,
                                    staleness=STALENESS)
    add("engine_quantized", counts)
    if res["final_accuracy"] != 1.0 or not res["quiescent"]:
        raise AssertionError(f"int8 async-{STALENESS} grid: {res}")
    _check_async0_bitwise(grid, dev)
    return totals


# --- phase 10: the service under membership churn ------------------------


CHURN_Q = 16  # benchmarks/membership_churn.py::_bench_serve at full size
CHURN_K = 8
CHURN_DISPATCHES = 12  # timed, after one untimed dispatch
CHURN_RATES = (0, 8, 128)  # membership events queued a dispatch
CHURN_SPARE = 0.2  # _bench_serve's spare rows
REGROW_SPARE = 150  # rows past the grid, so joins hit the wall mid-serve


class _EventGen:
    """``benchmarks/membership_churn.py::_EventGen`` on the port's service:
    seeded join+link / leave / rewire events, with books of the present
    peers and edges kept incrementally (no topology scan per event).  It
    reads the service's current topology, which a regrow epoch replaces.
    ``ops`` is the mix it draws from: 0 join+link, 1 leave, 2 unlink
    (the benchmark's three), 3 link two present peers."""

    def __init__(self, svc, seed, ops=(0, 1, 2)):
        dyn = svc.topo
        self.rng = np.random.default_rng(seed)
        self.ops = ops
        self.present = [int(p) for p in np.flatnonzero(dyn.present)]
        self.pos = {p: i for i, p in enumerate(self.present)}
        ii, kk = np.nonzero(dyn.mask)
        jj = dyn.nbr[ii, kk]
        keep = ii < jj
        self.edges = list(zip(ii[keep].tolist(), jj[keep].tolist()))
        self.eidx = {e: i for i, e in enumerate(self.edges)}

    def _drop_present(self, p):
        i = self.pos.pop(p)
        last = self.present.pop()
        if last != p:
            self.present[i] = last
            self.pos[last] = i

    def _drop_edge(self, key):
        i = self.eidx.pop(key)
        last = self.edges.pop()
        if last != key:
            self.edges[i] = last
            self.eidx[last] = i

    def _add_edge(self, i, j):
        key = (min(i, j), max(i, j))
        if key not in self.eidx:
            self.eidx[key] = len(self.edges)
            self.edges.append(key)

    def _pick(self):
        return self.present[self.rng.integers(len(self.present))]

    def emit(self, svc) -> bool:
        """Queue one event through the service; True when it was taken."""
        op = self.ops[self.rng.integers(len(self.ops))]
        try:
            if op == 0:
                p = int(svc.join_peer())
                partner = self._pick()
                svc.link_peers(p, partner)
                self.present.append(p)
                self.pos[p] = len(self.present) - 1
                self._add_edge(p, partner)
            elif op == 1:
                p = self._pick()
                dyn = svc.topo
                nbrs = [int(j) for j in dyn.nbr[p][dyn.mask[p]]]
                svc.leave_peer(p)
                self._drop_present(p)
                for j in nbrs:
                    key = (min(p, j), max(p, j))
                    if key in self.eidx:
                        self._drop_edge(key)
            elif op == 2:
                if not self.edges:
                    return False
                key = self.edges[self.rng.integers(len(self.edges))]
                svc.unlink_peers(*key)
                self._drop_edge(key)
            else:
                i, j = self._pick(), self._pick()
                svc.link_peers(i, j)
                self._add_edge(i, j)
        except (ValueError, RuntimeError):
            return False
        return True


def _churn_specs(n_rows, n_pad, q):
    """``_bench_serve``'s Q Voronoi tenants (the Sec.-VI problem, tenant i
    seeded i) over ``n_rows`` peers, padded with zero-weight rows up to
    ``n_pad`` (what a service provisioned large holds for the same
    tenants)."""
    centers, sample, _, _ = sim.make_problem(sim.ProblemSpec(n=n_rows,
                                                             seed=0))
    rng = np.random.default_rng(1)
    specs = []
    for i in range(q):
        x = np.zeros((n_pad, 2), np.float32)
        x[:n_rows] = sample(rng, n_rows)
        w = np.zeros((n_pad,), np.float32)
        w[:n_rows] = 1.0
        specs.append(service.QuerySpec(
            region=regions.VoronoiRegions(centers),
            inputs=x, weights=w, seed=i))
    return specs


def _churn_service(base, n_cap, specs, dev, use_kernels=None,
                   auto_regrow=False, tracker=None, **cfg):
    """The churn workload's service (``cfg``: further ``ServiceConfig``
    fields, the engine backend's in phase 11, ``overlap`` in phase 12)."""
    dyn = topology.DynTopology.from_topology(base, n_cap=n_cap,
                                             deg_cap=base.max_deg + 2)
    svc = service.Service(dyn, service.ServiceConfig(
        capacity=len(specs), k_max=3, d=2, cycles_per_dispatch=CHURN_K,
        use_kernels=use_kernels,
        control=service.ControlPlaneConfig(auto_regrow=auto_regrow), **cfg),
        tracker=tracker, device=dev)
    for spec in specs:
        svc.admit(spec)
    return svc


def _churn_run(svc, rate, dispatches, seed=2, ops=(0, 1, 2), timed=False,
               hook=None):
    """One untimed dispatch, then ``dispatches`` ticks with ``rate``
    events queued before each (``hook(svc, i)`` runs before the events of
    dispatch i).  Returns (records per tick, wall s per tick, events the
    generator queued)."""
    svc.tick()
    gen = _EventGen(svc, seed, ops)
    records, walls, queued = [], [], 0
    for i in range(dispatches):
        if hook is not None:
            hook(svc, i)
        for _ in range(rate):
            queued += gen.emit(svc)
        if timed:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        records.append(svc.tick())
        if timed:
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return records, walls, queued, gen


def _spans(svc, name):
    return [r["seconds"] for r in svc.tracker.records
            if r.get("kind") == "span" and r["name"] == name]


def _check_service_kernels(label, svc, timed=False):
    """The three kernels' wrappers on the churned service's own stacked
    (Q, n_cap, D) state (dead spare rows, masks with holes, D after any
    regrow), bitwise against their plain versions: ``lss_state`` and
    ``correction`` (V = every live slot) with the dispatch's slot tables
    and per-slot eps and beta, the global decision as the observe calls
    it.  With ``timed``, each wrapper and plain version is timed by CUDA
    events beside its bound."""
    params = svc.registry.params
    tables = svc.backend.tables(params)
    st, eps, beta = svc.states, params.eps, params.beta
    rows, topo = "n_cap", getattr(svc.backend, "ta", None)
    if topo is None:  # the engine backend: its flat (Q, S*B, D) rows
        eng = svc.backend.eng
        st, topo, rows = eng._flat_state(st), eng._flat_topo, "S*B"
    live = lss._live_mask(topo, st.alive)
    args = (st.x_m, st.x_c, st.out_m, st.out_c, st.in_m, st.in_c, live)
    state = ops.lss_state(*args, tables, eps=eps)
    s_m, s_c, _, _ = state
    cargs = (s_m, s_c, st.out_m + st.in_m, st.out_c + st.in_c, st.in_m,
             st.in_c, live)
    gargs = (st.x_m, st.x_c, st.alive)
    calls = {
        "lss_state": (lambda: ops.lss_state(*args, tables, eps=eps),
                      lambda: ref.lss_state_ref(*args, tables.regions, eps)),
        "correction": (lambda: ops.correction(*cargs, beta=beta, eps=eps),
                       lambda: ref.correction_ref(*cargs, beta, eps)),
        "region_decide": (
            lambda: ops.global_decision(*gargs, tables, eps),
            lambda: ref.global_decision_ref(*gargs, tables.regions, eps))}
    checks = [(k, state if k == "lss_state" else fused(), plain())
              for k, (fused, plain) in calls.items()]
    torch.cuda.synchronize()
    for kname, got, want in checks:
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"{label}: {kname} differs from its plain version on "
                    f"the churned service's state in "
                    f"{int((g != w).sum())} values")
    q, n, D = live.shape
    print(f"[churn-kernels] {label}: lss_state, correction and the global "
          f"decision bitwise equal to their plain versions on the "
          f"service's state Q={q} {rows}={n} D={D} ({int(st.alive.sum())} "
          f"of {q * n} rows alive; V: all {int(live.sum())} live slots)",
          flush=True)
    if not timed:
        return
    k = tables.cn.shape[-1]
    bounds = {"lss_state": _bound_ms(*_lss_state_cost(args, k)),
              "correction": _bound_ms(*_correction_cost(cargs, live)),
              "region_decide": _bound_ms(*_global_cost(q, n, s_m.shape[-1],
                                                       k),
                                         ops_per_s=F64_OPS_PER_S)}
    for kname, (fused, plain) in calls.items():
        ms = _time_ms(fused, 10)
        print(f"[churn-kernels] {label} {kname}: {ms:.4f} ms a call by "
              f"events (plain {_time_ms(plain, 3):.4f} ms; bound "
              f"{bounds[kname][0]:.4f} ms by {bounds[kname][1]}; share "
              f"{_fmt_share(bounds[kname], ms)})", flush=True)


def phase_churn(topos, dev, gpu):
    """The service on a ``DynTopology`` at the paper's size under 0, 8 and
    128 membership events a dispatch (``_bench_serve``'s workload), the
    launch counters zeroed just before each run and read just after; the
    regrow run against a service provisioned large; the fused suite
    against the reference suite on the same churn at 4,096 peers.
    Returns the launch totals of the churn runs and each run's records and
    numbers by label (phase 11 holds the engine backend to them)."""
    from torch.profiler import ProfilerActivity, profile

    totals = {key: 0 for key in KERNELS}
    runs = {}
    for name in SERVICE_TOPOS:
        base = topos[name]
        n_cap = base.n + max(4, int(base.n * CHURN_SPARE))
        specs = _churn_specs(n_cap, n_cap, CHURN_Q)
        for rate in CHURN_RATES:
            label = f"{name} rate={rate}"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_counts()
            svc = _churn_service(base, n_cap, specs, dev)
            records, walls, queued, gen = _churn_run(
                svc, rate, CHURN_DISPATCHES, timed=True)
            for _ in range(rate):
                gen.emit(svc)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                svc.tick()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = kernels.counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if any(counts[f"{k}_ref"] for k in totals):
                raise AssertionError(f"{label}: a plain version ran")
            for key in totals:
                if counts[key] <= 0:
                    raise AssertionError(f"{label}: launched no {key}")
                totals[key] += counts[key]
            _check_records(label, records, CHURN_Q)
            us = [w / CHURN_K * 1e6 for w in walls]
            drain = _spans(svc, "membership_drain")[-CHURN_DISPATCHES - 1:-1]
            applied = [c.get("boundary", {}).get("membership_events", 0)
                       for c in svc.telemetry.controls()]
            if rate and not (svc.topo_version > 0 and sum(applied) > 0):
                raise AssertionError(f"{label}: no membership event applied")
            ticks = CHURN_DISPATCHES + 2
            print(f"[churn] {label} n_cap={n_cap} D={svc.topo.max_deg} "
                  f"Q={CHURN_Q} K={CHURN_K}: us_per_cycle median "
                  f"{np.median(us):.1f} (min {min(us):.1f} max "
                  f"{max(us):.1f}) over {len(us)} dispatches; "
                  f"membership_drain ms per dispatch median "
                  f"{np.median(drain) * 1e3:.3f} (max "
                  f"{max(drain) * 1e3:.3f}); events queued "
                  f"{queued / CHURN_DISPATCHES:.2f} and topology events "
                  f"applied {sum(applied) / (CHURN_DISPATCHES + 1):.2f} a "
                  f"dispatch (version {svc.topo_version}, "
                  f"{svc.topo.num_present} present); launches per dispatch "
                  f"{ {k: counts[k] / ticks for k in totals} }; peak "
                  f"memory {peak:.3f} GiB; last dispatch accuracy min "
                  f"{min(r['accuracy'] for r in records[-1]):.4f}; {gpu}",
                  flush=True)
            stats = _print_profile(f"churn {label}", prof, wall * 1e3,
                                   float(np.median(walls)) * 1e3, 1,
                                   "dispatch")
            if stats is not None:
                print(f"[churn] {label}: device events per dispatch "
                      f"{stats['events']:.1f}, idle share "
                      f"{stats['idle']:.3f}", flush=True)
            _check_service_kernels(label, svc, timed=rate == CHURN_RATES[-1])
            runs[label] = {"records": records, "us": float(np.median(us)),
                           "drain_ms": float(np.median(drain)) * 1e3,
                           "counts": {k: counts[k] for k in totals},
                           "peak": peak, "stats": stats}
            del svc, prof
            torch.cuda.empty_cache()
        _time_refresh(name, base, n_cap, dev)
    _check_churn_regrow(topos["grid"], dev)
    _check_churn_suites(dev)
    return totals, runs


def _time_refresh(name, base, n_cap, dev, reps=5):
    """The boundary's table refresh alone: the three topology tables
    copied to the card anew (``refresh_topology``), synchronized, host
    clock, median of ``reps``."""
    dyn = topology.DynTopology.from_topology(base, n_cap=n_cap,
                                             deg_cap=base.max_deg + 2)
    mb = (dyn.nbr.nbytes + dyn.mask.nbytes + dyn.rev.nbytes) / 1e6
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lss.TopoArrays.from_topology(dyn, dev)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[churn] {name}: table refresh ({mb:.1f} MB of nbr, mask and "
          f"rev to the card) median {np.median(ms):.3f} ms (min "
          f"{min(ms):.3f} max {max(ms):.3f}) over {reps}", flush=True)


def _check_churn_regrow(base, dev):
    """tests/test_controlplane.py::test_auto_regrow_midserve_cycle_exact
    at the card's size: joins past ``n_cap`` mid-serve (an auto-regrow
    epoch) give, dispatch by dispatch, the records of a service
    provisioned large from the start: msgs and quiescent exact, accuracy
    within 1e-7."""
    n1 = base.n + REGROW_SPARE
    n2 = base.n + int(base.n * CHURN_SPARE)
    runs = []
    for n_cap in (n1, n2):
        svc = _churn_service(base, n_cap, _churn_specs(n1, n_cap, CHURN_Q),
                             dev, auto_regrow=True)
        records = _churn_run(svc, 64, 6, ops=(0,))[0]
        _check_service_kernels(f"regrow run n_cap={n_cap}->"
                               f"{svc.topo.n_cap}", svc)
        runs.append((records, svc.topo.n_cap,
                     [e["kind"] for e in svc.capman.epochs]))
        del svc
    (small, cap1, epochs1), (large, cap2, epochs2) = runs
    if "regrow" not in epochs1 or cap1 <= n1 or cap2 != n2:
        raise AssertionError(f"regrow run: epochs {epochs1} / {epochs2}, "
                             f"n_cap {cap1} / {cap2}")
    for i, (ra, rb) in enumerate(zip(small, large)):
        for a, b in zip(ra, rb):
            if (a["msgs"], a["quiescent"]) != (b["msgs"], b["quiescent"]) \
                    or abs(a["accuracy"] - b["accuracy"]) > 1e-7:
                raise AssertionError(f"regrow run dispatch {i}: {a} != {b}")
    print(f"[churn-regrow] grid n={base.n}: n_cap {n1} grew to {cap1} "
          f"mid-serve (64 joins a dispatch; epochs {epochs1}, the large "
          f"service's {epochs2}); its records equal those of a "
          f"service provisioned at {n2} over {len(small)} dispatches "
          f"({sum(len(r) for r in small)} records; msgs and quiescent "
          f"exact, accuracy within 1e-7)", flush=True)
    torch.cuda.empty_cache()


def _check_churn_suites(dev, tag="churn-parity", **cfg):
    """The fused suite against the reference suite at phase 7's size
    (grid 4,096, Q = 8), on the same seeded churn of all four event kinds,
    through an auto-regrow of the rows and a ``grow_capacity`` of the
    degree slots: identical records (``cfg``: further ``ServiceConfig``
    fields, the engine backend's in phase 11)."""
    side = int(round(N_SMALL ** 0.5))
    base = topology.grid(side * side)
    n_cap = base.n + 8
    specs = _churn_specs(n_cap, n_cap, 8)

    def grow(svc, i):
        if i == 3:
            svc.grow_capacity(deg_cap=svc.topo.deg_cap + 4)

    runs = []
    for use_kernels in (True, False):
        svc = _churn_service(base, n_cap, specs, dev, use_kernels,
                             auto_regrow=True, **cfg)
        records = _churn_run(svc, 16, 6, ops=(0, 0, 1, 2, 3), hook=grow)[0]
        if use_kernels:
            _check_service_kernels(f"{tag}: suite parity, grown", svc)
        runs.append((records, [e["kind"] for e in svc.capman.epochs],
                     svc.topo.n_cap, svc.topo.deg_cap))
    (fused, epochs, cap, deg), plain = runs
    if "regrow" not in epochs[1:] or len(epochs) < 3:
        raise AssertionError(f"suite parity: epochs {epochs}")
    if runs[0] != plain:
        diff = [(i, a, b) for i, (ra, rb) in enumerate(zip(fused, plain[0]))
                for a, b in zip(ra, rb) if a != b]
        raise AssertionError(f"churn: fused != reference: {diff[:4]}")
    print(f"[{tag}] grid n={base.n} Q=8: fused-suite and "
          f"reference-suite services gave identical records over "
          f"{len(fused)} churned dispatches ({sum(len(r) for r in fused)} "
          f"records; epochs {epochs}, n_cap {n_cap} -> {cap}, deg_cap "
          f"{base.max_deg + 2} -> {deg})", flush=True)


# --- phase 11: the service on the sharded engine backend -----------------


ENGINE_SERVICE = dict(backend="engine", engine_shards=ENGINE["num_shards"],
                      engine_method="bfs", engine_wire="exact")
ENGINE_RATES = (0, 128)  # phase 10's rates without and with heavy churn
REBALANCE_AT = 6  # the forced rebalance follows the 6th timed dispatch


def _same_records(label, got, want):
    """Dispatch by dispatch, record by record: msgs, quiescent and region
    exact, accuracy within 1e-7."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} dispatches != "
                             f"{len(want)}")
    for i, (ga, wa) in enumerate(zip(got, want)):
        if len(ga) != len(wa):
            raise AssertionError(f"{label} dispatch {i}: {len(ga)} records")
        for a, b in zip(ga, wa):
            if ((a["query"], a["msgs"], a["quiescent"], a["region"])
                    != (b["query"], b["msgs"], b["quiescent"], b["region"])
                    or abs(a["accuracy"] - b["accuracy"]) > 1e-7):
                raise AssertionError(f"{label} dispatch {i}: {a} != {b}")
    return sum(len(r) for r in got)


def phase_service_engine(topos, dev, gpu, core_runs):
    """Phase 10's churn workload on the engine backend (8 shards, BFS,
    exact wire): the launch counters zeroed just before each run and read
    just after, records held to phase 10's core-backed runs dispatch by
    dispatch, one forced rebalance epoch in the 128-event run, one
    profiled dispatch, the kernels held bitwise on the service's flat
    state; then fused against reference at 4,096 under churn through a
    regrow.  Returns the launch totals of the runs."""
    from torch.profiler import ProfilerActivity, profile

    totals = {key: 0 for key in KERNELS}
    for name in SERVICE_TOPOS:
        base = topos[name]
        n_cap = base.n + max(4, int(base.n * CHURN_SPARE))
        specs = _churn_specs(n_cap, n_cap, CHURN_Q)
        for rate in ENGINE_RATES:
            label = f"{name} rate={rate}"
            core = core_runs[label]
            epoch = {}

            def rebalance(svc, i, rate=rate, epoch=epoch):
                if rate and i == REBALANCE_AT:
                    before = svc.backend.cut_frac()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ev = svc.rebalance_now()
                    torch.cuda.synchronize()
                    epoch.update(ev, ms=(time.perf_counter() - t0) * 1e3,
                                 before=before, after=svc.backend.cut_frac())

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            svc = _churn_service(base, n_cap, specs, dev, **ENGINE_SERVICE)
            setup = time.perf_counter() - t0
            kernels.reset_counts()
            records, walls, queued, gen = _churn_run(
                svc, rate, CHURN_DISPATCHES, timed=True, hook=rebalance)
            for _ in range(rate):
                gen.emit(svc)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                svc.tick()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = kernels.counts()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if any(counts[f"{k}_ref"] for k in totals):
                raise AssertionError(f"engine {label}: a plain version ran")
            for key in totals:
                if counts[key] <= 0:
                    raise AssertionError(f"engine {label}: launched no {key}")
                totals[key] += counts[key]
            _check_records(f"engine {label}", records, CHURN_Q)
            n_rec = _same_records(f"engine {label} vs phase 10", records,
                                  core["records"])
            # One launch a step for all Q tenants: the core's count.
            if {k: counts[k] for k in totals} != core["counts"]:
                raise AssertionError(
                    f"engine {label}: launches {counts} != the core "
                    f"backend's {core['counts']}")
            if rate and epoch.get("kind") != "rebalance":
                raise AssertionError(f"engine {label}: no rebalance epoch")
            us = [w / CHURN_K * 1e6 for w in walls]
            drain = _spans(svc, "membership_drain")[-CHURN_DISPATCHES - 1:-1]
            ticks = CHURN_DISPATCHES + 2
            eng = svc.backend.eng
            st = (core["stats"] or {})
            print(f"[service-engine] {label} n_cap={n_cap} S={eng.S} "
                  f"B={eng.B} D={eng.D} halo width "
                  f"{eng.stopo.halo_width} Q={CHURN_Q} K={CHURN_K} (set-up "
                  f"{setup:.2f} s): us_per_cycle median "
                  f"{np.median(us):.1f} (min {min(us):.1f} max "
                  f"{max(us):.1f}; core, phase 10: {core['us']:.1f}); "
                  f"membership_drain ms per dispatch median "
                  f"{np.median(drain) * 1e3:.3f} (max "
                  f"{max(drain) * 1e3:.3f}; core {core['drain_ms']:.3f}); "
                  f"events queued {queued / CHURN_DISPATCHES:.2f} a "
                  f"dispatch; launches per dispatch "
                  f"{ {k: counts[k] / ticks for k in totals} } (equal to "
                  f"the core's); peak memory {peak:.3f} GiB (core "
                  f"{core['peak']:.3f}); records equal to phase 10's over "
                  f"{len(records)} dispatches ({n_rec} records); {gpu}",
                  flush=True)
            if rate:
                print(f"[service-engine] {label}: forced rebalance after "
                      f"timed dispatch {REBALANCE_AT}: cut fraction "
                      f"{epoch['before']:.6f} -> {epoch['after']:.6f} "
                      f"(drift {epoch['drift']:.6f}), epoch "
                      f"{epoch['ms']:.1f} ms; records still equal to the "
                      f"core's", flush=True)
            stats = _print_profile(f"service-engine {label}", prof,
                                   wall * 1e3, float(np.median(walls)) * 1e3,
                                   1, "dispatch")
            if stats is not None:
                print(f"[service-engine] {label}: device events per "
                      f"dispatch {stats['events']:.1f} (core "
                      f"{st.get('events', float('nan')):.1f}), idle share "
                      f"{stats['idle']:.3f} (core "
                      f"{st.get('idle', float('nan')):.3f})", flush=True)
            _check_service_kernels(f"engine {label}", svc,
                                   timed=rate == ENGINE_RATES[-1])
            del svc, prof
            torch.cuda.empty_cache()
    _check_churn_suites(dev, "service-engine-parity", **ENGINE_SERVICE)
    return totals


# --- phase 12: the overlapped service boundary -----------------------------


OVERLAP_RATE = 128  # phase 10's heavy churn
OVERLAP_ROUNDS = 2  # interleaved rounds: a sync chunk, then an overlap chunk
OVERLAP_PER_ROUND = CHURN_DISPATCHES // OVERLAP_ROUNDS
OVERLAP_PROFILED = 2  # dispatches under torch.profiler, each mode


def _in_flight(tracker, skip):
    """``benchmarks/async_overlap.py::_in_flight``: the in-flight interval
    of each window, from the end of its ``dispatch`` span (the K cycles
    enqueued) to the end of its ``observe`` span (the records on the
    host), merged; ``skip`` drops the warm-up window."""
    enq = [s._t0 + s.seconds for s in tracker.spans_named("dispatch")][skip:]
    syn = [s._t0 + s.seconds for s in tracker.spans_named("observe")][skip:]
    merged = []
    for lo, hi in sorted(zip(enq, syn)):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return merged


def _bubble_frac(chunks, intervals):
    """``benchmarks/async_overlap.py::_bubble_frac``: the share of the
    timed chunks that no in-flight window covers."""
    covered = 0.0
    for lo, hi in intervals:
        for c0, c1 in chunks:
            covered += max(0.0, min(hi, c1) - max(lo, c0))
    total = sum(c1 - c0 for c0, c1 in chunks)
    return max(0.0, total - covered) / total


def _by_dispatch(records):
    """Records grouped per dispatch, in dispatch order."""
    out = {}
    for r in records:
        out.setdefault(r["dispatch"], []).append(r)
    return [out[k] for k in sorted(out)]


def _span_ms(svc, name, attr=None):
    """Milliseconds of each ``name`` span (or of its ``attr``)."""
    return [1e3 * (s.attrs[attr] if attr else s.seconds)
            for s in svc.tracker.spans_named(name)
            if attr is None or attr in s.attrs]


def _stage_rebalance(svc):
    """What ``_maybe_rebalance`` does when the drift check fires under
    overlap: the rebalance's partition build staged on a background
    thread, adopted by a later boundary once ready."""
    with svc._obs.span("epoch_stage", kind="rebalance"):
        svc._staged["rebalance"] = svc.backend.stage_rebalance(svc._dyn)


def _epoch_dispatch(svc, kind):
    """The dispatch whose control record carries the first ``kind``
    epoch (the first dispatch launched after it)."""
    return next(r["dispatch"] for r in svc.tracker.records
                if r.get("kind") == "control"
                and any(e["kind"] == kind for e in r.get("epochs", ())))


def _count_into(label, totals):
    counts = kernels.counts()
    if any(counts[f"{k}_ref"] for k in totals):
        raise AssertionError(f"{label}: a plain version ran")
    for key in totals:
        totals[key] += counts[key]


def _overlap_cell(label, base, dev, gpu, cfg, totals):
    """One backend on phase 10's workload at 128 events a dispatch, the
    synchronous and the overlapped service side by side: one untimed
    dispatch each, then ``OVERLAP_ROUNDS`` interleaved rounds of
    ``OVERLAP_PER_ROUND`` timed ticks (events emitted inside the timed
    chunk, the overlapped chunk ending when its last dispatch is back).
    On the engine the second round opens with a rebalance: in line in the
    synchronous service, staged in the overlapped one.  The launch
    counters are zeroed before each chunk and read after it; the
    overlapped chunks' counts go into ``totals``."""
    from torch.profiler import ProfilerActivity, profile

    n_cap = base.n + max(4, int(base.n * CHURN_SPARE))
    specs = _churn_specs(n_cap, n_cap, CHURN_Q)
    modes = {}
    for mode in ("sync", "overlap"):
        svc = _churn_service(base, n_cap, specs, dev,
                             tracker=obs.InMemoryTracker(),
                             overlap=mode == "overlap", **cfg)
        warm = svc.tick() + svc.flush()
        modes[mode] = {"svc": svc, "gen": _EventGen(svc, 2), "wall": 0.0,
                       "chunks": [], "records": warm,
                       "counts": {k: 0 for k in KERNELS}}
    engine = cfg.get("backend") == "engine"
    for rnd in range(OVERLAP_ROUNDS):
        for mode, m in modes.items():
            svc, gen = m["svc"], m["gen"]
            kernels.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if engine and rnd == 1:
                staged_at = svc.dispatches
                (_stage_rebalance if mode == "overlap"
                 else service.Service.rebalance_now)(svc)
            for _ in range(OVERLAP_PER_ROUND):
                for _ in range(OVERLAP_RATE):
                    gen.emit(svc)
                m["records"] += svc.tick()
            svc._join()  # the chunk's last dispatch is back
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _count_into(f"{label} {mode}", m["counts"])
            m["wall"] += t1 - t0
            m["chunks"].append((t0, t1))
    over = modes["overlap"]["svc"]
    if engine and "rebalance" in over._staged:
        # Not adopted within the timed rounds: wait for the build and
        # give both services one more (untimed) dispatch.
        over._staged["rebalance"][0].take()
        for mode, m in modes.items():
            kernels.reset_counts()
            for _ in range(OVERLAP_RATE):
                m["gen"].emit(m["svc"])
            m["records"] += m["svc"].tick()
            m["svc"]._join()
            _count_into(f"{label} {mode} adoption", m["counts"])
    ticks = OVERLAP_ROUNDS * OVERLAP_PER_ROUND
    stats = {}
    for mode, m in modes.items():
        svc = m["svc"]
        kernels.reset_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(OVERLAP_PROFILED):
                for _ in range(OVERLAP_RATE):
                    m["gen"].emit(svc)
                m["records"] += svc.tick()
            svc._join()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        _count_into(f"{label} {mode} profiled", m["counts"])
        m["records"] += svc.flush()
        stats[mode] = _print_profile(
            f"overlap {label} {mode}", prof, wall * 1e3,
            m["wall"] / ticks * 1e3 * OVERLAP_PROFILED, OVERLAP_PROFILED,
            "dispatch")
        m["frac"] = _bubble_frac(m["chunks"], _in_flight(svc.tracker, 1))
    sync, over_m = modes["sync"], modes["overlap"]
    n_rec = _same_records(f"{label} overlap vs sync",
                          _by_dispatch(over_m["records"]),
                          _by_dispatch(sync["records"]))
    if over_m["counts"] != sync["counts"]:
        raise AssertionError(f"{label}: launches {over_m['counts']} != the "
                             f"synchronous service's {sync['counts']}")
    if engine:
        staged = [e for e in over.capman.epochs if e["kind"] == "rebalance"]
        if [e["staged"] for e in staged] != [True]:
            raise AssertionError(f"{label}: rebalance epochs {staged}")
    for key in totals:
        if over_m["counts"][key] <= 0:
            raise AssertionError(f"{label}: overlap launched no {key}")
        totals[key] += over_m["counts"][key]
    tick_ms = {mode: m["wall"] / ticks * 1e3 for mode, m in modes.items()}
    frac_ratio = min(100.0, sync["frac"] / max(over_m["frac"],
                                               sync["frac"] / 100.0, 1e-9))
    wall_ratio = tick_ms["sync"] / tick_ms["overlap"]
    drains = {mode: _span_ms(m["svc"], "membership_drain")[1:]
              for mode, m in modes.items()}
    beside = _span_ms(over, "membership_drain", "prepare_s")[1:]
    steps = {mode: _span_ms(m["svc"], "dispatch")[1:]
             for mode, m in modes.items()}
    n_disp = over.dispatches - 1  # every counted dispatch
    print(f"[overlap] {label} n_cap={n_cap} Q={CHURN_Q} K={CHURN_K}, "
          f"{OVERLAP_RATE} events a dispatch, {OVERLAP_ROUNDS} interleaved "
          f"rounds of {OVERLAP_PER_ROUND} timed ticks: wall ms a tick sync "
          f"{tick_ms['sync']:.3f}, overlap {tick_ms['overlap']:.3f} "
          f"(wall_ratio {wall_ratio:.4f}); host_overhead_frac sync "
          f"{sync['frac']:.4f}, overlap {over_m['frac']:.4f} "
          f"(host_frac_ratio {frac_ratio:.4f}); membership_drain ms median "
          f"sync {np.median(drains['sync']):.3f}, overlap "
          f"{np.median(drains['overlap']):.3f} of which beside the "
          f"dispatch {np.median(beside):.3f}; dispatch span (its K cycles "
          f"enqueued) ms median sync {np.median(steps['sync']):.3f}, "
          f"overlap {np.median(steps['overlap']):.3f}; launches per dispatch "
          f"{ {k: over_m['counts'][k] / n_disp for k in KERNELS} } (equal "
          f"to the synchronous service's); records equal over "
          f"{len(_by_dispatch(over_m['records']))} dispatches ({n_rec} "
          f"records); {gpu}", flush=True)
    for mode in modes:
        st = stats[mode]
        if st is not None:
            print(f"[overlap] {label} {mode}: device events per dispatch "
                  f"{st['events']:.1f}, idle share {st['idle']:.3f}",
                  flush=True)
    if engine:
        print(f"[overlap] {label}: rebalance in line "
              f"{_span_ms(sync['svc'], 'epoch_rebalance')[0]:.3f} ms; "
              f"staged: epoch_stage {_span_ms(over, 'epoch_stage')[0]:.3f} "
              f"ms after dispatch {staged_at}, adopted in "
              f"{_span_ms(over, 'epoch_rebalance')[0]:.3f} ms by the "
              f"boundary of dispatch {_epoch_dispatch(over, 'rebalance')} "
              f"(staged: true; catch-up and migration)", flush=True)
    _check_service_kernels(f"overlap {label}", over)
    for m in modes.values():
        m["svc"].close()
    return {"tick_ms": tick_ms, "wall_ratio": wall_ratio,
            "frac": {mode: m["frac"] for mode, m in modes.items()},
            "frac_ratio": frac_ratio}


def _overlap_regrow(base, dev, gpu, totals):
    """Phase 10's regrow run (grid, ``REGROW_SPARE`` rows past the graph,
    64 joins a dispatch) on the engine backend, synchronous and
    overlapped: under overlap ``_maybe_stage_growth`` stages the grown
    partition at the first boundary and the regrow at the capacity wall
    adopts it, caught up from the journal (``staged: true``); the
    synchronous service rebuilds in line.  Records equal; the launch
    counters zeroed before the overlapped run and read after it."""
    n1 = base.n + REGROW_SPARE
    specs = _churn_specs(n1, n1, CHURN_Q)
    runs = {}
    for overlap in (False, True):
        svc = _churn_service(base, n1, specs, dev, auto_regrow=True,
                             tracker=obs.InMemoryTracker(), overlap=overlap,
                             **ENGINE_SERVICE)
        records = svc.tick()
        gen = _EventGen(svc, 2, (0,))
        kernels.reset_counts()
        for _ in range(6):
            for _ in range(64):
                gen.emit(svc)
            records += svc.tick()
        records += svc.flush()
        if overlap:
            _count_into("overlap regrow", totals)
            _check_service_kernels(f"overlap regrow run n_cap={n1}->"
                                   f"{svc.topo.n_cap}", svc)
        runs[overlap] = (svc, _by_dispatch(records))
    (sync, want), (over, got) = runs[False], runs[True]
    n_rec = _same_records("overlap regrow vs sync", got, want)
    epochs = [(e["kind"], e.get("staged")) for e in over.capman.epochs]
    in_line = [(e["kind"], e.get("staged")) for e in sync.capman.epochs]
    if (epochs[1] != ("regrow", True) or any(st for _, st in in_line)
            or [k for k, _ in epochs] != [k for k, _ in in_line]):
        raise AssertionError(f"overlap regrow: epochs {epochs}, in line "
                             f"{in_line}")
    print(f"[overlap-regrow] grid engine n_cap {n1} -> {over.topo.n_cap} "
          f"(64 joins a dispatch; epochs {epochs}): first regrow in line "
          f"{_span_ms(sync, 'epoch_regrow')[0]:.3f} ms; staged "
          f"(epoch_stage {_span_ms(over, 'epoch_stage')[0]:.3f} ms at the "
          f"first boundary) adopted with the journal's catch-up in "
          f"{_span_ms(over, 'epoch_regrow')[0]:.3f} ms (staged: true); "
          f"records equal over {len(got)} dispatches ({n_rec} records); "
          f"{gpu}", flush=True)
    sync.close()
    over.close()
    torch.cuda.empty_cache()


def phase_overlap(topos, dev, gpu):
    """The overlapped boundary (``ServiceConfig(overlap=True)``) beside the
    synchronous one on chord at 128 events a dispatch, on the core and
    the engine backend, and the staged regrow on grid.  Returns the
    overlapped runs' launch totals."""
    totals = {key: 0 for key in KERNELS}
    for label, cfg in (("core chord", {}),
                       ("engine chord", ENGINE_SERVICE)):
        _overlap_cell(label, topos["chord"], dev, gpu, cfg, totals)
        torch.cuda.empty_cache()
    _overlap_regrow(topos["grid"], dev, gpu, totals)
    return totals


# --- phase 13: the observability and audit plane ---------------------------


OBS_ROUNDS = 3  # timed dispatches a tracker, round-robin after one untimed
AUDIT_RATE = 128  # phase 10's heavy churn
AUDIT_VERDICT = ("dispatch", "t", "query", "slot", "ok", "violations",
                 "monitors", "quiescent", "claimed_quiescent", "edge_bad",
                 "edge_checked", "stop_bad", "msgs", "live_slots")
PROFILE_SAMPLE = 4  # profile_sample_every of the profiled service
PROFILE_TICKS = 8  # timed ticks of the profiled and unprofiled services


def _always_alert():
    return (obs.AlertRule(name="always", metric="service_queue_depth",
                          above=-1.0),)


def _observe_audit_ms(svc, reps=3):
    """The observe and the audit reductions alone on the service's state
    (CUDA events, ms a call): what an audited window adds to its
    dispatch, beside what every window pays."""
    params = svc.registry.params
    tables = svc.backend.tables(params)
    topo = svc.backend.topo_args()
    return (_time_ms(lambda: svc.backend.metrics(svc.states, params, tables,
                                                 topo), reps),
            _time_ms(lambda: svc.backend.audit(svc.states, params, tables,
                                               topo), reps))


def _obs_overhead(topo, dev, gpu):
    """``benchmarks/obs_overhead.py`` on phase 6's workload (64 tenants,
    K = 16): five services that differ only in their tracker and knobs,
    one untimed dispatch each, then ``OBS_ROUNDS`` round-robin timed
    dispatches.  Records must be equal across the five (msgs, quiescent
    and region exact, accuracy bitwise) and every audit clean."""
    import tempfile

    specs = service.heterogeneous_tenants(topo.n, Q_SERVICE)
    state_gb = (Q_SERVICE * topo.n * topo.max_deg * (2 * 2 + 2) * 4
                + Q_SERVICE * topo.n * topo.max_deg) / 1e9
    print(f"[obs-overhead] chord n={topo.n} D={topo.max_deg} Q={Q_SERVICE}: "
          f"message state {state_gb:.2f} GB a service, "
          f"{5 * state_gb:.2f} GB for five", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        prom = obs.PrometheusTextTracker()
        backends = [
            ("noop", obs.NoopTracker(), None, {}),
            ("jsonl", obs.JsonlTracker(str(Path(tmp) / "obs.jsonl")), None,
             {}),
            ("prom", prom, prom.expose, {}),
            ("traced", obs.InMemoryTracker(max_records=4096), None,
             dict(profile_dispatch=True, alerts=_always_alert())),
            ("audited", obs.InMemoryTracker(max_records=4096), None,
             dict(audit_every=1))]
        runs = {}
        for name, tracker, scrape, cfg in backends:
            svc = service.Service(topo, service.ServiceConfig(
                capacity=Q_SERVICE, k_max=3, d=2,
                cycles_per_dispatch=K_SERVICE, **cfg), tracker=tracker,
                device=dev)
            for spec in specs:
                svc.admit(spec)
            runs[name] = {"svc": svc, "scrape": scrape, "walls": [],
                          "records": [svc.tick()]}
        for _ in range(OBS_ROUNDS):
            for name, run in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run["records"].append(run["svc"].tick())
                if run["scrape"] is not None:
                    run["scrape"]()
                torch.cuda.synchronize()
                run["walls"].append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        observe_ms, audit_ms = _observe_audit_ms(runs["audited"]["svc"])
        for run in runs.values():
            run["svc"].close()
    want = runs["noop"]["records"]
    for name, run in runs.items():
        if run["records"] != want:
            raise AssertionError(f"obs-overhead {name}: records differ from "
                                 f"the noop tracker's")
    audits = [r for r in backends[4][1].records if r.get("kind") == "audit"]
    if len(audits) != (OBS_ROUNDS + 1) * Q_SERVICE or not all(
            r["ok"] for r in audits):
        raise AssertionError(f"obs-overhead audited: {len(audits)} audit "
                             f"records, failing "
                             f"{[r for r in audits if not r['ok']][:2]}")
    alerts = [r for r in backends[3][1].records if r.get("kind") == "alert"]
    floor = float(np.median(runs["noop"]["walls"]))
    parts = []
    for name, run in runs.items():
        med = float(np.median(run["walls"]))
        parts.append(f"{name} {med * 1e3:.3f} ms (min "
                     f"{min(run['walls']) * 1e3:.3f} max "
                     f"{max(run['walls']) * 1e3:.3f}) overhead_frac "
                     f"{max(0.0, (med - floor) / floor):.4f}")
    gauges = {g: backends[3][1].registry.gauge(g).value(backend="core")
              for g in ("dispatch_host_ms", "dispatch_device_ms",
                        "host_overhead_frac")}
    print(f"[obs-overhead] median dispatch wall over {OBS_ROUNDS} "
          f"round-robin dispatches a tracker: {'; '.join(parts)}; records "
          f"equal across the five over {OBS_ROUNDS + 1} dispatches; "
          f"{len(audits)} audit records, all ok (max residual/tol "
          f"{max(r['residual'] / r['tol'] for r in audits):.3e}); "
          f"{len(alerts)} alert record(s); traced gauges (last dispatch) "
          f"{gauges}; alone by CUDA events: the observe "
          f"{observe_ms:.3f} ms, the audit {audit_ms:.3f} ms a window; peak "
          f"memory {peak:.3f} GiB; {gpu}", flush=True)


def _audited_churn(topos, dev, gpu, churn_runs, totals):
    """Phase 10's churn at ``AUDIT_RATE`` events a dispatch with
    ``audit_every=1``, on the core and (S = 8, a forced rebalance after
    the 6th timed dispatch, as phase 11) the engine backend: the counters
    zeroed before each run and read after it, which must equal phase
    10's (the audit launches no kernel); records equal to phase 10's;
    every audit record ``ok``; the kernels held bitwise on the audited
    state."""
    for backend, cfg in (("core", {}), ("engine", ENGINE_SERVICE)):
        for name in SERVICE_TOPOS:
            base = topos[name]
            label = f"{name} rate={AUDIT_RATE}"
            core = churn_runs[label]
            n_cap = base.n + max(4, int(base.n * CHURN_SPARE))
            specs = _churn_specs(n_cap, n_cap, CHURN_Q)

            def rebalance(svc, i):
                if backend == "engine" and i == REBALANCE_AT:
                    svc.rebalance_now()

            torch.cuda.synchronize()
            kernels.reset_counts()
            svc = _churn_service(base, n_cap, specs, dev,
                                 tracker=obs.InMemoryTracker(),
                                 audit_every=1, **cfg)
            records, walls, _, gen = _churn_run(
                svc, AUDIT_RATE, CHURN_DISPATCHES, timed=True,
                hook=rebalance)
            for _ in range(AUDIT_RATE):
                gen.emit(svc)
            svc.tick()  # phase 10's profiled dispatch
            torch.cuda.synchronize()
            counts = kernels.counts()
            _count_into(f"audited {backend} {label}", totals)
            for key in KERNELS:
                if counts[key] <= 0:
                    raise AssertionError(f"audited {backend} {label}: "
                                         f"launched no {key}")
            if {k: counts[k] for k in KERNELS} != core["counts"]:
                raise AssertionError(
                    f"audited {backend} {label}: launches {counts} != "
                    f"phase 10's unaudited {core['counts']}")
            n_rec = _same_records(f"audited {backend} {label} vs phase 10",
                                  records, core["records"])
            audits = [r for r in svc.tracker.records
                      if r.get("kind") == "audit"]
            bad = [r for r in audits if not r["ok"]]
            if len(audits) != (CHURN_DISPATCHES + 2) * CHURN_Q or bad:
                raise AssertionError(f"audited {backend} {label}: "
                                     f"{len(audits)} audits, failing "
                                     f"{bad[:2]}")
            epochs = [e["kind"] for e in svc.capman.epochs]
            observe_ms, audit_ms = _observe_audit_ms(svc)
            us = [w / CHURN_K * 1e6 for w in walls]
            print(f"[obs-audit] {backend} {label} n_cap={n_cap} Q={CHURN_Q} "
                  f"K={CHURN_K} audit_every=1: us_per_cycle median "
                  f"{np.median(us):.1f} (min {min(us):.1f} max "
                  f"{max(us):.1f}; phase 10 unaudited core "
                  f"{core['us']:.1f}); alone by CUDA events: the observe "
                  f"{observe_ms:.3f} ms, the audit {audit_ms:.3f} ms a "
                  f"window; {len(audits)} audit records all ok "
                  f"(max residual/tol "
                  f"{max(r['residual'] / r['tol'] for r in audits):.3e}, "
                  f"edges checked a window "
                  f"{np.mean([r['edge_checked'] for r in audits]):.0f}); "
                  f"epochs {epochs}; records equal to phase 10's over "
                  f"{len(records)} dispatches ({n_rec} records); launches "
                  f"equal to phase 10's {core['counts']}; {gpu}",
                  flush=True)
            _check_service_kernels(f"audited {backend} {label}", svc)
            svc.close()
            del svc
            torch.cuda.empty_cache()


def _engine_audits(topos, dev):
    """``ShardedLSS.audit`` on phase 9's async (staleness 2) and int8
    engines' quiescent states (``run_static``'s engine route, grid and
    Chord at 80,000 peers): every monitor holds, the stale-drop books
    reconciled with ``async_lag_stats``."""
    for name in SERVICE_TOPOS:
        topo = topos[name]
        for kw in (dict(async_mode=True, staleness=STALENESS),
                   dict(wire="int8")):
            drv = _set_up(topo, dev, _engine_cfg(**kw))
            res = sim._run_to_quiescence(drv, topo, MAX_CYCLES, 1)
            eng, st = drv._eng, drv._st
            t0 = time.perf_counter()
            raw = eng.audit(st)
            ms = (time.perf_counter() - t0) * 1e3
            drops = (eng.async_lag_stats(st)["stale_drops"]
                     if kw.get("async_mode") else None)
            rep = obs_audit.evaluate(raw, stale_drops_metric=drops)
            what = ", ".join(f"{k}={v}" for k, v in kw.items())
            if not rep.ok:
                raise AssertionError(f"engine audit {name} {what}: "
                                     f"{rep.monitors} {raw}")
            print(f"[obs-engine-audit] {name} n={topo.n} {what} after "
                  f"{res['quiesced_at']} cycles: every monitor holds "
                  f"({sorted(rep.monitors)}; residual {raw['resid']:.3e} "
                  f"tol {raw['tol']:.3e}, edges checked "
                  f"{raw['edge_checked']}, seq_bad {raw.get('seq_bad')}, "
                  f"stale_drops {raw.get('stale_drops')}); audit "
                  f"{ms:.1f} ms", flush=True)
            del drv, eng, st
            torch.cuda.empty_cache()


def _flip_delta(snap, ta, centers, row=0):
    """``tests/test_audit.py::_flip_delta``: the data-vector skew that
    moves ``row``'s status vector exactly onto the next center."""
    s = stopping.status(snap.x_m, snap.x_c, snap.out_m, snap.out_c,
                            snap.in_m, snap.in_c, ta.mask)
    c = centers.cpu().numpy()
    v = s.m[row].cpu().numpy() / float(s.c[row])
    cur = int(np.argmin(((c - v) ** 2).sum(-1)))
    return c[(cur + 1) % len(c)] * float(s.c[row]) - s.m[row].cpu().numpy()


def _service_fault(device, cfg, fault):
    """A 4-tenant service on grid 4,096 with ``audit_every=1``: three
    clean ticks, one slot faulted by ``AuditFaults`` through snapshot ->
    fault -> restore, a zero-cycle tick.  Returns (the audit verdicts,
    the first violation's dispatch, the forensic span's dispatch)."""
    base = topology.grid(N_SMALL)
    tracker = obs.InMemoryTracker()
    svc = service.Service(base, service.ServiceConfig(
        capacity=4, k_max=3, d=2, cycles_per_dispatch=4, audit_every=1,
        **cfg), tracker=tracker, device=device)
    for spec in _churn_specs(base.n, base.n, 4):
        svc.admit(spec)
    for _ in range(3):
        svc.tick()
    snap = svc.backend.snapshot(svc.states, 1)
    ta = lss.TopoArrays.from_topology(base, device)
    # The conservation tolerance grows with n (D + 1) times the state's
    # mass (hundreds here): the phantom knowledge must exceed it.
    delta = 1e4 if fault == "corrupt_knowledge" else 5.0
    bad = getattr(obs.AuditFaults, fault)(snap, ta, row=0, delta=delta)
    svc.states = svc.backend.restore_slot(svc.states, 1, bad)
    svc.tick(cycles=0)
    svc.close()
    prov = forensics.provenance(tracker.records)
    return ([{k: r.get(k) for k in AUDIT_VERDICT} for r in tracker.records
             if r.get("kind") == "audit"],
            prov["violation"]["dispatch"], prov["span"].attrs["dispatch"],
            prov["failed"])


def _engine_fault(device, fault):
    """``ShardedLSS`` on grid 4,096 (S = 4, K = 5, 20 cycles): a skewed
    data vector under a stale quiescence claim (sync) or a regressed
    sequence counter (staleness 2).  Returns (the verdicts, the integer
    reductions)."""
    from repro_torch.engine import ShardedLSS

    base = topology.grid(N_SMALL)
    centers, _, _, inputs = sim._setup(base, sim.ProblemSpec(n=base.n),
                                       device)
    kw = (dict(async_mode=True, staleness=STALENESS)
          if fault == "regress_seq" else {})
    eng = ShardedLSS(base, centers, lss.LSSConfig(),
                     EngineConfig(num_shards=4, cycles_per_dispatch=5, **kw),
                     device=device)
    st = eng.run(eng.init(inputs, seed=0), 20)
    if fault == "regress_seq":
        bad, claimed = obs.AuditFaults.regress_seq(st, eng._tables), None
    else:
        ta = lss.TopoArrays.from_topology(base, device)
        delta = _flip_delta(eng.to_lss_state(st), ta, centers)
        bad = obs.AuditFaults.on_engine(
            eng, st, lambda s: obs.AuditFaults.skew_migration(s, delta))
        claimed = True
    raw = eng.audit(bad)
    rep = obs_audit.evaluate(raw, claimed_quiescent=claimed)
    return rep.monitors, {k: raw[k] for k in ("edge_bad", "edge_checked",
                                              "stop_bad", "seq_bad")
                          if k in raw}


def _audit_faults(dev, gpu):
    """One fault of each ``AuditFaults`` kind at grid 4,096 on the card
    and on the CPU: the verdicts must be equal (on the async engine,
    whose delay draws differ between the card's generators and the CPU's,
    the monitors only), each fault fires its monitor, and forensics names
    the faulted window."""
    fires = {"corrupt_knowledge": "conservation",
             "drop_halo_message": "edge", "skew_migration": "stopping",
             "regress_seq": "seq"}
    for backend, cfg in (("core", {}),
                         ("engine", dict(backend="engine", engine_shards=4))):
        for fault in ("corrupt_knowledge", "drop_halo_message"):
            got = _service_fault(dev, cfg, fault)
            want = _service_fault("cpu", cfg, fault)
            verdicts, first, span, failed = got
            if got != want:
                raise AssertionError(f"fault {backend} {fault}: card "
                                     f"{got[1:]} != CPU {want[1:]}")
            if first != 4 or span != 4 or fires[fault] not in failed:
                raise AssertionError(f"fault {backend} {fault}: {got[1:]}")
            print(f"[obs-fault] service {backend} grid n={N_SMALL} {fault}: "
                  f"monitors {failed} fire at dispatch {first} (slot 1; "
                  f"forensics' span: dispatch {span}); {len(verdicts)} "
                  f"audit verdicts equal to the CPU's", flush=True)
    for fault in ("skew_migration", "regress_seq"):
        monitors, ints = _engine_fault(dev, fault)
        cpu_monitors, cpu_ints = _engine_fault("cpu", fault)
        failed = sorted(m for m, held in monitors.items() if not held)
        if (monitors != cpu_monitors or failed != [fires[fault]]
                or (fault != "regress_seq" and ints != cpu_ints)):
            raise AssertionError(f"fault engine {fault}: card {monitors} "
                                 f"{ints}, CPU {cpu_monitors} {cpu_ints}")
        print(f"[obs-fault] engine grid n={N_SMALL} {fault}: fires only "
              f"{failed}, as on the CPU ({ints}); {gpu}", flush=True)


def _profiled_overlap(topos, dev, gpu):
    """The overlapped engine-backed service (chord, S = 8, phase 12's
    churn) with ``profile_dispatch=True`` and ``profile_sample_every=4``
    beside the same service unprofiled: records equal; the sampled
    attributions printed.  Then one ``profiler_dir`` session on a small
    overlapped service writes a Chrome trace (its device kernels
    counted)."""
    import tempfile

    base = topos["chord"]
    n_cap = base.n + max(4, int(base.n * CHURN_SPARE))
    specs = _churn_specs(n_cap, n_cap, CHURN_Q)
    runs = {}
    for profile in (False, True):
        tracker = obs.InMemoryTracker()
        svc = _churn_service(base, n_cap, specs, dev, tracker=tracker,
                             overlap=True, profile_dispatch=profile,
                             profile_sample_every=PROFILE_SAMPLE,
                             **ENGINE_SERVICE)
        records, walls, _, _ = _churn_run(svc, OVERLAP_RATE, PROFILE_TICKS)
        records.append(svc.flush())
        runs[profile] = (records, tracker, walls,
                         getattr(svc._dispatch_call, "sampled", 0))
        svc.close()
        del svc
        torch.cuda.empty_cache()
    (plain, _, plain_walls, _), (got, tracker, walls, sampled) = \
        runs[False], runs[True]
    n_rec = _same_records("profiled overlap vs unprofiled",
                          _by_dispatch([r for rs in got for r in rs]),
                          _by_dispatch([r for rs in plain for r in rs]))
    samples = [m["metrics"] for m in tracker.metrics
               if "dispatch_host_ms" in m["metrics"]]
    if sampled < 2 or len(samples) != sampled:
        raise AssertionError(f"profiled overlap: {sampled} sampled, "
                             f"{len(samples)} published")
    med = {k: float(np.median([s[k] for s in samples]))
           for k in ("dispatch_host_ms", "dispatch_device_ms",
                     "host_overhead_frac")}
    print(f"[obs-profile] engine chord overlapped, {OVERLAP_RATE} events a "
          f"dispatch, profile_sample_every={PROFILE_SAMPLE}: {sampled} of "
          f"{PROFILE_TICKS + 1} dispatches fenced on the worker thread; "
          f"median dispatch_host_ms {med['dispatch_host_ms']:.3f}, "
          f"dispatch_device_ms {med['dispatch_device_ms']:.3f}, "
          f"host_overhead_frac {med['host_overhead_frac']:.4f} (each: "
          f"{[round(s['host_overhead_frac'], 4) for s in samples]}); wall "
          f"a tick median {np.median(walls) * 1e3:.3f} ms (unprofiled "
          f"{np.median(plain_walls) * 1e3:.3f}); records equal to the "
          f"unprofiled service's ({n_rec} records); {gpu}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = topology.grid(N_SMALL)
        svc = _churn_service(base, base.n, _churn_specs(base.n, base.n, 4),
                             dev, overlap=True, profile_dispatch=True,
                             profiler_dir=tmp, backend="engine",
                             engine_shards=4)
        svc.tick()
        svc.flush()
        svc.close()
        files = list(Path(tmp).glob("*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"profiler_dir: {files}")
        events = json.loads(files[0].read_text()).get("traceEvents", [])
        kern = [e for e in events if e.get("cat") == "kernel"]
        ours = {m.group(1) for m in (
            re.search(r"(\w*(?:lss_state|correction|decide)\w*)", e["name"])
            for e in kern) if m}
        if not events:
            raise AssertionError(f"profiler_dir: {files[0].name} is empty")
        print(f"[obs-profile] profiler_dir: one session on the worker "
              f"thread wrote {files[0].name} ({files[0].stat().st_size} "
              f"bytes, {len(events)} events, {len(kern)} device kernels; "
              f"ours: {sorted(ours)})", flush=True)


def phase_observability(topos, dev, gpu, churn_runs):
    """The observability and audit plane on the card: tracker overhead on
    phase 6's workload, the audited churned services (their launches
    returned as the ``service_audit`` path), ``ShardedLSS.audit`` on phase
    9's engines, one fault of each kind against the CPU, and profiling on
    the overlapped engine service."""
    totals = {key: 0 for key in KERNELS}
    _obs_overhead(topos["chord"], dev, gpu)
    torch.cuda.empty_cache()
    _audited_churn(topos, dev, gpu, churn_runs, totals)
    _engine_audits(topos, dev)
    _audit_faults(dev, gpu)
    _profiled_overlap(topos, dev, gpu)
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    dev = torch.device("cuda")

    gpu = _gpu_line()
    print(gpu, flush=True)

    t0 = time.perf_counter()
    built = _build.build()
    print(f"[build] {built or 'cached'} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    topos = _topologies(N_MAIN)
    print(f"[setup] topologies built in {time.perf_counter() - t0:.1f} s "
          f"(D: {', '.join(f'{k}={t.max_deg}' for k, t in topos.items())})",
          flush=True)

    def phase(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[wall] {label}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    main_stats = phase("phase 3", phase_kernels, topos, dev)
    batched = phase("phase 3b", phase_kernels_batched, topos, dev)
    totals, cycles, results = phase("phase 4 runs", phase_main_path, topos,
                                    dev)
    medians = phase("phase 4 timing", phase_timing, topos, dev, cycles)
    phase("phase 4 profile", phase_profile, topos, dev, medians, cycles)
    phase("phase 5", phase_parity, dev)
    svc_totals, runs = phase("phase 6", phase_service, topos, dev)
    phase("phase 7", phase_service_parity, topos, dev, runs)
    eng_totals, eng_cycles, eng_results = phase("phase 8 runs", phase_engine,
                                                topos, dev, results)
    eng_timings = phase("phase 8 timing", phase_engine_timing, topos, dev,
                        eng_cycles)
    phase("phase 8 parity", phase_engine_parity, dev, topos["grid"])
    sweep_totals = phase("phase 8 sweep", phase_sweep, dev, topos["chord"])
    aq_totals = phase("phase 9", phase_async_quantized, topos, dev,
                      eng_results, eng_timings)
    churn_totals, churn_runs = phase("phase 10", phase_churn, topos, dev,
                                     gpu)
    engine_svc_totals = phase("phase 11", phase_service_engine, topos, dev,
                              gpu, churn_runs)
    overlap_totals = phase("phase 12", phase_overlap, topos, dev, gpu)
    audit_totals = phase("phase 13", phase_observability, topos, dev, gpu,
                         churn_runs)

    line = {"kernels": []}
    decide = batched["region_decide"]
    glob = batched["global"]
    for name, src, rep in (
            ("region_decide", "src/repro_torch/kernels/csrc/region_decide.cu",
             "src/repro/kernels/region_decide.py:51"),
            ("lss_state", "src/repro_torch/kernels/csrc/lss_state.cu",
             "src/repro/kernels/lss_state.py:42"),
            ("correction", "src/repro_torch/kernels/csrc/correction.cu",
             "src/repro/kernels/correction.py:27")):
        if name == "region_decide":
            # The main paths launch its second entry, the global decision,
            # once an observe: the service's on Chord at Q = 64 leads; its
            # other shapes, then the first entry's, beside.
            head = glob["service chord"]
            shapes = [{"shape": st["label"], "ms": st["ms"],
                       "device_ms": st["device_ms"],
                       "plain_ms": st["plain_ms"], "bound_ms": st["bound"][0],
                       "bound_by": st["bound"][1],
                       "share_of_bound": _share(st["bound"], st["ms"]),
                       **({"bitwise_values": st["bitwise_values"]}
                          if "bitwise_values" in st else {})}
                      for st in [*glob.values(), *decide.values()]]
            entry = {"max_abs_err": max(st["max_abs_err"] for st in
                                        [*glob.values(), *decide.values()]),
                     "ms": head["ms"], "device_ms": head["device_ms"],
                     "plain_ms": head["plain_ms"],
                     "bound_ms": head["bound"][0],
                     "bound_by": head["bound"][1], "shape": head["label"]}
        else:
            # This slice's main path: the service at Q = 64 on Chord; the
            # other shapes (the service on grid, run_static) beside.
            stats = [batched["chord"], batched["grid"], main_stats["ba"],
                     main_stats["chord"], main_stats["grid"]]
            head = stats[0]
            shapes = [{"shape": st["label"], "ms": st[f"{name}_ms"],
                       "device_ms": st[f"{name}_device_ms"],
                       "plain_ms": st[f"{name}_plain_ms"],
                       "bound_ms": st[f"{name}_bound"][0],
                       "bound_by": st[f"{name}_bound"][1],
                       "share_of_bound": _share(st[f"{name}_bound"],
                                                st[f"{name}_ms"]),
                       "bitwise_values": st[f"{name}_bitwise"],
                       **({"bound_v_ms": st["correction_bound_v"][0]}
                          if name == "correction" else {})}
                      for st in stats]
            entry = {"max_abs_err": max(st[f"err_{name}"] for st in stats),
                     "ms": head[f"{name}_ms"],
                     "device_ms": head[f"{name}_device_ms"],
                     "plain_ms": head[f"{name}_plain_ms"],
                     "bound_ms": head[f"{name}_bound"][0],
                     "bound_by": head[f"{name}_bound"][1],
                     **({"bound_v_ms": head["correction_bound_v"][0]}
                        if name == "correction" else {}),
                     "shape": head["label"]}
        line["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": (totals[name] + svc_totals[name] + eng_totals[name]
                         + sweep_totals[name]
                         + sum(t[name] for t in aq_totals.values())
                         + churn_totals[name] + engine_svc_totals[name]
                         + overlap_totals[name] + audit_totals[name]),
            "launches_by_path": {"run_static": totals[name],
                                 "service": svc_totals[name],
                                 "engine": eng_totals[name],
                                 "sweep": sweep_totals[name],
                                 **{path: t[name]
                                    for path, t in aq_totals.items()},
                                 "service_churn": churn_totals[name],
                                 "service_engine": engine_svc_totals[name],
                                 "service_overlap": overlap_totals[name],
                                 "service_audit": audit_totals[name]},
            "library_ms": None, **entry, "by_shape": shapes, "gpu": gpu})
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
