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
   trace;
14. the multi-process paths, on grid and Chord at 80,000 peers through
   the kernels (``EngineConfig(num_shards=S, cycles_per_dispatch=10)``,
   one untimed and five timed dispatches, 60 cycles, counters zeroed
   before and read after each run, the final observe included): (a)
   ``ShardedLSS.use_mesh`` on a one-rank NCCL group (S = 1): every
   ``ShardedState`` field, msgs and metrics bitwise the gather
   fallback's at S = 1 (sha256 of each field), µs per cycle beside it,
   each of the cycle's collectives timed alone at its shapes, one more
   dispatch of each under ``torch.profiler`` (device events a cycle,
   idle share, device time by kernel), the kernels held bitwise
   to their plain versions on its state; (b)
   two ranks on the one card over gloo (``repro_torch.distributed.
   launch.spawn``; the payload staged through pinned host memory), S = 2,
   on the ``exact`` and ``int8`` wires: both ranks' gathered state,
   msgs and metrics bitwise the fallback's at S = 2, µs per cycle (rank 0
   and 1, and the fallback's), the staged bytes a cycle beside the
   modeled ``wire_pair_bytes``, each rank's launches, the kernels held
   bitwise on each rank's block (the B rows its cycles launch on); (c)
   ``MeshMonitor`` on four ranks of the card (a 4-ring with
   ``tests/test_distributed.py:91``'s flip, a 2x2 torus with ``:66``'s
   statistics): decisions equal the same ranks' CPU run at every step,
   the last ones the global mean's region, fewer effective than physical
   sends, ms a step;
15. the rest of the engine, on grid and Chord at 80,000 peers through
   the kernels: (a) ``engine.autotune.plan`` around phase 8's
   ``EngineConfig(8, 10)`` (K 5 / 10 / 20 x ``exact`` / ``compact``, each
   probe counted by ``launch.cost.analyze``, one warm-up and three timed
   dispatches), its table (modeled and measured µs a cycle, wire bytes,
   counted HBM bytes and flops), the Spearman rank correlation of
   modeled and measured, the plan's wall and its probe builds' share; the
   chosen plan must be the measured argmin, and on grid an engine built
   with ``auto_plan=True`` must adopt one of the candidates and give, on
   ``run_static``'s engine route, the results and every state field of
   an engine built directly at that config (the kernels held bitwise on
   its state); (b) the async ring with one shard a process, K = 10, one
   untimed and five timed dispatches: at world size 1 on NCCL (S = 1,
   staleness 0 and 2) and on two ranks of the card over gloo (S = 2,
   staleness 2, ``exact`` and ``int8``), every field, the books and the
   ring columns (gathered), msgs and metrics bitwise the single-process
   async engine's after every dispatch; µs a cycle beside that engine
   and beside phase 14's sync mesh run, staged bytes a cycle, the kernels
   held bitwise on each rank's block; (c) each run's ``audit`` equal to
   the fallback's, every monitor holding; (d) on both ranks a rebalance,
   ``migrate_from`` a BFS onto a stride partition (S = 2) after 20
   cycles, and 10 cycles after it, bitwise the fallback's;
16. the model zoo (``repro_torch.models``, A.10a), the launch counters
   zeroed before and required to read 0 after (the models launch none of
   the three kernels): (a) each arch's smoke config in float32 on the
   card, ``logits_train`` (or the encoder) and ``loss``, a 40-token
   prefill, 8 decode steps and the caches ``allclose`` (1e-4) to the same
   code on the CPU from the same parameters; (b) each arch at its
   published widths with only the depth cut (2 layers; zamba2 one
   6-layer group; whisper 2 + 2), in bf16: a (1, 4096) prefill (the
   chunked attention path) and 32 greedy decode steps, each after an
   untimed run, with prefill ms, decode ms a token, peak memory, the
   share of the bf16 tensor-core peak (``_zoo_flops``: the products the
   tokens need, causal query-key pairs, the routed experts) and decode's
   share of its byte bound (``_zoo_decode_bytes``); qwen3, mixtral and
   zamba2 profiled (a prefill and 8 decode steps); (c) in float32 at
   published widths (depth cut; the MoE's capacity factor raised to
   n_experts / top_k, so no token drops) qwen3-14b, mixtral-8x7b,
   mamba2-370m and zamba2-2.7b: prefill of 4,160 tokens (past mixtral's
   4,096 window: its ring prefill and ring decode run) and one decode
   step equal to ``logits_train`` at those positions within 2e-2.

17. the single-process training path (``repro_torch.optim``, ``data``,
   ``checkpoint``, ``training``; A.10b), the launch counters zeroed before
   and required to read 0 after (the training path launches none of the
   three kernels): (a) each arch's smoke config in float32, one train
   step with ``accum_steps=2`` and ``warmup=0`` on the card against the
   same code on the CPU from the same parameters and batch: loss and
   gnorm within rtol 1e-4, ``m`` and ``v`` within rtol 1e-4 and 1e-4 of
   the leaf's largest value (at least 1e-9), the parameters within rtol
   1e-5 / atol 1e-6 where the CPU's |g| is above ten times the grads'
   noise (AdamW's
   first step is about ±lr a coordinate, and one whose grad lies in the
   noise may flip sign); (b) ``Trainer`` on yi-9b smoke for 30 steps
   with a ``RuntimeError`` injected at step 17: restored from step 10,
   ends at step 30, the loss falls as ``tests/test_system.py`` asks;
   (c) mamba2 smoke: 10 steps, a save, 2 more; the load and the same 2
   steps land bitwise on the uninterrupted run, under
   ``torch.use_deterministic_algorithms(True)`` (the embedding's backward
   and other scatters accumulate with atomics otherwise); (d) qwen3-14b
   at published widths with 2 layers and mamba2-370m whole, in bf16 with
   float32 moments and remat on: (1, 4096) ``TokenSource`` batches (the
   train_4k length, the global batch cut from 256 to 1), one untimed and
   three timed steps, with ms a step, tokens/s, peak memory and the share
   of the bf16 peak (3x the forward's products, ``_train_flops``); one
   qwen3 step profiled.  No full-width checkpoint is written.

18. the multi-process training substrate (``repro_torch.training.localsgd``,
   ``distributed.sharding`` / ``elastic`` / ``pipeline``, the checkpoint's
   ``load(shardings=)``, ``make_batch_fn(mesh=)``; A.10c part 1), its
   ranks as processes sharing the card over gloo (NCCL refuses two ranks
   on one GPU; tensors stay on the card, the collectives stage through
   pinned host memory), the launch counters zeroed on every rank before
   and required to read 0 after: (a) the 4-ring LocalSGD case of
   ``tests/test_torch_localsgd.py`` on 4 ranks of the card and on the same
   ranks on the CPU: the synced flag equal at every gate call, the params
   within 1e-5; (b) LocalSGD on mamba2-370m at published widths, 24 of
   its 48 layers (bf16, float32 moments, remat), a data ring of 4 ranks,
   each rank's
   own (1, 4096) row of a ``TokenSource`` global batch placed by
   ``make_batch_fn(mesh=...)`` (the train_4k length, the global batch cut
   from 256 to 4), 8 local train steps each followed by the gate, tau 4x
   the global mean drift after step 1 (all-gathered outside the gate): no
   sync at step 1, at least one by step 8, after each sync every rank's
   params bitwise equal (sha256) and the anchor equal to them; ms a local
   step, a gate (drift, monitor step, the all-reduced any, the sync
   all-reduce), staged bytes a sync, effective and physical monitor
   sends, peak memory; (c) the same 24-layer mamba2-370m's params and a
   seeded AdamW state placed on (data 2, model 2) by
   ``model.param_specs()`` with ``elastic.reshard`` and saved from 4 ranks,
   then a second launch of 2 ranks ``remesh(model_axis=2)`` -> (1, 2) loads
   with ``shardings``:
   every local shard bitwise its slice of the saved leaf (sha256 per leaf
   per rank), save and load ms and GB/s, the checkpoint deleted after;
   (d) four qwen3-14b decoder layers at published widths (bf16, seeded)
   as the stages of ``pipeline`` over 4 stage ranks, M = 8 microbatches
   of (1, 4096) hidden states: the output equal on every rank and bitwise
   the four layers applied in sequence on one rank of the card; ms an
   apply and a tick, staged bytes a tick, the measured bubble beside
   (S - 1) / (M + S - 1).

19. the train, prefill and decode steps across a multi-device
   ``DeviceMesh`` (``repro_torch.training.steps`` through
   ``repro_torch.distributed.spmd``) and the dry-run
   (``repro_torch.launch.dryrun``; A.10c part 2): 4 ranks sharing the
   card over gloo on a (data 2, model 2) mesh, shards on the card, the
   launch counters zeroed on every rank and required to read 0 after:
   (a) at smoke size in float32, on the card and on the same ranks with
   CPU shards: two yi-9b train steps at accum 2 on (4, 32), a qwen3-moe
   and a zamba2 step (FSDP, remat, accum 2), a yi-9b prefill of (4, 12)
   and three
   greedy steps: losses and gnorms within 1e-4, params within (1e-4,
   1e-5) but for AdamW sign flips (under 1e-3 of a leaf, each under
   2 lr a step), tokens equal; (b) mamba2-370m whole (bf16, float32
   moments, remat; the SSD's heads split over "model"), a (2, 4096)
   ``TokenSource`` global batch (one row a data rank), one untimed and two
   timed steps, with the default (non-deterministic) CUDA algorithms: ms a
   step, staged bytes a step a
   rank (gathers, grad reduction, means: ``fn.plan.staged``), peak
   memory a rank after the first step; after every step the gathered
   params equal on every rank (sha256) and every local shard, each
   replica's own, bitwise its slice; (c) qwen3-14b with 2 of 40 layers
   (bf16): a prefill of (2, 4096), one row a data rank, and 32 greedy
   steps, ms and ms a token, staged bytes; each rank's row then through
   the one-rank steps at batch 1 (the shapes the rank computed), whose
   tokens must be equal;
   (d) the dry-run of yi-9b train_4k single and qwen3-moe-235b-a22b
   train_4k multi, each in a child process started beside the kernels'
   build and awaited before phase 3 (so that no timed phase shares the
   host with their tracing): status ``ok``, the dominant term, the
   bound, bytes per device; (e) yi-9b training, 2 of 48 layers, checked
   as (b); then, in 4 ranks of their own, (f) qwen3-moe-235b-a22b
   serving (2 of 94 layers, 64 experts a "model" rank; a prefill of (2,
   4096), 32 steps) and (g) mixtral-8x7b at batch 1 (2 of 32 layers,
   its KV ring split over "data"; a prompt past the window, 32 steps
   writing across the two halves), each teacher-forced by the one-rank
   steps run first in this process: tokens equal but at near ties (of
   the logits or of a router's K-th and (K+1)-th expert), under 1 MB
   staged a decode step a rank, no weight or KV cache gathered, no
   expert gathered over "model", and (h) zamba2-2.7b serving (one 6-layer
   group; the SSD's heads and the shared attention's split over "model";
   a prefill of (2, 4096), 32 steps, teacher-forced as (f): every step's
   logits within twice the one-rank bf16 run's own largest deviation
   from a float32 run of the same weights, tokens equal but where the
   top-two gap is within twice that step's logit err, a float32 prefill
   within 1e-4 of the one-rank float32 prefill's logits, under 1 MB
   staged a decode step a rank, no leaf gathered over "model" by a
   decode step, the SSM state half the heads a rank); then, in 8 ranks
   of their own on a (data 1, model 8) mesh, (i) whisper-large-v3 (2 + 2 layers), whose 20 heads 8
   does not divide: a float32 train step (remat) of a (2, 128) batch held
   to the one-rank step (loss and gnorm within 1e-4; each leaf's params,
   where the one-rank grads clear the CPU parity tests' noise gate,
   within 2e-3 with at most 1e-3 of them past (a)'s tolerance),
   shards bitwise and replicas equal, and a bf16 prefill of (2, 120) and
   8 steps teacher-forced by the one-rank run.

20. ``sim.run_dynamic`` (Figs. 6-8's problem: bias 0.2, std 2.0, d = 2,
   k = 3; 400 cycles, warm-up a quarter) at 80,000 peers through the
   kernels, the launch counters zeroed before each run and read after it:
   (a) grid at drift 1,000 and 100,000 ppmc, grid, Chord and BA at drift
   1,000 and ``drop_rate`` 0.05, grid at drift 1,000 and churn 1,000 ppmc;
   each prints avg_accuracy, msgs_per_link_per_cycle, alive_frac (equal to
   the host's replay of the numpy churn draws), the median µs a cycle
   (between consecutive drains), launches and host reads a cycle and the
   host seconds in each driver method; avg_accuracy at least 0.90 at
   ``drop_rate`` 0; the table rebuild a churn cycle costs on a
   ``DynTopology`` at 80,089 peers; (b) at 4,096 peers on grid (drift
   10,000, churn 1,000 ppmc, 200 cycles) the fused and reference suites
   equal in every key at ``drop_rate`` 0 and 0.05, and the card equal to
   the CPU at 0; (c) ``engine=EngineConfig(num_shards=8)`` on grid 80,089
   (drift 1,000, 200 cycles) equal to the core in every key; (d) at 4,096
   peers a ``DynTopology`` whose peers leave (drift 10,000, churn 500,
   80 cycles, the first seed whose churn never draws a dead peer again)
   equal to the alive-mask run.

21. the demo twins (``examples/*_torch.py``) on the card at their
   defaults, the counters zeroed before and read after each: quickstart
   (its dict equal to its CPU run's), sensor_grid (alive_frac the
   replay's, accuracy at least 0.90), engine_demo (quiesced, the sweep's
   statistics), serve_monitor (64 tenants in 48 slots of a 4,096-peer
   grid, the priority scheduler with preemption, a join burst forcing a
   regrow: at least one preemption, resume and regrow; the fused and
   reference services equal in records, SLO reports, control trail and
   epochs); then serve_monitor on grid 283² (80,089 peers), 64 tenants in
   48 slots, 10 dispatches of K = 8, 24 joins: dispatch wall, tenant-cycles
   a second, preemptions, resumes, epochs, each class's attainment,
   launches and host reads a dispatch, peak memory.

It prints phase 16's rows as a JSON line (``{"zoo": [...]}``), phase 17's
(``{"train": [...]}``), phase 18's (``{"distributed": {...}}``), phase
19's (``{"mesh_steps": {...}}``), then a
JSON line with one entry per kernel (its numbers at the
service's shape, ``by_shape`` for the others, ``launches`` summed over the
``run_static``, service, engine, sweep, async-engine, quantized-engine,
churned-service, engine-backed-service, overlapped-service,
audited-service and collective-engine (``engine-mesh``: phase 14's (a)
and both ranks of (b)) runs, the autotuner's (``autotune``: phase 15
(a)'s probes and its ``auto_plan`` run), the async and moved mesh
engines' (``engine-mesh-async``: phase 15 (b)-(d)), the dynamic runs'
(``dynamic``: phase 20's fused runs), the demos' (``demos``: phase 21's
twins at their defaults) and the contended service at 80,089 peers
(``monitor-contended``), each path's in ``launches_by_path``;
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
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

# Phase 17 (c) runs under torch.use_deterministic_algorithms, which needs
# cuBLAS's workspace fixed before the first cuBLAS call (Hopper's default
# size, so the other phases see no change).
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
from repro_torch.kernels import cost as kcost  # noqa: E402
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
    """:func:`kcost.lss_state_cost` of these inputs (n counts the peers of
    every slot of a batched call), with their live slots."""
    _, x_c, out_m, _, _, _, mask = args
    return kcost.lss_state_cost(x_c.numel(), *out_m.shape[-2:], k,
                                int(mask.sum()))


def _correction_cost(args, v):
    """:func:`kcost.correction_cost` of these inputs, with ``v``'s
    violating slots."""
    _, s_c, a_m, _, _, _, _ = args
    return kcost.correction_cost(s_c.numel(), *a_m.shape[-2:], int(v.sum()))


def _correction_cost_v(args, v):
    """:func:`kcost.correction_cost_v`: the part of the correction the
    main path keeps, on ``v``'s violating slots."""
    _, s_c, a_m, _, _, _, _ = args
    return kcost.correction_cost_v(s_c.numel(), *a_m.shape[-2:],
                                   int(v.sum()))


_bound_ms = kcost.bound_ms


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
    """:func:`kcost.region_decide_cost` of ``v`` (Q, m, d) against the
    packed families: their live centers on the Voronoi slots, and the
    other slots."""
    q, m, d = v.shape
    voronoi = packed.kind == regions.KIND_VORONOI
    return kcost.region_decide_cost(
        q, m, d, packed.k_max, int(packed.cmask.sum(-1)[voronoi].sum()),
        int((~voronoi).sum()))


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
            "bound": _bound_ms(
                *kcost.global_cost(q, n, d, tables.cn.shape[-1]),
                ops_per_s=kcost.F64_OPS_PER_S)}


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


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _require_launched(label, counts, keys=KERNELS) -> None:
    """Every kernel of ``keys`` launched on the path and no plain version
    ran."""
    if min(counts[key] for key in keys) <= 0:
        raise AssertionError(f"{label}: the path launched no kernel")
    if any(counts[f"{key}_ref"] for key in KERNELS):
        raise AssertionError(f"{label}: the path ran a plain version")


def _counted_run(label, fn=sim.run_static, **kw):
    """``fn(**kw)`` (a main path's entry point) with the launch counters
    zeroed before it and read after it; fails unless every kernel launched
    and no plain version ran."""
    kernels.reset_counts()
    res = fn(**kw)
    torch.cuda.synchronize()
    counts = kernels.counts()
    _require_launched(label, counts)
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
    state three cycles in (padding rows included; under a mesh this
    rank's ``B`` rows, the shape its cycles launch), bitwise against their
    plain versions: ``lss_state`` and ``correction`` (V = every live slot)
    with the cycles' tables, the global decision with the observe's."""
    st = eng.run(_replay_state(st0), 3)
    flat = eng._flat_state(st)
    if eng._mesh is None:
        live = lss._live_mask(eng._flat_topo, flat.alive)
    else:  # the block's live slots, as its cycle computes them
        blk = eng._block
        alive_all = eng._base(eng.gather_state(st)).alive.reshape(-1)
        live = blk.mask & flat.alive[:, None] & alive_all[blk.tgt_pos]
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
    _sync(flat.x_m.device)
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
              "region_decide": _bound_ms(
                  *kcost.global_cost(q, n, s_m.shape[-1], k),
                  ops_per_s=kcost.F64_OPS_PER_S)}
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


# --- phase 14: the multi-process paths (collective engine, mesh monitor) -

MESH_K = 10  # cycles a dispatch: phase 8's K
MESH_TIMED = 5  # timed dispatches, after one untimed: 60 cycles in all
MESH_WIRES = ("exact", "int8")
MESH_TIMEOUT_S = 600  # each launch.spawn of phase 14
# tests/test_distributed.py:91's flip on a 4-ring and :66's statistics on
# a 2x2 torus: (mesh shape, axis names, centers, [(per-peer stat, steps)]).
MONITOR_CASES = {
    "ring4": ((4,), ("data",), [[0.0], [10.0]],
              [(np.full((4, 1), 2.0, np.float32), 6),
               (np.full((4, 1), 9.0, np.float32), 10)]),
    "torus2x2": ((2, 2), ("data", "model"), [[0.0, 0.0], [1.0, 1.0]],
                 [(np.array([[0.95, 0.9]] * 3 + [[0.1, 0.05]], np.float32),
                   8)]),
}


def _mesh_engine(topo, dev, shards, wire, mesh=None, **kw):
    """Phase 8's problem on an engine of ``shards`` shards (K = 10,
    through the kernels on the card; ``kw`` more ``EngineConfig`` fields),
    on ``mesh`` when given."""
    from repro_torch.engine import ShardedLSS

    centers, _, _, inputs = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
    eng = ShardedLSS(topo, centers, lss.LSSConfig(),
                     EngineConfig(num_shards=shards, cycles_per_dispatch=MESH_K,
                                  wire=wire, **kw), device=dev)
    if mesh is not None:
        eng.use_mesh(mesh, "shards")
    return eng, eng.init(inputs, seed=0)


def _mesh_dispatches(eng, st, dev):
    """One untimed dispatch and ``MESH_TIMED`` timed ones of K cycles:
    (state, µs a cycle of each timed dispatch, synchronized)."""
    st = eng.run(st, MESH_K)
    _sync(dev)
    us = []
    for _ in range(MESH_TIMED):
        t0 = time.perf_counter()
        st = eng.run(st, MESH_K)
        _sync(dev)
        us.append((time.perf_counter() - t0) * 1e6 / MESH_K)
    return st, us


def _profile_dispatch(label, eng, st, dev, us):
    """One more dispatch of ``eng`` from ``st`` under torch.profiler:
    device events a cycle, idle share, device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(st, MESH_K)
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    _print_profile(label, prof, wall_ms, np.median(us) * MESH_K / 1e3,
                   MESH_K)


def _collective_ms(label, eng, st, dev, reps=20):
    """Each collective of a mesh cycle alone at the cycle's shapes (the
    ``alive`` all-gather and the wire's all-to-alls on ``st``'s boundary
    sends): ms a call over ``reps`` back-to-back calls, synchronized once,
    and their sum a cycle."""
    from repro_torch.distributed import collective

    group, h = eng._mesh.group, eng._block.halo
    bufs = exchange.gather_block(st.out_m[0], st.out_c[0], st.pending[0],
                                 h.send_row, h.send_slot, h.send_ok)
    payload, _, _ = eng._wire.encode(*bufs)
    calls = [("all_gather alive", st.alive[0], collective.all_gather)]
    calls += [("all_to_all", p, exchange.collective_all_to_all)
              for p in payload]
    total, parts = 0.0, []
    for name, buf, fn in calls:
        fn(buf, group)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(buf, group)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3 / reps
        total += ms
        parts.append(f"{name} {tuple(buf.shape)} {buf.dtype} {ms:.4f}")
    print(f"[mesh] {label}: the cycle's collectives alone, ms a call over "
          f"{reps} calls: {'; '.join(parts)}; {total:.4f} ms a cycle",
          flush=True)


def _digests(eng, st) -> dict:
    """sha256 of every field of the (gathered) state, an async state's
    books and rings included, the metrics and the send total: what two
    runs are held to bitwise."""
    import hashlib

    def sha(t):
        return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()

    full = eng.gather_state(st)
    parts = (full,) if full is eng._base(full) else (full.sync, full)
    out = {f"{name} {tuple(t.shape)} {t.dtype}": sha(t)
           for part in parts for name, t in part._asdict().items()
           if isinstance(t, torch.Tensor)}
    acc, quiescent, correct = eng.metrics(st)
    out["metrics"] = (float(acc), bool(quiescent), sha(correct))
    out["total_msgs"] = int(eng.total_msgs(st))
    return out


def _mesh_rank(rank, world, topos, dev):
    """Phase 14 (b) on one rank: each topology and wire on this rank's
    shard of a gloo ``("shards",)`` mesh, counters zeroed before the 60
    cycles and read after them (the final observe included); then the
    kernels held bitwise to their plain versions on the rank's block."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
    out = {}
    for name, topo in topos.items():
        for wire in MESH_WIRES:
            eng, st0 = _mesh_engine(topo, dev, world, wire, mesh)
            kernels.reset_counts()
            st, us = _mesh_dispatches(eng, _replay_state(st0), dev)
            digests = _digests(eng, st)
            _sync(dev)
            counts = kernels.counts()
            out[(name, wire)] = {
                "digests": digests, "us": us, "counts": counts,
                "staged_per_cycle": eng.staged_bytes / (
                    MESH_K * (MESH_TIMED + 1)),
                "pair_bytes": int(eng.wire_pair_bytes(2)[rank].sum()),
                "B": eng.B}
            _check_engine_kernels(f"mesh S={world} rank {rank} {name} "
                                  f"{wire}", eng, st0)
    return out


def _mesh_world1(topos, dev, totals, sync_us):
    """Phase 14 (a): ``use_mesh`` on a one-rank NCCL group (S = 1) against
    the gather fallback at S = 1, bitwise, timed beside it (the median
    µs/cycle into ``sync_us``)."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # before the mesh: NCCL's device
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1,),
                                    mesh_dim_names=("shards",))
            for name, topo in topos.items():
                eng, st0 = _mesh_engine(topo, dev, 1, "exact", mesh)
                kernels.reset_counts()
                st, us = _mesh_dispatches(eng, _replay_state(st0), dev)
                got = _digests(eng, st)
                _sync(dev)
                counts = kernels.counts()
                _require_launched(f"mesh S=1 {name}", counts)
                sync_us[(1, name, "exact")] = float(np.median(us))
                for key in KERNELS:
                    totals[key] += counts[key]
                ref_eng, ref0 = _mesh_engine(topo, dev, 1, "exact")
                ref_st, ref_us = _mesh_dispatches(ref_eng, ref0, dev)
                want = _digests(ref_eng, ref_st)
                if got != want:
                    bad = [k for k in want if got.get(k) != want[k]]
                    raise AssertionError(f"mesh S=1 {name} ({backend}): "
                                         f"differs from the gather "
                                         f"fallback in {bad}")
                print(f"[mesh] {name} n={topo.n} S=1 {backend} world 1: "
                      f"every ShardedState field, msgs and metrics bitwise "
                      f"the gather fallback's after "
                      f"{MESH_K * (MESH_TIMED + 1)} cycles (metrics "
                      f"{got['metrics'][:2]}, msgs {got['total_msgs']}); "
                      f"us_per_cycle median {np.median(us):.1f} (min "
                      f"{min(us):.1f} max {max(us):.1f}), gather fallback "
                      f"{np.median(ref_us):.1f} ({min(ref_us):.1f}-"
                      f"{max(ref_us):.1f}); launches {counts}", flush=True)
                _collective_ms(f"{name} S=1 {backend}", eng, st, dev)
                _profile_dispatch(f"mesh S=1 {name}", eng, st, dev, us)
                _profile_dispatch(f"gather S=1 {name}", ref_eng, ref_st, dev,
                                  ref_us)
                _check_engine_kernels(f"mesh S=1 {name}", eng, st0)
        finally:
            dist.destroy_process_group()


def _mesh_world2(topos, dev, totals, sync_us):
    """Phase 14 (b): two ranks on one device over gloo (the payload
    staged through pinned host memory), S = 2, against the gather
    fallback at S = 2 on the exact and int8 wires (rank 0's median
    µs/cycle into ``sync_us``)."""
    from repro_torch.distributed import launch

    ranks = launch.spawn(_mesh_rank, 2, timeout_s=MESH_TIMEOUT_S,
                         args=(topos, str(dev)))
    for name, topo in topos.items():
        for wire in MESH_WIRES:
            eng, st0 = _mesh_engine(topo, dev, 2, wire)
            st, ref_us = _mesh_dispatches(eng, st0, dev)
            want = _digests(eng, st)
            runs = [r[(name, wire)] for r in ranks]
            for rank, run in enumerate(runs):
                if run["digests"] != want:
                    bad = [k for k in want if run["digests"].get(k) !=
                           want[k]]
                    raise AssertionError(
                        f"mesh S=2 rank {rank} {name} {wire}: differs from "
                        f"the gather fallback in {bad}")
                _require_launched(f"mesh S=2 rank {rank} {name} {wire}",
                                  run["counts"])
                for key in KERNELS:
                    totals[key] += run["counts"][key]
            us = runs[0]["us"]
            sync_us[(2, name, wire)] = float(np.median(us))
            print(f"[mesh] {name} n={topo.n} S=2 gloo world 2 on one "
                  f"device, wire {wire}: every ShardedState field, msgs "
                  f"and metrics bitwise the gather fallback's on both "
                  f"ranks after {MESH_K * (MESH_TIMED + 1)} cycles (metrics "
                  f"{want['metrics'][:2]}, msgs {want['total_msgs']}); "
                  f"rank 0 us_per_cycle median {np.median(us):.1f} (min "
                  f"{min(us):.1f} max {max(us):.1f}), rank 1 median "
                  f"{np.median(runs[1]['us']):.1f}; gather fallback S=2 "
                  f"median {np.median(ref_us):.1f} ({min(ref_us):.1f}-"
                  f"{max(ref_us):.1f}); staged bytes a cycle rank 0 "
                  f"{runs[0]['staged_per_cycle']:.0f} rank 1 "
                  f"{runs[1]['staged_per_cycle']:.0f}; modeled "
                  f"wire_pair_bytes a cycle rank 0 {runs[0]['pair_bytes']} "
                  f"rank 1 {runs[1]['pair_bytes']}; B={runs[0]['B']}; "
                  f"launches rank 0 {runs[0]['counts']} rank 1 "
                  f"{runs[1]['counts']}", flush=True)


def _monitor_rank(rank, world, dev):
    """Phase 14 (c) on one rank: each monitor case on ``dev`` and on the
    CPU (one gloo mesh each), every step's gathered decisions, the
    gathered send counters and the ms a step (synchronized) on ``dev``."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import monitor

    if torch.device(dev).type == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for case, (shape, names, centers, phases) in MONITOR_CASES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        for where in (dev, "cpu"):
            mon = monitor.MeshMonitor(mesh, names, centers,
                                      monitor.MonitorConfig(rounds=2),
                                      device=where)
            st = mon.init()
            decisions, ms = [], []
            for vals, steps in phases:
                stat = wvs.from_vector(
                    torch.tensor(vals[mon.peer:mon.peer + 1], device=where),
                    torch.ones(1, device=where))
                for _ in range(steps):
                    t0 = time.perf_counter()
                    st, dec, _ = mon.step(st, stat)
                    _sync(where)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    decisions.append(mon.gather(dec))
            out[(case, str(where))] = {
                "decisions": decisions, "eff": mon.gather(st.eff_sends),
                "phys": mon.gather(st.phys_sends), "ms": ms}
    return out


def _mesh_monitor(dev):
    """Phase 14 (c): the mesh monitor on 4 ranks of one device (gloo)
    gives the CPU run's decisions, and the region of the global mean."""
    from repro_torch.distributed import launch

    ranks = launch.spawn(_monitor_rank, 4, timeout_s=MESH_TIMEOUT_S,
                         args=(str(dev),))
    for case, (_, _, centers, phases) in MONITOR_CASES.items():
        card, cpu = ranks[0][(case, str(dev))], ranks[0][(case, "cpu")]
        for i, (a, b) in enumerate(zip(card["decisions"],
                                       cpu["decisions"])):
            if not np.array_equal(a, b):
                raise AssertionError(f"monitor {case} step {i}: {a} on the "
                                     f"device, {b} on the CPU")
        gmean = phases[-1][0].mean(0)
        want = int(((gmean - np.asarray(centers)) ** 2).sum(1).argmin())
        last = card["decisions"][-1]
        if not (last == want).all():
            raise AssertionError(f"monitor {case}: final decisions {last}, "
                                 f"the global mean's region is {want}")
        eff, phys = float(card["eff"].sum()), float(card["phys"].sum())
        if not eff < phys:
            raise AssertionError(f"monitor {case}: eff {eff} >= phys {phys}")
        ms = card["ms"]
        print(f"[mesh] monitor {case} on 4 ranks of one device (gloo, "
              f"staged): {len(ms)} steps, decisions equal the CPU run's at "
              f"every step, final {last.tolist()} = the global mean's "
              f"region; eff_sends {eff:.0f} < phys_sends {phys:.0f}; ms a "
              f"step (rank 0, 2 rounds) median {np.median(ms):.3f} (min "
              f"{min(ms):.3f} max {max(ms):.3f}), CPU median "
              f"{np.median(cpu['ms']):.3f}", flush=True)


def phase_mesh(topos, dev):
    """The multi-process paths: (a) the collective engine at world size 1
    on NCCL, (b) at world size 2 over gloo on one device, (c) the mesh
    monitor on 4 ranks; returns the engine's launches (the
    ``engine-mesh`` path) and its median µs/cycle by ``(S, topology,
    wire)``."""
    totals = {key: 0 for key in KERNELS}
    sync_us = {}
    topos = {name: topos[name] for name in ("grid", "chord")}
    _mesh_world1(topos, dev, totals, sync_us)
    torch.cuda.empty_cache()
    _mesh_world2(topos, dev, totals, sync_us)
    _mesh_monitor(dev)
    return totals, sync_us


# --- phase 15: the rest of the engine (autotune; under a mesh the async
# ring, the audit and the layout moves) ------------------------------------

PLAN_REPEATS = 3  # timed dispatches a candidate, after one warm-up
ASYNC_STALENESS = (0, 2)  # world size 1; two ranks run STALENESS


def _spearman(a, b) -> float:
    """Spearman's rank correlation of two sequences (no ties expected)."""
    ra = np.argsort(np.argsort(np.asarray(a)))
    rb = np.argsort(np.argsort(np.asarray(b)))
    return float(np.corrcoef(ra, rb)[0, 1])


def _plan_lines(label, res, wall):
    """The plan table, each candidate's model terms, the rank correlation
    of modeled and measured, the plan's wall and its probe builds'
    share; fails unless the chosen candidate is the measured argmin."""
    from repro_torch.engine import autotune

    print(f"[autotune] {label}:\n{autotune.format_table(res)}", flush=True)
    for e in res.table:
        c = e.cand
        print(f"[autotune] {label} S={c.num_shards} K={c.k} wire={c.wire}: "
              f"modeled_us {e.modeled_us:.3f} measured_us "
              f"{e.measured_us:.3f} wire_bytes {e.wire_bytes} hbm_bytes "
              f"{e.hbm_bytes:.0f} flops {e.flops:.0f} build_s "
              f"{e.build_s:.3f}", flush=True)
    best = min(res.table, key=lambda e: e.measured_us)
    if res.chosen != best.cand or res.config.auto_plan:
        raise AssertionError(f"autotune {label}: chose {res.chosen}, the "
                             f"measured argmin is {best.cand}")
    builds = sum(e.build_s for e in res.table)
    rho = _spearman([e.modeled_us for e in res.table],
                    [e.measured_us for e in res.table])
    print(f"[autotune] {label}: chosen {tuple(res.chosen)} = the measured "
          f"argmin; Spearman(modeled, measured) {rho:.4f}; plan wall "
          f"{wall:.3f} s, probe builds {builds:.3f} s ({builds / wall:.4f} "
          f"of it)", flush=True)


def _autotune(topos, dev, totals):
    """Phase 15 (a): ``autotune.plan`` around phase 8's ``EngineConfig(8,
    10)`` on grid and Chord, measured, then on grid an engine built with
    ``auto_plan=True`` against one built directly at its adopted config:
    ``run_static``'s engine route, results and every state field equal."""
    from repro_torch.engine import autotune

    for name in ("grid", "chord"):
        topo = topos[name]
        centers, _, _, _ = sim._setup(topo, sim.ProblemSpec(n=topo.n), dev)
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = autotune.plan(topo, centers, base=_engine_cfg(), measure=True,
                            repeats=PLAN_REPEATS, device=dev)
        wall = time.perf_counter() - t0
        counts = kernels.counts()
        # The probes dispatch and never observe: no global decision.
        _require_launched(f"autotune {name}", counts,
                          ("lss_state", "correction"))
        for key in KERNELS:
            totals[key] += counts[key]
        _plan_lines(f"{name} n={topo.n}", res, wall)
        del res
        torch.cuda.empty_cache()
    topo = topos["grid"]
    kernels.reset_counts()
    t0 = time.perf_counter()
    drv = _set_up(topo, dev, _engine_cfg(auto_plan=True))
    built = time.perf_counter() - t0
    got = sim._run_to_quiescence(drv, topo, MAX_CYCLES, 1)
    _sync(dev)
    counts = kernels.counts()
    _require_launched("autotune auto_plan grid", counts)
    for key in KERNELS:
        totals[key] += counts[key]
    adopted = drv._eng.ecfg
    cand = (adopted.num_shards, adopted.halo_slack,
            adopted.cycles_per_dispatch, adopted.wire)
    if adopted.auto_plan or cand not in autotune.default_candidates(
            _engine_cfg()):
        raise AssertionError(f"auto_plan grid: adopted {adopted}")
    direct = _set_up(topo, dev, adopted)
    want = sim._run_to_quiescence(direct, topo, MAX_CYCLES, 1)
    if got != want or _digests(drv._eng, drv._st) != _digests(
            direct._eng, direct._st):
        raise AssertionError(f"auto_plan grid: {_diffs(got, want)} or the "
                             f"states differ from the direct engine's")
    print(f"[autotune] grid auto_plan=True: built (planned) in {built:.3f} "
          f"s, adopted {cand}, run_static's engine route {got['cycles_100']}"
          f" cycles to 100 %, quiesced at {got['quiesced_at']}, msgs/link "
          f"{got['msgs_per_link']!r}: results and every state field equal "
          f"to an engine built at that config; launches {counts}",
          flush=True)
    _check_engine_kernels("autotune grid (the adopted plan)", drv._eng,
                          drv._eng.init(sim._setup(
                              topo, sim.ProblemSpec(n=topo.n), dev)[3],
                              seed=0))


def _lockstep(eng, st, dev):
    """One untimed and ``MESH_TIMED`` timed dispatches of K cycles, the
    digests after each (outside the timing): (state, µs a cycle of each
    timed dispatch, digests)."""
    us, digests = [], []
    for i in range(MESH_TIMED + 1):
        _sync(dev)
        t0 = time.perf_counter()
        st = eng.run(st, MESH_K)
        _sync(dev)
        if i:
            us.append((time.perf_counter() - t0) * 1e6 / MESH_K)
        digests.append(_digests(eng, st))
    return st, us, digests


def _audited(label, eng, st):
    """The audit of ``st``: its dict, failing unless every monitor holds
    (the stale-drop books reconciled with ``async_lag_stats``)."""
    raw = eng.audit(st)
    drops = eng.async_lag_stats(st)["stale_drops"]
    rep = obs_audit.evaluate(raw, stale_drops_metric=drops)
    if not rep.ok:
        raise AssertionError(f"audit {label}: {rep.monitors} {raw}")
    return raw


def _async_world1(topos, dev, totals, sync_us):
    """Phase 15 (b, c) at world size 1 on NCCL (S = 1): the async engine
    on the mesh in lockstep with the single-process async engine at S = 1,
    bitwise after every dispatch; the audits equal and clean."""
    import os
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # before the mesh: NCCL's device
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        try:
            mesh = init_device_mesh(dev.type, (1,),
                                    mesh_dim_names=("shards",))
            for name, topo in topos.items():
                for stale in ASYNC_STALENESS:
                    label = f"async-{stale} S=1 {name}"
                    eng, st0 = _mesh_engine(topo, dev, 1, "exact", mesh,
                                            async_mode=True, staleness=stale)
                    kernels.reset_counts()
                    st, us, got = _lockstep(eng, _replay_state(st0), dev)
                    _sync(dev)
                    counts = kernels.counts()
                    _require_launched(label, counts)
                    for key in KERNELS:
                        totals[key] += counts[key]
                    ref, ref0 = _mesh_engine(topo, dev, 1, "exact",
                                             async_mode=True,
                                             staleness=stale)
                    ref_st, ref_us, want = _lockstep(ref, ref0, dev)
                    bad = [i for i, (g, w) in enumerate(zip(got, want))
                           if g != w]
                    if bad:
                        raise AssertionError(f"{label}: differs from the "
                                             f"fallback after dispatches "
                                             f"{bad}")
                    audit = _audited(label, eng, st)
                    if audit != _audited(label, ref, ref_st):
                        raise AssertionError(f"{label}: audit differs")
                    sync = sync_us.get((1, name, "exact"), float("nan"))
                    print(f"[mesh-async] {name} n={topo.n} staleness "
                          f"{stale} S=1 {backend} world 1: every field, the "
                          f"books and the ring, msgs and metrics bitwise the "
                          f"async engine's after each of {MESH_TIMED + 1} "
                          f"dispatches (metrics {want[-1]['metrics'][:2]}, "
                          f"msgs {want[-1]['total_msgs']}); us_per_cycle "
                          f"median {np.median(us):.1f} (min {min(us):.1f} "
                          f"max {max(us):.1f}), async engine "
                          f"{np.median(ref_us):.1f}, phase 14's sync mesh "
                          f"{sync:.1f}; audit equal, every monitor "
                          f"holds ({audit}); launches {counts}", flush=True)
                    _check_engine_kernels(label, eng, st0)
                    del eng, st, ref, ref_st
                    torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()


def _async_rank(rank, world, topos, dev):
    """Phase 15 (b, c, d) on one rank of a gloo mesh: the async engine
    (staleness ``STALENESS``) on each topology and wire, digests after
    each dispatch and the audit; then on each topology a rebalance
    (``migrate_from`` a BFS onto a stride partition, S = 2, after two
    dispatches) and ``MESH_K`` cycles on it, digests after each."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.engine import ShardedLSS

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("shards",))
    out = {}
    for name, topo in topos.items():
        for wire in MESH_WIRES:
            eng, st0 = _mesh_engine(topo, dev, world, wire, mesh,
                                   async_mode=True, staleness=STALENESS)
            kernels.reset_counts()
            st, us, digests = _lockstep(eng, _replay_state(st0), dev)
            audit = _audited(f"mesh-async rank {rank} {name} {wire}", eng,
                             st)
            _sync(dev)
            out[(name, wire)] = {
                "digests": digests, "us": us, "counts": kernels.counts(),
                "audit": audit, "staged_per_cycle": eng.staged_bytes / (
                    MESH_K * (MESH_TIMED + 1)),
                "pair_bytes": int(eng.wire_pair_bytes(2)[rank].sum())}
            _check_engine_kernels(f"mesh-async S={world} rank {rank} {name} "
                                  f"{wire}", eng, st0)
            del eng, st, st0
        old, st = _mesh_engine(topo, dev, world, "exact", mesh)
        new = ShardedLSS(topo, old.centers, old.cfg,
                         old.ecfg._replace(method="stride"),
                         device=dev).use_mesh(mesh, "shards")
        kernels.reset_counts()
        moved = new.migrate_from(old, old.run(st, 2 * MESH_K))
        after = new.run(moved, MESH_K)
        _sync(dev)
        out[(name, "migrate")] = {
            "digests": [_digests(new, moved), _digests(new, after)],
            "counts": kernels.counts()}
        del old, new, st, moved, after
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _async_world2(topos, dev, totals, sync_us):
    """Phase 15 (b, c, d) on two ranks of one device over gloo (S = 2),
    each held to the single-process engine at S = 2 run here."""
    from repro_torch.distributed import launch
    from repro_torch.engine import ShardedLSS

    ranks = launch.spawn(_async_rank, 2, timeout_s=MESH_TIMEOUT_S,
                         args=(topos, str(dev)))
    for name, topo in topos.items():
        for wire in MESH_WIRES:
            label = f"async-{STALENESS} S=2 {name} {wire}"
            ref, ref0 = _mesh_engine(topo, dev, 2, wire, async_mode=True,
                                     staleness=STALENESS)
            ref_st, ref_us, want = _lockstep(ref, ref0, dev)
            audit = _audited(label, ref, ref_st)
            runs = [r[(name, wire)] for r in ranks]
            for rank, run in enumerate(runs):
                bad = [i for i, (g, w) in enumerate(zip(run["digests"], want))
                       if g != w]
                if bad or len(run["digests"]) != len(want):
                    raise AssertionError(f"{label} rank {rank}: differs from "
                                         f"the fallback after dispatches "
                                         f"{bad}")
                if run["audit"] != audit:
                    raise AssertionError(f"{label} rank {rank}: audit "
                                         f"{run['audit']} != {audit}")
                _require_launched(f"{label} rank {rank}", run["counts"])
                for key in KERNELS:
                    totals[key] += run["counts"][key]
            lag = ref.async_lag_stats(ref_st)
            us = runs[0]["us"]
            print(f"[mesh-async] {name} n={topo.n} staleness {STALENESS} S=2 "
                  f"gloo world 2 on one device, wire {wire}: every field, "
                  f"the books and the rings, msgs and metrics bitwise the "
                  f"async engine's on both ranks after each of "
                  f"{MESH_TIMED + 1} dispatches (metrics "
                  f"{want[-1]['metrics'][:2]}, msgs {want[-1]['total_msgs']},"
                  f" lag {lag}); audit equal on both ranks, every monitor "
                  f"holds; rank 0 us_per_cycle median "
                  f"{np.median(us):.1f} (min {min(us):.1f} max "
                  f"{max(us):.1f}), rank 1 median "
                  f"{np.median(runs[1]['us']):.1f}; async engine S=2 median "
                  f"{np.median(ref_us):.1f}; phase 14's sync mesh S=2 "
                  f"{sync_us.get((2, name, wire), float('nan')):.1f}; "
                  f"staged bytes a cycle rank 0 "
                  f"{runs[0]['staged_per_cycle']:.0f} rank 1 "
                  f"{runs[1]['staged_per_cycle']:.0f}; modeled "
                  f"wire_pair_bytes a cycle rank 0 {runs[0]['pair_bytes']} "
                  f"rank 1 {runs[1]['pair_bytes']}; launches rank 0 "
                  f"{runs[0]['counts']} rank 1 {runs[1]['counts']}",
                  flush=True)
            del ref, ref_st, ref0
            torch.cuda.empty_cache()
        old, st = _mesh_engine(topo, dev, 2, "exact")
        new = ShardedLSS(topo, old.centers, old.cfg,
                         old.ecfg._replace(method="stride"), device=dev)
        moved = new.migrate_from(old, old.run(st, 2 * MESH_K))
        want = [_digests(new, moved), _digests(new, new.run(moved, MESH_K))]
        for rank, r in enumerate(ranks):
            run = r[(name, "migrate")]
            if run["digests"] != want:
                raise AssertionError(f"migrate S=2 {name} rank {rank}: "
                                     f"differs from the fallback's")
            _require_launched(f"migrate S=2 {name} rank {rank}",
                              run["counts"])
            for key in KERNELS:
                totals[key] += run["counts"][key]
        print(f"[mesh-layout] {name} n={topo.n} S=2 gloo world 2: "
              f"migrate_from the BFS onto a stride partition after "
              f"{2 * MESH_K} cycles, and {MESH_K} cycles after it, bitwise "
              f"the fallback's on both ranks (cut edges {old._cuts.sum() // 2}"
              f" -> {new._cuts.sum() // 2}; metrics "
              f"{want[-1]['metrics'][:2]}); launches rank 0 "
              f"{ranks[0][(name, 'migrate')]['counts']}", flush=True)
        del old, new, st, moved
        torch.cuda.empty_cache()


def phase_engine_rest(topos, dev, sync_us):
    """The rest of the engine: (a) the autotuner, (b)-(c) the async ring
    and its audit with one shard a process (timed beside phase 14's
    ``sync_us``), (d) a rebalance under the mesh; returns the launches of
    (a) (``autotune``) and of (b)-(d) (``engine-mesh-async``)."""
    plan_totals = {key: 0 for key in KERNELS}
    mesh_totals = {key: 0 for key in KERNELS}
    topos = {name: topos[name] for name in ("grid", "chord")}
    _autotune(topos, dev, plan_totals)
    torch.cuda.empty_cache()
    _async_world1(topos, dev, mesh_totals, sync_us)
    _async_world2(topos, dev, mesh_totals, sync_us)
    return plan_totals, mesh_totals


# --- phase 16: the model zoo (A.10a) on the card ---------------------------

ZOO_STEPS = 8  # (a): decode steps after the smoke prefill
ZOO_SMOKE_PROMPT, ZOO_SMOKE_CACHE = 40, 64  # past mixtral-smoke's window
ZOO_PROMPT = 4096  # (b): configs.SHAPES' train_4k length (chunked attention)
ZOO_DECODE = 32  # (b): greedy decode steps, timed after one untimed
ZOO_TF_PROMPT = 4160  # (c): past mixtral's 4,096 window: its ring runs
ZOO_TF_ARCHS = ("qwen3-14b", "mixtral-8x7b", "mamba2-370m", "zamba2-2.7b")
ZOO_PROFILED = ("qwen3-14b", "mixtral-8x7b", "zamba2-2.7b")  # (b): traced
ZOO_PROFILED_STEPS = 8  # decode steps under the profiler
ZOO_TOL = 1e-4  # (a): card against the CPU, float32
ZOO_TF_TOL = 2e-2  # (c): tests/test_models.py's decode-vs-teacher tolerance


def _zoo_cut(cfg):
    """Published widths, depth cut: (config, the cut as printed)."""
    import dataclasses

    from repro_torch.models import EncDecConfig

    if isinstance(cfg, EncDecConfig):
        return (dataclasses.replace(cfg, n_enc=2, n_dec=2),
                f"n_enc=n_dec=2 of {cfg.n_enc}/{cfg.n_dec}")
    if cfg.block == "hybrid":  # one shared-attention group
        return (dataclasses.replace(cfg, n_layers=cfg.attn_every),
                f"n_layers={cfg.attn_every} of {cfg.n_layers} (one group)")
    return (dataclasses.replace(cfg, n_layers=2),
            f"n_layers=2 of {cfg.n_layers}")


def _attn_pairs(new, past, window):
    """Query-key pairs a causal attention of ``new`` queries after ``past``
    cached positions scores (within ``window`` when nonzero)."""
    keys = np.arange(past + 1, past + new + 1, dtype=np.int64)
    if window:
        keys = np.minimum(keys, window)
    return int(keys.sum())


def _zoo_flops(cfg, new, past, enc_len=0):
    """Matrix-product flops of one prefill of ``new`` tokens after ``past``
    cached ones (a decode step: ``new`` = 1): 2 a weight a token for the
    weights the tokens use (the experts they are routed to), 4 H dh a
    scored query-key pair, the SSD's chunked contractions, and the head
    for the one row of logits these calls return.  The embedding is a
    gather, no flops."""
    from repro_torch.models import EncDecConfig

    D, V = cfg.d_model, cfg.vocab
    head = 2 * D * V
    if isinstance(cfg, EncDecConfig):
        H, dh, F = cfg.n_heads, cfg.d_head, cfg.d_ff
        per = (2 * (4 * D * H * dh + 2 * D * H * dh + 2 * D * F) * new
               + 4 * H * dh * (_attn_pairs(new, past, 0) + new * enc_len))
        return cfg.n_dec * per + head

    def attn():
        H, K, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
        return (2 * (D * (H + 2 * K) * dh + H * dh * D) * new
                + 4 * H * dh * _attn_pairs(new, past, cfg.window))

    def ffn(d_ff):
        return 2 * 3 * D * d_ff * new

    def ssm_layer():
        s = cfg.ssm
        H, P, N, G = s.n_heads, s.headdim, s.d_state, s.n_groups
        proj = D * (2 * s.d_inner + 2 * G * N + H) + s.d_inner * D
        if new == 1:  # the recurrence
            mix = 6 * H * P * N
        else:  # the chunked dual form at the chunk fwd_train picks
            Q = min(s.chunk, new)
            while new % Q:
                Q -= 1
            mix = 2 * new * Q * (G * N + H * P) + 4 * new * H * P * N
        return 2 * proj * new + 2 * s.conv_kernel * s.conv_dim * new + mix

    if cfg.block == "dense":
        per = (attn() + ffn(cfg.d_ff)) * cfg.n_layers
    elif cfg.block == "moe":
        m = cfg.moe
        per = (attn() + 2 * D * m.n_experts * new
               + ffn(m.d_ff) * m.top_k) * cfg.n_layers
    elif cfg.block == "ssm":
        per = ssm_layer() * cfg.n_layers
    else:  # hybrid: the shared block once a group
        per = (ssm_layer() * cfg.n_layers
               + (attn() + ffn(cfg.d_ff)) * cfg.n_groups)
    return per + head


def _zoo_decode_bytes(cfg, past, enc_len=0):
    """Bytes one bf16 decode step after ``past`` cached tokens must move:
    the weights the token uses (the routed experts; the head, not the
    embedding table), each read once, and the caches it reads (K/V of
    the visible positions, the cross K/V, the SSM states read and
    written in float32)."""
    from repro_torch.models import EncDecConfig

    D, V = cfg.d_model, cfg.vocab
    if isinstance(cfg, EncDecConfig):
        H, dh = cfg.n_heads, cfg.d_head
        weights = cfg.n_dec * (6 * D * H * dh + 2 * D * cfg.d_ff) + V * D
        cache = cfg.n_dec * 2 * H * dh * (past + 1 + enc_len)
        return 2 * (weights + cache)
    emb = V * D * (1 if cfg.tie_embed else 2)
    weights = cfg.active_param_count() - emb + V * D
    nbytes = 2 * weights
    if cfg.block != "ssm":
        n_attn = cfg.n_groups if cfg.block == "hybrid" else cfg.n_layers
        keys = min(past + 1, cfg.window) if cfg.window else past + 1
        nbytes += 2 * n_attn * 2 * keys * cfg.n_kv * cfg.d_head
    if cfg.block in ("ssm", "hybrid"):
        s = cfg.ssm
        nbytes += cfg.n_layers * 2 * 4 * s.n_heads * s.headdim * s.d_state
    return nbytes


def _zoo_inputs(cfg, dev, gen, batch, length):
    from repro_torch.models import EncDecConfig

    toks = torch.randint(0, cfg.vocab, (batch, length), generator=gen,
                         device=dev)
    frames = None
    if isinstance(cfg, EncDecConfig):
        frames = torch.randn((batch, cfg.enc_len, cfg.d_model), generator=gen,
                             device=dev)
    return toks, frames


def _zoo_cache(model, params, frames, batch, max_len):
    if frames is None:
        return model.init_cache(batch, max_len)
    return model.init_cache(params, model.encode(params, frames), batch,
                            max_len)


def _zoo_run(model, params, toks, frames, prompt, steps):
    """Logits and loss of the whole sequence (``loss`` alone for the
    enc-dec), then prefill of ``prompt`` tokens and ``steps`` decode steps
    teacher-forced: every output as a list of tensors."""
    outs = []
    labels = torch.roll(toks, -1, dims=1)
    if frames is None:
        outs.append(model.logits_train(params, toks)[0])
        outs.append(model.loss(params, toks, labels)[0])
    else:
        outs.append(model.encode(params, frames))
        outs.append(model.loss(params, frames, toks, labels)[0])
    cache = _zoo_cache(model, params, frames, toks.shape[0],
                       ZOO_SMOKE_CACHE)
    logits, cache = model.prefill(params, toks[:, :prompt], cache)
    outs.append(logits)
    for t in range(prompt, prompt + steps):
        logits, cache = model.decode_step(params, toks[:, t], cache)
        outs.append(logits)
    outs.extend(f for part in cache for f in
                (part if isinstance(part, tuple) else (part,))
                if isinstance(f, torch.Tensor))
    return outs


def _zoo_smoke(dev):
    """(a) every arch's smoke config (float32) on the card against the same
    port code on the CPU, from the same parameters and inputs."""
    import copy

    from repro_torch import configs
    from repro_torch.models import build

    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke(arch)
        gen = torch.Generator().manual_seed(16)
        cpu_model = build(cfg, "cpu")
        params = cpu_model.init(gen)
        toks, frames = _zoo_inputs(cfg, torch.device("cpu"), gen, 2,
                                   ZOO_SMOKE_PROMPT + ZOO_STEPS)
        want = _zoo_run(cpu_model, params, toks, frames, ZOO_SMOKE_PROMPT,
                        ZOO_STEPS)
        got = _zoo_run(build(cfg, dev), copy.deepcopy(params).to(dev),
                       toks.to(dev), None if frames is None
                       else frames.to(dev), ZOO_SMOKE_PROMPT, ZOO_STEPS)
        err = 0.0
        for g, w in zip(got, want, strict=True):
            g = g.cpu()
            if not torch.allclose(g.float(), w.float(), rtol=ZOO_TOL,
                                  atol=ZOO_TOL) or g.dtype != w.dtype:
                raise AssertionError(f"zoo {arch} smoke: the card differs "
                                     f"from the CPU")
            err = max(err, float((g.float() - w.float()).abs().max()))
        print(f"[zoo-smoke] {arch} ({cfg.name}): logits/loss, prefill "
              f"{ZOO_SMOKE_PROMPT}, {ZOO_STEPS} decode steps and "
              f"{len(got) - ZOO_STEPS - 3} cache tensors on the card == the "
              f"CPU (float32, max abs err {err:.3g}, tol {ZOO_TOL})",
              flush=True)


def _timed(dev, fn):
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _zoo_profile(arch, dev, model, params, toks, frames, max_len, pf_ms,
                 tok_ms):
    """One prefill and ``ZOO_PROFILED_STEPS`` decode steps under
    ``torch.profiler``: device time by kernel, device events a token and
    the idle share of each profiled run."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    cache = _zoo_cache(model, params, frames, 1, max_len)
    box = {}

    def prefill():
        box["logits"], box["cache"] = model.prefill(params, toks, cache)

    def decode():
        tok = torch.argmax(box["logits"], -1).to(torch.int32)
        c = box["cache"]
        for _ in range(ZOO_PROFILED_STEPS):
            lg, c = model.decode_step(params, tok, c)
            tok = torch.argmax(lg, -1).to(torch.int32)

    for name, fn, steps, unprof in (("prefill", prefill, 1, pf_ms),
                                    ("decode", decode, ZOO_PROFILED_STEPS,
                                     tok_ms * ZOO_PROFILED_STEPS)):
        _sync(dev)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = (time.perf_counter() - t0) * 1e3
        got = _print_profile(f"zoo {arch} {name}", prof, wall, unprof,
                             steps, "token" if name == "decode" else name)
        out[f"{name}_idle_profiled"] = None if got is None else got["idle"]
        out[f"{name}_device_events"] = None if got is None else got["events"]
    return out


def _zoo_full(dev, gpu):
    """(b) every arch at its published widths, depth cut, in bf16: a
    (1, 4096) prefill and 32 greedy decode steps, timed; returns the rows."""
    from repro_torch import configs
    from repro_torch.models import EncDecConfig, build

    rows = []
    for arch in configs.ARCH_IDS:
        cfg, cut = _zoo_cut(configs.get(arch))
        model = build(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        params = model.init(gen)
        n_params = sum(p.numel() for p in params.parameters())
        toks, frames = _zoo_inputs(cfg, dev, gen, 1, ZOO_PROMPT)
        max_len = ZOO_PROMPT + max(ZOO_DECODE, ZOO_PROFILED_STEPS) + 2
        enc_len = cfg.enc_len if isinstance(cfg, EncDecConfig) else 0
        torch.cuda.reset_peak_memory_stats()
        cache0, enc_ms = _timed(dev, lambda: _zoo_cache(
            model, params, frames, 1, max_len))
        model.prefill(params, toks, cache0)  # untimed: first launches
        (logits, cache), pf_ms = _timed(
            dev, lambda: model.prefill(params, toks, cache0))
        del cache0
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = model.decode_step(params, tok, cache)  # untimed
        tok = torch.argmax(logits, -1).to(torch.int32)

        def decode(tok=tok, cache=cache):
            out = []
            for _ in range(ZOO_DECODE):
                lg, cache = model.decode_step(params, tok, cache)
                tok = torch.argmax(lg, -1).to(torch.int32)
                out.append(tok)
            return torch.stack(out, 1), lg

        (gen_toks, last), dec_ms = _timed(dev, decode)
        peak = torch.cuda.max_memory_allocated()
        if not (torch.isfinite(logits.float()).all()
                and torch.isfinite(last.float()).all()):
            raise AssertionError(f"zoo {arch}: non-finite logits")
        if not ((gen_toks >= 0) & (gen_toks < cfg.vocab)).all():
            raise AssertionError(f"zoo {arch}: a token out of the vocab")
        pf_flops = _zoo_flops(cfg, ZOO_PROMPT, 0, enc_len)
        dec_flops = sum(_zoo_flops(cfg, 1, ZOO_PROMPT + 1 + j, enc_len)
                        for j in range(ZOO_DECODE))
        dec_bytes = sum(_zoo_decode_bytes(cfg, ZOO_PROMPT + 1 + j, enc_len)
                        for j in range(ZOO_DECODE))
        dec_bound_ms = max(dec_bytes / kcost.HBM_BYTES_PER_S,
                           dec_flops / kcost.BF16_OPS_PER_S) * 1e3
        row = {"arch": arch, "cut": cut, "params": n_params,
               "prefill_ms": pf_ms,
               "prefill_share_bf16": pf_flops / (pf_ms * 1e-3
                                                 * kcost.BF16_OPS_PER_S),
               "decode_ms_per_token": dec_ms / ZOO_DECODE,
               "decode_share_bf16": dec_flops / (dec_ms * 1e-3
                                                 * kcost.BF16_OPS_PER_S),
               "decode_bound_ms_per_token": dec_bound_ms / ZOO_DECODE,
               "decode_share_of_bound": dec_bound_ms / dec_ms,
               "peak_gb": peak / 1e9, "prefill_tflop": pf_flops / 1e12}
        if frames is not None:
            row["encode_and_cross_kv_ms"] = enc_ms
        if arch in ZOO_PROFILED:
            row.update(_zoo_profile(arch, dev, model, params, toks, frames,
                                    max_len, pf_ms, dec_ms / ZOO_DECODE))
        rows.append(row)
        print(f"[zoo] {arch} bf16, {cut}, {n_params / 1e9:.3f} B params: "
              f"prefill (1, {ZOO_PROMPT}) {pf_ms:.3f} ms "
              f"({pf_flops / 1e12:.3f} TFLOP, share of the bf16 peak "
              f"{row['prefill_share_bf16']:.4f}); decode "
              f"{row['decode_ms_per_token']:.3f} ms/token over {ZOO_DECODE} "
              f"greedy steps (share of the bf16 peak "
              f"{row['decode_share_bf16']:.5f}; of its byte bound "
              f"{row['decode_bound_ms_per_token']:.3f} ms: "
              f"{row['decode_share_of_bound']:.4f}); peak "
              f"{row['peak_gb']:.2f} GB"
              + (f"; encoder + cross K/V {enc_ms:.3f} ms"
                 if frames is not None else "") + f"; {gpu}", flush=True)
        del model, params, cache, logits, last
        torch.cuda.empty_cache()
    return rows


def _zoo_teacher(dev):
    """(c) float32 at published widths (depth cut): one decode step after a
    4,160-token prefill equals ``logits_train`` at that position (mixtral
    past its window: ring prefill and ring decode).  The MoE's capacity
    factor is raised to n_experts / top_k, so no token drops."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build

    for arch in ZOO_TF_ARCHS:
        cfg, cut = _zoo_cut(configs.get(arch))
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        if cfg.moe is not None:
            cf = cfg.moe.n_experts / cfg.moe.top_k
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
            cut += f", capacity_factor {cf:g} (no drops)"
        model = build(cfg, dev)
        gen = torch.Generator(device=dev).manual_seed(16)
        params = model.init(gen)
        L = ZOO_TF_PROMPT
        toks, _ = _zoo_inputs(cfg, dev, gen, 1, L + 1)
        want = model.logits_train(params, toks)[0][:, L - 1:].clone()
        cache = model.init_cache(1, L + 8)
        ring = cache.kv is not None and cache.kv.k.shape[2] < L
        logits_pf, cache = model.prefill(params, toks[:, :L], cache)
        logits_dec, cache = model.decode_step(params, toks[:, L], cache)
        errs = []
        for got, ref_ in ((logits_pf, want[:, 0]), (logits_dec, want[:, 1])):
            if not torch.allclose(got, ref_, rtol=ZOO_TF_TOL, atol=ZOO_TF_TOL):
                raise AssertionError(f"zoo {arch}: decode differs from "
                                     f"teacher forcing")
            errs.append(float((got - ref_).abs().max()))
        print(f"[zoo-teacher] {arch} float32, {cut}: prefill {L} + 1 decode "
              f"step == logits_train at {L - 1} and {L} (max abs err "
              f"{errs[0]:.3g}, {errs[1]:.3g}; tol {ZOO_TF_TOL})"
              + (f"; ring cache of {cache.kv.k.shape[2]} slots" if ring
                 else ""), flush=True)
        del model, params, cache, want
        torch.cuda.empty_cache()


def phase_zoo(dev, gpu):
    """The model zoo: (a) smoke configs card == CPU, (b) published widths
    in bf16, timed, (c) decode against teacher forcing in float32.  The
    models launch none of the three kernels: the counters, zeroed before,
    must read 0 after.  Returns (b)'s rows."""
    kernels.reset_counts()
    with torch.inference_mode():
        _zoo_smoke(dev)
        rows = _zoo_full(dev, gpu)
        _zoo_teacher(dev)
    _sync(dev)
    counts = kernels.counts()
    if any(counts[key] for key in KERNELS):
        raise AssertionError(f"zoo: the models launched a kernel: {counts}")
    print(f"[zoo] launches of {', '.join(KERNELS)} over phase 16: "
          f"{', '.join(str(counts[key]) for key in KERNELS)}", flush=True)
    return rows


# --- phase 17: the single-process training path (A.10b) on the card --------

TRAIN_TOL = 1e-4  # (a): loss / gnorm rtol; m / v rtol and leaf-relative atol
TRAIN_MOM_ATOL = 1e-9  # (a): m / v atol floor (whisper's key biases: grads
#                        of rounding noise alone, as softmax ignores them)
TRAIN_GRAD_TOL = (1e-4, 1e-6)  # the grads' noise: leaf-relative, absolute
TRAIN_NOISE = 10.0  # (a): parameters compared where |g| > 10x that noise
TRAIN_PARAM_TOL = (1e-5, 1e-6)  # (a): rtol, atol of the parameters (lr 1e-3)
TRAIN_TRAINER_STEPS, TRAIN_FAULT_AT = 30, 17  # (b)
TRAIN_LEN = 4096  # (d): configs.SHAPES' train_4k length; global batch 1
TRAIN_TIMED = 3  # (d): timed steps after one untimed
TRAIN_FULL = ("qwen3-14b", "mamba2-370m")  # (d): 2 layers; whole


def _train_batch(cfg, gen, rows, length):
    from repro_torch.models import EncDecConfig

    out = {"tokens": torch.randint(0, cfg.vocab, (rows, length),
                                   generator=gen, dtype=torch.int32),
           "labels": torch.randint(0, cfg.vocab, (rows, length),
                                   generator=gen, dtype=torch.int32)}
    if isinstance(cfg, EncDecConfig):
        out["frames"] = torch.randn((rows, cfg.enc_len, cfg.d_model),
                                    generator=gen)
    return out


def _leaf_err(label, got, want, rtol, leaf_atol, atol=0.0):
    """Largest |got - want| of two like trees (``got`` on the card), each
    leaf held to rtol and ``leaf_atol`` of its largest |value| (or
    ``atol``, where larger)."""
    from repro_torch import tree

    err = 0.0
    for name, g, w in zip(*tree.leaves_with_names(got), tree.leaves(want),
                          strict=False):
        g, w = g.detach().cpu().float(), w.detach().float()
        tol = max(atol, leaf_atol * float(w.abs().max()))
        if not torch.allclose(g, w, rtol=rtol, atol=tol):
            raise AssertionError(f"{label}{name}: the card differs from the "
                                 f"CPU (max abs err "
                                 f"{float((g - w).abs().max()):.3g})")
        err = max(err, float((g - w).abs().max()))
    return err


def _train_smoke(dev):
    """(a) one train step of every smoke arch on the card against the CPU."""
    import copy

    from repro_torch import configs, tree
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import (TrainHParams, build_for_cell,
                                      loss_and_grads)

    hp = TrainHParams(lr=1e-3, warmup=0, accum_steps=2)
    cell = configs.ShapeCell("t", "train", 32, 4)
    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke(arch)
        gen = torch.Generator().manual_seed(17)
        cpu_model = build(cfg, "cpu")
        params = cpu_model.init(gen)
        batch = _train_batch(cfg, gen, cell.global_batch, cell.seq_len)
        dev_params = copy.deepcopy(params).to(dev)
        grads = loss_and_grads(cpu_model, params, batch, hp.accum_steps)[2]
        p_c, o_c, m_c = build_for_cell(cpu_model, None, cell, hp)[0](
            params, adamw_init(params), batch)
        p_d, o_d, m_d = build_for_cell(build(cfg, dev), None, cell, hp)[0](
            dev_params, adamw_init(dev_params),
            {k: v.to(dev) for k, v in batch.items()})
        for key in ("loss", "gnorm"):
            if not torch.allclose(m_d[key].cpu(), m_c[key], rtol=TRAIN_TOL,
                                  atol=0.0):
                raise AssertionError(f"train {arch}: {key} "
                                     f"{float(m_d[key])} on the card, "
                                     f"{float(m_c[key])} on the CPU")
        if int(o_d.step) != 1:
            raise AssertionError(f"train {arch}: opt.step {int(o_d.step)}")
        err = max(_leaf_err(f"train {arch} m", o_d.m, o_c.m, TRAIN_TOL,
                            TRAIN_TOL, TRAIN_MOM_ATOL),
                  _leaf_err(f"train {arch} v", o_d.v, o_c.v, TRAIN_TOL,
                            TRAIN_TOL, TRAIN_MOM_ATOL))
        kept = total = 0
        p_err = 0.0
        for name, pd, pc, g in zip(*tree.leaves_with_names(p_d),
                                   tree.leaves(p_c), tree.leaves(grads)):
            g = g.abs()
            noise = max(TRAIN_GRAD_TOL[1],
                        TRAIN_GRAD_TOL[0] * float(g.max()))
            sure = g > TRAIN_NOISE * noise
            got, want = pd.detach().cpu()[sure], pc.detach()[sure]
            if not torch.allclose(got, want, rtol=TRAIN_PARAM_TOL[0],
                                  atol=TRAIN_PARAM_TOL[1]):
                raise AssertionError(f"train {arch} params{name}: the card "
                                     f"differs from the CPU")
            if got.numel():
                p_err = max(p_err, float((got - want).abs().max()))
            kept += int(sure.sum())
            total += g.numel()
        if kept < total // 2:
            raise AssertionError(f"train {arch}: only {kept} of {total} "
                                 f"parameters above the grads' noise")
        print(f"[train-smoke] {arch} ({cfg.name}) float32, accum 2: loss "
              f"{float(m_d['loss']):.6f} (CPU {float(m_c['loss']):.6f}), "
              f"gnorm {float(m_d['gnorm']):.6f} (CPU "
              f"{float(m_c['gnorm']):.6f}), m/v max abs err {err:.3g}, "
              f"params max abs err {p_err:.3g} at {kept} of {total} "
              f"coordinates (the rest within the grads' noise); card == "
              f"CPU (tol {TRAIN_TOL})", flush=True)


def _train_ckpt_dir(name):
    import shutil

    path = ROOT / "build" / "chip_smoke_ckpt" / name
    shutil.rmtree(path, ignore_errors=True)
    return path


def _train_trainer(dev):
    """(b) ``Trainer`` on the card with an injected fault."""
    import shutil

    from repro_torch import checkpoint, configs
    from repro_torch.data import TokenSource, make_batch_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import (Trainer, TrainerConfig, TrainHParams,
                                      build_for_cell)

    cfg = configs.get_smoke("yi-9b")
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    step = build_for_cell(model, None, configs.ShapeCell("t", "train", 64, 8),
                          TrainHParams(lr=3e-3, warmup=5,
                                       total_steps=100))[0]
    batches = make_batch_fn(TokenSource(vocab=cfg.vocab, seq_len=64,
                                        global_batch=8, seed=0), device=dev)
    ckpt = _train_ckpt_dir("trainer")
    armed = [True]

    def fault(s):
        if s == TRAIN_FAULT_AT and armed[0]:
            armed[0] = False
            raise RuntimeError("injected device failure")

    trainer = Trainer(
        TrainerConfig(total_steps=TRAIN_TRAINER_STEPS, ckpt_every=10,
                      ckpt_dir=str(ckpt), log_every=1),
        lambda p, o, b: step(p, o, {"tokens": b.tokens, "labels": b.labels}),
        batches)
    t0 = time.perf_counter()
    _, opt = trainer.run(params, adamw_init(params), fault_injector=fault)
    _sync(dev)
    wall = time.perf_counter() - t0
    events = [r for r in trainer.metrics_log if "event" in r]
    losses = [r["loss"] for r in trainer.metrics_log if "event" not in r]
    latest = checkpoint.latest_step(ckpt)
    shutil.rmtree(ckpt, ignore_errors=True)
    if [(r["event"], r["step"]) for r in events] != [("restored", 10)]:
        raise AssertionError(f"trainer: events {events}")
    if int(opt.step) != TRAIN_TRAINER_STEPS or latest != TRAIN_TRAINER_STEPS:
        raise AssertionError(f"trainer: ended at opt.step {int(opt.step)}, "
                             f"LATEST {latest}")
    if not (np.all(np.isfinite(losses))
            and np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2):
        raise AssertionError(f"trainer: the loss did not fall: {losses}")
    print(f"[train-trainer] yi-9b smoke on the card: {TRAIN_TRAINER_STEPS} "
          f"steps, RuntimeError injected at step {TRAIN_FAULT_AT}, "
          f"'restored' from step 10, ended at step {int(opt.step)} (LATEST "
          f"{latest}); loss {np.mean(losses[:5]):.4f} over the first 5 "
          f"logged steps, {np.mean(losses[-5:]):.4f} over the last 5; "
          f"{wall:.1f} s", flush=True)


def _train_resume(dev):
    """(c) save, load and two more steps land bitwise on the run that was
    not interrupted (deterministic algorithms on)."""
    import shutil

    from repro_torch import checkpoint, configs, tree
    from repro_torch.data import TokenSource, make_batch_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    cfg = configs.get_smoke("mamba2-370m")
    model = build(cfg, dev)
    step = build_for_cell(model, None, configs.ShapeCell("t", "train", 32, 4),
                          TrainHParams())[0]
    batches = make_batch_fn(TokenSource(vocab=cfg.vocab, seq_len=32,
                                        global_batch=4, seed=1), device=dev)

    def run(p, o, steps):
        for s in steps:
            b = batches(s)
            p, o, _ = step(p, o, {"tokens": b.tokens, "labels": b.labels})
        return p, o

    ckpt = _train_ckpt_dir("resume")
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        params = model.init(torch.Generator(device=dev).manual_seed(17))
        params, opt = run(params, adamw_init(params), range(10))
        checkpoint.save(ckpt, 10, (params, opt))
        p_ref, o_ref = run(params, opt, (10, 11))
        p2, o2 = run(*checkpoint.load(ckpt, 10, (params, opt)), (10, 11))
        _sync(dev)
    finally:
        torch.use_deterministic_algorithms(was)
        shutil.rmtree(ckpt, ignore_errors=True)
    n = 0
    for name, a, b in zip(*tree.leaves_with_names((p_ref, o_ref)),
                          tree.leaves((p2, o2))):
        if not torch.equal(a, b):
            raise AssertionError(f"resume: {name} differs after the load")
        n += a.numel()
    print(f"[train-resume] mamba2 smoke on the card: 10 steps, save, load, "
          f"2 steps == 2 uninterrupted steps, bitwise on all {n} values "
          f"(params and AdamW state; deterministic algorithms on), "
          f"opt.step {int(o2.step)}", flush=True)


def _train_flops(cfg, length):
    """Matrix-product flops of one train step on one sequence of
    ``length`` tokens: 3x the forward's (the backward takes two products
    for each of the forward's), the forward's as ``_zoo_flops`` counts a
    prefill but with the head over every position.  Remat's recompute is
    not counted: the share is of the work the step needs."""
    head = 2 * cfg.d_model * cfg.vocab
    return 3 * (_zoo_flops(cfg, length, 0) - head + head * length)


def _train_full(dev, gpu):
    """(d) published widths in bf16, float32 moments, remat on: one untimed
    and ``TRAIN_TIMED`` timed steps on (1, 4096) batches; returns the
    rows."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, tree
    from repro_torch.data import TokenSource, make_batch_fn
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    rows = []
    for arch in TRAIN_FULL:
        cfg = configs.get(arch)
        cut = "whole"
        if arch != "mamba2-370m":
            cfg, cut = _zoo_cut(cfg)
        assert cfg.remat and cfg.dtype == torch.bfloat16
        torch.cuda.reset_peak_memory_stats()
        model = build(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(17))
        opt = adamw_init(params)
        n_params = sum(p.numel() for p in tree.leaves(params))
        step = build_for_cell(model, None, configs.ShapeCell(
            "train_4k_b1", "train", TRAIN_LEN, 1), TrainHParams(warmup=0))[0]
        batches = make_batch_fn(TokenSource(vocab=cfg.vocab,
                                            seq_len=TRAIN_LEN,
                                            global_batch=1, seed=17),
                                device=dev)

        def one(s):
            nonlocal params, opt
            b = batches(s)
            params, opt, m = step(params, opt, {"tokens": b.tokens,
                                                "labels": b.labels})
            return m

        one(0)  # untimed: first launches, allocator warm-up
        ms, metrics = [], None
        for s in range(1, 1 + TRAIN_TIMED):
            metrics, t = _timed(dev, lambda s=s: one(s))
            ms.append(t)
        peak = torch.cuda.max_memory_allocated()
        loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        if int(opt.step) != 1 + TRAIN_TIMED or not (
                np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"train {arch}: opt.step {int(opt.step)}, "
                                 f"loss {loss}, gnorm {gnorm}")
        flops = _train_flops(cfg, TRAIN_LEN)
        step_ms = float(np.median(ms))
        row = {"arch": arch, "cut": cut, "params": n_params,
               "dtype": "bfloat16, float32 moments", "remat": True,
               "tokens": [1, TRAIN_LEN], "step_ms": step_ms,
               "step_ms_all": ms, "tokens_per_s": TRAIN_LEN / step_ms * 1e3,
               "peak_gb": peak / 1e9, "train_tflop": flops / 1e12,
               "share_bf16": flops / (step_ms * 1e-3
                                      * kcost.BF16_OPS_PER_S),
               "opt_step": int(opt.step), "loss": loss, "gnorm": gnorm}
        if arch == "qwen3-14b":
            _sync(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall = _timed(dev, lambda: one(1 + TRAIN_TIMED))
            got = _print_profile(f"train {arch}", prof, wall, step_ms, 1,
                                 "step")
            row["idle_profiled"] = None if got is None else got["idle"]
            row["device_events"] = None if got is None else got["events"]
        rows.append(row)
        print(f"[train] {arch} bf16 (float32 moments, remat), {cut}, "
              f"{n_params / 1e9:.3f} B params, (1, {TRAIN_LEN}) tokens: "
              f"{step_ms:.3f} ms a step (median of {TRAIN_TIMED}: "
              f"{', '.join(f'{t:.3f}' for t in ms)}), "
              f"{row['tokens_per_s']:.1f} tokens/s, {flops / 1e12:.3f} "
              f"TFLOP a step, share of the bf16 peak "
              f"{row['share_bf16']:.4f}; peak {row['peak_gb']:.2f} GB; "
              f"opt.step {row['opt_step']}, loss {loss:.4f}, gnorm "
              f"{gnorm:.4f}; {gpu}", flush=True)
        del model, params, opt, metrics, step
        torch.cuda.empty_cache()
    return rows


def phase_train(dev, gpu):
    """The single-process training path: (a) smoke archs card == CPU, (b)
    the trainer's fault recovery, (c) bitwise resume, (d) published
    widths in bf16, timed.  The training path launches none of the three
    kernels: the counters, zeroed before, must read 0 after.  Returns
    (d)'s rows."""
    kernels.reset_counts()
    _train_smoke(dev)
    _train_trainer(dev)
    _train_resume(dev)
    rows = _train_full(dev, gpu)
    _sync(dev)
    counts = kernels.counts()
    if any(counts[key] for key in KERNELS):
        raise AssertionError(f"train: the training path launched a kernel: "
                             f"{counts}")
    print(f"[train] launches of {', '.join(KERNELS)} over phase 17: "
          f"{', '.join(str(counts[key]) for key in KERNELS)}", flush=True)
    return rows


# --- phase 18: the multi-process training substrate (LocalSGD, placements,
# elastic restore, the stage pipeline; A.10c part 1) -------------------------

SUB_RANKS = 4  # (a), (b): a data ring of 4; (c): a (2, 2) mesh; (d): 4 stages
SUB_TIMEOUT_S = 900  # each launch.spawn of phase 18
# The sizes the ranks run at (passed to them; a CPU rehearsal shrinks these).
SUB_SIZES = {"len": 4096,  # configs.SHAPES' train_4k length
             "steps": 8,  # (b): local steps, each followed by the gate
             "tau_factor": 4.0,  # (b): tau = 4x the global drift after step 1
             "stages": 4, "microbatches": 8,  # (d)
             "apply_timed": 3,  # (d): timed applies after one untimed
             "smoke": False}  # the archs' smoke configs (CPU rehearsal only)
SUB_TOL = 1e-5  # (a): the card's params against the CPU's
SUB_ARCH, PIPE_ARCH = "mamba2-370m", "qwen3-14b"
# (b), (c): mamba2-370m at 24 of its 48 layers (the script's time limit:
# phase 19's (h) and (i) took the ~40 s this cut saves).
SUB_LAYERS = 24


def _sub_arch_cfg(sizes):
    """(b), (c): ``SUB_ARCH`` at published widths cut to ``SUB_LAYERS``
    layers (the smoke config in a rehearsal)."""
    import dataclasses

    cfg = _sub_cfg(SUB_ARCH, sizes)
    return cfg if sizes["smoke"] else dataclasses.replace(
        cfg, n_layers=SUB_LAYERS)


def _sub_cfg(arch, sizes):
    """``arch`` at published widths (the smoke config in a rehearsal)."""
    import dataclasses

    from repro_torch import configs

    if sizes["smoke"]:
        return dataclasses.replace(configs.get_smoke(arch),
                                   dtype=torch.bfloat16, remat=True)
    return configs.get(arch)


def _digest(tree_or_tensors) -> str:
    """sha256 over the bytes of every leaf (JAX's order)."""
    import hashlib

    from repro_torch import tree

    h = hashlib.sha256()
    for t in tree.leaves(tree_or_tensors):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def _sub_localsgd_small(dev):
    """(a) the 4-ring case of ``tests/test_torch_localsgd.py`` on ``dev``
    and on the CPU: every call's synced flag and gathered params."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.training import LocalSGDConfig, make_localsgd

    mesh = init_device_mesh("cpu", (SUB_RANKS,), mesh_dim_names=("data",))
    out = {}
    for where in (dev, "cpu"):
        init_fn, gate = make_localsgd(mesh, ("data",),
                                      LocalSGDConfig(tau=0.5), device=where)
        zeros = torch.zeros((1, 8), device=where)
        hold, p_feed = {"w": zeros + 0.05}, {"w": zeros + gate.mon.peer}
        state, calls = init_fn({"w": zeros}), []
        for i in range(16):  # 6 held at a drift of 0.05, 10 fed back
            state, p2, synced = gate(state, p_feed if i >= 6 else hold)
            if i >= 6:
                p_feed = p2
            calls.append((synced, int(state.syncs), gate.gather(p2)["w"]))
        out[str(where)] = calls
    return out


def _time_parts(gate, dev, times):
    """Wrap the gate's parts so each call is timed (synchronized)."""
    def wrap(obj, name, key):
        fn = getattr(obj, name)

        def timed(*a, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            _sync(dev)
            times.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
            if key == "monitor":  # sends a step (the state resets on a sync)
                times.setdefault("sends", []).append(
                    (float((res[0].eff_sends - a[0].eff_sends).sum()),
                     float((res[0].phys_sends - a[0].phys_sends).sum())))
            return res

        setattr(obj, name, timed)

    wrap(gate, "drift", "drift")
    wrap(gate.mon, "step", "monitor")
    wrap(gate, "any_drifted", "any")
    wrap(gate, "sync", "sync")


def _sub_localsgd_full(dev, sizes):
    """(b) LocalSGD on mamba2-370m (``SUB_LAYERS`` layers):
    ``sizes["steps"]`` local train
    steps on this rank's row of a ``TokenSource`` batch placed by
    ``make_batch_fn(mesh=...)``, each followed by the gate; tau = 4x the
    global mean drift after step 1 (all-gathered outside the gate)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs, tree
    from repro_torch.data import TokenSource, make_batch_fn
    from repro_torch.distributed import collective
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import (LocalSGDConfig, TrainHParams,
                                      build_for_cell, make_localsgd)

    cfg, L = _sub_arch_cfg(sizes), sizes["len"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    opt = adamw_init(params)
    step = build_for_cell(model, None, configs.ShapeCell(
        "train_4k_row", "train", L, 1), TrainHParams(warmup=0))[0]
    mesh = init_device_mesh("cpu", (SUB_RANKS,), mesh_dim_names=("data",))
    batches = make_batch_fn(TokenSource(vocab=cfg.vocab, seq_len=L,
                                        global_batch=SUB_RANKS, seed=17),
                            mesh=mesh, device=dev)
    anchor0 = tree.map(torch.clone, params)
    step_ms, losses = [], []

    def one(s):
        nonlocal params, opt
        b = batches(s)
        params, opt, m = step(params, opt, {"tokens": b.tokens.to_local(),
                                            "labels": b.labels.to_local()})
        losses.append(float(m["loss"]))

    _, t = _timed(dev, lambda: one(0))
    step_ms.append(t)
    d2 = sum((p.float() - a.float()).square().sum()
             for p, a in zip(tree.leaves(params), tree.leaves(anchor0)))
    drift1 = collective.all_gather(d2.reshape(1).to(torch.float32))
    tau = sizes["tau_factor"] * float(drift1.mean())
    init_fn, gate = make_localsgd(mesh, ("data",), LocalSGDConfig(tau=tau),
                                  device=dev)
    times = {}
    _time_parts(gate, dev, times)
    state = init_fn(anchor0)
    del anchor0
    calls, gate_ms = [], []
    for s in range(sizes["steps"]):
        if s:
            _, t = _timed(dev, lambda s=s: one(s))
            step_ms.append(t)
        (state, params, synced), t = _timed(dev, lambda: gate(state, params))
        gate_ms.append(t)
        call = {"step": s + 1, "synced": synced, "syncs": int(state.syncs)}
        if synced:
            call["digest"] = _digest(params)
            call["anchor_is_params"] = all(
                torch.equal(a, p) for a, p in zip(tree.leaves(state.anchor),
                                                  tree.leaves(params)))
        calls.append(call)
    staged = sum(p.numel() * 4 for p in tree.leaves(params)) \
        if dev.type == "cuda" else 0
    return {"tau": tau, "drift1": drift1, "calls": calls,
            "step_ms": step_ms, "gate_ms": gate_ms, "parts_ms": {
                k: v for k, v in times.items() if k != "sends"},
            "sends": times.get("sends", []), "staged_sync_bytes": staged,
            "params": sum(p.numel() for p in tree.leaves(params)),
            "losses": losses,
            "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                        if dev.type == "cuda" else None)}


def _elastic_state(model, dev):
    """Seeded published-width params and an AdamW state with seeded
    moments (the same bits in every process on one device)."""
    from repro_torch import tree
    from repro_torch.optim import AdamWState

    g = torch.Generator(device=dev).manual_seed(23)
    params = model.init(g)
    m = tree.map(lambda p: torch.randn(p.shape, generator=g, device=dev),
                 params)
    v = tree.map(lambda p: torch.rand(p.shape, generator=g, device=dev),
                 params)
    return params, AdamWState(m=m, v=v, step=torch.tensor(
        7, dtype=torch.int32, device=dev))


def _elastic_specs(model, mesh):
    from repro_torch.models import common
    from repro_torch.optim import AdamWState

    with common.axis_env(mesh):
        pspecs = model.param_specs()
    return (pspecs, AdamWState(m=pspecs, v=pspecs, step=()))


def _sub_elastic_save(dev, sizes, ckpt):
    """(c) the params and AdamW state placed on (data 2, model 2) by
    ``model.param_specs()``, saved synchronously (every rank gathers, rank
    0 writes)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import checkpoint, tree
    from repro_torch.distributed import elastic
    from repro_torch.models import build

    model = build(_sub_arch_cfg(sizes), dev)
    state = _elastic_state(model, dev)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    placed = elastic.reshard(state, _elastic_specs(model, mesh), mesh)
    nbytes = sum(x.numel() * x.element_size() for x in tree.leaves(state))
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    _, ms = _timed(dev, lambda: checkpoint.save(ckpt, 1, placed))
    return {"save_ms": ms, "bytes": nbytes}


def _sub_pipeline(dev, sizes):
    """(d) four qwen3-14b decoder layers as the stages of ``pipeline`` over
    M microbatches of (1, L, d_model) hidden states; stage 0's rank also
    applies the layers in sequence, one microbatch at a time."""
    import dataclasses

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.distributed import elastic, pipeline
    from repro_torch.models import build, common

    S, M, L = sizes["stages"], sizes["microbatches"], sizes["len"]
    cfg = dataclasses.replace(_sub_cfg(PIPE_ARCH, sizes), n_layers=S)
    model = build(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(29)
    blocks = common.stack_layers(lambda: model._init_block(g), S)
    xs = torch.randn((M, 1, L, cfg.d_model), generator=g,
                     device=dev).to(cfg.dtype)
    mesh = init_device_mesh("cpu", (S,), mesh_dim_names=("stage",))
    stage = int(mesh.get_local_rank("stage"))
    placed = elastic.reshard(blocks, tree.map(lambda _: ("stage",), blocks),
                             mesh)
    if stage:
        del blocks
    n_params = sum(x.to_local().numel() for x in tree.leaves(placed))

    def stage_fn(p, x):
        return model._attn_mlp_block(p, x, "train")[0]

    apply = pipeline.pipeline(stage_fn, mesh, "stage")
    with torch.no_grad():
        out, _ = _timed(dev, lambda: apply(placed, xs))  # untimed
        walls, ticks = [], []
        for _ in range(sizes["apply_timed"]):
            out, t = _timed(dev, lambda: apply(placed, xs))
            walls.append(t)
            ticks.append(apply.ticks)
        res = {"stage": stage, "apply_ms": walls, "ticks": ticks,
               "layer_params": n_params, "digest": _digest([out])}
        if stage == 0:
            seq = []
            for m in range(M):
                x = xs[m]
                for s in range(S):
                    x = stage_fn(common.tree_index(blocks, s), x)
                seq.append(x)
            seq = torch.stack(seq)
            res["bitwise"] = bool(torch.equal(out, seq))
            res["max_abs_err"] = float((out.float() - seq.float()).abs().max())
    return res


def _substrate_rank(rank, world, dev, sizes, ckpt):
    """Phase 18 on one of 4 ranks: (a), (b), (c)'s save, (d), with the
    kernel counters zeroed before and read after."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    kernels.reset_counts()
    out = {"small": _sub_localsgd_small(dev)}
    out["localsgd"] = _sub_localsgd_full(dev, sizes)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["save"] = _sub_elastic_save(dev, sizes, ckpt)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["pipeline"] = _sub_pipeline(dev, sizes)
    _sync(dev)
    out["counts"] = kernels.counts()
    return out


def _restore_rank(rank, world, dev, sizes, ckpt):
    """(c) the second launch: ``remesh(model_axis=2)`` over 2 ranks and a
    load with ``shardings`` from the same specs; each local shard held
    bitwise to its slice of the regenerated saved value."""
    from repro_torch import checkpoint, tree
    from repro_torch.distributed import elastic, sharding
    from repro_torch.models import build

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    kernels.reset_counts()
    model = build(_sub_arch_cfg(sizes), dev)
    mesh, info = elastic.remesh(model_axis=2)
    like = _elastic_state(model, dev)
    spec_tree = _elastic_specs(model, mesh)
    specs = tree.prefix_leaves(like, spec_tree)
    sh = sharding.shardings_like(like, spec_tree, mesh)
    loaded, ms = _timed(dev, lambda: checkpoint.load(ckpt, 1, like,
                                                     shardings=sh))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes_ = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    digests, equal, n = {}, True, 0
    for name, got, want, spec in zip(*tree.leaves_with_names(loaded),
                                     tree.leaves(like), specs):
        sl = sharding.local_slices(tuple(want.shape), sizes_, spec, coord)
        local = got.to_local()
        equal = equal and torch.equal(local, want[sl]) \
            and local.dtype == want.dtype
        digests[name] = (_digest([local]), _digest([want[sl]]))
        n += local.numel()
    _sync(dev)
    return {"info": info, "load_ms": ms, "equal": equal, "digests": digests,
            "values": n, "coord": tuple(coord.values()),
            "counts": kernels.counts()}


def phase_substrate(dev, gpu):
    """The multi-process training substrate on ranks of the card (gloo,
    tensors on ``dev``): (a) LocalSGD card == CPU, (b) LocalSGD at
    published widths, (c) the elastic restore 4 -> 2 ranks, (d) the stage
    pipeline.  None of it launches a kernel: the counters, zeroed on
    every rank before, must read 0 after.  Returns the rows."""
    import shutil

    from repro_torch.distributed import launch

    kernels.reset_counts()
    ckpt = _train_ckpt_dir("elastic")
    t0 = time.perf_counter()
    try:
        ranks = launch.spawn(_substrate_rank, SUB_RANKS,
                             timeout_s=SUB_TIMEOUT_S,
                             args=(str(dev), SUB_SIZES, str(ckpt)))
        spawn4_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = launch.spawn(_restore_rank, 2, timeout_s=SUB_TIMEOUT_S,
                                args=(str(dev), SUB_SIZES, str(ckpt)))
        spawn2_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    rows = {"ranks": SUB_RANKS, "sizes": dict(SUB_SIZES),
            "launch_s": [spawn4_s, spawn2_s], "gpu": gpu}

    # (a) card against the CPU
    for r, rank in enumerate(ranks):
        card, cpu = rank["small"][str(dev)], rank["small"]["cpu"]
        for i, ((s1, n1, p1), (s2, n2, p2)) in enumerate(zip(card, cpu)):
            if (s1, n1) != (s2, n2):
                raise AssertionError(f"localsgd small rank {r} call {i}: "
                                     f"{(s1, n1)} on the card, {(s2, n2)} "
                                     f"on the CPU")
            if not np.allclose(p1, p2, rtol=SUB_TOL, atol=SUB_TOL):
                raise AssertionError(f"localsgd small rank {r} call {i}: "
                                     f"params differ")
    small = ranks[0]["small"][str(dev)]
    print(f"[substrate] (a) LocalSGD 4-ring on 4 ranks of the card == the "
          f"same ranks on the CPU: synced {[int(c[0]) for c in small]}, "
          f"syncs {small[-1][1]}, params within {SUB_TOL}", flush=True)
    rows["localsgd_small"] = {"synced": [bool(c[0]) for c in small],
                              "syncs": small[-1][1]}

    # (b) LocalSGD at published widths
    lsgd = [r["localsgd"] for r in ranks]
    calls = lsgd[0]["calls"]
    for r, x in enumerate(lsgd[1:], 1):
        if [(c["synced"], c["syncs"]) for c in x["calls"]] != \
                [(c["synced"], c["syncs"]) for c in calls]:
            raise AssertionError(f"localsgd: rank {r} disagrees on the syncs")
    if calls[0]["synced"] or not any(c["synced"] for c in calls):
        raise AssertionError(f"localsgd: synced {[c['synced'] for c in calls]}"
                             f" (quiet at step 1, a sync by step "
                             f"{len(calls)} wanted)")
    for i, c in enumerate(calls):
        if c["synced"]:
            digests = {x["calls"][i]["digest"] for x in lsgd}
            if len(digests) != 1 or not all(x["calls"][i]["anchor_is_params"]
                                             for x in lsgd):
                raise AssertionError(f"localsgd: replicas differ after the "
                                     f"sync at step {c['step']}: {digests}")
    med = {k: float(np.median(np.concatenate([x["parts_ms"][k] for x in lsgd])))
           for k in lsgd[0]["parts_ms"]}
    eff = sum(e for x in lsgd for e, _ in x["sends"]) / SUB_RANKS
    phys = sum(p for x in lsgd for _, p in x["sends"]) / SUB_RANKS
    row = {"arch": SUB_ARCH, "params": lsgd[0]["params"],
           "rows_per_rank": [1, SUB_SIZES["len"]],
           "step_ms_median_by_rank": [float(np.median(x["step_ms"][1:]))
                                      for x in lsgd],
           "step_ms_first": [x["step_ms"][0] for x in lsgd],
           "gate_ms_median": float(np.median([t for x in lsgd
                                              for t in x["gate_ms"]])),
           "gate_parts_ms_median": med,
           "sync_ms_all": lsgd[0]["parts_ms"].get("sync", []),
           "staged_bytes_a_sync": lsgd[0]["staged_sync_bytes"],
           "tau": lsgd[0]["tau"],
           "drift_after_step1": np.asarray(lsgd[0]["drift1"]).tolist(),
           "synced": [c["synced"] for c in calls],
           "syncs": calls[-1]["syncs"], "eff_sends": eff,
           "phys_sends": phys, "losses_rank0": lsgd[0]["losses"],
           "peak_gb_by_rank": [x["peak_gb"] for x in lsgd]}
    rows["localsgd"] = row
    print(f"[substrate] (b) LocalSGD {SUB_ARCH} ({SUB_LAYERS} of 48 layers) "
          f"({row['params'] / 1e9:.3f} B params, bf16, float32 moments, "
          f"remat) on a data ring of {SUB_RANKS} ranks, one (1, "
          f"{SUB_SIZES['len']}) row a rank: tau {row['tau']:.6g} (4x the "
          f"mean drift after step 1, {row['drift_after_step1']}); synced "
          f"{[int(c) for c in row['synced']]} ({row['syncs']} syncs), every "
          f"rank bitwise equal after each sync (sha256) and the anchor = the "
          f"params; ms a local step (median of steps 2..): "
          f"{', '.join(f'{t:.1f}' for t in row['step_ms_median_by_rank'])}; "
          f"ms a gate median {row['gate_ms_median']:.3f} (drift "
          f"{med.get('drift', 0):.3f}, monitor step {med.get('monitor', 0):.3f},"
          f" any {med.get('any', 0):.3f}, sync all-reduce "
          f"{med.get('sync', float('nan')):.3f}); staged bytes a sync "
          f"{row['staged_bytes_a_sync']} a rank; monitor sends effective "
          f"{eff:.0f} < physical {phys:.0f} a rank; peak GB "
          f"{[None if g is None else round(g, 2) for g in row['peak_gb_by_rank']]}; "
          f"rank 0's losses {[round(x, 4) for x in row['losses_rank0']]}; "
          f"{gpu}", flush=True)
    if not eff < phys:
        raise AssertionError(f"localsgd: eff {eff} >= phys {phys}")

    # (c) the elastic restore
    saves = [r["save"] for r in ranks]
    for r, x in enumerate(restored):
        if not x["equal"]:
            raise AssertionError(f"elastic: rank {r}'s loaded shards differ "
                                 f"from their slices")
        bad = [n for n, (a, b) in x["digests"].items() if a != b]
        if bad:
            raise AssertionError(f"elastic: rank {r} digests differ: {bad}")
    gb = saves[0]["bytes"] / 1e9
    save_ms = max(x["save_ms"] for x in saves)
    load_ms = max(x["load_ms"] for x in restored)
    rows["elastic"] = {"bytes": saves[0]["bytes"], "save_ms": save_ms,
                       "save_gb_s": gb / (save_ms / 1e3),
                       "load_ms": load_ms, "load_gb_s": gb / (load_ms / 1e3),
                       "save_ms_by_rank": [x["save_ms"] for x in saves],
                       "load_ms_by_rank": [x["load_ms"] for x in restored],
                       "remesh": restored[0]["info"],
                       "leaves": len(restored[0]["digests"]),
                       "values_by_rank": [x["values"] for x in restored]}
    print(f"[substrate] (c) elastic: {SUB_ARCH} ({SUB_LAYERS} of 48 "
          f"layers) params + AdamW state "
          f"({gb:.3f} GB) placed on (data 2, model 2) by param_specs and "
          f"saved from 4 ranks in {save_ms:.1f} ms "
          f"({rows['elastic']['save_gb_s']:.3f} GB/s); a second launch of 2 "
          f"ranks remeshed to {restored[0]['info']['shape']} and loaded with "
          f"shardings in {load_ms:.1f} ms ({rows['elastic']['load_gb_s']:.3f} "
          f"GB/s); every local shard bitwise its slice of the saved leaf "
          f"({rows['elastic']['leaves']} leaves x 2 ranks, sha256); {gpu}",
          flush=True)

    # (d) the pipeline
    pipes = [r["pipeline"] for r in ranks]
    p0 = next(x for x in pipes if x["stage"] == 0)
    if len({x["digest"] for x in pipes}) != 1:
        raise AssertionError("pipeline: the ranks' outputs differ")
    if not p0["bitwise"]:
        raise AssertionError(f"pipeline: not bitwise the sequential layers "
                             f"(max abs err {p0['max_abs_err']})")
    S, M = SUB_SIZES["stages"], SUB_SIZES["microbatches"]
    idle = []
    for x in pipes:
        for ticks in x["ticks"]:
            wall = sum(t for t, _, _ in ticks)
            idle.append(sum(t for t, _, a in ticks if not a) / wall)
    tick_ms = [t * 1e3 for x in pipes for ticks in x["ticks"]
               for t, _, _ in ticks]
    staged = max(b for x in pipes for ticks in x["ticks"] for _, b, _ in ticks)
    row = {"arch": PIPE_ARCH, "stages": S, "microbatches": M,
           "microbatch": [1, SUB_SIZES["len"]],
           "layer_params": p0["layer_params"],
           "apply_ms": float(np.median([t for x in pipes
                                        for t in x["apply_ms"]])),
           "apply_ms_rank0": p0["apply_ms"],
           "tick_ms_median": float(np.median(tick_ms)),
           "staged_bytes_a_tick": staged,
           "bubble_measured": float(np.mean(idle)),
           "bubble_schedule": (S - 1) / (M + S - 1), "bitwise": True}
    rows["pipeline"] = row
    print(f"[substrate] (d) pipeline: {S} {PIPE_ARCH} decoder layers "
          f"({row['layer_params'] / 1e9:.3f} B params a stage, bf16) as "
          f"stage ranks, M = {M} microbatches of (1, {SUB_SIZES['len']}, "
          f"d_model): output bitwise the layers in sequence on one rank, "
          f"equal on every rank; ms an apply median {row['apply_ms']:.1f}, "
          f"ms a tick median {row['tick_ms_median']:.2f}, staged bytes a "
          f"tick {staged}; bubble measured {row['bubble_measured']:.4f} "
          f"beside (S-1)/(M+S-1) = {row['bubble_schedule']:.4f}; {gpu}",
          flush=True)

    counts = kernels.counts()
    totals = {key: counts[key] + sum(r["counts"][key]
                                     for r in [*ranks, *restored])
              for key in KERNELS}
    if any(totals.values()):
        raise AssertionError(f"substrate: a kernel launched: {totals}")
    rows["kernel_launches"] = totals
    print(f"[substrate] launches of {', '.join(KERNELS)} over phase 18 (all "
          f"ranks): {', '.join(str(totals[k]) for k in KERNELS)}; launches "
          f"{spawn4_s:.1f} s (4 ranks), {spawn2_s:.1f} s (2 ranks)",
          flush=True)
    return rows


# --- phase 19: the train, prefill and decode steps across a multi-device
# DeviceMesh, tensor-parallel on "model" (A.10d part 1), and the dry-run ------

STEP_RANKS = 4  # a (2, 2) ("data", "model") mesh of ranks sharing the card
STEP_TIMEOUT_S = 900  # the launch.spawn of phase 19
# The sizes the ranks run at (passed to them; a CPU rehearsal shrinks these).
STEP_SIZES = {"len": 4096,  # (b), (e): configs.SHAPES' train_4k length
              "train_steps": 3,  # (b), (e): one untimed, then two timed
              "prompt": 4096, "decode": 32,  # (c), (f), (h)
              # (i): a (2, 128) train step, a (2, 120) prompt and 8 greedy
              # steps (8 ranks' gloo sums bound it: a (2, 448) step took
              # 27 s on one H100)
              "uneven_len": 128, "uneven_prompt": 120, "uneven_decode": 8,
              "smoke": False,  # the archs' smoke configs (CPU rehearsal)
              "uneven_heads": None}  # (i) a rehearsal's heads (smoke: 4)
STEP_TOL = 1e-4  # (a): losses and gnorms rtol, card against the CPU
STEP_PARAM_TOL = (1e-4, 1e-5)  # (a): params rtol, atol (lr 1e-3)
STEP_FLIPS = 1e-3  # (a): share of params allowed past it (AdamW sign flips)
STEP_TRAIN_ARCH, STEP_SERVE_ARCH = "mamba2-370m", "qwen3-14b"
STEP_TP_ARCH = "yi-9b"  # (e): 2 of 48 layers at published widths
STEP_TIE_ULPS = 2  # (c): a near tie: top-two gap within 2 bf16 ulps of top
# (h): the mesh's float32 prefill against the one-rank float32 prefill of
# the same weights: max abs logit err over the largest |logit| (a fault of
# the split SSD shows here, above bf16's round-off)
STEP_SSD_F32_TOL = 1e-4
# (h): every bf16 step's max abs logit err against the one-rank run within
# this many times the one-rank run's own largest deviation from its
# float32 run (two runs each within d of float32 are within 2 d of each
# other); a flipped step is a tie where its top-two gap is within twice
# that step's err (the logits moved by it can swap the two)
STEP_SSD_DEV = 2.0
STEP_TIES = 1  # (c): steps a row may differ from the one-rank run, at ties
STEP_TIES_SPLIT = 3  # (f), (g): the same, of 33 (a 151,936 or 32,000 vocab)
STEP_ROUTE_TIE = 0.01  # (f), (g): a router's K-th, (K+1)-th probs this close
STEP_EP_ARCH = "qwen3-moe-235b-a22b"  # (f): 64 experts a "model" rank
STEP_LONG_ARCH = "mixtral-8x7b"  # (g): batch 1, the KV sequence on "data"
STEP_SSD_ARCH = "zamba2-2.7b"  # (h): one group, the SSD's heads on "model"
STEP_SERVED_MAX = 1_000_000  # (f)-(h): bytes staged a decode step a rank
STEP_UNEVEN_ARCH = "whisper-large-v3"  # (i): its 20 heads over 8 ranks
STEP_UNEVEN_MESH = (1, 8)  # (i): ("data", "model"), 8 ranks on the card
STEP_UNEVEN_TOL = 1e-4  # (i): float32 loss / gnorm rtol against one rank
STEP_UNEVEN_PARAM_ERR = 2e-3  # (i): a leaf's max abs err, 1 step x 2 lr
# (i): tests/torch_train_parity.py's noise gate: a parameter is held where
# its one-rank |grad| exceeds NOISE_FACTOR x max(GRAD_ATOL, GRAD_LEAF_ATOL
# x its leaf's largest |grad|); elsewhere the grad is round-off and AdamW
# moves the parameter by its sign (the cross-attention key biases)
STEP_GRAD_ATOL, STEP_GRAD_LEAF_ATOL, STEP_NOISE_FACTOR = 1e-6, 1e-4, 10.0
# (a): (arch, FSDP and remat, steps) of the smoke train steps; zamba2's
# remat recomputes its split SSD on autograd's thread on the card.
STEP_SMOKE_TRAIN = (("yi-9b", False, 2), ("qwen3-moe-235b-a22b", True, 1),
                    ("zamba2-2.7b", True, 1))
DRYRUN_CELLS = (("yi-9b", "train_4k", False),
                ("qwen3-moe-235b-a22b", "train_4k", True))
DRYRUN_TIMEOUT_S = 300  # the dry-run cells, awaited after the build


def _gathered(tree_):
    """Every DTensor leaf of ``tree_`` whole, on the CPU (a collective)."""
    from repro_torch import tree
    from repro_torch.distributed import sharding

    return [sharding.full_tensor(x, device="cpu") for x in tree.leaves(tree_)]


def _shards_are_slices(mesh, tree_, wholes) -> bool:
    """Whether every local shard of ``tree_`` is bitwise its slice of its
    gathered whole value in ``wholes``."""
    from repro_torch import tree
    from repro_torch.distributed import sharding

    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    for x, whole in zip(tree.leaves(tree_), wholes):
        sl = sharding.local_slices(tuple(whole.shape), sizes,
                                   sharding._spec_of(x), coord)
        if not torch.equal(x.to_local().cpu(), whole[sl]):
            return False
    return True


def _replicas_equal(mesh, trees) -> bool:
    """Whether, for every DTensor leaf of ``trees``, the ranks that hold
    the same slice (equal coordinates on the axes its spec names) hold
    the same bytes: sha256 of each local shard, gathered (a
    collective)."""
    import hashlib

    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import sharding

    names = tuple(mesh.mesh_dim_names)
    coord = dict(zip(names, mesh.get_coordinate()))
    mine = []
    for t in trees:
        for x in tree.leaves(t):
            named = {a for s in sharding._spec_of(x) if s
                     for a in ((s,) if isinstance(s, str) else s)}
            loc = x.to_local().detach().contiguous().cpu()
            if loc.dtype == torch.bfloat16:
                loc = loc.view(torch.int16)
            mine.append((tuple(coord[a] for a in names if a in named),
                         hashlib.sha256(loc.numpy().tobytes()).hexdigest()))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for i in range(len(mine)):
        seen = {}
        for theirs in every:
            key, digest = theirs[i]
            if seen.setdefault(key, digest) != digest:
                return False
    return True


def _steps_smoke(mesh, where):
    """(a) on ``where``: yi-9b smoke two train steps at accum 2 on (4, 32),
    qwen3-moe and zamba2 smoke (FSDP, remat) one step at accum 2 each
    (``STEP_SMOKE_TRAIN``), a yi-9b prefill of
    (4, 12) and three greedy decode steps; from the same CPU-made
    parameters and batches.  Returns metrics, gathered params and
    tokens."""
    import copy
    import dataclasses

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    out = {}
    hp = TrainHParams(lr=1e-3, warmup=0, accum_steps=2)
    cell = configs.ShapeCell("t", "train", 32, 4)
    for arch, fsdp, steps in STEP_SMOKE_TRAIN:
        cfg = configs.get_smoke(arch)
        if fsdp:
            cfg = dataclasses.replace(cfg, fsdp=True, remat=True)
        gen = torch.Generator().manual_seed(17)
        params = copy.deepcopy(build(cfg, "cpu").init(gen)).to(where)
        batch = {k: v.to(where) for k, v in
                 _train_batch(cfg, gen, cell.global_batch,
                              cell.seq_len).items()}
        step = build_for_cell(build(cfg, where), mesh, cell, hp)[0]
        opt, metrics = adamw_init(params), []
        for _ in range(steps):
            params, opt, m = step(params, opt, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[arch] = {"metrics": metrics, "params": _gathered(params)}
    cfg = configs.get_smoke("yi-9b")
    gen = torch.Generator().manual_seed(18)
    model = build(cfg, where)
    params = copy.deepcopy(build(cfg, "cpu").init(gen)).to(where)
    toks = torch.randint(0, cfg.vocab, (4, 12), generator=gen,
                         dtype=torch.int32).to(where)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", 12, 4))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", 16, 4))[0]
    tok, cache = prefill(params, toks, model.init_cache(4, 16))
    served = [tok]
    for _ in range(3):
        tok, cache = decode(params, tok, cache)
        served.append(tok)
    out["tokens"] = torch.stack([sharding.full_tensor(t, device="cpu")
                                 for t in served], 1)
    return out


def _steps_train_full(mesh, dev, sizes, arch, cut):
    """(b) / (e): ``arch`` at published widths (bf16, float32 moments,
    remat; depth cut to 2 layers where ``cut``) on the (2, 2) mesh: a (2,
    len) ``TokenSource`` global batch (one row a data rank),
    ``train_steps`` steps (the first untimed); after each, every rank's
    gathered params digested (sha256), every local shard held bitwise to
    its slice, and every replica of a parameter and moment shard held
    bitwise to the others."""
    from repro_torch import configs, tree
    from repro_torch.data import TokenSource
    from repro_torch.models import build
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell

    cfg, L = _sub_cfg(arch, sizes), sizes["len"]
    depth = "whole"
    if cut and not sizes["smoke"]:
        cfg, depth = _zoo_cut(cfg)
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    n_params = sum(p.numel() for p in tree.leaves(params))
    opt = adamw_init(params)
    step = build_for_cell(model, mesh, configs.ShapeCell(
        "train_4k_2rows", "train", L, 2), TrainHParams(warmup=0))[0]
    src = TokenSource(vocab=cfg.vocab, seq_len=L, global_batch=2, seed=17)
    ms, staged, digests, bitwise, replicas, losses = [], [], [], [], [], []
    for s in range(sizes["train_steps"]):
        if s == 1 and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        b = src.global_batch_at(s)
        before = dict(step.plan.staged)
        (params, opt, m), t = _timed(dev, lambda: step(
            params, opt, {"tokens": b.tokens.to(dev),
                          "labels": b.labels.to(dev)}))
        ms.append(t)
        staged.append({k: v - before[k]
                       for k, v in step.plan.staged.items()})
        losses.append(float(m["loss"]))
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        wholes = _gathered(params)
        digests.append(_digest(wholes))
        bitwise.append(_shards_are_slices(mesh, params, wholes))
        del wholes
        replicas.append(_replicas_equal(mesh, (params, opt.m, opt.v)))
    return {"arch": arch, "depth": depth, "params": n_params,
            "step_ms": ms, "staged": staged, "digests": digests,
            "bitwise": bitwise, "replicas": replicas, "losses": losses,
            "opt_step": int(opt.step.to_local()), "peak_gb": peak,
            "model_gathered": sorted(step.plan.model_gathered)}


def _serve_ref(model, params, toks, length, steps, dev, feed=None,
               keep=False):
    """The one-rank prefill of ``toks`` (one row) and ``steps`` greedy
    decode steps (fed ``feed``'s tokens instead where given): the
    ``steps + 1`` tokens, (top logit, top-two gap) of each step's
    logits, prefill ms, ms a decode step, and with ``keep`` each step's
    logits (float32, on the CPU; else None)."""
    from repro_torch.training.steps import _argmax

    with torch.no_grad():
        (logits, cache), pf = _timed(dev, lambda: model.prefill(
            params, toks, model.init_cache(1, length)))
        tokens, gaps, tok_ms, kept = [], [], [], []
        while True:
            top2 = torch.topk(logits[0].float(), 2).values
            gaps.append((float(top2[0]), float(top2[0] - top2[1])))
            if keep:
                kept.append(logits[0].float().cpu())
            tok = _argmax(logits)
            tokens.append(int(tok[0]))
            if len(tokens) == steps + 1:
                return (tokens, gaps, pf, tok_ms,
                        torch.stack(kept).numpy() if keep else None)
            if feed is not None:
                tok = torch.tensor([feed[len(tokens) - 1]],
                                   dtype=torch.int32, device=dev)
            (logits, cache), dt = _timed(dev, lambda: model.decode_step(
                params, tok, cache))
            tok_ms.append(dt)


def _route_margins(model, params, toks, length, want):
    """The one-rank run of ``toks`` (one row) fed its tokens ``want``
    again, untimed, with the MoE router observed: for each decode step the
    smallest relative gap, over its MoE layers, between the K-th and the
    (K + 1)-th expert probability of the token (None for the prefill's
    step, and where the model has no MoE)."""
    from repro_torch.models import moe

    seen, orig = [], moe.route

    def route(p, cfg, x, dropless=False):
        if x.shape[1] == 1:
            probs = torch.softmax(torch.einsum(
                "bld,de->ble", x.float(), p["router"]), dim=-1)
            top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
            seen.append(((top[..., -2] - top[..., -1]) / top[..., -2]).min())
        return orig(p, cfg, x, dropless)

    moe.route = route
    try:
        with torch.no_grad():
            _, cache = model.prefill(params, toks,
                                     model.init_cache(1, length))
            out = [None]
            for t in want[:-1]:
                seen.clear()
                _, cache = model.decode_step(
                    params, torch.tensor([t], dtype=torch.int32,
                                         device=toks.device), cache)
                out.append(min(float(m) for m in seen) if seen else None)
    finally:
        moe.route = orig
    return out


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x else 2.0 ** -133


def _steps_serve_full(mesh, dev, sizes):
    """(c) qwen3-14b (2 of 40 layers, bf16) on the (2, 2) mesh: a prefill
    of (2, prompt), one row a data rank, then ``decode`` greedy steps
    teacher-forced: each mesh step is fed the one-rank run's previous
    tokens (each row alone through the one-rank steps, the shapes the
    mesh rank computes), so a flip at a near tie does not carry on."""
    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cfg = _sub_cfg(STEP_SERVE_ARCH, sizes)
    cut = "smoke"
    if not sizes["smoke"]:
        cfg, cut = _zoo_cut(cfg)
    P, T = sizes["prompt"], sizes["decode"]
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    toks = torch.randint(0, cfg.vocab, (2, P), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(19)).to(dev)
    ref = [_serve_ref(model, params, toks[r:r + 1], P + T, T, dev)
           for r in range(2)]
    want = torch.tensor([x[0] for x in ref], dtype=torch.int32)  # (2, T+1)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", P, 2))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", P + T, 2))[0]
    (tok, cache), pf_ms = _timed(dev, lambda: prefill(
        params, toks, model.init_cache(2, P + T)))
    served, tok_ms = [tok], []
    for t in range(T):
        feed = want[:, t].to(dev)
        (tok, cache), dt = _timed(dev, lambda: decode(params, feed, cache))
        served.append(tok)
        tok_ms.append(dt)
    got = torch.stack([sharding.full_tensor(t, device="cpu")
                       for t in served], 1)
    row = int(mesh.get_coordinate()[0])
    return {"cut": cut, "tokens": got, "want": want, "row": row,
            "gaps": [x[1] for x in ref],
            "prefill_ms": pf_ms, "token_ms": tok_ms,
            "ref_prefill_ms": ref[row][2], "ref_token_ms": ref[row][3],
            "staged_decode": dict(decode.plan.staged),
            "staged_prefill": dict(prefill.plan.staged)}


SERVED_ARCHS = {"ep": STEP_EP_ARCH, "long": STEP_LONG_ARCH,
                "ssd": STEP_SSD_ARCH}  # (f), (g), (h)


def _served_cfg(part, sizes):
    """(f) qwen3-moe / (g) mixtral at published widths, 2 layers, (h)
    zamba2 one 6-layer group (the smoke config in a rehearsal), serving
    weights not split over "data" (``serve_fsdp`` off: the "model" slice
    fits on a rank, so a decode step gathers no weight): (config, the cut
    as printed)."""
    import dataclasses

    cfg = _sub_cfg(SERVED_ARCHS[part], sizes)
    cut = "smoke"
    if not sizes["smoke"]:
        cfg, cut = _zoo_cut(cfg)
    return dataclasses.replace(cfg, serve_fsdp=False), cut


def _served_prompt(part, cfg, sizes):
    """(f), (h): (2, prompt) tokens, one row a data rank.  (g): (1, P)
    with P = window + window / 2 - decode / 2: past the window, so the
    ring wraps, and the decode steps write slots window / 2 - decode / 2
    on, across the boundary of the two data ranks' halves.  Returns
    (tokens, P, decode steps)."""
    T = sizes["decode"]
    if part != "long":
        rows, P = 2, sizes["prompt"]
    else:
        rows, P = 1, cfg.window + cfg.window // 2 - T // 2
    toks = torch.randint(0, cfg.vocab, (rows, P), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(23))
    return toks, P, T


def served_refs(dev, sizes):
    """(f)-(h): each row alone through the one-rank steps, in this
    process before the ranks start (four whole copies of the parameters
    beside the ranks' shards would not fit on the card): the tokens, the
    (top logit, top-two gap) of each step, prefill ms, ms a token and the
    peak memory; and (h)'s logits a step, of this bf16 run and of a
    float32 run of the same weights fed the same tokens (:func:`_ssd_f32`),
    kept apart (the ranks are not sent them).  The parameters are freed
    after.  Returns (refs, {"bf16": rows, "f32": rows})."""
    from repro_torch.models import build

    out, logits = {}, {}
    for part in SERVED_ARCHS:
        cfg, cut = _served_cfg(part, sizes)
        toks, P, T = _served_prompt(part, cfg, sizes)
        model = build(cfg, dev)
        params = model.init(torch.Generator(device=dev).manual_seed(17))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        keep = part == "ssd"
        ref = [_serve_ref(model, params, toks[r:r + 1].to(dev), P + T, T,
                          dev, keep=keep) for r in range(toks.shape[0])]
        if keep:
            logits = {"bf16": [x[4] for x in ref],
                      "f32": _ssd_f32(cfg, params, toks, P, T,
                                      [x[0] for x in ref], dev)}
        margins = [_route_margins(model, params, toks[r:r + 1].to(dev),
                                  P + T, x[0]) if cfg.moe else [None] * (T + 1)
                   for r, x in enumerate(ref)]
        out[part] = {"cut": cut, "want": [x[0] for x in ref],
                     "gaps": [[(*g, m) for g, m in zip(x[1], ms)]
                              for x, ms in zip(ref, margins)],
                     "prefill_ms": [x[2] for x in ref],
                     "token_ms": [t for x in ref for t in x[3]],
                     "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                                 if dev.type == "cuda" else None)}
        del params, model, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out, logits


def _ssd_f32(cfg, params, toks, P, T, want, dev):
    """(h): each row alone through a float32 one-rank run of the bf16
    ``params`` cast up, fed the bf16 run's tokens ``want``: its logits a
    step (the bf16 run's distance from them is its own round-off)."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.models import build

    model = build(dataclasses.replace(cfg, dtype=torch.float32), dev)
    p32 = tree.map(lambda p: p.float() if p.is_floating_point() else p,
                   params)
    out = [_serve_ref(model, p32, toks[r:r + 1].to(dev), P + T, T, dev,
                      feed=want[r], keep=True)[4]
           for r in range(toks.shape[0])]
    del p32
    return out


def _card_memory(dev) -> dict | None:
    """GB this process holds on the card (allocated, reserved) and free
    on it (None on the CPU)."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info()
    return {"allocated_gb": round(torch.cuda.memory_allocated() / 1e9, 3),
            "reserved_gb": round(torch.cuda.memory_reserved() / 1e9, 3),
            "free_gb": round(free / 1e9, 3)}


def _placed_params(mesh, model, spec, dev, dtype=None):
    """The seed-17 parameters of ``model`` (cast to ``dtype`` where given)
    at ``spec`` on this rank: made whole on ``dev`` and sliced one rank
    at a time (the whole copies of the four ranks at once would not fit
    beside the shards)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.distributed import sharding

    placed = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            whole = model.init(torch.Generator(device=dev).manual_seed(17))
            if dtype is not None:
                whole = tree.map(lambda p: p.to(dtype), whole)
            placed = sharding.put_tree(whole, spec, mesh, dev)
            del whole
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        dist.barrier()
    return placed


def _keep_logits(model, kept: list) -> None:
    """``model``'s ``prefill`` and ``decode_step`` from now on append each
    call's logits to ``kept`` (float32, on the CPU: on a mesh rank its
    rows and its slice of the vocab)."""
    for name in ("prefill", "decode_step"):
        def call(*args, _fn=getattr(model, name)):
            logits, cache = _fn(*args)
            kept.append(logits.float().cpu())
            return logits, cache
        setattr(model, name, call)


def _ssd_f32_prefill(mesh, dev, cfg, toks, P, rows):
    """(h): the mesh's float32 prefill of ``toks`` on the bf16 parameters
    cast up: this rank's logits (its row, its vocab slice)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    model = build(dataclasses.replace(cfg, dtype=torch.float32), dev)
    kept = []
    _keep_logits(model, kept)
    prefill, in_specs = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", P, rows))[:2]
    params = _placed_params(mesh, build(cfg, dev), in_specs[0], dev,
                            torch.float32)
    prefill(params, toks.to(dev), model.init_cache(rows, P))
    del params
    _free(dev)
    return kept[0][0].numpy()


def _steps_served_split(mesh, dev, sizes, part, ref):
    """(f) / (g) / (h) on the (2, 2) mesh: the prefill of
    :func:`_served_prompt` and ``decode`` greedy steps teacher-forced by
    the one-rank run's tokens ``ref["want"]`` (as (c)): (f) the experts
    split over "model", (g) the KV sequence over "data", (h) the SSD's
    heads (and the shared attention's) over "model", its logits a step
    kept, then a float32 prefill (:func:`_ssd_f32_prefill`)."""
    from repro_torch import configs
    from repro_torch.distributed import sharding, spmd
    from repro_torch.models import build
    from repro_torch.training import build_for_cell

    cfg, _ = _served_cfg(part, sizes)
    toks, P, T = _served_prompt(part, cfg, sizes)
    rows = toks.shape[0]
    model = build(cfg, dev)
    kept = []
    if part == "ssd":
        _keep_logits(model, kept)
    prefill, in_specs = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", P, rows))[:2]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", P + T, rows))[0]
    mem = _card_memory(dev)
    print(f"[mesh-steps] ({part}) rank {mesh.get_rank()} before its "
          f"parameters: {mem}", flush=True)
    params = _placed_params(mesh, model, in_specs[0], dev)
    want = torch.tensor(ref["want"], dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (tok, cache), pf_ms = _timed(dev, lambda: prefill(
        params, toks.to(dev), model.init_cache(rows, P + T)))
    served, tok_ms = [tok], []
    for t in range(T):
        feed = want[:, t].to(dev)
        (tok, cache), dt = _timed(dev, lambda: decode(params, feed, cache))
        served.append(tok)
        tok_ms.append(dt)
    got = torch.stack([sharding.full_tensor(t, device="cpu")
                       for t in served], 1)
    k = cache.kv.k
    ssm = None if cache.ssm is None else cache.ssm.ssm
    out = {"tokens": got, "prompt": [rows, P], "prefill_ms": pf_ms,
           "token_ms": tok_ms,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev.type == "cuda" else None),
           "staged_decode": dict(decode.plan.staged),
           "staged_prefill": dict(prefill.plan.staged),
           "model_gathered": sorted(prefill.plan.model_gathered
                                    | decode.plan.model_gathered),
           "decode_gathered": sorted(decode.plan.model_gathered),
           "kv_shard": list(spmd.local(k).shape), "kv_whole": list(k.shape),
           "ssm_shard": None if ssm is None else list(spmd.local(ssm).shape),
           "ssm_whole": None if ssm is None else list(ssm.shape),
           "experts": cfg.moe.n_experts if cfg.moe else None,
           "memory_at_start": mem, "logits": None}
    if part == "ssd":  # after the peak is read
        del params, cache, k, ssm
        _free(dev)
        out["logits"] = {
            "bf16": torch.cat(kept).numpy(),
            "f32": _ssd_f32_prefill(mesh, dev, cfg, toks, P, rows),
            "coord": [int(c) for c in mesh.get_coordinate()]}
    return out


def _served_near_tie(row, step, gap) -> bool:
    """Whether a step's (top logit, top-two gap[, router margin]) is a
    near tie (:func:`_served_ties`): the gap within ``STEP_TIE_ULPS``
    bf16 ulps of the top logit, or the router margin within
    ``STEP_ROUTE_TIE``."""
    margin = gap[2] if len(gap) > 2 else None
    return (gap[1] <= STEP_TIE_ULPS * _bf16_ulp(gap[0])
            or (margin is not None and margin <= STEP_ROUTE_TIE))


def _served_ties(label, sv, want, gaps, limit, tie=_served_near_tie):
    """The near ties of a teacher-forced serving part, and its faults:
    every rank's tokens must equal rank 0's, and each row's the one-rank
    run's ``want`` but at near ties, at most ``limit`` a row: where
    ``tie(row, step, gap entry)`` holds (:func:`_served_near_tie`: the
    top-two gap within ``STEP_TIE_ULPS`` bf16 ulps of the top logit, or
    (a gap entry's third value, :func:`_route_margins`) a MoE router's
    K-th and (K + 1)-th expert probabilities within ``STEP_ROUTE_TIE`` of
    each other, where a token may go to another expert).  Returns
    ([(row, step, gap entry)], [fault, ...])."""
    for r, x in enumerate(sv):
        if not np.array_equal(x["tokens"], sv[0]["tokens"]):
            return [], [f"mesh steps ({label}) rank {r}: tokens differ "
                        f"from rank 0's"]
    got, want = np.asarray(sv[0]["tokens"]), np.asarray(want)
    ties, faults = [], []
    for row_ in range(got.shape[0]):
        bad = [t for t in range(got.shape[1]) if got[row_, t] !=
               int(want[row_, t])]
        near = [(t, gaps[row_][t]) for t in bad
                if tie(row_, t, gaps[row_][t])]
        if len(near) < len(bad) or len(bad) > limit:
            faults.append(
                f"mesh steps ({label}) row {row_}: steps {bad} differ from "
                f"the one-rank run (near ties {near}; (top logit, gap) "
                f"{[gaps[row_][t] for t in bad]})")
        ties += [(row_, t, g) for t, g in near]
    return ties, faults


def _ssd_logit_errs(sv, logits):
    """(h), per row: the mesh's logits a step, assembled from its ranks'
    vocab slices, against the one-rank runs' ``logits``
    (:func:`served_refs`): each step's max abs err against the bf16 run
    (``dev``), the bf16 run's against the float32 run (``rho``), and the
    mesh's float32 prefill against the float32 run's, over its largest
    |logit| (``f32_rel``)."""
    by_row = {}
    for x in sv:
        d, m = x["logits"]["coord"]
        by_row.setdefault(d, {})[m] = x["logits"]
    out = []
    for d in sorted(by_row):
        parts = [by_row[d][m] for m in sorted(by_row[d])]
        one, one32 = logits["bf16"][d], logits["f32"][d]  # (steps, V)
        V = one.shape[-1]
        got = np.concatenate([p["bf16"] for p in parts], -1)[:, :V]
        got32 = np.concatenate([p["f32"] for p in parts], -1)[:V]
        out.append({
            "dev": np.abs(got - one).max(-1).tolist(),
            "rho": np.abs(one - one32).max(-1).tolist(),
            "f32_rel": float(np.abs(got32 - one32[0]).max()
                             / np.abs(one32[0]).max())})
    return out


def _served_row(label, part, ranks, refs, gpu, logits=None):
    """(f) / (g) / (h): the checks and the row of a split serving part:
    tokens as the one-rank run's (:func:`_served_ties`), under
    ``STEP_SERVED_MAX`` bytes staged a decode step on every rank, no
    weight gathered (and (f): no expert leaf over "model"; (g): no KV
    cache gathered, each rank's cache half the sequence; (h): no leaf
    gathered over "model" by a decode step, the SSM state half the heads
    a rank; its conv tail, whole on "model", is its one input gathered;
    the float32 prefill within ``STEP_SSD_F32_TOL`` of one rank's, every
    bf16 step's logits within ``STEP_SSD_DEV`` times the one-rank bf16
    run's own round-off of the one-rank run's, and a flipped token a tie
    where its top-two gap is within twice that step's logit err:
    :func:`_ssd_logit_errs` on ``logits``)."""
    sv = [r[part] for r in ranks]
    key = part.split("_")[0]
    ref = refs[key]
    errs, tie = None, _served_near_tie
    if key == "ssd":
        errs = _ssd_logit_errs(sv, logits)

        def tie(row_, t, gap):
            return gap[1] <= 2 * errs[row_]["dev"][t]
    ties, faults = _served_ties(label, sv, ref["want"], ref["gaps"],
                                STEP_TIES_SPLIT, tie)
    for row_, e in enumerate(errs or ()):
        if e["f32_rel"] > STEP_SSD_F32_TOL:
            faults.append(f"mesh steps ({label}) row {row_}: the float32 "
                          f"prefill's logits {e['f32_rel']:.3g} of the "
                          f"largest off the one-rank run's")
        if max(e["dev"]) > STEP_SSD_DEV * max(e["rho"]):
            faults.append(f"mesh steps ({label}) row {row_}: logit errs "
                          f"{e['dev']} against the one-rank run, its own "
                          f"round-off {max(e['rho'])}")
    n_dec = STEP_SIZES["decode"]
    per_step = [sum(x["staged_decode"].values()) / n_dec for x in sv]
    if max(per_step) >= STEP_SERVED_MAX:
        faults.append(f"mesh steps ({label}): {max(per_step)} bytes staged "
                      f"a decode step a rank")
    for r, x in enumerate(sv):
        if ((x["staged_decode"]["gather"] and key != "ssd")
                or x["staged_decode"]["kv"]):
            faults.append(f"mesh steps ({label}) rank {r}: a decode step "
                          f"gathered {x['staged_decode']}")
        if key == "ssd" and (x["decode_gathered"] or x["ssm_shard"][3] * 2
                             != x["ssm_whole"][3]):
            faults.append(f"mesh steps ({label}) rank {r}: a decode step "
                          f"gathered {x['decode_gathered']} over \"model\","
                          f" SSM state {x['ssm_shard']} of "
                          f"{x['ssm_whole']}")
        if part == "ep_serve" and any("moe" in n for n in
                                      x["model_gathered"]):
            faults.append(f"mesh steps ({label}) rank {r}: experts gathered "
                          f"over \"model\": {x['model_gathered']}")
        if part == "long_serve" and x["kv_shard"][2] * 2 != x["kv_whole"][2]:
            faults.append(f"mesh steps ({label}) rank {r}: KV cache "
                          f"{x['kv_shard']} of {x['kv_whole']}")
    arch = SERVED_ARCHS[key]
    got = np.asarray(sv[0]["tokens"])
    tok_ms = [t for x in sv for t in x["token_ms"]]
    row = {"arch": arch, "cut": ref["cut"], "prompt": sv[0]["prompt"],
           "decode": n_dec,
           "prefill_ms_by_rank": [x["prefill_ms"] for x in sv],
           "token_ms_median": float(np.median(tok_ms)),
           "ref_prefill_ms": ref["prefill_ms"],
           "ref_token_ms_median": float(np.median(ref["token_ms"])),
           "staged_bytes_decode_steps": sv[0]["staged_decode"],
           "staged_bytes_a_decode_step_by_rank": per_step,
           "staged_bytes_prefill": sv[0]["staged_prefill"],
           "peak_gb_by_rank": [x["peak_gb"] for x in sv],
           "ref_peak_gb": ref["peak_gb"],
           "model_gathered": sv[0]["model_gathered"],
           "kv_shard": sv[0]["kv_shard"], "kv_whole": sv[0]["kv_whole"],
           "ssm_shard": sv[0]["ssm_shard"], "ssm_whole": sv[0]["ssm_whole"],
           "decode_gathered": sv[0]["decode_gathered"],
           "near_ties": ties, "tokens_head": got[:, :8].tolist(),
           "logit_errs": errs}
    E = sv[0]["experts"]
    what = {"ep": f"its {E} experts {(E or 0) // 2} a \"model\" rank",
            "long": f"batch 1 (long_ctx), its KV ring of "
                    f"{row['kv_whole'][2]} slots {row['kv_shard'][2]} a "
                    f"\"data\" rank",
            "ssd": f"its SSM state {row['ssm_whole']} {row['ssm_shard']} a "
                   f"rank (the SSD's heads on \"model\"), a decode step "
                   f"gathering {row['decode_gathered'] or 'no'} leaf over "
                   f"\"model\""}[key]
    near = (f"top-two gap within {STEP_TIE_ULPS} bf16 ulps, or a router's "
            f"K-th and (K+1)-th expert probabilities within "
            f"{STEP_ROUTE_TIE:.0%}")
    if errs:
        near = (f"top-two gap within twice the step's max abs logit err "
                f"against the one-rank run; by row, that err's max "
                f"{[max(e['dev']) for e in errs]} (at most "
                f"{STEP_SSD_DEV} x the one-rank bf16 run's own max err "
                f"against its float32 run, "
                f"{[max(e['rho']) for e in errs]}), at the "
                f"flipped steps "
                f"{[(r, t, errs[r]['dev'][t]) for r, t, _ in ties]}"
                f"; the float32 prefill's max abs logit err over the "
                f"largest |logit| "
                f"{[e['f32_rel'] for e in errs]} (tol "
                f"{STEP_SSD_F32_TOL})")
    print(f"[mesh-steps] ({label}) {arch} bf16 ({row['cut']}) on (data 2, "
          f"model 2), {what}: a prefill of {tuple(row['prompt'])} "
          f"{max(row['prefill_ms_by_rank']):.1f} ms (slowest rank), then "
          f"{n_dec} greedy steps teacher-forced at "
          f"{row['token_ms_median']:.1f} ms a token (median over the ranks);"
          f" the one-rank steps on each row alone: prefill "
          f"{max(row['ref_prefill_ms']):.1f} ms, "
          f"{row['ref_token_ms_median']:.1f} ms a token, peak "
          f"{row['ref_peak_gb']} GB; every token equal to the one-rank "
          f"run's but at near ties ({near}; at most {STEP_TIES_SPLIT} a "
          f"row; (top, gap, router margin)): {ties or 'none'}; "
          f"staged bytes a decode "
          f"step a rank {[round(b) for b in per_step]} (the {n_dec} steps, "
          f"rank 0: {row['staged_bytes_decode_steps']}; prefill "
          f"{row['staged_bytes_prefill']}); peak GB a rank "
          f"{[g if g is None else round(g, 2) for g in row['peak_gb_by_rank']]};"
          f" leaves gathered over \"model\": {row['model_gathered']}; "
          f"tokens[:, :8] {row['tokens_head']}; {gpu}", flush=True)
    if faults:  # after the row is printed
        raise AssertionError("; ".join(faults))
    return row


def _free(dev) -> None:
    """Collect the garbage (a part's reference cycles hold its tensors:
    up to 18 GB a rank of an H100 after (b) and (c) without it) and empty
    the card's cache, before a part's rank starts the next."""
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _mesh_step_rank(rank, world, dev, sizes):
    """Phase 19 on one of 4 ranks: (a) on the card and on the CPU, (b),
    (c), (e), with the kernel counters zeroed before and read after."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    kernels.reset_counts()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {"smoke": {str(w): _steps_smoke(mesh, w)
                     for w in dict.fromkeys((dev, torch.device("cpu")))}}
    for key, fn in (
            ("train", lambda: _steps_train_full(mesh, dev, sizes,
                                                STEP_TRAIN_ARCH, False)),
            ("serve", lambda: _steps_serve_full(mesh, dev, sizes)),
            ("tp_train", lambda: _steps_train_full(mesh, dev, sizes,
                                                   STEP_TP_ARCH, True))):
        _free(dev)
        print(f"[mesh-steps] rank {rank} before ({key}): "
              f"{_card_memory(dev)}", flush=True)
        out[key] = fn()
    _sync(dev)
    out["counts"] = kernels.counts()
    return out


def _served_rank(rank, world, dev, sizes, refs):
    """Phase 19 (f), (g), (h) on one of 4 ranks, in ranks of their own
    (the parameters of (f) need the card's memory free of (a)-(e)'s), with
    the kernel counters zeroed before and read after."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(2)
    kernels.reset_counts()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    for part in SERVED_ARCHS:
        _free(dev)
        out[f"{part}_serve"] = _steps_served_split(mesh, dev, sizes, part,
                                                   refs[part])
    _sync(dev)
    out["counts"] = kernels.counts()
    return out


def _uneven_cfg(sizes, dtype):
    """(i) whisper-large-v3 at published widths, 2 + 2 layers (the smoke
    config in a rehearsal), in ``dtype``: (config, the cut as printed)."""
    import dataclasses

    cfg, cut = _sub_cfg(STEP_UNEVEN_ARCH, sizes), "smoke"
    if not sizes["smoke"]:
        cfg, cut = _zoo_cut(cfg)
    elif sizes.get("uneven_heads"):  # a rehearsal's smoke heads
        cfg = dataclasses.replace(cfg, n_heads=sizes["uneven_heads"])
    return dataclasses.replace(cfg, dtype=dtype), cut


def _uneven_inputs(cfg, sizes):
    """(i): (2, uneven_len) tokens and labels, (2, enc_len, d_model)
    frames, on the CPU, from seed 29."""
    gen = torch.Generator().manual_seed(29)
    return _train_batch(cfg, gen, 2, sizes["uneven_len"])


def _uneven_model(sizes, dtype, dev):
    """(i): the model, its seed-17 parameters on ``dev`` and the inputs."""
    from repro_torch.models import build

    cfg, cut = _uneven_cfg(sizes, dtype)
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(17))
    inputs = {k: v.to(dev) for k, v in _uneven_inputs(cfg, sizes).items()}
    return model, params, inputs, cut


def _uneven_cache(model, params, inputs, length):
    """(i): the serving cache of the two rows (the encoder run whole)."""
    with torch.no_grad():
        enc = model.encode(params, inputs["frames"])
        return model.init_cache(params, enc, 2, length)


def uneven_refs(dev, sizes):
    """(i): the one-rank bf16 prefill of the (2, uneven_prompt) prompt and
    ``uneven_decode`` greedy steps, both rows at once (the shapes every
    rank of the (1, 8) mesh computes): the tokens, each step's (top logit,
    top-two gap) a row, prefill ms and ms a token."""
    from repro_torch.training.steps import _argmax

    model, params, inputs, cut = _uneven_model(sizes, torch.bfloat16, dev)
    P, T = sizes["uneven_prompt"], sizes["uneven_decode"]
    cache = _uneven_cache(model, params, inputs, P + T)
    with torch.no_grad():
        (logits, cache), pf = _timed(dev, lambda: model.prefill(
            params, inputs["tokens"][:, :P], cache))
        tokens, gaps, tok_ms = [], [], []
        while True:
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            gaps.append([(float(a), float(a - b)) for a, b in top2.tolist()])
            tok = _argmax(logits)
            tokens.append(tok.cpu())
            if len(tokens) == T + 1:
                break
            (logits, cache), dt = _timed(dev, lambda: model.decode_step(
                params, tok, cache))
            tok_ms.append(dt)
    del params, model, cache
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"cut": cut, "want": torch.stack(tokens, 1).tolist(),
            "gaps": [list(g) for g in zip(*gaps)], "prefill_ms": pf,
            "token_ms": tok_ms}


def _uneven_train(mesh, dev, sizes):
    """(i) one float32 train step (lr 1e-3, remat) of the (2, uneven_len)
    batch on the (1, 8) mesh: its metrics and ms, staged bytes, the leaves
    gathered over "model", every shard bitwise its slice and every replica
    the others; rank 0 also runs the one-rank step first and holds the
    gathered parameters to its leaf by leaf (:func:`_leaf_errs`)."""
    from repro_torch import configs, tree
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHParams, build_for_cell, steps

    model, params, batch, cut = _uneven_model(sizes, torch.float32, dev)
    hp = TrainHParams(lr=1e-3, warmup=0)
    cell = configs.ShapeCell("t", "train", sizes["uneven_len"], 2)
    ref = None
    if mesh.get_rank() == 0:
        grads = steps.loss_and_grads(model, params, batch)[2]
        one = build_for_cell(model, None, cell, hp)[0]
        p1, _, m1 = one(params, adamw_init(params), batch)
        names, flat = tree.leaves_with_names(p1)
        ref = {"metrics": {k: float(v) for k, v in m1.items()},
               "names": names, "params": [x.detach().cpu() for x in flat],
               "grads": [g.detach().cpu() for g in tree.leaves(grads)]}
        del p1, grads
        params = model.init(torch.Generator(device=dev).manual_seed(17))
    step = build_for_cell(model, mesh, cell, hp)[0]
    (params, opt, m), ms = _timed(dev, lambda: step(
        params, adamw_init(params), batch))
    wholes = _gathered(params)
    out = {"cut": cut, "metrics": {k: float(v) for k, v in m.items()},
           "step_ms": ms, "staged": dict(step.plan.staged),
           "model_gathered": sorted(step.plan.model_gathered),
           "bitwise": _shards_are_slices(mesh, params, wholes),
           "replicas": _replicas_equal(mesh, (params, opt.m, opt.v))}
    if ref is not None:
        out["ref"] = {"metrics": ref["metrics"],
                      **_leaf_errs(wholes, ref)}
    return out


def _leaf_errs(wholes, ref) -> dict:
    """(i): the gathered parameters ``wholes`` against the one-rank
    step's, leaf by leaf, where the noise gate of
    ``tests/torch_train_parity.py`` holds them (``STEP_GRAD_ATOL``,
    ``STEP_GRAD_LEAF_ATOL``, ``STEP_NOISE_FACTOR`` on the one-rank
    grads): each leaf's (name, max abs err, share past
    ``STEP_PARAM_TOL``, elements held, elements), the worst of each, and
    the share of all elements held."""
    leaves = []
    for name, a, b, g in zip(ref["names"], wholes, ref["params"],
                             ref["grads"], strict=True):
        g = np.abs(np.asarray(g, np.float32))
        noise = max(STEP_GRAD_ATOL,
                    STEP_GRAD_LEAF_ATOL * float(g.max(initial=0.0)))
        sure = g > STEP_NOISE_FACTOR * noise
        err, past = _close(np.asarray(a)[sure], np.asarray(b)[sure],
                           *STEP_PARAM_TOL)
        leaves.append((name, err, past, int(sure.sum()), g.size))
    return {"leaves": leaves,
            "param_abs_err": max(x[1] for x in leaves),
            "param_share_past_tol": max(x[2] for x in leaves),
            "held": sum(x[3] for x in leaves) / sum(x[4] for x in leaves)}


def _uneven_serve(mesh, dev, sizes, ref):
    """(i) the bf16 prefill of the (2, uneven_prompt) prompt and
    ``uneven_decode`` greedy steps teacher-forced by the one-rank run's
    tokens ``ref["want"]`` on the (1, 8) mesh (as (c))."""
    from repro_torch import configs
    from repro_torch.distributed import sharding, spmd
    from repro_torch.training import build_for_cell

    model, params, inputs, _ = _uneven_model(sizes, torch.bfloat16, dev)
    P, T = sizes["uneven_prompt"], sizes["uneven_decode"]
    cache = _uneven_cache(model, params, inputs, P + T)
    prefill = build_for_cell(model, mesh, configs.ShapeCell(
        "p", "prefill", P, 2))[0]
    decode = build_for_cell(model, mesh, configs.ShapeCell(
        "d", "decode", P + T, 2))[0]
    want = torch.tensor(ref["want"], dtype=torch.int32)
    (tok, cache), pf_ms = _timed(dev, lambda: prefill(
        params, inputs["tokens"][:, :P], cache))
    served, tok_ms = [tok], []
    for t in range(T):
        feed = want[:, t].to(dev)
        (tok, cache), dt = _timed(dev, lambda: decode(params, feed, cache))
        served.append(tok)
        tok_ms.append(dt)
    got = torch.stack([sharding.full_tensor(t, device="cpu")
                       for t in served], 1)
    k = cache.kv.k
    return {"tokens": got, "prefill_ms": pf_ms, "token_ms": tok_ms,
            "staged_decode": dict(decode.plan.staged),
            "staged_prefill": dict(prefill.plan.staged),
            "model_gathered": sorted(prefill.plan.model_gathered
                                     | decode.plan.model_gathered),
            "kv_shard": list(spmd.local(k).shape), "kv_whole": list(k.shape)}


def _uneven_rank(rank, world, dev, sizes, ref):
    """Phase 19 (i) on one of 8 ranks of the (1, 8) mesh, with the kernel
    counters zeroed before and read after."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    kernels.reset_counts()
    mesh = init_device_mesh("cpu", STEP_UNEVEN_MESH,
                            mesh_dim_names=("data", "model"))
    out = {"train": _uneven_train(mesh, dev, sizes)}
    _free(dev)
    out["serve"] = _uneven_serve(mesh, dev, sizes, ref)
    _sync(dev)
    out["counts"] = kernels.counts()
    return out


def _uneven_row(ranks, ref, gpu):
    """(i): the checks and the row: the train step held to the one-rank
    step (loss and gnorm within ``STEP_UNEVEN_TOL``; each leaf's
    parameters behind the noise gate (:func:`_leaf_errs`) within
    ``STEP_UNEVEN_PARAM_ERR`` and with at most ``STEP_FLIPS`` of them past
    ``STEP_PARAM_TOL``, at least half of all held), shards bitwise and
    replicas equal, the same metrics on every rank; the served tokens as
    the one-rank run's but at near ties."""
    tr = [r["train"] for r in ranks]
    one = tr[0]["ref"]
    faults = []
    if not all(x["bitwise"] and x["replicas"] for x in tr):
        faults.append("mesh steps (i): a shard is not its slice, or "
                      "replicas differ")
    if len({tuple(sorted(x["metrics"].items())) for x in tr}) != 1:
        faults.append("mesh steps (i): the ranks' metrics differ")
    rel = {k: abs(tr[0]["metrics"][k] - one["metrics"][k])
           / abs(one["metrics"][k]) for k in ("loss", "gnorm")}
    if max(rel.values()) > STEP_UNEVEN_TOL:
        faults.append(f"mesh steps (i): {tr[0]['metrics']} against the "
                      f"one-rank step's {one['metrics']}")
    bad = [x for x in one["leaves"]
           if x[2] > STEP_FLIPS or x[1] > STEP_UNEVEN_PARAM_ERR]
    if bad or one["held"] < 0.5:
        faults.append(f"mesh steps (i): params differ from the one-rank "
                      f"step's, (leaf, max abs err, share past "
                      f"{STEP_PARAM_TOL}, held, elements) {bad}, "
                      f"{one['held']} of all elements held")
    sv = [r["serve"] for r in ranks]
    ties, more = _served_ties("i", sv, ref["want"], ref["gaps"], STEP_TIES)
    faults += more
    n_dec = STEP_SIZES["uneven_decode"]
    per_step = [sum(x["staged_decode"].values()) / n_dec for x in sv]
    tok_ms = [t for x in sv for t in x["token_ms"]]
    row = {"arch": STEP_UNEVEN_ARCH, "cut": ref["cut"],
           "mesh": list(STEP_UNEVEN_MESH), "rows": [2, STEP_SIZES[
               "uneven_len"]], "train_metrics": tr[0]["metrics"],
           "one_rank_metrics": one["metrics"], "metric_rel_err": rel,
           "param_abs_err": one["param_abs_err"],
           "param_share_past_tol": one["param_share_past_tol"],
           "param_share_held": one["held"],
           "step_ms_by_rank": [x["step_ms"] for x in tr],
           "staged_bytes_a_step": tr[0]["staged"],
           "model_gathered_train": tr[0]["model_gathered"],
           "prompt": [2, STEP_SIZES["uneven_prompt"]], "decode": n_dec,
           "prefill_ms_by_rank": [x["prefill_ms"] for x in sv],
           "token_ms_median": float(np.median(tok_ms)),
           "ref_prefill_ms": ref["prefill_ms"],
           "ref_token_ms_median": float(np.median(ref["token_ms"])),
           "staged_bytes_a_decode_step_by_rank": per_step,
           "staged_bytes_prefill": sv[0]["staged_prefill"],
           "model_gathered_serve": sv[0]["model_gathered"],
           "kv_shard": sv[0]["kv_shard"], "kv_whole": sv[0]["kv_whole"],
           "near_ties": ties,
           "tokens_head": np.asarray(sv[0]["tokens"])[:, :8].tolist()}
    H = _uneven_cfg(STEP_SIZES, torch.float32)[0].n_heads
    m = STEP_UNEVEN_MESH[1]
    print(f"[mesh-steps] (i) {STEP_UNEVEN_ARCH} ({row['cut']}) on (data 1, "
          f"model {m}), its {H} heads {H // m} or {-(-H // m)} a rank: a "
          f"float32 train step (remat,"
          f" lr 1e-3) of a (2, {STEP_SIZES['uneven_len']}) batch "
          f"{max(row['step_ms_by_rank']):.1f} ms (slowest rank), loss / "
          f"gnorm {tr[0]['metrics']['loss']:.6f} / "
          f"{tr[0]['metrics']['gnorm']:.6f} against the one-rank step's "
          f"{one['metrics']['loss']:.6f} / {one['metrics']['gnorm']:.6f} "
          f"(rel {rel['loss']:.2e}, {rel['gnorm']:.2e}; tol "
          f"{STEP_UNEVEN_TOL}), params leaf by leaf behind the noise gate "
          f"({one['held']} of all elements held): max abs err "
          f"{one['param_abs_err']} (tol {STEP_UNEVEN_PARAM_ERR}), the "
          f"worst leaf's share past {STEP_PARAM_TOL} "
          f"{one['param_share_past_tol']} (tol {STEP_FLIPS}); shards "
          f"bitwise and replicas "
          f"equal; staged a step a rank {tr[0]['staged']}; leaves gathered "
          f"over \"model\" {row['model_gathered_train']}; bf16 serving: a "
          f"prefill of (2, {STEP_SIZES['uneven_prompt']}) "
          f"{max(row['prefill_ms_by_rank']):.1f} ms (slowest rank), then "
          f"{n_dec} greedy steps teacher-forced at "
          f"{row['token_ms_median']:.1f} ms a token (median over the ranks),"
          f" the one-rank run {row['ref_prefill_ms']:.1f} ms and "
          f"{row['ref_token_ms_median']:.1f} ms a token; the cache "
          f"{row['kv_whole']} {row['kv_shard']} a rank (d_head split); "
          f"tokens as the one-rank run's but at near ties (at most "
          f"{STEP_TIES} a row): {ties or 'none'}; staged bytes a decode step"
          f" a rank {[round(b) for b in per_step]}; tokens[:, :8] "
          f"{row['tokens_head']}; {gpu}", flush=True)
    if faults:
        raise AssertionError("; ".join(faults))
    return row


def _close(a, b, rtol, atol):
    """(max abs err, share of elements past ``atol + rtol |b|``) of two
    float arrays."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if not a.size:
        return 0.0, 0.0
    err = np.abs(a - b)
    return float(err.max()), float(np.mean(err > atol + rtol * np.abs(b)))


def start_dryruns() -> list:
    """Phase 19 (d): each ``DRYRUN_CELLS`` cell in a child process of its
    own, started now; the futures of their records."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch import dryrun

    pool = ThreadPoolExecutor(max_workers=len(DRYRUN_CELLS))
    dry = [pool.submit(dryrun.run_cell_in_child, *c) for c in DRYRUN_CELLS]
    pool.shutdown(wait=False)
    return dry


def phase_mesh_steps(dev, gpu, recs):
    """The train, prefill and decode steps across a (2, 2) ("data",
    "model") mesh of 4 ranks sharing the card (gloo, shards on ``dev``),
    tensor-parallel on "model": (a) card == CPU at smoke size, (b)
    mamba2-370m whole training, (c) qwen3-14b serving, teacher-forced,
    (d) the records ``recs`` of the dry-run cells (:func:`start_dryruns`),
    (e) yi-9b training (2 of 48 layers), (f) qwen3-moe serving with its
    experts split over "model", (g) mixtral serving at batch 1 with its
    KV sequence split over "data" (2 layers each) and (h) zamba2 serving
    (one 6-layer group) with the SSD's heads split over "model" (all
    three teacher-forced by the one-rank runs, made here first), (i)
    whisper-large-v3 (2 + 2 layers) on a (1, 8) mesh of 8 ranks, which
    does not divide its 20 heads: a float32 train step held to the
    one-rank step, and bf16 serving teacher-forced.  No kernel launches:
    the counters, zeroed on every rank, must read 0.  Returns the rows."""
    from repro_torch.distributed import launch
    from repro_torch.launch import dryrun

    kernels.reset_counts()
    t0 = time.perf_counter()
    refs, ssd_logits = served_refs(dev, STEP_SIZES)
    refs_s = time.perf_counter() - t0
    print(f"[mesh-steps] (f)-(h) one-rank runs in {refs_s:.1f} s; this "
          f"process after them: {_card_memory(dev)}", flush=True)
    t0 = time.perf_counter()
    ranks = launch.spawn(_mesh_step_rank, STEP_RANKS,
                         timeout_s=STEP_TIMEOUT_S,
                         args=(str(dev), STEP_SIZES))
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = launch.spawn(_served_rank, STEP_RANKS, timeout_s=STEP_TIMEOUT_S,
                          args=(str(dev), STEP_SIZES, refs))
    served_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    uneven_ref = uneven_refs(dev, STEP_SIZES)
    uneven = launch.spawn(_uneven_rank, math.prod(STEP_UNEVEN_MESH),
                          timeout_s=STEP_TIMEOUT_S,
                          args=(str(dev), STEP_SIZES, uneven_ref))
    uneven_s = time.perf_counter() - t0
    rows = {"ranks": STEP_RANKS, "mesh": [2, 2], "sizes": dict(STEP_SIZES),
            "launch_s": spawn_s, "served_launch_s": served_s,
            "uneven_launch_s": uneven_s,
            "one_rank_refs_s": refs_s, "gpu": gpu}

    # (a) the card against the CPU
    worst = {"loss": 0.0, "params": 0.0, "flips": 0.0}
    for r, rank in enumerate(ranks):
        card, cpu = rank["smoke"][str(dev)], rank["smoke"]["cpu"]
        if not np.array_equal(card["tokens"], cpu["tokens"]):
            raise AssertionError(f"mesh steps (a) rank {r}: tokens differ "
                                 f"on the card and the CPU")
        for arch, _, _ in STEP_SMOKE_TRAIN:
            for m_d, m_c in zip(card[arch]["metrics"], cpu[arch]["metrics"]):
                for key in ("loss", "gnorm"):
                    rel = abs(m_d[key] - m_c[key]) / abs(m_c[key])
                    worst["loss"] = max(worst["loss"], rel)
                    if rel > STEP_TOL:
                        raise AssertionError(
                            f"mesh steps (a) rank {r} {arch}: {key} "
                            f"{m_d[key]} on the card, {m_c[key]} on the CPU")
            for pd, pc in zip(card[arch]["params"], cpu[arch]["params"]):
                err, past = _close(pd, pc, *STEP_PARAM_TOL)
                worst["params"] = max(worst["params"], err)
                worst["flips"] = max(worst["flips"], past)
                if past > STEP_FLIPS or err > 4e-3:  # 2 steps x 2 lr
                    raise AssertionError(
                        f"mesh steps (a) rank {r} {arch}: params differ "
                        f"(max abs err {err}, {past:.2e} of a leaf past "
                        f"the tolerance)")
    tokens = ranks[0]["smoke"][str(dev)]["tokens"]
    print(f"[mesh-steps] (a) (2, 2) mesh of {STEP_RANKS} ranks, "
          f"tensor-parallel on \"model\", card == CPU:"
          f" yi-9b smoke 2 train steps (accum 2), qwen3-moe and zamba2 smoke "
          f"(FSDP, remat, accum 2) losses / gnorms within rtol "
          f"{worst['loss']:.3g} (tol {STEP_TOL}), params max abs err "
          f"{worst['params']:.3g} ({worst['flips']:.2e} of a leaf past "
          f"{STEP_PARAM_TOL}); prefill + 3 greedy steps tokens equal "
          f"{tokens.tolist()}", flush=True)
    rows["smoke"] = {"loss_rel_err": worst["loss"],
                     "param_abs_err": worst["params"],
                     "param_share_past_tol": worst["flips"],
                     "tokens": tokens.tolist()}

    # (b) training at published width; (e) the same for yi-9b, tensor-
    # parallel on "model"
    for part, label in (("train", "b"), ("tp_train", "e")):
        tr = [r[part] for r in ranks]
        for s in range(len(tr[0]["digests"])):
            if len({x["digests"][s] for x in tr}) != 1:
                raise AssertionError(f"mesh steps ({label}) step {s + 1}: "
                                     f"the ranks' gathered params differ")
            if not all(x["bitwise"][s] for x in tr):
                raise AssertionError(f"mesh steps ({label}) step {s + 1}: "
                                     f"a local shard is not its slice")
            if not all(x["replicas"][s] for x in tr):
                raise AssertionError(f"mesh steps ({label}) step {s + 1}: "
                                     f"replicas of a shard differ")
        if tr[0]["opt_step"] != STEP_SIZES["train_steps"] or not all(
                np.isfinite(x["losses"]).all() for x in tr):
            raise AssertionError(f"mesh steps ({label}): opt.step "
                                 f"{tr[0]['opt_step']}, losses "
                                 f"{[x['losses'] for x in tr]}")
        if len({tuple(x["losses"]) for x in tr}) != 1:
            raise AssertionError(f"mesh steps ({label}): the ranks' losses "
                                 f"differ")
        timed = [t for x in tr for t in x["step_ms"][1:]]
        staged = tr[0]["staged"][-1]
        row = {"arch": tr[0]["arch"], "depth": tr[0]["depth"],
               "params": tr[0]["params"], "rows": [2, STEP_SIZES["len"]],
               "step_ms_median": float(np.median(timed)),
               "step_ms_by_rank": [x["step_ms"] for x in tr],
               "staged_bytes_a_step": staged, "losses": tr[0]["losses"],
               "peak_gb_by_rank": [x["peak_gb"] for x in tr],
               "model_gathered": tr[0]["model_gathered"]}
        rows[part] = row
        print(f"[mesh-steps] ({label}) {row['arch']} ({row['depth']}, "
              f"{row['params'] / 1e9:.3f} B params, bf16, float32 moments, "
              f"remat) on (data 2, model 2), tensor-parallel on \"model\", "
              f"a (2, {STEP_SIZES['len']}) global batch, one row a data rank:"
              f" {row['step_ms_median']:.1f} ms a step (median of steps "
              f"2-{STEP_SIZES['train_steps']} over the ranks; by rank "
              f"{[[round(t, 1) for t in x['step_ms']] for x in tr]}); staged "
              f"bytes a step a rank: gathers {staged['gather']}, grad "
              f"reduction {staged['reduce']}, tensor-parallel activations "
              f"{staged['tp']}, MoE / metric means {staged['stats']}; peak GB"
              f" a rank "
              f"{[g if g is None else round(g, 2) for g in row['peak_gb_by_rank']]}"
              f"; losses {[round(x, 4) for x in row['losses']]}; leaves "
              f"gathered over \"model\": {row['model_gathered']}; after every"
              f" step the gathered params bitwise equal on every rank "
              f"(sha256), every local shard bitwise its slice and every "
              f"replica of a param / moment shard bitwise the others; {gpu}",
              flush=True)

    # (c) serving at published width, teacher-forced
    sv = [r["serve"] for r in ranks]
    want, gaps = sv[0]["want"], sv[0]["gaps"]
    for r, x in enumerate(sv):
        if not np.array_equal(x["want"], want):
            raise AssertionError(f"mesh steps (c) rank {r}: the one-rank "
                                 f"runs differ from rank 0's")
    ties, faults = _served_ties("c", sv, want, gaps, STEP_TIES)
    if faults:
        raise AssertionError(faults[0])
    got = np.asarray(sv[0]["tokens"])
    tok_ms = [t for x in sv for t in x["token_ms"]]
    n_dec = STEP_SIZES["decode"]
    staged_dec = sv[0]["staged_decode"]
    row = {"arch": STEP_SERVE_ARCH, "cut": sv[0]["cut"],
           "prompt": [2, STEP_SIZES["prompt"]], "decode": n_dec,
           "prefill_ms_by_rank": [x["prefill_ms"] for x in sv],
           "token_ms_median": float(np.median(tok_ms)),
           "ref_prefill_ms_by_rank": [x["ref_prefill_ms"] for x in sv],
           "ref_token_ms_median": float(np.median(
               [t for x in sv for t in x["ref_token_ms"]])),
           "staged_bytes_decode_steps": staged_dec,
           "staged_bytes_a_decode_step": sum(staged_dec.values()) / n_dec,
           "staged_bytes_prefill": sv[0]["staged_prefill"],
           "near_ties": ties, "tokens_head": got[:, :8].tolist()}
    rows["serve"] = row
    print(f"[mesh-steps] (c) {STEP_SERVE_ARCH} bf16 ({row['cut']}) on (data "
          f"2, model 2), tensor-parallel on \"model\": a prefill of (2, "
          f"{STEP_SIZES['prompt']}), one row a data rank, "
          f"{max(row['prefill_ms_by_rank']):.1f} ms (slowest rank), then "
          f"{n_dec} greedy steps teacher-forced at "
          f"{row['token_ms_median']:.1f} ms a token (median over the ranks);"
          f" the one-rank steps on each row alone: prefill "
          f"{max(row['ref_prefill_ms_by_rank']):.1f} ms, "
          f"{row['ref_token_ms_median']:.1f} ms a token, beside the other "
          f"ranks' runs; every one of the {n_dec + 1} tokens a row equal to "
          f"the one-rank run's but at near ties (top-two gap within "
          f"{STEP_TIE_ULPS} bf16 ulps of the top logit; at most {STEP_TIES} a"
          f" row): {ties or 'none'}; staged bytes a decode step a rank "
          f"{row['staged_bytes_a_decode_step']:.0f} (the {n_dec} steps: "
          f"{staged_dec}; prefill {row['staged_bytes_prefill']}); "
          f"tokens[:, :8] {row['tokens_head']}; {gpu}", flush=True)

    # (f) the experts on "model", (g) the KV sequence on "data", (h) the
    # SSD's heads on "model"
    for part, label in (("ep_serve", "f"), ("long_serve", "g"),
                        ("ssd_serve", "h")):
        rows[part] = _served_row(label, part, served, refs, gpu, ssd_logits)

    # (i) attention heads that "model" does not divide
    rows["uneven"] = _uneven_row(uneven, uneven_ref, gpu)

    # (d) the dry-run
    rows["dryrun"] = recs
    for rec in recs:
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run {rec['arch']} {rec['shape']} "
                                 f"{rec['mesh']}: {rec['status']} "
                                 f"{rec.get('error')}")
        print(f"[mesh-steps] (d) dry-run {rec['arch']} {rec['shape']} "
              f"{rec['mesh']} ({rec['n_chips']} fake ranks, rank 0's step on"
              f" meta tensors, accum {rec['accum_steps']}): ok in "
              f"{rec['trace_s']} s; dominant {rec['dominant']}, bound "
              f"{rec['step_time_bound_s']:.4f} s (roofline "
              f"{ {k: round(v, 4) for k, v in rec['roofline'].items()} }), "
              f"bytes per device {rec['bytes_per_device']}, useful flops "
              f"ratio {rec['useful_flops_ratio']:.4f}, collective bytes "
              f"{rec['collective_bytes_per_device']}, leaves gathered over "
              f"\"model\" {rec['model_gathered']}; the H100 SXM's "
              f"constants ({dryrun.PEAK_FLOPS:.3g} FLOP/s, "
              f"{dryrun.HBM_BW:.3g} B/s, {dryrun.NET_BW:.3g} B/s a GPU); "
              f"{gpu}", flush=True)

    counts = kernels.counts()
    totals = {key: counts[key] + sum(r["counts"][key]
                                     for r in ranks + served + uneven)
              for key in KERNELS}
    if any(totals.values()):
        raise AssertionError(f"mesh steps: a kernel launched: {totals}")
    rows["kernel_launches"] = totals
    rows["kernel_launches_by_rank"] = [[r["counts"][k] for k in KERNELS]
                                       for r in ranks + served + uneven]
    print(f"[mesh-steps] launches of {', '.join(KERNELS)} over phase 19, by "
          f"rank ((a)-(e), then (f)-(h), then (i)): "
          f"{rows['kernel_launches_by_rank']}; launches {spawn_s:.1f} s, "
          f"{served_s:.1f} s and {uneven_s:.1f} s (its one-rank run "
          f"included)", flush=True)
    return rows


# --- phases 20 and 21: the dynamic runs and the demos ---------------------

DYN_SPEC = dict(bias=0.2, std=2.0)  # benchmarks/fig6-8's problem
DYN_CYCLES = 400  # benchmarks/fig6-8's cycles (warm-up a quarter)
DYN_RUNS = (  # (label, topology, noise ppmc, churn ppmc, drop rate)
    ("fig6 drift 1000", "grid", 1_000.0, 0.0, 0.0),
    ("fig6 drift 100000", "grid", 100_000.0, 0.0, 0.0),
    ("fig7 drop 0.05", "grid", 1_000.0, 0.0, 0.05),
    ("fig7 drop 0.05", "chord", 1_000.0, 0.0, 0.05),
    ("fig7 drop 0.05", "ba", 1_000.0, 0.0, 0.05),
    ("fig8 churn 1000", "grid", 1_000.0, 1_000.0, 0.0),
)
DYN_MIN_ACC = 0.90  # (a): avg_accuracy of every run at drop_rate 0
DYN_SMALL = dict(noise_ppmc=10_000.0, churn_ppmc=1_000.0)  # (b)
DYN_SMALL_CYCLES = 200
# (d): peers leave a DynTopology; at these rates some seeds' churn never
# draws a dead peer again (the first is 13 at 4,096 peers)
DYN_LEAVE = dict(noise_ppmc=10_000.0, churn_ppmc=500.0)
DYN_LEAVE_CYCLES = 80
DYN_ENGINE_CYCLES = 200  # (c)
DYN_DROP = 0.05  # (b)'s lossy pair
DEMOS = ("quickstart_torch", "sensor_grid_torch", "engine_demo_torch",
         "serve_monitor_torch")
DEMO_ARGS = dict.fromkeys(DEMOS, ())  # each twin at its defaults
MONITOR_FULL = ("--n", str(283 * 283))  # the twin's other defaults


def _churn_replay(n, spec, cycles, noise_ppmc, churn_ppmc):
    """``run_dynamic``'s numpy stream replayed on the host alone (the
    initial inputs, then a cycle's noise and churn draws, as
    ``core/sim.py`` draws them): the alive fraction at the end, and whether
    a churn draw picked a peer already dead."""
    rng = np.random.default_rng(spec.seed + 1)
    rng.standard_normal((n, spec.d))
    alive = np.ones(n, bool)
    rekill = False
    for _ in range(cycles):
        changes = rng.binomial(n, min(noise_ppmc * 1e-6, 1.0))
        if changes:
            rng.choice(n, size=changes, replace=False)
            rng.standard_normal((changes, spec.d))
        dead = rng.binomial(n, min(churn_ppmc * 1e-6, 1.0))
        if dead:
            cand = rng.choice(n, size=dead, replace=False)
            rekill = rekill or not alive[cand].all()
            alive[cand] = False
    return float(alive.mean()), rekill


class _DriverClock:
    """Host seconds spent in ``sim._Driver``'s methods while a
    ``run_dynamic`` call runs (wrapped on the class for the call, restored
    after), and the clock at each ``drain``'s return: the driver drains
    once a cycle and the drain reads the send count, so consecutive
    returns bound one cycle each."""

    METHODS = ("advance", "drain", "observe", "set_inputs", "kill_peers")

    def __enter__(self):
        self.spent = dict.fromkeys(self.METHODS, 0.0)
        self.ticks = []
        self._orig = {m: getattr(sim._Driver, m) for m in self.METHODS}
        for name, fn in self._orig.items():
            setattr(sim._Driver, name, self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(drv, *args, **kw):
            t0 = time.perf_counter()
            out = fn(drv, *args, **kw)
            t1 = time.perf_counter()
            self.spent[name] += t1 - t0
            if name == "drain":
                self.ticks.append(t1)
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(sim._Driver, name, fn)


def _dyn_run(label, topo, spec, dev, cycles, cfg=lss.LSSConfig(),
             fused=True, **kw):
    """One ``run_dynamic`` (warm-up a quarter of ``cycles``) with the
    launch counters and the do-while's read counter zeroed before it and
    read after it.  Fused runs must launch every kernel and no plain
    version; others no kernel.  Returns (result, counts, a line of
    stats)."""
    _sync(dev)
    kernels.reset_counts()
    lss.host_syncs = 0
    t0 = time.perf_counter()
    with _DriverClock() as clock:
        res = sim.run_dynamic(topo, spec, cfg, cycles=cycles,
                              warmup=cycles // 4, device=dev,
                              use_kernels=fused, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    if fused:
        _require_launched(label, counts)
    elif any(counts[k] for k in KERNELS):
        raise AssertionError(f"{label}: the reference run launched a kernel")
    acc = res["avg_accuracy"]
    if (not 0.0 <= acc <= 1.0 or res["msgs_per_link_per_cycle"] <= 0
            or not 0.0 < res["alive_frac"] <= 1.0):
        raise AssertionError(f"{label}: implausible result {res}")
    us = np.diff(clock.ticks) * 1e6
    observes = cycles - cycles // 4
    stats = (f"median {np.median(us):.1f} us a cycle (min {us.min():.1f}, "
             f"max {us.max():.1f}; wall {wall:.3f} s for {cycles}); "
             f"launches a cycle "
             f"{ {k: round(counts[k] / cycles, 3) for k in KERNELS} }; host "
             f"syncs a cycle {lss.host_syncs / cycles:.3f} do-while reads + 1 "
             f"drain + {2 * observes / cycles:.2f} observe reads; host s in "
             f"{ {k: round(v, 3) for k, v in clock.spent.items()} }")
    return res, counts, stats


def _add_counts(totals, counts):
    for key in KERNELS:
        totals[key] += counts[key]


def _same_result(label, got, want):
    if got != want:
        diff = {k: (got.get(k), want.get(k)) for k in {*got, *want}
                if got.get(k) != want.get(k)}
        raise AssertionError(f"{label}: results differ in {diff}")


def phase_dynamic(topos, dev):
    """Figs. 6-8's ``run_dynamic`` on the card: (a) at 80,000 peers through
    the kernels, (b) fused == reference (and card == CPU) at 4,096, (c) the
    engine == the core, (d) a churned DynTopology == the alive mask."""
    totals = dict.fromkeys(KERNELS, 0)
    for label, name, noise, churn, drop in DYN_RUNS:
        topo = topos[name]
        spec = sim.ProblemSpec(n=topo.n, **DYN_SPEC)
        res, counts, stats = _dyn_run(
            f"{label} {name}", topo, spec, dev, DYN_CYCLES,
            lss.LSSConfig(drop_rate=drop), noise_ppmc=noise,
            churn_ppmc=churn)
        _add_counts(totals, counts)
        alive, _ = _churn_replay(topo.n, spec, DYN_CYCLES, noise, churn)
        if res["alive_frac"] != alive:
            raise AssertionError(f"{label} {name}: alive_frac "
                                 f"{res['alive_frac']} != the host's "
                                 f"replay {alive}")
        if drop == 0.0 and res["avg_accuracy"] < DYN_MIN_ACC:
            raise AssertionError(f"{label} {name}: avg_accuracy "
                                 f"{res['avg_accuracy']} < {DYN_MIN_ACC}")
        print(f"[dynamic] (a) {label} {name} n={topo.n} D={topo.max_deg} "
              f"drift={noise:g} churn={churn:g} drop={drop:g}: avg_accuracy "
              f"{res['avg_accuracy']!r} msgs_per_link_per_cycle "
              f"{res['msgs_per_link_per_cycle']!r} alive_frac "
              f"{res['alive_frac']!r} (the host's replay of the churn "
              f"draws); {stats}", flush=True)
    grid = topos["grid"]
    dyn = topology.DynTopology.from_topology(grid)
    ms = []
    for _ in range(3):
        _sync(dev)
        t0 = time.perf_counter()
        lss.TopoArrays.from_topology(dyn, dev)
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[dynamic] (a) the table rebuild a churn cycle costs on a "
          f"DynTopology (TopoArrays.from_topology) at n={dyn.n}: "
          f"{[round(m, 3) for m in ms]} ms", flush=True)

    # (b) fused == reference == CPU at 4,096 on grid.
    side = int(round(N_SMALL ** 0.5))
    small = topology.grid(side * side)
    spec = sim.ProblemSpec(n=small.n, **DYN_SPEC)
    for drop in (0.0, DYN_DROP):
        cfg = lss.LSSConfig(drop_rate=drop)
        fused, counts, stats = _dyn_run(f"(b) drop {drop}", small, spec, dev,
                                        DYN_SMALL_CYCLES, cfg, **DYN_SMALL)
        _add_counts(totals, counts)
        plain, _, _ = _dyn_run(f"(b) drop {drop} reference", small, spec,
                               dev, DYN_SMALL_CYCLES, cfg, fused=False,
                               **DYN_SMALL)
        _same_result(f"(b) drop {drop} fused vs reference", fused, plain)
        line = "== the reference suite's on the card"
        if drop == 0.0:
            cpu = sim.run_dynamic(small, spec, cfg, cycles=DYN_SMALL_CYCLES,
                                  warmup=DYN_SMALL_CYCLES // 4,
                                  device="cpu", **DYN_SMALL)
            _same_result("(b) card vs CPU", fused, cpu)
            line += " == the CPU's"
        print(f"[dynamic] (b) grid n={small.n} drift 10000 churn 1000 drop "
              f"{drop:g}, {DYN_SMALL_CYCLES} cycles: fused {fused} {line} "
              f"in every key; {stats}", flush=True)

    # (c) the engine (S = 8) == the core, grid 80,089, drift 1,000.
    spec = sim.ProblemSpec(n=grid.n, **DYN_SPEC)
    eng, counts, eng_stats = _dyn_run(
        "(c) engine", grid, spec, dev, DYN_ENGINE_CYCLES,
        engine=EngineConfig(num_shards=ENGINE["num_shards"]),
        noise_ppmc=1_000.0)
    _add_counts(totals, counts)
    core, counts, core_stats = _dyn_run("(c) core", grid, spec, dev,
                                        DYN_ENGINE_CYCLES, noise_ppmc=1_000.0)
    _add_counts(totals, counts)
    _same_result("(c) engine vs core", eng, core)
    print(f"[dynamic] (c) grid n={grid.n} drift 1000, {DYN_ENGINE_CYCLES} "
          f"cycles: engine (S = {ENGINE['num_shards']}) {eng} == the core's "
          f"in every key; engine {eng_stats}; core {core_stats}", flush=True)

    # (d) a churned DynTopology == the alive mask, at a seed whose churn
    # never draws a dead peer again.
    seed = next(s for s in range(200) if not _churn_replay(
        small.n, sim.ProblemSpec(n=small.n, seed=s), DYN_LEAVE_CYCLES,
        **DYN_LEAVE)[1])
    spec = sim.ProblemSpec(n=small.n, seed=seed, **DYN_SPEC)
    masked, counts, _ = _dyn_run("(d) alive mask", small, spec, dev,
                                 DYN_LEAVE_CYCLES, **DYN_LEAVE)
    _add_counts(totals, counts)
    left, counts, stats = _dyn_run(
        "(d) DynTopology", topology.DynTopology.from_topology(small), spec,
        dev, DYN_LEAVE_CYCLES, **DYN_LEAVE)
    _add_counts(totals, counts)
    _same_result("(d) DynTopology vs alive mask", left, masked)
    print(f"[dynamic] (d) grid n={small.n} drift 10000 churn 500, "
          f"{DYN_LEAVE_CYCLES} cycles, seed {seed} (no churn draw picks a "
          f"dead peer): DynTopology {left} == the alive mask's in every "
          f"key; {stats}", flush=True)
    print(f"[dynamic] launches {totals}", flush=True)
    return totals


def _demo(name):
    """The demo twin ``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demo_run(name, argv, fused=True, echo=True):
    """``main(argv)`` of a demo twin with its stdout captured (and printed,
    prefixed, with ``echo``), the launch counters and the do-while's read
    counter zeroed before it and read after it.  Returns (result, counts,
    do-while reads, wall s, peak GiB on the card)."""
    import contextlib
    import io

    mod = _demo(name)
    out = io.StringIO()
    dev = torch.device("cpu" if "cpu" in argv else "cuda")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    lss.host_syncs = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = mod.main(argv)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts, syncs = kernels.counts(), lss.host_syncs
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if dev.type == "cuda" else 0.0)
    if fused:
        _require_launched(name, counts)
    elif any(counts[k] for k in KERNELS):
        raise AssertionError(f"{name} {argv}: launched a kernel")
    if echo:
        for line in out.getvalue().splitlines():
            print(f"[demo {name}] {line}", flush=True)
    return res, counts, syncs, wall, peak


def _monitor_line(label, res, counts, syncs, peak):
    walls = res["walls"]
    served = [len(r) for r in res["records"]]
    k = res["k"]
    tc = sum(served) * k / sum(walls)
    n = len(walls)
    print(f"[monitor] {label} n={res['peers']} n_cap {res['n_cap']}: "
          f"dispatch wall ms {[round(w * 1e3, 3) for w in walls]} (median "
          f"{np.median(walls) * 1e3:.3f}); tenant-cycles/s {tc:.1f} "
          f"({sum(served)} tenant windows of {k} cycles); "
          f"{res['preemptions']} preemptions, {res['resumes']} resumes, "
          f"epochs {[e['kind'] for e in res['epochs']]}; attainment by "
          f"class { {p: round(c['attainment'], 4) for p, c in res['classes'].items()} }; "
          f"launches a dispatch "
          f"{ {key: counts[key] / n for key in KERNELS} }; host syncs a "
          f"dispatch {syncs / n:.3f} do-while reads + 1 observe transfer; "
          f"peak memory {peak:.3f} GiB", flush=True)


def phase_demos(dev):
    """The four demo twins on the card at their defaults, and the contended
    priority service at 80,089 peers."""
    demos = dict.fromkeys(KERNELS, 0)
    args = {name: list(DEMO_ARGS[name]) for name in DEMOS}
    res, counts, _, wall, _ = _demo_run("quickstart_torch",
                                        args["quickstart_torch"])
    _add_counts(demos, counts)
    cpu = _demo_run("quickstart_torch",
                    args["quickstart_torch"] + ["--device", "cpu"],
                    fused=False, echo=False)[0]
    if res != cpu:
        raise AssertionError(f"quickstart: card {res} != CPU {cpu}")
    print(f"[demos] quickstart {wall:.3f} s: its dict equals its CPU "
          f"run's ({len(res['printed'])} printed cycles, quiesced at "
          f"{res['quiesced_at']}); launches {counts}", flush=True)

    res, counts, _, wall, _ = _demo_run("sensor_grid_torch",
                                        args["sensor_grid_torch"])
    _add_counts(demos, counts)
    spec = sim.ProblemSpec(n=res["n"], seed=res["seed"])
    alive, _ = _churn_replay(spec.n, spec, res["cycles"], res["noise_ppmc"],
                             res["churn_ppmc"])
    if res["alive_frac"] != alive or res["avg_accuracy"] < DYN_MIN_ACC:
        raise AssertionError(f"sensor_grid: {res} (replayed alive {alive})")
    print(f"[demos] sensor_grid {wall:.3f} s: {res}; launches {counts}",
          flush=True)

    res, counts, _, wall, _ = _demo_run("engine_demo_torch",
                                        args["engine_demo_torch"])
    _add_counts(demos, counts)
    if res["quiesced_at"] is None or res["final_accuracy"] != 1.0:
        raise AssertionError(f"engine_demo: {res}")
    print(f"[demos] engine_demo {wall:.3f} s: quiesced_at "
          f"{res['quiesced_at']} msgs_per_link {res['msgs_per_link']!r} "
          f"c95 {res['c95']} c100 {res['c100']} msgs/link at end "
          f"{res['msgs_per_link_end']}; launches {counts}", flush=True)

    fused, counts, syncs, wall, peak = _demo_run(
        "serve_monitor_torch", args["serve_monitor_torch"])
    _add_counts(demos, counts)
    if (fused["preemptions"] < 1 or fused["resumes"] < 1
            or "regrow" not in [e["kind"] for e in fused["epochs"]]):
        raise AssertionError(f"serve_monitor: no preemption, resume or "
                             f"regrow: {fused['preemptions']}, "
                             f"{fused['resumes']}, {fused['epochs']}")
    plain = _demo_run("serve_monitor_torch",
                      args["serve_monitor_torch"] + ["--plain"], fused=False,
                      echo=False)[0]
    for key in ("records", "slo_report", "controls", "epochs"):
        if fused[key] != plain[key]:
            raise AssertionError(f"serve_monitor: fused and reference "
                                 f"services differ in {key}")
    print(f"[demos] serve_monitor {wall:.3f} s: the fused and reference "
          f"services gave equal records ({sum(map(len, fused['records']))} "
          f"over {len(fused['records'])} dispatches), SLO reports, control "
          f"trail and epochs", flush=True)
    _monitor_line("defaults", fused, counts, syncs, peak)
    print(f"[demos] launches {demos}", flush=True)

    res, monitor, syncs, wall, peak = _demo_run(
        "serve_monitor_torch", list(MONITOR_FULL), echo=False)
    if (res["preemptions"] < 1
            or "regrow" not in [e["kind"] for e in res["epochs"]]):
        raise AssertionError(f"monitor at {res['peers']}: {res['epochs']}")
    _monitor_line(f"contended {res['queries']} tenants in {res['slots']} "
                  f"slots ({wall:.1f} s in all)", res, monitor, syncs, peak)
    return demos, {k: monitor[k] for k in KERNELS}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in fp32
    dev = torch.device("cuda")

    gpu = _gpu_line()
    print(gpu, flush=True)

    t0 = time.perf_counter()
    dry = start_dryruns()  # beside the build: no timed phase shares the host
    built = _build.build()
    print(f"[build] {built or 'cached'} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    dry_recs = [f.result(timeout=DRYRUN_TIMEOUT_S) for f in dry]
    print(f"[build] phase 19's dry-run cells, in child processes beside the "
          f"build, done at {time.perf_counter() - t0:.1f} s", flush=True)
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
    mesh_totals, sync_us = phase("phase 14", phase_mesh, topos, dev)
    plan_totals, mesh_async_totals = phase("phase 15", phase_engine_rest,
                                           topos, dev, sync_us)
    zoo = phase("phase 16", phase_zoo, dev, gpu)
    train = phase("phase 17", phase_train, dev, gpu)
    substrate = phase("phase 18", phase_substrate, dev, gpu)
    mesh_steps = phase("phase 19", phase_mesh_steps, dev, gpu, dry_recs)
    dyn_totals = phase("phase 20", phase_dynamic, topos, dev)
    demo_totals, monitor_totals = phase("phase 21", phase_demos, dev)

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
                         + overlap_totals[name] + audit_totals[name]
                         + mesh_totals[name] + plan_totals[name]
                         + mesh_async_totals[name] + dyn_totals[name]
                         + demo_totals[name] + monitor_totals[name]),
            "launches_by_path": {"run_static": totals[name],
                                 "service": svc_totals[name],
                                 "engine": eng_totals[name],
                                 "sweep": sweep_totals[name],
                                 **{path: t[name]
                                    for path, t in aq_totals.items()},
                                 "service_churn": churn_totals[name],
                                 "service_engine": engine_svc_totals[name],
                                 "service_overlap": overlap_totals[name],
                                 "service_audit": audit_totals[name],
                                 "engine-mesh": mesh_totals[name],
                                 "autotune": plan_totals[name],
                                 "engine-mesh-async":
                                     mesh_async_totals[name],
                                 "dynamic": dyn_totals[name],
                                 "demos": demo_totals[name],
                                 "monitor-contended": monitor_totals[name]},
            "library_ms": None, **entry, "by_shape": shapes, "gpu": gpu})
    print(json.dumps({"zoo": zoo, "gpu": gpu}), flush=True)
    print(json.dumps({"train": train, "gpu": gpu}), flush=True)
    print(json.dumps({"distributed": substrate, "gpu": gpu}), flush=True)
    print(json.dumps({"mesh_steps": mesh_steps, "gpu": gpu}, default=str),
          flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
