"""Batched scenario sweeps: whole experiments stacked on one device (port
of ``repro/engine/sweep.py``).

The paper's figures average many independent trials per data point (seeds
x configurations).  Here the trial axis is the core's query-slot axis:
every trial is one slot of one stacked :class:`~repro_torch.core.lss.
LSSState` with its own packed region family, so each cycle is one batched
``lss_state`` / ``correction`` launch for all trials on the card.

* :func:`sweep_static` — the static-data experiment for many seeds (fresh
  centers + inputs per seed, same topology).  Returns per-seed, per-cycle
  accuracy / quiescence / message trajectories.
* :func:`sweep_configs` — the multi-config axis.  Configs sharing their
  structural fields (policy, drop rate, correction-loop bound) differ only
  in ``beta`` / ``ell`` / ``eps``, which go in as (Q,) tensors (as the
  service passes its tenants' knobs), so such a group is one batch of
  config x seed trials.

Differences from the JAX twin: the cycles are a host loop (JAX scans them
in one dispatch), and the per-cycle results stay on the device until the
sweep ends.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import lss, regions, sim, topology, wvs
from ..kernels import ops as kernel_ops
from ..kernels.suite import resolve_suite

__all__ = ["sweep_static", "sweep_configs", "cycles_to_accuracy"]


def cycles_to_accuracy(accuracy: np.ndarray, level: float) -> np.ndarray:
    """Per-seed first cycle (1-based) reaching ``level``; -1 if never."""
    hit = accuracy >= level
    first = hit.argmax(axis=1) + 1
    return np.where(hit.any(axis=1), first, -1)


def _static_key(cfg: lss.LSSConfig):
    """The structural fields — configs sharing these batch together."""
    return (cfg.policy, float(cfg.drop_rate), int(cfg.max_corr_iters))


def _setup_trials(topo, spec, seeds, device):
    """Topology tables, the stacked initial state (one slot per seed) and
    the seeds' Voronoi families, each as ``sim.run_static`` poses it."""
    ta = lss.TopoArrays.from_topology(topo, device)
    xs, fams = [], []
    for s in seeds:
        sp = dataclasses.replace(spec, seed=int(s))
        centers, sample, _, _ = sim.make_problem(sp)
        xs.append(sample(np.random.default_rng(sp.seed + 1), topo.n))
        fams.append(regions.VoronoiRegions(centers.to(device)))
    x = torch.from_numpy(np.stack(xs)).to(device)
    inputs = wvs.from_vector(x, torch.ones(x.shape[:-1], dtype=torch.float32,
                                           device=device))
    state = lss.init_state(ta, inputs, seed=[int(s) for s in seeds])
    return ta, state, regions.PackedRegions.pack(fams)


def _run_trials(ta, state, fams, cfg, cycles, suite):
    """``cycles`` batched cycles, observed after each one at the observe
    eps.  Returns numpy (accuracy, quiescent, cumulative msgs), each
    (trials, cycles)."""
    tables = kernel_ops.prep_slots(fams, cfg.eps)
    observe = kernel_ops.prep_slots(fams, sim.OBSERVE_EPS)
    decide = lambda v: suite.decide(v, observe)  # noqa: E731
    accs, quiet, sent = [], [], []
    for _ in range(cycles):
        state, _ = lss.cycle_impl(state, ta, cfg, None, suite=suite,
                                  regions=tables)
        acc, quiescent, _, _ = lss.metrics_impl(
            state, ta, decide, sim.OBSERVE_EPS, suite=suite, regions=observe)
        accs.append(acc)
        quiet.append(quiescent)
        # Collect the per-cycle count and reset the counter, so the host
        # cumsum below is exact at any length.
        sent.append(state.msgs)
        state = state._replace(msgs=torch.zeros_like(state.msgs))
    host = lambda xs: torch.stack(xs, dim=1).cpu().numpy()  # noqa: E731
    msgs = np.cumsum(host(sent).astype(np.int64), axis=1)
    return host(accs), host(quiet), msgs


def sweep_static(
    topo: topology.Topology,
    spec: sim.ProblemSpec,
    seeds: Sequence[int],
    cfg: lss.LSSConfig = lss.LSSConfig(),
    cycles: int = 200,
    device=None,
    use_kernels=None,
):
    """Run ``len(seeds)`` independent static experiments, batched.

    Each seed re-derives the problem (fresh centers + inputs via
    ``sim.make_problem``) exactly as a sequential ``sim.run_static`` with
    ``ProblemSpec(seed=s)`` would.  ``device`` and ``use_kernels`` as in
    ``sim.run_static``.  Returns a dict of arrays:

      accuracy   (n_seeds, cycles)  float
      quiescent  (n_seeds, cycles)  bool
      msgs       (n_seeds, cycles)  cumulative sends
    """
    device = resolve_device(device)
    ta, state, fams = _setup_trials(topo, spec, seeds, device)
    acc, quiescent, msgs = _run_trials(ta, state, fams, cfg, cycles,
                                       resolve_suite(use_kernels, device))
    return {"accuracy": acc, "quiescent": quiescent, "msgs": msgs,
            "num_edges": topo.num_edges}


def _sweep_knob_group(topo, spec, seeds, cfgs, cycles, device, suite):
    """ALL seeds x configs of one structural group as one batch: trials
    are flattened (config, seed) pairs, the knobs (Q,) tensors."""
    ta, base, fams = _setup_trials(topo, spec, seeds, device)
    C, S = len(cfgs), len(seeds)
    tile = lambda a: a.repeat(C, *([1] * (a.ndim - 1)))  # noqa: E731
    state = base._replace(
        **{f: tile(getattr(base, f)) for f in lss.LSSState._fields
           if f != "rng"},
        rng=tuple(lss._generator(device, int(s)) for _ in cfgs
                  for s in seeds))
    fams = regions.PackedRegions(*(tile(f) for f in fams))
    rep = lambda xs, dt: torch.tensor(  # noqa: E731
        xs, dtype=dt, device=device).repeat_interleave(S)
    cfg = cfgs[0]._replace(
        beta=rep([c.beta for c in cfgs], torch.float32),
        ell=rep([c.ell for c in cfgs], torch.int32),
        eps=rep([c.eps for c in cfgs], torch.float32))
    acc, quiescent, msgs = _run_trials(ta, state, fams, cfg, cycles, suite)
    shape = lambda a: a.reshape(C, S, cycles)  # noqa: E731
    acc, quiescent, msgs = shape(acc), shape(quiescent), shape(msgs)
    return [{"accuracy": acc[i], "quiescent": quiescent[i], "msgs": msgs[i],
             "num_edges": topo.num_edges} for i in range(C)]


def sweep_configs(
    topo: topology.Topology,
    spec: sim.ProblemSpec,
    seeds: Sequence[int],
    cfgs: Sequence[lss.LSSConfig],
    cycles: int = 200,
    names: Optional[Sequence[str]] = None,
    batch_knobs: bool = True,
    device=None,
    use_kernels=None,
):
    """Sweep seeds x configs; results keyed per config.

    With ``batch_knobs`` (default) each group of configs sharing their
    structural fields is one batch of all its seeds x configs;
    ``batch_knobs=False`` runs one :func:`sweep_static` per config.
    """
    keys = [names[i] if names else f"cfg{i}" for i in range(len(cfgs))]
    out = {}
    if not batch_knobs:
        for key, cfg in zip(keys, cfgs):
            out[key] = sweep_static(topo, spec, seeds, cfg, cycles,
                                    device=device, use_kernels=use_kernels)
        return out
    device = resolve_device(device)
    suite = resolve_suite(use_kernels, device)
    groups = {}
    for i, cfg in enumerate(cfgs):
        groups.setdefault(_static_key(cfg), []).append(i)
    for idxs in groups.values():
        res = _sweep_knob_group(topo, spec, seeds, [cfgs[i] for i in idxs],
                                cycles, device, suite)
        for i, r in zip(idxs, res):
            out[keys[i]] = r
    return out
