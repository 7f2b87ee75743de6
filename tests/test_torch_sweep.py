"""The port's batched sweeps (``repro_torch.engine.sweep``) against the JAX
package's and against sequential ``run_static`` runs.

Every trial is one slot of the core's stacked state, so at ``drop_rate=0``
each trial's per-cycle accuracy, quiescence and cumulative message count
must equal the JAX sweep's and a sequential run's exactly.  The families
are ``sim.make_problem``'s Voronoi centers (no halfspace threshold at the
data mean, whose ``want`` is a rounding tie: ROADMAP C).
"""

import dataclasses

import numpy as np
import pytest

from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.engine import sweep as j_sweep
from repro_torch.core import lss as t_lss
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top
from repro_torch.engine import sweep as t_sweep
from test_torch_formulas import assert_exact

SEEDS = [0, 1, 2]
CYCLES = 40


def _assert_sweep(got, want):
    for key in ("accuracy", "quiescent", "msgs"):
        assert got[key].shape == want[key].shape, key
        assert_exact(got[key], want[key], key)
    assert got["num_edges"] == want["num_edges"]


@pytest.mark.parametrize("use_kernels", [None, True],
                         ids=["reference", "fused"])
@pytest.mark.parametrize("make", [lambda m: m.grid(64),
                                  lambda m: m.chord(60)],
                         ids=["grid", "chord"])
def test_sweep_static_matches_jax(make, use_kernels):
    want = j_sweep.sweep_static(make(j_top), j_sim.ProblemSpec(n=64),
                                SEEDS, cycles=CYCLES)
    got = t_sweep.sweep_static(make(t_top), t_sim.ProblemSpec(n=64), SEEDS,
                               cycles=CYCLES, device="cpu",
                               use_kernels=use_kernels)
    _assert_sweep(got, want)


def test_sweep_matches_sequential_runs():
    topo = t_top.grid(49)
    spec = t_sim.ProblemSpec(n=49)
    res = t_sweep.sweep_static(topo, spec, SEEDS, cycles=80, device="cpu")
    assert res["accuracy"].shape == (3, 80)
    for i, s in enumerate(SEEDS):
        seq = t_sim.run_static(topo, dataclasses.replace(spec, seed=s),
                               max_cycles=80, device="cpu")
        assert res["accuracy"][i, -1] == seq["final_accuracy"]
        assert res["msgs"][i, -1] == seq["total_msgs"]
        q = seq["quiesced_at"]
        assert q is not None and bool(res["quiescent"][i, q - 1])
        assert not res["quiescent"][i, :q - 1].any()
        for level, key in ((0.95, "cycles_95"), (1.0, "cycles_100")):
            assert t_sweep.cycles_to_accuracy(res["accuracy"], level)[i] \
                == seq[key]


@pytest.mark.parametrize("batch_knobs", [True, False])
def test_sweep_configs_matches_jax(batch_knobs):
    """Two structural groups; the first batches three knob settings."""
    knobs = [dict(), dict(beta=0.05, ell=2), dict(eps=1e-3),
             dict(policy="uniform")]
    names = ["base", "beta-ell", "eps", "uniform"]
    want = j_sweep.sweep_configs(
        j_top.chord(60), j_sim.ProblemSpec(n=60), SEEDS[:2],
        [j_lss.LSSConfig(**k) for k in knobs], cycles=CYCLES, names=names,
        batch_knobs=batch_knobs)
    got = t_sweep.sweep_configs(
        t_top.chord(60), t_sim.ProblemSpec(n=60), SEEDS[:2],
        [t_lss.LSSConfig(**k) for k in knobs], cycles=CYCLES, names=names,
        batch_knobs=batch_knobs, device="cpu")
    assert list(got) == names
    for name in names:
        _assert_sweep(got[name], want[name])


def test_cycles_to_accuracy_matches_jax():
    acc = np.random.default_rng(0).uniform(0.8, 1.0, (4, 30))
    acc[2] = 0.5
    for level in (0.9, 0.95, 1.0):
        assert_exact(t_sweep.cycles_to_accuracy(acc, level),
                     j_sweep.cycles_to_accuracy(acc, level))
