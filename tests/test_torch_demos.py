"""The port's twins of the four paper demos (``examples/*_torch.py``)
against the JAX package, on the CPU.

Each twin runs small through its ``main(argv)`` with ``--device cpu``; the
JAX side makes the same calls at the same sizes (``serve_monitor.py`` runs
itself, in process).  Every input and event stream is drawn from numpy
with fixed seeds, so each case gives the same result on every run.  At
``drop_rate=0`` the numbers must be equal (``run_dynamic``'s averages
within 1e-9, the sum of per-cycle floats); with message loss the streams
differ by design (ROADMAP C), so the twin is held to JAX's churn, which
numpy alone draws, and to its accuracy less 0.02.
"""

import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import lss as j_lss
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro.core import wvs as j_wvs
from repro.engine import EngineConfig as JEngineConfig
from repro.engine import sweep_static as j_sweep_static
from repro.engine.sweep import cycles_to_accuracy as j_cycles_to_accuracy
from repro_torch import kernels as t_kernels
from repro_torch.core import lss as t_lss
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("quickstart_torch", "sensor_grid_torch", "engine_demo_torch",
         "serve_monitor_torch")


def _twin(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_twin(name, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = _twin(name).main(argv)
    return res, out.getvalue()


def test_quickstart_matches_jax_loop():
    n = 256
    res, out = _run_twin("quickstart_torch", ["--n", str(n), "--device",
                                              "cpu"])
    # examples/quickstart.py's loop at the same n.
    topo = j_top.grid(n)
    ta = j_lss.TopoArrays.from_topology(topo)
    centers = jnp.array([[0.0, 0.0], [2.0, 2.0], [4.0, 0.0]])
    rng = np.random.default_rng(0)
    inputs = rng.normal(loc=(1.8, 1.9), scale=1.5,
                        size=(n, 2)).astype(np.float32)
    state = j_lss.init_state(ta, j_wvs.from_vector(jnp.asarray(inputs),
                                                   jnp.ones((n,))))
    cfg = j_lss.LSSConfig(beta=1e-3, ell=1)
    want = []
    for cycle in range(200):
        state, _ = j_lss.cycle(state, ta, centers, cfg)
        acc, quiescent, _ = j_lss.metrics(state, ta, centers)
        if cycle % 5 == 0 or quiescent:
            want.append((cycle, float(acc), int(state.msgs),
                         bool(quiescent)))
        if quiescent:
            break
    assert want[-1][3], "the JAX loop never quiesced"
    assert res["printed"] == want
    assert res["quiesced_at"] == want[-1][0]
    assert res["msgs_per_link"] == float(state.msgs) / topo.num_edges
    assert res["true_choice"] == 1
    assert out.count("\ncycle ") + out.startswith("cycle ") == len(want)


def _sensor_grid_jax(drop):
    n = 24 * 24
    return j_sim.run_dynamic(
        j_top.grid(n),
        j_sim.ProblemSpec(n=n, k=3, d=2, bias=0.2, std=2.0, seed=7),
        j_lss.LSSConfig(drop_rate=drop), cycles=120, noise_ppmc=1000.0,
        churn_ppmc=100.0, warmup=30)


def _sensor_grid_twin(drop):
    res, out = _run_twin("sensor_grid_torch", [
        "--n", str(24 * 24), "--cycles", "120", "--warmup", "30",
        "--drop", str(drop), "--device", "cpu"])
    assert f"{res['avg_accuracy'] * 100:6.2f}%" in out
    assert f"{res['alive_frac'] * 100:6.1f}%" in out
    return res


def test_sensor_grid_without_loss_matches_jax():
    want = _sensor_grid_jax(0.0)
    got = _sensor_grid_twin(0.0)
    assert got["alive_frac"] < 1.0  # the churn really happened
    assert got["cycles"] == 120 and got["drop_rate"] == 0.0
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_sensor_grid_with_the_demos_loss_tracks_jax():
    want = _sensor_grid_jax(0.02)
    got = _sensor_grid_twin(0.02)
    assert got["alive_frac"] == want["alive_frac"]  # numpy's draws alone
    assert got["avg_accuracy"] >= want["avg_accuracy"] - 0.02
    assert got["msgs_per_link_per_cycle"] > 0


def test_engine_demo_matches_jax():
    n, seeds, cycles = 32 * 32, [0, 1, 2], 60
    res, _ = _run_twin("engine_demo_torch", [
        "--n", str(n), "--seeds", "3", "--sweep-cycles", str(cycles),
        "--device", "cpu"])
    topo = j_top.grid(n)
    spec = j_sim.ProblemSpec(n=n, seed=0)
    want = j_sim.run_static(
        topo, spec, max_cycles=300,
        engine=JEngineConfig(num_shards=4, cycles_per_dispatch=10))
    assert want["quiesced_at"] is not None
    for key in ("engine_shards", "cut_edges", "quiesced_at",
                "final_accuracy", "msgs_per_link"):
        assert res[key] == want[key], key
    sweep = j_sweep_static(topo, spec, seeds, cycles=cycles)
    acc = np.asarray(sweep["accuracy"])
    assert res["seeds"] == seeds
    assert res["c95"] == j_cycles_to_accuracy(acc, 0.95).tolist()
    assert res["c100"] == j_cycles_to_accuracy(acc, 1.0).tolist()
    end = (np.asarray(sweep["msgs"])[:, -1]
           / sweep["num_edges"]).round(2).tolist()
    assert res["msgs_per_link_end"] == end


SERVE_ARGS = ["--n", "256", "--queries", "12", "--slots", "8",
              "--dispatches", "4", "--k", "4", "--joins", "6"]


def _masked(text):
    """The lines without wall times and without the suite line."""
    text = re.sub(r"\(\d+\.\d+s\)", "(<s>)", text)
    text = re.sub(r"in \d+\.\d+s \([\d,]+ query-cycles/s\)",
                  "in <s> (<rate>)", text)
    text = re.sub(r"\(max \w+ \d+\.\d+ms\)", "(max <span>)", text)
    return [line for line in text.splitlines()
            if not line.startswith("dispatch runs the ")]


def test_serve_monitor_prints_jaxs_lines(monkeypatch):
    res, got = _run_twin("serve_monitor_torch", SERVE_ARGS + ["--device",
                                                              "cpu"])
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv",
                        [str(EXAMPLES / "serve_monitor.py"), *SERVE_ARGS])
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(EXAMPLES / "serve_monitor.py"),
                       run_name="__main__")
    want = out.getvalue()
    assert _masked(got) == _masked(want)
    assert len(_masked(got)) > 30
    assert got.splitlines()[0] == ("dispatch runs the 'reference' kernel "
                                   "suite (fused=False)")
    # The contention and the regrow the demo is about.
    assert res["preemptions"] > 0
    assert [e["kind"] for e in res["epochs"]] == ["init", "regrow"]
    assert res["n_cap"][1] > res["n_cap"][0]
    assert len(res["records"]) == 4


@pytest.mark.parametrize("case", ["drift", "loss", "dyntopo"])
def test_run_dynamic_with_fused_suite_on_cpu_matches(case):
    """use_kernels=True on CPU tensors runs the kernels' plain versions
    through ops: the reference suite's averages, with message loss too
    (the loss draws do not depend on the suite)."""
    def topo():
        t = t_top.grid(144)
        return t_top.DynTopology.from_topology(t) if case == "dyntopo" else t

    kw = dict(cycles=80, noise_ppmc=10_000.0, churn_ppmc=1_500.0, warmup=20,
              device="cpu")
    cfg = t_lss.LSSConfig(drop_rate=0.05 if case == "loss" else 0.0)
    # Seed 2 never draws an already-dead peer for churn at these rates.
    spec = t_sim.ProblemSpec(n=144, seed=2, bias=0.2, std=2.0)
    t_kernels.reset_counts()
    a = t_sim.run_dynamic(topo(), spec, cfg, use_kernels=True, **kw)
    fused = t_kernels.counts()
    t_kernels.reset_counts()
    b = t_sim.run_dynamic(topo(), spec, cfg, use_kernels=False, **kw)
    plain = t_kernels.counts()
    assert a == b
    assert a["alive_frac"] < 1.0
    for key in ("lss_state_ref", "correction_ref", "region_decide_ref"):
        assert fused[key] > 0 and plain[key] == 0, key


@pytest.mark.parametrize("name", TWINS)
def test_twin_default_device_is_cuda_or_raises(name):
    if torch.cuda.is_available():
        assert repro_torch.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        _twin(name).main([])
