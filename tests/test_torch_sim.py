"""The port's Sec.-VI driver (``repro_torch.core.sim``) against the JAX
package's, and the port's independence from JAX.

At ``drop_rate=0`` both packages draw the same inputs, noise and churn from
numpy, so ``run_static`` must give equal cycle counts, message counts and
accuracy, and ``run_dynamic`` equal averages (within 1e-9, the summation of
per-cycle floats).  With message loss the streams differ (JAX threefry vs
a torch generator), so the port is held to convergence alone.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro.core import sim as j_sim
from repro.core import topology as j_top
from repro_torch.core import lss as t_lss
from repro_torch.core import sim as t_sim
from repro_torch.core import topology as t_top

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
EXAMPLE_TWINS = ("serve_lm_torch", "train_lm_torch", "quickstart_torch",
                 "sensor_grid_torch", "engine_demo_torch",
                 "serve_monitor_torch")

STATIC_KEYS = ("n", "cycles_95", "cycles_100", "quiesced_at",
               "final_accuracy", "quiescent", "msgs_per_link", "total_msgs")


@pytest.mark.parametrize("make", [
    lambda m: m.grid(256),
    lambda m: m.barabasi_albert(256, m=2, seed=1),
    lambda m: m.chord(256),
], ids=["grid", "ba", "chord"])
def test_run_static_matches_jax(make):
    spec = j_sim.ProblemSpec(n=256)
    want = j_sim.run_static(make(j_top), spec, max_cycles=300)
    got = t_sim.run_static(make(t_top), t_sim.ProblemSpec(n=256),
                           max_cycles=300, device="cpu")
    assert got["quiesced_at"] is not None
    for key in STATIC_KEYS:
        assert got[key] == want[key], key


def test_run_static_with_fused_suite_on_cpu_matches():
    """use_kernels=True on CPU tensors runs the kernels' plain versions
    through ops: same outcome as the reference suite."""
    topo = t_top.grid(144)
    spec = t_sim.ProblemSpec(n=144, seed=3)
    a = t_sim.run_static(topo, spec, max_cycles=200, device="cpu",
                         use_kernels=True)
    b = t_sim.run_static(topo, spec, max_cycles=200, device="cpu",
                         use_kernels=False)
    assert a == b


@pytest.mark.parametrize("dyn", [False, True], ids=["alive-mask", "dyntopo"])
def test_run_dynamic_matches_jax(dyn):
    def topo(mod):
        t = mod.grid(256)
        return mod.DynTopology.from_topology(t) if dyn else t

    # Seed 2 never draws an already-dead peer for churn (see below).
    kw = dict(cycles=60, noise_ppmc=20_000.0, churn_ppmc=1_500.0, warmup=10)
    want = j_sim.run_dynamic(topo(j_top), j_sim.ProblemSpec(n=256, seed=2),
                             **kw)
    got = t_sim.run_dynamic(topo(t_top), t_sim.ProblemSpec(n=256, seed=2),
                            device="cpu", **kw)
    assert got["alive_frac"] < 1.0  # the churn really happened
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


def test_run_dynamic_dyntopology_rekill_raises_in_both():
    """The churn draw may pick a peer that is already dead; on a
    DynTopology the JAX driver then calls ``remove_peer`` on an absent
    peer and raises.  The port keeps that behaviour (ROADMAP C.4)."""
    kw = dict(cycles=60, noise_ppmc=20_000.0, churn_ppmc=3_000.0, warmup=10)
    for mod, sim_mod, extra in ((j_top, j_sim, {}),
                                (t_top, t_sim, {"device": "cpu"})):
        dyn = mod.DynTopology.from_topology(mod.grid(256))
        with pytest.raises(ValueError, match="not present"):
            sim_mod.run_dynamic(dyn, sim_mod.ProblemSpec(n=256), **kw,
                                **extra)


def test_message_loss_converges():
    res = t_sim.run_static(t_top.grid(256), t_sim.ProblemSpec(n=256),
                           t_lss.LSSConfig(drop_rate=0.1), max_cycles=600,
                           device="cpu")
    assert res["final_accuracy"] == 1.0
    assert res["quiescent"]


def test_default_device_is_cuda_or_raises():
    topo = t_top.grid(16)
    spec = t_sim.ProblemSpec(n=16)
    if torch.cuda.is_available():
        assert repro_torch.default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.run_static(topo, spec, max_cycles=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_sim.run_dynamic(topo, spec, cycles=2)


def test_engine_unported_options_raise(monkeypatch):
    """The engine route runs (async and quantized too, profiled, and
    auto-planned: every option of the engine is ported)."""
    from repro_torch.engine import EngineConfig, autotune

    topo, spec = t_top.grid(16), t_sim.ProblemSpec(n=16)
    for ecfg in (2, EngineConfig(async_mode=True, staleness=1),
                 EngineConfig(wire="int8"), EngineConfig(wire="bf16")):
        res = t_sim.run_static(topo, spec, engine=ecfg, device="cpu")
        assert res["engine_shards"] == 2 and res["quiescent"]
    # profile=True runs (A.7) and changes no result.
    assert (t_sim.run_static(topo, spec, engine=EngineConfig(profile=True),
                             device="cpu")
            == t_sim.run_static(topo, spec, engine=EngineConfig(),
                                device="cpu"))
    # auto_plan=True (A.8) runs: its result is that of the plan it adopts.
    planned = {}
    plan = autotune.plan

    def record(*args, **kw):
        planned["result"] = plan(*args, **kw)
        return planned["result"]

    monkeypatch.setattr(autotune, "plan", record)
    res = t_sim.run_static(topo, spec, engine=EngineConfig(auto_plan=True),
                           device="cpu")
    assert res["engine_shards"] == 2 and res["quiescent"]
    assert res == t_sim.run_static(topo, spec,
                                   engine=planned["result"].config,
                                   device="cpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "examples" / f"{name}.py" for name in EXAMPLE_TWINS]
    assert len(files) > 10
    assert PORT / "models" / "attention.py" in files
    assert PORT / "configs" / "zamba2_27b.py" in files
    assert PORT / "training" / "trainer.py" in files
    assert PORT / "checkpoint" / "store.py" in files
    for path in files:
        bad = ({"jax", "jaxlib", "repro", "ml_dtypes"}
               & set(_imported_roots(path)))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_import_leaves_jax_unloaded():
    code = ("import sys\n"
            "import repro_torch, repro_torch.convert\n"
            "import repro_torch.core.sim, repro_torch.kernels.ops\n"
            "import repro_torch.engine, repro_torch.engine.sweep\n"
            "import repro_torch.service, repro_torch.obs.validate\n"
            "import repro_torch.obs.forensics, repro_torch.obs.audit\n"
            "import repro_torch.models, repro_torch.configs as cfgs\n"
            "import repro_torch.optim, repro_torch.data\n"
            "import repro_torch.checkpoint, repro_torch.training\n"
            "[cfgs.get(a) for a in cfgs.ARCH_IDS]\n"
            "import importlib.util\n"
            f"for name in {EXAMPLE_TWINS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(name, "
            f"{str(ROOT / 'examples')!r} + f'/{{name}}.py')\n"
            "    spec.loader.exec_module("
            "importlib.util.module_from_spec(spec))\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert 'repro' not in sys.modules, 'repro was imported'\n"
            "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes was imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_needs_cuda_and_the_checkout(tmp_path):
    """Without a card, or copied out of the repository alone, the chip
    smoke run exits nonzero and prints no result."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [alone]
    if not torch.cuda.is_available():
        runs.append(ROOT / "chip_smoke.py")
    for script in runs:
        out = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120,
                             env=dict(os.environ, PYTHONPATH=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
