"""The port's dry-run (``repro_torch.launch.dryrun``): rank 0's step of a
cell traced on ``meta`` tensors in a fake world of 256 / 512 ranks.

* The count is the real program's: in a fake world of 4 on a (2, 2)
  ("data", "model") mesh, the dry-run's count of yi-9b smoke at 4 layers
  (FSDP, remat; past the three depths it traces, so carried to the fourth)
  equals, exactly, ``cost.analyze`` on rank 0 of a real 4-rank gloo run of
  the same steps (a train cell at accum 4, carried from 2 and 3
  microbatches, and a decode cell): flops, HBM bytes and collective bytes
  by op.
* Full-width cells on the 256-rank production mesh (mamba2-370m train_4k
  and prefill_32k single, through the CLI) are ``ok``, with the record's
  keys, positive argument and temporary bytes, finite
  ``bytes_per_device`` and ``useful_flops_ratio`` (printed).
* ``configs.skip_reason`` cells come out ``"skipped"``; ``model_flops``
  is JAX's formula (restated here) on the port's configs, whose parameter
  counts equal JAX's.

Each dry-run runs in a child process: the fake process group owns its
process.  JAX's ``repro.launch.dryrun`` is not imported (it sets
``XLA_FLAGS`` at import).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import torch_ranks
from repro_torch import configs
from repro_torch.distributed import launch
from repro_torch.launch import dryrun

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
           + str(ROOT / "tests"))
KEYS = {"arch", "shape", "mesh", "status", "n_chips", "accum_steps",
        "trace_s", "counted_flops_per_device", "counted_bytes_per_device",
        "collective_bytes_per_device", "model_flops_global",
        "model_flops_per_device", "useful_flops_ratio", "roofline",
        "dominant", "step_time_bound_s", "memory_analysis",
        "bytes_per_device", "model_gathered"}

_FAKE_COUNT = """
import json, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
import torch_ranks as tr
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.training import TrainHParams
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", tr.STEP_MESH[0], mesh_dim_names=tr.STEP_MESH[1])
out = {}
for name, kind, length, rows, accum in tr.DRYRUN_CELLS:
    cell = configs.ShapeCell(name, kind, length, rows)
    out[name] = dryrun.count(tr.dryrun_cfg(), cell, mesh,
                             TrainHParams(accum_steps=accum))
dist.destroy_process_group()
print("RESULT" + json.dumps(out))
"""


def _start(args):
    return subprocess.Popen(args, env=ENV, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)


def _done(proc, timeout=240):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    return out


def _run(args):
    return _done(_start(args))


def test_dryrun_count_equals_real_run():
    child = _start([sys.executable, "-c", _FAKE_COUNT])  # beside the ranks
    real = launch.spawn(torch_ranks.dryrun_real_body, 4, timeout_s=240)[0]
    fake = json.loads(_done(child).split("RESULT", 1)[1])
    for name, *_ in torch_ranks.DRYRUN_CELLS:
        got, want = fake[name], real[name]
        assert got["flops"] == want["flops"], name
        assert got["hbm_bytes"] == want["hbm_bytes"], name
        assert got["collective_bytes"] == {
            k: int(v) for k, v in want["collective_bytes"].items()}, name
        assert want["collective_bytes"]["all-gather"] > 0
        if name == "t":
            assert want["collective_bytes"]["all-reduce"] > 0


@pytest.mark.parametrize("shape,accum", [("train_4k", 8),
                                         ("prefill_32k", 1)])
def test_dryrun_full_width_cell(tmp_path, shape, accum):
    out = _run([sys.executable, "-m", "repro_torch.launch.dryrun",
                "--arch", "mamba2-370m", "--shape", shape, "--mesh",
                "single", "--out", str(tmp_path)])
    assert "ok" in out
    rec = json.loads((tmp_path / f"mamba2-370m__{shape}__single.json")
                     .read_text())
    assert rec["status"] == "ok" and set(rec) == KEYS
    assert rec["n_chips"] == 256 and rec["accum_steps"] == accum
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0
    assert np.isfinite(rec["bytes_per_device"])
    assert rec["bytes_per_device"] == sum(mem.values())
    assert 0 < rec["useful_flops_ratio"] < 1
    assert rec["dominant"] in rec["roofline"]
    assert rec["step_time_bound_s"] == max(rec["roofline"].values())
    print(f"mamba2-370m {shape} single: useful_flops_ratio "
          f"{rec['useful_flops_ratio']}, bytes_per_device "
          f"{rec['bytes_per_device']}, dominant {rec['dominant']}")


def test_dryrun_skipped_cells(tmp_path):
    _run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
          "yi-9b", "--shape", "long_500k", "--mesh", "both", "--out",
          str(tmp_path)])
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"yi-9b__long_500k__{mesh}.json")
                         .read_text())
        assert rec["status"] == "skipped"
        assert rec["reason"] == configs.skip_reason("yi-9b", "long_500k")


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_dryrun_model_flops(arch):
    """JAX's ``model_flops``: 6 N D train, 2 N D prefill, 2 N B decode, N
    the active parameters (the port's counts equal JAX's configs')."""
    import repro.configs as j_cfgs

    cfg, j_cfg = configs.get(arch), j_cfgs.get(arch)
    assert cfg.param_count() == j_cfg.param_count()
    n = getattr(cfg, "active_param_count", cfg.param_count)()
    assert n == getattr(j_cfg, "active_param_count", j_cfg.param_count)()
    for cell in configs.SHAPES:
        want = {"train": 6.0 * n * cell.global_batch * cell.seq_len,
                "prefill": 2.0 * n * cell.global_batch * cell.seq_len,
                "decode": 2.0 * n * cell.global_batch}[cell.kind]
        assert dryrun.model_flops(cfg, cell) == want
