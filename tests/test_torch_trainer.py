"""The port's trainer, remat and training example against the JAX
package's.

* ``Trainer``: the twin of ``tests/test_substrate.py::
  test_trainer_resume_and_fault_recovery``; and for one synthetic step
  function with an injected error and a forced rollback, the port's
  ``metrics_log`` equals JAX's record for record (events, steps, errors
  and straggler flags equal, losses at rtol 1e-6; ``step_time`` is a wall
  time and is left out; ``straggler_factor`` is set so high that no step
  is flagged in either, since the flag reads wall times too).  With a
  ``DeviceMesh`` holding the monitor axes the trainer builds the port's
  ``MeshMonitor`` with JAX's centres.
* The twins of ``tests/test_system.py::test_lm_training_loss_decreases``
  (yi-9b smoke, 30 steps) and ``test_checkpoint_resume_is_exact`` (mamba2
  smoke, bitwise on the CPU), on the port alone.
* ``remat`` (full and ``"dots"``) gives bitwise the loss and grads of
  ``remat=False`` and keeps fewer activations for the backward pass.
* ``examples/train_lm_torch.py --device cpu`` runs and resumes from its
  own checkpoint.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.configs as cfgs
from repro import checkpoint as j_checkpoint
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import clip_by_global_norm as j_clip
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint, tree
from repro_torch.configs import ShapeCell
from repro_torch.data import TokenSource
from repro_torch.models import EncDecConfig, build
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm)
from repro_torch.training import (Trainer, TrainerConfig, TrainHParams,
                                  build_for_cell,
                                  checkpoint_restorable_errors,
                                  loss_and_grads)

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def _port_step(p, o, batch):
    g = {"w": p["w"] - batch}
    _, g = clip_by_global_norm(g, 1e9)
    p2, o2 = adamw_update(p, g, o, 0.1, AdamWConfig(weight_decay=0.0))
    return p2, o2, {"loss": torch.sum(torch.square(p2["w"] - batch))}


def _jax_step(p, o, batch):
    g = {"w": p["w"] - batch}
    _, g = j_clip(g, 1e9)
    p2, o2 = j_adamw_update(p, g, o, 0.1, JAdamWConfig(weight_decay=0.0))
    return p2, o2, {"loss": jnp.sum(jnp.square(p2["w"] - batch))}


def _faults(error_at=17, diverge_at=None):
    """(fault injector raising once at ``error_at``, step wrapper forcing
    one divergent loss at ``diverge_at``)."""
    armed = {"error": True, "diverge": True}

    def fault(step):
        if step == error_at and armed["error"]:
            armed["error"] = False
            raise RuntimeError("injected device failure")

    def wrap(step_fn, batch_step, wait_pending):
        def fn(p, o, batch):
            p2, o2, m = step_fn(p, o, batch)
            if batch_step(batch) == diverge_at and armed["diverge"]:
                armed["diverge"] = False
                m = {"loss": m["loss"] * 0 + 1e5}
                # JAX's trainer reads LATEST before it waits for the
                # async saves: let the last one land first.
                wait_pending()
            return p2, o2, m
        return fn

    return fault, wrap


def test_trainer_resume_and_fault_recovery(tmp_path):
    params = {"w": torch.zeros((4,))}
    opt = adamw_init(params)
    cfg = TrainerConfig(total_steps=30, ckpt_every=10,
                        ckpt_dir=str(tmp_path), log_every=5)
    fault, _ = _faults()
    tr = Trainer(cfg, _port_step, lambda step: torch.full((4,), 1.0))
    params2, opt2 = tr.run(params, opt, fault_injector=fault)
    events = [m.get("event") for m in tr.metrics_log]
    assert "restored" in events  # failure was recovered from a checkpoint
    assert int(opt2.step) >= 30 - 10  # made it to the end after restore
    assert checkpoint.latest_step(tmp_path) == 30


def test_trainer_log_matches_jax(tmp_path):
    """The same run in both packages: an error at step 17 (restored from
    step 10) and a divergent loss at step 23 (rolled back to step 20)."""
    kw = dict(total_steps=30, ckpt_every=10, log_every=3,
              straggler_factor=1e9)

    fault, wrap = _faults(diverge_at=23)
    port = Trainer(TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                   wrap(_port_step, lambda b: int(b[0]),
                        checkpoint.wait_pending),
                   lambda s: torch.full((4,), float(s)))
    p, o = port.run({"w": torch.zeros((4,))}, adamw_init(
        {"w": torch.zeros((4,))}), fault_injector=fault)

    fault, wrap = _faults(diverge_at=23)
    jax_tr = JTrainer(JTrainerConfig(ckpt_dir=str(tmp_path / "jax"), **kw),
                      wrap(_jax_step, lambda b: int(b[0]),
                           j_checkpoint.wait_pending),
                      lambda s: jnp.full((4,), float(s)))
    jp, jo = jax_tr.run({"w": jnp.zeros((4,))},
                        j_adamw_init({"w": jnp.zeros((4,))}),
                        fault_injector=fault)

    got = [{k: v for k, v in r.items() if k != "step_time"}
           for r in port.metrics_log]
    want = [{k: v for k, v in r.items() if k != "step_time"}
            for r in jax_tr.metrics_log]
    assert [r.get("event") for r in got] == [r.get("event") for r in want]
    assert {"restored", "rollback"} <= {r.get("event") for r in got}
    for g, w in zip(got, want, strict=True):
        assert g.keys() == w.keys()
        for key in g:
            if key == "loss":
                np.testing.assert_allclose(g[key], w[key], rtol=1e-6)
            else:
                assert g[key] == w[key], (key, g, w)
    np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    assert int(o.step) == int(jo.step)
    assert (checkpoint.latest_step(tmp_path / "port")
            == checkpoint.latest_step(tmp_path / "jax") == 30)


def test_trainer_builds_the_mesh_monitor():
    """With a ``DeviceMesh`` holding the monitor axes the trainer builds
    the port's ``MeshMonitor`` with JAX's centres (a one-rank gloo
    group)."""
    from torch.distributed.device_mesh import init_device_mesh

    assert checkpoint_restorable_errors() == (RuntimeError,)
    assert issubclass(torch.OutOfMemoryError, checkpoint_restorable_errors())
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        cfg = TrainerConfig(divergence_loss=10.0)
        tr = Trainer(cfg, _port_step, lambda s: None, mesh=mesh)
        assert tr._mon.axes == ("data",)
        np.testing.assert_array_equal(tr._mon.centers.numpy(),
                                      [[5.0], [15.0]])
        assert tr._mon_state.out_m.shape == (1, 2, 1)
        no_axis = Trainer(cfg, _port_step, lambda s: None, mesh=mesh,
                          monitor_axes=("pod",))
        assert no_axis._mon is None
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Twins of tests/test_system.py (the port alone)
# ---------------------------------------------------------------------------


def _step_batch(b):
    return {"tokens": b.tokens, "labels": b.labels}


def test_lm_training_loss_decreases():
    """Small LM, 30 real optimizer steps through the train step: loss must
    drop."""
    cfg = cfgs.get_smoke("yi-9b")
    model = build(cfg, "cpu")
    cell = ShapeCell("t", "train", 64, 8)
    src = TokenSource(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=0)
    step, _, _, _ = build_for_cell(
        model, ("data", "model"), cell,
        TrainHParams(lr=3e-3, warmup=5, total_steps=100))
    params = model.init()
    opt = adamw_init(params)
    losses = []
    for s in range(30):
        params, opt, m = step(params, opt,
                              _step_batch(src.global_batch_at(s)))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_checkpoint_resume_is_exact(tmp_path):
    """Stop at step 10, resume from disk, land bit-identically at step
    12."""
    cfg = cfgs.get_smoke("mamba2-370m")
    model = build(cfg, "cpu")
    cell = ShapeCell("t", "train", 32, 4)
    src = TokenSource(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=1)
    step, _, _, _ = build_for_cell(model, ("data", "model"), cell,
                                   TrainHParams())
    params = model.init()
    opt = adamw_init(params)
    for s in range(10):
        params, opt, _ = step(params, opt, _step_batch(src.global_batch_at(s)))
    checkpoint.save(tmp_path, 10, (params, opt))
    p_ref, o_ref = params, opt
    for s in (10, 11):
        p_ref, o_ref, _ = step(p_ref, o_ref,
                               _step_batch(src.global_batch_at(s)))
    p2, o2 = checkpoint.load(tmp_path, 10, (params, opt))
    for s in (10, 11):
        p2, o2, _ = step(p2, o2, _step_batch(src.global_batch_at(s)))
    assert int(o2.step) == int(o_ref.step) == 12
    for a, b in zip(tree.leaves((p_ref, o_ref)), tree.leaves((p2, o2))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------


def _grads_and_saved(cfg):
    """Loss, grads and the elements autograd saved for the backward
    pass."""
    model = build(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=g)}
    if isinstance(cfg, EncDecConfig):
        batch["frames"] = torch.randn((2, cfg.enc_len, cfg.d_model),
                                      generator=g)
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _, grads = loss_and_grads(model, params, batch)
    return loss, tree.leaves(grads), sum(saved)


@pytest.mark.parametrize("arch,policy", [
    ("qwen3-14b", None), ("qwen3-14b", "dots"), ("mixtral-8x7b", None),
    ("mamba2-370m", None), ("zamba2-2.7b", None), ("zamba2-2.7b", "dots"),
    ("whisper-large-v3", None)])
def test_remat_keeps_loss_and_grads(arch, policy):
    import dataclasses

    cfg = cfgs.get_smoke(arch)
    assert not cfg.remat  # every smoke config
    assert cfgs.get(arch).remat  # every published config
    kw = {} if policy is None else {"remat_policy": policy}
    loss0, grads0, saved0 = _grads_and_saved(cfg)
    loss1, grads1, saved1 = _grads_and_saved(
        dataclasses.replace(cfg, remat=True, **kw))
    assert torch.equal(loss0, loss1)
    for a, b in zip(grads0, grads1, strict=True):
        assert torch.equal(a, b)
    assert saved1 < saved0


# ---------------------------------------------------------------------------
# The example
# ---------------------------------------------------------------------------


def test_train_lm_example_runs_and_resumes(tmp_path):
    script = ROOT / "examples" / "train_lm_torch.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, str(script), "--device", "cpu", "--batch", "2",
            "--seq", "32", "--ckpt", str(tmp_path)]
    first = subprocess.run(args + ["--steps", "3"], env=env,
                           capture_output=True, text=True, timeout=120)
    assert first.returncode == 0, first.stderr
    assert "resumed" not in first.stdout
    assert "monitor=healthy" in first.stdout
    assert checkpoint.latest_step(tmp_path) == 3
    second = subprocess.run(args + ["--steps", "5"], env=env,
                            capture_output=True, text=True, timeout=120)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 3" in second.stdout
    assert checkpoint.latest_step(tmp_path) == 5


def test_train_lm_example_two_ranks_resumes_bitwise(tmp_path):
    """``--ranks 2``: an (2, 1) ("data", "model") mesh of two gloo ranks,
    one row of the batch a rank through the mesh step.  Three steps, then
    a resume to five (a checkpoint saved and loaded through the mesh's
    placements), end bitwise where five steps in one run end."""
    script = ROOT / "examples" / "train_lm_torch.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(steps, ckpt):
        return subprocess.Popen(
            [sys.executable, str(script), "--device", "cpu", "--ranks", "2",
             "--batch", "2", "--seq", "32", "--steps", str(steps),
             "--ckpt", str(tmp_path / ckpt)], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def done(proc):
        out, err = proc.communicate(timeout=180)
        assert proc.returncode == 0, err
        return out

    first, whole = run(3, "resumed"), run(5, "whole")
    out = done(first)
    assert "ranks=2" in out and "monitor=healthy" in out
    assert "resumed" not in done(whole)
    assert "resumed from step 3" in done(run(5, "resumed"))
    got, want = (np.load(tmp_path / d / "step_00000005" / "shard_0.npz")
                 for d in ("resumed", "whole"))
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# The chunked attention path under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-14b", "mixtral-8x7b"])
def test_chunked_attention_grads_match_jax(arch, monkeypatch):
    """Past ``DENSE_MAX`` tokens attention runs chunk by chunk (phase 17's
    4,096-token steps do): with ``CHUNK_Q`` = 8, ``CHUNK_KV`` = 16 and
    ``DENSE_MAX`` = 16 in both packages, the grads of a 32-token batch
    equal ``jax.grad``'s at the train-step tolerance
    (``torch_train_parity``: rtol 1e-4, atol 1e-4 of the leaf's largest
    |g|, at least 1e-6); mixtral-smoke's 32-token window included."""
    import jax

    import repro.configs as j_cfgs
    import torch_train_parity as parity
    from repro.models import attention as j_attention
    from repro.models import build as j_build
    from repro_torch import convert
    from repro_torch.models import attention

    calls = []
    chunked = attention._attend_chunked
    monkeypatch.setattr(attention, "_attend_chunked",
                        lambda *a, **k: calls.append(1) or chunked(*a, **k))
    for mod in (attention, j_attention):
        monkeypatch.setattr(mod, "CHUNK_Q", 8)
        monkeypatch.setattr(mod, "CHUNK_KV", 16)
        monkeypatch.setattr(mod, "DENSE_MAX", 16)
    j_model = j_build(j_cfgs.get_smoke(arch))
    j_params = j_model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    cfg = cfgs.get_smoke(arch)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    want = jax.tree.map(np.asarray, jax.jit(jax.grad(
        lambda p: j_model.loss(p, toks, labels)[0]))(j_params))
    params = convert.model_params_from_jax_numpy(
        cfg, jax.tree.map(np.asarray, j_params), "cpu")
    got = loss_and_grads(build(cfg, "cpu"), params,
                         {"tokens": torch.from_numpy(toks),
                          "labels": torch.from_numpy(labels)})[2]
    assert calls, "the chunked path did not run"
    parity._leafwise(got, want, "grad ", parity.GRAD_RTOL,
                     parity.GRAD_LEAF_ATOL, parity.GRAD_ATOL)


def test_ssd_grads_finite_where_jax_overflows():
    """The SSD's intra-chunk decay at a long chunk: above the diagonal the
    segment sums are positive and exp overflows.  JAX masks after the exp
    and its grads turn NaN (0 * inf in the backward); the port masks
    before it: the same forward (rtol = atol = 1e-4, the models' parity
    tolerance) and finite grads.  Chunk 128,
    dt about 1: sums near +128, past float32's exp range (88.7)."""
    import jax

    from repro.models import ssm as j_ssm
    from repro_torch.models import ssm

    kw = dict(d_model=32, d_state=8, headdim=8, expand=2, n_groups=1,
              conv_kernel=4, chunk=128)
    j_cfg, cfg = j_ssm.SSMConfig(**kw), ssm.SSMConfig(**kw)
    j_params = j_ssm.init(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    j_params["dt_bias"] = jnp.full_like(j_params["dt_bias"], 1.0)
    x = np.random.default_rng(0).standard_normal((1, 128, 32)).astype(
        np.float32)

    def j_loss(p):
        return jnp.sum(jnp.square(j_ssm.fwd_train(p, j_cfg, x)[0]))

    j_y = np.asarray(j_ssm.fwd_train(j_params, j_cfg, x)[0])
    j_grads = jax.grad(j_loss)(j_params)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(j_grads))

    params = {k: torch.tensor(np.asarray(v), requires_grad=True)
              for k, v in j_params.items()}
    y = ssm.fwd_train(params, cfg, torch.from_numpy(x))[0]
    np.testing.assert_allclose(y.detach().numpy(), j_y, rtol=1e-4,
                               atol=1e-4)
    grads = torch.autograd.grad(torch.sum(torch.square(y)),
                                list(params.values()))
    assert all(torch.isfinite(g).all() for g in grads)
