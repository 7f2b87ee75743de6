"""End-to-end training driver on the PyTorch port: LM + substrate + the
paper as monitor.

Runs the port's train step (gradient accumulation, float32 AdamW moments),
the deterministic data pipeline, async checkpointing with exact resume,
and an LSS mesh-monitor divergence guard, over an (N, 1) ("data",
"model") mesh of ``--ranks`` N ranks (the twin of JAX's ``(n_dev, 1)``
mesh over its devices): one rank is a one-rank process group (gloo on the
CPU, NCCL on the card); N > 1 ranks are processes started by
``repro_torch.distributed.launch.spawn`` on gloo (on the card they share
it, each collective staged through pinned host memory), each computing
its rows of the batch through the mesh step.  The twin of
``examples/train_lm.py``: the same presets, flags, data, schedule and
checkpoints, plus ``--device`` and ``--ranks``.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --ranks 2
"""

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import repro_torch.configs as cfgs
from repro_torch import checkpoint, tree
from repro_torch.configs import ShapeCell
from repro_torch.core import monitor as monitor_lib
from repro_torch.core import wvs
from repro_torch.data import TokenSource
from repro_torch.distributed import launch, sharding
from repro_torch.models import build
from repro_torch.models.transformer import LMConfig
from repro_torch.optim import adamw_init
from repro_torch.training.steps import TrainHParams, build_for_cell

PRESETS = {
    # ~8M params: CI-friendly.
    "tiny": LMConfig(name="tiny", n_layers=4, d_model=256, vocab=4096,
                     n_heads=4, n_kv=2, d_head=64, d_ff=1024, block="dense",
                     remat=False, fsdp=False, dtype=torch.float32),
    # ~100M params: the deliverable-scale run (use on the card).
    "100m": LMConfig(name="lm100m", n_layers=12, d_model=768, vocab=32_768,
                     n_heads=12, n_kv=4, d_head=64, d_ff=3072, block="dense",
                     remat=True, fsdp=False, dtype=torch.bfloat16),
}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _mesh(device, ranks):
    """The (N, 1) ("data", "model") mesh over the default group, which one
    rank starts here (NCCL on the card, gloo on the CPU) and N > 1 ranks
    join from ``launch.spawn`` (gloo)."""
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    if ranks == 1:
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        kind = device.type
    else:
        kind = "cpu"  # a gloo mesh, whatever device the shards are on
    return init_device_mesh(kind, (ranks, 1),
                            mesh_dim_names=("data", "model"))


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="/tmp/repro_train_lm_torch")
    ap.add_argument("--arch", default=None,
                    help="train an assigned arch's smoke config instead")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda (the default) raises without "
                         "a card")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of the (N, 1) data mesh; N > 1 starts N "
                         "processes on gloo")
    return ap


def train(args, rank=0):
    """The training run on this rank (prints on rank 0)."""
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = cfgs.get_smoke(args.arch) if args.arch else PRESETS[args.preset]
    dev = torch.device(args.device)
    model = build(cfg, dev)
    mesh = _mesh(dev, args.ranks)
    try:
        cell = ShapeCell("train", "train", args.seq, args.batch)
        hp = TrainHParams(lr=args.lr, warmup=20, total_steps=args.steps)
        step, in_specs, _, _ = build_for_cell(model, mesh, cell, hp)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        opt = adamw_init(params)
        n_params = sum(p.numel() for p in tree.leaves(params))
        say(f"model={cfg.name} params={n_params/1e6:.1f}M "
            f"device={dev} ranks={args.ranks} batch={args.batch}x{args.seq}")

        src = TokenSource(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=0)

        # LSS divergence guard: options {healthy, diverged} on the loss axis.
        div_thresh = float(np.log(cfg.vocab)) + 2.0
        mon = monitor_lib.MeshMonitor(
            mesh, ("data",), [[div_thresh - 1.0], [div_thresh + 1.0]],
            monitor_lib.MonitorConfig(rounds=1), device=dev)
        mon_state = mon.init()

        start = checkpoint.latest_step(args.ckpt)
        if start is not None:
            state = (params, opt)
            shardings = (None if args.ranks == 1 else
                         sharding.shardings_like(state, in_specs[:2], mesh))
            params, opt = checkpoint.load(args.ckpt, start, state,
                                          shardings=shardings)
            say(f"resumed from step {start}")
        start = start or 0

        _sync(dev)
        t0 = time.perf_counter()
        for s in range(start, args.steps):
            b = src.global_batch_at(s)
            params, opt, m = step(params, opt, {"tokens": b.tokens.to(dev),
                                                "labels": b.labels.to(dev)})
            loss = float(m["loss"])
            stat = wvs.from_vector(torch.full((1, 1), loss), torch.ones(1))
            mon_state, decision, _ = mon.step(mon_state, stat)
            diverged = bool(torch.any(decision == 1))
            if s % 20 == 0 or s == args.steps - 1:
                dt = (time.perf_counter() - t0) / max(s - start + 1, 1)
                tok_s = args.batch * args.seq / dt
                say(f"step {s:4d}  loss={loss:7.4f}  "
                    f"gnorm={float(m['gnorm']):6.2f}  "
                    f"lr={float(m['lr']):.2e}  {tok_s:9.0f} tok/s  "
                    f"monitor={'DIVERGED' if diverged else 'healthy'}")
            if s and s % 100 == 0:
                checkpoint.save_async(args.ckpt, s, (params, opt))
        checkpoint.save(args.ckpt, args.steps, (params, opt))
        checkpoint.wait_pending()
        say("done; checkpoint at", args.ckpt)
    finally:
        if args.ranks == 1:
            dist.destroy_process_group()


def _rank(rank, world, args):
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    train(args, rank)


def main():
    args = _parser().parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    if args.ranks > 1:
        launch.spawn(_rank, args.ranks, timeout_s=24 * 3600.0,
                     args=(args,))
    else:
        train(args)


if __name__ == "__main__":
    main()
