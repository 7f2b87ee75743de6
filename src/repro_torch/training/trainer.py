"""Fault-tolerant training driver (port of ``repro/training/trainer.py``).

Wraps a train step with the production concerns:

  * checkpoint/restart — async checkpoints every ``ckpt_every`` steps and
    at the end, automatic resume from LATEST (the data pipeline is
    counter-indexed, so resume is exact);
  * failure handling — a step that raises a restorable error (a
    ``RuntimeError``, which covers torch's CUDA errors) restores the
    latest checkpoint and continues from its step;
  * straggler flag — a step whose wall time exceeds ``straggler_factor``
    times the running mean of the last 64 is flagged in the log;
  * divergence guard — a non-finite loss, or one above
    ``divergence_loss``, rolls back to the latest checkpoint (after the
    pending async saves have landed: JAX's trainer reads LATEST before it
    waits for them, so its rollback can go to an older checkpoint).

With a ``DeviceMesh`` holding ``monitor_axes``, the trainer builds the
port's :class:`~repro_torch.core.monitor.MeshMonitor` on those axes with
JAX's centres; JAX's trainer never steps it, and neither does this one.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import checkpoint
from ..core import monitor as monitor_lib

__all__ = ["TrainerConfig", "Trainer", "checkpoint_restorable_errors"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    ckpt_every: int = 200
    ckpt_dir: str = "/tmp/repro_ckpt"
    log_every: int = 10
    max_keep: int = 3
    divergence_loss: float = 1e4  # halfspace threshold on loss
    straggler_factor: float = 2.0  # step time vs fleet mean


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn: Callable,
                 batch_fn: Callable, mesh=None, monitor_axes=("data",)):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.mesh = mesh
        self._mon = None
        names = getattr(mesh, "mesh_dim_names", None) or ()
        if mesh is not None and all(a in names for a in monitor_axes):
            centers = torch.tensor([[cfg.divergence_loss * 0.5],
                                    [cfg.divergence_loss * 1.5]])
            self._mon = monitor_lib.MeshMonitor(
                mesh, monitor_axes, centers, monitor_lib.MonitorConfig(),
                device=mesh.device_type)
            self._mon_state = self._mon.init()
        self.step_times: list[float] = []
        self.metrics_log: list[dict] = []

    # ------------------------------------------------------------------
    def run(self, params, opt, start_step: Optional[int] = None,
            fault_injector: Callable | None = None):
        cfg = self.cfg
        step0 = start_step
        if step0 is None:
            latest = checkpoint.latest_step(cfg.ckpt_dir)
            if latest is not None:
                params, opt = checkpoint.load(
                    cfg.ckpt_dir, latest, (params, opt))
                step0 = latest
            else:
                step0 = 0

        step = step0
        while step < cfg.total_steps:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            try:
                if fault_injector is not None:
                    fault_injector(step)
                params, opt, metrics = self.step_fn(params, opt, batch)
                loss = float(metrics["loss"])
            except checkpoint_restorable_errors() as e:  # noqa: PERF203
                # Failure path: restore from the latest checkpoint and
                # continue.
                checkpoint.wait_pending()  # async saves may be in flight
                latest = checkpoint.latest_step(cfg.ckpt_dir)
                if latest is None:
                    raise
                params, opt = checkpoint.load(cfg.ckpt_dir, latest,
                                              (params, opt))
                step = latest
                self.metrics_log.append(
                    {"step": step, "event": "restored", "error": repr(e)})
                continue
            dt = time.perf_counter() - t0
            self.step_times.append(dt)

            if not math.isfinite(loss) or loss > cfg.divergence_loss:
                # Wait first: JAX reads LATEST before the pending saves
                # land, so its rollback may skip a save still in flight.
                checkpoint.wait_pending()
                latest = checkpoint.latest_step(cfg.ckpt_dir)
                if latest is not None and latest < step:
                    params, opt = checkpoint.load(cfg.ckpt_dir, latest,
                                                  (params, opt))
                    step = latest
                    self.metrics_log.append(
                        {"step": step, "event": "rollback", "loss": loss})
                    continue

            step += 1
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                checkpoint.save_async(cfg.ckpt_dir, step, (params, opt),
                                      cfg.max_keep)
            if step % cfg.log_every == 0:
                rec = {"step": step, "loss": loss,
                       "step_time": dt,
                       "straggler": self._straggler_flag(dt)}
                self.metrics_log.append(rec)
        checkpoint.wait_pending()
        return params, opt

    # ------------------------------------------------------------------
    def _straggler_flag(self, dt: float) -> bool:
        """LSS-style threshold on step time vs the fleet's running mean."""
        if len(self.step_times) < 8:
            return False
        mean = float(np.mean(self.step_times[-64:]))
        return dt > self.cfg.straggler_factor * mean


def checkpoint_restorable_errors():
    return (RuntimeError,)
