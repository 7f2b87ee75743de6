"""PyTorch/CUDA port of the LSS reproduction (Local Thresholding in General
Network Graphs).

The package mirrors the JAX package ``repro`` module for module, on torch
tensors, and imports neither JAX nor ``repro``.  Every Pallas kernel of the
JAX package on a ported path is a hand-written CUDA C++ kernel for Hopper
(``sm_90a``) under :mod:`repro_torch.kernels`; a tensor on the CPU takes the
kernel's plain PyTorch version instead.

Ported so far: the paper's formulas (:mod:`.core.wvs`, :mod:`.core.regions`,
:mod:`.core.stopping`, :mod:`.core.correction`, :mod:`.core.wvs_cov`), the
topologies, Alg. 1 (:mod:`.core.lss`), the Sec.-VI experiment driver
(:mod:`.core.sim`), the event-driven simulator (:mod:`.core.async_sim`),
the mesh monitor (:mod:`.core.monitor`, one rank a peer over
``torch.distributed``), the multi-tenant monitor service (:mod:`.service`,
both backends, synchronous and overlapped, with its observability and
audit plane, :mod:`.obs`), the sharded engine (:mod:`.engine`: sync and
async, all four halo wires, its sweeps and its autotuner
(:mod:`.engine.autotune`, counted by :mod:`.launch.cost`), on one device
or with one shard a rank over collective ``all_to_all``s, sync and async,
with its audits and layout moves), the halo quantizer and the rank
launcher (:mod:`.distributed`), all three kernels: ``lss_state``,
``correction`` and ``region_decide``, and the model zoo of the
training-monitor substrate (:mod:`.models`: the dense, MoE, SSM and hybrid
LMs and the encoder-decoder, with their configs in :mod:`.configs`; plain
torch ops, no kernel of their own, as the JAX models reach no Pallas
kernel), and its single-process training path: AdamW and the LR schedule
(:mod:`.optim`), the token stream (:mod:`.data`), checkpoints in JAX's
layout (:mod:`.checkpoint`), the train / prefill / decode steps and the
fault-tolerant trainer (:mod:`.training`), and its multi-process
substrate: the host and production meshes (:mod:`.launch.mesh`), named
shardings on ``DeviceMesh`` placements with elastic remesh and reshard
(:mod:`.distributed.sharding`, :mod:`.distributed.elastic`, the
checkpoint's ``load(shardings=)`` and the batch's placement), LSS-gated
LocalSGD (:mod:`.training.localsgd`) and the stage pipeline
(:mod:`.distributed.pipeline`), the train / prefill / decode steps across
a ``DeviceMesh`` of more than one device (:mod:`.distributed.spmd`) and
the device-free dry-run (:mod:`.launch.dryrun`): every module of the JAX
package but ``compat`` and ``launch.hlo_cost``, which have no twin.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The device an entry point runs on when none is given: ``cuda``.

    Raises ``RuntimeError`` when CUDA is unavailable; there is no silent
    fallback to the CPU (pass ``device="cpu"`` explicitly for that).
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> :func:`default_device`; anything else -> ``torch.device``."""
    return default_device() if device is None else torch.device(device)
