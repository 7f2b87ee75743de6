"""AdamW with decoupled weight decay and global-norm clipping.

Port of ``repro/optim/adamw.py``.  Moments are float32 whatever the
parameter dtype (bf16 parameters with float32 moments is the memory
recipe the large archs need), and the update runs in float32 and casts
back, in JAX's order of operations.  Plain functions over parameter trees
(a :class:`~repro_torch.models.common.ParamTree` or nested dicts), walked
in JAX's leaf order (:mod:`repro_torch.tree`); not ``torch.optim.AdamW``,
which keeps its moments in the parameter's dtype and applies the weight
decay before the moment update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .. import tree as tree_lib
from ..models.common import as_tree

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "clip_to_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    m: Any  # nested dicts of float32 tensors, the parameters' paths
    v: Any
    step: torch.Tensor  # 0-d int32


def _device(params) -> torch.device:
    flat = tree_lib.leaves(params)
    return flat[0].device if flat else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    """Zero float32 moments of the parameters' shapes, on their devices,
    and step 0 (a 0-d int32 tensor)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    plain = as_tree(params)
    return AdamWState(
        m=tree_lib.map(zeros, plain), v=tree_lib.map(zeros, plain),
        step=torch.zeros((), dtype=torch.int32, device=_device(params)))


def clip_by_global_norm(grads, max_norm: float):
    """(global norm, the float32 grads scaled so their norm is at most
    ``max_norm``).  New tensors: the caller's grads are not written."""
    flat = tree_lib.leaves(grads)
    g2 = sum(torch.sum(torch.square(g.float())) for g in flat)
    gnorm = torch.sqrt(g2)
    return gnorm, clip_to_norm(grads, gnorm, max_norm)


def clip_to_norm(grads, gnorm, max_norm: float):
    """The float32 grads scaled as :func:`clip_by_global_norm` scales them
    when their global norm is ``gnorm`` (across a mesh: the grads are this
    rank's shards, ``gnorm`` the whole tree's)."""
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return tree_lib.unflatten_like(
        grads, [g.float() * scale for g in tree_lib.leaves(grads)])


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr, cfg: AdamWConfig):
    """One AdamW step: ``(params', state')``.

    ``grads`` must already be float32 (:func:`clip_by_global_norm` casts).
    ``lr`` is a float or a 0-d float32 tensor.  The update is written into
    the caller's tensors: each parameter and both moments are updated in
    place and returned (JAX's train step donates ``params`` and ``opt``,
    so its caller never reads them again either); ``state.step`` is not
    written.  Runs under ``no_grad``.
    """
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves(grads)
    flat_m = tree_lib.leaves(state.m)
    flat_v = tree_lib.leaves(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and moments differ in leaf count")
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        delta = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        p32 = p.float()
        delta.add_(p32 * cfg.weight_decay)
        if p.dtype == torch.float32:
            p.sub_(delta.mul_(lr))
        else:
            p.copy_(p32.sub_(delta.mul_(lr)))
        del delta, p32
    return params, AdamWState(m=state.m, v=state.v, step=step)
