"""Token-choice top-k Mixture-of-Experts with group-local capacity dispatch.

Port of ``repro/models/moe.py``.  Dispatch is group-local (group = batch
row): each row sorts its own (L*K) token-slots by expert id, assigns
positions within the expert by a running count, drops beyond capacity C,
and scatters into its (E, C, D) slice of the (B, E, C, D) buffer; the
experts are one einsum over E.  C = cf * L * K / E a row; ``dropless=True``
(decode) sets C = L so serving never drops a token.

The routing is JAX's exactly, on the same router probabilities:

* the top-k takes the lower expert index first on a tie, as ``lax.top_k``
  (a stable descending sort, not ``torch.topk``);
* the sort by expert is stable (``jnp.argsort`` is), so the tokens keep
  their order inside an expert and capacity drops the same ones;
* a dropped slot's destination is the dummy row E*C, written and sliced
  off (JAX's ``mode="drop"``).

The combine is deterministic: each slot's weighted output is put back in
token order (the inverse of the sort) and summed over the K choices,
where JAX scatter-adds; no atomics, so the card gives the same sum every
run.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import common
from .common import DATA, shard

__all__ = ["MoEConfig", "init", "param_specs", "route", "dispatch",
           "combine", "fwd"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int  # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shard_experts: bool = True  # EP on 'model' (else TP inside experts)
    router_jitter: float = 0.0


def init(gen, cfg: MoEConfig, dtype=torch.float32):
    E, D, F_ = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": common.normal_init(gen, (D, E), torch.float32),
        "wg": common.normal_init(gen, (E, D, F_), dtype),
        "wu": common.normal_init(gen, (E, D, F_), dtype),
        "wd": common.normal_init(gen, (E, F_, D), dtype),
    }


def param_specs(cfg: MoEConfig, fsdp: bool = False):
    d0 = DATA if fsdp else None
    if cfg.shard_experts:
        return {
            "router": common.pspec(None, None),
            "wg": common.pspec("model", d0, None),
            "wu": common.pspec("model", d0, None),
            "wd": common.pspec("model", d0, None),
        }
    return {
        "router": common.pspec(None, None),
        "wg": common.pspec(None, d0, "model"),
        "wu": common.pspec(None, d0, "model"),
        "wd": common.pspec(None, "model", d0),
    }


def _capacity(cfg: MoEConfig, L: int, dropless: bool) -> int:
    E, K = cfg.n_experts, cfg.top_k
    C = L if dropless else (int(cfg.capacity_factor * L * K / E) or 1)
    return min(C, L * K)


def route(params, cfg: MoEConfig, x, dropless: bool = False):
    """The router: (top_e (B, L, K), top_p (B, L, K) renormalized, the aux
    loss, the capacity C)."""
    B, L, _ = x.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.einsum("bld,de->ble", x.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # Load-balancing auxiliary loss (Switch-style), over all tokens: of
    # every data-parallel rank (common.data_mean), not only this one's.
    me = common.data_mean(probs.mean(dim=(0, 1)))
    flat = top_e.reshape(-1)
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))  # bincount, static
    ce = common.data_mean(counts.float() / (B * L)).detach()
    aux = E * torch.sum(me * ce) / K
    return top_e, top_p, aux, _capacity(cfg, L, dropless)


def dispatch(x, top_e, top_p, E: int, C: int):
    """Every row's dispatch.  x: (B, L, D); top_e/top_p: (B, L, K).

    Returns (buf (B, E, C, D), dst (B, L*K), keep (B, L*K), order (B, L*K),
    w (B, L*K)): slot j of a row's sorted order is token-slot ``order[j]``
    (token ``order[j] // K``), bound for buffer row ``dst[j]``.
    """
    B, L, D = x.shape
    K = top_e.shape[-1]
    flat_e = top_e.reshape(B, L * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(L * K, device=x.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    src_tok = order // K
    dst = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    rows = torch.gather(x, 1, src_tok[..., None].expand(B, L * K, D))
    buf = torch.zeros((B, E * C + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dst[..., None].expand(B, L * K, D), rows)
    w = torch.gather(top_p.reshape(B, L * K), 1, order)
    return buf[:, :E * C].reshape(B, E, C, D), dst, keep, order, w


def combine(y_e, dst, keep, order, w, L: int):
    """Inverse of dispatch at the storage dtype: each kept slot's output
    times its weight, back in token order, summed over the K choices."""
    B, E, C, D = y_e.shape
    K = dst.shape[1] // L
    EC = E * C
    slot_val = torch.gather(
        y_e.reshape(B, EC, D), 1,
        torch.clamp(dst, 0, EC - 1)[..., None].expand(B, L * K, D))
    slot_val = torch.where(keep[..., None], slot_val, 0.0)
    contrib = slot_val * w[..., None].to(y_e.dtype)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(L * K, device=order.device)
                 .expand(B, L * K).contiguous())
    back = torch.gather(contrib, 1, inv[..., None].expand(B, L * K, D))
    return back.reshape(B, L, K, D).sum(dim=2)


def fwd(params, cfg: MoEConfig, x, dropless: bool = False):
    """x: (B, L, D) -> (B, L, D), plus aux losses dict.

    ``dropless=True`` (decode path) sets capacity C = L so routing
    collisions can never drop a token.
    """
    L = x.shape[1]
    top_e, top_p, aux, C = route(params, cfg, x, dropless)
    buf, dst, keep, order, w = dispatch(x, top_e, top_p, cfg.n_experts, C)

    e_ax = "model" if cfg.shard_experts else None
    f_ax = None if cfg.shard_experts else "model"
    buf = shard(buf, DATA, e_ax, None, None)  # (B, E, C, D)

    h = F.silu(torch.einsum("becd,edf->becf", buf, params["wg"]))
    h = h * torch.einsum("becd,edf->becf", buf, params["wu"])
    h = shard(h, DATA, e_ax, None, f_ax)
    y_e = torch.einsum("becf,efd->becd", h, params["wd"])
    y_e = shard(y_e, DATA, e_ax, None, None)

    y = combine(y_e, dst, keep, order, w, L)
    return y.to(x.dtype), {"aux_loss": aux}
