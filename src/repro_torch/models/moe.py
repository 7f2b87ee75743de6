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

**Experts on ``"model"``.**  Within
:func:`~repro_torch.models.common.tensor_parallel` (m ranks on
``"model"``), as JAX's ``param_specs`` place the experts (:func:`_layout`):

* ``"experts"`` (``shard_experts`` and m divides E): every ``"model"``
  rank already holds the same tokens (the attention's row-parallel sum
  ran just before), so the routing and the dispatch stay local, with no
  all-to-all: the rank's buffer holds only its E / m experts (a slot bound
  for another rank's expert goes to the dummy row), its experts are its
  ``"model"`` shards, and it combines its own slots;
* ``"ffn"`` (not ``shard_experts``, m divides d_ff): every expert on every
  rank, ``wg`` / ``wu`` column-parallel on their d_ff columns and ``wd``
  row-parallel (its partial one precision up, as
  :func:`~repro_torch.models.common.row_product`);
* ``"whole"`` (else, or outside the block): every expert whole on every
  rank, the leaves gathered whole (and named as gathered over ``"model"``:
  :func:`~repro_torch.models.common.computed_whole`).

In the first two each rank's combine is a (B, L, D) partial, summed one
precision up (:data:`~repro_torch.models.common.WIDER`), and the partials
are summed over ``"model"`` once a layer and cast once
(:func:`~repro_torch.models.common.reduce_from_model`): after the
combine, where the (B, E, C, D) buffer would be cf * K times the bytes.
The router runs outside the split region, on every rank alike (its grad
whole on each, as that of a leaf used outside a split layer); the tokens
entering the dispatch and the combine weights enter it through
:func:`~repro_torch.models.common.copy_to_model`, whose backward sums each
rank's share over ``"model"``.
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
    """JAX's specs: the experts on ``"model"`` (``shard_experts``), else
    each expert's d_ff.  Where the axis does not divide them (JAX could
    not place such a leaf), the leaves stay whole on it and the layer is
    computed whole (:func:`_layout`)."""
    d0 = DATA if fsdp else None
    m = common.axis_size("model")
    if cfg.shard_experts:
        e_ax = "model" if cfg.n_experts % m == 0 else None
        return {
            "router": common.pspec(None, None),
            "wg": common.pspec(e_ax, d0, None),
            "wu": common.pspec(e_ax, d0, None),
            "wd": common.pspec(e_ax, d0, None),
        }
    f_ax = "model" if cfg.d_ff % m == 0 else None
    return {
        "router": common.pspec(None, None),
        "wg": common.pspec(None, d0, f_ax),
        "wu": common.pspec(None, d0, f_ax),
        "wd": common.pspec(None, f_ax, d0),
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


def dispatch(x, top_e, top_p, E: int, C: int, lo: int = 0,
             n: int | None = None):
    """Every row's dispatch into the buffer of the experts ``[lo, lo + n)``
    (all ``E`` by default).  x: (B, L, D); top_e/top_p: (B, L, K).

    Returns (buf (B, n, C, D), dst (B, L*K), keep (B, L*K), order (B, L*K),
    w (B, L*K)): slot j of a row's sorted order is token-slot ``order[j]``
    (token ``order[j] // K``), bound for buffer row ``dst[j]``; ``keep``
    is False for a slot dropped by the capacity or bound for an expert
    outside the range (its row the dummy one, n * C).
    """
    B, L, D = x.shape
    K = top_e.shape[-1]
    n = E if n is None else n
    flat_e = top_e.reshape(B, L * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = torch.zeros((B, E), dtype=torch.int64, device=x.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = (torch.arange(L * K, device=x.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    if n != E:
        keep &= (sorted_e >= lo) & (sorted_e < lo + n)
    src_tok = order // K
    dst = torch.where(keep, (sorted_e - lo) * C + pos_in_e, n * C)
    rows = torch.gather(x, 1, src_tok[..., None].expand(B, L * K, D))
    buf = torch.zeros((B, n * C + 1, D), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dst[..., None].expand(B, L * K, D), rows)
    w = torch.gather(top_p.reshape(B, L * K), 1, order)
    return buf[:, :n * C].reshape(B, n, C, D), dst, keep, order, w


def combine(y_e, dst, keep, order, w, L: int, sum_dtype=None):
    """Inverse of dispatch at the storage dtype: each kept slot's output
    times its weight, back in token order, summed over the K choices (as
    ``sum_dtype``, where given)."""
    B, E, C, D = y_e.shape
    K = dst.shape[1] // L
    EC = E * C
    slot_val = torch.gather(
        y_e.reshape(B, EC, D), 1,
        torch.clamp(dst, 0, EC - 1)[..., None].expand(B, L * K, D))
    slot_val = torch.where(keep[..., None], slot_val, 0.0)
    contrib = slot_val * w[..., None].to(y_e.dtype)
    if sum_dtype is not None:
        contrib = contrib.to(sum_dtype)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(L * K, device=order.device)
                 .expand(B, L * K).contiguous())
    back = torch.gather(contrib, 1, inv[..., None].expand(B, L * K, D))
    return back.reshape(B, L, K, D).sum(dim=2)


def _layout(cfg: MoEConfig) -> str:
    """How the ``"model"`` ranks split the layer (module docstring):
    ``"experts"``, ``"ffn"`` or ``"whole"``."""
    m = common.model_size()
    if m == 1:
        return "whole"
    if cfg.shard_experts:
        return "experts" if cfg.n_experts % m == 0 else "whole"
    return "ffn" if cfg.d_ff % m == 0 else "whole"


def _hidden(buf, wg, wu):
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg))
    return h * torch.einsum("becd,edf->becf", buf, wu)


def fwd(params, cfg: MoEConfig, x, dropless: bool = False):
    """x: (B, L, D) -> (B, L, D), plus aux losses dict.

    ``dropless=True`` (decode path) sets capacity C = L so routing
    collisions can never drop a token.  ``params`` may hold
    :class:`~repro_torch.models.common.ShardedLeaf` s: each is gathered
    as its layout uses it (module docstring).
    """
    L = x.shape[1]
    E = cfg.n_experts
    top_e, top_p, aux, C = route(
        {"router": common.gathered(params["router"])}, cfg, x, dropless)
    layout = _layout(cfg)
    e_ax = "model" if cfg.shard_experts else None
    f_ax = None if cfg.shard_experts else "model"
    if layout == "whole":
        p = common.computed_whole({k: params[k] for k in ("wg", "wu", "wd")})
        buf, dst, keep, order, w = dispatch(x, top_e, top_p, E, C)
        buf = shard(buf, DATA, e_ax, None, None)  # (B, E, C, D)
        h = shard(_hidden(buf, p["wg"], p["wu"]), DATA, e_ax, None, f_ax)
        y_e = torch.einsum("becf,efd->becd", h, p["wd"])
        y_e = shard(y_e, DATA, e_ax, None, None)
        y = combine(y_e, dst, keep, order, w, L)
        return y.to(x.dtype), {"aux_loss": aux}

    xc, pc = common.copy_to_model(x), common.copy_to_model(top_p)
    p = {k: common.model_part(params[k]) for k in ("wg", "wu", "wd")}
    wide = common.WIDER.get(x.dtype, x.dtype)
    if layout == "experts":  # this rank's experts, whole
        n = E // common.model_size()
        buf, dst, keep, order, w = dispatch(xc, top_e, pc, E, C,
                                            common.model_rank() * n, n)
        y_e = torch.einsum("becf,efd->becd", _hidden(buf, p["wg"], p["wu"]),
                           p["wd"])
        y = combine(y_e, dst, keep, order, w, L, sum_dtype=wide)
    else:  # "ffn": every expert, this rank's d_ff columns
        buf, dst, keep, order, w = dispatch(xc, top_e, pc, E, C)
        h = _hidden(buf, p["wg"], p["wu"])
        y_e = torch.stack([common.row_product(h[:, e], p["wd"][e])
                           for e in range(E)], dim=1)
        y = combine(y_e, dst, keep, order, w, L)
    return common.reduce_from_model(y, x.dtype), {"aux_loss": aux}
