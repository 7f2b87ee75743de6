"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) block.

Port of ``repro/models/ssm.py``.  Chunked "dual" form for train/prefill:
within a chunk of length Q the computation is an attention-like quadratic
contraction with a causal decay mask (segment-sum of ``a = dt * A``);
across chunks a linear recurrence (a Python loop where JAX scans) carries
the (H, P, N) state.  Decode is the pure recurrence, O(1) per token.

Layout: d_inner = expand * d_model, H = d_inner / headdim heads, state size
N, G B/C-groups (shared across H/G heads); the state (B, H, P, N) is the
decode "cache".  The O(Q^2) contractions take storage-dtype operands with
float32 products and sums, as JAX's ``preferred_element_type`` dots
(``attention._dot32``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import common
from .attention import _dot32
from .common import DATA, shard

__all__ = ["SSMConfig", "SSMState", "init", "param_specs", "fwd_train",
           "fwd_decode", "init_state"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_state: int  # N
    headdim: int = 64  # P
    expand: int = 2
    n_groups: int = 1  # G
    conv_kernel: int = 4
    chunk: int = 256  # Q

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class SSMState(NamedTuple):
    ssm: torch.Tensor  # (B, H, P, N)
    conv: torch.Tensor  # (B, K-1, conv_dim) — causal-conv tail
    pos: torch.Tensor  # (B,) int32


def init(gen, cfg: SSMConfig, dtype=torch.float32):
    H = cfg.n_heads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + H
    dev = common.init_device(gen)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": common.normal_init(gen, (cfg.d_model, d_in_proj), dtype),
        "conv_w": common.normal_init(gen, (cfg.conv_kernel, cfg.conv_dim),
                                     dtype, scale=0.5),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), **f32),  # A = -exp(A_log) = -1
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm_w": torch.ones((cfg.d_inner,), dtype=dtype, device=dev),
        "out_proj": common.normal_init(gen, (cfg.d_inner, cfg.d_model), dtype),
    }


def param_specs(cfg: SSMConfig, fsdp: bool = False):
    d0 = DATA if fsdp else None
    return {
        "in_proj": common.pspec(d0, "model"),
        "conv_w": common.pspec(None, "model"),
        "conv_b": common.pspec("model"),
        "A_log": common.pspec(None),
        "D": common.pspec(None),
        "dt_bias": common.pspec(None),
        "norm_w": common.pspec("model"),
        "out_proj": common.pspec("model", d0),
    }


def init_state(cfg: SSMConfig, batch: int, dtype=torch.float32,
               device=None) -> SSMState:
    return SSMState(
        ssm=torch.zeros((batch, cfg.n_heads, cfg.headdim, cfg.d_state),
                        dtype=dtype, device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, cfg.conv_dim),
                         dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _split(cfg: SSMConfig, proj):
    """in_proj output -> (z, xBC, dt)."""
    di = cfg.d_inner
    z = proj[..., :di]
    xBC = proj[..., di: di + cfg.conv_dim]
    dt = proj[..., di + cfg.conv_dim:]
    return z, xBC, dt


def _xbc_split(cfg: SSMConfig, xBC):
    di, gn = cfg.d_inner, cfg.n_groups * cfg.d_state
    return xBC[..., :di], xBC[..., di: di + gn], xBC[..., di + gn:]


def _causal_conv(cfg: SSMConfig, xBC, conv_w, conv_b, tail=None):
    """Depthwise causal conv1d along L; tail = (B, K-1, C) history."""
    K = cfg.conv_kernel
    if tail is None:
        tail = torch.zeros((xBC.shape[0], K - 1, xBC.shape[-1]),
                           dtype=xBC.dtype, device=xBC.device)
    xpad = torch.cat([tail, xBC], dim=1)  # (B, L+K-1, C)
    L = xBC.shape[1]
    out = 0
    for i in range(K):  # JAX's sum() starts from 0 and adds in this order
        out = out + xpad[:, i: i + L] * conv_w[i]
    return F.silu(out + conv_b), xpad[:, -(K - 1):]


def _segsum(a):
    """(..., Q) -> (..., Q, Q) with out[i, j] = sum_{l=j+1..i} a_l (i >= j)."""
    cum = torch.cumsum(a, dim=-1)
    return cum[..., :, None] - cum[..., None, :]


def fwd_train(params, cfg: SSMConfig, x, state: SSMState | None = None):
    """x: (B, L, D) -> (B, L, D), final SSMState (for prefill reuse)."""
    B, L, D = x.shape
    H, P, N, G, Q = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups, cfg.chunk
    # Largest divisor of L <= the configured chunk.
    Q = min(Q, L)
    while L % Q:
        Q -= 1
    nc = L // Q

    proj = torch.einsum("bld,df->blf", x, params["in_proj"])
    z, xBC, dt_raw = _split(cfg, proj)
    tail = state.conv if state is not None else None
    xBC, new_tail = _causal_conv(cfg, xBC, params["conv_w"], params["conv_b"],
                                 tail)
    xin, Bssm, Cssm = _xbc_split(cfg, xBC)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,L,H)
    A = -torch.exp(params["A_log"])  # (H,)
    a = dt * A  # (B, L, H)

    xh = shard(xin.reshape(B, L, H, P), DATA, None, "model", None)
    Bh = Bssm.reshape(B, L, G, N)
    Ch = Cssm.reshape(B, L, G, N)
    rep = H // G
    xdt = xh.float() * dt[..., None]  # (B, L, H, P)

    # chunk views
    ac = a.reshape(B, nc, Q, H)
    cum = torch.cumsum(ac, dim=2)  # (B, nc, Q, H)
    xc = xdt.reshape(B, nc, Q, H, P)
    Bc = Bh.reshape(B, nc, Q, G, N).float()
    Cc = Ch.reshape(B, nc, Q, G, N).float()

    # ---- intra-chunk (dual quadratic form) ------------------------------
    # The O(Q^2) operands at the storage dtype, float32 products and sums;
    # the exp/segsum statistics stay float32.
    dt_store = x.dtype
    seg = _segsum(ac.permute(0, 1, 3, 2))  # (B, nc, H, Q, Q) = cum_i - cum_j
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # Masked before the exp, not after it as JAX does: above the diagonal
    # the sums are positive and overflow float32 past a chunk of ~100
    # positions (mamba2's published chunk is 256).  The forward's values
    # are JAX's either way (exp(-inf) = 0), but JAX's backward takes
    # 0 * exp(inf) there, a NaN that reaches every grad.
    decay = torch.exp(torch.where(tri, seg, float("-inf")))
    # scores[b,c,h,i,j] = (C_i . B_j) * decay[h,i,j]
    cb = _dot32("bcigm,bcjgm->bcgij", Cc.to(dt_store), Bc.to(dt_store))
    cb = torch.repeat_interleave(cb, rep, dim=2)  # (B, nc, H, Q, Q)
    scores = (cb * decay).to(dt_store)
    y_intra = _dot32("bchij,bcjhp->bcihp", scores, xc.to(dt_store))

    # ---- chunk states and inter-chunk recurrence ------------------------
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, H)
    Bfull = torch.repeat_interleave(Bc, rep, dim=3)  # (B, nc, Q, H, N)
    states = torch.einsum("bcqh,bcqhp,bcqhn->bchpn",
                          decay_end.to(dt_store).float(),
                          xc.to(dt_store).float(),
                          Bfull.to(dt_store).float())

    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)
    s = (state.ssm.float() if state is not None
         else torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device))
    s_enter = []
    for c in range(nc):
        s_enter.append(s)  # state entering this chunk
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_enter = torch.stack(s_enter, dim=1)  # (B, nc, H, P, N)

    Cfull = torch.repeat_interleave(Cc, rep, dim=3)  # (B, nc, Q, H, N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                           Cfull.to(dt_store).float(),
                           s_enter.to(dt_store).float(),
                           torch.exp(cum).to(dt_store).float())

    y = y_intra.reshape(B, L, H, P) + y_inter.reshape(B, L, H, P)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, L, cfg.d_inner)
    # Gated RMSNorm (Mamba2's RMSNormGated: gate, then normalize).
    y = y * F.silu(z.float())
    y = common.rms_norm(y.to(x.dtype), params["norm_w"])
    out = torch.einsum("blf,fd->bld", y, params["out_proj"])
    pos = (state.pos + L if state is not None
           else torch.full((B,), L, dtype=torch.int32, device=x.device))
    # JAX casts the final state to its float32 s0, whatever state.ssm was.
    new_state = SSMState(ssm=s, conv=new_tail, pos=pos)
    return shard(out, DATA, None, None), new_state


def fwd_decode(params, cfg: SSMConfig, x, state: SSMState):
    """One-token recurrence. x: (B, 1, D) -> (B, 1, D), state'."""
    B = x.shape[0]
    H, P, N, G = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups
    proj = torch.einsum("bld,df->blf", x, params["in_proj"])[:, 0]
    z, xBC, dt_raw = _split(cfg, proj)
    # conv over the K-long history window
    hist = torch.cat([state.conv, xBC[:, None, :]], dim=1)  # (B,K,C)
    # A float32 tail (init_state's) promotes the window, as in JAX.
    w = params["conv_w"].to(torch.promote_types(hist.dtype,
                                                 params["conv_w"].dtype))
    conv_out = torch.einsum("bkc,kc->bc", hist.to(w.dtype), w) + params["conv_b"]
    xBC = F.silu(conv_out)
    xin, Bssm, Cssm = _xbc_split(cfg, xBC)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,H)
    A = -torch.exp(params["A_log"])
    dec = torch.exp(dt * A)  # (B, H)
    xh = xin.reshape(B, H, P).float()
    rep = H // G
    Bh = torch.repeat_interleave(Bssm.reshape(B, G, N), rep, dim=1).float()
    Ch = torch.repeat_interleave(Cssm.reshape(B, G, N), rep, dim=1).float()

    s = state.ssm.float() * dec[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, s) + params["D"][None, :, None] * xh
    y = y.reshape(B, cfg.d_inner)
    y = y * F.silu(z.float())
    y = common.rms_norm(y.to(x.dtype), params["norm_w"])
    out = torch.einsum("bf,fd->bd", y, params["out_proj"])[:, None, :]
    return out, SSMState(ssm=s.to(state.ssm.dtype), conv=hist[:, 1:],
                         pos=state.pos + 1)
