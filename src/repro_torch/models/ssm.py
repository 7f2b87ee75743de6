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

**Heads on ``"model"``.**  Within
:func:`~repro_torch.models.common.tensor_parallel` (m ranks on
``"model"``, as JAX's hint puts ``xh``'s heads there) each rank computes
the heads ``[h0, h1)`` of :func:`~.common.head_range`; the leaves keep
JAX's specs.  ``in_proj``'s columns are z | x B C | dt and ``conv_w`` /
``conv_b``'s channels x | B | C, so a rank's stored column shard is not
its heads' columns:

* train and prefill take the heads' z, x and dt columns and channels from
  the leaves whole (:func:`~.common.model_share`: each rank's grad its
  share); every head reads B and C (G = 1 < m), so each rank projects and
  convolves its even share of their channels and gathers them
  (:func:`~.common.gather_from_model`, whose backward reduce-scatters the
  heads' partial grads), and computes the C·B product whole; ``A_log``,
  ``D`` and ``dt_bias`` are sliced to the heads; ``x`` enters through
  :func:`~.common.copy_to_model`;
* the gated norm's mean of squares is over the whole d_inner: each rank
  sums its slice's squares, totalled over ``"model"`` with its grad
  summed too (:func:`~.common.rms_norm_split`: every rank normalises its
  slice by the total);
  ``norm_w`` and ``out_proj``'s rows are head-aligned (d_inner = H P), the
  rank's ``"model"`` shard, and the output is a row-parallel partial
  summed over ``"model"`` (:func:`~.common.row_product`);
* the state ``ssm`` holds the rank's heads (B, H / m, P, N); the conv
  tail stays whole on every rank (prefill gathers its channels over
  ``"model"``, no grad: (B, K − 1, conv_dim), tiny);
* decode multiplies by the rank's stored column shard of ``in_proj``
  and gathers the (B, d_in_proj / m) projection, convolves the rank's
  stored channel shard of the whole window and gathers that, then runs
  the recurrence on its heads: it gathers no weight.
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


def _heads(cfg: SSMConfig) -> tuple[int, int]:
    """The heads ``[h0, h1)`` this rank computes (every head outside
    :func:`~.common.tensor_parallel`)."""
    return common.head_range(cfg.n_heads)


def _bc_range(cfg: SSMConfig) -> tuple[int, int]:
    """The B / C channels ``[b0, b1)`` (of the 2 G N after x) whose
    projection and conv this rank computes in train and prefill: its even
    share (gathered after the conv)."""
    n, m, r = 2 * cfg.n_groups * cfg.d_state, common.model_size(), \
        common.model_rank()
    if n % m:
        raise ValueError(f"\"model\" of {m} does not divide the SSD's {n} "
                         f"B / C channels")
    return r * n // m, (r + 1) * n // m


def _train_leaves(params, cfg: SSMConfig, h0: int, h1: int):
    """The leaves as the heads ``[h0, h1)`` read them in train and
    prefill (module docstring): ``in_proj``'s z, x and dt columns of the
    heads and its B / C columns of :func:`_bc_range`, the x channels of
    the heads and those B / C ones of ``conv_w`` / ``conv_b``, the heads
    of the (H,) leaves, all from the leaves whole through
    :func:`~.common.model_share`; the rows of ``norm_w`` and ``out_proj``
    through :func:`~.common.model_slice`."""
    P, di, cd = cfg.headdim, cfg.d_inner, cfg.conv_dim
    b0, b1 = _bc_range(cfg)
    w = common.model_share(params["in_proj"])
    cw = common.model_share(params["conv_w"])
    cb = common.model_share(params["conv_b"])
    x0, x1 = h0 * P, h1 * P
    return {
        "in_proj": torch.cat([w[:, x0:x1], w[:, di + x0:di + x1],
                              w[:, 2 * di + b0:2 * di + b1],
                              w[:, di + cd + h0:di + cd + h1]], dim=1),
        "conv_w": torch.cat([cw[:, x0:x1], cw[:, di + b0:di + b1]], dim=1),
        "conv_b": torch.cat([cb[x0:x1], cb[di + b0:di + b1]]),
        **{n: common.model_share(params[n])[h0:h1]
           for n in ("A_log", "D", "dt_bias")},
        "norm_w": common.model_slice(params["norm_w"], 0, x0, x1, di),
        "out_proj": common.model_slice(params["out_proj"], 0, x0, x1, di),
    }


def _out(y, out_proj, dtype):
    """The gated norm's output ``y`` (B, L, ·) times ``out_proj``: this
    rank's rows within :func:`~.common.tensor_parallel`, its partial
    one precision up, summed over ``"model"``."""
    return common.reduce_from_model(common.row_product(y, out_proj), dtype)


def _check_split(cfg: SSMConfig) -> None:
    """A state split on heads needs ``"model"`` to divide them (as the
    state's placement at ``cache_specs``)."""
    m = common.model_size()
    if cfg.n_heads % m:
        raise ValueError(f"\"model\" of {m} does not divide the SSD's "
                         f"{cfg.n_heads} heads: its state cannot split")


def fwd_train(params, cfg: SSMConfig, x, state: SSMState | None = None,
              with_state: bool = True):
    """x: (B, L, D) -> (B, L, D), final SSMState (for prefill reuse; None
    without ``with_state``).  Within :func:`~.common.tensor_parallel` this
    rank's heads (module docstring): ``state.ssm`` and the returned one
    are its heads', the conv tails whole."""
    B, L, D = x.shape
    H, P, N, G, Q = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups, cfg.chunk
    h0, h1 = _heads(cfg)
    Hl, di = h1 - h0, (h1 - h0) * P  # this rank's heads and their width
    split = common.model_size() > 1
    if split:
        params = _train_leaves(params, cfg, h0, h1)
        x_in = common.copy_to_model(x)
    else:
        params = common.gathered(params)
        x_in = x
    # Largest divisor of L <= the configured chunk.
    Q = min(Q, L)
    while L % Q:
        Q -= 1
    nc = L // Q

    proj = torch.einsum("bld,df->blf", x_in, params["in_proj"])
    b0, b1 = _bc_range(cfg) if split else (0, 2 * G * N)
    cd = di + b1 - b0  # the conv channels this rank computes
    z, xBC, dt_raw = proj[..., :di], proj[..., di:di + cd], proj[..., di + cd:]
    tail = None
    if state is not None:
        tail = state.conv
        if split:  # the whole tail's channels of this rank
            tail = torch.cat([tail[..., h0 * P:h1 * P],
                              tail[..., cfg.d_inner + b0:cfg.d_inner + b1]],
                             dim=-1)
    xBC, new_tail = _causal_conv(cfg, xBC, params["conv_w"], params["conv_b"],
                                 tail)
    xin, BC = xBC[..., :di], xBC[..., di:]
    if split:  # every rank's share of B and C
        BC = common.gather_from_model(BC, -1)
    Bssm, Cssm = BC[..., :G * N], BC[..., G * N:]

    dt = F.softplus(dt_raw.float() + params["dt_bias"])  # (B,L,Hl)
    A = -torch.exp(params["A_log"])  # (Hl,)
    a = dt * A  # (B, L, Hl)

    xh = shard(xin.reshape(B, L, Hl, P), DATA, None, "model", None)
    Bh = Bssm.reshape(B, L, G, N)
    Ch = Cssm.reshape(B, L, G, N)
    # Each head's B / C group (JAX repeats the G groups H / G times).
    group = torch.arange(h0, h1, device=x.device) // (H // G)
    xdt = xh.float() * dt[..., None]  # (B, L, Hl, P)

    # chunk views
    ac = a.reshape(B, nc, Q, Hl)
    cum = torch.cumsum(ac, dim=2)  # (B, nc, Q, Hl)
    xc = xdt.reshape(B, nc, Q, Hl, P)
    Bc = Bh.reshape(B, nc, Q, G, N).float()
    Cc = Ch.reshape(B, nc, Q, G, N).float()

    # ---- intra-chunk (dual quadratic form) ------------------------------
    # The O(Q^2) operands at the storage dtype, float32 products and sums;
    # the exp/segsum statistics stay float32.
    dt_store = x.dtype
    seg = _segsum(ac.permute(0, 1, 3, 2))  # (B, nc, Hl, Q, Q) = cum_i - cum_j
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # Masked before the exp, not after it as JAX does: above the diagonal
    # the sums are positive and overflow float32 past a chunk of ~100
    # positions (mamba2's published chunk is 256).  The forward's values
    # are JAX's either way (exp(-inf) = 0), but JAX's backward takes
    # 0 * exp(inf) there, a NaN that reaches every grad.
    decay = torch.exp(torch.where(tri, seg, float("-inf")))
    # scores[b,c,h,i,j] = (C_i . B_j) * decay[h,i,j]
    cb = _dot32("bcigm,bcjgm->bcgij", Cc.to(dt_store), Bc.to(dt_store))
    cb = cb.index_select(2, group)  # (B, nc, Hl, Q, Q)
    scores = (cb * decay).to(dt_store)
    y_intra = _dot32("bchij,bcjhp->bcihp", scores, xc.to(dt_store))

    # ---- chunk states and inter-chunk recurrence ------------------------
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B, nc, Q, Hl)
    Bfull = Bc.index_select(3, group)  # (B, nc, Q, Hl, N)
    states = torch.einsum("bcqh,bcqhp,bcqhn->bchpn",
                          decay_end.to(dt_store).float(),
                          xc.to(dt_store).float(),
                          Bfull.to(dt_store).float())

    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, Hl)
    s = (state.ssm.float() if state is not None
         else torch.zeros((B, Hl, P, N), dtype=torch.float32,
                          device=x.device))
    s_enter = []
    for c in range(nc):
        s_enter.append(s)  # state entering this chunk
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    s_enter = torch.stack(s_enter, dim=1)  # (B, nc, Hl, P, N)

    Cfull = Cc.index_select(3, group)  # (B, nc, Q, Hl, N)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp",
                           Cfull.to(dt_store).float(),
                           s_enter.to(dt_store).float(),
                           torch.exp(cum).to(dt_store).float())

    y = y_intra.reshape(B, L, Hl, P) + y_inter.reshape(B, L, Hl, P)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(B, L, di)
    # Gated RMSNorm (Mamba2's RMSNormGated: gate, then normalize), over
    # the whole d_inner.
    y = y * F.silu(z.float())
    y = common.rms_norm_split(y.to(x.dtype), params["norm_w"], cfg.d_inner)
    out = _out(y, params["out_proj"], x.dtype)
    if not with_state:
        return shard(out, DATA, None, None), None
    if split:  # the tail whole: every rank's x (and B / C) channels
        _check_split(cfg)
        new_tail = torch.cat([common.gather_model(new_tail[..., :di], -1),
                              common.gather_model(new_tail[..., di:], -1)],
                             dim=-1)
    pos = (state.pos + L if state is not None
           else torch.full((B,), L, dtype=torch.int32, device=x.device))
    # JAX casts the final state to its float32 s0, whatever state.ssm was.
    new_state = SSMState(ssm=s, conv=new_tail, pos=pos)
    return shard(out, DATA, None, None), new_state


def _decode_inputs(params, cfg: SSMConfig, x, conv):
    """A decode step's projection and conv (module docstring): (z, the
    conv's activated channels, dt_raw, the new window), every channel.
    Within :func:`~.common.tensor_parallel` the rank's column shard of
    ``in_proj`` and channel shard of ``conv_w`` / ``conv_b`` compute
    theirs, gathered over ``"model"``: no weight is gathered."""
    split = common.model_size() > 1
    w = common.model_part(params["in_proj"])
    proj = torch.einsum("bld,df->blf", x, w)[:, 0]
    if split:
        proj = common.gather_model(proj, -1)
    z, xBC, dt_raw = _split(cfg, proj)
    # conv over the K-long history window
    hist = torch.cat([conv, xBC[:, None, :]], dim=1)  # (B,K,C)
    cw, cb = (common.model_part(params[n]) for n in ("conv_w", "conv_b"))
    # A float32 tail (init_state's) promotes the window, as in JAX.
    cw = cw.to(torch.promote_types(hist.dtype, cw.dtype))
    win = hist
    if split:  # this rank's channel shard of the window
        n = cfg.conv_dim // common.model_size()
        win = hist[..., common.model_rank() * n:(common.model_rank() + 1) * n]
    act = F.silu(torch.einsum("bkc,kc->bc", win.to(cw.dtype), cw) + cb)
    if split:
        act = common.gather_model(act, -1)
    return z, act, dt_raw, hist


def fwd_decode(params, cfg: SSMConfig, x, state: SSMState):
    """One-token recurrence. x: (B, 1, D) -> (B, 1, D), state'.  Within
    :func:`~.common.tensor_parallel` on this rank's heads: ``state.ssm``
    holds them, the conv window is whole (module docstring)."""
    B = x.shape[0]
    H, P, N, G = cfg.n_heads, cfg.headdim, cfg.d_state, cfg.n_groups
    h0, h1 = _heads(cfg)
    Hl, di = h1 - h0, (h1 - h0) * P
    split = common.model_size() > 1
    if split:
        _check_split(cfg)
    else:
        params = common.gathered(params)
    z, xBC, dt_raw, hist = _decode_inputs(params, cfg, x, state.conv)
    xin, Bssm, Cssm = _xbc_split(cfg, xBC)
    z, xin = z[:, h0 * P:h1 * P], xin[:, h0 * P:h1 * P]
    dt_raw = dt_raw[:, h0:h1]
    hp = {n: common.model_share(params[n])[h0:h1]
          for n in ("A_log", "D", "dt_bias")}

    dt = F.softplus(dt_raw.float() + hp["dt_bias"])  # (B,Hl)
    A = -torch.exp(hp["A_log"])
    dec = torch.exp(dt * A)  # (B, Hl)
    xh = xin.reshape(B, Hl, P).float()
    group = torch.arange(h0, h1, device=x.device) // (H // G)
    Bh = Bssm.reshape(B, G, N).index_select(1, group).float()
    Ch = Cssm.reshape(B, G, N).index_select(1, group).float()

    s = state.ssm.float() * dec[..., None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhn,bhpn->bhp", Ch, s) + hp["D"][None, :, None] * xh
    y = y.reshape(B, di)
    y = y * F.silu(z.float())
    norm_w = common.model_slice(params["norm_w"], 0, h0 * P, h1 * P,
                                cfg.d_inner)
    y = common.rms_norm_split(y.to(x.dtype), norm_w, cfg.d_inner)
    out_proj = common.model_slice(params["out_proj"], 0, h0 * P, h1 * P,
                                  cfg.d_inner)
    out = _out(y[:, None, :], out_proj, x.dtype)
    return out, SSMState(ssm=s.to(state.ssm.dtype), conv=hist[:, 1:],
                         pos=state.pos + 1)
