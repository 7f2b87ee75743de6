"""Grouped-query attention with qk-norm, RoPE, sliding-window and KV cache.

Port of ``repro/models/attention.py``: MHA (kv == heads), GQA (kv < heads),
qk_norm (qwen3), sliding window (mixtral), no-bias (command-r),
cross-attention (whisper decoder), as plain torch ops; no fused library
attention.

**Float32 scores on bf16 inputs.**  JAX's flash-style path contracts the
storage dtype with ``preferred_element_type=float32``: bf16 operands,
float32 products and sums, and a float32 result.  Torch has no such
argument (a bf16 ``einsum`` rounds its result to bf16), so :func:`_dot32`
casts both operands to float32 first.  A bf16 value is exact in float32
and so is the product of two, so the scores reach the softmax in float32
with JAX's arithmetic, and so do the probability-times-V sums; only the
order of the float32 additions may differ.  The dense path casts to
float32 explicitly, as JAX's does.

The window ring cache and the chunk constants (:data:`CHUNK_Q`,
:data:`CHUNK_KV`, :data:`DENSE_MAX`) are JAX's; :func:`attend` reads the
constants when it is called, so a test can make them small.  Functions are
pure: a cache passed in is never written, the new cache is a new tensor.

**Heads on ``"model"``.**  Within
:func:`~repro_torch.models.common.tensor_parallel` (m > 1 ranks on
``"model"``), as JAX's hints put the heads there, each rank computes a
balanced range of q heads in train and prefill
(:func:`~.common.head_range`: the even split where m divides H; 40 heads
over 16 ranks are 2 or 3 a rank, where GSPMD pads) and the kv heads they
read (:func:`_kv_heads`), each q head's picked by index.  Their columns
of ``wq`` / ``wk`` / ``wv`` (and biases) and rows of ``wo`` come by
:func:`~.common.model_slice`: the rank's ``"model"`` shard where the
range is that shard, else the leaf whole (:func:`~.common.model_share`:
each rank's grad is its share), sliced, as where the stored shards split
heads mid-head or m does not divide the kv heads.  ``wo``'s partial is
summed over ``"model"`` before ``bo``.  Outside the block every rank
computes everything, as on one device.

Where m divides K, the KV cache is split on its heads.  Else it is split
on ``d_head`` (JAX's ``cache_specs``): prefill projects every kv head and
writes its ``d_head`` slice, and decode (:func:`_decode_dh`) projects its
columns, gathers the (B, 1, ·) q / k / v over ``"model"``, contracts
QK^T on its ``d_head`` slice, sums the logits over ``"model"``, and
gathers o back before the row-parallel ``wo``.

**The KV sequence on ``"data"``.**  Within
:func:`~repro_torch.models.common.seq_parallel` (a batch-1 serving step
whose ``"data"`` ranks split the cache's sequence) a cache holds this
rank's slice of the slots, ``[offset, offset + length)`` of ``total``:

* prefill computes the prompt whole on every rank (there are no rows to
  split) and keeps the slice of the cache, the window's rolled ring too;
* decode computes the new token's slot in whole-cache positions (the
  ring's ``length % total`` for a windowed arch); only the rank whose
  slice holds it writes it, at ``slot - offset``, by a masked index (no
  host sync);
* the query attends over the slice (:func:`_attend_seq`), masked by the
  keys' absolute positions: a float32 max ``m_r``, ``l_r = Σ exp(s −
  m_r)`` and ``acc_r = Σ exp(s − m_r) v`` a rank, combined by log-sum-exp
  (``M`` the max over the slices, then the sum of ``exp(m_r − M) l_r``
  and ``exp(m_r − M) acc_r``, packed in one all-reduce), then ``acc /
  l``.  A slice all masked (a long cache's upper part after a prefill)
  has ``m_r = NEG`` and ``exp(s − m_r) = 1`` on every key, harmless only
  because ``exp(m_r − M)`` is then 0: neither normalising a slice before
  the combine nor taking ``M`` from one slice would be right.  Where
  ``"model"`` also splits ``d_head``, the logits are summed over
  ``"model"`` first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import common
from .common import DATA, shard

__all__ = ["AttnConfig", "init", "param_specs", "attend", "fwd_train",
           "fwd_prefill", "fwd_decode", "fwd_cross_decode", "cross_kv",
           "KVCache", "init_cache"]

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    qk_norm: bool = False
    bias: bool = False
    window: int = 0  # sliding-window size; 0 = full causal
    rope_theta: float = 10_000.0
    causal: bool = True  # False for encoder self-attn
    cross: bool = False  # cross-attention (kv from encoder output)
    shard_cache_seq: bool = False  # SP decode: KV cache seq dim on 'data'


def init(gen, cfg: AttnConfig, dtype=torch.float32):
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    p = {
        "wq": common.normal_init(gen, (D, H * dh), dtype),
        "wk": common.normal_init(gen, (D, K * dh), dtype),
        "wv": common.normal_init(gen, (D, K * dh), dtype),
        "wo": common.normal_init(gen, (H * dh, D), dtype),
    }
    dev = common.init_device(gen)
    if cfg.bias:
        p |= {
            "bq": torch.zeros((H * dh,), dtype=dtype, device=dev),
            "bk": torch.zeros((K * dh,), dtype=dtype, device=dev),
            "bv": torch.zeros((K * dh,), dtype=dtype, device=dev),
            "bo": torch.zeros((D,), dtype=dtype, device=dev),
        }
    if cfg.qk_norm:
        p |= {"q_norm": torch.ones((dh,), dtype=dtype, device=dev),
              "k_norm": torch.ones((dh,), dtype=dtype, device=dev)}
    return p


def param_specs(cfg: AttnConfig, fsdp: bool = False):
    d0 = DATA if fsdp else None
    p = {
        "wq": common.pspec(d0, "model"),
        "wk": common.pspec(d0, "model"),
        "wv": common.pspec(d0, "model"),
        "wo": common.pspec("model", d0),
    }
    if cfg.bias:
        p |= {"bq": common.pspec("model"), "bk": common.pspec("model"),
              "bv": common.pspec("model"), "bo": common.pspec(None)}
    if cfg.qk_norm:
        p |= {"q_norm": common.pspec(None), "k_norm": common.pspec(None)}
    return p


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, K, dh)
    v: torch.Tensor  # (B, S, K, dh)
    length: torch.Tensor  # (B,) int32 — filled prefix length


def init_cache(cfg: AttnConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    K, dh = cfg.n_kv, cfg.d_head
    return KVCache(
        k=torch.zeros((batch, max_len, K, dh), dtype=dtype, device=device),
        v=torch.zeros((batch, max_len, K, dh), dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _proj(x, w, b):
    y = torch.einsum("bld,df->blf", x, w)
    return y + b if b is not None else y


def _heads(x, n, dh):
    return x.reshape(*x.shape[:-1], n, dh)


def _dh_split(cfg: AttnConfig) -> bool:
    """Whether the cache is split on ``d_head`` over ``"model"`` (m does
    not divide the kv heads), as JAX's ``cache_specs``."""
    m = common.model_size()
    return m > 1 and cfg.n_kv % m != 0


def _dh_slice(cfg: AttnConfig) -> slice:
    """This rank's ``d_head`` slice of a cache split on ``d_head``."""
    n = cfg.d_head // common.model_size()
    return slice(common.model_rank() * n, (common.model_rank() + 1) * n)


def _kv_heads(cfg: AttnConfig, every: bool, device):
    """The kv heads ``[lo, hi)`` a rank projects (those its q heads
    ``common.head_range(n_heads)`` read, or ``every`` one) and each of its
    q heads' index among them."""
    lo_q, hi_q = common.head_range(cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv
    lo, hi = (0, cfg.n_kv) if every else (lo_q // g, -(-hi_q // g))
    return lo, hi, torch.arange(lo_q, hi_q, device=device) // g - lo


def _cols(params, w: str, b: str, lo: int, hi: int, n: int, dh: int):
    """The columns of heads ``[lo, hi)`` (of ``n``) of the weight ``w``
    and the bias ``b`` (None where there is none), for this rank:
    :func:`~.common.model_slice` (its ``"model"`` shard where they are
    that shard)."""
    bias = params.get(b)
    return (common.model_slice(params[w], 1, lo * dh, hi * dh, n * dh),
            None if bias is None
            else common.model_slice(bias, 0, lo * dh, hi * dh, n * dh))


def _norm_rope(params, cfg: AttnConfig, q, k, positions):
    if cfg.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    if not cfg.cross:
        cos, sin = common.rope(positions, q.shape[-1], cfg.rope_theta)
        q = common.apply_rope(q, cos, sin)
        k = common.apply_rope(k, cos, sin)
    return q, k


def _qkv(params, cfg: AttnConfig, x, kv_src, positions, every_kv=False):
    """Project to (q, k, v) with qk-norm and RoPE applied: this rank's q
    heads and the kv heads they read, or ``every_kv`` one (every head
    outside :func:`~.common.tensor_parallel`; ``params``, ``x`` and
    ``kv_src`` as :func:`_enter` gives them; the columns by
    :func:`_cols`)."""
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    lo_q, hi_q = common.head_range(H)
    lo, hi, _ = _kv_heads(cfg, every_kv, x.device)
    q = _heads(_proj(x, *_cols(params, "wq", "bq", lo_q, hi_q, H, dh)),
               hi_q - lo_q, dh)
    k = _heads(_proj(kv_src, *_cols(params, "wk", "bk", lo, hi, K, dh)),
               hi - lo, dh)
    v = _heads(_proj(kv_src, *_cols(params, "wv", "bv", lo, hi, K, dh)),
               hi - lo, dh)
    norms = {n: common.model_share(params[n])
             for n in ("q_norm", "k_norm") if n in params}
    q, k = _norm_rope(norms, cfg, q, k, positions)
    q = shard(q, DATA, None, "model", None)
    k = shard(k, DATA, None, "model" if K > 1 else None, None)
    v = shard(v, DATA, None, "model" if K > 1 else None, None)
    return q, k, v


# Chunk sizes for the flash-style path (JAX's).
CHUNK_Q = 512
CHUNK_KV = 1024
DENSE_MAX = 2048  # use the dense path when Lq*Lk is small enough


def _divisor_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target (1500 -> 750 for target 1024)."""
    c = min(target, n)
    while n % c:
        c -= 1
    return c


def _mask(qpos, kpos, causal, window, kv_len):
    """(B, Lq, Lk) validity mask from absolute positions."""
    m = torch.ones((qpos.shape[0], qpos.shape[1], kpos.shape[-1]),
                   dtype=torch.bool, device=qpos.device)
    kp = kpos[None, None, :] if kpos.ndim == 1 else kpos[:, None, :]
    qp = qpos[:, :, None]
    if causal:
        m &= kp <= qp
    if window:
        m &= kp > (qp - window)
    if kv_len is not None:
        m &= kp < kv_len[:, None, None]
    return m


def _offsets(q_offset, batch, device):
    """q_offset (a scalar or (B,)) as a (B, 1) int tensor."""
    off = torch.as_tensor(q_offset, device=device)
    return torch.broadcast_to(off[..., None], (batch, 1))


def _dot32(eq, a, b):
    """``einsum`` with float32 products and sums (see the module docstring)."""
    return torch.einsum(eq, a.float(), b.float())


def _attend_dense(q, k, v, *, causal, window, q_offset, kv_len,
                  kv_seq_shard=False, d_head=None, reduce_logits=None):
    B, Lq, H, dh = q.shape
    Lk, K = k.shape[1], k.shape[2]
    g = H // K
    qg = q.reshape(B, Lq, K, g, dh)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head or dh),
                                          device=q.device))
    logits = torch.einsum("blkgh,bskh->bklgs", qg.float() * scale,
                          k.float())  # (B, K, Lq, g, Lk)
    if reduce_logits is not None:  # a d_head slice's partial logits
        logits = reduce_logits(logits)
    qpos = _offsets(q_offset, B, q.device) + torch.arange(Lq, device=q.device)
    m = _mask(qpos, torch.arange(Lk, device=q.device), causal, window, kv_len)
    logits = torch.where(m[:, None, :, None, :], logits, NEG)
    if kv_seq_shard:
        logits = shard(logits, DATA, None, None, None, "data")
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bklgs,bskh->blkgh", probs.to(v.dtype), v)
    return out.reshape(B, Lq, H, dh)


def _attend_chunked(q, k, v, *, causal, window, q_offset, kv_len):
    """Online-softmax (flash-style) two-level loop; memory O(Cq*Ck).

    The q/k/v blocks and the probabilities stay at the storage dtype and
    are contracted by :func:`_dot32`; the softmax statistics (max,
    normalizer, accumulator) are float32, as JAX's.
    """
    B, Lq, H, dh = q.shape
    Lk, K = k.shape[1], k.shape[2]
    g = H // K
    cq, ck = _divisor_chunk(Lq, CHUNK_Q), _divisor_chunk(Lk, CHUNK_KV)
    nq, nk = Lq // cq, Lk // ck
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype, device=q.device)

    qs = q.reshape(B, nq, cq, K, g, dh) * scale
    ks = k.reshape(B, nk, ck, K, dh)
    vs = v.reshape(B, nk, ck, K, dh)
    qpos0 = _offsets(q_offset, B, q.device)
    outs = []
    for qi in range(nq):
        qb = qs[:, qi]  # (B, cq, K, g, dh)
        qpos = qpos0 + qi * cq + torch.arange(cq, device=q.device)[None, :]
        m_run = torch.full((B, K, cq, g), NEG, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, K, cq, g), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, K, cq, g, dh), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            s = _dot32("blkgh,bskh->bklgs", qb, ks[:, ki])
            kpos = ki * ck + torch.arange(ck, device=q.device)
            msk = _mask(qpos, kpos, causal, window, kv_len)
            s = torch.where(msk[:, None, :, None, :], s, NEG)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + _dot32(
                "bklgs,bskh->bklgh", p.to(v.dtype), vs[:, ki])
            m_run = m_new
        out = acc / torch.clamp_min(l_run, 1e-30)[..., None]  # (B,K,cq,g,dh)
        outs.append(out.permute(0, 2, 1, 3, 4).reshape(B, cq, H, dh))
    return torch.cat(outs, dim=1).to(v.dtype)


def attend(q, k, v, *, causal: bool, window: int, q_offset, kv_len=None,
           kv_seq_shard: bool = False, d_head=None, reduce_logits=None):
    """softmax(QK^T) V with GQA head-group expansion.

    q: (B, Lq, H, dh); k/v: (B, Lk, K, dh); q_offset: scalar/(B,) — absolute
    position of q[0] (for causal masking of cached decode).
    kv_len: (B,) valid cache length, None = all valid.
    Dispatches to a dense path for small problems / decode, and to a
    flash-style chunked loop otherwise.  A decode step on a ``d_head``
    slice (``Lq`` 1) passes the head's whole ``d_head`` (the scale) and
    ``reduce_logits``, which sums the slices' float32 logits.
    """
    Lq, Lk = q.shape[1], k.shape[1]
    if reduce_logits is not None and Lq > 1:
        raise ValueError("a d_head slice attends one query at a time")
    if Lq <= 1 or (Lq <= DENSE_MAX and Lk <= DENSE_MAX):
        return _attend_dense(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len,
                             kv_seq_shard=kv_seq_shard, d_head=d_head,
                             reduce_logits=reduce_logits)
    return _attend_chunked(q, k, v, causal=causal, window=window,
                           q_offset=q_offset, kv_len=kv_len)


def _expand_kv(k, v, n_heads: int):
    """Repeat KV heads to the full q-head count (JAX's layout for sharded
    attention; decode keeps the compact K-head cache)."""
    g = n_heads // k.shape[2]
    if g == 1:
        return k, v
    k = shard(torch.repeat_interleave(k, g, dim=2), DATA, None, "model", None)
    v = shard(torch.repeat_interleave(v, g, dim=2), DATA, None, "model", None)
    return k, v


def _expand(k, v, cfg: AttnConfig, every_kv=False):
    """k / v at one kv head a q head of this rank: where its q heads are
    whole groups of the kv heads :func:`_qkv` projected,
    :func:`_expand_kv` (its backward a sum, not a scatter-add: no
    atomics on the card), else its q heads' kv heads picked by index."""
    lo, hi, idx = _kv_heads(cfg, every_kv, k.device)
    lo_q, hi_q = common.head_range(cfg.n_heads)
    g = cfg.n_heads // cfg.n_kv
    if not every_kv and (lo_q, hi_q) == (lo * g, hi * g):
        return _expand_kv(k, v, hi_q - lo_q)
    k = shard(k.index_select(2, idx), DATA, None, "model", None)
    v = shard(v.index_select(2, idx), DATA, None, "model", None)
    return k, v


def _enter(params, cfg: AttnConfig, x, kv_src):
    """``(params, x, kv_src)`` as :func:`_qkv` takes them: ``params``
    gathered whole on one ``"model"`` rank, else the inputs entering the
    split layer (m ranks split H heads: m <= H)."""
    m = common.model_size()
    if m == 1:
        return common.gathered(params), x, kv_src
    if m > cfg.n_heads:
        raise ValueError(f"\"model\" of {m} splits {cfg.n_heads} heads")
    xc = None if x is None else common.copy_to_model(x)
    return params, xc, xc if kv_src is x else common.copy_to_model(kv_src)


def _wo(params, cfg: AttnConfig):
    """This rank's rows of ``wo``: those of its q heads
    (:func:`~.common.head_range`, by :func:`~.common.model_slice`)."""
    lo, hi = common.head_range(cfg.n_heads)
    return common.model_slice(params["wo"], 0, lo * cfg.d_head,
                              hi * cfg.d_head, cfg.n_heads * cfg.d_head)


def _out(params, o, B, L, wo):
    """The output projection of ``o`` by ``wo``, this rank's rows of
    ``params["wo"]`` (its partial summed over ``"model"`` before
    ``bo``; the whole ``wo`` outside :func:`~.common.tensor_parallel`)."""
    o = o.reshape(B, L, -1)
    y = common.reduce_from_model(common.row_product(o, wo), o.dtype)
    if params.get("bo") is not None:
        y = y + common.gathered(params["bo"])
    return y


def _zeros_b(B, device):
    return torch.zeros((B,), dtype=torch.int32, device=device)


def fwd_train(params, cfg: AttnConfig, x, kv_src=None, positions=None):
    B, L, _ = x.shape
    kv_src = x if kv_src is None else kv_src
    if positions is None:
        positions = torch.arange(L, device=x.device)[None, :]
    params, x, kv_src = _enter(params, cfg, x, kv_src)
    q, k, v = _qkv(params, cfg, x, kv_src, positions)
    k, v = _expand(k, v, cfg)
    o = attend(q, k, v, causal=cfg.causal and not cfg.cross, window=cfg.window,
               q_offset=_zeros_b(B, x.device))
    return shard(_out(params, o, B, L, _wo(params, cfg)), DATA, None, None)


def fwd_prefill(params, cfg: AttnConfig, x, cache: KVCache, positions=None):
    """Self-attn over the prompt; writes the cache. Returns (y, cache')."""
    B, L, _ = x.shape
    if positions is None:
        positions = torch.arange(L, device=x.device)[None, :]
    dh_split = _dh_split(cfg)
    params, xc, _ = _enter(params, cfg, x, x)
    q, k, v = _qkv(params, cfg, xc, xc, positions, every_kv=dh_split)
    ke, ve = _expand(k, v, cfg, every_kv=dh_split)
    o = attend(q, ke, ve, causal=True, window=cfg.window,
               q_offset=_zeros_b(B, x.device))
    y = _out(params, o, B, L, _wo(params, cfg))
    if dh_split:  # the cache holds this rank's d_head slice of every head
        k, v = k[..., _dh_slice(cfg)], v[..., _dh_slice(cfg)]
    sp = common.seq_split()
    lo, Sc = (0, cache.k.shape[1]) if sp is None else (sp.offset, sp.total)
    n = cache.k.shape[1]  # this rank's slots: [lo, lo + n) of Sc
    length = torch.full((B,), L, dtype=torch.int32, device=x.device)
    if L >= Sc:
        # Window-capped ring cache: keep the last Sc tokens, placing absolute
        # position p at slot p % Sc so decode's ring writes line up.
        shift = L % Sc
        kw = torch.roll(k[:, L - Sc:], shift, dims=1)[:, lo:lo + n]
        vw = torch.roll(v[:, L - Sc:], shift, dims=1)[:, lo:lo + n]
        newc = KVCache(k=kw.to(cache.k.dtype), v=vw.to(cache.v.dtype),
                       length=length)
    else:
        newk, newv = cache.k.clone(), cache.v.clone()
        hi = min(lo + n, L)  # the prompt's positions in this rank's slice
        if hi > lo:
            newk[:, :hi - lo] = k[:, lo:hi]
            newv[:, :hi - lo] = v[:, lo:hi]
        newc = KVCache(k=newk, v=newv, length=length)
    return shard(y, DATA, None, None), newc


def _total(cache: KVCache) -> int:
    """The whole cache's slots (this rank's slice within
    :func:`~.common.seq_parallel`)."""
    sp = common.seq_split()
    return cache.k.shape[1] if sp is None else sp.total


def _write(cfg: AttnConfig, cache: KVCache, k, v):
    """The cache with this step's k / v written at each row's slot (on a
    slice of the sequence: by the rank whose slice holds it, the others'
    slices unchanged)."""
    B = k.shape[0]
    if cfg.window:
        # Ring-buffer write at pos % window keeps the cache O(window).
        slot = (cache.length % _total(cache))[:, None]
    else:
        slot = cache.length[:, None]
    bidx = torch.arange(B, device=k.device)[:, None]
    newk, newv = cache.k.clone(), cache.v.clone()
    k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
    sp = common.seq_split()
    if sp is not None:  # a masked write at the clamped local slot
        slot = slot - sp.offset
        mine = ((slot >= 0) & (slot < sp.length))[..., None, None]
        slot = torch.clamp(slot, 0, sp.length - 1)
        k = torch.where(mine, k, newk[bidx, slot.long()])
        v = torch.where(mine, v, newv[bidx, slot.long()])
    newk[bidx, slot.long()] = k
    newv[bidx, slot.long()] = v
    return newk, newv


def _attend_cache(cfg: AttnConfig, q, newk, newv, cache: KVCache, **kw):
    """One query a row against the cache just written."""
    sp = common.seq_split()
    if cfg.window:
        # The ring holds only the last `window` positions by construction;
        # kv_len masks the slots not yet written during warm-up.
        kv_len = torch.clamp_max(cache.length + 1, _total(cache))
        args = dict(causal=False, window=0, q_offset=cache.length,
                    kv_len=kv_len)
    else:
        args = dict(causal=True, window=0, q_offset=cache.length,
                    kv_len=cache.length + 1)
    if sp is not None:
        return _attend_seq(q, newk, newv, sp, **args, **kw)
    return attend(q, newk, newv, **args, kv_seq_shard=cfg.shard_cache_seq,
                  **kw)


def _attend_seq(q, k, v, sp, *, causal, window, q_offset, kv_len,
                d_head=None, reduce_logits=None):
    """:func:`attend` of one query a row against this rank's slice of the
    KV sequence (``sp``, :class:`~repro_torch.distributed.spmd.SeqSlice`),
    the slices combined by log-sum-exp (module docstring)."""
    B, Lq, H, dh = q.shape
    n, K = k.shape[1], k.shape[2]
    g = H // K
    qg = q.reshape(B, Lq, K, g, dh)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d_head or dh),
                                          device=q.device))
    logits = torch.einsum("blkgh,bskh->bklgs", qg.float() * scale,
                          k.float())  # (B, K, Lq, g, n)
    if reduce_logits is not None:  # a d_head slice's partial logits
        logits = reduce_logits(logits)
    qpos = _offsets(q_offset, B, q.device) + torch.arange(Lq, device=q.device)
    kpos = sp.offset + torch.arange(n, device=q.device)
    m = _mask(qpos, kpos, causal, window, kv_len)
    s = torch.where(m[:, None, :, None, :], logits, NEG)
    m_r = s.amax(dim=-1)  # (B, K, Lq, g): NEG where the slice is masked
    p = torch.exp(s - m_r[..., None])
    c = torch.exp(m_r - sp.max(m_r))  # exactly 0 for a masked slice
    acc = _dot32("bklgs,bskh->bklgh", p, v) * c[..., None]
    tot = sp.sum(torch.cat([(p.sum(dim=-1) * c)[..., None], acc], dim=-1))
    out = tot[..., 1:] / tot[..., :1]  # (B, K, Lq, g, dh)
    return out.permute(0, 2, 1, 3, 4).reshape(B, Lq, H, dh).to(v.dtype)


def _sum_logits(logits):
    """The float32 logits of ``d_head`` slices summed over ``"model"``
    (in float32, as JAX's psum of its float32 scores)."""
    return common.reduce_from_model(logits, widen=False)


def _gathered_cols(params, x, w, b, n, dh):
    """This rank's columns of ``x @ w + b`` gathered over ``"model"``, as
    ``n`` heads of ``dh``: (B, 1, n, dh)."""
    bias = params.get(b)
    y = _proj(x, common.model_part(params[w]),
              None if bias is None else common.model_part(bias))
    return _heads(common.gather_model(y, -1), n, dh)


def _out_dh(params, o, B, L):
    """:func:`_out` of ``o``, this rank's ``d_head`` slice of every head,
    gathered back over ``"model"``: this rank's rows of ``wo``."""
    o = common.gather_model(o, -1).reshape(B, L, -1)
    n = o.shape[-1] // common.model_size()
    rows = o[..., common.model_rank() * n:(common.model_rank() + 1) * n]
    return _out(params, rows, B, L, common.model_part(params["wo"]))


def _decode_dh(params, cfg: AttnConfig, x, cache: KVCache):
    """:func:`fwd_decode` on a cache split on ``d_head`` (module
    docstring)."""
    B = x.shape[0]
    H, K, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    xc = common.copy_to_model(x)
    q = _gathered_cols(params, xc, "wq", "bq", H, dh)
    k = _gathered_cols(params, xc, "wk", "bk", K, dh)
    v = _gathered_cols(params, xc, "wv", "bv", K, dh)
    q, k = _norm_rope(common.gathered({n: params[n] for n in (
        "q_norm", "k_norm") if n in params}), cfg, q, k, cache.length[:, None])
    sl = _dh_slice(cfg)
    q, k, v = q[..., sl], k[..., sl], v[..., sl]
    newk, newv = _write(cfg, cache, k, v)
    o = _attend_cache(cfg, q, newk, newv, cache, d_head=dh,
                      reduce_logits=_sum_logits)
    return _out_dh(params, o, B, 1), KVCache(newk, newv, cache.length + 1)


def fwd_decode(params, cfg: AttnConfig, x, cache: KVCache):
    """One-token decode step against the cache. x: (B, 1, D)."""
    if _dh_split(cfg):
        # When kv heads don't divide the model axis, the cache is d_head-
        # sharded (see cache_specs); q follows the same split.
        return _decode_dh(params, cfg, x, cache)
    B = x.shape[0]
    pos = cache.length[:, None]  # (B, 1)
    params, xc, _ = _enter(params, cfg, x, x)
    q, k, v = _qkv(params, cfg, xc, xc, pos)
    newk, newv = _write(cfg, cache, k, v)
    o = _attend_cache(cfg, q, newk, newv, cache)
    return _out(params, o, B, 1, _wo(params, cfg)), KVCache(
        newk, newv, cache.length + 1)


def fwd_cross_decode(params, cfg: AttnConfig, x, enc_k, enc_v, enc_len=None,
                     cached: bool = False):
    """Cross-attention for decode/train: kv precomputed from encoder
    (:func:`cross_kv`'s heads, or with ``cached`` a serving cache's, which
    holds a ``d_head`` slice of every head where ``"model"`` splits it
    so: :func:`_dh_split`)."""
    B, Lq, _ = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    dh_cache = cached and _dh_split(cfg)
    if dh_cache and Lq == 1:  # one query against the d_head slice
        xc = common.copy_to_model(x)
        q = _gathered_cols(params, xc, "wq", "bq", H, dh)
        if cfg.qk_norm:
            q = common.rms_norm(q, common.gathered(params["q_norm"]))
        o = attend(q[..., _dh_slice(cfg)], enc_k, enc_v, causal=False,
                   window=0, q_offset=_zeros_b(B, x.device), kv_len=enc_len,
                   d_head=dh, reduce_logits=_sum_logits)
        return _out_dh(params, o, B, Lq)
    if dh_cache:  # a prompt: the heads whole, then the rank's kv heads
        lo, hi, _ = _kv_heads(cfg, False, x.device)
        enc_k = common.gather_model(enc_k, -1)[:, :, lo:hi]
        enc_v = common.gather_model(enc_v, -1)[:, :, lo:hi]
    params, xc, _ = _enter(params, cfg, x, x)
    lo_q, hi_q = common.head_range(H)
    q = _heads(_proj(xc, *_cols(params, "wq", "bq", lo_q, hi_q, H, dh)),
               hi_q - lo_q, dh)
    if cfg.qk_norm:
        q = common.rms_norm(q, common.model_share(params["q_norm"]))
    enc_k, enc_v = _expand(enc_k, enc_v, cfg)
    o = attend(q, enc_k, enc_v, causal=False, window=0,
               q_offset=_zeros_b(B, x.device), kv_len=enc_len)
    return _out(params, o, B, Lq, _wo(params, cfg))


def cross_kv(params, cfg: AttnConfig, enc_out):
    """Precompute cross-attention K/V from encoder output (where
    ``"model"`` splits the heads: the kv heads this rank's q heads read,
    :func:`_kv_heads`)."""
    K, dh = cfg.n_kv, cfg.d_head
    params, _, enc_out = _enter(params, cfg, None, enc_out)
    lo, hi, _ = _kv_heads(cfg, False, enc_out.device)
    k = _heads(_proj(enc_out, *_cols(params, "wk", "bk", lo, hi, K, dh)),
               hi - lo, dh)
    v = _heads(_proj(enc_out, *_cols(params, "wv", "bv", lo, hi, K, dh)),
               hi - lo, dh)
    return k, v
