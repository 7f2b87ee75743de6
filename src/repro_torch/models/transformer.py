"""Unified decoder-only LM covering the dense / MoE / SSM / hybrid families.

Port of ``repro/models/transformer.py``.  One config describes every LM
arch:

* ``block="dense"``  — attn + SwiGLU (qwen3, command-r, codeqwen, yi,
  chameleon backbone)
* ``block="moe"``    — attn + MoE FFN (qwen3-moe, mixtral)
* ``block="ssm"``    — Mamba2 block only (mamba2-370m; d_ff = 0)
* ``block="hybrid"`` — groups of ``attn_every`` Mamba2 blocks, each group
  preceded by a **shared** transformer block whose weights are reused by
  every group (zamba2; the KV caches are per application)

The layer parameters are stacked on a leading (n_layers, ...) axis, as
JAX's, and the forward loops over that axis in Python where JAX scans.
``remat`` / ``remat_policy`` act where JAX's ``jax.checkpoint`` does, on
each block body of ``logits_train`` (a hybrid group's body as one) when
grads are on (:func:`~repro_torch.models.common.remat`).  A leaf is
gathered (:func:`~repro_torch.models.common.gathered`) inside the body
that uses it, the top-level leaves where they are used.  Within
:func:`~repro_torch.models.common.tensor_parallel` the attention and the
SwiGLU MLP compute their part of the heads and the ffn
(:mod:`.attention`, :mod:`.mlp`), the MoE layer its experts or its
experts' ffn (:mod:`.moe`), the embedding, the head and the loss their
part of the vocab (``embed`` split on its rows, ``lm_head`` on its
columns, the tied head ``embed``'s rows), the SSD its heads
(:mod:`.ssm`; its leaves reach it ungathered).
Parameters are a :class:`~repro_torch.models.common.ParamTree` (or the
nested dict it holds) at JAX's paths, so
``convert.model_params_from_jax_numpy`` is a copy by path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from .. import resolve_device
from . import attention, common, mlp, moe as moe_lib, ssm as ssm_lib
from .common import DATA, shard

__all__ = ["LMConfig", "LMCache", "LM"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0
    d_ff: int = 0
    qk_norm: bool = False
    bias: bool = False
    window: int = 0
    rope_theta: float = 10_000.0
    block: str = "dense"
    moe: Optional[moe_lib.MoEConfig] = None
    ssm: Optional[ssm_lib.SSMConfig] = None
    attn_every: int = 6  # hybrid: one shared attn block per group
    norm_eps: float = 1e-6
    tie_embed: bool = False
    remat: bool = True
    # remat policy: None = full recompute; "dots" = save matmul outputs.
    remat_policy: str | None = None
    fsdp: bool = True
    # Serving: shard weights over the data axes too (ZeRO-style) when a
    # model-parallel slice alone exceeds device memory.
    serve_fsdp: bool = False
    dtype: Any = torch.bfloat16

    @property
    def attn(self) -> attention.AttnConfig:
        return attention.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            d_head=self.d_head, qk_norm=self.qk_norm, bias=self.bias,
            window=self.window, rope_theta=self.rope_theta,
        )

    @property
    def n_groups(self) -> int:
        assert self.block == "hybrid"
        assert self.n_layers % self.attn_every == 0
        return self.n_layers // self.attn_every

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        D, V = self.d_model, self.vocab
        emb = V * D * (1 if self.tie_embed else 2)
        per = 0
        if self.block in ("dense", "moe"):
            a = self.attn
            per += D * (a.n_heads + 2 * a.n_kv) * a.d_head + a.n_heads * a.d_head * D
            if self.block == "dense":
                per += 3 * D * self.d_ff
            else:
                m = self.moe
                per += D * m.n_experts + 3 * m.n_experts * D * m.d_ff
            per += 2 * D
        elif self.block == "ssm":
            s = self.ssm
            per += D * (2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads)
            per += s.d_inner * D + s.conv_kernel * s.conv_dim + 2 * D
        elif self.block == "hybrid":
            s = self.ssm
            per_ssm = (D * (2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads)
                       + s.d_inner * D + s.conv_kernel * s.conv_dim + 2 * D)
            a = self.attn
            shared = (D * (a.n_heads + 2 * a.n_kv) * a.d_head
                      + a.n_heads * a.d_head * D + 3 * D * self.d_ff + 2 * D)
            return emb + self.n_layers * per_ssm + shared
        return emb + self.n_layers * per

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.block != "moe":
            return self.param_count()
        D, V, m = self.d_model, self.vocab, self.moe
        a = self.attn
        per = (D * (a.n_heads + 2 * a.n_kv) * a.d_head
               + a.n_heads * a.d_head * D
               + D * m.n_experts + 3 * m.top_k * D * m.d_ff + 2 * D)
        return V * D * (1 if self.tie_embed else 2) + self.n_layers * per


class LMCache(NamedTuple):
    """Decode cache: stacked attention caches + stacked SSM states."""

    kv: Any  # KVCache with leading layer dim, or None
    ssm: Any  # SSMState with leading layer dims, or None

    # The fields (or "field.sub-field"s) the tensor-parallel layers keep
    # split on "model" as cache_specs splits them: the KV caches (heads or
    # d_head) and the SSM state's heads; its conv tail and pos stay whole.
    MODEL_SPLIT = ("kv", "ssm.ssm")


class LM:
    """Functional model: params are trees at JAX's paths, methods are pure.

    ``device`` is where :meth:`init` and :meth:`init_cache` put their
    tensors: ``cuda`` unless the caller passes one (``"cpu"``, or
    ``"meta"`` for shapes alone); without a card and without a device it
    raises.
    """

    def __init__(self, cfg: LMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ---------------- init -------------------------------------------------
    def _init_block(self, gen):
        cfg = self.cfg
        dev = common.init_device(gen)
        p = {"ln1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)}
        if cfg.block in ("dense", "moe"):
            p["attn"] = attention.init(gen, cfg.attn, cfg.dtype)
            p["ln2"] = torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev)
            if cfg.block == "dense":
                p["mlp"] = mlp.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype)
            else:
                p["moe"] = moe_lib.init(gen, cfg.moe, cfg.dtype)
        else:  # ssm, hybrid
            p["ssm"] = ssm_lib.init(gen, cfg.ssm, cfg.dtype)
        return p

    def init(self, generator=None) -> common.ParamTree:
        """Random parameters from ``generator`` (a seeded one on the
        model's device by default): JAX's distributions and shapes."""
        cfg = self.cfg
        gen = (generator if generator is not None
               else common.default_generator(self.device))
        dev = common.init_device(gen)
        blocks = common.stack_layers(lambda: self._init_block(gen),
                                     cfg.n_layers)
        params = {
            "embed": common.normal_init(gen, (cfg.vocab, cfg.d_model),
                                        cfg.dtype, scale=0.02),
            "blocks": blocks,
            "final_norm": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                     device=dev),
        }
        if not cfg.tie_embed:
            params["lm_head"] = common.normal_init(
                gen, (cfg.d_model, cfg.vocab), cfg.dtype)
        if cfg.block == "hybrid":
            params["shared"] = {
                "ln1": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
                "attn": attention.init(gen, cfg.attn, cfg.dtype),
                "ln2": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
                "mlp": mlp.init_swiglu(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
            }
        return common.ParamTree(params)

    # ---------------- sharding specs ---------------------------------------
    def param_specs(self):
        cfg = self.cfg
        L = common.pspec  # shorthand
        fsdp = cfg.fsdp

        blk = {}
        if cfg.block in ("dense", "moe"):
            blk["ln1"] = L(None)
            blk["attn"] = attention.param_specs(cfg.attn, fsdp)
            blk["ln2"] = L(None)
            if cfg.block == "dense":
                blk["mlp"] = mlp.swiglu_specs(fsdp)
            else:
                blk["moe"] = moe_lib.param_specs(cfg.moe, fsdp)
        else:
            blk["ln1"] = L(None)
            blk["ssm"] = ssm_lib.param_specs(cfg.ssm, fsdp)

        specs = {
            "embed": L("model", DATA if fsdp else None),
            "blocks": common.stack_specs(blk),
            "final_norm": L(None),
        }
        if not cfg.tie_embed:
            specs["lm_head"] = L(DATA if fsdp else None, "model")
        if cfg.block == "hybrid":
            specs["shared"] = {
                "ln1": L(None),
                "attn": attention.param_specs(cfg.attn, fsdp),
                "ln2": L(None),
                "mlp": mlp.swiglu_specs(fsdp),
            }
        return specs

    # ---------------- block bodies ------------------------------------------
    def _attn_mlp_block(self, p, x, mode, cache=None, moe_aux=None):
        cfg = self.cfg
        h = common.rms_norm(x, common.gathered(p["ln1"]), cfg.norm_eps)
        if mode == "train":
            a = attention.fwd_train(p["attn"], cfg.attn, h)
        elif mode == "prefill":
            a, cache = attention.fwd_prefill(p["attn"], cfg.attn, h, cache)
        else:
            a, cache = attention.fwd_decode(p["attn"], cfg.attn, h, cache)
        x = x + a
        h = common.rms_norm(x, common.gathered(p["ln2"]), cfg.norm_eps)
        if cfg.block == "moe" and "moe" in p:
            y, aux = moe_lib.fwd(p["moe"], cfg.moe, h,
                                 dropless=(mode == "decode"))
            moe_aux = aux["aux_loss"] if moe_aux is None else moe_aux + aux["aux_loss"]
        else:
            y = mlp.swiglu(p["mlp"], h)
        return x + y, cache, moe_aux

    def _ssm_block(self, p, x, mode, state=None):
        cfg = self.cfg
        h = common.rms_norm(x, common.gathered(p["ln1"]), cfg.norm_eps)
        if mode == "decode":
            y, state = ssm_lib.fwd_decode(p["ssm"], cfg.ssm, h, state)
        else:
            y, state = ssm_lib.fwd_train(p["ssm"], cfg.ssm, h, state,
                                         with_state=mode != "train")
        return x + y, state

    def _embed(self, p, tokens):
        x = common.vocab_lookup(p["embed"], tokens).to(self.cfg.dtype)
        return shard(x, DATA, None, None)

    def _head(self, p):
        """The head (D, V): this rank's vocab columns within
        :func:`~.common.tensor_parallel`."""
        cfg = self.cfg
        head = common.model_part(p["embed"] if cfg.tie_embed
                                 else p["lm_head"])
        head = head.T if cfg.tie_embed else head
        return head.to(cfg.dtype)

    # ---------------- forward (train) ---------------------------------------
    def logits_train(self, params, tokens):
        """tokens (B, L) int -> logits (B, L, V); returns (logits, aux)."""
        cfg = self.cfg
        p = common.as_tree(params)
        x = self._embed(p, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        blocks = p["blocks"]
        if cfg.block in ("dense", "moe"):
            def body(x, aux, bp):
                x, _, aux2 = self._attn_mlp_block(bp, x, "train", None, aux)
                return x, aux2 if aux2 is not None else aux

            body = common.remat(body, cfg)
            for i in range(cfg.n_layers):
                x, aux = body(x, aux, common.tree_index(blocks, i))
        elif cfg.block == "ssm":
            def body(x, bp):
                return self._ssm_block(bp, x, "train")[0]

            body = common.remat(body, cfg)
            for i in range(cfg.n_layers):
                x = body(x, common.tree_index(blocks, i))
        else:  # hybrid: one body a group (the shared block, then g SSMs)
            g = cfg.attn_every

            def body(x, j):
                x, _, _ = self._attn_mlp_block(p["shared"], x, "train")
                for i in range(j * g, (j + 1) * g):
                    x, _ = self._ssm_block(common.tree_index(blocks, i), x,
                                           "train")
                return x

            body = common.remat(body, cfg)
            for j in range(cfg.n_groups):
                x = body(x, j)

        x = common.rms_norm(x, common.gathered(p["final_norm"]),
                            cfg.norm_eps)
        logits = torch.einsum("bld,dv->blv", common.copy_to_model(x),
                              self._head(p))
        return shard(logits, DATA, None, "model"), aux

    def loss(self, params, tokens, labels):
        logits, aux = self.logits_train(params, tokens)
        nll = _nll(logits, labels)
        return nll + 0.01 * aux, {"nll": nll, "aux": aux}

    # ---------------- serving ----------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> LMCache:
        cfg = self.cfg
        dev = self.device

        def stack_kv(n):
            c = attention.init_cache(cfg.attn, batch,
                                     min(max_len, cfg.window or max_len),
                                     cfg.dtype, dev)
            return common.stack([c] * n)

        def stack_ssm(shape_prefix):
            out = ssm_lib.init_state(cfg.ssm, batch, device=dev)
            for n in reversed(shape_prefix):
                out = common.stack([out] * n)
            return out

        if cfg.block in ("dense", "moe"):
            return LMCache(kv=stack_kv(cfg.n_layers), ssm=None)
        if cfg.block == "ssm":
            return LMCache(kv=None, ssm=stack_ssm((cfg.n_layers,)))
        return LMCache(kv=stack_kv(cfg.n_groups),
                       ssm=stack_ssm((cfg.n_groups, cfg.attn_every)))

    def cache_specs(self, long_ctx: bool = False) -> LMCache:
        """Spec tree matching init_cache().

        Normal decode shards the batch on (pod, data) and heads on model;
        ``long_ctx`` shards the KV *sequence* on data instead and
        replicates SSM state on data.
        """
        cfg = self.cfg
        L = common.pspec
        b = None if long_ctx else DATA
        # Shard KV heads on "model" when divisible; otherwise head_dim.
        kv_div = cfg.n_kv and cfg.n_kv % max(common.axis_size("model"), 1) == 0
        h_ax, d_ax = ("model", None) if kv_div else (None, "model")
        kv = attention.KVCache(
            k=L(None, b, "data" if long_ctx else None, h_ax, d_ax),
            v=L(None, b, "data" if long_ctx else None, h_ax, d_ax),
            length=L(None, b),
        )
        if cfg.block in ("dense", "moe"):
            return LMCache(kv=kv, ssm=None)
        if cfg.block == "ssm":
            st = ssm_lib.SSMState(
                ssm=L(None, b, "model", None, None),
                conv=L(None, b, None, "model"),
                pos=L(None, b),
            )
            return LMCache(kv=None, ssm=st)
        st = ssm_lib.SSMState(
            ssm=L(None, None, b, "model", None, None),
            conv=L(None, None, b, None, "model"),
            pos=L(None, None, b),
        )
        return LMCache(kv=kv, ssm=st)

    def _serve_layers(self, p, x, cache: LMCache, mode):
        cfg = self.cfg
        blocks = p["blocks"]
        if cfg.block in ("dense", "moe"):
            kvs = []
            for i in range(cfg.n_layers):
                x, c2, _ = self._attn_mlp_block(
                    common.tree_index(blocks, i), x, mode,
                    common.layer(cache.kv, i))
                kvs.append(c2)
            return x, LMCache(kv=common.stack(kvs), ssm=None)
        if cfg.block == "ssm":
            sts = []
            for i in range(cfg.n_layers):
                x, s2 = self._ssm_block(common.tree_index(blocks, i), x, mode,
                                        common.layer(cache.ssm, i))
                sts.append(s2)
            return x, LMCache(kv=None, ssm=common.stack(sts))
        # hybrid
        g = cfg.attn_every
        kvs, groups = [], []
        for j in range(cfg.n_groups):
            x, kv2, _ = self._attn_mlp_block(p["shared"], x, mode,
                                             common.layer(cache.kv, j))
            kvs.append(kv2)
            sts = []
            for i in range(g):
                x, s2 = self._ssm_block(common.tree_index(blocks, j * g + i),
                                        x, mode, common.layer(cache.ssm, j, i))
                sts.append(s2)
            groups.append(common.stack(sts))
        return x, LMCache(kv=common.stack(kvs), ssm=common.stack(groups))

    def prefill(self, params, tokens, cache: LMCache):
        """tokens (B, L) -> (logits (B, V) at the last position, cache')."""
        cfg = self.cfg
        p = common.as_tree(params)
        x = self._embed(p, tokens)
        x, cache = self._serve_layers(p, x, cache, "prefill")
        x = common.rms_norm(x, common.gathered(p["final_norm"]),
                            cfg.norm_eps)
        logits = torch.einsum("bd,dv->bv", common.copy_to_model(x[:, -1]),
                              self._head(p))
        return shard(logits, DATA, "model"), cache

    def decode_step(self, params, token, cache: LMCache):
        """token (B,) int -> (logits (B, V), cache')."""
        cfg = self.cfg
        p = common.as_tree(params)
        x = self._embed(p, token[:, None])
        x, cache = self._serve_layers(p, x, cache, "decode")
        x = common.rms_norm(x, common.gathered(p["final_norm"]),
                            cfg.norm_eps)
        logits = torch.einsum("bd,dv->bv", common.copy_to_model(x[:, 0]),
                              self._head(p))
        return shard(logits, DATA, "model"), cache


def _nll(logits, labels):
    """Mean token negative log-likelihood, in float32 (of this rank's vocab
    columns ``logits`` within :func:`~.common.tensor_parallel`)."""
    split = common.vocab_nll(logits, labels)
    if split is not None:
        return split
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)
