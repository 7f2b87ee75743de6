"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

Port of ``repro/models/encdec.py``.  The conv/mel frontend is a stub: the
caller supplies precomputed frame embeddings (B, S_enc, D).  Pre-LayerNorm
blocks with biases, GELU MLP, sinusoidal positions on the encoder, learned
positions on the decoder, MHA self/cross attention, tied softmax head.

Serving: the encoder runs once; decoder prefill/decode carry a self-attn
KV cache plus per-layer cross K/V computed once from the encoder output.
``remat`` acts on each encoder block and each training decoder block when
grads are on, as JAX's ``jax.checkpoint`` there; a leaf is gathered
inside the body that uses it (:func:`~.common.gathered`).  Within
:func:`~.common.tensor_parallel` the attention and the GELU MLP compute
their part of the heads and the ffn, and the embedding, the tied head and
the loss their part of the vocab, as :mod:`.transformer`'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from .. import resolve_device
from . import attention, common, mlp
from .common import DATA, shard
from .transformer import _nll

__all__ = ["EncDecConfig", "EncDec", "EncDecCache"]


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    n_enc: int
    n_dec: int
    d_model: int
    n_heads: int
    d_head: int
    d_ff: int
    vocab: int
    enc_len: int = 1500  # native whisper frame count after conv
    max_dec: int = 448
    norm_eps: float = 1e-5
    remat: bool = True
    fsdp: bool = True
    dtype: Any = torch.bfloat16

    @property
    def attn(self) -> attention.AttnConfig:
        return attention.AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_heads,
            d_head=self.d_head, bias=True, causal=True)

    @property
    def enc_attn(self) -> attention.AttnConfig:
        return dataclasses.replace(self.attn, causal=False)

    @property
    def cross_attn(self) -> attention.AttnConfig:
        return dataclasses.replace(self.attn, cross=True)

    def param_count(self) -> int:
        D = self.d_model
        per_enc = 4 * D * D + 2 * D * self.d_ff + 6 * D
        per_dec = 8 * D * D + 2 * D * self.d_ff + 8 * D
        return (self.vocab * D + self.n_enc * per_enc + self.n_dec * per_dec)


class EncDecCache(NamedTuple):
    kv: Any  # stacked self-attn KVCache (n_dec, ...)
    cross_k: torch.Tensor  # (n_dec, B, S_enc, H, dh)
    cross_v: torch.Tensor

    # The fields the tensor-parallel layers keep split on "model" as
    # cache_specs splits them (heads or d_head).
    MODEL_SPLIT = ("kv", "cross_k", "cross_v")


def _ln_init(cfg, dev):
    return {"w": torch.ones((cfg.d_model,), dtype=cfg.dtype, device=dev),
            "b": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=dev)}


def _ln(x, p, eps):
    return common.layer_norm(x, p["w"], p["b"], eps)


class EncDec:
    """Functional enc-dec model; ``device`` as :class:`~.transformer.LM`'s."""

    def __init__(self, cfg: EncDecConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------- init -----------------------------------------------------
    def _enc_block(self, gen):
        cfg = self.cfg
        dev = common.init_device(gen)
        return {
            "ln1": _ln_init(cfg, dev),
            "attn": attention.init(gen, cfg.enc_attn, cfg.dtype),
            "ln2": _ln_init(cfg, dev),
            "mlp": mlp.init_gelu(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def _dec_block(self, gen):
        cfg = self.cfg
        dev = common.init_device(gen)
        return {
            "ln1": _ln_init(cfg, dev),
            "self": attention.init(gen, cfg.attn, cfg.dtype),
            "ln_x": _ln_init(cfg, dev),
            "cross": attention.init(gen, cfg.cross_attn, cfg.dtype),
            "ln2": _ln_init(cfg, dev),
            "mlp": mlp.init_gelu(gen, cfg.d_model, cfg.d_ff, cfg.dtype),
        }

    def init(self, generator=None) -> common.ParamTree:
        """Random parameters, as :meth:`~.transformer.LM.init`."""
        cfg = self.cfg
        gen = (generator if generator is not None
               else common.default_generator(self.device))
        dev = common.init_device(gen)
        return common.ParamTree({
            "embed": common.normal_init(gen, (cfg.vocab, cfg.d_model),
                                        cfg.dtype, scale=0.02),
            "dec_pos": common.normal_init(gen, (cfg.max_dec, cfg.d_model),
                                          cfg.dtype, scale=0.02),
            "enc": common.stack_layers(lambda: self._enc_block(gen),
                                       cfg.n_enc),
            "dec": common.stack_layers(lambda: self._dec_block(gen),
                                       cfg.n_dec),
            "enc_ln": _ln_init(cfg, dev),
            "dec_ln": _ln_init(cfg, dev),
        })

    def param_specs(self):
        cfg = self.cfg
        L = common.pspec
        fsdp = cfg.fsdp
        ln = {"w": L(None), "b": L(None)}
        enc_blk = {
            "ln1": ln, "attn": attention.param_specs(cfg.enc_attn, fsdp),
            "ln2": ln, "mlp": mlp.gelu_specs(True, fsdp),
        }
        dec_blk = {
            "ln1": ln, "self": attention.param_specs(cfg.attn, fsdp),
            "ln_x": ln, "cross": attention.param_specs(cfg.cross_attn, fsdp),
            "ln2": ln, "mlp": mlp.gelu_specs(True, fsdp),
        }
        return {
            "embed": L("model", DATA if fsdp else None),
            "dec_pos": L(None, None),
            "enc": common.stack_specs(enc_blk),
            "dec": common.stack_specs(dec_blk),
            "enc_ln": ln,
            "dec_ln": ln,
        }

    # ------------- encoder ---------------------------------------------------
    def encode(self, params, frames):
        """frames: (B, S_enc, D) stub embeddings -> encoder output."""
        cfg = self.cfg
        p = common.as_tree(params)
        S = frames.shape[1]
        dev = frames.device
        pos = torch.arange(S, device=dev)
        half = cfg.d_model // 2
        freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=dev)
                         / (half - 1) * math.log(10_000.0))
        ang = pos[:, None] * freq[None, :]
        pe = torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(cfg.dtype)
        x = shard(frames.to(cfg.dtype) + pe[None], DATA, None, None)

        def body(x, bp):
            h = _ln(x, common.gathered(bp["ln1"]), cfg.norm_eps)
            x = x + attention.fwd_train(bp["attn"], cfg.enc_attn, h)
            h = _ln(x, common.gathered(bp["ln2"]), cfg.norm_eps)
            return x + mlp.gelu_mlp(bp["mlp"], h)

        body = common.remat(body, cfg)
        for i in range(cfg.n_enc):
            x = body(x, common.tree_index(p["enc"], i))
        return _ln(x, common.gathered(p["enc_ln"]), cfg.norm_eps)

    # ------------- decoder ---------------------------------------------------
    def _dec_layer(self, bp, x, enc_out, mode, kv_c=None, cross=None):
        cfg = self.cfg
        h = _ln(x, common.gathered(bp["ln1"]), cfg.norm_eps)
        if mode == "train":
            x = x + attention.fwd_train(bp["self"], cfg.attn, h)
        elif mode == "prefill":
            a, kv_c = attention.fwd_prefill(bp["self"], cfg.attn, h, kv_c)
            x = x + a
        else:
            a, kv_c = attention.fwd_decode(bp["self"], cfg.attn, h, kv_c)
            x = x + a
        h = _ln(x, common.gathered(bp["ln_x"]), cfg.norm_eps)
        if mode == "train":
            ck, cv = attention.cross_kv(bp["cross"], cfg.cross_attn, enc_out)
        else:
            ck, cv = cross
        x = x + attention.fwd_cross_decode(bp["cross"], cfg.cross_attn, h,
                                           ck, cv, cached=mode != "train")
        h = _ln(x, common.gathered(bp["ln2"]), cfg.norm_eps)
        return x + mlp.gelu_mlp(bp["mlp"], h), kv_c

    def _dec_body(self, p, x, enc_out, mode, cache=None):
        kvs = []

        def train_body(x, bp):
            return self._dec_layer(bp, x, enc_out, "train")[0]

        train_body = common.remat(train_body, self.cfg)
        for i in range(self.cfg.n_dec):
            bp = common.tree_index(p["dec"], i)
            if mode == "train":
                x = train_body(x, bp)
            else:
                x, kv = self._dec_layer(bp, x, None, mode,
                                        common.layer(cache.kv, i),
                                        (cache.cross_k[i], cache.cross_v[i]))
                kvs.append(kv)
        if mode == "train":
            return x, None
        return x, EncDecCache(kv=common.stack(kvs), cross_k=cache.cross_k,
                              cross_v=cache.cross_v)

    def _head(self, p, x):
        """The tied head's logits: this rank's vocab columns within
        :func:`~.common.tensor_parallel`."""
        head = common.model_part(p["embed"]).T.to(self.cfg.dtype)
        return torch.einsum("...d,dv->...v", common.copy_to_model(x), head)

    def loss(self, params, frames, tokens, labels):
        cfg = self.cfg
        p = common.as_tree(params)
        enc_out = self.encode(p, frames)
        L = tokens.shape[1]
        pos_tab = common.gathered(p["dec_pos"])
        if L > pos_tab.shape[0]:  # long shapes exceed the native 448
            reps = -(-L // pos_tab.shape[0])
            pos_tab = pos_tab.repeat(reps, 1)
        x = (common.vocab_lookup(p["embed"], tokens).to(cfg.dtype)
             + pos_tab[None, :L])
        x = shard(x, DATA, None, None)
        x, _ = self._dec_body(p, x, enc_out, "train")
        x = _ln(x, common.gathered(p["dec_ln"]), cfg.norm_eps)
        nll = _nll(self._head(p, x), labels)
        zero = torch.zeros((), dtype=torch.float32, device=nll.device)
        return nll, {"nll": nll, "aux": zero}

    # ------------- serving ----------------------------------------------------
    def init_cache(self, params, enc_out, batch: int, max_len: int):
        cfg = self.cfg
        p = common.as_tree(params)
        kv = attention.init_cache(cfg.attn, batch, max_len, cfg.dtype,
                                  self.device)
        kv = common.stack([kv] * cfg.n_dec)
        cks, cvs = zip(*(attention.cross_kv(common.tree_index(p["dec"], i)
                                            ["cross"], cfg.cross_attn, enc_out)
                         for i in range(cfg.n_dec)))
        return EncDecCache(kv=kv, cross_k=torch.stack(cks).to(cfg.dtype),
                           cross_v=torch.stack(cvs).to(cfg.dtype))

    def cache_specs(self, long_ctx: bool = False) -> EncDecCache:
        L = common.pspec
        b = None if long_ctx else DATA
        s = "data" if long_ctx else None
        kv_div = self.cfg.n_heads % max(common.axis_size("model"), 1) == 0
        h_ax, d_ax = ("model", None) if kv_div else (None, "model")
        kv = attention.KVCache(
            k=L(None, b, s, h_ax, d_ax),
            v=L(None, b, s, h_ax, d_ax),
            length=L(None, b),
        )
        return EncDecCache(
            kv=kv,
            cross_k=L(None, b, None, h_ax, d_ax),
            cross_v=L(None, b, None, h_ax, d_ax),
        )

    def _embed_tok(self, p, token, position):
        cfg = self.cfg
        pos_tab = common.gathered(p["dec_pos"])
        idx = position % pos_tab.shape[0]
        return (common.vocab_lookup(p["embed"], token).to(cfg.dtype)
                + pos_tab[idx.long()].to(cfg.dtype))

    def prefill(self, params, tokens, cache: EncDecCache):
        cfg = self.cfg
        p = common.as_tree(params)
        B, L = tokens.shape
        x = self._embed_tok(p, tokens,
                            torch.arange(L, device=tokens.device)[None, :])
        x = shard(x, DATA, None, None)
        x, cache = self._dec_body(p, x, None, "prefill", cache)
        x = _ln(x, common.gathered(p["dec_ln"]), cfg.norm_eps)
        return self._head(p, x[:, -1]), cache

    def decode_step(self, params, token, cache: EncDecCache):
        cfg = self.cfg
        p = common.as_tree(params)
        pos = cache.kv.length[0][:, None]  # (B, 1) — layer 0's fill level
        x = self._embed_tok(p, token[:, None], pos)
        x, cache = self._dec_body(p, x, None, "decode", cache)
        x = _ln(x, common.gathered(p["dec_ln"]), cfg.norm_eps)
        return self._head(p, x[:, 0]), cache
