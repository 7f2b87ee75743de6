"""Dense MLP blocks: SwiGLU (llama/qwen family) and GELU (whisper).

Port of ``repro/models/mlp.py``.  ``jax.nn.gelu`` defaults to the tanh
approximation, and so does :func:`gelu_mlp`.

Within :func:`~repro_torch.models.common.tensor_parallel` each rank
computes its columns of the hidden layer (``wg`` / ``wu`` / ``w1`` / ``b1``
column-parallel on their ``"model"`` shards, as JAX's hints put the ffn
on ``"model"``) and its partial of the output (``wd`` / ``w2``
row-parallel), summed over ``"model"`` before ``b2`` is added once.  The
parameters may be :class:`~repro_torch.models.common.ShardedLeaf` s.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common
from .common import DATA, shard

__all__ = ["init_swiglu", "swiglu", "swiglu_specs", "init_gelu", "gelu_mlp",
           "gelu_specs"]


def init_swiglu(gen, d_model: int, d_ff: int, dtype=torch.float32):
    return {
        "wg": common.normal_init(gen, (d_model, d_ff), dtype),
        "wu": common.normal_init(gen, (d_model, d_ff), dtype),
        "wd": common.normal_init(gen, (d_ff, d_model), dtype),
    }


def swiglu_specs(fsdp: bool = False):
    d0 = DATA if fsdp else None
    return {
        "wg": common.pspec(d0, "model"),
        "wu": common.pspec(d0, "model"),
        "wd": common.pspec("model", d0),
    }


def swiglu(params, x):
    dtype = x.dtype
    x = common.copy_to_model(x)
    h = F.silu(torch.einsum("bld,df->blf", x,
                            common.model_part(params["wg"])))
    h = h * torch.einsum("bld,df->blf", x, common.model_part(params["wu"]))
    h = shard(h, DATA, None, "model")
    y = common.row_product(h, common.model_part(params["wd"]))
    return shard(common.reduce_from_model(y, dtype), DATA, None, None)


def init_gelu(gen, d_model: int, d_ff: int, dtype=torch.float32, bias=True):
    p = {
        "w1": common.normal_init(gen, (d_model, d_ff), dtype),
        "w2": common.normal_init(gen, (d_ff, d_model), dtype),
    }
    if bias:
        dev = common.init_device(gen)
        p |= {"b1": torch.zeros((d_ff,), dtype=dtype, device=dev),
              "b2": torch.zeros((d_model,), dtype=dtype, device=dev)}
    return p


def gelu_specs(bias=True, fsdp: bool = False):
    d0 = DATA if fsdp else None
    p = {"w1": common.pspec(d0, "model"), "w2": common.pspec("model", d0)}
    if bias:
        p |= {"b1": common.pspec("model"), "b2": common.pspec(None)}
    return p


def gelu_mlp(params, x):
    dtype = x.dtype
    x = common.copy_to_model(x)
    h = torch.einsum("bld,df->blf", x, common.model_part(params["w1"]))
    if "b1" in params:
        h = h + common.model_part(params["b1"])
    h = shard(F.gelu(h, approximate="tanh"), DATA, None, "model")
    y = common.reduce_from_model(
        common.row_product(h, common.model_part(params["w2"])), dtype)
    if "b2" in params:
        y = y + common.gathered(params["b2"])
    return shard(y, DATA, None, None)
