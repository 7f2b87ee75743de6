"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3 MoE family].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
Experts shard 8-per-device on the 16-way model axis (EP).
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        vocab=151_936,
        n_heads=64,
        n_kv=4,
        d_head=128,
        block="moe",
        moe=MoEConfig(d_model=4096, d_ff=1536, n_experts=128, top_k=8,
                      capacity_factor=1.25, shard_experts=True),
        qk_norm=True,
        rope_theta=1_000_000.0,
        serve_fsdp=True,  # 470 GB bf16: a 1/16 TP slice alone is 29 GB
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen3-moe-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=2,
        d_head=16,
        block="moe",
        moe=MoEConfig(d_model=64, d_ff=96, n_experts=8, top_k=2,
                      capacity_factor=4.0, shard_experts=True),
        qk_norm=True,
        remat=False,
        fsdp=False,
    )
