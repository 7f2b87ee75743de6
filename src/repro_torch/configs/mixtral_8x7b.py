"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) per-expert d_ff=14336 vocab=32000,
sliding window 4096.  With 8 experts < 16-way model axis, experts stay
replicated and d_ff is tensor-parallel inside each expert
(``shard_experts=False``).  SWA bounds the decode cache to the window,
so ``long_500k`` runs for this arch.
"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="mixtral-8x7b",
        n_layers=32,
        d_model=4096,
        vocab=32_000,
        n_heads=32,
        n_kv=8,
        d_head=128,
        window=4096,
        block="moe",
        moe=MoEConfig(d_model=4096, d_ff=14_336, n_experts=8, top_k=2,
                      capacity_factor=1.25, shard_experts=False),
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="mixtral-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=2,
        d_head=16,
        window=32,
        block="moe",
        # cf=4 makes the reduced config drop-free, so cache-consistency
        # tests compare decode against an undropped teacher-forced pass.
        moe=MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                      capacity_factor=4.0, shard_experts=False),
        remat=False,
        fsdp=False,
    )
