"""zamba2-2.7b [hybrid] — Mamba2 + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 (Mamba2, ssm_state=64) with a **shared** transformer block
(32H MHA, d_ff=10240) reused before every group of 6 Mamba2 layers.  The
shared block has one weight set but per-application KV caches.
SSM state is O(1) in sequence, so ``long_500k`` runs.
"""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="zamba2-2.7b",
        n_layers=54,
        d_model=2560,
        vocab=32_000,
        n_heads=32,
        n_kv=32,
        d_head=80,
        d_ff=10_240,
        block="hybrid",
        attn_every=6,  # 9 shared-attn applications over 54 mamba layers
        ssm=SSMConfig(d_model=2560, d_state=64, headdim=64, expand=2,
                      n_groups=1, chunk=256),
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="zamba2-smoke",
        n_layers=4,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=128,
        block="hybrid",
        attn_every=2,
        ssm=SSMConfig(d_model=64, d_state=16, headdim=16, expand=2,
                      n_groups=1, chunk=16),
        remat=False,
        fsdp=False,
    )
