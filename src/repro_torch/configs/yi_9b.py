"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""

from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="yi-9b",
        n_layers=48,
        d_model=4096,
        vocab=64_000,
        n_heads=32,
        n_kv=4,
        d_head=128,
        d_ff=11_008,
        block="dense",
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="yi-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        block="dense",
        remat=False,
        fsdp=False,
    )
