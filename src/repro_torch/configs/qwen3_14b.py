"""qwen3-14b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
"""

from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="qwen3-14b",
        n_layers=40,
        d_model=5120,
        vocab=151_936,
        n_heads=40,
        n_kv=8,
        d_head=128,
        d_ff=17_408,
        block="dense",
        qk_norm=True,
        rope_theta=1_000_000.0,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=160,
        block="dense",
        qk_norm=True,
        remat=False,
        fsdp=False,
    )
