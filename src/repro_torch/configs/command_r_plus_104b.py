"""command-r-plus-104b [dense] — GQA, no-bias [hf:CohereForAI family].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
(The HF model uses parallel attn+FFN blocks; we use the standard
sequential residual form — noted in DESIGN.md.)
"""

from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="command-r-plus-104b",
        n_layers=64,
        d_model=12_288,
        vocab=256_000,
        n_heads=96,
        n_kv=8,
        d_head=128,
        d_ff=33_792,
        block="dense",
        bias=False,
        rope_theta=75_000_000.0,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="command-r-smoke",
        n_layers=2,
        d_model=96,
        vocab=512,
        n_heads=6,
        n_kv=2,
        d_head=16,
        d_ff=256,
        block="dense",
        remat=False,
        fsdp=False,
    )
