"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (fused text+VQ).
The VQ image-token frontend is a STUB: input_specs() supplies token ids
drawn from the fused vocab (DESIGN.md §Arch-applicability).
"""

from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="chameleon-34b",
        n_layers=48,
        d_model=8192,
        vocab=65_536,
        n_heads=64,
        n_kv=8,
        d_head=128,
        d_ff=22_016,
        block="dense",
        qk_norm=True,  # chameleon uses qk-norm for stability
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="chameleon-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=2,
        d_head=16,
        d_ff=128,
        block="dense",
        qk_norm=True,
        remat=False,
        fsdp=False,
    )
