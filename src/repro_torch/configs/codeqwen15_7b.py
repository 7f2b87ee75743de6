"""codeqwen1.5-7b [dense] — qwen1.5 arch, MHA-equal GQA [hf:Qwen/CodeQwen1.5-7B].

32L d_model=4096 32H (GQA kv=32 = MHA) d_ff=13440 vocab=92416; qkv biases.
"""

from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="codeqwen1.5-7b",
        n_layers=32,
        d_model=4096,
        vocab=92_416,
        n_heads=32,
        n_kv=32,
        d_head=128,
        d_ff=13_440,
        block="dense",
        bias=True,  # qwen1.5 uses qkv bias
        rope_theta=1_000_000.0,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="codeqwen-smoke",
        n_layers=2,
        d_model=64,
        vocab=512,
        n_heads=4,
        n_kv=4,
        d_head=16,
        d_ff=128,
        block="dense",
        bias=True,
        remat=False,
        fsdp=False,
    )
