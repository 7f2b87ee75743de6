"""whisper-large-v3 [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280 20H d_ff=5120 vocab=51866.
The mel/conv frontend is a STUB: input_specs() supplies the (B, 1500, D)
frame embeddings the conv stack would produce.
"""

from repro_torch.models.encdec import EncDecConfig


def full() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-large-v3",
        n_enc=32,
        n_dec=32,
        d_model=1280,
        n_heads=20,
        d_head=64,
        d_ff=5120,
        # 51866 logical, padded to a 256-multiple for clean vocab sharding.
        vocab=51_968,
        enc_len=1500,
        max_dec=448,
    )


def smoke() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-smoke",
        n_enc=2,
        n_dec=2,
        d_model=64,
        n_heads=4,
        d_head=16,
        d_ff=128,
        vocab=512,
        enc_len=64,
        max_dec=64,
        remat=False,
        fsdp=False,
    )
