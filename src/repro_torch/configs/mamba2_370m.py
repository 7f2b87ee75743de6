"""mamba2-370m [ssm] — SSD, attention-free [arXiv:2405.21060].

48L d_model=1024, ssm_state=128, vocab=50280, d_ff=0 (no MLP blocks).
"""

from repro_torch.models.ssm import SSMConfig
from repro_torch.models.transformer import LMConfig


def full() -> LMConfig:
    return LMConfig(
        name="mamba2-370m",
        n_layers=48,
        d_model=1024,
        # 50280 logical, padded to a 256-multiple for clean vocab sharding
        # (standard practice; the mamba reference pads to a 16-multiple too).
        vocab=50_432,
        block="ssm",
        # chunk=256 kept after the §Perf C2/C3 hillclimb: chunk=128 and
        # remat_policy="dots" were both measured net-negative on the
        # memory term (see EXPERIMENTS.md §Perf — refuted hypotheses).
        ssm=SSMConfig(d_model=1024, d_state=128, headdim=64, expand=2,
                      n_groups=1, chunk=256),
        tie_embed=True,
    )


def smoke() -> LMConfig:
    return LMConfig(
        name="mamba2-smoke",
        n_layers=2,
        d_model=64,
        vocab=256,
        block="ssm",
        ssm=SSMConfig(d_model=64, d_state=16, headdim=16, expand=2,
                      n_groups=1, chunk=32),
        tie_embed=True,
        remat=False,
        fsdp=False,
    )
