"""Model zoo: unified LM (dense/GQA/MoE/SSM/hybrid) + enc-dec backbone.

Port of ``repro/models``: the same configs, parameter trees (JAX's paths,
shapes and orientation), caches and methods, in plain torch ops.  The
models launch none of the port's CUDA kernels: the JAX models reach no
Pallas kernel either.
"""

from __future__ import annotations

from .common import ParamTree
from .encdec import EncDec, EncDecCache, EncDecConfig
from .transformer import LM, LMCache, LMConfig

__all__ = ["LM", "LMCache", "LMConfig", "EncDec", "EncDecCache",
           "EncDecConfig", "ParamTree", "build"]


def build(cfg, device=None):
    """Model object from a config (LMConfig | EncDecConfig); its
    parameters and caches go to ``device`` (``cuda`` by default)."""
    if isinstance(cfg, EncDecConfig):
        return EncDec(cfg, device)
    return LM(cfg, device)
