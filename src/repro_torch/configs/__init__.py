"""Assigned architecture registry: ``--arch <id>`` resolves here.

Port of ``repro/configs``: the same ten architectures, field for field.

Each ``<arch>.py`` exposes ``full()`` (the exact published config) and
``smoke()`` (a reduced same-family config for CPU tests).  The registry
also carries the shape cells and per-arch skips (with reasons).
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

__all__ = ["SHAPES", "ARCH_IDS", "get", "get_smoke", "skip_reason", "ShapeCell"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

ARCH_IDS = (
    "mamba2-370m",
    "chameleon-34b",
    "qwen3-14b",
    "command-r-plus-104b",
    "codeqwen1.5-7b",
    "yi-9b",
    "qwen3-moe-235b-a22b",
    "mixtral-8x7b",
    "zamba2-2.7b",
    "whisper-large-v3",
)

_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "chameleon-34b": "chameleon_34b",
    "qwen3-14b": "qwen3_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-9b": "yi_9b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "mixtral-8x7b": "mixtral_8x7b",
    "zamba2-2.7b": "zamba2_27b",
    "whisper-large-v3": "whisper_large_v3",
}

# long_500k needs a sub-quadratic (or window-bounded) path.  Archs with pure
# full attention skip it.
_SKIPS = {
    ("chameleon-34b", "long_500k"): "pure full attention (O(L) KV at 524k infeasible)",
    ("qwen3-14b", "long_500k"): "pure full attention",
    ("command-r-plus-104b", "long_500k"): "pure full attention",
    ("codeqwen1.5-7b", "long_500k"): "pure full attention",
    ("yi-9b", "long_500k"): "pure full attention",
    ("qwen3-moe-235b-a22b", "long_500k"): "pure full attention",
    ("whisper-large-v3", "long_500k"): "pure full attention enc-dec",
}


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choose from {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}")


def get(arch_id: str):
    """Full (published) config for an assigned architecture."""
    return _mod(arch_id).full()


def get_smoke(arch_id: str):
    """Reduced same-family config for CPU smoke tests (f32 for tight
    numeric comparisons — production configs stay bf16)."""
    cfg = _mod(arch_id).smoke()
    return dataclasses.replace(cfg, dtype=torch.float32)


def skip_reason(arch_id: str, shape_name: str) -> str | None:
    return _SKIPS.get((arch_id, shape_name))
