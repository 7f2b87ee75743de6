"""Optimizer substrate (port of ``repro.optim``): AdamW, the LR schedule
and global-norm clipping, as plain functions over parameter trees."""

from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm)
from .schedule import cosine_schedule

__all__ = [
    "AdamWConfig",
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "cosine_schedule",
]
