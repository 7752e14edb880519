"""Optimizers: AdamW and its learning-rate schedule."""

from .adamw import adamw_init, adamw_update, global_norm
from .schedules import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule", "global_norm"]
