"""Optimizers of the port (AdamW, SGD with momentum), schedules, clipping
and the mask-projection hook."""

from .optimizer import (OptConfig, apply_updates, clip_by_global_norm,
                        init_state, schedule_lr)

__all__ = ["OptConfig", "apply_updates", "clip_by_global_norm", "init_state",
           "schedule_lr"]
