"""Optimizer substrate: AdamW and global-norm clipping. Schedules and
gradient compression come with the LLM stack."""

from repro_torch.optim.adamw import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, clip_by_global_norm,
                                     global_norm)

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm"]
