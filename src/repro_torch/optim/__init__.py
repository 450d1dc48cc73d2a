"""Optimizers on the port's parameter trees: AdamW with optional 8-bit
moments, global-norm clipping and the learning-rate schedules."""

from repro_torch.optim.adam import AdamConfig, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamConfig", "adam_init", "adam_update", "cosine_schedule",
           "linear_warmup_cosine", "clip_by_global_norm"]
