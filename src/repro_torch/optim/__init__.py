"""The optimizer of the training path: AdamW and its LR schedules (the
reference's ``repro.optim``)."""

from repro_torch.optim import adamw, schedule
from repro_torch.optim.adamw import AdamWConfig, apply_updates, init_state

__all__ = ["adamw", "schedule", "AdamWConfig", "apply_updates", "init_state"]
