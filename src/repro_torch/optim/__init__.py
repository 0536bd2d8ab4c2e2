"""The optimizer and its schedules (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (
    OptConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule

__all__ = [
    "OptConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "cosine_schedule",
    "wsd_schedule",
]
