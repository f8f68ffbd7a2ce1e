from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_update,
                    clip_by_global_norm, make_optimizer)
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "make_optimizer", "clip_by_global_norm", "cosine_schedule",
           "wsd_schedule"]
