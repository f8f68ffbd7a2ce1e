from .adamw import (AdamWConfig, AdamWState, adamw_init, adamw_state_axes,
                    adamw_state_shapes, adamw_update, clip_by_global_norm,
                    make_optimizer)
from .schedules import cosine_schedule, wsd_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "adamw_state_shapes", "adamw_state_axes",
           "make_optimizer", "clip_by_global_norm", "cosine_schedule",
           "wsd_schedule"]
