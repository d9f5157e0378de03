from .lcm import (
    guidance_scale_embedding,
    predicted_origin,
    scalings_for_boundary_conditions,
    timestep_embedding,
)
from .schedule import DiffusionSchedule, extract
from .scheduler import LCMScheduler, lcm_timesteps

__all__ = [
    "DiffusionSchedule",
    "LCMScheduler",
    "extract",
    "guidance_scale_embedding",
    "lcm_timesteps",
    "predicted_origin",
    "scalings_for_boundary_conditions",
    "timestep_embedding",
]
