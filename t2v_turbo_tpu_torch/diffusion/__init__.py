from .ddim import DDIMSolver
from .lcm import (
    guidance_scale_embedding,
    huber_loss,
    predicted_noise,
    predicted_origin,
    scalings_for_boundary_conditions,
    timestep_embedding,
)
from .schedule import DiffusionSchedule, add_noise, bcast_right, extract, q_sample
from .scheduler import LCMScheduler, lcm_timesteps

__all__ = [
    "DDIMSolver",
    "DiffusionSchedule",
    "LCMScheduler",
    "add_noise",
    "bcast_right",
    "extract",
    "guidance_scale_embedding",
    "huber_loss",
    "lcm_timesteps",
    "predicted_noise",
    "predicted_origin",
    "q_sample",
    "scalings_for_boundary_conditions",
    "timestep_embedding",
]
