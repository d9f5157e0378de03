from .ancestral import p_sample, p_sample_loop, posterior_tables
from .ddim import DDIMSolver, ddim_sample_loop
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
    "ddim_sample_loop",
    "extract",
    "guidance_scale_embedding",
    "huber_loss",
    "lcm_timesteps",
    "p_sample",
    "p_sample_loop",
    "posterior_tables",
    "predicted_noise",
    "predicted_origin",
    "q_sample",
    "scalings_for_boundary_conditions",
    "timestep_embedding",
]
