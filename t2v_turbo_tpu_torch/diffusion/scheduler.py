"""LCM multistep scheduler (port of t2v_turbo_tpu/diffusion/scheduler.py).

`lcm_timesteps` picks the inference grid on the host; `LCMScheduler.step`
is one denoise + renoise step with the noise passed in by the caller, who
owns the `torch.Generator`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .lcm import predicted_origin, scalings_for_boundary_conditions
from .schedule import DiffusionSchedule, extract


def lcm_timesteps(
    num_inference_steps: int, lcm_origin_steps: int = 50, num_train_timesteps: int = 1000
) -> np.ndarray:
    """LCM inference timesteps, descending int64 (e.g. [999, 759, 519, 279])."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps {num_inference_steps} > train timesteps {num_train_timesteps}"
        )
    c = num_train_timesteps // lcm_origin_steps
    origin = np.arange(1, lcm_origin_steps + 1, dtype=np.int64) * c - 1
    skip = len(origin) // num_inference_steps
    return origin[::-skip][:num_inference_steps].copy()


@dataclasses.dataclass(frozen=True)
class LCMScheduler:
    """LCM step math for an epsilon-predicting UNet."""

    schedule: DiffusionSchedule

    def timesteps(self, num_inference_steps: int, lcm_origin_steps: int = 50) -> np.ndarray:
        return lcm_timesteps(num_inference_steps, lcm_origin_steps, self.schedule.num_timesteps)

    def step(
        self,
        model_output: torch.Tensor,
        timestep: int,
        prev_timestep: int,
        sample: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ):
        """One LCM step -> (prev_sample, denoised). `noise` is None on a
        single-step run; then prev_sample is the denoised sample."""
        sched = self.schedule
        t_b = torch.tensor([timestep], device=sample.device)
        pred_x0 = predicted_origin(model_output, t_b, sample, sched)
        c_skip, c_out = scalings_for_boundary_conditions(float(timestep))
        denoised = c_out * pred_x0 + c_skip * sample
        if noise is None:
            return denoised, denoised
        alpha_prev = extract(
            sched.alphas_cumprod, torch.tensor([prev_timestep], device=sample.device), sample.dim()
        )
        prev_sample = torch.sqrt(alpha_prev) * denoised + torch.sqrt(1.0 - alpha_prev) * noise
        return prev_sample, denoised
