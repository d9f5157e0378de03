"""LCM multistep scheduler (port of t2v_turbo_tpu/diffusion/scheduler.py).

`lcm_timesteps` picks the inference grid on the host; `LCMScheduler.step`
is one denoise + renoise step with the noise passed in by the caller, who
owns the `torch.Generator`: `step_scalars` (the step's five scalars as 0-d
tensors), then `lcm_update` (the arithmetic). The pipeline's exported step
program takes the scalars as inputs, so the host that serves it needs no
schedule.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .lcm import scalings_for_boundary_conditions
from .schedule import DiffusionSchedule


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

    def step_scalars(self, timestep: int, prev_timestep: int) -> StepScalars:
        """The step's scalars, each a 0-d f32 tensor on the schedule's device."""
        sched = self.schedule
        c_skip, c_out = scalings_for_boundary_conditions(float(timestep))
        dev = sched.alphas_cumprod.device
        return StepScalars(sched.sqrt_alphas_cumprod[timestep], sched.sqrt_one_minus_alphas_cumprod[timestep],
                           c_skip.to(dev), c_out.to(dev), sched.alphas_cumprod[prev_timestep])

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
        return lcm_update(model_output, sample, self.step_scalars(timestep, prev_timestep), noise)


class StepScalars(NamedTuple):
    """One LCM step's scalars: the epsilon parameterisation's sqrt(a_t) and
    sqrt(1 - a_t), the boundary scalings, and a_prev of the renoise."""

    sqrt_alpha: torch.Tensor
    sqrt_one_minus_alpha: torch.Tensor
    c_skip: torch.Tensor
    c_out: torch.Tensor
    alpha_prev: torch.Tensor


def lcm_update(model_output: torch.Tensor, sample: torch.Tensor, scalars, noise: Optional[torch.Tensor] = None):
    """The LCM step's arithmetic on its scalars -> (prev_sample, denoised):
    x0 = (sample - sqrt(1 - a) eps) / sqrt(a), denoised = c_out x0 +
    c_skip sample, then the renoise to a_prev (none without `noise`)."""
    sqrt_alpha, sqrt_one_minus_alpha, c_skip, c_out, alpha_prev = scalars
    pred_x0 = (sample - sqrt_one_minus_alpha * model_output) / sqrt_alpha
    denoised = c_out * pred_x0 + c_skip * sample
    if noise is None:
        return denoised, denoised
    return torch.sqrt(alpha_prev) * denoised + torch.sqrt(1.0 - alpha_prev) * noise, denoised
