"""The diffusion noise schedule (port of t2v_turbo_tpu/diffusion/schedule.py):
the tables, `extract`, and the forward diffusion `q_sample` / `add_noise`
that training draws its noisy latents with (the VC2 latent-scale variant of
`q_sample` is v2 training's and is not ported yet).

The tables are computed in float64 numpy exactly as the JAX package does for
the `scaled_linear` schedule of every T2V-Turbo config, then held as float32
tensors; `to(device)` moves them next to the latents.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Cumulative-alpha tables, each a (T,) float32 tensor."""

    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(
        cls, num_timesteps: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.012
    ) -> "DiffusionSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64) ** 2
        alphas_cumprod = np.cumprod(1.0 - betas)

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32))

        return cls(
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            num_timesteps=num_timesteps,
        )

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(
            self,
            alphas_cumprod=self.alphas_cumprod.to(device),
            sqrt_alphas_cumprod=self.sqrt_alphas_cumprod.to(device),
            sqrt_one_minus_alphas_cumprod=self.sqrt_one_minus_alphas_cumprod.to(device),
        )


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """table[t], right-broadcast to `ndim` dims: (B,) -> (B, 1, 1, ...)."""
    out = table[t.to(device=table.device, dtype=torch.long)]
    return out.reshape(out.shape + (1,) * (ndim - out.dim()))


def bcast_right(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Right-broadcast a (B,) tensor to `ndim` dims: (B, 1, 1, ...)."""
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def q_sample(sched: DiffusionSchedule, x_start, t, noise) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) = sqrt(a_t) x_0 + sqrt(1 - a_t) noise."""
    nd = x_start.dim()
    a = extract(sched.sqrt_alphas_cumprod, t, nd)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, nd)
    return a * x_start + s * noise


def add_noise(sched: DiffusionSchedule, x0, noise, t) -> torch.Tensor:
    """The DDPM `add_noise` (no VC2 scale): `q_sample` with its arguments in
    the scheduler's order."""
    return q_sample(sched, x0, t, noise)
