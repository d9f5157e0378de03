"""The diffusion noise schedule (port of t2v_turbo_tpu/diffusion/schedule.py):
the tables, `extract`, and the forward diffusion `q_sample` / `add_noise`
that training draws its noisy latents with (the VC2 latent-scale variant of
`q_sample` has no caller in the port).

The tables are computed in float64 numpy exactly as the JAX package does for
the `scaled_linear` schedule of every T2V-Turbo config, optionally rescaled
to a zero terminal SNR (`rescale_betas_zero_snr`), then held as float32
tensors; `to(device)` moves them next to the latents.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The betas and the cumulative-alpha tables, each a (T,) float32 tensor."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(
        cls, num_timesteps: int = 1000, linear_start: float = 0.00085, linear_end: float = 0.012,
        rescale_betas_zero_snr: bool = False,
    ) -> "DiffusionSchedule":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps, dtype=np.float64) ** 2
        if rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        alphas_cumprod = np.cumprod(1.0 - betas)

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32))

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
            num_timesteps=num_timesteps,
        )

    def to(self, device) -> "DiffusionSchedule":
        return dataclasses.replace(
            self,
            betas=self.betas.to(device),
            alphas_cumprod=self.alphas_cumprod.to(device),
            sqrt_alphas_cumprod=self.sqrt_alphas_cumprod.to(device),
            sqrt_one_minus_alphas_cumprod=self.sqrt_one_minus_alphas_cumprod.to(device),
        )


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Betas rescaled so that the last timestep has zero SNR (arXiv
    2305.08891, Algorithm 1; the reference scheduler/t2v_turbo_scheduler.py:96-126):
    sqrt(alpha_bar) shifted to end at 0 and scaled to keep its first value."""
    alphas_bar = np.cumprod(1.0 - np.asarray(betas, dtype=np.float64))
    ab_sqrt = np.sqrt(alphas_bar)
    ab0, abT = ab_sqrt[0], ab_sqrt[-1]
    alphas_bar = ((ab_sqrt - abT) * (ab0 / (ab0 - abT))) ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


def make_vc2_scale_arr(num_timesteps: int, scale_a: float = 1.0, scale_b: float = 0.7,
                       mid_step: int = 400) -> np.ndarray:
    """VideoCrafter2's per-timestep latent scale: the first `mid_step`
    entries ramp from scale_a to scale_b, the rest are scale_b. The
    reference builds the tail `num_timesteps` long and cuts the whole to
    `num_timesteps` (its off-by-mid_step quirk, lvdm/models/ddpm3d.py:448-456);
    the values are the same."""
    arr = np.concatenate([np.linspace(scale_a, scale_b, mid_step), np.full(num_timesteps, scale_b)])
    return arr[:num_timesteps].astype(np.float64)


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
