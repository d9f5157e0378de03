"""Latent-consistency-model math (port of t2v_turbo_tpu/diffusion/lcm.py):
the sinusoidal timestep and guidance-scale embeddings, the boundary-condition
scalings, the x0 and noise predictions under the eps / sample / v
parameterisations, and the pseudo-Huber distillation loss. Computed in
float32 as the JAX package does.
"""

from __future__ import annotations

import math

import torch

from .schedule import DiffusionSchedule, extract


def guidance_scale_embedding(w: torch.Tensor, embedding_dim: int) -> torch.Tensor:
    """Fourier embedding of guidance scales w (B,) -> (B, embedding_dim):
    w * 1000, [sin | cos] halves, zero pad when odd."""
    if w.dim() != 1:
        raise ValueError(f"w must be (B,), got {tuple(w.shape)}")
    w = w.float() * 1000.0
    freqs = guidance_frequencies(embedding_dim // 2, w.device)
    emb = w[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def guidance_frequencies(half: int, device=None) -> torch.Tensor:
    """The guidance embedding's f32 frequencies exp(-log(10000) i / (half - 1)), i < half."""
    return torch.exp(torch.arange(half, dtype=torch.float32, device=device) * (-math.log(10000.0) / (half - 1)))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding (B,) -> (B, dim), [cos | sin] order,
    max period 10000."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


def scalings_for_boundary_conditions(timestep, sigma_data: float = 0.5, timestep_scaling: float = 10.0):
    """Consistency-model boundary scalings (c_skip, c_out)."""
    st = timestep_scaling * torch.as_tensor(timestep).float()
    c_skip = sigma_data**2 / (st**2 + sigma_data**2)
    c_out = st / torch.sqrt(st**2 + sigma_data**2)
    return c_skip, c_out


def predicted_origin(
    model_output: torch.Tensor, t: torch.Tensor, sample: torch.Tensor, sched: DiffusionSchedule,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """x0 from a model output; for an epsilon model
    (sample - sqrt(1-a) eps) / sqrt(a)."""
    nd = sample.dim()
    a = extract(sched.sqrt_alphas_cumprod, t, nd)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, nd)
    if prediction_type == "epsilon":
        return (sample - s * model_output) / a
    if prediction_type == "sample":
        return model_output
    if prediction_type == "v_prediction":
        return a * sample - s * model_output
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def predicted_noise(
    model_output: torch.Tensor, t: torch.Tensor, sample: torch.Tensor, sched: DiffusionSchedule,
    prediction_type: str = "epsilon",
) -> torch.Tensor:
    """The noise (epsilon) from a model output."""
    nd = sample.dim()
    a = extract(sched.sqrt_alphas_cumprod, t, nd)
    s = extract(sched.sqrt_one_minus_alphas_cumprod, t, nd)
    if prediction_type == "epsilon":
        return model_output
    if prediction_type == "sample":
        return (sample - a * model_output) / s
    if prediction_type == "v_prediction":
        return a * model_output + s * sample
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def huber_loss(pred: torch.Tensor, target: torch.Tensor, c: float = 0.001) -> torch.Tensor:
    """Pseudo-Huber loss mean(sqrt((pred - target)^2 + c^2) - c)."""
    return torch.mean(torch.sqrt((pred - target) ** 2 + c**2) - c)
