"""Ancestral DDPM sampling (port of t2v_turbo_tpu/diffusion/ancestral.py).

The reference's base-model sampling path (lvdm/models/ddpm3d.py:267-283
predict_start_from_noise / q_posterior, :680-765 p_mean_variance / p_sample,
:765-833 p_sample_loop) as functions over a `DiffusionSchedule`. The tables
of q(x_{t-1} | x_t, x_0) are derived from the schedule's f32 betas and
cumulative alphas in f32, as the JAX package derives them.

`p_sample_loop` is a plain Python loop over t = T-1 .. 0 (JAX runs one
`lax.scan`). Its noise comes from an explicit `torch.Generator`, or from
the caller: `noise_fn(i, t)` returns the draw of step i (and, with the
inpainting blend, `q_noise_fn`), so a test can feed it JAX's draws;
`torch.Generator` and `jax.random` draw different numbers.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .schedule import DiffusionSchedule, extract, q_sample


class PosteriorTables(NamedTuple):
    """q(x_{t-1} | x_t, x_0) coefficient tables, each (T,) f32 (the reference
    ddpm3d.py:174-194; `v_posterior` interpolates the variance toward beta_t,
    0 in every shipped config)."""

    mean_coef1: torch.Tensor  # on x_0
    mean_coef2: torch.Tensor  # on x_t
    variance: torch.Tensor
    log_variance_clipped: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor


def posterior_tables(sched: DiffusionSchedule, v_posterior: float = 0.0) -> PosteriorTables:
    betas, abar = sched.betas, sched.alphas_cumprod
    abar_prev = torch.cat([torch.ones(1, dtype=abar.dtype, device=abar.device), abar[:-1]])
    var = (1.0 - v_posterior) * betas * (1.0 - abar_prev) / (1.0 - abar) + v_posterior * betas
    return PosteriorTables(
        mean_coef1=betas * torch.sqrt(abar_prev) / (1.0 - abar),
        mean_coef2=(1.0 - abar_prev) * torch.sqrt(1.0 - betas) / (1.0 - abar),
        variance=var,
        log_variance_clipped=torch.log(torch.clamp_min(var, 1e-20)),
        sqrt_recip_alphas_cumprod=torch.sqrt(1.0 / abar),
        sqrt_recipm1_alphas_cumprod=torch.sqrt(1.0 / abar - 1.0),
    )


def predict_start_from_noise(tabs: PosteriorTables, x_t, t, noise):
    """x_0 estimate from an eps prediction (ddpm3d.py:267-272)."""
    nd = x_t.dim()
    return (extract(tabs.sqrt_recip_alphas_cumprod, t, nd) * x_t
            - extract(tabs.sqrt_recipm1_alphas_cumprod, t, nd) * noise)


def q_posterior(tabs: PosteriorTables, x_start, x_t, t):
    """(mean, variance, clipped log variance) of q(x_{t-1} | x_t, x_0)."""
    nd = x_t.dim()
    mean = extract(tabs.mean_coef1, t, nd) * x_start + extract(tabs.mean_coef2, t, nd) * x_t
    return mean, extract(tabs.variance, t, nd), extract(tabs.log_variance_clipped, t, nd)


def p_mean_variance(tabs: PosteriorTables, model_out, x, t, parameterization: str = "eps",
                    clip_denoised: bool = False):
    """(mean, variance, log variance, x_0 estimate) given a model output
    (ddpm3d.py:680-717)."""
    if parameterization == "eps":
        x_recon = predict_start_from_noise(tabs, x, t, model_out)
    elif parameterization == "x0":
        x_recon = model_out
    else:
        raise NotImplementedError(parameterization)
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    mean, var, logvar = q_posterior(tabs, x_recon, x, t)
    return mean, var, logvar, x_recon


def p_sample(tabs: PosteriorTables, model_out, x, t, parameterization: str = "eps",
             clip_denoised: bool = False, temperature: float = 1.0, noise=None,
             generator: Optional[torch.Generator] = None):
    """One ancestral step x_t -> x_{t-1} (ddpm3d.py:719-765): the posterior
    mean plus exp(0.5 logvar) * temperature * noise, the noise zeroed where
    t == 0. `noise` as given, else drawn from `generator` (or the global
    generator) on x's device. Returns (x_{t-1}, x_0 estimate)."""
    mean, _, logvar, x_recon = p_mean_variance(tabs, model_out, x, t, parameterization, clip_denoised)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    noise = noise.to(x.device, x.dtype) * temperature
    nonzero = (t.to(x.device) > 0).to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    return mean + nonzero * torch.exp(0.5 * logvar) * noise, x_recon


def p_sample_loop(
    model_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    sched: DiffusionSchedule,
    x_T: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    timesteps: Optional[int] = None,
    parameterization: str = "eps",
    clip_denoised: bool = False,
    temperature: float = 1.0,
    v_posterior: float = 0.0,
    mask: Optional[torch.Tensor] = None,
    x0: Optional[torch.Tensor] = None,
    noise_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
    q_noise_fn: Optional[Callable[[int, int], torch.Tensor]] = None,
) -> torch.Tensor:
    """The reverse chain t = timesteps-1 .. 0 (ddpm3d.py:765-833, without the
    callbacks and intermediates). `model_fn(x, t_batch) -> model_out` has the
    conditioning closed over. `mask` / `x0` (given together) are the
    reference's inpainting blend (ddpm3d.py:814-821): after each step the
    mask == 1 region is replaced by x0 noised to the step's t. Step i's
    draws come from `noise_fn(i, t)` / `q_noise_fn(i, t)` when given, else
    from `generator` (step noise, then the blend's, as JAX splits its key)."""
    if (mask is None) != (x0 is None):
        raise ValueError("mask and x0 must be given together")
    n = timesteps if timesteps is not None else sched.num_timesteps
    sched = sched.to(x_T.device)
    tabs = posterior_tables(sched, v_posterior)
    b, x = x_T.shape[0], x_T

    def draw(fn, i, t):
        if fn is not None:
            return fn(i, t)
        return torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)

    for i, t in enumerate(range(n - 1, -1, -1)):
        tb = torch.full((b,), t, dtype=torch.long, device=x.device)
        x, _ = p_sample(tabs, model_fn(x, tb), x, tb, parameterization, clip_denoised, temperature,
                        noise=draw(noise_fn, i, t))
        if mask is not None:
            x_orig = q_sample(sched, x0, tb, draw(q_noise_fn, i, t).to(x.device, x.dtype))
            x = x_orig * mask + (1.0 - mask) * x
    return x
