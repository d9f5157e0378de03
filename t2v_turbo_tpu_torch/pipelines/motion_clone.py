"""MotionClone motion transfer (port of t2v_turbo_tpu/pipelines/motion_clone.py;
the reference's motion_prior_sample.py:87-300).

DDIM-invert a reference video's latents over the whole grid, then sample
guided DDIM from the last grid index down to 0. Inside the top band of the
grid (index i >= (1 - percentage) * n, JAX's float comparison) the noise
estimate is corrected by the gradient of the temporal-attention rank loss
between the sample's capture and the reference's capture at the inverted
latents of the same index (training/motion.py), and optionally by a reward
gradient:

    eps <- eps_cfg - sqrt(1 - sqrt(abar_t)) * (score_motion + reward_scale * score_reward)

(the reference's alpha_schedule is sqrt(abar), :283-292). Both eps and x0
take classifier-free guidance before the DDIM step. Outside the band a step
is two plain UNet calls without gradient.

The loop is a host loop, as in JAX. `unet(z, ts, ctx, fps=)` is the UNet
module (it must also take `record_probs=True`, as the port's UNetModel
does); its weights need no gradient: the score is a gradient with respect
to the latents alone, so each kernel's autograd function computes the
input's gradient and no weight's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..diffusion import DDIMSolver, DiffusionSchedule, extract, predicted_origin
from ..training.motion import motion_prior_score, reverse_ddim_loop


@dataclasses.dataclass(frozen=True)
class MotionCloneConfig:
    num_ddim_timesteps: int = 50
    guidance_scale: float = 7.5
    percentage: float = 0.3  # the top band of the grid where motion guidance applies
    temp_loss_scale: float = 100.0
    rank_k: int = 1
    reward_scale: float = 0.0  # > 0 adds the reward gradient (with a reward_grad_fn)


def guided_indices(cfg: MotionCloneConfig):
    """The grid indices that take the guided step, high to low."""
    band_lo = (1.0 - cfg.percentage) * cfg.num_ddim_timesteps
    return [i for i in reversed(range(cfg.num_ddim_timesteps)) if i >= band_lo]


def motion_transfer_sample(
    unet,
    ref_latents: torch.Tensor,  # (B, T, h, w, C) clean latents of the reference video
    original_ctx: torch.Tensor,  # the reference video's prompt embedding
    inference_ctx: torch.Tensor,  # the generation prompt's
    uncond_ctx: torch.Tensor,
    sched: DiffusionSchedule,
    solver: DDIMSolver,
    cfg: MotionCloneConfig,
    fps=None,
    reward_grad_fn: Optional[Callable] = None,  # (latents, ts) -> d(reward)/d latents
    return_trace: bool = False,
):
    """The final denoised latents (B, T, h, w, C), f32. With
    return_trace=True, (latents, {"motion_loss": (n_guided,) tensor}): the
    unscaled rank loss of each guided step at its pre-update latents."""
    n = cfg.num_ddim_timesteps
    if solver.ddim_timesteps.numel() != n:
        raise ValueError(f"the solver's grid has {solver.ddim_timesteps.numel()} points, the config {n}")
    b, nd, device = ref_latents.shape[0], ref_latents.dim(), ref_latents.device
    sched, solver = sched.to(device), solver.to(device)
    inter = reverse_ddim_loop(unet, ref_latents.float(), original_ctx, solver, num_steps=n, fps=fps)
    latents = inter[-1]
    guided = set(guided_indices(cfg))
    w = cfg.guidance_scale

    def update(z, ts, index, cond_eps, uncond_eps, score=None):
        eps = cond_eps + w * (cond_eps - uncond_eps)
        cond_x0 = predicted_origin(cond_eps, ts, z, sched)
        uncond_x0 = predicted_origin(uncond_eps, ts, z, sched)
        x0 = cond_x0 + w * (cond_x0 - uncond_x0)
        if score is not None:
            eps = eps - torch.sqrt(1.0 - extract(sched.sqrt_alphas_cumprod, ts, nd)) * score
        return solver.ddim_step(x0, eps, index)

    losses = []
    for i in reversed(range(n)):
        index = torch.full((b,), i, dtype=torch.long, device=device)
        ts = solver.index_to_timestep(index)
        if i in guided:
            score, cond_eps, raw = motion_prior_score(
                unet, latents, ts, inter[i], original_ctx, inference_ctx, fps=fps,
                temp_loss_scale=cfg.temp_loss_scale, rank_k=cfg.rank_k, return_loss=True)
            with torch.no_grad():
                uncond_eps = unet(latents, ts, uncond_ctx, fps=fps).float()
            if reward_grad_fn is not None and cfg.reward_scale > 0:
                score = score + cfg.reward_scale * reward_grad_fn(latents, ts)
            with torch.no_grad():
                latents = update(latents, ts, index, cond_eps.float(), uncond_eps, score.float())
            losses.append(raw)
        else:
            with torch.no_grad():
                cond_eps = unet(latents, ts, inference_ctx, fps=fps).float()
                uncond_eps = unet(latents, ts, uncond_ctx, fps=fps).float()
                latents = update(latents, ts, index, cond_eps, uncond_eps)
    # after the last grid step the latents sit at alpha_cumprods[0]: the
    # clean sample (the reference decodes them directly, :299)
    if return_trace:
        return latents, {"motion_loss": torch.stack(losses) if losses else torch.zeros(0, device=device)}
    return latents
