"""Latent consistency distillation (LCD): the v1 trainer's loss (port of
t2v_turbo_tpu/training/lcd.py).

Per batch: a DDIM grid index per example sets t_{n+k} (start) and t_n; the
clean latents are noised to t_{n+k}; the student, given a random guidance
scale w through its w-embedding, predicts x0 there and forms the
boundary-condition prediction; the frozen teacher's classifier-free-guided
estimate (cond and uncond as two forwards) takes one DDIM step to x_prev;
the student at t_n on x_prev gives the target; the loss is pseudo-Huber
(or l2) between the two. The teacher and target branches run under
`torch.no_grad()`, the JAX package's `stop_gradient` islands. With reward
feedback, each reward fn scores the boundary-condition prediction (with
its gradient) and adds -(r * mask).sum() / max(mask.sum(), 1) * scale; the
per-example masks (`reward_mask`, `video_reward_mask`, ones when absent)
select which examples carry each reward, as the JAX package's role masks.

The random draws (grid index, noise, w) come from `sample_draws`, a
function of a `torch.Generator`; `lcd_loss` takes them explicitly, so a
test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion import (
    DDIMSolver,
    DiffusionSchedule,
    add_noise,
    bcast_right,
    guidance_scale_embedding,
    huber_loss,
    predicted_noise,
    predicted_origin,
    scalings_for_boundary_conditions,
)


@dataclasses.dataclass(frozen=True)
class LCDConfig:
    num_ddim_timesteps: int = 50
    w_min: float = 5.0
    w_max: float = 15.0
    w_embedding_dim: int = 256
    timestep_scaling: float = 10.0
    prediction_type: str = "epsilon"
    loss_type: str = "huber"  # 'huber' | 'l2'
    huber_c: float = 0.001
    reward_scale: float = 1.0
    video_reward_scale: float = 1.0


@dataclasses.dataclass
class LCDDraws:
    index: torch.Tensor  # (B,) int64 DDIM grid indices
    noise: torch.Tensor  # latents-shaped f32
    w: torch.Tensor  # (B,) f32 guidance scales

    def to(self, device) -> "LCDDraws":
        return LCDDraws(self.index.to(device), self.noise.to(device), self.w.to(device))


def sample_draws(cfg: LCDConfig, latents_shape, generator: torch.Generator) -> LCDDraws:
    """The step's random draws, from `generator` on the CPU (so a card and
    a CPU run given the same generator state draw the same values)."""
    b = latents_shape[0]
    index = torch.randint(0, cfg.num_ddim_timesteps, (b,), generator=generator)
    noise = torch.randn(tuple(latents_shape), generator=generator)
    w = cfg.w_min + (cfg.w_max - cfg.w_min) * torch.rand((b,), generator=generator)
    return LCDDraws(index, noise, w)


def lcd_loss(
    student: Callable,
    teacher: Callable,
    batch: Dict[str, torch.Tensor],
    draws: LCDDraws,
    *,
    sched: DiffusionSchedule,
    solver: DDIMSolver,
    cfg: LCDConfig,
    reward_fn: Optional[Callable] = None,
    video_reward_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, terms) for one batch; `terms` holds distill_loss, loss and,
    with their fns, reward_loss and video_rm_loss, not detached (so a
    caller can differentiate one term alone).

    batch: latents (B, T, h, w, C) clean, scaled VAE latents; ctx and
    uncond_ctx (B, L, D) prompt and empty-prompt embeddings; fps (B,); and
    the fields the reward fns read. student(x, t, ctx, fps=, timestep_cond=)
    and teacher(x, t, ctx, fps=) are epsilon (or cfg.prediction_type)
    models on channels-last latents. reward_fn(model_pred, batch) and
    video_reward_fn give (B,) rewards.
    """
    latents = batch["latents"].float()
    ctx, uncond_ctx, fps = batch["ctx"], batch["uncond_ctx"], batch.get("fps")
    nd = latents.dim()
    draws = draws.to(latents.device)
    index = draws.index

    start_timesteps = solver.index_to_timestep(index)
    timesteps = (start_timesteps - solver.step_ratio).clamp_min(0)
    c_skip_s, c_out_s = (bcast_right(c, nd) for c in scalings_for_boundary_conditions(
        start_timesteps, timestep_scaling=cfg.timestep_scaling))
    c_skip, c_out = (bcast_right(c, nd) for c in scalings_for_boundary_conditions(
        timesteps, timestep_scaling=cfg.timestep_scaling))

    noisy = add_noise(sched, latents, draws.noise.float(), start_timesteps)
    w_emb = guidance_scale_embedding(draws.w, cfg.w_embedding_dim)
    w_b = bcast_right(draws.w.float(), nd)

    # online student prediction at t_{n+k}
    noise_pred = student(noisy, start_timesteps, ctx, fps=fps, timestep_cond=w_emb).float()
    pred_x0 = predicted_origin(noise_pred, start_timesteps, noisy, sched, cfg.prediction_type)
    model_pred = c_skip_s * noisy + c_out_s * pred_x0

    with torch.no_grad():
        # teacher CFG estimate and one DDIM step (two forwards, as JAX)
        def origin_and_noise(out):
            return (predicted_origin(out, start_timesteps, noisy, sched, cfg.prediction_type),
                    predicted_noise(out, start_timesteps, noisy, sched, cfg.prediction_type))

        cx0, ceps = origin_and_noise(teacher(noisy, start_timesteps, ctx, fps=fps).float())
        ux0, ueps = origin_and_noise(teacher(noisy, start_timesteps, uncond_ctx, fps=fps).float())
        x_prev = solver.ddim_step(cx0 + w_b * (cx0 - ux0), ceps + w_b * (ceps - ueps), index)

        # target LCM prediction at t_n
        tgt_pred = student(x_prev, timesteps, ctx, fps=fps, timestep_cond=w_emb).float()
        tx0 = predicted_origin(tgt_pred, timesteps, x_prev, sched, cfg.prediction_type)
        target = c_skip * x_prev + c_out * tx0

    if cfg.loss_type == "l2":
        distill = torch.mean((model_pred - target) ** 2)
    else:
        distill = huber_loss(model_pred, target, cfg.huber_c)
    terms = {"distill_loss": distill}
    total = distill
    b = latents.shape[0]
    for name, fn, mask_key, scale in (
        ("reward_loss", reward_fn, "reward_mask", cfg.reward_scale),
        ("video_rm_loss", video_reward_fn, "video_reward_mask", cfg.video_reward_scale),
    ):
        if fn is None:
            continue
        mask = batch.get(mask_key)
        mask = torch.ones(b, device=latents.device) if mask is None else mask.float()
        r = fn(model_pred, batch)
        terms[name] = -(r * mask).sum() / mask.sum().clamp_min(1.0) * scale
        total = total + terms[name]
    terms["loss"] = total
    return total, terms
