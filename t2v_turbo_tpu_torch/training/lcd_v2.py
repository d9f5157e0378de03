"""T2V-Turbo-v2's loss: full-model latent consistency training on
precomputed teacher outputs, with motion-prior guidance and an optional
EMA target network (port of t2v_turbo_tpu/training/lcd_v2.py; reference
train_latent_t2v_turbo_v2.py:978-1270).

The teacher never runs at train time: a batch carries {index, z_t,
cond_teacher_out, uncond_teacher_out, score, prompt_emb, use_motion_guide}
from the offline preprocess (training/preprocess.py). The CFG estimate is
formed from the stored outputs; inside the top `percentage` band of the
grid, where the sample has a motion prior, the score times motion_gs and
the reference's factor is subtracted from the CFG noise; one DDIM step
gives x_prev; the target comes from the EMA network (or the online
student) without gradient. The teacher and target branches run under
`torch.no_grad()`.

Kept quirk: the guidance factor is sqrt(1 - sqrt(alpha_bar_t)), not
sqrt(1 - alpha_bar_t): the reference gathers from alpha_schedule =
sqrt(alphas_cumprod) and then applies (1 - .) ** 0.5
(train_latent_t2v_turbo_v2.py:705, 1213-1226).

The guidance scales w come from `sample_v2_draws`, a function of a
`torch.Generator`; `lcd_v2_loss` takes them explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..diffusion import (
    DDIMSolver,
    DiffusionSchedule,
    bcast_right,
    extract,
    guidance_scale_embedding,
    huber_loss,
    predicted_noise,
    predicted_origin,
    scalings_for_boundary_conditions,
)
from .lcd import with_reward_terms


@dataclasses.dataclass(frozen=True)
class LCDV2Config:
    num_ddim_timesteps: int = 50
    w_min: float = 5.0
    w_max: float = 15.0
    w_embedding_dim: int = 256
    timestep_scaling: float = 10.0
    prediction_type: str = "epsilon"
    loss_type: str = "huber"  # 'huber' | 'l2'
    huber_c: float = 0.001
    motion_gs: float = 0.05
    percentage: float = 0.3  # the top band of the grid that gets motion guidance
    use_motion_cond: bool = False  # feed the motion_gs embedding to the UNet
    reward_scale: float = 1.0
    video_reward_scale: float = 1.0


@dataclasses.dataclass
class LCDV2Draws:
    w: torch.Tensor  # (B,) f32 guidance scales

    def to(self, device) -> "LCDV2Draws":
        return LCDV2Draws(self.w.to(device))


def sample_v2_draws(cfg: LCDV2Config, batch_size: int, generator: torch.Generator) -> LCDV2Draws:
    """The step's draws from `generator` on the CPU: w uniform in [w_min, w_max)."""
    return LCDV2Draws(cfg.w_min + (cfg.w_max - cfg.w_min) * torch.rand((batch_size,), generator=generator))


def motion_gate(batch: Dict[str, torch.Tensor], cfg: LCDV2Config) -> torch.Tensor:
    """(B,) bool: the sample has a motion prior and its index lies in the
    top `percentage` of the grid."""
    index = batch["index"]
    use_mg = batch.get("use_motion_guide")
    in_band = index >= (1.0 - cfg.percentage) * cfg.num_ddim_timesteps
    return in_band if use_mg is None else in_band & use_mg.bool()


def lcd_v2_loss(
    student: Callable,
    batch: Dict[str, torch.Tensor],
    draws: LCDV2Draws,
    *,
    target: Optional[Callable] = None,
    sched: DiffusionSchedule,
    solver: DDIMSolver,
    cfg: LCDV2Config,
    reward_fn: Optional[Callable] = None,
    video_reward_fn: Optional[Callable] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, terms) for one batch, the terms not detached (lcd.py's
    `lcd_loss` convention). batch: index (B,) int, z_t, cond_teacher_out,
    uncond_teacher_out, score (B, T, h, w, C), prompt_emb (B, L, D),
    use_motion_guide (B,) bool, optionally fps and the reward fields.
    student(x, t, ctx, fps=, timestep_cond=, motion_cond=) and `target`
    (the EMA network; None: the student) are epsilon models. Under a `mesh`
    (data axis only): this rank's share of each term (lcd.py's
    `with_reward_terms`)."""
    z_t = batch["z_t"].float()
    index = batch["index"].long()
    ctx, fps = batch["prompt_emb"], batch.get("fps")
    nd = z_t.dim()
    draws = draws.to(z_t.device)

    start_timesteps = solver.index_to_timestep(index)
    timesteps = (start_timesteps - solver.step_ratio).clamp_min(0)
    c_skip_s, c_out_s = (bcast_right(c, nd) for c in scalings_for_boundary_conditions(
        start_timesteps, timestep_scaling=cfg.timestep_scaling))
    c_skip, c_out = (bcast_right(c, nd) for c in scalings_for_boundary_conditions(
        timesteps, timestep_scaling=cfg.timestep_scaling))
    w_emb = guidance_scale_embedding(draws.w, cfg.w_embedding_dim)
    w_b = bcast_right(draws.w.float(), nd)

    gate = motion_gate(batch, cfg)
    motion_gs = torch.where(gate, torch.full_like(draws.w, cfg.motion_gs), torch.zeros_like(draws.w))
    motion_cond = guidance_scale_embedding(motion_gs, cfg.w_embedding_dim) if cfg.use_motion_cond else None
    kw = dict(fps=fps, timestep_cond=w_emb, motion_cond=motion_cond)

    # the online student's prediction at t_{n+k}
    noise_pred = student(z_t, start_timesteps, ctx, **kw).float()
    pred_x0 = predicted_origin(noise_pred, start_timesteps, z_t, sched, cfg.prediction_type)
    model_pred = c_skip_s * z_t + c_out_s * pred_x0

    with torch.no_grad():
        # the stored teacher's CFG estimate, the motion prior, one DDIM step
        def origin_and_noise(out):
            out = out.float()
            return (predicted_origin(out, start_timesteps, z_t, sched, cfg.prediction_type),
                    predicted_noise(out, start_timesteps, z_t, sched, cfg.prediction_type))

        cx0, ceps = origin_and_noise(batch["cond_teacher_out"])
        ux0, ueps = origin_and_noise(batch["uncond_teacher_out"])
        px0 = cx0 + w_b * (cx0 - ux0)
        peps = ceps + w_b * (ceps - ueps)
        sqrt_abar = extract(sched.sqrt_alphas_cumprod, start_timesteps, nd)
        factor = torch.where(bcast_right(gate, nd), torch.sqrt(1.0 - sqrt_abar), torch.zeros_like(sqrt_abar))
        peps = peps - bcast_right(motion_gs, nd) * factor * batch["score"].float()
        x_prev = solver.ddim_step(px0, peps, index)

        # the target at t_n, from the EMA network or the online student
        tgt = (target or student)(x_prev, timesteps, ctx, **kw).float()
        tx0 = predicted_origin(tgt, timesteps, x_prev, sched, cfg.prediction_type)
        target_pred = c_skip * x_prev + c_out * tx0

    if cfg.loss_type == "l2":
        distill = torch.mean((model_pred - target_pred) ** 2)
    else:
        distill = huber_loss(model_pred, target_pred, cfg.huber_c)
    return with_reward_terms(distill, model_pred, batch, cfg, reward_fn, video_reward_fn, mesh)


def trainer_loss(trainer, batch, draws):
    """`LCDTrainer`'s loss hook for v2: `lcd_v2_loss` of its student, with
    its EMA target network (None: the student), schedule, solver, config
    (`lcd_cfg`, an LCDV2Config) and reward fns. With a trained text
    encoder, the context is the batch's `tokens` encoded by it at every
    step (the reference :989-992; the target's context too)."""
    if trainer.text_encoder is not None:
        batch = dict(batch, prompt_emb=trainer.text_encoder(batch["tokens"]))
    return lcd_v2_loss(trainer.student, batch, draws, target=trainer.target, sched=trainer.sched,
                       solver=trainer.solver, cfg=trainer.lcd_cfg, reward_fn=trainer.reward_fn,
                       video_reward_fn=trainer.video_reward_fn, mesh=trainer.mesh)


def trainer_draws(trainer, batch):
    """`LCDTrainer`'s draws hook for v2: w from its generator, the global
    batch's, this rank's block kept."""
    draws = sample_v2_draws(trainer.lcd_cfg, trainer.global_shape(batch["z_t"].shape)[0], trainer.generator)
    if trainer.mesh is None:
        return draws
    from ..parallel.mesh import shard

    return LCDV2Draws(shard(trainer.mesh, draws.w, ("data",)))
