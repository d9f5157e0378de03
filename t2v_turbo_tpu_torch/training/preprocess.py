"""The offline v2 data producer (port of t2v_turbo_tpu/training/preprocess.py):
clean latents -> one pickled dict of {z_t, teacher outputs, motion-prior
score} per sample, which `data.datasets.MP4LatentDataset` (either
package's) reads back.

Per sample (reference preprocess_with_motion_prior.py:192-408 and
preprocess_no_motion_*.py): draw a DDIM grid index in the top
`max_percentage` band and noise the clean latents to its timestep (z_t);
with the motion prior, invert the clean latents through the index + 1
first grid points with the teacher (z_example, at z_t's noise level), then
take the MotionClone score and the conditional output at z_t (two teacher
calls: the reference capture at z_example, the capture with gradient at
z_t); without it the score is zero and the conditional output one call;
then the unconditional output. So the teacher runs index + 4 times with
the motion prior and twice without. The JAX package runs the inversion as
a fixed-length scan that skips the teacher past the index; this eager loop
stops there.

The draws (index, noise) come from `sample_preprocess_draws`, a function
of a `torch.Generator`; `preprocess_sample` takes them explicitly, so a test
can feed it the JAX package's draws.

Under a (data, seq) mesh (`mesh=`, parallel/mesh.py; JAX's dryrun runs the
preprocess with the latents at P(None, "seq"), __graft_entry__.py:509-566)
every rank is given the global latents and draws and keeps its T / seq
frames; the teacher runs sequence-parallel over the seq axis (the
inversion, the capture and the score of training/motion.py); the data
ranks repeat the sample, as JAX's replicated batch axis does. The
frame-shaped outputs are gathered on rank 0, which returns the sample; the
other ranks return None.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from ..diffusion import DDIMSolver, DiffusionSchedule, add_noise
from ..parallel import collectives
from ..parallel.mesh import shard
from ..parallel.tp import refuse_model_axis
from .motion import motion_prior_score, reverse_ddim_loop


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    num_ddim_timesteps: int = 50
    max_percentage: float = 0.3  # the index is drawn in the top band of the grid
    with_motion_prior: bool = True
    temp_loss_scale: float = 1.0
    rank_k: int = 1


@dataclasses.dataclass
class PreprocessDraws:
    index: int  # DDIM grid index
    noise: torch.Tensor  # latents-shaped f32


def sample_preprocess_draws(cfg: PreprocessConfig, latents_shape, generator: torch.Generator) -> PreprocessDraws:
    """A sample's draws from `generator` on the CPU: the index uniform in
    [int((1 - max_percentage) * N), N), then N(0, 1) noise."""
    lo = int((1.0 - cfg.max_percentage) * cfg.num_ddim_timesteps)
    index = int(torch.randint(lo, cfg.num_ddim_timesteps, (1,), generator=generator))
    return PreprocessDraws(index, torch.randn(tuple(latents_shape), generator=generator))


@torch.no_grad()
def preprocess_sample(teacher, latents: torch.Tensor, prompt_emb: torch.Tensor, uncond_emb: torch.Tensor,
                      draws: PreprocessDraws, *, sched: DiffusionSchedule, solver: DDIMSolver,
                      cfg: PreprocessConfig, fps=None, txt: str = "", short_txt: str = "",
                      mesh=None) -> Optional[dict]:
    """One sample (latents (1, T, h, w, C) clean and scaled, contexts (1, L, D)
    on the teacher's device) -> the v2 training dict with the keys, numpy
    dtypes and shapes of the JAX package's (t2v_turbo_tpu/training/
    preprocess.py `run`): index (np.int32), z_t, cond_teacher_out,
    uncond_teacher_out, score (T, h, w, C) f32, prompt_emb (L, D) f32,
    use_motion_guide, txt, short_txt, and with the motion prior z_example.
    With a `mesh` (every rank calls it with the global latents and draws;
    the teacher needs `set_seq_group`): the dict on rank 0, None on the
    others (the module docstring)."""
    refuse_model_axis(mesh, "preprocess_sample")
    group = None
    if mesh is not None:
        if latents.shape[1] % mesh.seq:
            raise ValueError(f"sharded preprocess needs frames {latents.shape[1]} divisible by the seq axis "
                             f"({mesh.seq})")
        if not hasattr(teacher, "set_seq_group"):
            raise NotImplementedError(f"{type(teacher).__name__} has no sequence-parallel path")
        group = mesh.axis("seq")
        teacher.set_seq_group(group)
        latents = shard(mesh, latents, (None, "seq"))
        draws = PreprocessDraws(draws.index, shard(mesh, draws.noise, (None, "seq")))
    device = latents.device
    sched, solver = sched.to(device), solver.to(device)
    b = latents.shape[0]
    index = torch.full((b,), draws.index, dtype=torch.long, device=device)
    ts = solver.index_to_timestep(index)
    latents32 = latents.float()
    z_t = add_noise(sched, latents32, draws.noise.to(device).float(), ts)

    def teacher_out(z, ctx):
        return teacher(z, ts, ctx, fps=fps).float()

    z_example = None
    if cfg.with_motion_prior:
        # index + 1 inversion steps (reference :348-355)
        z_example = reverse_ddim_loop(teacher, latents32, prompt_emb, solver, draws.index + 1, fps=fps,
                                      return_intermediates=False)
        score, cond_out = motion_prior_score(teacher, z_t, ts, z_example, prompt_emb, prompt_emb, fps=fps,
                                             temp_loss_scale=cfg.temp_loss_scale, rank_k=cfg.rank_k, group=group)
    else:
        score, cond_out = torch.zeros_like(z_t), teacher_out(z_t, prompt_emb)
    uncond_out = teacher_out(z_t, uncond_emb)

    def host(t):  # sample 0's (T, h, w, C), its frames gathered from the seq ranks in rank order
        t = t[0].float()
        if group is not None:
            t = collectives.gather_to_root(t, [t.shape[0]] * group.size, group)
        return None if t is None else t.cpu().numpy()

    frames = {"z_t": z_t, "cond_teacher_out": cond_out, "uncond_teacher_out": uncond_out, "score": score}
    if z_example is not None:
        frames["z_example"] = z_example
    frames = {k: host(v) for k, v in frames.items()}  # every rank takes part in the gathers
    if mesh is not None and mesh.rank != 0:
        return None
    return {
        "index": np.int32(draws.index),
        **frames,
        "prompt_emb": prompt_emb[0].float().cpu().numpy(),
        "use_motion_guide": bool(cfg.with_motion_prior),
        # the captions ride along for the v2 reward losses ("" = no short caption)
        "txt": txt,
        "short_txt": short_txt,
    }


def save_sample(out_dir: str, name: str, sample: dict) -> str:
    """Pickle `sample` to out_dir/name.pkl (written whole, then renamed); returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(sample, f)
    os.replace(path + ".tmp", path)
    return path
