"""CLI: the DDIM inversion round trip with the PyTorch port (the reference's
inverse_ddim.py:21-96; port of t2v_turbo_tpu/apps/inverse_ddim.py).

Encodes a video, inverts it over the first --invert-steps indices of a
--num-ddim-timesteps grid (training/motion.py::reverse_ddim_loop), runs
deterministic DDIM back down the same indices, and prints the
reconstruction's error against the clean latents, `rmse` and `relative`
(rmse over the latents' own root mean square): the solver-consistency
probe.

Usage:
  python -m t2v_turbo_tpu_torch.apps.inverse_ddim --checkpoint VideoCrafter2_model.ckpt \\
      --video clip.mp4 --prompt "a dog running" [--output recon.mp4]
  python -m t2v_turbo_tpu_torch.apps.inverse_ddim --random-weights [--tiny-model --device cpu]
With --random-weights alone the context and the latents are drawn from
numpy seeded with --seed, as the JAX CLI's; with --video too, seeded
models encode the clip. `build_job(args, frames=)` takes decoded frames in
place of the file. The models run in bf16 on --device (default cuda:0).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DDIM inversion round trip (PyTorch port)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt")
    p.add_argument("--random-weights", action="store_true", help="seeded random weights (smoke mode)")
    p.add_argument("--tiny-model", action="store_true", help="small UNet (tests / smoke)")
    p.add_argument("--video", default=None)
    p.add_argument("--prompt", default="")
    p.add_argument("--n-frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-ddim-timesteps", type=int, default=50)
    p.add_argument("--invert-steps", type=int, default=25)
    p.add_argument("--output", default=None, help="write the decoded reconstruction (with a VAE)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


@dataclasses.dataclass
class InversionJob:
    models: object  # motion_sample.Models
    z0: torch.Tensor  # (1, T, h, w, 4) f32 clean latents
    ctx: torch.Tensor
    sched: object
    solver: object
    steps: int


def build_job(args, frames: Optional[np.ndarray] = None) -> InversionJob:
    """The models (motion_sample.build_models), the clean latents and the
    context: from video (--checkpoint, --video or `frames`) the VAE's and
    the text tower's; else numpy draws seeded with --seed (the context
    first, then 0.2 N(0, 1) latents, as the JAX CLI)."""
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from . import motion_sample as ms

    if not 0 < args.invert_steps <= args.num_ddim_timesteps:
        raise SystemExit(f"error: --invert-steps must lie in [1, {args.num_ddim_timesteps}]")
    with_video = frames is not None or bool(args.video) or bool(args.checkpoint)
    if args.checkpoint and frames is None and not args.video:
        raise SystemExit("error: --video is required with --checkpoint")
    ms_args = argparse.Namespace(**vars(args), reference_video=args.video)
    models = ms.build_models(ms_args, with_video)
    device = next(models.unet.parameters()).device
    _, ctx_shape, lat_shape = ms.shapes(args)
    if with_video:
        z0 = ms.encode_frames(models, ms.reference_frames(ms_args) if frames is None else frames, args)
        with torch.no_grad():
            ctx = models.embed([args.prompt]).float()
    else:
        rng = np.random.RandomState(args.seed)
        ctx = torch.from_numpy(rng.randn(*ctx_shape).astype(np.float32)).to(device)
        z0 = torch.from_numpy(rng.randn(*lat_shape).astype(np.float32)).to(device) * 0.2
    sched = DiffusionSchedule.create()
    solver = DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=args.num_ddim_timesteps)
    return InversionJob(models, z0, ctx, sched.to(device), solver.to(device), args.invert_steps)


@torch.no_grad()
def round_trip(job: InversionJob):
    """(the reconstruction, {"rmse", "relative"}): invert `steps` grid
    indices, then deterministic DDIM from index steps - 1 down to 0."""
    from ..diffusion import predicted_origin
    from ..training.motion import reverse_ddim_loop

    unet, n, b = job.models.unet, job.steps, job.z0.shape[0]
    lat = reverse_ddim_loop(unet, job.z0, job.ctx, job.solver, num_steps=n, return_intermediates=False)
    for idx in reversed(range(n)):
        index = torch.full((b,), idx, dtype=torch.long, device=lat.device)
        ts = job.solver.index_to_timestep(index)
        eps = unet(lat, ts, job.ctx).float()
        lat = job.solver.ddim_step(predicted_origin(eps, ts, lat, job.sched), eps, index)
    rmse = float(torch.sqrt(torch.mean((lat - job.z0) ** 2)))
    return lat, {"rmse": rmse, "relative": rmse / float(torch.sqrt(torch.mean(job.z0**2)))}


def main(argv=None):
    args = parse_args(argv)
    job = build_job(args)
    z_rec, err = round_trip(job)
    print(f"inversion round-trip: rmse={err['rmse']:.5f} relative={err['relative']:.4f}")
    if args.output and job.models.vae is not None:
        from ..io.video import save_video
        from ..pipelines.vc2 import video_to_uint8
        from .motion_sample import decode_latents

        print(save_video(video_to_uint8(decode_latents(job.models, z_rec))[0], args.output))
    elif args.output:
        print("error: --output needs a video to decode (--checkpoint or --video)", file=sys.stderr)
    return err["relative"]


if __name__ == "__main__":
    main()
