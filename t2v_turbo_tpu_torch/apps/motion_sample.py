"""CLI: MotionClone motion transfer with the PyTorch port (the reference's
motion_prior_sample.py; port of t2v_turbo_tpu/apps/motion_sample.py):
DDIM-invert a reference video, then generate a new prompt's video with the
reference's motion through temporal-attention guidance
(pipelines/motion_clone.py).

Usage:
  python -m t2v_turbo_tpu_torch.apps.motion_sample --checkpoint VideoCrafter2_model.ckpt \\
      --reference-video ref.mp4 --reference-prompt "a dog running" \\
      --prompt "a cat running on the beach" --output motion_out.mp4
Smoke mode (seeded random weights; the reference latents and contexts
drawn from numpy with --seed, as the JAX CLI's; writes <output>.latents.npy):
  python -m t2v_turbo_tpu_torch.apps.motion_sample --random-weights --prompt x [--tiny-model --device cpu]
With --random-weights and --reference-video the whole path runs on seeded
models: the clip is decoded (libav), resized and centre-cropped, encoded by
the VAE, the prompts embedded by the text tower, and the video decoded and
written. `build_job(args, frames=)` takes decoded frames in place of the
file, for a host without libav.

The models run in bf16 on --device (default cuda:0): every attention,
GroupNorm, LayerNorm and GN->SiLU->conv pair on the hand-written kernels
but the nine probability captures of a guided step (plain attention).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo motion transfer (PyTorch port)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt (UNet, VAE and text tower)")
    p.add_argument("--random-weights", action="store_true", help="seeded random weights (smoke mode)")
    p.add_argument("--tiny-model", action="store_true", help="small UNet (tests / smoke)")
    p.add_argument("--reference-video", default=None, help="mp4 with the motion")
    p.add_argument("--reference-prompt", default="")
    p.add_argument("--prompt", required=True)
    p.add_argument("--n-frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-ddim-timesteps", type=int, default=50)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--percentage", type=float, default=0.3)
    p.add_argument("--temp-loss-scale", type=float, default=100.0)
    p.add_argument("--output", default="motion_out.mp4")
    p.add_argument("--save-fps", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def tiny_unet_config():
    """The JAX CLIs' tiny teacher UNet (no w-embedding)."""
    from ..models import UNetConfig
    from .train_v1 import TINY_UNET_KW

    return UNetConfig(**{**TINY_UNET_KW, "time_cond_proj_dim": None})


def shapes(args):
    """(UNet config, context shape, latent shape) of the flags."""
    from ..models import UNetConfig

    if args.tiny_model:
        cfg = tiny_unet_config()
        return cfg, (1, 7, cfg.context_dim), (1, 4, 8, 8, 4)
    cfg = UNetConfig()
    return cfg, (1, 77, cfg.context_dim), (1, args.n_frames, args.height // 8, args.width // 8, 4)


@dataclasses.dataclass
class Models:
    """The frozen UNet and, when the run starts from video, the VAE and
    the prompt embedder; the checkpoint's, else seeded."""

    unet: torch.nn.Module
    vae: Optional[torch.nn.Module]
    embed: Optional[object]  # captions -> contexts
    scale_factor: float


def build_models(args, with_video: bool) -> Models:
    """The UNet from --checkpoint or seeded (--random-weights); with
    `with_video` also the VAE and the text tower."""
    from ..config import vc2_spec
    from ..io.convert import load_checkpoint, split_vc2_checkpoint
    from ..models import UNetModel, cast_compute_dtype_, seeded_init_
    from .train_v1 import build_text_tower, build_vae, text_embedder

    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    ucfg = shapes(args)[0]
    with torch.device(device):
        unet = UNetModel(ucfg)
    vae_sd = clip_sd = None
    if args.checkpoint:
        unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        unet.load_state_dict(unet_sd, strict=True)
    elif args.random_weights:
        seeded_init_(unet, args.seed + 1_000_000)
    else:
        print("error: provide --checkpoint or --random-weights", file=sys.stderr)
        sys.exit(2)
    cast_compute_dtype_(unet, dtype).requires_grad_(False).eval()
    vae = embed = None
    if with_video:
        vae = build_vae(args, device, dtype, vae_sd)
        embed = text_embedder(build_text_tower(args, device, dtype, clip_sd))
    return Models(unet, vae, embed, vc2_spec().scale_factor)


def reference_frames(args) -> np.ndarray:
    """--reference-video decoded (--n-frames at the native rate) as
    (T, H, W, 3) uint8."""
    from ..data import videoio

    return videoio.decode(args.reference_video, n_frames=args.n_frames)


@torch.no_grad()
def encode_frames(models: Models, frames: np.ndarray, args) -> torch.Tensor:
    """Decoded frames -> resized, centre-cropped to --height x --width,
    [-1, 1], VAE-encoded (the posterior's mean x the scale): (1, T, h, w, 4) f32."""
    from ..data.transforms import normalize_video, resize_crop
    from ..models.vae import encode_video

    video = normalize_video(resize_crop(np.asarray(frames), (args.height, args.width)))
    device = next(models.vae.parameters()).device
    z = encode_video(models.vae, torch.from_numpy(video)[None].to(device), scale_factor=models.scale_factor)
    return z.float()


@torch.no_grad()
def decode_latents(models: Models, latents: torch.Tensor) -> torch.Tensor:
    """(B, T, h, w, 4) latents -> (B, T, H, W, 3) video in [-1, 1]."""
    b, t = latents.shape[:2]
    frames = models.vae.decode(latents.reshape(b * t, *latents.shape[2:]) / models.scale_factor)
    return frames.reshape(b, t, *frames.shape[1:])


@dataclasses.dataclass
class MotionJob:
    models: Models
    ref_latents: torch.Tensor  # (1, T, h, w, 4) f32
    original_ctx: torch.Tensor
    inference_ctx: torch.Tensor
    uncond_ctx: torch.Tensor
    sched: object
    solver: object
    cfg: object


def build_job(args, frames: Optional[np.ndarray] = None) -> MotionJob:
    """The models, the reference latents and the contexts. From video
    (--checkpoint, --reference-video or `frames`, decoded (T, H, W, 3)
    uint8): the VAE's latents and the text tower's embeddings of the two
    prompts and the empty one. Else (--random-weights alone): latents
    0.2 N(0, 1) and N(0, 1) contexts from numpy seeded with --seed, the
    empty prompt's context zeros, as the JAX CLI's."""
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from ..pipelines.motion_clone import MotionCloneConfig

    with_video = frames is not None or bool(args.reference_video) or bool(args.checkpoint)
    if args.checkpoint and frames is None and not args.reference_video:
        raise SystemExit("error: --reference-video is required with --checkpoint")
    models = build_models(args, with_video)
    device = next(models.unet.parameters()).device
    _, ctx_shape, lat_shape = shapes(args)
    if with_video:
        ref = encode_frames(models, reference_frames(args) if frames is None else frames, args)
        with torch.no_grad():
            original, inference, uncond = (models.embed([p]).float()
                                           for p in (args.reference_prompt, args.prompt, ""))
    else:
        rng = np.random.RandomState(args.seed)
        ref = torch.from_numpy(rng.randn(*lat_shape).astype(np.float32)).to(device) * 0.2
        original, inference = (torch.from_numpy(rng.randn(*ctx_shape).astype(np.float32)).to(device)
                               for _ in range(2))
        uncond = torch.zeros(ctx_shape, device=device)
    sched = DiffusionSchedule.create()
    return MotionJob(
        models=models, ref_latents=ref, original_ctx=original, inference_ctx=inference, uncond_ctx=uncond,
        sched=sched, solver=DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=args.num_ddim_timesteps),
        cfg=MotionCloneConfig(num_ddim_timesteps=args.num_ddim_timesteps, guidance_scale=args.guidance_scale,
                              percentage=args.percentage, temp_loss_scale=args.temp_loss_scale))


def run(job: MotionJob, return_trace: bool = False, **cfg_overrides):
    """motion_transfer_sample of the job (the config's fields replaced by
    `cfg_overrides`): the latents, or (latents, trace)."""
    from ..pipelines.motion_clone import motion_transfer_sample

    cfg = dataclasses.replace(job.cfg, **cfg_overrides)
    return motion_transfer_sample(job.models.unet, job.ref_latents, job.original_ctx, job.inference_ctx,
                                  job.uncond_ctx, job.sched, job.solver, cfg, return_trace=return_trace)


def write_output(job: MotionJob, latents: torch.Tensor, args) -> str:
    """The decoded video through io/video.py when the job has a VAE, else
    the latents as <output>.latents.npy; returns the path written."""
    from ..io.video import save_video
    from ..pipelines.vc2 import video_to_uint8

    if job.models.vae is not None:
        return save_video(video_to_uint8(decode_latents(job.models, latents))[0], args.output, fps=args.save_fps)
    path = args.output + ".latents.npy"
    np.save(path, latents.float().cpu().numpy())
    return path


def main(argv=None):
    args = parse_args(argv)
    job = build_job(args)
    t0 = time.time()
    latents = run(job)
    print(f"sampled in {time.time() - t0:.1f}s; latents {tuple(latents.shape)}", file=sys.stderr)
    print(write_output(job, latents, args))


if __name__ == "__main__":
    main()
