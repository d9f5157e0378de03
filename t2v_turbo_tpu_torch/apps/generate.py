"""CLI: prompt -> video with the PyTorch port (VC2 backbone, 4-step T2V-Turbo).

Usage:
  python -m t2v_turbo_tpu_torch.apps.generate \\
      --prompt "An astronaut riding a horse" \\
      --checkpoint /path/to/VideoCrafter2/model.ckpt --unet-ckpt /path/to/unet.pt \\
      --steps 4 --frames 16 --fps 16 --seed 123 --output out.mp4

Without --checkpoint, --random-weights must be passed explicitly: every
weight is then drawn from --seed (non-zero everywhere, 1/sqrt(fan_in)).
--lora-ckpt folds a trained LoRA into the UNet (alpha 1, the reference's
collapse): the reference's `unet_lora.pt` list or a `unet_lora.npz` of
either package's trainer. The output is written by the port's own
io/video.py: .npy always, .mp4 when an ffmpeg binary is present.
The models run in bf16 on --device (default cuda:0), where every GroupNorm
and LayerNorm, and every attention of head dim 64 or 512 but the CLIP
tower's causal one, run the hand-written kernels (ops/attention.py::sdpa).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo text-to-video (PyTorch port)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt")
    p.add_argument("--unet-ckpt", default=None, help="LCM student unet.pt (replaces the ckpt's UNet)")
    p.add_argument("--lora-ckpt", default=None,
                   help="v1 LoRA to fold into the UNet: unet_lora.pt or unet_lora.npz")
    p.add_argument("--random-weights", action="store_true",
                   help="run with seeded random weights (smoke mode, no checkpoint)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--lcm-origin-steps", type=int, default=50)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--guidance-scale", type=float, default=7.5)
    p.add_argument("--num-videos", type=int, default=1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--save-fps", type=int, default=8)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def build_pipeline(args, spec=None):
    """Models, weights and tokenizer -> a ready T2VTurboVC2Pipeline."""
    from ..config import vc2_spec
    from ..io.convert import load_checkpoint, load_clip_text, split_vc2_checkpoint
    from ..models import (
        AutoencoderKL, CLIPTextModel, UNetModel, cast_compute_dtype_, seeded_init_,
    )
    from ..pipelines.vc2 import T2VTurboVC2Pipeline
    from ..utils.tokenizer import CLIPTokenizer

    spec = spec or vc2_spec()
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    with torch.device(device):
        unet = UNetModel(spec.unet)
        vae = AutoencoderKL(spec.vae)
        text = CLIPTextModel(spec.text)

    if args.checkpoint:
        unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        if args.unet_ckpt:
            unet_sd = load_checkpoint(args.unet_ckpt)
        unet.load_state_dict(unet_sd, strict=True)
        vae.load_state_dict(vae_sd, strict=True)
        load_clip_text(text, clip_sd)
    elif args.random_weights:
        for i, m in enumerate((unet, vae, text)):
            seeded_init_(m, args.seed + 1_000_000 * i)
    else:
        print("error: provide --checkpoint or pass --random-weights", file=sys.stderr)
        sys.exit(2)

    if args.lora_ckpt:
        unet.load_state_dict(lora_state_dict(unet, args.lora_ckpt, spec.unet), strict=True)
    for m in (unet, vae, text):
        cast_compute_dtype_(m, dtype).eval().requires_grad_(False)
    return T2VTurboVC2Pipeline(
        unet=unet, vae=vae, text_model=text, tokenizer=CLIPTokenizer(),
        schedule=spec.make_schedule(), device=device, scale_factor=spec.scale_factor,
        dtype=dtype,
    )


def lora_state_dict(unet, path, cfg):
    """The UNet's state dict with the LoRA at `path` (.pt or .npz) folded in."""
    from ..io.lora_import import apply_lora_pt, load_lora_pt
    from ..lora import load_lora_npz, merge_lora

    with torch.no_grad():
        if path.endswith(".npz"):
            return merge_lora(unet.state_dict(), load_lora_npz(path, unet))
        return apply_lora_pt(unet.state_dict(), load_lora_pt(path), cfg)


def main(argv=None):
    args = parse_args(argv)
    from ..io.video import save_video
    from ..pipelines.vc2 import video_to_uint8

    t0 = time.time()
    pipe = build_pipeline(args)
    print(f"pipeline ready in {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    video = pipe(
        prompt=args.prompt,
        height=args.height,
        width=args.width,
        frames=args.frames,
        fps=args.fps,
        guidance_scale=args.guidance_scale,
        num_videos_per_prompt=args.num_videos,
        num_inference_steps=args.steps,
        lcm_origin_steps=args.lcm_origin_steps,
        generator=gen,
    )
    frames = video_to_uint8(video)
    print(f"generated {frames.shape} in {time.time() - t0:.1f}s", file=sys.stderr)
    root, ext = args.output.rsplit(".", 1) if "." in args.output else (args.output, "mp4")
    for i in range(frames.shape[0]):
        out = args.output if frames.shape[0] == 1 else f"{root}_{i}.{ext}"
        print(save_video(frames[i], out, fps=args.save_fps))


if __name__ == "__main__":
    main()
