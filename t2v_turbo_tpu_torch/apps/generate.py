"""CLI: prompt -> video with the PyTorch port (4-step T2V-Turbo on the VC2 or
the ModelScope backbone).

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
T2V-Turbo-v2 (a v2 student's unet.pt, motion-conditioned; its operating
point is 16 steps from an origin grid of 200):
  ... --unet-ckpt runs/v2/unet.pt --use-motion-cond --motion-gs 0.05 \
      --percentage 0.3 --steps 16 --lcm-origin-steps 200
ModelScope (--backbone ms; its operating point is 16 frames at 256x256: the
size flags keep their VC2 defaults, as the JAX CLI's, so pass
--height 256 --width 256): the diffusers folder of text-to-video-ms-1.7b, or seeded
weights with --random-weights; --unet-ckpt replaces its UNet with an LCM
student's (diffusers keys), --lora-ckpt folds the reference's MS LoRA
(r = 32) into it (the reference's app_ms.py:181-227):
  ... --backbone ms --ms-dir /path/to/text-to-video-ms-1.7b --lora-ckpt unet_lora.pt --height 256 --width 256
The models run in bf16 on --device (default cuda:0), where every GroupNorm
and LayerNorm, and every attention of head dim 64 or 512 but the CLIP
tower's causal one, run the hand-written kernels (ops/attention.py::sdpa).

Sharded (VC2): one process per rank under torchrun, the batch over
--data-shards ranks and the frames over --seq-shards (--model-shards, tensor
parallelism, is A12b and refused); the world must hold exactly
data * seq * model ranks, each on cuda:{LOCAL_RANK} (NCCL), and rank 0
writes the output:
  torchrun --nproc-per-node 2 -m t2v_turbo_tpu_torch.apps.generate --random-weights \\
      --prompt "..." --seq-shards 2 --output out.npy
--device cpu runs the ranks on the CPU over gloo; --multihost joins
torchrun's world even at one shard.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo text-to-video (PyTorch port)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--backbone", default="vc2", choices=["vc2", "ms"],
                   help="vc2 = VideoCrafter2 (320x512); ms = ModelScope (256x256: pass the size)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt")
    p.add_argument("--ms-dir", default=None,
                   help="ModelScope diffusers folder with unet/, vae/ and text_encoder/ subfolders")
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
    p.add_argument("--use-motion-cond", action="store_true",
                   help="a v2 student's motion-guidance embedding (its UNet has motion_cond_proj)")
    p.add_argument("--motion-gs", type=float, default=0.05)
    p.add_argument("--percentage", type=float, default=0.3,
                   help="the top share of the timesteps given --motion-gs (0 below)")
    p.add_argument("--num-videos", type=int, default=1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--output", default="output.mp4")
    p.add_argument("--save-fps", type=int, default=8)
    p.add_argument("--device", default="cuda:0",
                   help="cuda:N or cpu; under a mesh the device type only (each rank takes cuda:{LOCAL_RANK})")
    add_mesh_args(p)
    return p.parse_args(argv)


def add_mesh_args(p):
    """The mesh flags of generate and serve."""
    p.add_argument("--data-shards", type=int, default=1, help="mesh data axis: videos of a batch over ranks")
    p.add_argument("--seq-shards", type=int, default=1, help="mesh seq axis: the frames of a video over ranks")
    p.add_argument("--model-shards", type=int, default=1,
                   help="mesh model axis (tensor parallelism): not ported yet (A12b), must be 1")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's torch.distributed world (implied by a shard count above 1)")


def make_cli_mesh(args):
    """The mesh the flags ask for, or None: joins torchrun's world (unless
    the process already joined one) and uses exactly data * seq * model
    ranks, refusing a world of another size, as JAX's _maybe_make_mesh uses
    exactly that many devices."""
    import torch.distributed as dist

    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    shards = (args.data_shards, args.seq_shards, args.model_shards)
    need = shards[0] * shards[1] * shards[2]
    if min(shards) < 1:
        raise SystemExit(f"error: shard counts must be >= 1, got {shards}")
    if args.model_shards > 1:
        raise SystemExit("error: --model-shards > 1 (tensor parallelism) is not ported yet (A12b)")
    if need == 1 and not args.multihost:
        return None
    if getattr(args, "backbone", "vc2") != "vc2":
        raise SystemExit("error: sharded sampling runs the VC2 backbone only")
    device = None
    if not dist.is_initialized():
        if not multihost.torchrun_env():
            raise SystemExit(f"error: {need} shard(s) need {need} ranks: launch under torchrun --nproc-per-node "
                             f"{need} (its MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE are not set)")
        device = multihost.initialize(device_type=torch.device(args.device).type)
    if dist.get_world_size() != need:
        raise SystemExit(f"error: --data/--seq/--model-shards {shards} need exactly {need} ranks, the world has "
                         f"{dist.get_world_size()}")
    return make_mesh(data=args.data_shards, seq=args.seq_shards, model=args.model_shards, device=device)


def build_pipeline(args, spec=None, mesh=None):
    """Models, weights and tokenizer -> a ready T2VTurboVC2Pipeline (with
    --backbone ms, `build_ms_pipeline`'s T2VTurboMSPipeline); with a `mesh`
    on the mesh's device, sampling over its ranks."""
    if getattr(args, "backbone", "vc2") == "ms":
        if mesh is not None:
            raise ValueError("sharded sampling runs the VC2 backbone only")
        return build_ms_pipeline(args)
    from ..config import vc2_spec
    from ..io.convert import load_checkpoint, load_clip_text, split_vc2_checkpoint
    from ..models import (
        AutoencoderKL, CLIPTextModel, UNetModel, cast_compute_dtype_, seeded_init_,
    )
    from ..pipelines.vc2 import T2VTurboVC2Pipeline
    from ..utils.tokenizer import CLIPTokenizer

    spec = spec or vc2_spec(motion_cond=getattr(args, "use_motion_cond", False))
    device = mesh.device if mesh is not None else torch.device(args.device)
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
        vae_scale=2 ** (len(spec.vae.ch_mult) - 1), dtype=dtype, mesh=mesh,
    )


def build_ms_pipeline(args, unet_cfg=None, vae_cfg=None, text_cfg=None):
    """The ModelScope backbone (the reference's app_ms.py /
    t2v_turbo_ms_pipeline): the MS UNet with the 256-d w-embedding input,
    the SD VAE and the full-depth CLIP text tower, from --ms-dir or seeded
    (--random-weights); the configs default to the published ones (tests
    pass small ones; a --ms-dir tower's config comes from its folder)."""
    from ..io.convert import load_checkpoint
    from ..io.ms import load_ms_components, ms_unet_state_dict
    from ..models import AutoencoderKL, CLIPTextConfig, CLIPTextModel, VAEConfig, cast_compute_dtype_, seeded_init_
    from ..models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
    from ..diffusion import DiffusionSchedule
    from ..pipelines.ms import T2VTurboMSPipeline
    from ..utils.tokenizer import CLIPTokenizer

    ucfg = unet_cfg or MSUNetConfig(time_cond_proj_dim=256)
    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    comps = None
    if args.ms_dir:
        comps = load_ms_components(args.ms_dir)
        text_cfg = comps["text_cfg"]
    elif not args.random_weights:
        print("error: the MS backbone needs --ms-dir (a diffusers folder) or --random-weights", file=sys.stderr)
        sys.exit(2)
    with torch.device(device):
        unet = MSUNet3DConditionModel(ucfg)
        vae = AutoencoderKL(vae_cfg or VAEConfig())
        text = CLIPTextModel(text_cfg or CLIPTextConfig(penultimate=False))
    if comps is not None:
        unet_sd = load_checkpoint(args.unet_ckpt) if args.unet_ckpt else comps["unet"]
        unet.load_state_dict(ms_unet_state_dict(unet_sd, ucfg), strict=True)
        vae.load_state_dict(comps["vae"], strict=True)
        text.load_state_dict(comps["text"], strict=True)
    else:
        for i, m in enumerate((unet, vae, text)):
            seeded_init_(m, args.seed + 1_000_000 * i)
    if args.lora_ckpt:
        from ..io.lora_import import apply_lora_pt_ms, load_lora_pt

        with torch.no_grad():
            unet.load_state_dict(apply_lora_pt_ms(unet.state_dict(), load_lora_pt(args.lora_ckpt), ucfg), strict=True)
    for m in (unet, vae, text):
        cast_compute_dtype_(m, dtype).eval().requires_grad_(False)
    return T2VTurboMSPipeline(unet=unet, vae=vae, text_model=text, tokenizer=CLIPTokenizer(),
                              schedule=DiffusionSchedule.create(), device=device, dtype=dtype)


def lora_state_dict(unet, path, cfg):
    """The UNet's state dict with the LoRA at `path` (.pt or .npz) folded in."""
    from ..io.lora_import import apply_lora_pt, load_lora_pt
    from ..lora import load_lora_npz, merge_lora

    with torch.no_grad():
        if path.endswith(".npz"):
            return merge_lora(unet.state_dict(), load_lora_npz(path, unet))
        return apply_lora_pt(unet.state_dict(), load_lora_pt(path), cfg)


def main(argv=None, spec=None):
    """The CLI; `spec` replaces the VC2 configs (tests pass small ones)."""
    args = parse_args(argv)
    mesh = make_cli_mesh(args)
    try:
        _generate(args, spec, mesh)
    finally:
        if mesh is not None:
            from ..parallel import multihost

            multihost.shutdown()


def _generate(args, spec, mesh):
    from ..io.video import save_video
    from ..pipelines.vc2 import video_to_uint8

    t0 = time.time()
    pipe = build_pipeline(args, spec, mesh)
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
        use_motion_cond=args.use_motion_cond,
        motion_gs=args.motion_gs,
        percentage=args.percentage,
    )
    if video is None:  # a rank other than 0 of a mesh: rank 0 writes
        return
    frames = video_to_uint8(video)
    print(f"generated {frames.shape} in {time.time() - t0:.1f}s", file=sys.stderr)
    root, ext = args.output.rsplit(".", 1) if "." in args.output else (args.output, "mp4")
    for i in range(frames.shape[0]):
        out = args.output if frames.shape[0] == 1 else f"{root}_{i}.{ext}"
        print(save_video(frames[i], out, fps=args.save_fps))


if __name__ == "__main__":
    main()
