"""CLI: build the kernels ahead of serving, and export the inference programs
(port of t2v_turbo_tpu/apps/warmup.py).

The port's one compile is nvcc's: `ops/cuda_lib.build()` compiles the
hand-written kernels at first use into build/t2v_turbo_tpu_torch/<source
hash>/. Run without --export, this CLI does that ahead of the first
request, the analog of JAX's cache fill.

`--export DIR` also writes the three inference programs with `torch.export`
(`torch.export.export(..., strict=False)` under `torch.no_grad()`, traced
at the operating point the flags give) and a manifest.json, which
pipelines/artifact.py serves without the model code:

- `lcm_step.pt2`: ONE LCM step (`T2VTurboVC2Pipeline.lcm_step`: UNet,
  boundary combine, renoise), its timestep and its five scalars as 0-d
  inputs; the manifest's `grid` lists them for each step of the schedule,
  as the live pipeline computes them (`LCMScheduler.step_scalars`), and the
  serving host loops over it. One step, not the unrolled loop: tracing one
  full-width UNet is already the longest part of the export;
- `vae_decode.pt2`: `decode_latents` on chunks of --decode-chunk frames;
- `text_encode.pt2`: the text tower on the tokenizer's ids.

The modules are built on the meta device (no weights are made) and every
weight is a program input, a state dict passed through
`torch.func.functional_call`: a program file holds no weights. The
manifest records each weight's dtype and shape. The programs call the
kernels as `t2v_turbo::*` operators (ops/cuda_lib.define_op), which the
trace records without reading a pointer or building the library.

Usage:
  python -m t2v_turbo_tpu_torch.apps.warmup                 # build the kernels
  python -m t2v_turbo_tpu_torch.apps.warmup --export /models/t2v_pt2
  python -m t2v_turbo_tpu_torch.apps.warmup --tiny-model --f32 --device cpu --export DIR  # CPU trial
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

# The tiny configs (--tiny-model): JAX's warmup tiny models, with heads of
# 64 (so the tiny programs call the attention kernels' operators too) and
# the 256-wide w-embedding projection the pipelines feed (torch's Linear
# does not infer its input width as flax's Dense does).
TINY_VC2_UNET = dict(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     num_head_channels=64, context_dim=64, time_cond_proj_dim=256)
TINY_MS_UNET = dict(block_out_channels=(64, 128), layers_per_block=1, attention_head_dim=64,
                    cross_attention_dim=64, time_cond_proj_dim=256)
TINY_VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY_TEXT = dict(vocab_size=50, width=64, heads=1, layers=2, context_length=8)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Build the kernels / export the T2V-Turbo inference programs")
    p.add_argument("--backbone", default="vc2", choices=["vc2", "ms"],
                   help="VideoCrafter2 (320x512) or ModelScope (256x256); both export the same three programs")
    p.add_argument("--tiny-model", action="store_true", help="tiny UNet/VAE/text configs (smoke / tests)")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--lcm-origin-steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--decode-chunk", type=int, default=0,
                   help="frames per VAE-decode program (0 = batch*frames, the pipeline default)")
    p.add_argument("--use-motion-cond", action="store_true")
    p.add_argument("--percentage", type=float, default=0.3)
    p.add_argument("--f32", action="store_true", help="float32 compute (default bfloat16)")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="also write each program (torch.export, .pt2) into DIR with a manifest.json")
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


def build_pipeline(args, device="meta", seed=None):
    """The live pipeline (VC2 or MS) at the flags' configs, its modules on
    `device`: on the meta device no weight is made (the export's case);
    with `seed`, every module is filled as generate --random-weights --seed
    fills it. Returns (pipeline, meta): meta has the geometry the program
    shapes derive from."""
    from ..config import vc2_spec
    from ..diffusion import DiffusionSchedule
    from ..models import (
        AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig, cast_compute_dtype_,
        seeded_init_,
    )

    dtype = torch.float32 if args.f32 else torch.bfloat16
    if args.backbone == "ms":
        from ..models.unet_ms import MSUNet3DConditionModel, MSUNetConfig
        from ..pipelines.ms import T2VTurboMSPipeline as pipe_cls

        if args.use_motion_cond:
            raise ValueError("the MS UNet takes no motion embedding")
        ucfg = MSUNetConfig(**TINY_MS_UNET) if args.tiny_model else MSUNetConfig(time_cond_proj_dim=256)
        tcfg = CLIPTextConfig(**TINY_TEXT, penultimate=False) if args.tiny_model else CLIPTextConfig(penultimate=False)
        vcfg = VAEConfig(**TINY_VAE) if args.tiny_model else VAEConfig()
        schedule, scale_factor, ctx_dim = DiffusionSchedule.create(), 0.18215, ucfg.cross_attention_dim
        make_unet = MSUNet3DConditionModel
    else:
        from ..pipelines.vc2 import T2VTurboVC2Pipeline as pipe_cls

        spec = vc2_spec(motion_cond=args.use_motion_cond)
        motion = 256 if args.use_motion_cond else None
        ucfg = UNetConfig(**TINY_VC2_UNET, motion_cond_proj_dim=motion) if args.tiny_model else spec.unet
        tcfg = CLIPTextConfig(**TINY_TEXT) if args.tiny_model else spec.text
        vcfg = VAEConfig(**TINY_VAE) if args.tiny_model else spec.vae
        schedule, scale_factor, ctx_dim = spec.make_schedule(), spec.scale_factor, ucfg.context_dim
        make_unet = UNetModel
    with torch.device(device):
        modules = [make_unet(ucfg), AutoencoderKL(vcfg), CLIPTextModel(tcfg)]
    for i, m in enumerate(modules):
        if seed is not None:
            seeded_init_(m, seed + 1_000_000 * i)
        cast_compute_dtype_(m, dtype).eval().requires_grad_(False)
    vae_scale = 2 ** (len(vcfg.ch_mult) - 1)
    pipe = pipe_cls(unet=modules[0], vae=modules[1], text_model=modules[2], tokenizer=None, schedule=schedule,
                    device="cpu" if device == "meta" else device, scale_factor=scale_factor, vae_scale=vae_scale,
                    dtype=dtype)
    meta = {"dtype": dtype, "backbone": args.backbone, "vae_scale": vae_scale, "ctx_len": tcfg.context_length,
            "ctx_dim": ctx_dim, "in_channels": ucfg.in_channels, "z_channels": vcfg.z_channels}
    return pipe, meta


class _Program(torch.nn.Module):
    """A function as a module's forward, for torch.export."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def with_weights(module, sd, fn, *args):
    """fn(*args) with every parameter of `module` taken from `sd` (strict):
    the weights are the program's inputs, not its constants."""
    holder = _Program(fn)
    holder.module = module
    return torch.func.functional_call(holder, {f"module.{k}": v for k, v in sd.items()}, args, strict=True)


def _weight_inputs(module, device):
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device) for k, v in module.state_dict().items()}


def step_grid(pipe, steps, origin_steps, percentage):
    """The LCM grid as the live pipeline walks it: each step's timestep, its
    scalars (`LCMScheduler.step_scalars`, as floats) and whether the motion
    embedding is on there (pipelines/vc2.py::motion_guidance_scale)."""
    from ..pipelines.vc2 import motion_guidance_scale

    ts = [int(t) for t in pipe.scheduler.timesteps(steps, origin_steps)]
    grid = []
    for t, pt in zip(ts, ts[1:] + ts[-1:]):
        scalars = pipe.scheduler.step_scalars(t, pt)
        grid.append({"t": t, **{k: float(v) for k, v in scalars._asdict().items()},
                     "motion_on": motion_guidance_scale(t, 1.0, percentage, pipe.schedule.num_timesteps) != 0.0})
    return grid


def build_programs(args, device=None):
    """([(name, module to export, example inputs, the module whose weights it
    takes)], operating point, grid) at the flags' operating point."""
    device = torch.device(device or args.device)
    pipe, meta = build_pipeline(args)
    pipe.device = device
    dtype = meta["dtype"]
    b, t = args.batch, args.frames
    lh, lw = args.height // meta["vae_scale"], args.width // meta["vae_scale"]
    lat_shape = (b, t, lh, lw, meta["in_channels"])

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    step_args = [_weight_inputs(pipe.unet, device), zeros(lat_shape), torch.full((b,), 999, device=device),
                 zeros((b, meta["ctx_len"], meta["ctx_dim"])), torch.full((b,), 16.0, device=device),
                 zeros((b, pipe.w_embedding_dim)), tuple(zeros((), torch.float32) for _ in range(5)),
                 zeros(lat_shape, torch.float32)]
    if args.use_motion_cond:
        step_args.append(zeros((b, pipe.w_embedding_dim)))
    chunk = args.decode_chunk or b * t

    def lcm_step(sd, *a):
        return with_weights(pipe.unet, sd, pipe.lcm_step, *a)

    def vae_decode(sd, z):
        return with_weights(pipe.vae, sd, pipe.decode_latents, z)

    def text_encode(sd, tokens):
        return with_weights(pipe.text_model, sd, lambda tok: pipe.text_model(tok), tokens)

    programs = [
        ("lcm_step", _Program(lcm_step), tuple(step_args), pipe.unet),
        ("vae_decode", _Program(vae_decode),
         (_weight_inputs(pipe.vae, device), zeros((chunk, lh, lw, meta["z_channels"]), torch.float32)), pipe.vae),
        ("text_encode", _Program(text_encode),
         (_weight_inputs(pipe.text_model, device), torch.zeros((b, meta["ctx_len"]), dtype=torch.int32,
                                                                device=device)), pipe.text_model),
    ]
    # the operating point baked into the programs: JAX's keys, which
    # pipelines/artifact.py reads to rebuild the host loop and to refuse
    # requests the programs cannot serve
    op = {
        "steps": args.steps, "lcm_origin_steps": args.lcm_origin_steps, "batch": b, "frames": t,
        "height": args.height, "width": args.width, "use_motion_cond": args.use_motion_cond,
        "percentage": args.percentage, "decode_chunk": chunk, "dtype": str(dtype).replace("torch.", ""),
        "tiny_model": args.tiny_model, "backbone": meta["backbone"], "vae_scale": meta["vae_scale"],
        "ctx_dim": meta["ctx_dim"], "z_channels": meta["z_channels"], "ctx_len": meta["ctx_len"],
        "in_channels": meta["in_channels"], "w_embedding_dim": pipe.w_embedding_dim, "init_noise_sigma": 1.0,
    }
    return programs, op, step_grid(pipe, args.steps, args.lcm_origin_steps, args.percentage)


def export_program(module, example_args, path: str) -> int:
    """torch.export one program (no gradients, non-strict) into `path`;
    returns its bytes. The example inputs are not kept in the file."""
    with torch.no_grad():
        ep = torch.export.export(module, example_args, strict=False)
    if getattr(ep, "example_inputs", None) is not None:
        ep.example_inputs = None  # they hold the (zero) weights
    torch.export.save(ep, path)
    return os.path.getsize(path)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    cache_dir = None
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: no CUDA device (pass --device cpu for a CPU trial)")
        from ..ops import cuda_lib

        t0 = time.perf_counter()
        cache_dir = os.path.dirname(cuda_lib.build())
        print(f"# kernels built in {time.perf_counter() - t0:.1f}s -> {cache_dir}", file=sys.stderr)
    manifest = {"device": str(device), "torch_version": torch.__version__, "programs": {}}
    if args.export:
        programs, op, grid = build_programs(args, device)
        manifest.update(operating_point=op, grid=grid, weights={})
        os.makedirs(args.export, exist_ok=True)
        for name, module, example_args, owner in programs:
            t0 = time.perf_counter()
            size = export_program(module, example_args, os.path.join(args.export, f"{name}.pt2"))
            dt = time.perf_counter() - t0
            manifest["programs"][name] = {"artifact": f"{name}.pt2", "bytes": size, "export_s": round(dt, 2)}
            manifest["weights"][name] = {k: [str(v.dtype).replace("torch.", ""), list(v.shape)]
                                         for k, v in owner.state_dict().items()}
            print(f"# {name}: exported in {dt:.1f}s, {size} B", file=sys.stderr)
        with open(os.path.join(args.export, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
    print(json.dumps({"cache_dir": cache_dir, **{k: v for k, v in manifest.items() if k not in ("grid", "weights")}}))
    return manifest


if __name__ == "__main__":
    main()
