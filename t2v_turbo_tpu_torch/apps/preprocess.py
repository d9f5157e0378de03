"""CLI: the offline T2V-Turbo-v2 data producer with the PyTorch port (the
reference's preprocess_with_motion_prior.py / preprocess_no_motion_*.py;
port of t2v_turbo_tpu/apps/preprocess.py).

Usage (smoke mode: seeded random teacher, synthetic latents and prompts):
  python -m t2v_turbo_tpu_torch.apps.preprocess --random-weights --synthetic-data \\
      --num-samples 4 --output-dir runs/v2_latents [--no-motion-prior]
On real video (a CSV of mp4 paths and captions, or webdataset tar shards):
  ... --checkpoint VideoCrafter2_model.ckpt --data-csv index.csv (or --data-shards 'shards/*.tar')
Each clip (16 frames at 8 fps, resized and centre-cropped to 320x512) is
VAE-encoded (the posterior's mean x 0.18215) and its caption embedded by
the OpenCLIP ViT-H text tower; the teacher (the checkpoint's VC2 UNet)
then gives z_t, the MotionClone score, and the conditional and
unconditional outputs (training/preprocess.py), pickled one file a sample
for apps/train_v2.py. The models run in bf16 on --device (default cuda:0),
every attention, GroupNorm, LayerNorm and GN->SiLU->conv pair on the
hand-written kernels but the nine probability captures (plain attention);
the score's backward runs the kernels' autograd functions with respect to
the latents alone. With --tiny-model the UNet and VAE are the tiny ones
and the contexts are seeded per caption (crc32).

The draws (grid index, noise) come from a torch.Generator seeded with
--seed; the synthetic latents and contexts from numpy, as the JAX CLI's.
The CLI takes no mesh flag, as the JAX CLI takes none; a caller that has
joined a torch.distributed world may set `PreprocessJob.mesh`, and every
rank then runs `samples()` over the (data, seq) mesh
(training/preprocess.py), rank 0 writing.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import sys
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo v2 preprocessing (PyTorch port)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt (the teacher, VAE and text tower)")
    p.add_argument("--random-weights", action="store_true", help="seeded random weights (smoke mode)")
    p.add_argument("--tiny-model", action="store_true", help="small UNet (tests / smoke)")
    p.add_argument("--data-csv", default=None, help="CSV of mp4 paths and captions (columns path, text)")
    p.add_argument("--data-shards", default=None, help="glob of webdataset tars (mp4 + txt)")
    p.add_argument("--synthetic-data", action="store_true", help="random latents and prompt embeddings")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--num-samples", type=int, default=100)
    p.add_argument("--n-frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--num-ddim-timesteps", type=int, default=50)
    p.add_argument("--max-percentage", type=float, default=0.3)
    p.add_argument("--no-motion-prior", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda:0")
    return p.parse_args(argv)


@dataclasses.dataclass
class PreprocessJob:
    """What `build_job` makes of the flags: the frozen teacher, the samples'
    source {name, latents, ctx, txt}, the empty prompt's context, the
    solver and the draws' generator."""

    teacher: torch.nn.Module
    source: Iterator[Tuple[str, torch.Tensor, torch.Tensor, str]]
    uncond: torch.Tensor
    cfg: object
    sched: object
    solver: object
    generator: torch.Generator
    output_dir: str
    mesh: Optional[object] = None  # parallel.mesh.Mesh: every rank runs `samples()`

    def samples(self) -> Iterator[Tuple[Optional[str], Optional[dict], float]]:
        """(path, sample, seconds) for each sample written, the seconds
        synchronised on a CUDA device; under a mesh, (None, None, seconds)
        on every rank but rank 0, which writes."""
        from ..training.preprocess import preprocess_sample, sample_preprocess_draws, save_sample

        device = next(self.teacher.parameters()).device
        for name, latents, ctx, txt in self.source:
            draws = sample_preprocess_draws(self.cfg, latents.shape, self.generator)
            t0 = time.perf_counter()
            sample = preprocess_sample(self.teacher, latents, ctx, self.uncond, draws, sched=self.sched,
                                       solver=self.solver, cfg=self.cfg, txt=txt, mesh=self.mesh)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            yield (None if sample is None else save_sample(self.output_dir, name, sample)), sample, seconds


def build_job(args) -> PreprocessJob:
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from ..io.convert import load_checkpoint, split_vc2_checkpoint
    from ..models import UNetConfig, UNetModel, cast_compute_dtype_, seeded_init_
    from ..training.preprocess import PreprocessConfig
    from .train_v1 import TINY_UNET_KW

    device = torch.device(args.device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if args.tiny_model:
        ucfg = UNetConfig(**{**TINY_UNET_KW, "time_cond_proj_dim": None})
        ctx_shape, lat_shape = (1, 7, ucfg.context_dim), (1, 4, 8, 8, 4)
    else:
        ucfg = UNetConfig()
        ctx_shape = (1, 77, ucfg.context_dim)
        lat_shape = (1, args.n_frames, args.height // 8, args.width // 8, 4)
    if not args.synthetic_data and not (args.data_csv or args.data_shards):
        raise SystemExit("error: provide --data-csv, --data-shards or --synthetic-data")
    with torch.device(device):
        teacher = UNetModel(ucfg)
    vae_sd = clip_sd = None
    if args.checkpoint:
        unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        teacher.load_state_dict(unet_sd, strict=True)
    elif args.random_weights:
        seeded_init_(teacher, args.seed + 1_000_000)
    else:
        print("error: provide --checkpoint or pass --random-weights", file=sys.stderr)
        sys.exit(2)
    cast_compute_dtype_(teacher, dtype).requires_grad_(False).eval()
    sched = DiffusionSchedule.create()
    if args.synthetic_data:
        source = synthetic_source(args, lat_shape, ctx_shape, device)
    else:
        source = video_source(args, device, dtype, ctx_shape, vae_sd, clip_sd)
    return PreprocessJob(
        teacher=teacher, source=source, uncond=torch.zeros(ctx_shape, device=device),
        cfg=PreprocessConfig(num_ddim_timesteps=args.num_ddim_timesteps, max_percentage=args.max_percentage,
                             with_motion_prior=not args.no_motion_prior),
        sched=sched,
        solver=DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=args.num_ddim_timesteps),
        generator=torch.Generator().manual_seed(args.seed), output_dir=args.output_dir)


def synthetic_source(args, lat_shape, ctx_shape, device):
    """The JAX CLI's synthetic samples: latents 0.2 N(0, 1) and a N(0, 1)
    context each, from numpy seeded with --seed."""
    rng = np.random.RandomState(args.seed)
    for i in range(args.num_samples):
        latents = torch.from_numpy(rng.randn(*lat_shape).astype(np.float32)).to(device) * 0.2
        ctx = torch.from_numpy(rng.randn(*ctx_shape).astype(np.float32)).to(device)
        yield f"synthetic_{i:06d}", latents, ctx, f"synthetic sample {i}"


def video_source(args, device, dtype, ctx_shape, vae_sd, clip_sd):
    """Samples from --data-csv (MP4Dataset) or --data-shards
    (WebVideoDataset), centre-cropped, in order, encoded on the device by
    the VAE and the text tower (the --checkpoint's, else seeded); with
    --tiny-model the contexts are seeded per caption (crc32)."""
    import functools

    from ..config import vc2_spec
    from ..data.datasets import MP4Dataset, read_csv_index
    from ..data.webdata import WebVideoDataset
    from ..models.vae import encode_video
    from .train_v1 import build_text_tower, build_vae, hashed_context, text_embedder

    size_hw = (args.height, args.width)
    if args.data_csv:
        ds = MP4Dataset(read_csv_index(args.data_csv), n_frames=args.n_frames, size_hw=size_hw,
                        random_crop=False)
        items = (ds[i] for i in range(min(len(ds), args.num_samples)))
        clips = ({"video": it["video"][None], "txt": [it["text"]]} for it in items)
    else:
        clips = iter(WebVideoDataset(sorted(glob.glob(args.data_shards)), batch_size=1, n_frames=args.n_frames,
                                     size_hw=size_hw, loop=False, random_crop=False))
    vae = build_vae(args, device, dtype, vae_sd)
    if args.tiny_model:
        embed = functools.partial(hashed_context, ctx_len=ctx_shape[1], ctx_dim=ctx_shape[2])
    else:
        embed = text_embedder(build_text_tower(args, device, dtype, clip_sd))
    for i, batch in enumerate(clips):
        if i >= args.num_samples:
            break
        with torch.no_grad():
            video = torch.as_tensor(np.asarray(batch["video"])).to(device)
            latents = encode_video(vae, video, scale_factor=vc2_spec().scale_factor).float()
            ctx = embed(list(batch["txt"])).float().to(device)
        yield f"sample_{i:06d}", latents, ctx, batch["txt"][0]


def main(argv=None):
    args = parse_args(argv)
    job = build_job(args)
    written = 0
    for path, _, _ in job.samples():
        print(path)
        written += 1
    print(f"wrote {written} samples to {args.output_dir}", file=sys.stderr)


if __name__ == "__main__":
    main()
