"""CLI: v1 LoRA latent consistency distillation with the PyTorch port.

Usage (smoke mode: seeded random weights, synthetic latents and prompts):
  python -m t2v_turbo_tpu_torch.apps.train_v1 --random-weights --synthetic-data \\
      --max-steps 3 --output-dir runs/v1_torch
With reward feedback (the reference v1 recipe: 5 random frames scored by
the ViT-H/14 image reward, 8 strided frames by the ViCLIP-L video reward,
both VAE-decoded from the student's prediction with gradient):
  ... --reward-fn hpsv2 --video-rm-fn vi_clip [--reward-ckpt open_clip.pt]
      [--video-rm-ckpt viclip.pt]

With a VideoCrafter2 checkpoint, the teacher is its UNet and the student
the same weights plus a zero `time_cond_proj` (the w-embedding input).
Frozen weights are bf16 on a CUDA device (f32 on the CPU); the LoRA
factors (rank 64 on every Linear, Conv2d and Conv3d of the UNet) are f32.
On the card every attention, GroupNorm and LayerNorm of the UNet runs the
hand-written kernels, the student's gradient-carrying forward and backward
through their autograd functions (ops/). At the end the factors are written
as `unet_lora.npz` (the JAX trainer's layout) and `unet_lora.pt` (the
reference's list), both loadable by `apps/generate.py --lora-ckpt`.

The reward towers and the reward VAE (the checkpoint's, or seeded random
weights) are frozen, bf16 on the card; the text features come from the
towers' pooled text branches, once per batch.

Not yet ported: the real-data path (webdataset / CSV video with VAE and
text encode), the BLIP and InternVideo2 rewards, HF-layout CLIP
checkpoints, multi-host and FSDP.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo v1 LoRA LCD trainer (PyTorch port)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt")
    p.add_argument("--random-weights", action="store_true",
                   help="seeded random weights (smoke mode, no checkpoint)")
    p.add_argument("--tiny-model", action="store_true", help="small UNet (tests / smoke)")
    p.add_argument("--synthetic-data", action="store_true",
                   help="random latents and prompt embeddings")
    p.add_argument("--output-dir", default="runs/v1")
    p.add_argument("--max-steps", type=int, default=10000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--n-frames", type=int, default=16)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--fps", type=int, default=16)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--optimizer", default="adamw8bit", choices=["adamw", "adamw_bf16", "adamw8bit"])
    p.add_argument("--lora-rank", type=int, default=64)
    p.add_argument("--w-min", type=float, default=5.0)
    p.add_argument("--w-max", type=float, default=15.0)
    p.add_argument("--num-ddim-timesteps", type=int, default=50)
    p.add_argument("--loss-type", default="huber", choices=["huber", "l2"])
    p.add_argument("--huber-c", type=float, default=0.001)
    p.add_argument("--checkpointing-steps", type=int, default=2000)
    p.add_argument("--checkpoints-total-limit", type=int, default=3)
    p.add_argument("--max-grad-norm", type=float, default=10.0)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1,
                   help="average grads over K micro-batches per update")
    p.add_argument("--seed", type=int, default=453645634)
    p.add_argument("--use-remat", action="store_true",
                   help="recompute each block's activations in the backward")
    p.add_argument("--device", default="cuda:0")
    # reward feedback (the reference's --reward_fn_name / --video_rm_name ...)
    p.add_argument("--reward-fn", default="none", choices=["none", "clip", "hpsv2", "pick"])
    p.add_argument("--reward-ckpt", default=None, help="open_clip CLIP state dict (image reward)")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--reward-frames", type=int, default=5, help="random frames scored per sample")
    p.add_argument("--reward-fraction", type=float, default=0.75,
                   help="share of each batch carrying the image-reward loss")
    p.add_argument("--video-rm-fn", default="none", choices=["none", "vi_clip"])
    p.add_argument("--video-rm-ckpt", default=None, help="ViCLIP state dict (video reward)")
    p.add_argument("--video-reward-scale", type=float, default=1.0)
    p.add_argument("--video-rm-frames", type=int, default=8)
    p.add_argument("--video-rm-fraction", type=float, default=0.25)
    p.add_argument("--vae-decode-batch-size", type=int, default=16,
                   help="frames decoded per checkpointed VAE chunk in the reward losses; 0 = one call")
    return p.parse_args(argv)


# the JAX CLI's --tiny-model UNet (t2v_turbo_tpu/apps/train_v1.py)
TINY_UNET_KW = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1),
                    channel_mult=(1, 2), num_head_channels=16, context_dim=16,
                    time_cond_proj_dim=8)


# the JAX CLI's --tiny-model reward stack (t2v_turbo_tpu/apps/train_v1.py)
TINY_VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY_VIT_KW = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4, output_dim=16)
TINY_REWARD_TEXT_KW = dict(vocab_size=49408, width=32, heads=4, layers=2, context_length=77,
                           penultimate=False)


@dataclasses.dataclass(frozen=True)
class DataShape:
    batch: int
    frames: int
    latent_hw: tuple
    ctx_len: int
    ctx_dim: int


def build_trainer(args):
    """(trainer, data iterator, UNet config) from the parsed flags."""
    from ..config import vc2_spec
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from ..io.convert import load_checkpoint, split_vc2_checkpoint
    from ..models import UNetConfig, UNetModel, cast_compute_dtype_, seeded_init_
    from ..training.lcd import LCDConfig
    from ..training.optim import make_optimizer
    from ..training.trainer import LCDTrainer, TrainerConfig

    if args.lora_rank <= 0:
        raise SystemExit("error: --lora-rank must be positive (full fine-tuning is v2's)")
    if not args.synthetic_data:
        raise SystemExit("error: only --synthetic-data is ported so far")
    device = torch.device(args.device)
    if args.tiny_model:
        ucfg = UNetConfig(**TINY_UNET_KW)
        shape = DataShape(4, 4, (8, 8), 7, ucfg.context_dim)
    else:
        ucfg = vc2_spec().unet
        shape = DataShape(args.batch_size, args.n_frames, (args.height // 8, args.width // 8),
                          77, ucfg.context_dim)
    wdim = ucfg.time_cond_proj_dim
    with torch.device(device):
        student = UNetModel(ucfg, use_remat=args.use_remat)
        teacher = UNetModel(dataclasses.replace(ucfg, time_cond_proj_dim=None))

    vae_sd = None
    if args.checkpoint:
        unet_sd, vae_sd, _ = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        teacher.load_state_dict(unet_sd, strict=True)
        # the student: the teacher's weights plus a zero w-embedding projection
        student.load_state_dict(
            {**unet_sd, "time_cond_proj.weight": torch.zeros(ucfg.model_channels, wdim)}, strict=True
        )
    elif args.random_weights:
        seeded_init_(student, args.seed)
        seeded_init_(teacher, args.seed + 1_000_000)
    else:
        print("error: provide --checkpoint or pass --random-weights", file=sys.stderr)
        sys.exit(2)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    for m in (student, teacher):
        cast_compute_dtype_(m, dtype).requires_grad_(False)

    reward_fn, video_reward_fn, image_rm, video_rm = build_reward_stack(args, device, dtype, vae_sd)
    sched = DiffusionSchedule.create()
    trainer = LCDTrainer(
        student=student,
        teacher=teacher,
        sched=sched,
        solver=DDIMSolver.create(sched.alphas_cumprod.numpy(),
                                 ddim_timesteps=args.num_ddim_timesteps),
        lcd_cfg=LCDConfig(num_ddim_timesteps=args.num_ddim_timesteps, w_min=args.w_min,
                          w_max=args.w_max, w_embedding_dim=wdim, loss_type=args.loss_type,
                          huber_c=args.huber_c, reward_scale=args.reward_scale,
                          video_reward_scale=args.video_reward_scale),
        optimizer=functools.partial(make_optimizer, name=args.optimizer,
                                    learning_rate=args.learning_rate),
        cfg=TrainerConfig(
            output_dir=args.output_dir, max_steps=args.max_steps,
            checkpoint_every=args.checkpointing_steps,
            keep_checkpoints=args.checkpoints_total_limit, log_every=1, seed=args.seed,
            max_grad_norm=args.max_grad_norm, lora_rank=args.lora_rank,
            grad_accum_steps=args.gradient_accumulation_steps,
        ),
        reward_fn=reward_fn,
        video_reward_fn=video_reward_fn,
    )
    data = synthetic_data(shape, args.fps)
    if image_rm is not None or video_rm is not None:
        data = add_reward_fields(data, args, shape.frames, shape.batch, image_rm, video_rm)
    return trainer, data, ucfg


def build_reward_stack(args, device, dtype, vae_sd=None):
    """(reward_fn, video_reward_fn, image reward model, video reward model)
    from the reward flags; Nones when both are "none". The reward VAE loads
    `vae_sd` (the --checkpoint's), else takes seeded random weights (the JAX
    CLI's tiny VAE with --tiny-model); the towers load --reward-ckpt /
    --video-rm-ckpt, else seeded random weights. All are frozen, in `dtype`
    but their norms."""
    from ..io.convert import load_checkpoint
    from ..models import AutoencoderKL, CLIPTextConfig, VAEConfig, cast_compute_dtype_, seeded_init_
    from ..rewards.reward_fn import build_image_reward_model, build_video_reward_model
    from ..rewards.vit import VideoViTConfig, ViTConfig
    from ..training.reward_adapters import make_reward_fns

    if args.reward_fn == "none" and args.video_rm_fn == "none":
        return None, None, None, None
    with torch.device(device):
        vae = AutoencoderKL(VAEConfig(**TINY_VAE_KW) if args.tiny_model else VAEConfig())
    if vae_sd is not None:
        vae.load_state_dict(vae_sd, strict=True)
    else:
        seeded_init_(vae, args.seed + 2_000_000)
    tiny_text = CLIPTextConfig(**TINY_REWARD_TEXT_KW)
    image_rm = video_rm = None
    if args.reward_fn != "none":
        sd = load_checkpoint(args.reward_ckpt) if args.reward_ckpt else None
        kw = dict(vit_cfg=ViTConfig(**TINY_VIT_KW), text_cfg=tiny_text) if args.tiny_model else {}
        image_rm = build_image_reward_model(sd, seed=args.seed + 3_000_000, device=device, **kw)
    if args.video_rm_fn != "none":
        sd = load_checkpoint(args.video_rm_ckpt) if args.video_rm_ckpt else None
        kw = dict(vit_cfg=VideoViTConfig(**TINY_VIT_KW, num_frames=8), text_cfg=tiny_text) \
            if args.tiny_model else {}
        video_rm = build_video_reward_model(sd, seed=args.seed + 4_000_000, device=device, **kw)
    for m in (vae, image_rm, video_rm):
        if m is not None:
            cast_compute_dtype_(m, dtype).requires_grad_(False).eval()
    rf, vrf = make_reward_fns(vae, image_rm, video_rm,
                              decode_chunk=args.vae_decode_batch_size or None)
    return rf, vrf, image_rm, video_rm


def add_reward_fields(base_iter, args, frames: int, b: int, image_rm, video_rm):
    """Batches with the reward fields added: frame indices (a numpy
    RandomState seeded as the JAX CLI's, so both draw the same frames),
    normalised text features of the batch's `_texts`, and role masks (the
    first round(reward_fraction * B) examples carry the image reward, the
    last round(video_rm_fraction * B) the video reward, at least one each)."""
    from ..training.reward_adapters import precompute_text_feats, sample_frame_indices

    rng = np.random.RandomState(args.seed % (2**31 - 1))
    n_img = max(1, int(round(args.reward_fraction * b)))
    n_vid = max(1, int(round(args.video_rm_fraction * b)))
    for batch in base_iter:
        texts = batch.get("_texts", [""] * b)
        if image_rm is not None:
            batch["reward_frame_idx"] = sample_frame_indices(rng, b, frames, min(args.reward_frames, frames))
            batch["reward_text_feats"] = precompute_text_feats(image_rm, texts).cpu().numpy()
            batch["reward_mask"] = (np.arange(b) < n_img).astype(np.float32)
        if video_rm is not None:
            batch["video_frame_idx"] = sample_frame_indices(
                rng, b, frames, min(args.video_rm_frames, frames), strided=True)
            batch["video_text_feats"] = precompute_text_feats(video_rm, texts).cpu().numpy()
            batch["video_reward_mask"] = (np.arange(b) >= b - n_vid).astype(np.float32)
        yield batch


def synthetic_data(shape: DataShape, fps: float):
    """Endless batches of random latents and prompt embeddings, zero
    unconditional embeddings, from a fixed numpy seed (as the JAX CLI)."""
    rng = np.random.RandomState(0)
    b = shape.batch
    while True:
        yield {
            "latents": rng.randn(b, shape.frames, *shape.latent_hw, 4).astype(np.float32),
            "ctx": rng.randn(b, shape.ctx_len, shape.ctx_dim).astype(np.float32),
            "uncond_ctx": np.zeros((b, shape.ctx_len, shape.ctx_dim), np.float32),
            "fps": np.full((b,), float(fps), np.float32),
            "_texts": ["synthetic sample"] * b,
        }


def export_lora(trainer, ucfg, output_dir: str):
    """Write unet_lora.npz and unet_lora.pt; returns their paths."""
    from ..io.lora_import import export_lora_pt
    from ..lora import save_lora_npz, target_shapes

    npz, pt = os.path.join(output_dir, "unet_lora.npz"), os.path.join(output_dir, "unet_lora.pt")
    save_lora_npz(npz, trainer.factors)
    torch.save(export_lora_pt(trainer.factors, ucfg, target_shapes(trainer.student)), pt)
    return npz, pt


def main(argv=None):
    args = parse_args(argv)
    trainer, data, ucfg = build_trainer(args)
    metrics = trainer.run(data)
    print(f"final metrics: {metrics}")
    for path in export_lora(trainer, ucfg, args.output_dir):
        print(path)


if __name__ == "__main__":
    main()
