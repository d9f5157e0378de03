"""CLI: v1 LoRA latent consistency distillation with the PyTorch port.

Usage (smoke mode: seeded random weights, synthetic latents and prompts):
  python -m t2v_turbo_tpu_torch.apps.train_v1 --random-weights --synthetic-data \\
      --max-steps 3 --output-dir runs/v1_torch
On real video (webdataset tar shards of mp4 + txt, or a CSV of mp4 paths
and captions; the reference's WebVid recipe: 16 frames at 8 fps, the short
side resized, then a random 320x512 crop):
  ... --checkpoint VideoCrafter2_model.ckpt --data-shards 'shards/*.tar' \\
      [--prefix-weights 'shards/a=0.7,shards/b=0.3']   (or --data-csv index.csv)
The clips are decoded by the native libav library (data/videoio.py, built
at first use), then on the device the VAE encodes them (the posterior's
mean times 0.18215) and the OpenCLIP ViT-H text tower embeds the captions
and, once, the empty prompt; both frozen, bf16 on a CUDA device. The
trainer's prefetcher runs this for the next batches while a step runs.
With --tiny-model the VAE is the tiny one and the contexts are seeded per
caption (crc32), as the JAX CLI's.
With reward feedback (the reference v1 recipe: 5 random frames scored by
the image reward, 8 strided frames by the video reward, both VAE-decoded
from the student's prediction with gradient):
  ... --reward-fn hpsv2 --video-rm-fn vi_clip [--reward-ckpt open_clip.pt]
      [--video-rm-ckpt viclip.pt]
  ... --reward-fn img_reward --video-rm-fn vi_clip2 [--bert-vocab vocab.txt]
      [--reward-ckpt ImageReward.pt] [--video-rm-ckpt InternVideo2-stage2.pt]
`hpsv2` / `clip` / `pick` are the ViT-H/14 image reward (an open_clip or,
for PickScore, an HF CLIPModel checkpoint), `img_reward` ImageReward (BLIP
ViT-L/16 and a cross-attending BERT, all on the gradient path), `vi_clip`
ViCLIP-L and `vi_clip2` InternVideo2 (the reference's default video
reward). The BERT towers tokenise with --bert-vocab (BLIP at 35 tokens,
InternVideo2 at 40), else, with seeded weights only, with a stand-in hash
of each word. `build_validation_fn` gives `LCDTrainer.run` its periodic
validation videos: the student renders the reference's 10 prompts at 8
and 16 steps into <output-dir>/validation/ with an index.jsonl, through
the VAE and text tower of `build_trainer(..., validation=True)`.

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

Over a (data, seq) mesh of torch.distributed ranks (JAX's --seq-shards,
--fsdp and --multihost; apps/train_v1.py:59-62, :107, :303-306): under
torchrun every rank runs this CLI, the frames of a clip split over
--seq-shards ranks and the batch over the data axis, the world divided by
seq (exactly data x seq ranks: a world that --seq-shards does not divide is
refused). --batch-size is a data rank's batch (the global batch is data
times it); with --synthetic-data every rank draws the global batch and
keeps its data index's rows, so a sharded run trains on the one-process
run's batches. --fsdp shards the optimizer state over the data axis
(training/trainer.py). --device cpu runs the ranks on the CPU over gloo:
  torchrun --nproc-per-node 2 -m t2v_turbo_tpu_torch.apps.train_v1 --tiny-model \
      --device cpu --random-weights --synthetic-data --max-steps 2 --seq-shards 2
Rank 0 writes the metrics, the checkpoints and the exports.

Not yet ported: EMA (v1 has none in the reference either).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import os
import sys
import zlib

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
    p.add_argument("--data-shards", default=None, help="glob of webdataset tars (mp4 + txt)")
    p.add_argument("--prefix-weights", default=None,
                   help="mixture-of-prefixes shard resampling, e.g. 'path/a=0.7,path/b=0.3' "
                        "(the reference's custom_wds.py PrefixResampler)")
    p.add_argument("--data-csv", default=None, help="CSV of mp4 paths and captions (columns path, text)")
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
    p.add_argument("--grads-bf16", action="store_true",
                   help="the LoRA gradient buffer in bf16 (the norm in f32; refused with accumulation)")
    p.add_argument("--seed", type=int, default=453645634)
    p.add_argument("--use-remat", action="store_true",
                   help="recompute each block's activations in the backward (the UNet's, and "
                        "InternVideo2's with --video-rm-fn vi_clip2)")
    p.add_argument("--device", default="cuda:0",
                   help="this process's device; under torchrun the rank's card (cuda:LOCAL_RANK), or cpu")
    p.add_argument("--seq-shards", type=int, default=1,
                   help="mesh seq axis: the frames of a clip over ranks (the data axis is the world over it)")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the optimizer state over the mesh's data axis (ZeRO)")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's torch.distributed world (implied by --seq-shards above 1 and by a "
                        "torchrun world of more than one rank)")
    # reward feedback (the reference's --reward_fn_name / --video_rm_name ...)
    p.add_argument("--reward-fn", default="none", choices=["none", "clip", "hpsv2", "pick", "img_reward"])
    p.add_argument("--reward-ckpt", default=None,
                   help="image reward state dict: open_clip or HF CLIPModel, or ImageReward's for img_reward")
    p.add_argument("--bert-vocab", default=None, help="BERT vocab.txt for the img_reward / vi_clip2 text towers")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--reward-frames", type=int, default=5, help="random frames scored per sample")
    p.add_argument("--reward-fraction", type=float, default=0.75,
                   help="share of each batch carrying the image-reward loss")
    p.add_argument("--video-rm-fn", default="none", choices=["none", "vi_clip", "vi_clip2"])
    p.add_argument("--video-rm-ckpt", default=None,
                   help="video reward state dict: ViCLIP's, or InternVideo2-Stage2's for vi_clip2")
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
TINY_BERT_KW = dict(vocab_size=30524, hidden=32, layers=2, heads=4, intermediate=64, encoder_width=32)
TINY_BLIP_VIT_KW = dict(image_size=28, patch_size=14, width=32, layers=2, heads=4)
TINY_IV2_KW = dict(img_size=28, patch_size=14, width=32, depth=2, heads=4, mlp_hidden=64, num_frames=4,
                   clip_embed_dim=16, attn_pool_heads=4)
# the tiny UNet's text context comes from a small tower: CLIP's vocabulary,
# the UNet's context width (validation renders at --tiny-model)
TINY_PROMPT_TEXT_KW = dict(vocab_size=49408, width=16, heads=2, layers=2, context_length=77)


@dataclasses.dataclass(frozen=True)
class DataShape:
    batch: int
    frames: int
    latent_hw: tuple
    ctx_len: int
    ctx_dim: int


def make_train_mesh(args):
    """The (data, seq) mesh the flags ask for, or None: joins torchrun's world
    (unless the process already joined one) and takes data = world / seq,
    refusing a world that --seq-shards does not divide (JAX's make_mesh uses
    exactly data * seq devices). The device becomes the rank's."""
    import os

    import torch.distributed as dist

    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    if args.seq_shards < 1:
        raise SystemExit(f"error: --seq-shards must be >= 1, got {args.seq_shards}")
    world_env = int(os.environ.get("WORLD_SIZE", "1")) if multihost.torchrun_env() else 1
    if not (args.multihost or args.seq_shards > 1 or world_env > 1 or dist.is_initialized()):
        return None
    device = None
    if not dist.is_initialized():
        if not multihost.torchrun_env():
            raise SystemExit(f"error: --seq-shards {args.seq_shards} / --multihost need torchrun (its MASTER_ADDR, "
                             "MASTER_PORT, RANK and WORLD_SIZE are not set): launch under torchrun --nproc-per-node "
                             "data*seq")
        device = multihost.initialize(device_type=torch.device(args.device).type)
    world = dist.get_world_size()
    if world % args.seq_shards:
        raise SystemExit(f"error: --seq-shards {args.seq_shards} needs a world of data x {args.seq_shards} ranks, "
                         f"the world has {world}")
    mesh = make_mesh(data=world // args.seq_shards, seq=args.seq_shards, device=device)
    args.device = str(mesh.device)
    return mesh


def data_rows(batches, mesh):
    """The rows of this rank's data index of each global batch: (B, ...)
    arrays and lists split evenly over the data axis (every rank keeps all
    of a clip's frames; the trainer keeps its seq frames)."""
    if mesh is None or mesh.data == 1:
        yield from batches
        return
    d = mesh.coords()[0]
    for batch in batches:
        out = {}
        for k, v in batch.items():
            n = len(v) // mesh.data
            out[k] = v[d * n:(d + 1) * n]
        yield out


def build_trainer(args, raw_videos=None, validation=False, mesh=None):
    """(trainer, data iterator, UNet config) from the parsed flags.
    `raw_videos`: decoded batches {video (B,T,H,W,3) in [-1, 1], txt} to
    encode in place of --data-shards / --data-csv (`raw_video_batches`).
    The trainer carries the frozen `vae` and `text_tower` it built (None
    where nothing needs one); `validation` builds both for
    `build_validation_fn`, from the same weights. `mesh`: the rank's mesh
    (default: `make_train_mesh`'s from the flags)."""
    from ..config import vc2_spec
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from ..io.convert import load_checkpoint, split_vc2_checkpoint
    from ..models import UNetConfig, UNetModel, cast_compute_dtype_, seeded_init_
    from ..training.lcd import LCDConfig
    from ..training.optim import make_optimizer
    from ..training.trainer import LCDTrainer, TrainerConfig

    if args.lora_rank <= 0:
        raise SystemExit("error: --lora-rank must be positive (full fine-tuning is v2's)")
    if mesh is None:
        mesh = make_train_mesh(args)
    else:
        args.device = str(mesh.device)
    device = torch.device(args.device)
    if args.tiny_model:
        ucfg = UNetConfig(**TINY_UNET_KW)
        shape = DataShape(4, 4, (8, 8), 7, ucfg.context_dim)
    else:
        ucfg = vc2_spec().unet
        shape = DataShape(args.batch_size, args.n_frames, (args.height // 8, args.width // 8),
                          77, ucfg.context_dim)
    if shape.frames % args.seq_shards:
        raise SystemExit(f"error: {shape.frames} frames do not split over --seq-shards {args.seq_shards}")
    if raw_videos is None and not args.synthetic_data:
        # the decoder loads here, before the models are built: without it this raises
        raw_videos = raw_video_batches(args, shape.frames, shape.batch, mesh)
    wdim = ucfg.time_cond_proj_dim
    with torch.device(device):
        student = UNetModel(ucfg, use_remat=args.use_remat)
        teacher = UNetModel(dataclasses.replace(ucfg, time_cond_proj_dim=None))

    vae_sd = clip_sd = None
    if args.checkpoint:
        unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
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

    rewards = args.reward_fn != "none" or args.video_rm_fn != "none"
    # one frozen VAE encodes the data and decodes for the rewards
    vae = build_vae(args, device, dtype, vae_sd) if rewards or raw_videos is not None or validation else None
    text = None
    if validation or (raw_videos is not None and not args.tiny_model):
        text = build_text_tower(args, device, dtype, clip_sd)
    reward_fn, video_reward_fn, image_rm, video_rm = build_reward_stack(args, device, dtype, vae)
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
            grad_accum_steps=args.gradient_accumulation_steps, grads_bf16=args.grads_bf16, fsdp=args.fsdp,
        ),
        reward_fn=reward_fn,
        video_reward_fn=video_reward_fn,
        mesh=mesh,
    )
    trainer.vae, trainer.text_tower = vae, text
    # synthetic data: every rank draws the global batch (data x its batch) and keeps its rows
    parts = mesh.data if mesh is not None and raw_videos is None else 1
    data = make_data_iter(args, dataclasses.replace(shape, batch=shape.batch * parts), raw_videos, vae, text)
    if image_rm is not None or video_rm is not None:
        data = add_reward_fields(data, args, shape.frames, shape.batch * parts, image_rm, video_rm)
    if parts > 1:
        data = data_rows(data, mesh)
    return trainer, data, ucfg


def build_vae(args, device, dtype, vae_sd=None):
    """The frozen VAE (eval, `dtype` but its norms): `vae_sd` (the
    --checkpoint's) loaded, else seeded random weights; the JAX CLI's tiny
    VAE with --tiny-model."""
    from ..models import AutoencoderKL, VAEConfig, cast_compute_dtype_, seeded_init_

    with torch.device(device):
        vae = AutoencoderKL(VAEConfig(**TINY_VAE_KW) if args.tiny_model else VAEConfig())
    if vae_sd is not None:
        vae.load_state_dict(vae_sd, strict=True)
    else:
        seeded_init_(vae, args.seed + 2_000_000)
    return cast_compute_dtype_(vae, dtype).requires_grad_(False).eval()


def build_text_tower(args, device, dtype, clip_sd=None):
    """The frozen OpenCLIP ViT-H text tower of VC2: `clip_sd` (the
    --checkpoint's) loaded, else seeded random weights; with --tiny-model a
    small seeded tower at the tiny UNet's context width (for validation
    renders: the tiny data path takes `hashed_context`)."""
    from ..config import vc2_spec
    from ..io.convert import load_clip_text
    from ..models import CLIPTextConfig, CLIPTextModel, cast_compute_dtype_, seeded_init_

    with torch.device(device):
        text = CLIPTextModel(CLIPTextConfig(**TINY_PROMPT_TEXT_KW) if args.tiny_model else vc2_spec().text)
    if clip_sd is not None:
        load_clip_text(text, clip_sd)
    else:
        seeded_init_(text, args.seed + 5_000_000)
    return cast_compute_dtype_(text, dtype).requires_grad_(False).eval()


def build_reward_stack(args, device, dtype, vae):
    """(reward_fn, video_reward_fn, image reward model, video reward model)
    from the reward flags; Nones when both are "none". The reward VAE is
    `vae` (`build_vae`'s); the towers load --reward-ckpt /
    --video-rm-ckpt, else seeded random weights. All are frozen, in `dtype`
    but their norms."""
    from ..models import cast_compute_dtype_
    from ..training.reward_adapters import make_reward_fns

    if args.reward_fn == "none" and args.video_rm_fn == "none":
        return None, None, None, None
    image_rm = build_image_reward(args, device) if args.reward_fn != "none" else None
    video_rm = build_video_reward(args, device) if args.video_rm_fn != "none" else None
    for m in (image_rm, video_rm):
        if m is not None:
            cast_compute_dtype_(m, dtype).requires_grad_(False).eval()
    rf, vrf = make_reward_fns(vae, image_rm, video_rm,
                              decode_chunk=args.vae_decode_batch_size or None)
    return rf, vrf, image_rm, video_rm


def _bert_tokenizer(args, max_length: int, ckpt):
    """--bert-vocab's wordpiece tokenizer, or None: the rewards' hash
    stand-in, sound only with seeded weights, so a tower loading `ckpt`
    without --bert-vocab is refused."""
    from ..utils.bert_tokenizer import BertWordPieceTokenizer

    if ckpt and not args.bert_vocab:
        raise SystemExit(f"error: {ckpt} holds a BERT text tower; pass its --bert-vocab (vocab.txt)")
    return BertWordPieceTokenizer(args.bert_vocab, max_length=max_length) if args.bert_vocab else None


def build_image_reward(args, device):
    """--reward-fn's model (f32, seeded unless --reward-ckpt): the ViT-H/14
    CLIP reward, or for img_reward ImageReward behind `BlipTrainReward`."""
    from ..io.convert import load_checkpoint
    from ..models import CLIPTextConfig
    from ..rewards import reward_fn as R
    from ..rewards.vit import ViTConfig

    tokenizer = _bert_tokenizer(args, 35, args.reward_ckpt) if args.reward_fn == "img_reward" else None
    sd = load_checkpoint(args.reward_ckpt) if args.reward_ckpt else None
    seed = args.seed + 3_000_000
    if args.reward_fn == "img_reward":
        from ..rewards.blip import BertConfig, BlipViTConfig, build_image_reward_blip

        kw = dict(vit_cfg=BlipViTConfig(**TINY_BLIP_VIT_KW), bert_cfg=BertConfig(**TINY_BERT_KW),
                  head_dims=(8, 1)) if args.tiny_model else {}
        return R.BlipTrainReward(build_image_reward_blip(sd, seed=seed, device=device, **kw), tokenizer=tokenizer)
    kw = dict(vit_cfg=ViTConfig(**TINY_VIT_KW), text_cfg=CLIPTextConfig(**TINY_REWARD_TEXT_KW)) \
        if args.tiny_model else {}
    return R.build_image_reward_model(sd, seed=seed, device=device, **kw)


def build_video_reward(args, device):
    """--video-rm-fn's model (f32, seeded unless --video-rm-ckpt): ViCLIP-L,
    or for vi_clip2 InternVideo2 behind `InternVideo2TrainReward`, its
    blocks recomputed in the backward with --use-remat."""
    from ..io.convert import load_checkpoint
    from ..models import CLIPTextConfig
    from ..rewards import reward_fn as R
    from ..rewards.vit import VideoViTConfig

    tokenizer = _bert_tokenizer(args, 40, args.video_rm_ckpt) if args.video_rm_fn == "vi_clip2" else None
    sd = load_checkpoint(args.video_rm_ckpt) if args.video_rm_ckpt else None
    seed = args.seed + 4_000_000
    if args.video_rm_fn == "vi_clip2":
        from ..rewards.blip import BertConfig
        from ..rewards.internvideo2 import IV2VisionConfig, build_internvideo2_reward

        kw = dict(vision_cfg=IV2VisionConfig(**TINY_IV2_KW), embed_dim=16,
                  text_cfg=BertConfig(**{**TINY_BERT_KW, "cross_attention": False})) if args.tiny_model else {}
        rm = build_internvideo2_reward(sd, seed=seed, device=device, remat=args.use_remat, **kw)
        return R.InternVideo2TrainReward(rm, tokenizer=tokenizer, image_size=rm.vision_encoder.cfg.img_size)
    kw = dict(vit_cfg=VideoViTConfig(**TINY_VIT_KW, num_frames=8), text_cfg=CLIPTextConfig(**TINY_REWARD_TEXT_KW)) \
        if args.tiny_model else {}
    return R.build_video_reward_model(sd, seed=seed, device=device, **kw)


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


def make_data_iter(args, shape: DataShape, raw_videos=None, vae=None, text=None):
    """The trainer's batches {latents, ctx, uncond_ctx, fps, _texts}: random
    ones with --synthetic-data, else `raw_videos` (`raw_video_batches`)
    encoded by `vae` (`build_vae`) on its device, with the captions'
    context from the text tower (`text`, else a seeded `build_text_tower`;
    the empty prompt's once), or with --tiny-model from `hashed_context`
    and zeros (the JAX CLI's `make_data_iter`)."""
    from ..config import vc2_spec
    from ..models.layers import compute_dtype

    if raw_videos is None:
        return synthetic_data(shape, args.fps)
    scale_factor = vc2_spec().scale_factor  # the tiny VAE's latents too, as the JAX CLI's
    if args.tiny_model:
        embed = functools.partial(hashed_context, ctx_len=shape.ctx_len, ctx_dim=shape.ctx_dim)
        uncond = torch.zeros(1, shape.ctx_len, shape.ctx_dim)
    else:
        if text is None:
            text = build_text_tower(args, next(vae.parameters()).device, compute_dtype(vae))
        embed = text_embedder(text)
        with torch.no_grad():
            uncond = embed([""])  # once; repeated over each batch
    return encode_batches(raw_videos, vae, embed, uncond, args.fps, scale_factor)


def raw_video_batches(args, frames: int, b: int, mesh=None):
    """Decoded video batches {video (B,T,H,W,3) f32 in [-1, 1], txt} from
    --data-shards (WebVideoDataset, with --prefix-weights as its mixture)
    or --data-csv (MP4Dataset): the JAX CLI's `_make_raw_video_iter`. The
    dataset loads the native decoder here, and raises if it cannot. Over a
    `mesh` each data index reads its own shards (or every data-th batch of
    the CSV), the seq ranks of one data index the same clips."""
    import itertools

    from ..data.datasets import MP4Dataset, read_csv_index
    from ..data.webdata import WebVideoDataset

    size_hw = (args.height, args.width)
    if args.data_shards:
        prefix_weights = None
        if args.prefix_weights:
            prefix_weights = {k: float(v) for k, v in (kv.split("=") for kv in args.prefix_weights.split(","))}
        return iter(WebVideoDataset(sorted(glob.glob(args.data_shards)), batch_size=b, n_frames=frames,
                                    size_hw=size_hw, prefix_weights=prefix_weights, mesh=mesh))
    if args.data_csv:
        ds = MP4Dataset(read_csv_index(args.data_csv), n_frames=frames, size_hw=size_hw)
        mine = ds.batches(b) if mesh is None else itertools.islice(ds.batches(b), mesh.coords()[0], None, mesh.data)
        return ({"video": d["video"], "txt": d["text"]} for d in mine)
    raise SystemExit("error: provide --data-shards, --data-csv or --synthetic-data")


def hashed_context(texts, ctx_len: int, ctx_dim: int):
    """--tiny-model's text context: a numpy N(0, 1) draw per caption seeded
    by its crc32 (never `hash()`, which is salted per process: a resumed run
    must see the same context for the same caption), as the JAX CLI's."""
    out = np.zeros((len(texts), ctx_len, ctx_dim), np.float32)
    for i, s in enumerate(texts):
        out[i] = np.random.RandomState(zlib.crc32(s.encode("utf-8"))).randn(ctx_len, ctx_dim)
    return torch.from_numpy(out)


def text_embedder(text):
    """captions -> the text tower's (B, 77, 1024) context, tokenised by the
    CLIP BPE tokenizer, on the tower's device."""
    from ..utils.tokenizer import CLIPTokenizer

    tok = CLIPTokenizer()
    device = next(text.parameters()).device
    return lambda texts: text(torch.from_numpy(tok(list(texts))).to(device))


def encode_batches(raw_iter, vae, embed, uncond_ctx, fps: float, scale_factor: float):
    """Raw batches {video (B,T,H,W,3) in [-1, 1], txt} -> the trainer's
    {latents (B,T,h,w,4) = encode(video)[0] * scale_factor over the B*T
    frames, ctx = embed(txt), uncond_ctx = `uncond_ctx` (1, L, D) repeated,
    fps, _texts}, in f32 on the VAE's device. Runs under no_grad (not
    inference_mode: the LCD step saves these tensors for its backward)."""
    from ..models.vae import encode_video

    device = next(vae.parameters()).device
    for batch in raw_iter:
        texts = list(batch["txt"])
        with torch.no_grad():
            video = torch.as_tensor(batch["video"]).to(device)
            latents = encode_video(vae, video, scale_factor=scale_factor).float()
            ctx = embed(texts).float().to(device)
        b = latents.shape[0]
        yield {"latents": latents, "ctx": ctx, "uncond_ctx": uncond_ctx.float().to(device).repeat(b, 1, 1),
               "fps": torch.full((b,), float(fps), device=device), "_texts": texts}


def build_validation_fn(args, trainer, max_prompts=None, step_counts=(8, 16), suffix=".mp4"):
    """`trainer.run`'s validation_fn: the student renders the validation
    prompts (training/validation.py) through a T2VTurboVC2Pipeline at the
    training clip's frames and size, with the trainer's own frozen VAE and
    text tower (`build_trainer(..., validation=True)`), into `suffix` files
    (.mp4 needs ffmpeg; .npy holds the uint8 frames). Over the trainer's
    mesh every rank renders (each data index on its own seq ranks) and rank
    0 writes."""
    from ..config import vc2_spec
    from ..models.layers import compute_dtype
    from ..parallel.mesh import seq_submesh
    from ..pipelines.vc2 import T2VTurboVC2Pipeline
    from ..training.validation import make_validation_logger
    from ..utils.tokenizer import CLIPTokenizer

    vae, text = trainer.vae, trainer.text_tower
    if vae is None or text is None:
        raise ValueError("validation renders need the trainer of build_trainer(..., validation=True)")
    spec, device, dtype = vc2_spec(), trainer.device, compute_dtype(vae)
    if args.tiny_model:
        frames, (height, width), vae_scale = 4, (16, 16), 2
    else:
        frames, height, width, vae_scale = args.n_frames, args.height, args.width, 8
    # over a mesh each data index renders every prompt on its seq ranks; rank 0 writes
    mesh = None if trainer.mesh is None else seq_submesh(trainer.mesh)
    pipe = T2VTurboVC2Pipeline(unet=trainer.student, vae=vae, text_model=text, tokenizer=CLIPTokenizer(),
                               schedule=spec.make_schedule(), device=device, scale_factor=spec.scale_factor,
                               vae_scale=vae_scale, w_embedding_dim=trainer.lcd_cfg.w_embedding_dim, dtype=dtype,
                               mesh=mesh)
    return make_validation_logger(pipe, args.output_dir, step_counts=step_counts, frames=frames, height=height,
                                  width=width, max_prompts=max_prompts, suffix=suffix, write=trainer.is_main)


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
    if trainer.is_main:
        print(f"final metrics: {metrics}")
        for path in export_lora(trainer, ucfg, args.output_dir):
            print(path)


if __name__ == "__main__":
    main()
