"""CLI: T2V-Turbo-v2 full-model latent consistency training with the
PyTorch port (the reference's train_latent_t2v_turbo_v2.py; port of
t2v_turbo_tpu/apps/train_v2.py).

Usage (smoke mode: seeded random weights, on apps/preprocess.py's pickles):
  python -m t2v_turbo_tpu_torch.apps.preprocess --random-weights --synthetic-data \\
      --num-samples 8 --output-dir runs/v2_latents
  python -m t2v_turbo_tpu_torch.apps.train_v2 --random-weights \\
      --latent-glob 'runs/v2_latents/*.pkl' --max-steps 4 --use-motion-cond \\
      --use-target-unet --temporal-lr 1e-5 --use-remat \\
      [--reward-fn hpsv2 --reward-scale 0.2 --video-rm-fn vi_clip --video-reward-scale 0.5]
The recipe (train_t2v_turbo_v2.sh): batch 3, adamw8bit at 1e-5 (the
temporal modules at --temporal-lr), the EMA target network at decay 0.95,
motion guidance 0.05 in the top 30% of the grid, the motion embedding fed
to the student, rewards decoded 16 frames a chunk.

The student is the whole VC2 UNet (from --checkpoint, with a zero
time_cond_proj where it has none; --use-motion-cond needs a checkpoint
holding motion_cond_proj and combine_proj), held as an f32 master and run
in bf16 on the card (training/trainer.py's full-model mode); the teacher
never runs: its outputs are in the pickles (`MP4LatentDataset`). Reward
feedback uses the reward stack of apps/train_v1.py with the reference's v2
choice of samples (`add_v2_reward_fields`). At the end `unet.pt` and, with
--use-target-unet, `target_unet.pt` (the EMA network) are written in the
reference's layout, f32, for apps/generate.py --unet-ckpt.

--train-text-encoder trains the text tower beside the UNet (the reference
:816-830, 989-992): each batch's captions are tokenised on the host and
re-encoded by the tower at every step; only the last --unlocked-text-layers
blocks of the reference's full tower (the penultimate tower runs one fewer,
so one fewer trains) and ln_final move, in an optimizer group at the base
rate (optim.v2_param_label); the EMA target covers the UNet alone. The
trained tower is written as text_encoder.npz with the JAX CLI's keys,
shapes and dtypes (io/convert.py::clip_text_to_jax), so either package
reads it.

Over a (data, seq) mesh of torch.distributed ranks (JAX's --seq-shards,
--fsdp and --multihost, apps/train_v2.py:46-54, :172-176, :376): under
torchrun every rank runs this CLI; --seq-shards N splits each clip's
frames over N ranks and the batch over the data axis, the world divided
by N (a world that N does not divide, or pickles whose frames it does not
divide, is refused). --batch-size is a data rank's: each data rank takes
its rows of the one-process run's batches, and the seq ranks of one data
index read the same rows, each keeping its frames of the stored z_t,
teacher outputs and motion score (the loss reads the preprocess's score:
nothing is captured at train time). --fsdp keeps on each data rank only
its slices of the f32 master, the moments and the EMA (training/
trainer.py, parallel/fsdp.py). Rank 0 writes the metrics, the checkpoints
and the exports; a checkpoint resumes on any world size.
  torchrun --nproc-per-node 4 -m t2v_turbo_tpu_torch.apps.train_v2 --tiny-model --device cpu \
      --random-weights --latent-glob 'runs/v2_latents/*.pkl' --max-steps 2 --seq-shards 2 --fsdp
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import sys

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo v2 latent trainer (PyTorch port)")
    p.add_argument("--checkpoint", default=None, help="VideoCrafter2 model.ckpt (its UNet starts the student)")
    p.add_argument("--random-weights", action="store_true", help="seeded random weights (smoke mode)")
    p.add_argument("--tiny-model", action="store_true", help="small UNet (tests / smoke)")
    p.add_argument("--latent-glob", required=True, help="glob of apps/preprocess.py pickles")
    p.add_argument("--output-dir", default="runs/v2")
    p.add_argument("--max-steps", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=3)
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--temporal-lr", type=float, default=None,
                   help="learning rate of init_attn and the temporal transformers (default: --learning-rate)")
    p.add_argument("--optimizer", default="adamw8bit", choices=["adamw", "adamw_bf16", "adamw8bit"])
    p.add_argument("--use-target-unet", action="store_true", help="the EMA target network")
    p.add_argument("--ema-decay", type=float, default=0.95)
    p.add_argument("--motion-gs", type=float, default=0.05)
    p.add_argument("--percentage", type=float, default=0.3)
    p.add_argument("--use-motion-cond", action="store_true", help="feed the motion-guidance embedding to the UNet")
    p.add_argument("--num-ddim-timesteps", type=int, default=50)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1,
                   help="average grads over K micro-batches per update")
    p.add_argument("--checkpointing-steps", type=int, default=2000)
    p.add_argument("--checkpoints-total-limit", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use-remat", action="store_true",
                   help="recompute each block's activations in the backward (the UNet's, and "
                        "InternVideo2's with --video-rm-fn vi_clip2)")
    p.add_argument("--grads-bf16", action="store_true", help="the gradient buffer in bf16 (the norm in f32)")
    p.add_argument("--train-text-encoder", action="store_true",
                   help="re-encode captions every step and train the last text blocks and ln_final")
    p.add_argument("--unlocked-text-layers", type=int, default=4,
                   help="blocks of the reference's full text tower that train (counted from its end)")
    p.add_argument("--device", default="cuda:0",
                   help="this process's device; under torchrun the rank's card (cuda:LOCAL_RANK), or cpu")
    p.add_argument("--fsdp", action="store_true",
                   help="shard the f32 master, the optimizer state and the EMA over the data axis (ZeRO)")
    p.add_argument("--multihost", action="store_true",
                   help="join torchrun's torch.distributed world (implied by a torchrun world of more than one rank)")
    p.add_argument("--seq-shards", type=int, default=1,
                   help="mesh seq axis: the frames of a clip over ranks (the data axis is the world over it)")
    # reward feedback (the reference's --reward_fn_name / --video_rm_name ..., :507-573, 1068-1162)
    p.add_argument("--reward-fn", default="none", choices=["none", "clip", "hpsv2", "pick", "img_reward"])
    p.add_argument("--reward-ckpt", default=None,
                   help="image reward state dict: open_clip or HF CLIPModel, or ImageReward's for img_reward")
    p.add_argument("--bert-vocab", default=None, help="BERT vocab.txt for the img_reward / vi_clip2 text towers")
    p.add_argument("--reward-scale", type=float, default=1.0)
    p.add_argument("--reward-frames", type=int, default=2, help="frames scored per selected sample")
    p.add_argument("--reward-batch", type=int, default=2, help="samples per batch carrying the image reward")
    p.add_argument("--video-rm-fn", default="none", choices=["none", "vi_clip", "vi_clip2"])
    p.add_argument("--video-rm-ckpt", default=None,
                   help="video reward state dict: ViCLIP's, or InternVideo2-Stage2's for vi_clip2")
    p.add_argument("--video-reward-scale", type=float, default=1.0)
    p.add_argument("--video-rm-frames", type=int, default=8, help="strided frames per scored sample")
    p.add_argument("--video-rm-batch", type=int, default=1, help="samples per batch carrying the video reward")
    p.add_argument("--vae-decode-batch-size", type=int, default=16,
                   help="frames decoded per checkpointed VAE chunk in the reward losses; 0 = one call")
    p.add_argument("--webvid-no-reward", action="store_true",
                   help="no reward losses on batches without short captions (the reference's "
                        "'webvid' opt-out, :1086-1090)")
    return p.parse_args(argv)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def add_v2_reward_fields(base_iter, args, image_rm, video_rm):
    """Batches with the reward fields, chosen as the reference's v2 does
    (train_latent_t2v_turbo_v2.py:1068-1162; the JAX CLI's numpy draws):
    - when any sample has a short caption, only those samples carry the
      reward losses, and the image reward scores them against the short
      caption (:1077-1100);
    - otherwise random samples with their full captions, unless
      --webvid-no-reward, which turns the losses off for the batch;
    - the video reward scores the full captions (:1157)."""
    from ..training.reward_adapters import precompute_text_feats, sample_frame_indices

    rng = np.random.RandomState(args.seed % (2**31 - 1))
    for batch in base_iter:
        b, frames = batch["z_t"].shape[:2]
        txt = list(batch.get("txt") or [""] * b)
        short = list(batch.get("short_txt") or [""] * b)
        has_short = np.array([s != "" for s in short])

        def choose(n_sel):
            if has_short.any():
                return rng.permutation(np.flatnonzero(has_short))[:n_sel]
            if args.webvid_no_reward:
                return np.array([], np.int64)
            return rng.permutation(b)[:n_sel]

        if image_rm is not None:
            batch["reward_frame_idx"] = sample_frame_indices(rng, b, frames, min(args.reward_frames, frames))
            sel_txt = [short[i] if short[i] else txt[i] for i in range(b)]
            batch["reward_text_feats"] = _host(precompute_text_feats(image_rm, sel_txt))
            mask = np.zeros((b,), np.float32)
            mask[choose(args.reward_batch)] = 1.0
            batch["reward_mask"] = mask
        if video_rm is not None:
            batch["video_frame_idx"] = sample_frame_indices(rng, b, frames, min(args.video_rm_frames, frames),
                                                            strided=True)
            batch["video_text_feats"] = _host(precompute_text_feats(video_rm, txt))
            mask = np.zeros((b,), np.float32)
            mask[choose(args.video_rm_batch)] = 1.0
            batch["video_reward_mask"] = mask
        yield batch


def build_text_encoder(args, device, ctx_len: int, clip_sd=None):
    """--train-text-encoder's tower, f32 (the trainer's master): the VC2
    penultimate ViT-H tower (the --checkpoint's, else seeded), or with
    --tiny-model JAX's tiny tower at the pickles' context length (width
    16, 3 blocks, 2 run)."""
    from ..config import vc2_spec
    from ..io.convert import load_clip_text
    from ..models import CLIPTextConfig, CLIPTextModel, seeded_init_

    tcfg = CLIPTextConfig(width=16, heads=4, layers=3, context_length=ctx_len) if args.tiny_model \
        else vc2_spec().text
    with torch.device(device):
        text = CLIPTextModel(tcfg)
    if clip_sd is not None:
        load_clip_text(text, clip_sd)
    else:
        seeded_init_(text, args.seed + 5_000_000)
    return text


def build_trainer(args, mesh=None):
    """(trainer, data iterator, UNet config) from the parsed flags; `mesh`:
    the rank's mesh (default: the flags', data = world / --seq-shards)."""
    from ..config import vc2_spec
    from ..data.datasets import MP4LatentDataset
    from ..diffusion import DDIMSolver, DiffusionSchedule
    from ..io.convert import load_checkpoint, split_vc2_checkpoint, student_unet_state_dict
    from ..models import UNetConfig, UNetModel, seeded_init_
    from ..training import lcd_v2
    from ..training.optim import make_v2_optimizer, v2_param_label
    from ..training.trainer import LCDTrainer, TrainerConfig
    from .train_v1 import TINY_UNET_KW, build_reward_stack, build_vae, make_train_mesh

    paths = sorted(glob.glob(args.latent_glob))
    if not paths:
        raise SystemExit(f"error: no latent pickles match {args.latent_glob}")
    ds = MP4LatentDataset(paths, seed=args.seed)
    seq = args.seq_shards if mesh is None else mesh.seq
    frames = ds[0]["z_t"].shape[0]
    if seq > 1 and frames % seq:
        raise SystemExit(f"error: {frames} frames do not split over --seq-shards {seq}")
    if mesh is None:
        mesh = make_train_mesh(args)
    else:
        args.device = str(mesh.device)
    device = torch.device(args.device)
    if args.tiny_model:
        ucfg = UNetConfig(**TINY_UNET_KW, motion_cond_proj_dim=8 if args.use_motion_cond else None)
    else:
        ucfg = vc2_spec(motion_cond=args.use_motion_cond).unet
    with torch.device(device):
        student = UNetModel(ucfg, use_remat=args.use_remat)  # f32: the trainer's master
    vae_sd = clip_sd = None
    if args.checkpoint:
        unet_sd, vae_sd, clip_sd = split_vc2_checkpoint(load_checkpoint(args.checkpoint))
        student.load_state_dict(student_unet_state_dict(unet_sd, ucfg), strict=True)
    elif args.random_weights:
        seeded_init_(student, args.seed)
    else:
        print("error: provide --checkpoint or pass --random-weights", file=sys.stderr)
        sys.exit(2)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    rewards = args.reward_fn != "none" or args.video_rm_fn != "none"
    vae = build_vae(args, device, dtype, vae_sd) if rewards else None
    reward_fn, video_reward_fn, image_rm, video_rm = build_reward_stack(args, device, dtype, vae)
    text = tokenizer = None
    label = v2_param_label
    if args.train_text_encoder:
        from ..utils.tokenizer import CLIPTokenizer

        text = build_text_encoder(args, device, ds[0]["prompt_emb"].shape[0], clip_sd)
        tokenizer = CLIPTokenizer(context_length=text.cfg.context_length)
        label = functools.partial(v2_param_label, unlocked_text_layers=args.unlocked_text_layers,
                                  text_resblocks=text.cfg.layers_run)
    sched = DiffusionSchedule.create()
    trainer = LCDTrainer(
        student=student,
        sched=sched,
        solver=DDIMSolver.create(sched.alphas_cumprod.numpy(), ddim_timesteps=args.num_ddim_timesteps),
        lcd_cfg=lcd_v2.LCDV2Config(
            num_ddim_timesteps=args.num_ddim_timesteps, w_embedding_dim=ucfg.time_cond_proj_dim,
            motion_gs=args.motion_gs, percentage=args.percentage, use_motion_cond=args.use_motion_cond,
            reward_scale=args.reward_scale, video_reward_scale=args.video_reward_scale),
        optimizer=functools.partial(make_v2_optimizer, name=args.optimizer, learning_rate=args.learning_rate,
                                    temporal_learning_rate=args.temporal_lr),
        cfg=TrainerConfig(
            output_dir=args.output_dir, max_steps=args.max_steps, checkpoint_every=args.checkpointing_steps,
            keep_checkpoints=args.checkpoints_total_limit, log_every=1, seed=args.seed, lora_rank=None,
            grad_accum_steps=args.gradient_accumulation_steps,
            ema_decay=args.ema_decay if args.use_target_unet else None, grads_bf16=args.grads_bf16,
            fsdp=args.fsdp),
        reward_fn=reward_fn,
        video_reward_fn=video_reward_fn,
        loss_fn=lcd_v2.trainer_loss,
        draws_fn=lcd_v2.trainer_draws,
        param_label=label,
        text_encoder=text,
        mesh=mesh,
    )
    part = (0, 1) if trainer.mesh is None else (trainer.mesh.coords()[0], trainer.mesh.data)
    return trainer, make_data_iter(args, ds, image_rm, video_rm, tokenizer, part), ucfg


def make_data_iter(args, ds, image_rm=None, video_rm=None, tokenizer=None, part=(0, 1)):
    """The trainer's batches: the dataset's (this data rank's `part` of the
    global batch: the seq ranks of a data index read the same rows, and the
    trainer keeps each rank's frames), with the reward fields, drawn on the
    whole clips, when a reward model is given and, with a `tokenizer`
    (--train-text-encoder), the captions' `tokens`; the captions stay on
    the host."""
    base = ds.batches(args.batch_size, part=part)
    if image_rm is not None or video_rm is not None:
        base = add_v2_reward_fields(base, args, image_rm, video_rm)
    for batch in base:
        txt = batch.pop("txt", None)
        batch.pop("short_txt", None)
        if tokenizer is not None:
            batch["tokens"] = tokenizer(list(txt) if txt is not None else [""] * batch["z_t"].shape[0])
        yield batch


def export_unets(trainer, output_dir: str):
    """Write unet.pt (the trained student), with the EMA target network
    target_unet.pt, and with a trained text encoder text_encoder.npz (the
    JAX CLI's layout); returns their paths. Every rank calls it (with
    --fsdp the weights are gathered); rank 0 writes (the others return [])."""
    from ..io.convert import clip_text_to_jax, save_unet

    out = [("unet.pt", trainer.export_student_params())]
    if trainer.ema is not None:
        out.append(("target_unet.pt", trainer.export_target_params()))
    if trainer.text_encoder is not None:
        out.append(("text_encoder.npz", trainer.text_state_dict()))
    if not trainer.is_main:
        return []
    paths = []
    for name, sd in out:
        path = os.path.join(output_dir, name)
        if name.endswith(".npz"):
            np.savez(path, **clip_text_to_jax(sd))
        else:
            save_unet(sd, path)
        paths.append(path)
    return paths


def main(argv=None):
    args = parse_args(argv)
    trainer, data, _ = build_trainer(args)
    metrics = trainer.run(data)
    paths = export_unets(trainer, args.output_dir)
    if trainer.is_main:
        print(f"final metrics: {metrics}")
        for path in paths:
            print(path)


if __name__ == "__main__":
    main()
