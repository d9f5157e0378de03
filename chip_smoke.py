#!/usr/bin/env python3
"""Smoke test of the PyTorch port (t2v_turbo_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases; the script exits non-zero, without the final result line, if any fails:
  1. device:    a CUDA device must exist; prints the card's name and power limit.
  2. build:     compiles the hand-written kernels from csrc/ with nvcc.
  3. kernels:   each kernel against its plain PyTorch version on the card, at the
                main path's and the training paths' shapes (ViCLIP's and the
                VAE decoder's head of 512 included), with the stated
                tolerance, from one table of cases; bf16 flash attention (the
                forward's and the forward-with-lse's output, and the gradients
                through the autograd function), the fused GroupNorm+SiLU+conv
                and the short-sequence attention, and their plain versions,
                also against f64 math; times kernel, plain and each PyTorch
                library call computing the same function (for attention every
                fused SDPA backend that takes the inputs; for the fused conv
                the unfused GroupNorm+SiLU and cuDNN conv; the fastest is
                recorded; a yardstick only) with CUDA events, beside the
                card's bound; B1's time is logged beside the short-sequence
                kernel's. B1 and B2 run at every bf16 head-dim-64 forward
                shape of the paths (apps/time_flash.py's FWD_SHAPES), and at
                head dim 512 at the VAE mid block's shapes and tile edges.
                Each flash case also checks its route (wgmma for aligned
                bf16 forwards and backwards at head dims 64 and 512, staged
                for a head-dim-64 forward on unaligned views or at a scale
                <= 0, packed for the other unaligned views (the backward, the
                head-dim-512 forward, also at a scale <= 0), f32), and at L0 and at the VAE mid block two launches of
                each flash forward must give equal bits (of B3 at L0 and at
                the video reward's VAE mid block); B3 at head dim 512 also
                runs at its tiles' edges (ragged, 129, 65 and 40 keys);
                first, the wgmma C entries must refuse an unaligned view
                and f32 at both head dims, and the forward a scale <= 0,
                and the staged entry f32, head dim 512, a head dimension
                that is not contiguous and a non-finite scale, the pack
                kernel f32 and a head dimension that is not contiguous,
                and the flash entries bf16 on the f32 route code (no
                fallback). The fused conv is also
                checked and timed at every distinct shape of a UNet step
                (15 spatial 3x3, 4 temporal (3,1)), each case on its route
                (wgmma for bf16, f32), and two launches at L0 must give
                equal bits. The norms: GroupNorm+SiLU (B4) at the UNet's,
                the whole clip's and the VAE decoder's shapes (the 256-
                channel full-resolution row and the reward decodes' 8 and
                5 frames included), in f32, on each route (cta, cluster
                (an f32 row beyond 16 blocks' shared memory among them),
                split for the whole clip, element-wise for a misaligned x
                or an odd spatial size); its statistics mode for B7 against
                group_stats and the affine fold, FiLM on and off; LayerNorm
                (B5) at the UNet's, the text tower's and the reward towers'
                widths in bf16, in f32 and element-wise; two launches of B4
                (cta, split, cluster) and of its statistics mode with equal
                bits. The short-sequence attention (B8) at every path
                shape (the temporal attention at levels 0-2 and init_attn,
                the middle block's temporal and spatial self-attention), at
                T = 13, 48, 64, in f32 (recorded as small_seq_attention_f32),
                each on its route (bulk for aligned views, element-wise for
                misaligned ones, in both dtypes), two launches with equal
                bits, and a launch captured in a CUDA graph against an eager
                one. B6: B1 and B2 on the staged route on misaligned views
                at (16,5,2560,2560,64) (flash_attention_staged and
                flash_attention_fwd_lse_staged), with equal bits to the
                wgmma route on contiguous copies at L0, at a ragged S and
                with 77 keys; with one of q, k, v misaligned; at scales
                -1/8 and 0 on aligned tensors; two launches with equal bits
                and a launch captured in a CUDA graph against an eager one.
                B6 on the packed route (the pack kernel's copies, then the
                wgmma kernels): B3's dK/dV and dQ on misaligned views at
                (16,5,2560,2560,64) and B1 at (16,1,2560,2560,512)
                (flash_attention_bwd_dkv_packed, _bwd_dq_packed,
                flash_attention_d512_packed), the pack alone on one L0
                tensor (pack_bshd, against contiguous() and its library
                time); equal bits to the wgmma route on contiguous copies
                of the backward at L0, (2,5,300,300,64), 77 keys, tile
                edges, (8,1,2560,2560,512) and (2,1,1111,1111,512) and of
                the D = 512 forward at (16,1,2560,2560,512) and
                (2,1,1111,1111,512); one of q, k, v, dO misaligned at a
                time; the D = 512 forward at scales -1/8 and 0; the pack
                against contiguous() at all 8 offsets in its three modes
                (as is, negated, zeros); two launches with equal bits and
                a packed backward captured in a CUDA graph.
                The reward towers of phase 7b: B2 and B3 at BLIP's ViT-L
                self-attention (5,16,197,197,64) and its BERT's
                cross-attention (5,12,35,197,64), B5 at BLIP's (985,1024)
                and (175,768, eps 1e-12) and InternVideo2's (2049,1408),
                (1,1408) and BERT-large (40,1024, eps 1e-12) rows.
                Full-model (v2) gradients: B7 (x, the GroupNorm affine,
                the conv weight and bias, the FiLM), B4 and B5 (x and both
                affines) through their autograd functions against the plain
                twins' autograd at one UNet L0 shape each, at the forward's
                bf16 bound.
                The norms' and B8's `ms` is
                back-to-back calls, as every kernel's (host time included:
                their calls are host-bound); their `graph_ms` the device
                time by CUDA-graph replay over enough input copies that the
                bytes come from device memory.
  4. main path: full-width VC2 (UNet 320/640/1280, VAE ch 128, ViT-H text tower
                with 23 of 24 blocks), seeded random weights, bf16, through
                apps/generate.py's build_pipeline and the pipeline call:
                3 prompts, 4 steps, 16 frames at 320x512, timed as plain calls.
                Checks every video and that each kernel launched during this
                run (B1 at head dim 512 once a video, in the VAE's mid block);
                logs the fused conv's and the flash forward's launches a
                UNet step by shape and fails unless every bf16 launch of
                either took the wgmma route, and the norms' launches by
                route and shape, failing unless every GroupNorm launch (and
                its statistics mode's) took cta or cluster and every
                LayerNorm launch the vector route; B8's launches by shape
                must be 35 a UNet pass at time_small_seq.SHAPES and all on
                the bulk route (phases 6, 7 and 8 check its route). Then one more
                video with each stage's forward timed (synchronised hooks),
                and one under torch.profiler (device time by kernel, the
                fused conv's, the flash forward's (the part at head dim 512
                apart), B8's and the norms' device time and the device's idle
                share, into chiprun_out/profile.txt).
  5. reference: a small pipeline (f32, 256x256, so flash attention still runs)
                on the card against the same weights on the CPU, where every
                kernel wrapper runs its plain version; every serving kernel
                must have launched on the card.
  6. training:  full-width v1 LoRA LCD training (a VC2 student with its
                256-d w-embedding input and a teacher, LoRA rank 64, batch 1 of
                16x40x64x4 latents and 77x1024 contexts, adamw8bit) built by
                apps/train_v1.py's builder with --random-weights and
                --synthetic-data: 1 warm-up and 3 timed steps; checks finite
                loss and grad_norm, that every LoRA factor moved and the frozen
                weights did not, and that every kernel of the path launched;
                one more step under torch.profiler (chiprun_out/profile_train.txt);
                every head-dim-64 flash launch (B1, B2, B3) must have taken
                the wgmma route (launches by route beside those by head dim;
                the forwards' also by shape), every fused conv launch the
                wgmma route, and the norms their staged and vector routes.
                Runs without --use-remat, with it only if that does not fit.
  7. training with rewards: the same training with --reward-fn hpsv2
                --video-rm-fn vi_clip: random ViT-H/14 (image reward, 5 random
                frames) and ViCLIP-L (video reward, 8 strided frames) towers
                and a VC2 VAE decoding those 13 frames with gradient; first
                checks that the reward terms alone give a finite gradient,
                non-zero in every LoRA up factor; then 1 warm-up and 3 timed
                steps with finite reward losses, launches a step by head dim
                (the D = 512 kernels at least twice a step, once in each
                decode, at batch 8 and at batch 5, each shape held to its
                plain twin in phase 3; every flash launch and every fused
                conv on wgmma), one profiled step (the flash backward's
                device ms with D = 512 apart;
                chiprun_out/profile_train_rewards.txt).
  7b. training with BLIP and InternVideo2: the same training with
                --reward-fn img_reward --video-rm-fn vi_clip2: ImageReward
                (BLIP ViT-L/16 at 224, BERT-base cross-attending to it, the
                published head; 5 random frames, all on the gradient path)
                and InternVideo2 (1408 wide, 40 blocks, heads of 88 on the
                plain attention, 8 strided frames at 224 = 2049 tokens;
                BERT-large text features once a batch), seeded; BLIP's token
                ids must reach the batch as int32; the reward terms' own
                gradient non-zero in every LoRA up factor; 1 warm-up and 3
                timed steps with finite reward losses, peak memory, the
                towers' B2/B3 and B5 launches a step by shape, every flash
                launch on wgmma (retried with --use-remat on running out of
                memory, which also recomputes InternVideo2's blocks); one
                profiled step (chiprun_out/profile_train_blip_iv2.txt); one
                render of training/validation.py's logger (the first
                prompt, 4 steps, .npy) equal to the bit to a direct pipeline
                call with the same weights and seed, the student's flags
                kept; then each tower at published width and 2 blocks, f32,
                card against CPU: score within 1e-4*max(1,|ref|), the
                gradient with respect to the frames within 1e-3 x its max.
  8. training on real data: apps/train_v1.py's real-data path at full width
                with seeded weights. The H100 host has no libav, so the phase
                starts at decoded frames: seeded uint8 clips of 16x360x640
                through the port's resize_crop (random crop, seeded) and
                normalize_video (apps/time_prefetch.py's decoded_clips),
                handed to build_trainer as its raw batches; its
                make_data_iter builds the text tower beside the trainer's
                VAE, and encode_batches has the VC2 VAE (bf16) encode 16
                frames at 320x512 in one call and the ViT-H tower embed the
                caption. The first batch: latents (1,16,40,64,4) and ctx
                (1,77,1024), finite; B1 at head dim 512 once an encode, on
                wgmma; every encoder GroupNorm on cta/cluster/split at a
                shape phase 3's table holds (it has a B4 case for each).
                Encode and text ms a batch. Then the full-width VAE's f32
                encode of 2 frames (TF32 off) on the card against the CPU,
                within 3e-4*max(1,|ref|). Then the trainer takes 4 steps
                through trainer.run, whose prefetcher encodes the next
                batches on its own thread: finite losses, every LoRA factor
                moved, frozen weights bitwise unchanged, every kernel of
                the path launched on its route, B1 at head dim 512 once an
                encode; s/step beside phase 6's, data_wait_frac and peak
                memory.
  9. training reference: one small f32 LCD step (heads of 64, so the flash
                kernels run) through the trainer's gradient path
                (LCDTrainer.loss_and_grads: the step's cached LoRA merge) on
                the card, with remat off and on, and with both rewards (the
                --tiny-model reward stack, decoding in checkpointed chunks),
                against the same weights, LoRA factors (non-zero ups) and
                draws on the CPU: loss, reward losses and every LoRA gradient.
 10. v2 generation: apps/generate.py's pipeline with a motion-conditioned
                v2 UNet (motion_cond_proj, combine_proj; seeded), 16 steps
                from an origin grid of 200, motion_gs 0.05 at the timesteps
                >= 700 (percentage 0.3), 3 prompts at 16x320x512: finite
                videos, s/video, peak memory, every flash and B7 launch on
                wgmma, B8 bulk at its 35 launches a UNet pass, no plain
                attention; the first prompt again at motion_gs 0 must differ;
                one more video profiled (chiprun_out/profile_v2_video.txt).
 11. v2 preprocess: apps/preprocess.py's job (build_job) at full width with a
                seeded teacher on synthetic latents: 4 samples (the last
                under torch.profiler: chiprun_out/profile_v2_preprocess.txt) with the
                motion prior and 1 without; the teacher's calls a sample
                counted (index + 4 with the prior: index + 1 inversion
                steps, the reference capture, the capture with gradient, the
                unconditional output; 2 without), scores finite and non-zero
                (zero without), the nine capture attentions plain (18 calls a
                sample), every flash launch on wgmma; the pickles read by
                MP4LatentDataset; s/sample and peak memory. Then a small f32
                UNet's motion_prior_score (41 inversion steps) on the card
                against the CPU.
 12. v2 training: apps/train_v2.py's build_trainer on those pickles at the
                recipe's point: batch 3 (else the largest batch that fits, said
                so), --use-remat, the motion embedding, the EMA target
                (decay 0.95), adamw8bit, the temporal group at 1e-5, HPSv2
                (0.2) and ViCLIP (0.5) rewards decoding 16 frames a chunk; 4
                steps: finite losses; after step 1 every UNet gradient
                (norm affines included) finite, those exactly zero counted;
                the EMA after each step equal to 0.95 EMA + 0.05 master (f32
                rounding, on a sample of elements); launches a step by
                kernel, every flash and B7 launch on wgmma; s/step, peak
                memory, one profiled step (chiprun_out/profile_train_v2.txt);
                unet.pt and target_unet.pt exported and loaded strictly into
                fresh UNets. Work files under build/chip_smoke_v2, removed.
 13-16. motion clone, inverse ddim, ModelScope, v2 text encoder:
                MotionClone and the DDIM inversion at full width,
                the MS backbone's launches by shape against a meta-device
                dry run (`ms_path_shapes`), text-encoder training.
 17. serving:   apps/serve.py at full width (VC2 16x320x512, bf16, 4 steps,
                seeded weights; `serve.build_server`, the server in a
                thread on 127.0.0.1): the three prompts POSTed (latency_s,
                request to written file, and the client's s/video), every
                launch of one video on its route; two concurrent POSTs,
                each equal to the bit to its sequential video; /healthz,
                /gallery, /videos/<name>. A 48-frame request with
                decode_frame_chunk=16: its launches by kernel and shape
                equal to `serving_48_shapes`' dry run (phase 3 holds that
                UNet's 63 shapes, checked only, as "(48 frames)"), peak
                memory, and the chunked decode of its latents against one
                decode of all 48 (<= 1e-2 on the [-1, 1] video). Then
                `warmup --export` (export_s and bytes a program) and the
                same three prompts served from the artifacts
                (`ArtifactPipeline.from_dir` with the live weights): each
                video equal to the live one to the bit, the launches of one
                video by kernel, route and shape equal to a live video's;
                the phase's wall time.
 18. image conditioning: image-conditioned VC2 at full width, bf16, seeded:
                ImageCondEncoder(finegrained) (ViT-H/14 at 224, 257 tokens ->
                the 4-deep Resampler's 16 tokens) on a 320x512 image,
                append_image_context (77 text rows repeated to 200, then
                the 16 tokens), the UNet with use_image_attention sampled by
                ddim_sample_loop (the "sampler" grid, 25 steps, CFG 7.5
                against the empty prompt with the same image tokens), the
                VAE's decode: s/video, peak memory, every launch by kernel
                and shape equal to `image_path_shapes`' dry run (B1 at 16
                and 200 keys), one profiled video
                (chiprun_out/profile_image_video.txt); then one UNet pass in
                coarse mode (ImageProjModel, 4 tokens: B1 at 4 keys).
 19. UNet switches: relative position and the causal mask in every
                temporal attention and the scale-shift norm in every
                ResBlock, sampled by p_sample_loop (10 ancestral steps, a
                generator): every out_layers conv through B7 with its FiLM,
                no B8 launch over the 16 frames (the plain path), every
                launch by shape equal to `switch_path_shapes`' dry run.
 20. x_transformer: TransformerWrapper at latent-diffusion's BERTEmbedder
                width (30522 tokens, 77 positions, 1280 wide, 32 layers),
                seeded, f32: the card's embeddings against the CPU's.
                Phase 3 holds every (kernel, shape) of phases 18-19's dry
                runs (`_lvdm_cases`: the plain twin, f64 where the kernel
                has such a check, the route, two launches with equal bits);
                B1 at 4, 16 and 200 keys and B7 / B4's statistics with the
                FiLM are recorded under their own names.
 21. sharded sampling: data- and sequence-parallel VC2 sampling at full
                width (16x320x512, seeded weights, generate's seed 0). This
                process computes the single-rank references (one f32 UNet
                pass with TF32 off; the bf16 4-step video of one prompt and
                of two, timed) and joins a world of one rank over NCCL (one
                all_reduce; the pipeline over that mesh equals the
                pipeline without one, video and launches by kernel, route
                and shape). Then 2 ranks spawned on the one card
                (torch.multiprocessing, spawn) over gloo with
                share_device=True (NCCL refuses two ranks on one device;
                gloo stages every collective through host memory): the f32
                UNet pass at (data, seq) = (1, 2) within 2e-4 of one
                process; the bf16 videos at (1, 2) (one prompt) and (2, 1)
                (two prompts), mean|d| <= 1e-2 against one rank; one
                `serve --seq-shards 2` request answered by rank 0, equal to
                the (1, 2) video to the bit. Each rank's launches of a
                timed video by kernel and shape equal `sharded_path_shapes`'
                dry run, on the paths' routes (B4's partials and apply, B7
                on given (a, b) at T / seq + 1 frames, B8 bulk at B*H*W / 2
                rows); s/video of (1, 1), (1, 2), (2, 1) and rank 0's
                collectives (calls, transport s, staged MiB) beside the
                card's name and power limit. Phase 3 holds every shape of
                that dry run (`_sharded_cases`: the four sequence-parallel
                entries recorded at each level, the rest checked).
 22. sharded training: v1 LoRA and v2 full-model training over the (data,
                seq) mesh at full width (16x320x512, the 77x1024 context,
                seeded weights, synthetic latents; apps/train_v1.py's and
                apps/train_v2.py's build_trainer with mesh=). The v1 runs
                use Adam's eps = 1 and lr 1e-3, so the factors after a step
                move by ~lr x the clipped gradient. This process takes two
                v1 steps at the global batches of 1 and of 2 (no remat),
                joins a world of one over NCCL (one v1 step over its mesh
                equal to the step without one to the bit, launches by
                kernel and shape included; a mesh of one is no mesh to the
                trainer, so no collective of the trainer runs there), the v1
                reference with the HPSv2 reward at a batch of 1 (remat, one
                step) and two v2 steps at a global batch of 2 (VC2's UNet at
                full depth, remat, EMA, adamw8bit). Then 2 ranks spawned on
                the one card over gloo, one clip a rank: two v1 steps at
                (1, 2) and at (2, 1) against one process at the global batch
                (the factors within 5e-2 of one process's largest move, the
                loss within 1e-2 and grad_norm within 2e-2 relative, the
                summed gradient's cosine to the reference's >= 0.999; bf16
                statistics and sums in another order), each rank's launches
                by kernel and shape equal to `sharded_training_shapes`' dry
                run; the HPSv2 run at (1, 2), one step, the same way but for
                the dry run (the towers are not in it); v2 --fsdp at
                (2, 1): two steps held to one process's (loss within 1e-2,
                grad_norm within 2e-2 relative), a checkpoint (gathered,
                one-process format, written by rank 0), a third step, then
                a fresh trainer on each rank resuming from the file and
                taking the third step again: equal to the uninterrupted one
                to the bit (torch.equal on the loss, grad_norm, master and
                EMA slices). Logged: s/step, each rank's peak memory against
                one process's, the collectives' calls, staged MiB and
                seconds. Phase 3 holds every shape of the v1 dry run
                (`_sharded_cases`).
`python3 chip_smoke.py --phases "v2 generation,v2 preprocess"` runs only the
named phases (after device and build), for development; with no argument
every phase runs.
The last lines of standard output are the card's name and power limit, the
kernels' JSON record and {"ok": true, "device": {...}}; the whole log is also
written to chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

import functools
import json
import os
from math import prod
import subprocess
import sys
import time
import traceback

# The smoke runs the port alone: importing JAX or the JAX package fails here.
for _name in ("jax", "flax", "t2v_turbo_tpu"):
    sys.modules.setdefault(_name, None)
HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out")
PROMPTS = (
    "An astronaut riding a horse on the moon",
    "A panda playing guitar in a bamboo forest, cinematic lighting",
    "Waves crashing against a lighthouse at sunset",
)
KERNELS = {
    "flash_attention": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                        "t2v_turbo_tpu/ops/attention.py:257"),
    "flash_attention_fwd_lse": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                "t2v_turbo_tpu/ops/attention.py:106"),
    "flash_attention_bwd_dkv": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                "t2v_turbo_tpu/ops/attention.py:157"),
    "flash_attention_bwd_dq": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                               "t2v_turbo_tpu/ops/attention.py:213"),
    # the same kernels at the VAE's one head of 512: B1 in the mid block when
    # serving, B2 and B3 in its decode with gradient (reward feedback)
    "flash_attention_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                             "t2v_turbo_tpu/ops/attention.py:257"),
    "flash_attention_fwd_lse_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                     "t2v_turbo_tpu/ops/attention.py:106"),
    "flash_attention_bwd_dkv_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                     "t2v_turbo_tpu/ops/attention.py:157"),
    "flash_attention_bwd_dq_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                    "t2v_turbo_tpu/ops/attention.py:213"),
    "group_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "layer_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:136"),
    # B4's statistics mode, for the fused conv (B7's GroupNorm statistics and
    # affine fold; the TPU path computed them with XLA around its kernel)
    "group_norm_stats": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "fused_gn_silu_conv": ("t2v_turbo_tpu_torch/csrc/fused_conv.cu", "t2v_turbo_tpu/ops/fused_conv.py:71"),
    "small_seq_attention": ("t2v_turbo_tpu_torch/csrc/small_seq_attention.cu",
                            "tests_tpu/bench_small_seq_attention.py:60"),
    # B8 in f32 (the card-vs-CPU phases' route; its launches are phase 5's)
    "small_seq_attention_f32": ("t2v_turbo_tpu_torch/csrc/small_seq_attention.cu",
                                "tests_tpu/bench_small_seq_attention.py:60"),
    # B6: B1 / B2 on misaligned (B, S, H, D) views, the staged route (no path
    # launches it: phases 4, 6, 7, 8 require wgmma; its launches are phase 4's, 0)
    "flash_attention_staged": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                               "t2v_turbo_tpu/ops/attention.py:540"),
    "flash_attention_fwd_lse_staged": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                       "t2v_turbo_tpu/ops/attention.py:813"),
    # B6 on the packed route: the backward at head dims 64 and 512 and the
    # forward at head dim 512 on misaligned views, the wgmma kernels on the
    # copies the pack kernel makes (no path launches them either), and the
    # pack kernel, which feeds all three
    "flash_attention_bwd_dkv_packed": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                       "t2v_turbo_tpu/ops/attention.py:590"),
    "flash_attention_bwd_dq_packed": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                      "t2v_turbo_tpu/ops/attention.py:644"),
    "flash_attention_d512_packed": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                                    "t2v_turbo_tpu/ops/attention.py:540"),
    "pack_bshd": ("t2v_turbo_tpu_torch/csrc/pack_bshd.cu", "t2v_turbo_tpu/ops/attention.py:590"),
    # B1 at the image-conditioned UNet's key lengths: the image branch's 4
    # (ImageProjModel) and 16 (Resampler) tokens, the text branch's 200 rows;
    # B7 and B4's statistics mode with the scale-shift ResBlock's FiLM
    "flash_attention_sk4": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                            "t2v_turbo_tpu/ops/attention.py:257"),
    "flash_attention_sk16": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                             "t2v_turbo_tpu/ops/attention.py:257"),
    "flash_attention_sk200": ("t2v_turbo_tpu_torch/csrc/flash_attention_sm90.cu",
                              "t2v_turbo_tpu/ops/attention.py:257"),
    "fused_gn_silu_conv_film": ("t2v_turbo_tpu_torch/csrc/fused_conv.cu", "t2v_turbo_tpu/ops/fused_conv.py:71"),
    "group_norm_stats_film": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    # sequence-parallel sampling (phase 21): B4's split route's two halves as
    # entries (a seq rank's chunk partials; the apply, and B7's (a, b), from
    # every rank's partials with their counts) and B7 on given (a, b) over
    # the halo-extended clip; their launches are phase 21's ranks'
    "group_norm_partials": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "group_norm_from_partials": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "group_norm_affine_from_partials": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "fused_gn_silu_conv_ab": ("t2v_turbo_tpu_torch/csrc/fused_conv.cu", "t2v_turbo_tpu/ops/fused_conv.py:71"),
}
SEQ_KERNELS = ("group_norm_partials", "group_norm_from_partials", "group_norm_affine_from_partials",
               "fused_gn_silu_conv_ab")
# (record, wrapper name): the packed records count their wrapper's launches
# on the packed route
PACKED_RECORDS = (("flash_attention_bwd_dkv_packed", "flash_attention_bwd_dkv"),
                  ("flash_attention_bwd_dq_packed", "flash_attention_bwd_dq"),
                  ("flash_attention_d512_packed", "flash_attention"))
SERVING_KERNELS = ("flash_attention", "group_norm", "group_norm_stats", "layer_norm", "fused_gn_silu_conv",
                   "small_seq_attention")
TRAIN_KERNELS = SERVING_KERNELS + ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                                   "flash_attention_bwd_dq")
D512_KERNELS = ("flash_attention_fwd_lse_d512", "flash_attention_bwd_dkv_d512",
                "flash_attention_bwd_dq_d512")  # on the rewards-ON training path
D512_SERVING = "flash_attention_d512"  # once a video, in the VAE's mid block
# The H100 SXM's published dense peaks (NVIDIA's H100 datasheet): bf16
# on tensor cores; f32 outside them (the f32 kernels are scalar FMAs).
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12


def wrappers():
    """Kernel name -> the wrapper whose `launches` counts its launches."""
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    return {"flash_attention": A.flash_attention, "flash_attention_fwd_lse": A.flash_attention_lse,
            "flash_attention_bwd_dkv": A.flash_attention_bwd_dkv,
            "flash_attention_bwd_dq": A.flash_attention_bwd_dq,
            "group_norm": N.fused_group_norm, "group_norm_stats": N.group_norm_affine_cuda,
            "layer_norm": N.fused_layer_norm,
            "fused_gn_silu_conv": FC.fused_gn_silu_conv, "small_seq_attention": A.small_seq_attention,
            "pack_bshd": A.pack_bshd, "group_norm_partials": N.group_norm_partials,
            "group_norm_from_partials": N.group_norm_from_partials,
            "group_norm_affine_from_partials": N.group_norm_affine_from_partials,
            "fused_gn_silu_conv_ab": FC.fused_gn_silu_conv_ab}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0
        for counts in ("by_head_dim", "by_route", "by_shape", "by_film_shape"):
            if hasattr(w, counts):
                getattr(w, counts).clear()


def read_launches():
    """Launches by kernel name; a `_d512` name counts its wrapper's
    launches at head dim 512 (also in the wrapper's own total)."""
    ws = wrappers()
    out = {n: w.launches for n, w in ws.items()}
    out.update({n: ws[n[:-len("_d512")]].by_head_dim[512] for n in D512_KERNELS + (D512_SERVING,)})
    return out


def launches_by_head_dim():
    """{wrapper: {head dim: launches}} of the four flash kernels."""
    return {n: dict(sorted(w.by_head_dim.items())) for n, w in wrappers().items() if hasattr(w, "by_head_dim")}


def check_flash_routes(what, passes, per):
    """Log the four flash kernels' launches by route beside those by head
    dim, and their launches by (B, H, Sq, Sk, D) shape over `passes`
    (UNet passes or training steps: `per` names them); raise unless every
    launch, forward and backward at head dims 64 and 512, went through wgmma
    (the path's bf16 tensors are TMA-aligned: no staged or packed launch,
    and no pack)."""
    from t2v_turbo_tpu_torch.ops import attention as A

    for w in (A.flash_attention, A.flash_attention_lse, A.flash_attention_bwd_dkv, A.flash_attention_bwd_dq):
        want = {"wgmma": w.launches} if w.launches else {}
        ok = dict(w.by_route) == want
        shapes = f"; a {per} by shape {dict((k, c / passes) for k, c in sorted(w.by_shape.items()))}"
        log(f"{what}: {w.__name__} launches by route {dict(w.by_route)}, by head dim "
            f"{dict(sorted(w.by_head_dim.items()))} (every launch on wgmma) {'OK' if ok else 'FAIL'}" + shapes)
        if not ok:
            raise AssertionError(f"{what}: {w.__name__} took routes {dict(w.by_route)}, expected {want}")
    log(f"{what}: pack_bshd launches {A.pack_bshd.launches} (none: no flash launch took staged or packed) "
        f"{'OK' if A.pack_bshd.launches == 0 else 'FAIL'}")
    if A.pack_bshd.launches:
        raise AssertionError(f"{what}: the pack kernel ran {A.pack_bshd.launches} times")


def check_small_seq(what, passes, per, shapes=True):
    """Log B8's launches by route and, a `per` over `passes`, by (R, T, H)
    shape; raise unless every launch took the bulk route (the paths' q, k, v
    are views of the Linears' outputs, which bulk copies read) and, with
    `shapes`, the launches a pass are time_small_seq.SHAPES' 35 (temporal
    attention at levels 0-2, init_attn, the middle block's temporal and
    spatial self-attention)."""
    from t2v_turbo_tpu_torch.apps.time_small_seq import SHAPES
    from t2v_turbo_tpu_torch.ops import attention as A

    w = A.small_seq_attention
    want = {shape: n * passes for shape, _, n in SHAPES}
    ok = dict(w.by_route) == {"bulk": w.launches} and (not shapes or dict(w.by_shape) == want)
    log(f"{what}: small_seq_attention launches {w.launches} by route {dict(w.by_route)} (all on bulk"
        + (f", {sum(want.values()) // passes} a {per} at time_small_seq.SHAPES" if shapes else "") + ") "
        f"{'OK' if ok else 'FAIL'}; a {per} by shape {dict((k, c / passes) for k, c in sorted(w.by_shape.items()))}")
    if not ok:
        raise AssertionError(f"{what}: small_seq_attention routes {dict(w.by_route)}, shapes {dict(w.by_shape)}")


def small_seq_device_ms(events):
    """B8's device ms in profiler events."""
    return sum(e.self_device_time_total for e in events if "small_seq_kernel" in e.key) / 1e3


def flash_device_ms(events):
    """(forward, backward, the forward at head dim 512, the backward at head
    dim 512) device ms of the flash kernels in profiler events (at D = 512
    the wgmma kernels `flash_fwd_d512_...` and `flash_bwd_d512_...`, or the
    f32 templates' `<512, ...>` instances)."""
    def ms(kind, d512=False):
        return sum(e.self_device_time_total for e in events if kind in e.key
                   and (not d512 or "d512" in e.key or "<512" in e.key)) / 1e3
    return ms("flash_fwd"), ms("flash_bwd"), ms("flash_fwd", True), ms("flash_bwd", True)


def check_conv_routes(what, unet_passes):
    """Log the fused conv's launches a UNet pass by shape (N, C, H, W, O, kh,
    kw) and raise unless every launch took the wgmma route (the path is
    bf16)."""
    from t2v_turbo_tpu_torch.ops import fused_conv as FC

    w = FC.fused_gn_silu_conv
    per_pass = {k: c / unet_passes for k, c in sorted(w.by_shape.items())}
    ok = dict(w.by_route) == {"wgmma": w.launches}
    log(f"{what}: fused_gn_silu_conv launches by route {dict(w.by_route)} (all {w.launches} on wgmma) "
        f"{'OK' if ok else 'FAIL'}; a UNet pass by shape {per_pass}")
    if not ok:
        raise AssertionError(f"{what}: fused conv routes {dict(w.by_route)}, expected all {w.launches} on wgmma")


def check_norm_routes(what, passes, per):
    """Log B4's, its statistics mode's and B5's launches by route and, a
    `per` over `passes`, by shape; raise unless every GroupNorm launch took
    `cta`, `cluster` or (B4's whole-clip rows) `split`, and every LayerNorm
    launch the `vector` route (the paths' norms are aligned bf16 rows, which
    never take the element-wise routes)."""
    from t2v_turbo_tpu_torch.ops import norms as N

    for w, routes in ((N.fused_group_norm, N.GN_STAGED + ("split",)), (N.group_norm_affine_cuda, N.GN_STAGED),
                      (N.fused_layer_norm, ("vector",))):
        ok = set(w.by_route) <= set(routes)
        shapes = {k: c / passes for k, c in sorted(w.by_shape.items())}
        log(f"{what}: {w.__name__} launches {w.launches} by route {dict(w.by_route)} (all on {'/'.join(routes)}) "
            f"{'OK' if ok else 'FAIL'}; a {per} by shape {shapes}")
        if not ok:
            raise AssertionError(f"{what}: {w.__name__} took routes {dict(w.by_route)}, expected only {routes}")


def norm_device_ms(events):
    """(B4, of which its split route, its statistics mode, B5, B4's
    element-wise route) device ms in profiler events."""
    def ms(*keys):
        return sum(e.self_device_time_total for e in events if any(k in e.key for k in keys)) / 1e3
    split = ms("gn_split_part_kernel", "gn_split_apply_kernel")
    return (ms("gn_staged_apply") + split, split, ms("gn_staged_stats"), ms("ln_vec_kernel", "ln_kernel"),
            ms("gn_sum_kernel", "gn_sqdev_kernel", "gn_apply_kernel", "gn_affine_kernel"))


def _norm_profile(events):
    gn, split, stats, ln, elementwise = norm_device_ms(events)
    return (f"GroupNorm (B4) {gn:.2f} ms (split route {split:.2f}), its statistics mode for B7 {stats:.2f} ms, "
            f"LayerNorm (B5) {ln:.2f} ms, B4's element-wise route {elementwise:.2f} ms")


def bound_ms(ops, nbytes, dtype):
    """(least ms the card could take, "operations" or "bytes"): the larger of
    ops over the peak rate for the dtype and bytes over the memory rate."""
    t_ops = ops / PEAK_OPS[str(dtype).replace("torch.", "")]
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attention_bound(q, k, which):
    """Bound of one attention kernel on (B, S, H, D) inputs: 2 flops a
    multiply-add over the products it must do (fwd: QK^T, PV; dkv: S^T, dP^T,
    dV, dK; dq: S, dP, dQ), each input read once and each output written once
    (lse / delta rows in f32)."""
    b, sq, h, d = q.shape
    sk, e = k.shape[1], q.element_size()
    qn, kn, rows = b * sq * h * d, b * sk * h * d, b * h * sq * 4
    products, nbytes = {
        "fwd": (2, e * (2 * qn + 2 * kn)),
        "fwd_lse": (2, e * (2 * qn + 2 * kn) + rows),
        "bwd_dkv": (4, e * (2 * qn + 4 * kn) + 2 * rows),
        "bwd_dq": (3, e * (3 * qn + 2 * kn) + 2 * rows),
    }[which]
    return bound_ms(products * 2 * b * h * sq * sk * d, nbytes, q.dtype)


def conv_bound(x, w, o):
    """The fused conv: 2 flops a multiply-add over N*O*H*W*C*kh*kw; x read
    once, the weight once and the output written once (the GN statistics
    pass re-reads x: not counted, as the function need not)."""
    n, c, hh, ww = x.shape
    ops = 2 * n * o * hh * ww * w[0].numel()
    nbytes = x.element_size() * (x.numel() + w.numel() + n * o * hh * ww)
    return bound_ms(ops, nbytes, x.dtype)


def norm_bound(x, c, ops_per_element):
    """A norm reads x and writes y once (plus its f32 affine); its few
    operations per element are f32."""
    return bound_ms(ops_per_element * x.numel(), 2 * x.numel() * x.element_size() + 8 * c,
                    "float32")


def record(records, name, max_err, ms, plain_ms, library_ms, bound, graph_ms=None):
    """Keep the first case's times (the path's main shape) and the largest
    error. `ms`: back-to-back calls (CUDA events), host time included;
    `graph_ms`: the norms' device time by graph replay (`_graph_times`)."""
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                    "library_ms": library_ms, "bound_ms": bound[0],
                                    "bound_by": bound[1], "graph_ms": graph_ms})
    rec["max_abs_err"] = max(rec["max_abs_err"], max_err)


def log(msg: str) -> None:
    """Print, and keep the whole log in chiprun_out/chip_smoke.log."""
    print(msg, flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.log"), "a") as f:
        f.write(msg + "\n")


def cuda_time_ms(fn, iters: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build():
    from t2v_turbo_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.lib()  # nvcc on the sources, then load
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(cuda_lib.library_path(), HERE)}")


def _elementwise(atol, rtol):
    """(bound, text): |kernel - plain| <= atol + rtol*|plain| on every element."""
    return (lambda ref: atol + rtol * ref.abs()), f"atol {atol:g} + rtol {rtol:g}*|ref|"


def _of_max(tol):
    """(bound, text): |kernel - plain| <= tol*max(1, max|plain|) on every element."""
    return (lambda ref: tol * max(1.0, float(ref.abs().max()))), f"{tol:g}*max(1,|ref|)"


def _fused_sdpa(make):
    """{backend name: call to time} for every fused SDPA backend (flash,
    memory-efficient, cuDNN) that takes the inputs: `make()`, run under the
    backend, sets up and returns the call (SDPA, or its backward). Empty if
    none takes them (SDPA would fall back to its math backend, the plain
    path's own arithmetic)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    calls = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                call = make()
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def timed(backend=backend, call=call):
            with sdpa_kernel([backend]):
                return call()
        calls[backend.name] = timed
    return calls


def _sdpa_fwd(q, k, v, *_):
    """The library forward on contiguous (B, H, S, D) copies of (B, S, H, D)
    inputs: SDPA's fused backends fault on misaligned views."""
    import torch.nn.functional as F

    qq, kk, vv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return _fused_sdpa(lambda: lambda: F.scaled_dot_product_attention(qq, kk, vv))


def _sdpa_bwd(q, k, v, do, *_):
    """The library backward alone (dq, dk and dv together, from one forward
    kept for it), on contiguous (B, H, S, D) copies as `_sdpa_fwd`."""
    import torch
    import torch.nn.functional as F

    qq, kk, vv = (t.detach().transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dout = do.transpose(1, 2).contiguous()

    def make():
        out = F.scaled_dot_product_attention(qq, kk, vv)
        return lambda: torch.autograd.grad(out, (qq, kk, vv), dout, retain_graph=True)
    return _fused_sdpa(make)


def _kernel_cases():
    """Dicts: kernel (a name in KERNELS: checked, timed and recorded; any
    other name: checked only), label, make (inputs), fn, plain, outputs (their
    names), tols (one (bound, text) per output held to plain), why, exact
    (optional: the f64 values of the first outputs), iters, library (inputs ->
    {name: PyTorch call computing the same function}, each timed, the
    fastest recorded), bound."""
    import torch
    import torch.nn.functional as F

    from t2v_turbo_tpu_torch.apps.time_flash import FWD_SHAPES
    from t2v_turbo_tpu_torch.apps.time_fused_conv import UNET_STEP_SHAPES
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    def attn(b, s, h, d, dtype, sk=None):
        def make():
            g = torch.Generator("cuda").manual_seed(s + d)
            shapes = [(b, s, h, d)] + 2 * [(b, sk or s, h, d)]
            return [torch.randn(sh, generator=g, device="cuda").to(dtype) for sh in shapes]
        make.shape = (b, h, s, sk or s)  # (B, H, Sq, Sk): the forward cases' coverage
        make.dims, make.dtype = (b, h, s, sk or s, d), dtype  # as the wrappers' `by_shape` keys them
        return make

    def norm_inputs(shape, c, dtype, film=None, offset=0):
        """x (3 N(0,1) + 1), weight, bias; with `film` (True/False) also the
        FiLM (N, C) or two Nones; `offset` elements: x starts that far into
        its allocation (misaligned for offset % 8)."""
        def make():
            g = torch.Generator("cuda").manual_seed(c)
            x = (3.0 * torch.randn(prod(shape) + offset, generator=g, device="cuda") + 1.0).to(dtype)
            x = x[offset:].view(shape)
            w = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            b = 0.1 * torch.randn(c, generator=g, device="cuda")
            if film is None:
                return [x, w, b]
            return [x, w, b] + ([0.1 * torch.randn((shape[0], c), generator=g, device="cuda") for _ in range(2)]
                                if film else [None, None])
        return make

    bf, f32 = torch.bfloat16, torch.float32
    why_bf = "bf16 output (8-bit mantissa); the kernel rounds unnormalised probabilities, the plain path normalised ones"
    why_short = ("few keys: probabilities near 1, rounded to bf16 (2^-9) at different points "
                 "in the two paths, differ by up to 2^-8*max|v|, ~0.02 for N(0,1) values; "
                 "both are also held to f64 math below")
    why_f32 = "f32 with TF32 off; only the summation order and expf differ"
    why_norm_bf = "bf16 output; f32 statistics summed in another order can move a value by one bf16 ulp"
    why_norm_f32 = "f32; only the summation order (and the SiLU's fast exp and division) differ"
    def flash(label, make, atol, rtol, iters, why, f64=True, route="wgmma", kernel="flash_attention"):
        return dict(kernel=kernel, label=label, make=make, fn=A.flash_attention,
                    plain=A.attention, outputs=("o",), tols=[_elementwise(atol, rtol)], why=why,
                    route=(A.flash_attention, route), shape=getattr(make, "shape", None), iters=iters,
                    library=_sdpa_fwd,
                    bound=lambda q, k, v: attention_bound(q, k, "fwd"),
                    holds=[("flash_attention", make.dims)] if route == "wgmma" and getattr(
                        make, "dtype", None) == bf else [],
                    **({"exact": _attention_f64} if f64 else {}))

    def flash_lse(label, make, atol, rtol, iters, why, route="wgmma", kernel="flash_attention_fwd_lse"):
        return dict(kernel=kernel, label=label, make=make,
                    fn=lambda q, k, v: A.flash_attention_lse(q, k, v), plain=lambda q, k, v: A.attention_lse_plain(
                        q, k, v, q.shape[-1] ** -0.5), outputs=("o", "lse"),
                    tols=[_elementwise(atol, rtol), _elementwise(1e-3, 0.0)], iters=iters, library=_sdpa_fwd,
                    why=f"o: {why}; lse: f32 sums of exp in another order", route=(A.flash_attention_lse, route),
                    shape=getattr(make, "shape", None),
                    bound=lambda q, k, v: attention_bound(q, k, "fwd_lse"), exact=_attention_f64)

    def gn(label, shape, c, eps, iters, dtype=bf, offset=0):
        plan = N.gn_plan(shape[0], c, 32, prod(shape[2:]), dtype, offset % 8 == 0)
        label += f" [{plan.route}" + (f", {plan.k} x {plan.chunk} elements, {plan.staged} held]"
                                      if plan.route in N.GN_STAGED else
                                      f", {plan.k} chunks of {plan.chunk}]" if plan.route == "split" else "]")
        f32_case = dtype == torch.float32
        return dict(kernel="group_norm", label=label, make=norm_inputs(shape, c, dtype, offset=offset),
                    fn=lambda x, w, b: N.fused_group_norm(x, w, b, 32, eps, "silu"),
                    plain=lambda x, w, b: N.group_norm_plain(x, w, b, 32, eps, "silu"), outputs=("y",),
                    tols=[_elementwise(1e-5, 1e-5) if f32_case else _elementwise(1e-2, 1e-2)], iters=iters,
                    why=why_norm_f32 if f32_case else why_norm_bf, route=(N.fused_group_norm, plan.route), graph=True,
                    shape=tuple(shape), dtype=dtype,
                    library=lambda x, w, b: {"F.group_norm+F.silu": lambda: F.silu(
                        F.group_norm(x, 32, w.to(x.dtype), b.to(x.dtype), eps))},
                    bound=lambda x, w, b: norm_bound(x, c, 10),
                    holds=[("group_norm", tuple(shape))] if dtype == bf and offset == 0 else [])

    def gn_stats(label, shape, c, film, iters=20):
        plan = N.gn_plan(shape[0], c, 32, prod(shape[2:]), bf, stats=True)
        label += f" [{plan.route}, {plan.k} x {plan.chunk} elements, {plan.staged} held]"
        return dict(kernel="group_norm_stats", label=label, make=norm_inputs(shape, c, bf, film=film),
                    fn=lambda x, w, b, fs, fh: N.group_norm_affine_cuda(x, w, b, 32, 1e-5, fs, fh),
                    plain=lambda x, w, b, fs, fh: FC.gn_affine_vectors(x, w, b, 32, 1e-5, fs, fh),
                    outputs=("a", "b"), tols=2 * [_elementwise(1e-5, 1e-5)], iters=iters, graph=True,
                    why="f32 (N, C) vectors (group_stats + the affine and FiLM fold); the statistics summed in "
                        "another order", route=(N.group_norm_affine_cuda, plan.route), library=lambda *_: {},
                    bound=lambda x, *_: bound_ms(3 * x.numel(), x.numel() * x.element_size() + 8 * x.shape[0] * c
                                                 + 8 * c, "float32"),
                    holds=[("group_norm_stats", tuple(shape))] + [("group_norm_stats film", tuple(shape))] * film)

    def ln(label, shape, c, dtype, atol, why, eps=1e-5):
        plan = N.ln_plan(shape[0], c, dtype)
        label += f" [{plan.route}" + (f", {plan.lanes} lanes x {plan.vecs} vectors]" if plan.lanes else "]")
        return dict(kernel="layer_norm", label=label, make=norm_inputs(shape, c, dtype),
                    fn=lambda x, w, b: N.fused_layer_norm(x, w, b, eps),
                    plain=lambda x, w, b: N.layer_norm_plain(x, w, b, eps),
                    outputs=("y",), tols=[_elementwise(atol, atol)], iters=20, why=why, graph=True,
                    route=(N.fused_layer_norm, plan.route),
                    library=lambda x, w, b: {"F.layer_norm": lambda: F.layer_norm(
                        x, (c,), w.to(x.dtype), b.to(x.dtype), eps)},
                    bound=lambda x, w, b: norm_bound(x, c, 8), holds=[("layer_norm", tuple(shape))] * (dtype == bf))

    def norm_determinism(kernel, label, make, fn):
        return dict(kernel=f"{kernel} determinism", label=label, make=make, fn=fn, plain=fn,
                    outputs=("y",) if kernel == "group_norm" else ("a", "b"),
                    tols=(1 if kernel == "group_norm" else 2) * [_elementwise(0.0, 0.0)],
                    why="two launches: partials added in a fixed order (blocks in rank order), so equal bits")

    def conv_inputs(n, c, hh, ww, o, kh, kw, dtype, film):
        def make():
            g = torch.Generator("cuda").manual_seed(c + o + kw)
            x = (2.0 * torch.randn((n, c, hh, ww), generator=g, device="cuda") + 0.5).to(dtype)
            gs = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            gb = 0.1 * torch.randn(c, generator=g, device="cuda")
            w = (torch.randn((o, c, kh, kw), generator=g, device="cuda") / (c * kh * kw) ** 0.5).to(dtype)
            b = (0.1 * torch.randn(o, generator=g, device="cuda")).to(dtype)
            film_sh = [0.1 * torch.randn((n, c), generator=g, device="cuda") for _ in range(2)]
            return [x, gs, gb, w, b] + (film_sh if film else [None, None])
        return make

    def unfused(x, gs, gb, w, b, fs, fh):
        """The pair the port ran before B7 (B4 with SiLU, then cuDNN), and the
        library's own GroupNorm; none computes a FiLM."""
        pad = (w.shape[2] // 2, w.shape[3] // 2)
        if fs is not None:
            return {}
        return {"B4+SiLU, cuDNN conv": lambda: F.conv2d(N.fused_group_norm(x, gs, gb, 32, 1e-5, "silu"), w, b,
                                                        padding=pad),
                "F.group_norm+F.silu+F.conv2d": lambda: F.conv2d(
                    F.silu(F.group_norm(x, 32, gs.to(x.dtype), gb.to(x.dtype), 1e-5)), w, b, padding=pad)}

    why_conv_bf = ("bf16 output; kernel and plain round the activation to bf16 at the same point, but the "
                   "kernel folds the GroupNorm into x*a+b (an activation may land one bf16 ulp apart) and "
                   "sums the C*kh*kw products in another order; both are also held to f64 math below")

    def conv(label, shape, dtype=bf, film=False, iters=10, f64=True):
        n, c, hh, ww, o, kh, kw = shape
        f32_case = dtype == torch.float32
        plan = FC.conv_plan(*shape, dtype)
        if not f32_case:
            label += f" [{plan.tw}x{plan.tr} tiles, {plan.splits} split(s), {prod(plan.grid)} blocks]"
        return dict(kernel="fused_gn_silu_conv", label=label, make=conv_inputs(*shape, dtype, film),
                    route=(FC.fused_gn_silu_conv, plan.route),
                    fn=lambda *a: FC.fused_gn_silu_conv(*a[:5], 32, 1e-5, *a[5:]),
                    plain=lambda *a: FC.fused_gn_silu_conv_plain(*a[:5], 32, 1e-5, *a[5:]), outputs=("y",),
                    tols=[_elementwise(1e-4, 1e-4) if f32_case else _elementwise(2e-2, 2e-2)],
                    why=("f32 with TF32 off; the GroupNorm folded into x*a+b and the sums in another order"
                         if f32_case else why_conv_bf), iters=iters, library=unfused,
                    bound=lambda x, gs, gb, w, *_: conv_bound(x, w, o),
                    holds=[] if f32_case else [("fused_gn_silu_conv", tuple(shape))]
                    + [("fused_gn_silu_conv film", tuple(shape))] * film,
                    **({"exact": _fused_conv_f64} if f64 and not f32_case else {}))

    def small_seq(label, make, shape, iters=20, dtype=bf, aligned=True):
        f32_case = dtype == torch.float32
        plan = A.ss_plan(*shape, dtype, aligned)
        return dict(kernel="small_seq_attention_f32" if f32_case else "small_seq_attention",
                    label=f"{label} [{plan.route}, {plan.heads} head(s) an item, {plan.grid} blocks of "
                          f"{plan.threads} threads, {plan.smem} bytes]", make=make, fn=A.small_seq_attention,
                    plain=A.attention, outputs=("o",), route=(A.small_seq_attention, plan.route), graph=True,
                    tols=[_elementwise(1e-5, 1e-4) if f32_case else _elementwise(2e-3, 2e-2)],
                    why=("f32; only the summation order and expf differ" if f32_case else
                         "bf16 output; both normalise P in f32 and round it to bf16 before P.V; the "
                         "logits are summed in another order; both are also held to f64 math below"),
                    iters=iters, library=_sdpa_fwd, beside={"B1 flash": A.flash_attention_cuda},
                    bound=lambda q, k, v: attention_bound(q, k, "fwd"),
                    holds=[("small_seq_attention", tuple(shape))] * (aligned and not f32_case),
                    **({} if f32_case else {"exact": _attention_f64}))

    b7 = [
        conv("UNet L0 ResBlock conv 320->320 3x3 (16,320,40,64) bf16", (16, 320, 40, 64, 320, 3, 3)),
        conv("UNet L0 output block 640->320 3x3 (16,640,40,64) bf16", (16, 640, 40, 64, 320, 3, 3)),
        conv("UNet level-3 output block 2560->1280 3x3 at 5x8 (16,2560,5,8) bf16", (16, 2560, 5, 8, 1280, 3, 3)),
        conv("UNet L0 temporal conv (3,1) on the clip (1,320,16,2560) bf16", (1, 320, 16, 2560, 320, 3, 1)),
        conv("UNet out head 320->4 3x3 (16,320,40,64) bf16", (16, 320, 40, 64, 4, 3, 3)),
        conv("FiLM on, 320->320 3x3 (16,320,40,64) bf16", (16, 320, 40, 64, 320, 3, 3), film=True),
        conv("odd sizes 96->70 (3,1) (2,96,5,300) bf16", (2, 96, 5, 300, 70, 3, 1), iters=5),
        conv("f32 L0 320->320 3x3 (2,320,40,64), TF32 off", (2, 320, 40, 64, 320, 3, 3), torch.float32, iters=3),
    ]
    # B7 at every shape of a UNet step, and its determinism: last in the
    # table, after the cases of earlier PRs, so the phases after this one
    # start from the same allocator state as before they were added (with
    # them in the middle the rewards-ON peak read 0.01 GiB higher, PERF.md).
    b7_unet = [conv(f"UNet step shape {shape[1]}->{shape[4]} ({shape[5]},{shape[6]}) {shape[:4]} bf16", shape,
                    f64=False) for shape in UNET_STEP_SHAPES] + [dict(
        kernel="fused_gn_silu_conv determinism", label="UNet L0 320->320 3x3 (16,320,40,64) bf16",
        make=conv_inputs(16, 320, 40, 64, 320, 3, 3, bf, False),
        fn=lambda *a: FC.fused_gn_silu_conv(*a[:5], 32, 1e-5), plain=lambda *a: FC.fused_gn_silu_conv(*a[:5], 32, 1e-5),
        outputs=("y",), tols=[_elementwise(0.0, 0.0)],
        why="two launches: no atomics, a fixed summation order, so equal bits")]
    b8 = [
        small_seq("UNet L0 temporal attn (2560,16,5,64) bf16", attn(2560, 16, 5, 64, bf), (2560, 16, 5)),
        small_seq("init_attn temporal (2560,16,8,64) bf16", attn(2560, 16, 8, 64, bf), (2560, 16, 8)),
        small_seq("UNet L1 temporal attn (640,16,10,64) bf16", attn(640, 16, 10, 64, bf), (640, 16, 10)),
        small_seq("UNet L2 temporal attn (160,16,20,64) bf16", attn(160, 16, 20, 64, bf), (160, 16, 20)),
        small_seq("ragged T = 13 (300,13,5,64) bf16", attn(300, 13, 5, 64, bf), (300, 13, 5)),
        small_seq("T = 48 (200,48,5,64) bf16", attn(200, 48, 5, 64, bf), (200, 48, 5)),
        small_seq("unaligned strided (300,16,5,64) bf16", _unaligned(300, 16, 16, 5, 64, 3), (300, 16, 5),
                  aligned=False),
        small_seq("f32 (2560,16,5,64)", attn(2560, 16, 5, 64, f32), (2560, 16, 5), iters=5, dtype=f32),
    ]
    serving = [
        flash("UNet L0 self-attn (16,5,2560,2560,64) bf16", attn(16, 2560, 5, 64, bf), 2e-3, 2e-2, 10, why_bf),
        flash("UNet L0 self-attn (16,5,2560,2560,64) f32", attn(16, 2560, 5, 64, f32), 1e-5, 1e-4, 5, why_f32,
              f64=False, route="f32"),
        flash("VAE mid attn (16,1,2560,2560,512) bf16", attn(16, 2560, 1, 512, bf), 2e-3, 2e-2, 5, why_bf,
              kernel="flash_attention_d512"),
        flash("UNet L1 self-attn (16,10,640,640,64) bf16", attn(16, 640, 10, 64, bf), 2e-3, 2e-2, 20, why_bf),
        flash("UNet L0 cross-attn (16,5,2560,77,64) bf16", attn(16, 2560, 5, 64, bf, sk=77), 2e-2, 2e-2, 20,
              why_short),
        flash("UNet L0 temporal attn (2560,5,16,16,64) bf16", attn(2560, 16, 5, 64, bf), 2e-2, 2e-2, 20,
              why_short),
        flash("ragged S (2,5,1111,1111,64) bf16", attn(2, 1111, 5, 64, bf), 2e-3, 2e-2, 5, why_bf),
        flash("ragged S (2,1,1111,1111,512) bf16", attn(2, 1111, 1, 512, bf), 2e-3, 2e-2, 5, why_bf,
              kernel="flash_attention_d512"),
        flash("unaligned strided K/V (2,5,300,300,64) bf16", _unaligned(2, 300, 300, 5, 64, 3), 2e-3, 2e-2, 5,
              why_bf, route="staged"),
        gn("UNet L0 GN+SiLU per frame (16,320,40,64) bf16", (16, 320, 40, 64), 320, 1e-5, 20),
        gn("whole-clip GN+SiLU (1,320,16,40,64) bf16", (1, 320, 16, 40, 64), 320, 1e-5, 20),
        gn("VAE full-res GN+SiLU (16,128,320,512) bf16", (16, 128, 320, 512), 128, 1e-6, 10),
        gn("odd spatial size, element-wise path (2,64,5,7) bf16", (2, 64, 5, 7), 64, 1e-5, 5),
        ln("transformer LN (40960,320) bf16", (40960, 320), 320, bf, 1e-2, why_norm_bf),
        ln("transformer LN (2560,1280) f32", (2560, 1280), 1280, f32, 1e-5, "f32; only the summation order differs"),
    ] + b7 + b8
    train = [case for args in TRAIN_ATTENTION_CASES for case in _train_attention_cases(*args)]
    # B1 and B2 at every bf16 head-dim-64 forward shape of the paths
    # (time_flash.FWD_SHAPES) that no wgmma case above holds, a negative
    # scale (staged route: the wgmma forward takes positive scales only), and
    # two launches of each at L0 with equal bits
    covered = {(c["kernel"], c.get("shape")) for c in serving + train if c.get("route", (0, ""))[1] == "wgmma"}
    fwd_path = []
    for (b, h, sq, sk), name, b1, b2, b2_rewards in FWD_SHAPES:
        label = f"UNet {name} ({b},{h},{sq},{sk},64) bf16"
        why, atol = (why_short, 2e-2) if sk <= 77 else (why_bf, 2e-3)
        if b1 and ("flash_attention", (b, h, sq, sk)) not in covered:
            fwd_path.append(flash(label, attn(b, sq, h, 64, bf, sk=sk), atol, 2e-2, 20, why))
        if b2 + b2_rewards and ("flash_attention_fwd_lse", (b, h, sq, sk)) not in covered:
            fwd_path.append(flash_lse(label, attn(b, sq, h, 64, bf, sk=sk), atol, 2e-2, 20, why))
    fwd_path.append(dict(
        kernel="flash_attention_fwd_lse negative scale", label="ragged S (2,5,1111,1111,64) bf16, scale -1/8",
        make=attn(2, 1111, 5, 64, bf), fn=lambda q, k, v: A.flash_attention_lse(q, k, v, -0.125),
        plain=lambda q, k, v: A.attention_lse_plain(q, k, v, -0.125), outputs=("o", "lse"),
        tols=[_elementwise(2e-3, 2e-2), _elementwise(1e-3, 0.0)], route=(A.flash_attention_lse, "staged"),
        why=f"o: {why_bf}; lse: f32 sums of exp in another order; a scale <= 0 takes the staged route"))
    both = lambda q, k, v: (A.flash_attention(q, k, v),) + A.flash_attention_lse(q, k, v)  # noqa: E731
    for label, make in (("UNet L0 self-attn (16,5,2560,2560,64) bf16", attn(16, 2560, 5, 64, bf)),
                        ("VAE mid attn (16,1,2560,2560,512) bf16", attn(16, 2560, 1, 512, bf))):
        fwd_path.append(dict(
            kernel="flash_attention forward determinism", label=label, make=make, fn=both, plain=both,
            outputs=("o (B1)", "o (B2)", "lse"), tols=3 * [_elementwise(0.0, 0.0)],
            why="two launches of each: a fixed summation order (at D = 512 the two warpgroups' partial "
                "logits added in one order), so equal bits"))
    # B1 at head dim 512 on the edges of its 64-row tiles (S one row past two
    # tiles; Sk one row past one; Sq != Sk with Sk < 64), and an unaligned
    # view, which the wgmma forward cannot read (packed route)
    fwd_path += [
        flash("tile edges (2,1,129,129,512) bf16", attn(2, 129, 1, 512, bf), 2e-3, 2e-2, 3, why_bf,
              kernel="flash_attention_d512"),
        flash("tile edges (2,1,191,65,512) bf16", attn(2, 191, 1, 512, bf, sk=65), 2e-2, 2e-2, 3, why_short,
              kernel="flash_attention_d512"),
        flash("short keys (2,1,100,40,512) bf16", attn(2, 100, 1, 512, bf, sk=40), 2e-2, 2e-2, 3, why_short,
              kernel="flash_attention_d512"),
        # checked, not recorded: the record of flash_attention_d512 is the wgmma kernel's
        flash("unaligned strided q/k/v (2,1,300,300,512) bf16", _unaligned(2, 300, 300, 1, 512, 3), 2e-3, 2e-2, 3,
              why_bf, route="packed", kernel="flash_attention_d512 on packed"),
    ]
    # B4, its statistics mode and B5 at the paths' other shapes, on every
    # route, and their determinism: last, after the earlier PRs' cases
    norms = [
        gn("VAE full-res 256-ch GN+SiLU (16,256,320,512) bf16", (16, 256, 320, 512), 256, 1e-6, 5),
        gn("VAE full-res GN+SiLU, image-reward decode (5,128,320,512) bf16", (5, 128, 320, 512), 128, 1e-6, 10),
        gn("VAE 256-ch GN+SiLU, video-reward decode (8,256,320,512) bf16", (8, 256, 320, 512), 256, 1e-6, 5),
        gn("VAE mid block GN+SiLU (16,512,40,64) bf16", (16, 512, 40, 64), 512, 1e-6, 20),
        gn("whole-clip GN+SiLU at L2 (1,1280,16,10,16) bf16", (1, 1280, 16, 10, 16), 1280, 1e-5, 20),
        gn("f32 GN+SiLU (2,320,40,64)", (2, 320, 40, 64), 320, 1e-5, 20, f32),
        gn("f32 row beyond 16 blocks' shared memory (1,256,320,512)", (1, 256, 320, 512), 256, 1e-6, 5, f32),
        gn("misaligned x (one element in), element-wise path (2,64,40,64) bf16", (2, 64, 40, 64), 64, 1e-5, 5,
           offset=1),
        gn_stats("B7 statistics, UNet L0 (16,320,40,64) bf16, no FiLM", (16, 320, 40, 64), 320, False),
        gn_stats("B7 statistics, UNet L0 (16,320,40,64) bf16, FiLM", (16, 320, 40, 64), 320, True),
        gn_stats("B7 statistics, L0 temporal conv on the clip (1,320,16,2560) bf16", (1, 320, 16, 2560), 320, False),
        gn_stats("B7 statistics, (16,1920,20,32) bf16, FiLM", (16, 1920, 20, 32), 1920, True),
        norm_determinism("group_norm", "UNet L0 per frame (16,320,40,64) bf16 [cta]",
                         norm_inputs((16, 320, 40, 64), 320, bf), lambda *a: N.fused_group_norm(*a, 32, 1e-5, "silu")),
        norm_determinism("group_norm", "whole clip (1,320,16,40,64) bf16 [split]",
                         norm_inputs((1, 320, 16, 40, 64), 320, bf), lambda *a: N.fused_group_norm(*a, 32, 1e-5, "silu")),
        norm_determinism("group_norm", "VAE full-res (16,128,320,512) bf16 [cluster, part re-read]",
                         norm_inputs((16, 128, 320, 512), 128, bf), lambda *a: N.fused_group_norm(*a, 32, 1e-6, "silu")),
        norm_determinism("group_norm_stats", "temporal conv clip (1,320,16,2560) bf16, FiLM [cluster]",
                         norm_inputs((1, 320, 16, 2560), 320, bf, film=True),
                         lambda *a: N.group_norm_affine_cuda(*a[:3], 32, 1e-5, *a[3:])),
        ln("UNet L1 transformer LN (10240,640) bf16", (10240, 640), 640, bf, 1e-2, why_norm_bf),
        ln("init_attn transformer LN (40960,512) bf16", (40960, 512), 512, bf, 1e-2, why_norm_bf),
        ln("UNet L2 transformer LN (2560,1280) bf16", (2560, 1280), 1280, bf, 1e-2, why_norm_bf),
        ln("text tower LN (77,1024) bf16", (77, 1024), 1024, bf, 1e-2, why_norm_bf),
        ln("ViCLIP-L LN (2049,1024) bf16", (2049, 1024), 1024, bf, 1e-2, why_norm_bf),
        ln("ViT-H/14 LN (1285,1280) bf16", (1285, 1280), 1280, bf, 1e-2, why_norm_bf),
        ln("C not whole vectors, element-wise path (300,100) bf16", (300, 100), 100, bf, 1e-2, why_norm_bf),
    ]
    # B8 at the middle block's shapes, T = 64, f32 on its element-wise
    # route, two launches with equal bits, a launch inside a CUDA graph
    # against the eager one; B6 (the mma route on misaligned views) at a
    # size where its bound is not negligible: last, after the earlier PRs'
    # cases
    graphed = _graphed(A.small_seq_attention)
    b8_more = [
        small_seq("UNet mid block temporal attn (40,16,20,64) bf16", attn(40, 16, 20, 64, bf), (40, 16, 20)),
        small_seq("UNet mid block self-attn at 5x8 (16,40,20,64) bf16", attn(16, 40, 20, 64, bf), (16, 40, 20)),
        small_seq("T = 64 (100,64,2,64) bf16", attn(100, 64, 2, 64, bf), (100, 64, 2)),
        small_seq("f32 unaligned strided (100,13,5,64)", _unaligned(100, 13, 13, 5, 64, 3, torch.float32),
                  (100, 13, 5), iters=5, dtype=f32, aligned=False),
        dict(kernel="small_seq_attention determinism", label="UNet L0 temporal attn (2560,16,5,64) bf16",
             make=attn(2560, 16, 5, 64, bf), fn=A.small_seq_attention, plain=A.small_seq_attention,
             outputs=("o",), tols=[_elementwise(0.0, 0.0)],
             why="two launches: every sum in a fixed order, so equal bits"),
        dict(kernel="small_seq_attention in a CUDA graph", label="UNet L1 temporal attn (640,16,10,64) bf16",
             make=attn(640, 16, 10, 64, bf), fn=graphed, plain=A.small_seq_attention, outputs=("o",),
             tols=[_elementwise(0.0, 0.0)],
             why="a launch captured in a torch.cuda.CUDAGraph and replayed (output NaN-filled first) against "
                 "an eager launch: equal bits"),
    ]
    # B6's forward on the staged route: the recorded rows at L0 on misaligned
    # views; equal bits to the wgmma route on contiguous copies of the same
    # values (at L0, a ragged S, 77 keys); one tensor misaligned at a time;
    # scales -1/8 and 0 on aligned tensors; two launches; a CUDA graph
    both = lambda q, k, v, scale=None: (A.flash_attention(q, k, v, scale),) + A.flash_attention_lse(  # noqa: E731
        q, k, v, scale)

    def on_tma(q, k, v):  # the same values, contiguous: the wgmma route
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        if A.flash_route(qc, kc, vc, fwd_scale=q.shape[-1] ** -0.5) != "wgmma":
            raise AssertionError("contiguous copies do not take the wgmma route")
        return both(qc, kc, vc)

    def staged_bits(label, make):
        return dict(kernel="flash_attention staged vs wgmma", label=label, make=make, fn=both, plain=on_tma,
                    outputs=("o (B1)", "o (B2)", "lse"), tols=3 * [_elementwise(0.0, 0.0)],
                    route=(A.flash_attention, "staged"),
                    why="scale 1/8: the same consumer warpgroup on the same tile bytes (TMA's 128-byte swizzle "
                        "rebuilt by the staged producer), so equal bits")

    def staged_scale(label, make, scale):
        return dict(kernel="flash_attention staged scale", label=label, make=make,
                    fn=lambda q, k, v: both(q, k, v, scale),
                    plain=lambda q, k, v: (A.attention(q, k, v, scale=scale),) + A.attention_lse_plain(q, k, v, scale),
                    outputs=("o (B1)", "o (B2)", "lse"),
                    tols=2 * [_elementwise(2e-3, 2e-2)] + [_elementwise(1e-3, 0.0)], route=(A.flash_attention, "staged"),
                    why=f"o: {why_bf}; lse: f32 sums of exp in another order; scale {scale:g}: Q stored "
                        + ("negated" if scale < 0 else "as zeros") + " by the producer")

    def one_misaligned(b, s, h, d, i, n):  # n (b, s, h, d) tensors, the i-th misaligned
        def make():
            g = torch.Generator("cuda").manual_seed(300 + d + i)
            t = [torch.randn((b, s, h, d), generator=g, device="cuda").to(bf) for _ in range(n)]
            t[i] = _unaligned(b, s, s, h, d, n)()[i]
            return t
        return make

    b6 = [
        flash("staged route, misaligned views (16,5,2560,2560,64) bf16", _unaligned(16, 2560, 2560, 5, 64, 3), 2e-3,
              2e-2, 5, why_bf, route="staged", kernel="flash_attention_staged"),
        flash_lse("staged route, misaligned views (16,5,2560,2560,64) bf16", _unaligned(16, 2560, 2560, 5, 64, 3),
                  2e-3, 2e-2, 5, why_bf, route="staged", kernel="flash_attention_fwd_lse_staged"),
        staged_bits("misaligned views (16,5,2560,2560,64) bf16", _unaligned(16, 2560, 2560, 5, 64, 3)),
        staged_bits("ragged misaligned views (2,5,300,300,64) bf16", _unaligned(2, 300, 300, 5, 64, 3)),
        staged_bits("misaligned views, 77 keys (2,5,300,77,64) bf16", _unaligned(2, 300, 77, 5, 64, 3)),
    ] + [
        flash(f"staged route, only {'qkv'[i]} misaligned (2,5,300,300,64) bf16", one_misaligned(2, 300, 5, 64, i, 3),
              2e-3, 2e-2, 5, why_bf, route="staged", kernel="flash_attention on staged")
        for i in range(3)
    ] + [
        staged_scale(f"aligned ragged S (2,5,1111,1111,64) bf16, scale {scale:g}", attn(2, 1111, 5, 64, bf), scale)
        for scale in (-0.125, 0.0)
    ] + [
        dict(kernel="flash_attention staged determinism", label="misaligned views (16,5,2560,2560,64) bf16",
             make=_unaligned(16, 2560, 2560, 5, 64, 3), fn=both, plain=both, outputs=("o (B1)", "o (B2)", "lse"),
             tols=3 * [_elementwise(0.0, 0.0)], route=(A.flash_attention, "staged"),
             why="two launches of each: a fixed summation order, so equal bits"),
        dict(kernel="flash_attention staged in a CUDA graph", label="misaligned views (16,10,640,640,64) bf16",
             make=_unaligned(16, 640, 640, 10, 64, 3), fn=_graphed(A.flash_attention), plain=A.flash_attention,
             outputs=("o",), tols=[_elementwise(0.0, 0.0)],
             why="a launch captured in a torch.cuda.CUDAGraph and replayed (output NaN-filled first) against "
                 "an eager launch: equal bits"),
    ]
    # B6 on the packed route (the backward at D = 64 and 512, the forward at
    # D = 512, on misaligned views): the recorded rows at L0 and at the VAE
    # mid block, and the pack alone on one L0 tensor; equal bits to the wgmma
    # route on contiguous copies of the same values; one of q, k, v, dO
    # misaligned at a time; the D = 512 forward at scales -1/8 and 0; the
    # pack against contiguous() at all 8 offsets in all three modes; two
    # launches; a packed backward in a CUDA graph
    exact = _elementwise(0.0, 0.0)
    why_copy = ("the wgmma kernels on the pack kernel's copies, which hold the contiguous copies' bytes: "
                "equal bits")

    def bwd_all(q, k, v, do, lse, delta):
        return A.flash_attention_bwd_dkv(q, k, v, do, lse, delta) + (A.flash_attention_bwd_dq(q, k, v, do, lse, delta),)

    def bwd_on_tma(q, k, v, do, lse, delta):  # the same values, contiguous: the wgmma route
        c = [t.contiguous() for t in (q, k, v, do)]
        if A.flash_route(*c) != "wgmma":
            raise AssertionError("contiguous copies do not take the wgmma route")
        return bwd_all(*c, lse, delta)

    def row_stats(make):  # q, k, v, dO and the plain forward's lse and delta
        def run():
            q, k, v, do = make()
            o, lse = A.attention_lse_plain(q, k, v, q.shape[-1] ** -0.5)
            return [q, k, v, do, lse, A.attention_bwd_delta(do, o)]
        return run

    def bwd_bits(label, make):
        return dict(kernel="flash_attention_bwd packed vs wgmma", label=label, make=row_stats(make), fn=bwd_all,
                    plain=bwd_on_tma, outputs=("dk", "dv", "dq"), tols=3 * [exact],
                    route=(A.flash_attention_bwd_dkv, "packed"), why=why_copy)

    def fwd_bits(label, make):
        return dict(kernel="flash_attention_d512 packed vs wgmma", label=label, make=make, fn=both, plain=on_tma,
                    outputs=("o (B1)", "o (B2)", "lse"), tols=3 * [exact], route=(A.flash_attention, "packed"),
                    why=why_copy)

    def packed_scale(label, make, scale):
        atol = 2e-2 if scale else 2e-3
        return dict(kernel="flash_attention_d512 packed scale", label=label, make=make,
                    fn=lambda q, k, v: both(q, k, v, scale),
                    plain=lambda q, k, v: (A.attention(q, k, v, scale=scale),) + A.attention_lse_plain(q, k, v, scale),
                    outputs=("o (B1)", "o (B2)", "lse"),
                    tols=2 * [_elementwise(atol, 2e-2)] + [_elementwise(1e-3, 0.0)],
                    route=(A.flash_attention, "packed"),
                    why=f"scale {scale:g}: Q packed " + ("negated, run at 1/8" if scale else "as zeros, run at 1")
                        + "; "
                        + ("o: at D = 512 a scale of 1/8 makes the logits' std 2.8, probabilities near 1, which the "
                           "two paths round to bf16 at different points: up to 2^-8*max|v| (as few keys)" if scale
                           else f"o: {why_bf}") + "; lse: f32 sums of exp in another order")

    def pack_view(d, off):  # a (2, 37, 3, d) bf16 view `off` elements into its buffer, odd row stride
        def make():
            g = torch.Generator("cuda").manual_seed(d + off)
            buf = torch.randn(2 * 37 * (3 * d + 1) + 8, generator=g, device="cuda").to(bf)
            return [buf.as_strided((2, 37, 3, d), (37 * (3 * d + 1), 3 * d + 1, d, 1), off)]
        return make

    modes = tuple(A.PACK_MODES)
    l0_bwd = row_stats(_unaligned(16, 2560, 2560, 5, 64, 4))
    why_twin = "P and dS rounded to bf16 for their products"
    packed = [
        dict(kernel="flash_attention_bwd_dkv_packed", label="packed route, misaligned views (16,5,2560,2560,64) bf16",
             make=l0_bwd, fn=lambda *a: A.flash_attention_bwd_dkv(*a),
             plain=lambda *a: A.attention_bwd_dkv_plain(*a, 0.125), outputs=("dk", "dv"),
             tols=2 * [_of_max(2e-2)], why=why_twin, iters=5, library=_sdpa_bwd,
             route=(A.flash_attention_bwd_dkv, "packed"), bound=lambda q, k, *_: attention_bound(q, k, "bwd_dkv")),
        dict(kernel="flash_attention_bwd_dq_packed", label="packed route, misaligned views (16,5,2560,2560,64) bf16",
             make=l0_bwd, fn=lambda *a: A.flash_attention_bwd_dq(*a),
             plain=lambda *a: A.attention_bwd_dq_plain(*a, 0.125), outputs=("dq",),
             tols=[_of_max(2e-2)], why=why_twin, iters=5, library=_sdpa_bwd,
             route=(A.flash_attention_bwd_dq, "packed"), bound=lambda q, k, *_: attention_bound(q, k, "bwd_dq")),
        flash("packed route, misaligned views (16,1,2560,2560,512) bf16", _unaligned(16, 2560, 2560, 1, 512, 3), 2e-3,
              2e-2, 5, why_bf, route="packed", kernel="flash_attention_d512_packed"),
        dict(kernel="pack_bshd", label="one L0 tensor, a misaligned view (16,2560,5,64) bf16",
             make=_unaligned(16, 2560, 2560, 5, 64, 1), fn=A.pack_bshd, plain=A.pack_bshd_plain, outputs=("copy",),
             tols=[exact], why="a copy: equal bits", iters=50, library=lambda x: {"contiguous()": x.contiguous},
             bound=lambda x: bound_ms(0, 4 * x.numel(), x.dtype)),
        bwd_bits("misaligned views (16,5,2560,2560,64) bf16", _unaligned(16, 2560, 2560, 5, 64, 4)),
        bwd_bits("ragged misaligned views (2,5,300,300,64) bf16", _unaligned(2, 300, 300, 5, 64, 4)),
        bwd_bits("misaligned views, 77 keys (2,5,300,77,64) bf16", _unaligned(2, 300, 77, 5, 64, 4)),
        bwd_bits("misaligned views, tile edges (2,5,191,65,64) bf16", _unaligned(2, 191, 65, 5, 64, 4)),
        bwd_bits("misaligned views (8,1,2560,2560,512) bf16", _unaligned(8, 2560, 2560, 1, 512, 4)),
        bwd_bits("ragged misaligned views (2,1,1111,1111,512) bf16", _unaligned(2, 1111, 1111, 1, 512, 4)),
        fwd_bits("misaligned views (16,1,2560,2560,512) bf16", _unaligned(16, 2560, 2560, 1, 512, 3)),
        fwd_bits("ragged misaligned views (2,1,1111,1111,512) bf16", _unaligned(2, 1111, 1111, 1, 512, 3)),
    ] + [
        bwd_bits(f"only {('q', 'k', 'v', 'dO')[i]} misaligned (2,5,300,300,64) bf16",
                 one_misaligned(2, 300, 5, 64, i, 4))
        for i in range(4)
    ] + [
        fwd_bits(f"only {'qkv'[i]} misaligned (2,1,300,300,512) bf16", one_misaligned(2, 300, 1, 512, i, 3))
        for i in range(3)
    ] + [
        packed_scale(f"aligned ragged S (2,1,1111,1111,512) bf16, scale {scale:g}", attn(2, 1111, 1, 512, bf), scale)
        for scale in (-0.125, 0.0)
    ] + [
        dict(kernel="pack_bshd vs contiguous()", label=f"(2,37,3,{d}) bf16 view {2 * off} bytes past 16-byte "
             f"alignment, odd row stride, modes {modes}", make=pack_view(d, off),
             fn=lambda x: tuple(A.pack_bshd(x, m) for m in modes),
             plain=lambda x: tuple(A.pack_bshd_plain(x, m) for m in modes), outputs=modes, tols=3 * [exact],
             why="a copy (negated: each sign bit flipped; zeros): equal bits")
        for d in (64, 512) for off in range(8)
    ] + [
        dict(kernel="flash_attention_bwd packed determinism", label="misaligned views (16,5,2560,2560,64) bf16",
             make=l0_bwd, fn=bwd_all, plain=bwd_all, outputs=("dk", "dv", "dq"), tols=3 * [exact],
             route=(A.flash_attention_bwd_dkv, "packed"), why="two launches of each: equal bits"),
        dict(kernel="flash_attention_d512 packed determinism", label="misaligned views (16,1,2560,2560,512) bf16",
             make=_unaligned(16, 2560, 2560, 1, 512, 3), fn=both, plain=both, outputs=("o (B1)", "o (B2)", "lse"),
             tols=3 * [exact], route=(A.flash_attention, "packed"), why="two launches of each: equal bits"),
        dict(kernel="flash_attention_bwd packed in a CUDA graph", label="misaligned views (16,10,640,640,64) bf16",
             make=row_stats(_unaligned(16, 640, 640, 10, 64, 4)), fn=_graphed(bwd_all), plain=bwd_all,
             outputs=("dk", "dv", "dq"), tols=3 * [exact],
             why="the packs and both kernels captured in a torch.cuda.CUDAGraph and replayed (outputs NaN-filled "
                 "first) against eager launches: equal bits"),
    ]
    # B4 at the VAE encoder's shapes that no case above holds (the training
    # on real data phase encodes 16 frames at 320x512): last, after the
    # earlier PRs' cases
    encoder_gn = [gn(f"VAE encoder GN+SiLU {shape} bf16", shape, shape[1], 1e-6, 5)
                  for shape in ((16, 128, 160, 256), (16, 256, 160, 256), (16, 256, 80, 128), (16, 512, 80, 128))]
    # The BLIP and InternVideo2 reward towers' attentions (B2, B3) and
    # LayerNorms (B5) at the rewards-ON v1 path's shapes (5 image-reward
    # frames, one 8-frame clip): last, after the earlier PRs' cases
    towers = [case for args in TOWER_ATTENTION_CASES for case in _train_attention_cases(*args)] + [
        ln("BLIP ViT-L LN, 5 frames (985,1024) bf16", (985, 1024), 1024, bf, 1e-2, why_norm_bf),
        ln("BLIP BERT LN eps 1e-12, 5 x 35 tokens (175,768) bf16", (175, 768), 768, bf, 1e-2, why_norm_bf, 1e-12),
        ln("InternVideo2 pooling LN k/v (2049,1408) bf16", (2049, 1408), 1408, bf, 1e-2, why_norm_bf),
        ln("InternVideo2 pooling LN q (1,1408) bf16", (1, 1408), 1408, bf, 1e-2, why_norm_bf),
        ln("InternVideo2 BERT-large LN eps 1e-12 (40,1024) bf16", (40, 1024), 1024, bf, 1e-2, why_norm_bf, 1e-12),
    ]
    # Full-model training (v2) differentiates every weight: B7's conv weight,
    # bias, GroupNorm affine and FiLM, B4's and B5's affines, beside x, each
    # through its autograd function (kernel forward; B7's backward recomputes
    # the activation and runs cuDNN's conv gradients, the norms' is the plain
    # math) against the plain twin's autograd, at one UNet shape each and at
    # the forward's bf16 bound; last, after the earlier PRs' cases
    def full_grads(kernel, label, make, fn, plain, outputs, tol, route=None):
        def grads(f):
            def run(*inputs):
                *xs, dy = inputs
                leaves = [t.detach().requires_grad_() for t in xs if t is not None]
                it = iter(leaves)
                return torch.autograd.grad(f(*[next(it) if t is not None else None for t in xs]), leaves, dy)
            return run
        return dict(kernel=kernel, label=label, make=make, fn=grads(fn), plain=grads(plain), outputs=outputs,
                    tols=len(outputs) * [tol], route=route,
                    why="bf16 gradients (the forward's bound); the backward repeats the plain math on the saved "
                        "inputs, the forward's rounding differs")

    def with_dy(make, shape):
        def run():
            g = torch.Generator("cuda").manual_seed(77)
            return make() + [torch.randn(shape, generator=g, device="cuda").to(bf)]
        return run

    l0 = (16, 320, 40, 64)
    full_model = [
        full_grads("fused_gn_silu_conv full-model gradients", f"UNet L0 320->320 3x3 {l0} bf16, FiLM on",
                   with_dy(conv_inputs(*l0, 320, 3, 3, bf, True), l0),
                   lambda *a: FC.fused_gn_silu_conv(*a[:5], 32, 1e-5, *a[5:]),
                   lambda *a: FC.fused_gn_silu_conv_plain(*a[:5], 32, 1e-5, *a[5:]),
                   ("dx", "d gn_scale", "d gn_bias", "d weight", "d bias", "d film_scale", "d film_shift"),
                   _elementwise(2e-2, 2e-2), route=(FC.fused_gn_silu_conv, "wgmma")),
        full_grads("group_norm full-model gradients", f"UNet L0 GN+SiLU {l0} bf16",
                   with_dy(norm_inputs(l0, 320, bf), l0), lambda x, w, b: N.group_norm(x, w, b, 32, 1e-5, "silu"),
                   lambda x, w, b: N.group_norm_plain(x, w, b, 32, 1e-5, "silu"), ("dx", "d weight", "d bias"),
                   _elementwise(1e-2, 1e-2)),
        full_grads("layer_norm full-model gradients", "UNet L0 transformer LN (40960,320) bf16",
                   with_dy(norm_inputs((40960, 320), 320, bf), (40960, 320)),
                   lambda x, w, b: N.layer_norm(x, w, b, 1e-5), lambda x, w, b: N.layer_norm_plain(x, w, b, 1e-5),
                   ("dx", "d weight", "d bias"), _elementwise(1e-2, 1e-2)),
    ]
    # The ModelScope path's shapes (`ms_path_shapes`: the MS UNet at
    # 16x256x256, the VAE's decode at 256x256 with its mid block at S = 1024,
    # D = 512, the full-depth text tower), each kernel held to its plain twin
    # and timed, and B5 at the trained text tower's rows (3 x 77, phase 16):
    # last, after the earlier PRs' cases
    ms_shapes = {k: set() for k in MS_KERNELS}
    for part in ms_path_shapes().values():
        for k, c in part.items():
            ms_shapes[k] |= set(c)
    ms = []
    for b, h, sq, sk, d in sorted(ms_shapes["flash_attention"]):
        why, atol = (why_short, 2e-2) if sk <= 77 else (why_bf, 2e-3)
        ms.append(flash(f"MS ({b},{h},{sq},{sk},{d}) bf16", attn(b, sq, h, d, bf, sk=sk), atol, 2e-2, 5, why,
                        f64=False, kernel="flash_attention_d512" if d == 512 else "flash_attention"))
    ms += [small_seq(f"MS ({r},{t},{h},64) bf16", attn(r, t, h, 64, bf), (r, t, h), iters=10)
           for r, t, h in sorted(ms_shapes["small_seq_attention"])]
    ms += [conv(f"MS {shape[1]}->{shape[4]} ({shape[5]},{shape[6]}) {shape[:4]} bf16", shape, iters=5, f64=False)
           for shape in sorted(ms_shapes["fused_gn_silu_conv"])]
    ms += [gn(f"MS GN+SiLU {shape} bf16", shape, shape[1], 1e-6, 5) for shape in sorted(ms_shapes["group_norm"])]
    ms += [gn_stats(f"B7 statistics, MS {shape} bf16", shape, shape[1], False, iters=5)
           for shape in sorted(ms_shapes["group_norm_stats"])]
    ms += [ln(f"MS LN {shape} bf16", shape, shape[1], bf, 1e-2, why_norm_bf)
           for shape in sorted(ms_shapes["layer_norm"] | {(3 * 77, 1024)})]
    # The 48-frame request's UNet shapes (`serving_48_shapes`: every kernel
    # at batch 48 or over 48 frames; its decode runs in 16-frame chunks, the
    # 16-frame path's shapes), each held to its plain twin, checked only
    # (the " (48 frames)" names are not records): last, after the MS cases
    u48 = serving_48_shapes()["unet"]
    why_round = ("bf16 output; the two paths round the probabilities to bf16 at different points (the kernel "
                 "unnormalised, plain normalised), which moves an output by up to 2^-8*max|v|, ~0.02 for N(0,1) "
                 "values, at any key count; both are also held to f64 math below")
    f48 = [flash(f"48 frames ({b},{h},{sq},{sk},{d}) bf16", attn(b, sq, h, d, bf, sk=sk), 2e-2, 2e-2, 3, why_round)
           for b, h, sq, sk, d in sorted(u48["flash_attention"])]
    for r, t, h in sorted(u48["small_seq_attention"]):
        f48.append(small_seq(f"48 frames ({r},{t},{h},64) bf16", attn(r, t, h, 64, bf), (r, t, h), iters=3))
        f48[-1].update(tols=[_elementwise(2e-2, 2e-2)], why=why_round.replace(
            "the kernel unnormalised, plain normalised", "after f32 sums in another order"))
    f48 += [conv(f"48 frames {shape[1]}->{shape[4]} ({shape[5]},{shape[6]}) {shape[:4]} bf16", shape, iters=3,
                 f64=False) for shape in sorted(u48["fused_gn_silu_conv"])]
    f48 += [gn(f"48 frames GN+SiLU {shape} bf16", shape, shape[1], 1e-5, 3) for shape in sorted(u48["group_norm"])]
    f48 += [gn_stats(f"B7 statistics, 48 frames {shape} bf16", shape, shape[1], False, iters=3)
            for shape in sorted(u48["group_norm_stats"])]
    f48 += [ln(f"48 frames LN {shape} bf16", shape, shape[1], bf, 1e-2, why_norm_bf) for shape in sorted(u48["layer_norm"])]
    for case in f48:
        case["kernel"] += " (48 frames)"
    table = (serving + train + fwd_path + b7_unet + norms + b8_more + b6 + packed + encoder_gn + towers + full_model
            + ms + f48)
    table += _lvdm_cases(table, attn, flash, conv, gn, gn_stats, ln, small_seq, why_short, why_round)
    return table + _sharded_cases(table, attn, flash, conv, gn, gn_stats, ln, small_seq, norm_inputs, unfused,
                                  why_round)


# B1's records at the image-conditioned UNet's new key lengths
SK_RECORDS = {4: "flash_attention_sk4", 16: "flash_attention_sk16", 200: "flash_attention_sk200"}


def lvdm_path_shapes():
    """{kernel (a dry-run key): set of shapes} launched by the image
    conditioning and UNet switches phases (`image_path_shapes`,
    `switch_path_shapes`)."""
    import collections

    shapes = collections.defaultdict(set)
    for runs in (image_path_shapes(), switch_path_shapes()):
        for part in runs.values():
            for k, c in part.items():
                shapes[k] |= set(c)
    return shapes


def _lvdm_cases(cases_before, attn, flash, conv, gn, gn_stats, ln, small_seq, why_short, why_round):
    """Phase 3's cases for the image conditioning and UNet switches phases:
    every (kernel, shape) of their meta-device dry runs must be held by a
    case of the table (a case's `holds`: its kernel on the path's route and
    dtype at that shape), or fails. The cases added here, each held to its
    plain twin (and f64 where the kernel has such a check), on its route,
    and launched twice with equal bits (`twice`): B1 at the new key lengths
    4, 16 and 200 (SK_RECORDS) and B7 / B4's statistics mode with the FiLM
    (`fused_gn_silu_conv_film`, `group_norm_stats_film`), at every shape of
    the paths and recorded under those names (level 0 first, whose times
    the record keeps); and, checked only as "<kernel> (lvdm)", the paths'
    other shapes that no earlier case holds (the image tower's and the
    Resampler's LayerNorm rows, UNet GroupNorm and B7-statistics shapes of
    every VC2 pass that no case held before)."""
    import torch

    bf = torch.bfloat16
    shapes = lvdm_path_shapes()
    held = {key for case in cases_before for key in case.get("holds", ())}
    cases = []
    for b, h, sq, sk, d in sorted(shapes["flash_attention"], key=lambda s: (s[3], -s[2], s[4])):
        if sk in SK_RECORDS:
            why = why_short if sk <= 77 else why_round
            cases.append(flash(f"lvdm ({b},{h},{sq},{sk},{d}) bf16", attn(b, sq, h, d, bf, sk=sk), 2e-2, 2e-2, 5,
                               why, kernel=SK_RECORDS[sk]))
    for shape in sorted(shapes["fused_gn_silu_conv film"], key=lambda s: (-s[2] * s[3], s)):
        cases.append(conv(f"lvdm {shape[1]}->{shape[4]} ({shape[5]},{shape[6]}) {shape[:4]} bf16, FiLM", shape,
                          film=True, iters=5))
        cases[-1]["kernel"] = "fused_gn_silu_conv_film"
    for shape in sorted(shapes["group_norm_stats film"], key=lambda s: (-prod(s[2:]), s)):
        cases.append(gn_stats(f"B7 statistics, lvdm {shape} bf16, FiLM", shape, shape[1], True, iters=5))
        cases[-1]["kernel"] = "group_norm_stats_film"
    held |= {key for case in cases for key in case["holds"]}
    others = {  # a checked-only case for a shape of the family
        "group_norm": lambda s: gn(f"lvdm GN+SiLU {s} bf16", s, s[1], 1e-6, 3),
        "group_norm_stats": lambda s: gn_stats(f"B7 statistics, lvdm {s} bf16", s, s[1], False, iters=3),
        "layer_norm": lambda s: ln(f"lvdm LN {s} bf16", s, s[1], bf, 1e-2, "bf16 output; f32 statistics summed "
                                   "in another order can move a value by one bf16 ulp"),
        "fused_gn_silu_conv": lambda s: conv(f"lvdm {s[1]}->{s[4]} ({s[5]},{s[6]}) {s[:4]} bf16", s, iters=3),
        "small_seq_attention": lambda s: small_seq(f"lvdm ({s[0]},{s[1]},{s[2]},64) bf16",
                                                   attn(s[0], s[1], s[2], 64, bf), s, iters=3),
        "flash_attention": lambda s: flash(f"lvdm {s} bf16", attn(s[0], s[2], s[1], s[4], bf, sk=s[3]), 2e-2, 2e-2,
                                           3, why_round),
    }
    for family, make in others.items():
        for shape in sorted(s for s in shapes[family] if (family, s) not in held):
            cases.append(make(shape))
            cases[-1]["kernel"] = f"{family} (lvdm)"
            held |= set(cases[-1]["holds"])
    for case in cases:
        case["twice"] = True
    missing = sorted((k, s) for k, ss in shapes.items() for s in ss if (k, s) not in held)
    if missing:
        raise AssertionError(f"phase 3 holds no case for these launches of the lvdm phases: {missing}")
    return cases


# The training path's attentions (B, Sq, Sk, H, D): every UNet attention the
# student's gradient-carrying forward runs, plus ragged, strided and f32; and,
# with reward feedback, ViCLIP's and the VAE decoder's mid-block attention
# (one head of 512, recorded under the `_d512` names), once a step in each of
# the two decodes: 8 frames for the video reward, 5 for the image reward
# (the record keeps the first's times), then the D = 512 kernels' tile edges
# (ragged S; S one row past two 64-row tiles; Sk one row past two 32-row
# tiles; Sk < 64 and Sq != Sk); the unaligned and f32 rows at D = 512 are
# checked under their own names (`... on packed`, `... on f32`), so that the
# `_d512` records hold the wgmma kernels alone. The last field: the
# backward kernels are held to their twins by B1's element-wise bound, not
# the 2e-2*max(1,|ref|) of the rows before them.
TRAIN_ATTENTION_CASES = [
    ("UNet L0 self-attn (16,5,2560,2560,64) bf16", (16, 2560, 2560, 5, 64), "bfloat16", 5, False),
    ("UNet L1 self-attn (16,10,640,640,64) bf16", (16, 640, 640, 10, 64), "bfloat16", 10, False),
    ("UNet L0 cross-attn (16,5,2560,77,64) bf16", (16, 2560, 77, 5, 64), "bfloat16", 10, False),
    ("UNet L0 temporal attn (2560,5,16,16,64) bf16", (2560, 16, 16, 5, 64), "bfloat16", 10, False),
    ("init_attn temporal (2560,8,16,16,64) bf16", (2560, 16, 16, 8, 64), "bfloat16", 10, False),
    ("ragged S (2,5,1111,1111,64) bf16", (2, 1111, 1111, 5, 64), "bfloat16", 5, False),
    # S one row past two 64-row tiles; Sk one row past one; Sq != Sk with Sk < 64
    ("tile edges (2,5,129,129,64) bf16", (2, 129, 129, 5, 64), "bfloat16", 3, False),
    ("tile edges (2,5,191,65,64) bf16", (2, 191, 65, 5, 64), "bfloat16", 3, False),
    ("short keys (2,5,100,40,64) bf16", (2, 100, 40, 5, 64), "bfloat16", 3, False),
    ("unaligned strided BSHD (2,5,300,300,64) bf16", (2, 300, 300, 5, 64), "unaligned", 5, False),
    ("UNet L1 self-attn (16,10,640,640,64) f32, TF32 off", (16, 640, 640, 10, 64), "float32", 3, False),
    ("ViCLIP self-attn (1,16,2049,2049,64) bf16", (1, 2049, 2049, 16, 64), "bfloat16", 10, True),
    ("VAE mid attn, video reward (8,1,2560,2560,512) bf16", (8, 2560, 2560, 1, 512), "bfloat16", 3, True),
    ("VAE mid attn, image reward (5,1,2560,2560,512) bf16", (5, 2560, 2560, 1, 512), "bfloat16", 3, True),
    ("ragged S (2,1,1111,1111,512) bf16", (2, 1111, 1111, 1, 512), "bfloat16", 3, True),
    ("tile edges (2,1,129,129,512) bf16", (2, 129, 129, 1, 512), "bfloat16", 3, True),
    ("tile edges (2,1,191,65,512) bf16", (2, 191, 65, 1, 512), "bfloat16", 3, True),
    ("short keys (2,1,100,40,512) bf16", (2, 100, 40, 1, 512), "bfloat16", 3, True),
    ("ragged unaligned strided (2,1,1111,1111,512) bf16", (2, 1111, 1111, 1, 512), "unaligned", 3, True),
    ("VAE mid attn (2,1,1111,1111,512) f32, TF32 off", (2, 1111, 1111, 1, 512), "float32", 2, True),
]


# The BLIP reward's attentions with a gradient (B, Sq, Sk, H, D): the ViT-L's
# self-attention over 197 tokens of 5 frames, BERT's cross-attention from 35
# tokens to them (its masked self-attention takes the plain path)
TOWER_ATTENTION_CASES = [
    ("BLIP ViT-L self-attn (5,16,197,197,64) bf16", (5, 197, 197, 16, 64), "bfloat16", 20, False),
    ("BLIP BERT cross-attn (5,12,35,197,64) bf16", (5, 35, 197, 12, 64), "bfloat16", 20, False),
]


def _train_attention_cases(label, shape, kind, iters, elementwise):
    """At one training shape: B2 (o held as B1's output is, and to f64; lse
    against logsumexp of the f32 logits), each B3 kernel against its twin
    given the same lse and delta, and dq, dk, dv through the autograd
    function against plain autograd (bf16: both held to f64 math)."""
    import torch

    from t2v_turbo_tpu_torch.ops import attention as A

    b, sq, sk, h, d = shape
    dtype = torch.float32 if kind == "float32" else torch.bfloat16
    scale = d**-0.5
    suffix = "_d512" if d == 512 else ""

    def base():  # q, k, v, dO
        if kind == "unaligned":
            return _unaligned(b, sq, sk, h, d, 4)()
        g = torch.Generator("cuda").manual_seed(sq * 31 + sk)
        return [torch.randn((b, s, h, d), generator=g, device="cuda").to(dtype) for s in (sq, sk, sk, sq)]

    def with_row_stats():  # q, k, v, dO, lse, delta from the plain forward
        q, k, v, do = base()
        o, lse = A.attention_lse_plain(q, k, v, scale)
        return [q, k, v, do, lse, A.attention_bwd_delta(do, o)]

    def grads(attend):
        def run(q, k, v, do):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(attend(*leaves), leaves, do)
        return run

    if dtype == torch.float32:
        o_tol, why_o, twin_tol = _elementwise(1e-5, 1e-4), "f32 with TF32 off", _of_max(1e-5)
    elif sk <= 77:  # as B1's few-key cases
        o_tol, why_o, twin_tol = _elementwise(2e-2, 2e-2), "bf16 output, few keys (as B1)", _of_max(2e-2)
    else:
        o_tol, why_o, twin_tol = _elementwise(2e-3, 2e-2), "bf16 output (as B1)", _of_max(2e-2)
    bf16 = dtype == torch.bfloat16
    if elementwise:
        twin_tol = o_tol
    # kernel vs its plain twin on the same inputs (lse and delta given): the
    # kernel rounds P and dS to bf16 (2^-9) before each product over up to
    # 2560 terms and rounds its output to bf16; the twin keeps them f32.
    why_twin = ("P and dS rounded to bf16 for their products" if bf16 else "f32 with TF32 off")
    # wgmma at both head dims on aligned bf16; unaligned, the forward at head
    # dim 64 takes the staged kernel, the backward (and D = 512) the packed
    # route (the wgmma kernels on packed copies)
    route = "f32" if not bf16 else "packed" if kind == "unaligned" else "wgmma"
    fwd_route = "staged" if route == "packed" and d == 64 else route
    if d == 512 and route != "wgmma":
        suffix += f" on {route}"
    both = lambda *a: A.flash_attention_bwd_dkv(*a, scale) + (A.flash_attention_bwd_dq(*a, scale),)
    determinism = [dict(
        kernel="flash_attention_bwd determinism", label=label, make=with_row_stats, fn=both, plain=both,
        outputs=("dk", "dv", "dq"), tols=3 * [_elementwise(0.0, 0.0)],
        why="two launches of each kernel: no atomics, a fixed summation order, so equal bits")]
    return [
        dict(kernel="flash_attention_fwd_lse" + suffix, label=label, make=lambda: base()[:3],
             fn=lambda q, k, v: A.flash_attention_lse(q, k, v, scale),
             plain=lambda q, k, v: A.attention_lse_plain(q, k, v, scale), outputs=("o", "lse"),
             tols=[o_tol, _elementwise(1e-3, 0.0)], iters=iters, library=_sdpa_fwd,
             route=(A.flash_attention_lse, fwd_route), shape=(b, h, sq, sk),
             why=f"o: {why_o}; lse: f32 sums of exp in another order",
             bound=lambda q, k, v: attention_bound(q, k, "fwd_lse"),
             **({"exact": _attention_f64} if bf16 else {})),
        dict(kernel="flash_attention_bwd_dkv" + suffix, label=label, make=with_row_stats,
             fn=lambda *a: A.flash_attention_bwd_dkv(*a, scale),
             plain=lambda *a: A.attention_bwd_dkv_plain(*a, scale), outputs=("dk", "dv"),
             tols=[twin_tol, twin_tol], why=why_twin, iters=iters, library=_sdpa_bwd,
             route=(A.flash_attention_bwd_dkv, route), bound=lambda q, k, *_: attention_bound(q, k, "bwd_dkv")),
        dict(kernel="flash_attention_bwd_dq" + suffix, label=label, make=with_row_stats,
             fn=lambda *a: A.flash_attention_bwd_dq(*a, scale),
             plain=lambda *a: A.attention_bwd_dq_plain(*a, scale), outputs=("dq",),
             tols=[twin_tol], why=why_twin, iters=iters, library=_sdpa_bwd,
             route=(A.flash_attention_bwd_dq, route), bound=lambda q, k, *_: attention_bound(q, k, "bwd_dq")),
        dict(kernel="flash_attention autograd", label=label, make=base,
             fn=grads(lambda q, k, v: A.flash_attention(q, k, v, scale)),
             plain=grads(lambda q, k, v: A.attention(q, k, v, scale=scale)), outputs=("dq", "dk", "dv"),
             tols=[] if bf16 else 3 * [_of_max(1e-5)],
             why="bf16: held to f64 math below" if bf16 else "f32 with TF32 off",
             **({"exact": _attention_grads_f64} if bf16 else {})),
    ] + (determinism if shape in ((16, 2560, 2560, 5, 64), (8, 2560, 2560, 1, 512)) else [])


def _unaligned(b, sq, sk, h, d, n, dtype=None):
    """n (B, S, H, D) tensors (bf16 unless `dtype`) whose rows start one
    element past 16-byte alignment (strided views), so the kernels take
    their element-wise path."""
    def make():
        import torch

        g = torch.Generator("cuda").manual_seed(sq)
        bufs = [torch.randn((b, s, h * d + 1), generator=g, device="cuda").to(dtype or torch.bfloat16)
                for s in (sq, sk, sk, sq)[:n]]
        return [t[..., 1:].view(b, t.shape[1], h, d) for t in bufs]
    return make


def _graphed(fn):
    """fn(*inputs) captured in a CUDA graph (after one eager warm-up call),
    its output (or each of a tuple's) filled with NaN, the graph replayed
    once: the replay's output."""
    def run(*inputs):
        import torch

        fn(*inputs)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(*inputs)
        outs = _as_tuple(out)
        for t in outs:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        outs = tuple(t.clone() for t in outs)
        del graph
        return outs if isinstance(out, tuple) else outs[0]
    return run


def _attention_f64(q, k, v):
    """(o,): softmax(q k^T / sqrt(D)) v in f64 on the same inputs."""
    import torch

    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    return (torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v.double()),)


def _fused_conv_f64(x, gs, gb, w, b, fs, fh):
    """(y,): conv(silu(film(group_norm(x)))) + bias in f64 on the same inputs."""
    import torch.nn.functional as F

    n, c = x.shape[:2]
    xd = x.double().reshape(n, 32, -1)
    mean = xd.mean(-1, keepdim=True)
    var = (xd - mean).square().mean(-1, keepdim=True)
    h = ((xd - mean) / (var + 1e-5).sqrt()).reshape(x.shape) * gs.double()[:, None, None] + gb.double()[:, None, None]
    if fs is not None:
        h = h * (1 + fs.double()[:, :, None, None]) + fh.double()[:, :, None, None]
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    return (F.conv2d(F.silu(h), w.double(), b.double(), padding=pad),)


def _attention_grads_f64(q, k, v, do):
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v in f64 on the same inputs."""
    import torch

    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, -1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (ds - (ds * p).sum(-1, keepdim=True))
    del p
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale, dv)


# A bf16 flash result must be no less accurate than the plain path's, both
# measured against f64 math on the same bf16 inputs. Both round their output
# to bf16, so their errors are quantised to bf16 ulps: the largest error may
# land one ulp (2x) apart, the mean error is the finer reading. A P.V product
# accumulated in bf16, or a row sum out of step with the rescaled
# accumulator, raises the mean error well past these factors; so would a
# backward that dropped a term or rounded dS before the delta subtraction.
F64_MEAN_FACTOR, F64_MAX_FACTOR = 1.25, 2.0


def _check_against_f64(what, label, got, ref, exact):
    """Errors of kernel and plain against f64; raises unless the kernel's are
    within the factors above of the plain path's."""
    k_err, p_err = ((t.double() - exact).abs() for t in (got, ref))
    k_max, k_mean = float(k_err.max()), float(k_err.mean())
    p_max, p_mean = float(p_err.max()), float(p_err.mean())
    ok = k_mean <= F64_MEAN_FACTOR * p_mean and k_max <= F64_MAX_FACTOR * p_max
    log(f"kernel {what}: {label}: against f64 on the same bf16 inputs: kernel max {k_max:.3e} "
        f"mean {k_mean:.3e}, plain max {p_max:.3e} mean {p_mean:.3e} (kernel mean <= "
        f"{F64_MEAN_FACTOR:g}x plain's, max <= {F64_MAX_FACTOR:g}x) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} is less accurate than the plain path at {label}")


def _timing_line(ms, plain_ms, library, bound):
    lib = ", ".join(f"{n} {t:.4g} ms" for n, t in library.items()) or "none"
    return f"kernel {ms:.4g} ms, plain {plain_ms:.4g} ms, library {lib}, bound {bound[0]:.4g} ms ({bound[1]})"


def check_wgmma_refusals():
    """No fallback in the C entries: a forward on the wgmma route that its
    kernels cannot take (an unaligned view, a scale <= 0, f32), and a
    backward (dK/dV and dQ) given an unaligned view or f32, at both head
    dims, return an error instead of running; so does a forward on the
    staged route given f32, head dim 512, a head dimension that is not
    contiguous or a non-finite scale; the pack kernel given f32 or a head
    dimension that is not contiguous; and the forward and both backward
    entries given bf16 on the f32 route code (the mma.sync kernels that
    took bf16 there are deleted)."""
    import ctypes

    import torch

    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import cuda_lib

    for d in (64, 512):
        g = torch.Generator("cuda").manual_seed(d)
        q, k, v = (torch.randn((2, 130, 1, d), generator=g, device="cuda").bfloat16() for _ in range(3))
        requests = {"unaligned q": (_unaligned(2, 130, 130, 1, d, 1)()[0], k, v, 0.125),
                    "scale -1/8": (q, k, v, -0.125), "scale 0": (q, k, v, 0.0),
                    "f32": (q.float(), k.float(), v.float(), 0.125)}
        for what, (qq, kk, vv, scale) in requests.items():
            o = torch.empty_like(qq)
            strides = A._strides(qq, kk, vv, o)
            err = cuda_lib.lib().t2v_flash_attention_fwd(
                qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(), cuda_lib.DTYPE_CODES[qq.dtype], 2, 1,
                130, 130, d, strides, ctypes.c_float(scale), A.ROUTES["wgmma"], cuda_lib.stream_ptr(qq.device))
            torch.cuda.synchronize()
            log(f"kernels: the wgmma forward at D = {d} given {what}: error {err} "
                f"({'refused, OK' if err else 'ran, FAIL'})")
            if not err:
                raise AssertionError(f"the wgmma forward at D = {d} ran a request it cannot take ({what})")
        do = torch.randn((2, 130, 1, d), generator=g, device="cuda").bfloat16()
        lse, delta = (torch.zeros((2, 1, 130), device="cuda") for _ in range(2))
        for what, (qq, kk, vv, dd) in {"unaligned q": (_unaligned(2, 130, 130, 1, d, 1)()[0], k, v, do),
                                       "f32": (q.float(), k.float(), v.float(), do.float())}.items():
            outs = [torch.empty_like(t) for t in (qq, kk, vv)]
            strides = A._strides(qq, kk, vv, dd, *outs)
            common = (cuda_lib.DTYPE_CODES[qq.dtype], 2, 1, 130, 130, d, strides, A._row_stats_strides(lse),
                      ctypes.c_float(0.125), A.ROUTES["wgmma"], cuda_lib.stream_ptr(qq.device))
            ptrs = [t.data_ptr() for t in (qq, kk, vv, dd, lse, delta)]
            errs = (cuda_lib.lib().t2v_flash_attention_bwd_dkv(*ptrs, outs[1].data_ptr(), outs[2].data_ptr(), *common),
                    cuda_lib.lib().t2v_flash_attention_bwd_dq(*ptrs, outs[0].data_ptr(), *common))
            torch.cuda.synchronize()
            log(f"kernels: the wgmma backward (dK/dV, dQ) at D = {d} given {what}: errors {errs} "
                f"({'refused, OK' if all(errs) else 'ran, FAIL'})")
            if not all(errs):
                raise AssertionError(f"the wgmma backward at D = {d} ran a request it cannot take ({what})")
    g = torch.Generator("cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 130, 1, 64), generator=g, device="cuda").bfloat16() for _ in range(3))
    wide = [torch.randn((2, 130, 1, d), generator=g, device="cuda").bfloat16() for d in (512, 128, 512, 512)]
    requests = {"f32": (q.float(), k.float(), v.float(), 0.125), "head dim 512": (wide[0], wide[2], wide[3], 0.125),
                "a head-dim stride of 2": (wide[1][..., ::2], k, v, 0.125), "scale inf": (q, k, v, float("inf"))}
    for what, (qq, kk, vv, scale) in requests.items():
        o = torch.empty(qq.shape, dtype=qq.dtype, device="cuda")
        _, strides = A._layout((qq, kk, vv, o), 3, scale)  # with the head-dim strides the staged entry checks
        err = cuda_lib.lib().t2v_flash_attention_fwd(
            qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(), cuda_lib.DTYPE_CODES[qq.dtype], 2, 1, 130,
            130, qq.shape[-1], strides, ctypes.c_float(scale), A.ROUTES["staged"], cuda_lib.stream_ptr(qq.device))
        torch.cuda.synchronize()
        log(f"kernels: the staged forward given {what}: error {err} ({'refused, OK' if err else 'ran, FAIL'})")
        if not err:
            raise AssertionError(f"the staged forward ran a request it cannot take ({what})")
    # the pack kernel refuses f32 and a head dimension that is not contiguous
    for what, xx in {"f32": q.float(), "a head-dim stride of 2": wide[1][..., ::2]}.items():
        out = torch.empty(xx.shape, dtype=torch.bfloat16, device="cuda")
        err = cuda_lib.lib().t2v_pack_bshd(
            xx.data_ptr(), out.data_ptr(), cuda_lib.DTYPE_CODES[xx.dtype], *xx.shape,
            (ctypes.c_longlong * 4)(*xx.stride()), A.PACK_MODES["as_is"], cuda_lib.stream_ptr(xx.device))
        torch.cuda.synchronize()
        log(f"kernels: the pack kernel given {what}: error {err} ({'refused, OK' if err else 'ran, FAIL'})")
        if not err:
            raise AssertionError(f"the pack kernel ran a request it cannot take ({what})")
    # bf16 on the f32 route code, which the deleted mma.sync kernels shared
    for d in (64, 512):
        qq, kk, vv, dd = (torch.randn((2, 130, 1, d), generator=g, device="cuda").bfloat16() for _ in range(4))
        o = torch.empty_like(qq)
        lse, delta = (torch.zeros((2, 1, 130), device="cuda") for _ in range(2))
        code = cuda_lib.DTYPE_CODES[torch.bfloat16]
        stream = cuda_lib.stream_ptr(qq.device)
        errs = (
            cuda_lib.lib().t2v_flash_attention_fwd(
                qq.data_ptr(), kk.data_ptr(), vv.data_ptr(), o.data_ptr(), code, 2, 1, 130, 130, d,
                A._strides(qq, kk, vv, o), ctypes.c_float(0.125), A.ROUTES["f32"], stream),
            cuda_lib.lib().t2v_flash_attention_bwd_dkv(
                *(t.data_ptr() for t in (qq, kk, vv, dd, lse, delta)), o.data_ptr(), o.data_ptr(), code, 2, 1, 130,
                130, d, A._strides(qq, kk, vv, dd, o, o, o), A._row_stats_strides(lse), ctypes.c_float(0.125),
                A.ROUTES["f32"], stream),
            cuda_lib.lib().t2v_flash_attention_bwd_dq(
                *(t.data_ptr() for t in (qq, kk, vv, dd, lse, delta)), o.data_ptr(), code, 2, 1, 130, 130, d,
                A._strides(qq, kk, vv, dd, o, o, o), A._row_stats_strides(lse), ctypes.c_float(0.125),
                A.ROUTES["f32"], stream))
        torch.cuda.synchronize()
        log(f"kernels: bf16 at D = {d} on the f32 route code (forward, dK/dV, dQ): errors {errs} "
            f"({'refused, OK' if all(errs) else 'ran, FAIL'})")
        if not all(errs):
            raise AssertionError(f"a flash entry ran bf16 at D = {d} on the f32 route code")


def phase_kernels(records):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check_wgmma_refusals()
    for case in _kernel_cases():
        name, label = case["kernel"], case["label"]
        inputs = case["make"]()
        counter, route = case.get("route") or (None, None)  # a backward kernel's expected route
        before = counter.by_route.copy() if counter else None
        got = _as_tuple(case["fn"](*inputs))
        torch.cuda.synchronize()
        taken = dict(counter.by_route - before) if counter else None
        ref = _as_tuple(case["plain"](*inputs))
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        ok, errs = finite, []
        for g, r, (tol, _) in zip(got, ref, case["tols"]):
            err = (g.float() - r.float()).abs()
            errs.append(float(err.max()))
            ok = ok and bool((err <= tol(r.float())).all())
            del err
        if counter:
            ok = ok and taken == {route: 1}
        bits = ""
        if case.get("twice"):  # a second launch must give the first one's bits
            same = all(torch.equal(a, b) for a, b in zip(got, _as_tuple(case["fn"](*inputs))))
            ok, bits = ok and same, f"two launches equal bits {same}; "
        line = f"kernel {name}: {label}: finite {finite}; " + "".join(
            f"{n} max_abs_err {e:.3e} (<= {text}); " for n, e, (_, text) in zip(case["outputs"], errs, case["tols"])
        ) + (f"route {taken} (expected {route}); " if counter else "") + bits + f"({case['why']}) " \
            f"{'OK' if ok else 'FAIL'}"
        if name in KERNELS:
            library = {n: cuda_time_ms(c, case["iters"]) for n, c in case["library"](*inputs).items()}
            times = (cuda_time_ms(lambda: case["fn"](*inputs), case["iters"]),
                     cuda_time_ms(lambda: case["plain"](*inputs), case["iters"]),
                     min(library.values(), default=None))  # the fastest library call
            bound = case["bound"](*inputs)
            line += "; " + _timing_line(*times[:2], library, bound)
            graph = _graph_times(case, inputs, bound) if case.get("graph") else None
            if graph is not None:
                line += graph[1]
            for n, c in case.get("beside", {}).items():  # logged only
                line += f"; {n} {cuda_time_ms(lambda c=c: c(*inputs), case['iters']):.4g} ms"
            record(records, name, max(errs), *times, bound, graph_ms=graph and graph[0])
        log(line)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {label}")
        if "exact" in case:
            for n, g, r, e in zip(case["outputs"], got, ref, case["exact"](*inputs)):
                _check_against_f64(name, f"{label} {n}", g, r, e)
        del inputs, got, ref
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True


def _graph_times(case, inputs, bound):
    """(kernel graph ms, log text): the kernel and its library calls by
    CUDA-graph replay over enough copies of the inputs that their bytes come
    from device memory (apps/time_norms.py's `graph_ms`): the device time
    that the norms' host-bound back-to-back calls hide."""
    import functools

    from t2v_turbo_tpu_torch.apps.time_norms import copies_for, copy_inputs, graph_ms

    x = inputs[0]
    sets = [inputs] + [copy_inputs(inputs) for _ in range(copies_for(2 * x.numel() * x.element_size()) - 1)]
    ms = graph_ms([functools.partial(case["fn"], *s) for s in sets], case["iters"])
    library = {n: graph_ms([case["library"](*s)[n] for s in sets], case["iters"]) for n in case["library"](*inputs)}
    text = (f"; by graph replay over {len(sets)} input set(s): kernel {ms:.4g} ms ({bound[0] / ms:.0%} of the "
            f"bound)" + "".join(f", {n} {t:.4g} ms" for n, t in library.items()))
    del sets
    return ms, text


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _timed_forward(module, store):
    """Hooks recording each forward's wall time (synchronised) into `store`."""
    import torch

    def pre(_m, _a):
        torch.cuda.synchronize()
        store.append(-time.perf_counter())

    def post(_m, _a, _o):
        torch.cuda.synchronize()
        store[-1] += time.perf_counter()

    return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]


def phase_main_path(records):
    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps.generate import build_pipeline, parse_args
    from t2v_turbo_tpu_torch.pipelines.vc2 import video_to_uint8

    t0 = time.perf_counter()
    args = parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device", "cuda:0"])
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in m.parameters())
                for n, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_model))}
    log(f"main path: pipeline built in {time.perf_counter() - t0:.1f} s; parameters {n_params}")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    video_s = []
    for i, prompt in enumerate(PROMPTS):
        gen = torch.Generator(device="cuda").manual_seed(1000 + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = pipe(prompt=prompt, height=320, width=512, frames=16, num_inference_steps=4,
                     generator=gen)
        torch.cuda.synchronize()
        video_s.append(time.perf_counter() - t0)
        v = video.float()
        finite = bool(torch.isfinite(v).all())
        spread = float(v.max() - v.min()) if finite else float("nan")
        log(f"main path: video {i}: shape {tuple(video.shape)} {video.dtype}, finite {finite}, "
            f"min {float(v.min()):.4f} max {float(v.max()):.4f} std {float(v.std()):.4f}, "
            f"{video_s[-1]:.3f} s")
        if tuple(video.shape) != (1, 16, 320, 512, 3) or not finite or not spread > 0:
            raise AssertionError(f"video {i} is malformed")
        if i == 0:
            os.makedirs(OUT_DIR, exist_ok=True)
            path = os.path.join(OUT_DIR, "chip_smoke_video0.npy")
            np.save(path, video_to_uint8(video)[0])  # (T, H, W, 3) uint8, as save_video writes .npy
            log(f"main path: wrote {os.path.relpath(path, HERE)}")
    launches = {n: c for n, c in read_launches().items() if n in SERVING_KERNELS or n == D512_SERVING}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: s/video (videos 2-3, no hooks) {' '.join(f'{s:.3f}' for s in video_s[1:])}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"main path: kernel launches {launches}")
    check_flash_routes("main path", len(PROMPTS) * 4, "UNet pass")  # 4 UNet steps a video
    check_conv_routes("main path", len(PROMPTS) * 4)
    check_norm_routes("main path", len(PROMPTS), "video")
    check_small_seq("main path", len(PROMPTS) * 4, "UNet pass")
    seq = {n: c for n, c in read_launches().items() if n in SEQ_KERNELS}
    log(f"main path: sequence-parallel entries' launches {seq} (none without a mesh) "
        f"{'OK' if not any(seq.values()) else 'FAIL'}")
    if any(seq.values()):
        raise AssertionError(f"main path: the single-device path launched sequence-parallel entries {seq}")
    for name, n in launches.items():
        records[name]["launches"] = n
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    for name in ("flash_attention_staged", "flash_attention_fwd_lse_staged"):  # B6: no path launches it
        records[name]["launches"] = wrappers()[name[:-len("_staged")]].by_route["staged"]
    for name, wrapper in PACKED_RECORDS:  # B6's packed route: no path launches it either
        records[name]["launches"] = wrappers()[wrapper].by_route["packed"]
    records["pack_bshd"]["launches"] = wrappers()["pack_bshd"].launches
    _stage_times(pipe)
    _profile_one_video(pipe)


def _stage_times(pipe):
    """One more video with the text tower, each UNet step and the decoder
    timed by synchronised forward hooks (which the s/video runs lack)."""
    import numpy as np
    import torch

    unet_s, text_s, dec_s = [], [], []
    hooks = (_timed_forward(pipe.unet, unet_s) + _timed_forward(pipe.text_model, text_s)
             + _timed_forward(pipe.vae.decoder, dec_s))
    pipe(prompt=PROMPTS[1], generator=torch.Generator(device="cuda").manual_seed(1500))
    for h in hooks:
        h.remove()
    log(f"stages: ms/UNet step {1e3 * np.mean(unet_s):.1f} (over {len(unet_s)}); text encode ms "
        f"{1e3 * sum(text_s):.1f}; VAE decode ms {1e3 * sum(dec_s):.1f}")


def _profiled(fn, name, cpu=True):
    """(fn's result, wall ms, device-kernel ms, CUDA events) of one call
    under torch.profiler; the op table into chiprun_out/<name>. `cpu=False`
    traces the device alone (a long call's CPU ops make the tables slow)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = averages.table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=90)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms\n{table}\n")
    return out, wall_ms, busy_ms, events


def _profile_one_video(pipe, name="profile.txt", what="profile", **call_kw):
    """torch.profiler over one more video (the pipeline call's defaults, or
    `call_kw`): device time by kernel and the device's idle share of the
    wall time, into chiprun_out/<name>."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2000)
    _, wall_ms, busy_ms, events = _profiled(lambda: pipe(prompt=PROMPTS[0], generator=gen, **call_kw), name)
    b7_ms = sum(e.self_device_time_total for e in events if "gn_silu_conv" in e.key) / 1e3
    fwd_ms, _, fwd512_ms, _ = flash_device_ms(events)
    log(f"{what}: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the fused conv's kernels (B7) {b7_ms:.1f} ms; the flash "
        f"forward's kernels (B1) {fwd_ms:.2f} ms, of which D = 512 {fwd512_ms:.2f}; the short-sequence "
        f"attention (B8) {small_seq_device_ms(events):.3f} ms; " + _norm_profile(events) + f" -> chiprun_out/{name}")


def phase_reference(records):
    """A small f32 pipeline on the card (kernels) against the CPU (plain
    versions); B8's f32 launches there are its f32 record's."""
    import copy

    import torch

    from t2v_turbo_tpu_torch.config import VC2ModelSpec
    from t2v_turbo_tpu_torch.models import (
        AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig, seeded_init_,
    )
    from t2v_turbo_tpu_torch.pipelines.vc2 import T2VTurboVC2Pipeline
    from t2v_turbo_tpu_torch.utils.tokenizer import CLIPTokenizer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = VC2ModelSpec(
        unet=UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2),
                        channel_mult=(1, 2), context_dim=64, time_cond_proj_dim=256),
        vae=VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1),
        text=CLIPTextConfig(width=64, heads=2, layers=3),
    )
    cpu = [seeded_init_(UNetModel(spec.unet), 1), seeded_init_(AutoencoderKL(spec.vae), 2),
           seeded_init_(CLIPTextModel(spec.text), 3)]
    gpu = [copy.deepcopy(m).cuda() for m in cpu]
    videos = []
    g = torch.Generator().manual_seed(7)
    latents = torch.randn((1, 2, 32, 32, 4), generator=g)
    noise = [torch.randn(latents.shape, generator=g) for _ in range(2)]
    reset_launches()
    for (unet, vae, text), device in ((cpu, "cpu"), (gpu, "cuda:0")):
        pipe = T2VTurboVC2Pipeline(unet=unet.eval(), vae=vae.eval(), text_model=text.eval(),
                                   tokenizer=CLIPTokenizer(), schedule=spec.make_schedule(),
                                   device=device, dtype=torch.float32)
        videos.append(pipe(prompt=PROMPTS[0], height=256, width=256, frames=2, num_inference_steps=2,
                           latents=latents, noise=noise).cpu())
    err = float((videos[0] - videos[1]).abs().max())
    scale = float(videos[0].abs().max())
    launches = {n: c for n, c in read_launches().items() if n in SERVING_KERNELS}
    records["small_seq_attention_f32"]["launches"] = launches["small_seq_attention"]
    ok = err <= 1e-3 * max(1.0, scale) and all(n > 0 for n in launches.values())
    log(f"reference: 2-step f32 pipeline, 2x256x256, card vs CPU: max_abs_err {err:.3e} "
        f"(|ref| max {scale:.3f}; bound 1e-3*max(1,|ref|): f32, TF32 off, sums in another order), "
        f"card launches {launches} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's pipeline disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


def _moved(before, after, what):
    """Raise unless every tensor of `after` differs from `before`."""
    import torch

    still = [n for n in before if torch.equal(before[n], after[n])]
    if still:
        raise AssertionError(f"{len(still)} LoRA {what} factors did not move (first: {still[0]})")


def phase_training(records, step_times):
    """Full-width v1 LoRA LCD training through apps/train_v1.py's builder;
    its s/step (steps 2-4) into step_times["synthetic step_once"]."""
    import gc

    import torch

    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            step_times["synthetic step_once"] = _train_full_width(records, remat)
            return
        except torch.cuda.OutOfMemoryError:
            if remat:
                raise
            log("training: out of memory without --use-remat; running with it")


def _train_full_width(records, remat):
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch import lora as L
    from t2v_turbo_tpu_torch.apps import train_v1

    argv = ["--random-weights", "--synthetic-data", "--device", "cuda:0", "--seed", "0",
            "--output-dir", os.path.join(OUT_DIR, "train_v1"), "--max-steps", "4",
            "--checkpointing-steps", "1000000"] + (["--use-remat"] if remat else [])
    t0 = time.perf_counter()
    trainer, data, _ = train_v1.build_trainer(train_v1.parse_args(argv))
    torch.cuda.synchronize()
    n_student = sum(v.numel() for v in L.base_state_dict(trainer.student).values())
    log(f"training: built in {time.perf_counter() - t0:.1f} s ({' '.join(argv)}); mode "
        f"{'--use-remat' if remat else 'no remat'}; student {n_student} frozen parameters, "
        f"LoRA rank {trainer.cfg.lora_rank} on {len(trainer.factors)} modules, "
        f"{L.count_lora_params(trainer.factors)} trainable; optimizer moments {trainer.optimizer.moments}")
    frozen = {f"student.{k}": v.clone() for k, v in L.base_state_dict(trainer.student).items()}
    frozen.update({f"teacher.{k}": v.clone() for k, v in trainer.teacher.state_dict().items()})
    factors0 = {n: {k: t.detach().clone() for k, t in f.items()} for n, f in trainer.factors.items()}
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step_once(next(data))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        log(f"training: step {i + 1}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.3f} s, loss {loss:.6f}, "
            f"grad_norm {gnorm:.6f}, max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0):
            raise AssertionError(f"training step {i + 1}: loss {loss}, grad_norm {gnorm}")
        if i < 2:  # up starts at 0: it moves at step 1, down from step 2 on
            kind = ("up", "down")[i]
            _moved({n: f[kind] for n, f in factors0.items()},
                   {n: f[kind].detach() for n, f in trainer.factors.items()}, kind)
            log(f"training: after step {i + 1} every LoRA {kind} factor moved ({len(factors0)})")
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS}
    log(f"training: kernel launches over the 4 steps {launches}")
    check_flash_routes("training", 4, "step")
    check_conv_routes("training", 4 * 4)  # 4 steps of 4 UNet passes (student, teacher x2, target)
    check_norm_routes("training", 4, "step")
    check_small_seq("training", 4, "step", shapes=False)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the training path")
        if name not in SERVING_KERNELS:
            records[name]["launches"] = n
    now = {f"student.{k}": v for k, v in L.base_state_dict(trainer.student).items()}
    now.update({f"teacher.{k}": v for k, v in trainer.teacher.state_dict().items()})
    changed = [k for k in frozen if not torch.equal(frozen[k], now[k])]
    if changed:
        raise AssertionError(f"{len(changed)} frozen weights changed (first: {changed[0]})")
    log(f"training: {len(frozen)} frozen tensors (student base and teacher) bitwise unchanged")
    log(f"training: s/step (steps 2-4, {'--use-remat' if remat else 'no remat'}) "
        f"{' '.join(f'{s:.3f}' for s in step_s[1:])} (mean {np.mean(step_s[1:]):.3f}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del frozen, now, factors0
    _profile_train_step(trainer, data, "profile_train.txt")
    return step_s[1:]


def _profile_train_step(trainer, data, name):
    """torch.profiler over one more training step: device time by kernel and
    the idle share, into chiprun_out/<name>. The device alone is traced: a
    step's CPU ops made `key_averages()` take tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host_batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step_once(host_batch)["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = averages.table(sort_by="self_cuda_time_total", row_limit=50, max_name_column_width=90)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms\n{table}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    b7_ms = sum(e.self_device_time_total for e in events if "gn_silu_conv" in e.key) / 1e3
    fwd_ms, bwd_ms, fwd512_ms, bwd512_ms = flash_device_ms(events)
    log(f"training profile: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the fused conv's forward kernels (B7) {b7_ms:.1f} ms; flash "
        f"forward (B1, B2) {fwd_ms:.2f} ms (D = 512: {fwd512_ms:.2f}), backward (B3) {bwd_ms:.1f} ms "
        f"(D = 512: {bwd512_ms:.2f}); B8 {small_seq_device_ms(events):.3f} ms; " + _norm_profile(events)
        + f" -> chiprun_out/{name}; top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms" for e in top))


# The H100 host this script targets has no libav (no libavcodec / libavformat / libswscale
# in `ldconfig -p`, none of their headers, no ffmpeg), so the native decoder
# cannot be built there and the training on real data phase starts at
# decoded frames: apps/time_prefetch.py's `decoded_clips` (seeded uint8
# clips at WebVid's 360x640 through the port's resize, random crop and
# `normalize_video`), handed to build_trainer as its raw batches in place
# of --data-shards.
ENCODER_D512 = (16, 1, 2560, 2560, 512)  # the VAE encoder's mid-block attention, 16 frames at 320x512


def held_gn_shapes():
    """The bf16 shapes at which phase 3's B4 cases hold the kernel to its
    plain version."""
    import torch

    return {c["shape"] for c in _kernel_cases() if c["kernel"] == "group_norm" and c.get("dtype") == torch.bfloat16}


def phase_training_real_data(step_times):
    """Full-width v1 LoRA LCD training on decoded video through
    apps/train_v1.py's build_trainer: the VC2 VAE and text tower (seeded,
    frozen, bf16) encode each batch in the trainer's prefetcher while the
    step runs. Logs phase 6's s/step (`step_times`) beside its own."""
    import gc
    import shutil

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    out_dir = os.path.join(HERE, "build", "chip_smoke_train_real")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        _train_real_data(out_dir, step_times.get("synthetic step_once", []))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def _encode_batch_checks(data, size_hw, frames):
    """The first batch of the trainer's iterator (make_data_iter's
    full-width branch): shapes, finite values, and the encoder's kernels:
    B1 at head dim 512 once an encode on wgmma, every GroupNorm on a staged
    route at a shape phase 3 holds."""
    import torch

    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import norms as N

    reset_launches()
    batch = next(data)
    torch.cuda.synchronize()
    d512 = dict(A.flash_attention.by_shape)
    gn_shapes = dict(N.fused_group_norm.by_shape)
    check_flash_routes("real data encode", 1, "encode")
    check_norm_routes("real data encode", 1, "encode")
    ok = (tuple(batch["latents"].shape) == (1, frames, size_hw[0] // 8, size_hw[1] // 8, 4)
          and tuple(batch["ctx"].shape) == (1, 77, 1024) and tuple(batch["uncond_ctx"].shape) == (1, 77, 1024)
          and all(bool(torch.isfinite(batch[k]).all()) for k in ("latents", "ctx", "uncond_ctx"))
          and batch["latents"].dtype == torch.float32 and not batch["latents"].is_inference())
    log(f"real data: the trainer's first batch: latents {tuple(batch['latents'].shape)} (|max| "
        f"{float(batch['latents'].abs().max()):.3f}), ctx {tuple(batch['ctx'].shape)}, uncond_ctx "
        f"{tuple(batch['uncond_ctx'].shape)}, all finite f32, not inference tensors {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the encoded batch has the wrong shape, dtype or non-finite values")
    want = {ENCODER_D512: 1}
    if d512 != want:
        raise AssertionError(f"the encode's flash forward launches by shape {d512}, expected {want}")
    unheld = sorted(set(gn_shapes) - held_gn_shapes())
    log(f"real data encode: B1 at head dim 512 launched once {ENCODER_D512} on wgmma OK; the encoder's "
        f"GroupNorm shapes {sorted(gn_shapes)}, each held to its plain version in phase 3 "
        f"{'OK' if not unheld else 'FAIL: not held ' + str(unheld)}")
    if unheld:
        raise AssertionError(f"encoder GroupNorm shapes no phase-3 case holds: {unheld}")


def _encode_times(args, size_hw, frames):
    """The VAE encode's and the text tower's ms a batch (CUDA events), each
    built as apps/train_v1.py builds it."""
    import torch

    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.apps.time_prefetch import decoded_clips
    from t2v_turbo_tpu_torch.models.vae import encode_video

    device, dtype = torch.device("cuda:0"), torch.bfloat16
    vae = train_v1.build_vae(args, device, dtype)
    embed = train_v1.text_embedder(train_v1.build_text_tower(args, device, dtype))
    raw = next(decoded_clips(frames, size_hw))
    video = torch.as_tensor(raw["video"]).cuda()
    with torch.no_grad():
        enc_ms = cuda_time_ms(lambda: encode_video(vae, video, scale_factor=0.18215), 3)
        text_ms = cuda_time_ms(lambda: embed(raw["txt"]), 3)
    log(f"real data: a batch of 1 x {frames} x {size_hw[0]}x{size_hw[1]}: VAE encode {enc_ms:.1f} ms, text tower "
        f"{text_ms:.1f} ms (CUDA events over 3 back-to-back calls after 2 warm-ups)")
    return enc_ms, text_ms


def _vae_card_vs_cpu(args, size_hw, frames):
    """2 frames at 320x512 through the full-width VAE's encode in f32 (TF32
    off) on the card and on the CPU, the same seeded weights."""
    import copy

    import torch

    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.apps.time_prefetch import decoded_clips

    raw = next(decoded_clips(frames, size_hw))
    x = torch.from_numpy(raw["video"][0, :2].copy())
    cpu = train_v1.build_vae(args, torch.device("cpu"), torch.float32)
    gpu = copy.deepcopy(cpu).cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = cpu.encode(x)
            got = [t.cpu() for t in gpu.encode(x.cuda())]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    ok = True
    for name, g, r in zip(("mean", "logvar"), got, ref):
        err, scale = float((g - r).abs().max()), float(r.abs().max())
        good = err <= 3e-4 * max(1.0, scale) and bool(torch.isfinite(g).all())
        ok = ok and good
        log(f"real data: full-width VAE encode of 2 frames at {size_hw[0]}x{size_hw[1]}, f32, card vs CPU: {name} "
            f"max_abs_err {err:.3e} (|ref| max {scale:.3f}; bound 3e-4*max(1,|ref|), PARITY's VAE tolerance: "
            f"sums in another order, TF32 off) {'OK' if good else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's VAE encode disagrees with the CPU's")
    del cpu, gpu


def _train_real_data(out_dir, phase6):
    import json
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch import lora as L
    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.apps.time_prefetch import SOURCE_HW, decoded_clips
    from t2v_turbo_tpu_torch.ops import attention as A

    argv = ["--random-weights", "--device", "cuda:0", "--seed", "0", "--output-dir", out_dir, "--max-steps", "4",
            "--checkpointing-steps", "1000000"]
    args = train_v1.parse_args(argv)
    size_hw, frames = (args.height, args.width), args.n_frames
    counter = {"batches": 0}
    t0 = time.perf_counter()
    trainer, data, ucfg = train_v1.build_trainer(args, raw_videos=decoded_clips(frames, size_hw, counter))
    torch.cuda.synchronize()
    log(f"real data: trainer, VC2 VAE and ViT-H text tower built in {time.perf_counter() - t0:.1f} s by "
        f"build_trainer ({' '.join(argv)}; seeded, frozen, bf16), its raw batches source clips "
        f"{frames}x{SOURCE_HW[0]}x{SOURCE_HW[1]} uint8, resized on the short side and randomly cropped to "
        f"{size_hw[0]}x{size_hw[1]} (the H100 host has no libav: decoded frames are made with numpy)")
    _encode_batch_checks(data, size_hw, frames)
    enc_ms, text_ms = _encode_times(args, size_hw, frames)
    _vae_card_vs_cpu(args, size_hw, frames)

    frozen = {f"student.{k}": v.clone() for k, v in L.base_state_dict(trainer.student).items()}
    frozen.update({f"teacher.{k}": v.clone() for k, v in trainer.teacher.state_dict().items()})
    factors0 = {n: {k: t.detach().clone() for k, t in f.items()} for n, f in trainer.factors.items()}
    counter["batches"] = 0
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = trainer.run(data)  # the prefetcher's worker is stopped and joined on the way out
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    peak = torch.cuda.max_memory_allocated() / 2**30
    for row in rows:
        log(f"real data: step {row['step']}: {row['time_per_step_s']:.3f} s, loss {row['loss']:.6f}, grad_norm "
            f"{row['grad_norm']:.6f}, data_wait_frac {row['data_wait_frac']:.4f}")
    ok = len(rows) == 4 and last["step"] == 4 and all(
        math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) and r["grad_norm"] > 0 for r in rows)
    if not ok:
        raise AssertionError(f"real-data training: {rows}")
    for kind in ("up", "down"):
        _moved({n: f[kind] for n, f in factors0.items()}, {n: f[kind].detach() for n, f in trainer.factors.items()},
               kind)
    log(f"real data: after 4 steps every LoRA up and down factor moved ({len(factors0)} modules)")
    now = {f"student.{k}": v for k, v in L.base_state_dict(trainer.student).items()}
    now.update({f"teacher.{k}": v for k, v in trainer.teacher.state_dict().items()})
    changed = [k for k in frozen if not torch.equal(frozen[k], now[k])]
    if changed:
        raise AssertionError(f"{len(changed)} frozen weights changed (first: {changed[0]})")
    log(f"real data: {len(frozen)} frozen tensors (student base and teacher) bitwise unchanged")
    encodes = counter["batches"]
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS}
    log(f"real data: kernel launches over the 4 steps and {encodes} encodes {launches}")
    check_flash_routes("real data", 4, "step")
    check_conv_routes("real data", 4 * 4)
    check_norm_routes("real data", 4, "step")
    check_small_seq("real data", 4, "step", shapes=False)
    if A.flash_attention.by_shape[ENCODER_D512] != encodes or encodes < 4:
        raise AssertionError(f"B1 at {ENCODER_D512} launched {A.flash_attention.by_shape[ENCODER_D512]} times "
                             f"for {encodes} encodes")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"not launched on the real-data training path: {missing}")
    log(f"real data: B1 at head dim 512 launched once an encode ({encodes} encodes: 4 steps and the "
        f"prefetcher's read-ahead) OK; every kernel of the training path launched")
    # the same trainer through trainer.run on synthetic batches (steps 5-8,
    # after the final checkpoint of step 4): what the data path adds
    shape = train_v1.DataShape(1, frames, (size_hw[0] // 8, size_hw[1] // 8), 77, ucfg.context_dim)
    trainer.run(train_v1.synthetic_data(shape, args.fps), max_steps=8)
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    steady = [r["time_per_step_s"] for r in rows[1:4]]
    steady_synthetic = [r["time_per_step_s"] for r in rows[5:8]]
    waits = " ".join(f"{r['data_wait_frac']:.4f}" for r in rows[1:4])

    def steps(xs):
        return f"{' '.join(f'{x:.3f}' for x in xs)} (mean {np.mean(xs) if xs else float('nan'):.3f})"

    log(f"real data: s/step (steps 2-4, trainer.run through the prefetcher) {steps(steady)}; the same trainer's "
        f"trainer.run on synthetic batches (steps 6-8) {steps(steady_synthetic)}; phase 6's synthetic step_once "
        f"s/step {steps(phase6)}; data_wait_frac steps 2-4 {waits}; real-data run wall {wall:.2f} s for 4 steps "
        f"and {encodes} encodes; encode {enc_ms:.1f} ms + text {text_ms:.1f} ms a "
        f"batch; max_memory_allocated over the real-data steps {peak:.2f} GiB")


def phase_training_rewards(records):
    """Full-width v1 LoRA LCD training with both rewards through
    apps/train_v1.py's build_trainer."""
    import gc

    import torch

    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            return _train_rewards_full_width(records, remat)
        except torch.cuda.OutOfMemoryError:
            if remat:
                raise
            log("training with rewards: out of memory without --use-remat; running with it")


def _reward_gradient_check(trainer, host_batch, what="training with rewards"):
    """The reward terms' own gradient (autograd of reward_loss +
    video_rm_loss alone) at the step's cached LoRA merge, with fresh draws:
    finite everywhere and non-zero in every LoRA up factor (the ups start
    at zero, so the downs' gradient is zero at the first step)."""
    import math

    import torch
    from torch.nn.utils import parametrize

    from t2v_turbo_tpu_torch.training.lcd import lcd_loss, sample_draws

    batch = {k: torch.as_tensor(v).to(trainer.device) for k, v in host_batch.items() if not k.startswith("_")}
    draws = sample_draws(trainer.lcd_cfg, batch["latents"].shape, torch.Generator().manual_seed(1))
    with parametrize.cached():
        for m in trainer._lora_modules:
            m.weight  # fills the cache, as the trainer does
        _, terms = lcd_loss(trainer.student, trainer.teacher, batch, draws, sched=trainer.sched,
                            solver=trainer.solver, cfg=trainer.lcd_cfg, reward_fn=trainer.reward_fn,
                            video_reward_fn=trainer.video_reward_fn)
        grads = torch.autograd.grad(terms["reward_loss"] + terms["video_rm_loss"], trainer.params)
    ups = grads[1::2]  # trainer.params alternates (down, up) per module
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    nonzero = sum(bool(g.abs().max() > 0) for g in ups)
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in ups))
    ok = finite and nonzero == len(ups)
    r, vr = (float(terms[k].detach()) for k in ("reward_loss", "video_rm_loss"))
    log(f"{what}: the reward terms' own gradient at the first step (reward_loss "
        f"{r:.6f}, video_rm_loss {vr:.6f}): finite {finite}, "
        f"non-zero in {nonzero} of {len(ups)} LoRA up factors, their norm {norm:.4e} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the reward terms give no usable gradient to the LoRA up factors")


def _train_rewards_full_width(records, remat):
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import train_v1

    steps = 4
    argv = ["--random-weights", "--synthetic-data", "--device", "cuda:0", "--seed", "0",
            "--reward-fn", "hpsv2", "--video-rm-fn", "vi_clip",
            "--output-dir", os.path.join(OUT_DIR, "train_v1_rewards"), "--max-steps", str(steps),
            "--checkpointing-steps", "1000000"] + (["--use-remat"] if remat else [])
    t0 = time.perf_counter()
    trainer, data, _ = train_v1.build_trainer(train_v1.parse_args(argv))
    first = next(data)
    torch.cuda.synchronize()
    cells = trainer.reward_fn.__closure__ + trainer.video_reward_fn.__closure__
    rf_models = {id(c.cell_contents): c.cell_contents for c in cells if isinstance(c.cell_contents, torch.nn.Module)}
    n_frozen = {type(m).__name__: sum(p.numel() for p in m.parameters()) for m in rf_models.values()}
    log(f"training with rewards: built in {time.perf_counter() - t0:.1f} s ({' '.join(argv)}); "
        f"mode {'--use-remat' if remat else 'no remat'}; frozen reward models {n_frozen}; batch fields "
        + ", ".join(f"{k} {tuple(np.shape(v))}" for k, v in first.items() if k.startswith(("reward", "video"))))
    _reward_gradient_check(trainer, first)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step_once(first if i == 0 else next(data))
        vals = {k: float(metrics[k]) for k in ("loss", "distill_loss", "reward_loss", "video_rm_loss", "grad_norm")}
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        log(f"training with rewards: step {i + 1}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.3f} s, "
            + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
            + f", max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(math.isfinite(v) for v in vals.values()) or not vals["grad_norm"] > 0:
            raise AssertionError(f"training step {i + 1} with rewards: {vals}")
    by_dim = launches_by_head_dim()
    per_step = {n: {d: c / steps for d, c in dims.items()} for n, dims in by_dim.items()}
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS + D512_KERNELS}
    log(f"training with rewards: launches a step by head dim {per_step}; over the {steps} steps {launches}")
    check_flash_routes("training with rewards", steps, "step")
    check_conv_routes("training with rewards", 4 * steps)
    check_norm_routes("training with rewards", steps, "step")
    check_small_seq("training with rewards", steps, "step", shapes=False)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the rewards-ON training path")
    for name in D512_KERNELS:
        records[name]["launches"] = launches[name]
        if launches[name] < 2 * steps:  # one a decode, two decodes a step
            raise AssertionError(f"{name}: {launches[name]} launches in {steps} steps, expected >= 2 a step")
    log(f"training with rewards: s/step (steps 2-{steps}, {'--use-remat' if remat else 'no remat'}) "
        f"{' '.join(f'{s:.3f}' for s in step_s[1:])} (mean {np.mean(step_s[1:]):.3f}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile_train_step(trainer, data, "profile_train_rewards.txt")


def phase_training_blip_iv2():
    """Full-width v1 LoRA LCD training with the BLIP (img_reward) and
    InternVideo2 (vi_clip2) rewards through apps/train_v1.py's
    build_trainer, a validation render against a direct pipeline call, then
    each tower's f32 card-vs-CPU check at published width."""
    import gc

    import torch

    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            _train_blip_iv2_full_width(remat)
            break
        except torch.cuda.OutOfMemoryError:
            if remat:
                raise
            log(f"{BLIP_IV2}: out of memory without --use-remat; running with it (the UNet's blocks and "
                f"InternVideo2's recomputed in the backward)")
    gc.collect()
    torch.cuda.empty_cache()
    _towers_card_vs_cpu()


BLIP_IV2 = "training with BLIP and InternVideo2"
# the new towers' B2 / B3 (B, H, Sq, Sk, D) and B5 (rows, C) shapes on this path
TOWER_FLASH_SHAPES = ((5, 16, 197, 197, 64), (5, 12, 35, 197, 64))
TOWER_LN_SHAPES = ((985, 1024), (175, 768), (2049, 1408), (1, 1408), (40, 1024))


def _train_blip_iv2_full_width(remat):
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import norms as N

    steps, t_phase = 4, time.perf_counter()
    argv = ["--random-weights", "--synthetic-data", "--device", "cuda:0", "--seed", "0",
            "--reward-fn", "img_reward", "--video-rm-fn", "vi_clip2",
            "--output-dir", os.path.join(OUT_DIR, "train_v1_blip_iv2"), "--max-steps", str(steps),
            "--checkpointing-steps", "1000000"] + (["--use-remat"] if remat else [])
    args = train_v1.parse_args(argv)
    trainer, data, _ = train_v1.build_trainer(args, validation=True)  # the render shares its VAE and text tower
    first = next(data)
    torch.cuda.synchronize()
    cells = trainer.reward_fn.__closure__ + trainer.video_reward_fn.__closure__
    rf_models = {id(c.cell_contents): c.cell_contents for c in cells if isinstance(c.cell_contents, torch.nn.Module)}
    n_frozen = {type(m).__name__: sum(p.numel() for p in m.parameters()) for m in rf_models.values()}
    fields = {k: v for k, v in first.items() if k.startswith(("reward", "video"))}
    log(f"{BLIP_IV2}: built in {time.perf_counter() - t_phase:.1f} s ({' '.join(argv)}); mode "
        f"{'--use-remat' if remat else 'no remat'}; frozen reward models {n_frozen}; batch fields "
        + ", ".join(f"{k} {tuple(np.shape(v))} {np.asarray(v).dtype}" for k, v in fields.items()))
    if np.asarray(first["reward_text_feats"]).dtype != np.int32:
        raise AssertionError("BLIP's text field is not int32 token ids")
    _reward_gradient_check(trainer, first, BLIP_IV2)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step_once(first if i == 0 else next(data))
        vals = {k: float(metrics[k]) for k in ("loss", "distill_loss", "reward_loss", "video_rm_loss", "grad_norm")}
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        log(f"{BLIP_IV2}: step {i + 1}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.3f} s, "
            + ", ".join(f"{k} {v:.6f}" for k, v in vals.items())
            + f", max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not all(math.isfinite(v) for v in vals.values()) or not vals["grad_norm"] > 0:
            raise AssertionError(f"{BLIP_IV2}: step {i + 1}: {vals}")
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS + D512_KERNELS}
    flash = {w.__name__: {shape: w.by_shape[shape] / steps for shape in TOWER_FLASH_SHAPES}
             for w in (A.flash_attention_lse, A.flash_attention_bwd_dkv, A.flash_attention_bwd_dq)}
    norms = {shape: N.fused_layer_norm.by_shape[shape] / steps for shape in TOWER_LN_SHAPES}
    log(f"{BLIP_IV2}: over the {steps} steps {launches}; the towers' shapes a step: B2/B3 {flash}; B5 {norms}")
    check_flash_routes(BLIP_IV2, steps, "step")
    check_conv_routes(BLIP_IV2, 4 * steps)
    check_norm_routes(BLIP_IV2, steps, "step")
    check_small_seq(BLIP_IV2, steps, "step", shapes=False)
    unlaunched = [n for n, c in launches.items() if c <= 0] + [
        f"{w} at {shape}" for w, by in flash.items() for shape, c in by.items() if c < 1] + [
        f"layer_norm at {shape}" for shape, c in norms.items() if c <= 0]
    if unlaunched:
        raise AssertionError(f"{BLIP_IV2}: not launched on the path: {unlaunched}")
    log(f"{BLIP_IV2}: s/step (steps 2-{steps}, {'--use-remat' if remat else 'no remat'}) "
        f"{' '.join(f'{s:.3f}' for s in step_s[1:])} (mean {np.mean(step_s[1:]):.3f}); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile_train_step(trainer, data, "profile_train_blip_iv2.txt")
    _validation_render(args, trainer)
    log(f"{BLIP_IV2}: the phase's training part took {time.perf_counter() - t_phase:.1f} s")


def _validation_render(args, trainer):
    """One render of the validation logger (first prompt, 4 steps, .npy) at
    the trainer's step: it must equal, bit for bit, a direct pipeline call
    with the student's weights and the prompt's seed, and leave the
    student's train and grad flags as they were."""
    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.pipelines.vc2 import video_to_uint8
    from t2v_turbo_tpu_torch.training.validation import DEFAULT_VALIDATION_PROMPTS

    fn = train_v1.build_validation_fn(args, trainer, max_prompts=1, step_counts=(4,), suffix=".npy")
    flags = [(m, m.training) for m in trainer.student.modules()]
    grads = [(p, p.requires_grad) for p in trainer.student.parameters()]
    t0 = time.perf_counter()
    fn(trainer.step, trainer.student)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    kept = all(m.training == t for m, t in flags) and all(p.requires_grad == r for p, r in grads)
    path = os.path.join(args.output_dir, "validation", f"step{trainer.step:07d}_s4_p0.npy")
    saved = np.load(path)
    os.remove(path)  # 7.5 MB of frames: the output directory keeps logs and profiles
    with torch.no_grad():
        direct = fn.pipe(prompt=DEFAULT_VALIDATION_PROMPTS[0], height=args.height, width=args.width,
                         frames=args.n_frames, num_inference_steps=4, generator=torch.Generator().manual_seed(0))
    direct = video_to_uint8(direct)[0]
    equal = saved.shape == direct.shape and bool(np.array_equal(saved, direct))
    ok = equal and kept
    log(f"{BLIP_IV2}: validation render ({DEFAULT_VALIDATION_PROMPTS[0]!r}, 4 steps, {saved.shape} uint8 .npy) in "
        f"{render_s:.2f} s; equal bits to a direct pipeline call with seed 0: {equal}; the student's train and "
        f"grad flags kept: {kept} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the validation render differs from a direct pipeline call, or moved the student's flags")


def _towers_card_vs_cpu():
    """Each new tower at published width and 2 blocks, in f32 (TF32 off):
    the training facade's score and its gradient with respect to the frames
    in [0, 1], on the card (kernels) against the CPU (plain versions), on
    the same seeded weights, frames and text field."""
    import copy
    import dataclasses

    import torch

    from t2v_turbo_tpu_torch.rewards import blip, internvideo2
    from t2v_turbo_tpu_torch.rewards import reward_fn as R

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(41)
    image_rm = R.BlipTrainReward(blip.build_image_reward_blip(
        vit_cfg=blip.BlipViTConfig(layers=2), bert_cfg=blip.BertConfig(layers=2), seed=42))
    video_rm = R.InternVideo2TrainReward(internvideo2.build_internvideo2_reward(
        vision_cfg=internvideo2.IV2VisionConfig(depth=2),
        text_cfg=dataclasses.replace(internvideo2.BERT_LARGE, layers=2), seed=43))
    cases = [
        ("BLIP (ViT-L/16 at 224, BERT 768 with cross-attention, the published head; 2 blocks each), 2 frames "
         "320x512", image_rm, torch.rand((2, 320, 512, 3), generator=g), image_rm.encode_texts(PROMPTS[:2]),
         ("flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "layer_norm")),
        ("InternVideo2 (1408 wide, 16 heads of 88, 2 blocks; pooling), 8 frames 320x512 -> 2049 tokens", video_rm,
         torch.rand((1, 8, 320, 512, 3), generator=g), video_rm.encode_texts(PROMPTS[:1]), ("layer_norm",)),
    ]
    for label, model, frames, field, needed in cases:
        out = {}
        for device in ("cpu", "cuda:0"):
            m = (model if device == "cpu" else copy.deepcopy(model).to(device)).requires_grad_(False).eval()
            reset_launches()
            x = frames.to(device).requires_grad_()
            s = m.score(x, field.to(device))
            (gx,) = torch.autograd.grad(s.sum(), x)
            out[device] = (s.detach().cpu(), gx.cpu(), {n: c for n, c in read_launches().items() if c})
            del m
        (s0, g0, _), (s1, g1, launches) = out["cpu"], out["cuda:0"]
        serr, gerr, gmax = float((s1 - s0).abs().max()), float((g1 - g0).abs().max()), float(g0.abs().max())
        finite = bool(torch.isfinite(s1).all() and torch.isfinite(g1).all())
        ran = all(launches.get(n, 0) > 0 for n in needed)
        ok = finite and ran and gmax > 0 and serr <= 1e-4 * max(1.0, float(s0.abs().max())) and gerr <= 1e-3 * gmax
        log(f"{BLIP_IV2}: card vs CPU, f32, {label}: scores {[round(float(v), 6) for v in s1]} vs "
            f"{[round(float(v), 6) for v in s0]}, max|diff| {serr:.3e} (<= 1e-4*max(1,|ref|)); frame gradient "
            f"max|diff| {gerr:.3e} of max|ref| {gmax:.3e} (<= 1e-3 x it); card launches {launches} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: the card disagrees with the CPU")
    torch.backends.cudnn.allow_tf32 = True


def _w_embedding_drift(w) -> float:
    """How far the card's guidance embedding of these draws' w is from the
    CPU's (max |diff|), logged with which of its two f32 functions makes the
    difference: the frequencies' torch.exp, or sin / cos of the same
    arguments."""
    import torch

    from t2v_turbo_tpu_torch.diffusion.lcm import guidance_frequencies, guidance_scale_embedding

    freqs = [guidance_frequencies(128, device).cpu() for device in ("cpu", "cuda:0")]
    rel = (freqs[1] - freqs[0]).abs() / torch.finfo(torch.float32).eps / freqs[0]
    args = (w.float() * 1000.0)[:, None] * freqs[0][None, :]
    trig = max(float((fn(args.cuda()).cpu() - fn(args)).abs().max()) for fn in (torch.sin, torch.cos))
    emb = [guidance_scale_embedding(w.to(device), 256).cpu() for device in ("cpu", "cuda:0")]
    drift = float((emb[1] - emb[0]).abs().max())
    log(f"training reference: guidance embedding of w = {[round(float(x), 4) for x in w]}, card vs CPU: "
        f"max|diff| {drift:.3e}; frequencies (torch.exp) differ in "
        f"{int((rel > 0).sum())} of 128, by up to {float(rel.max()):.2f} f32 eps relative; sin / cos of the same "
        f"f32 arguments (up to {float(args.max()):.0f} rad) differ by up to {trig:.3e}")
    return drift


def phase_training_reference():
    """One small f32 LCD step through the trainer's gradient path on the card
    (kernels; remat off and on; and with both rewards) against the CPU
    (plain versions) on the same weights, factors and draws."""
    import copy
    import dataclasses
    import functools

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch import lora as L
    from t2v_turbo_tpu_torch.apps.train_v1 import TINY_REWARD_TEXT_KW, TINY_VAE_KW, TINY_VIT_KW
    from t2v_turbo_tpu_torch.diffusion import DDIMSolver, DiffusionSchedule
    from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextConfig, UNetConfig, UNetModel, VAEConfig, seeded_init_
    from t2v_turbo_tpu_torch.rewards.reward_fn import build_image_reward_model, build_video_reward_model
    from t2v_turbo_tpu_torch.rewards.vit import VideoViTConfig, ViTConfig
    from t2v_turbo_tpu_torch.training.lcd import LCDConfig, sample_draws
    from t2v_turbo_tpu_torch.training.optim import make_optimizer
    from t2v_turbo_tpu_torch.training.reward_adapters import make_reward_fns, sample_frame_indices
    from t2v_turbo_tpu_torch.training.trainer import LCDTrainer, TrainerConfig

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     context_dim=64, time_cond_proj_dim=256)
    student_sd = seeded_init_(UNetModel(cfg), 21).state_dict()
    teacher_cfg = dataclasses.replace(cfg, time_cond_proj_dim=None)
    teacher_sd = seeded_init_(UNetModel(teacher_cfg), 22).state_dict()
    g = torch.Generator().manual_seed(23)
    factors = L.init_lora(UNetModel(cfg), L.LoRAConfig(rank=8), g)
    for f in factors.values():  # non-zero ups, so every factor has a gradient
        f["up"] = 0.05 * torch.randn(f["up"].shape, generator=g)
    batch = {"latents": torch.randn((1, 4, 16, 16, 4), generator=g), "ctx": torch.randn((1, 77, 64), generator=g),
             "uncond_ctx": torch.zeros((1, 77, 64)), "fps": torch.full((1,), 16.0)}
    draws = sample_draws(LCDConfig(), batch["latents"].shape, g)
    w_drift = _w_embedding_drift(draws.w)
    sched = DiffusionSchedule.create()
    solver = DDIMSolver.create(sched.alphas_cumprod.numpy())
    # the reward stack of apps/train_v1.py --tiny-model: the VAE's mid-block
    # attention is one head of 64, so the flash kernels run in the decode
    text_cfg = CLIPTextConfig(**TINY_REWARD_TEXT_KW)
    rewards_cpu = (seeded_init_(AutoencoderKL(VAEConfig(**TINY_VAE_KW)), 24),
                   build_image_reward_model(vit_cfg=ViTConfig(**TINY_VIT_KW), text_cfg=text_cfg, seed=25),
                   build_video_reward_model(vit_cfg=VideoViTConfig(**TINY_VIT_KW, num_frames=8), text_cfg=text_cfg,
                                            seed=26))
    rng = np.random.RandomState(27)
    reward_batch = {
        "reward_frame_idx": torch.from_numpy(sample_frame_indices(rng, 1, 4, 2)),
        "reward_text_feats": rewards_cpu[1].encode_texts([PROMPTS[0]]),
        "reward_mask": torch.ones(1),
        "video_frame_idx": torch.from_numpy(sample_frame_indices(rng, 1, 4, 4, strided=True)),
        "video_text_feats": rewards_cpu[2].encode_texts([PROMPTS[0]]),
        "video_reward_mask": torch.ones(1),
    }

    def step(device, remat, rewards):
        student = UNetModel(cfg, use_remat=remat).to(device)
        student.load_state_dict(student_sd, strict=True)
        teacher = UNetModel(teacher_cfg).to(device)
        teacher.load_state_dict(teacher_sd, strict=True)
        rf = vrf = None
        if rewards:  # decode in chunks of 2 frames: the checkpointed path
            rf, vrf = make_reward_fns(*(copy.deepcopy(m).to(device).requires_grad_(False) for m in rewards_cpu),
                                      decode_chunk=2)
        trainer = LCDTrainer(student=student, teacher=teacher, sched=sched, solver=solver,
                             lcd_cfg=LCDConfig(), optimizer=functools.partial(make_optimizer, name="adamw"),
                             cfg=TrainerConfig(output_dir=os.path.join(OUT_DIR, "train_reference"),
                                               lora_rank=8), reward_fn=rf, video_reward_fn=vrf)
        with torch.no_grad():
            for n, f in trainer.factors.items():
                for k, t in f.items():
                    t.copy_(factors[n][k])
        names = [f"{n}.{k}" for n in sorted(trainer.factors) for k in ("down", "up")]
        reset_launches()
        full = {**batch, **(reward_batch if rewards else {})}
        loss, metrics, _ = trainer.loss_and_grads({k: v.to(device) for k, v in full.items()}, draws)
        grads = [t.detach().cpu() for t in trainer._grad_views]
        return ({k: float(v) for k, v in metrics.items()}, dict(zip(names, grads)),
                {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS})

    # Bounds (f32, TF32 off; sums run in another order through three UNet
    # passes, and with rewards two VAE decodes and two towers): the loss and
    # each reward term |diff| <= 1e-4 * max(1, |ref|); each LoRA gradient's
    # max|diff| <= 1e-3 * its max|ref| + 1e-6 * the largest gradient of all.
    # time_cond_proj's factors take the guidance embedding sin / cos(w * 1000
    # * f) as input: the card's f32 torch.exp gives some of the frequencies
    # f one ulp away from the CPU's, which arguments up to 1.5e4 rad turn
    # into ~1e-3 of the embedding (sin / cos of the same arguments agree to
    # ~6e-8; both logged above). Their gradients are linear in the
    # embedding, so their bound adds twice its measured drift.
    w_input, rtol = "time_cond_proj.", 1e-3
    w_tol = rtol + 2 * w_drift
    for rewards, modes in ((False, (False, True)), (True, (False,))):
        ref_metrics, ref_grads, _ = step("cpu", False, rewards)
        gmax = max(float(t.abs().max()) for t in ref_grads.values())
        for remat in modes:
            metrics, grads, launches = step("cuda:0", remat, rewards)
            ratios = {n: float((grads[n] - r).abs().max()) / (float(r.abs().max()) + 1e-6 * gmax)
                      for n, r in ref_grads.items()}
            rest = {n: v for n, v in ratios.items() if not n.startswith(w_input)}
            worst = max(rest, key=rest.get)
            w_worst = max(v for n, v in ratios.items() if n.startswith(w_input))
            errs = {k: abs(metrics[k] - v) for k, v in ref_metrics.items()}
            ran = all(n > 0 for n in launches.values())
            ok = (all(e <= 1e-4 * max(1.0, abs(ref_metrics[k])) for k, e in errs.items())
                  and rest[worst] <= rtol and w_worst <= w_tol and ran)
            log(f"training reference: 1 f32 LCD step{' with both rewards' if rewards else ''}, 4x16x16 latents, "
                f"UNet 64/128 with heads of 64, {'remat' if remat else 'no remat'}, card vs CPU: "
                + ", ".join(f"{k} {metrics[k]:.6f} vs {v:.6f}" for k, v in ref_metrics.items())
                + f" (max |diff| {max(errs.values()):.3e} <= 1e-4*max(1,|ref|)); {len(grads)} LoRA gradients, "
                f"max|diff| / (max|ref| + 1e-6*max|all ref|): median "
                f"{sorted(ratios.values())[len(ratios) // 2]:.3e}, worst {rest[worst]:.3e} at {worst} "
                f"(<= {rtol:g}), time_cond_proj {w_worst:.3e} (<= {w_tol:.3e}: 1e-3 + 2x the embedding's drift); "
                f"card launches {launches} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("the card's LCD step disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


# T2V-Turbo-v2 (phases 10-12): generation with the motion embedding, the
# offline preprocess (its pickles feed the training phase) and full-model
# training. The pickles and exported UNets are large, so they go to a work
# directory beside the script (build/, untracked), removed at the end.
V2_DIR = os.path.join(HERE, "build", "chip_smoke_v2")
V2_GEN = "v2 generation"
V2_PRE = "v2 preprocess"
V2_TRAIN = "v2 training"


class PlainAttentionCount:
    """Counts the plain `attention` calls (those the kernels do not take:
    the probability captures, head dims the flash kernels lack) while
    active, by (head dim, with probabilities)."""

    def __enter__(self):
        import collections

        from t2v_turbo_tpu_torch.models import layers
        from t2v_turbo_tpu_torch.ops import attention as A

        self.counts = collections.Counter()
        self._patched = [(A, A.attention), (layers, layers.attention)]
        plain = A.attention

        def counted(q, k, v, *args, **kw):
            self.counts[(q.shape[-1], bool(kw.get("return_probs")))] += 1
            return plain(q, k, v, *args, **kw)

        for module, _ in self._patched:
            module.attention = counted
        return self

    def __exit__(self, *exc):
        for module, fn in self._patched:
            module.attention = fn

    def text(self, passes=1, per="call"):
        return ", ".join(f"head dim {d}{' with probabilities' if p else ''}: {n / passes:g} a {per}"
                         for (d, p), n in sorted(self.counts.items())) or "none"


def phase_v2_generation():
    """apps/generate.py's pipeline with a motion-conditioned v2 UNet at the
    v2 operating point: 16 steps from an origin grid of 200, motion_gs 0.05
    in the top 30% of the timesteps; 3 prompts at 16x320x512."""
    import torch

    from t2v_turbo_tpu_torch.apps.generate import build_pipeline, parse_args
    from t2v_turbo_tpu_torch.pipelines.vc2 import motion_guidance_scale

    steps, origin, gs, pct = 16, 200, 0.05, 0.3
    t0 = time.perf_counter()
    args = parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device", "cuda:0",
                       "--use-motion-cond", "--motion-gs", str(gs), "--percentage", str(pct), "--steps", str(steps),
                       "--lcm-origin-steps", str(origin)])
    pipe = build_pipeline(args)
    ts = [int(t) for t in pipe.scheduler.timesteps(steps, origin)]
    guided = [t for t in ts if motion_guidance_scale(t, gs, pct) > 0]
    log(f"{V2_GEN}: pipeline built in {time.perf_counter() - t0:.1f} s, UNet "
        f"{sum(p.numel() for p in pipe.unet.parameters())} parameters (motion_cond_proj and combine_proj "
        f"included); timesteps {ts}; motion_gs {gs} at {guided} (t >= 1000 * (1 - {pct})), 0 after")
    kw = dict(height=320, width=512, frames=16, num_inference_steps=steps, lcm_origin_steps=origin,
              use_motion_cond=True, percentage=pct)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    video_s, videos = [], []
    with PlainAttentionCount() as plain:
        for i, prompt in enumerate(PROMPTS):
            gen = torch.Generator(device="cuda").manual_seed(3000 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video = pipe(prompt=prompt, generator=gen, motion_gs=gs, **kw)
            torch.cuda.synchronize()
            video_s.append(time.perf_counter() - t0)
            v = video.float()
            finite = bool(torch.isfinite(v).all())
            log(f"{V2_GEN}: video {i}: shape {tuple(video.shape)}, finite {finite}, min {float(v.min()):.4f} "
                f"max {float(v.max()):.4f} std {float(v.std()):.4f}, {video_s[-1]:.3f} s")
            if tuple(video.shape) != (1, 16, 320, 512, 3) or not finite or not float(v.max() - v.min()) > 0:
                raise AssertionError(f"{V2_GEN}: video {i} is malformed")
            videos.append(video)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: c for n, c in read_launches().items() if n in SERVING_KERNELS or n == D512_SERVING}
    log(f"{V2_GEN}: s/video (videos 2-3) {' '.join(f'{s:.3f}' for s in video_s[1:])}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; kernel launches {launches}; plain attention calls {plain.text()}")
    passes = len(PROMPTS) * steps
    check_flash_routes(V2_GEN, passes, "UNet pass")
    check_conv_routes(V2_GEN, passes)
    check_norm_routes(V2_GEN, len(PROMPTS), "video")
    check_small_seq(V2_GEN, passes, "UNet pass")
    missing = [n for n, c in launches.items() if c <= 0]
    if missing or plain.counts:
        raise AssertionError(f"{V2_GEN}: kernels not launched {missing}; plain attention calls {dict(plain.counts)}")
    gen = torch.Generator(device="cuda").manual_seed(3000)
    unguided = pipe(prompt=PROMPTS[0], generator=gen, motion_gs=0.0, **kw)
    diff = float((unguided.float() - videos[0].float()).abs().max())
    log(f"{V2_GEN}: the first prompt again with motion_gs 0 (same seed): max|diff| from motion_gs {gs} "
        f"{diff:.4f} {'OK' if diff > 0 else 'FAIL'}")
    if not diff > 0:
        raise AssertionError(f"{V2_GEN}: the motion embedding does not change the video")
    _profile_one_video(pipe, "profile_v2_video.txt", f"{V2_GEN} profile", motion_gs=gs, **kw)


def phase_v2_preprocess():
    """apps/preprocess.py's job at full width with a seeded teacher and
    synthetic latents: 4 samples with the motion prior (the last profiled)
    and 1 without, counting the teacher's calls; the pickles through
    MP4LatentDataset; then a small f32 motion_prior_score on the card against
    the CPU."""
    import shutil

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import preprocess
    from t2v_turbo_tpu_torch.data.datasets import MP4LatentDataset

    shutil.rmtree(V2_DIR, ignore_errors=True)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    paths, times = [], []
    with PlainAttentionCount() as plain:
        for motion, n, seed in ((True, 4, 0), (False, 1, 1)):
            argv = ["--random-weights", "--synthetic-data", "--device", "cuda:0", "--num-samples", str(n),
                    "--seed", str(seed), "--output-dir", os.path.join(V2_DIR, "latents", "motion" if motion else "plain")]
            argv += [] if motion else ["--no-motion-prior"]
            t0 = time.perf_counter()
            job = preprocess.build_job(preprocess.parse_args(argv))
            calls = []
            hook = job.teacher.register_forward_pre_hook(lambda *_: calls.append(1))
            log(f"{V2_PRE}: job built in {time.perf_counter() - t0:.1f} s ({' '.join(argv)})")
            samples = job.samples()
            for k in range(n):
                if motion and k == n - 1:  # the last sample with the prior under the profiler
                    (path, sample, seconds), wall_ms, busy_ms, events = _profiled(
                        lambda: next(samples), "profile_v2_preprocess.txt", cpu=False)  # ~45 UNet calls: device only
                    fwd_ms, bwd_ms, _, _ = flash_device_ms(events)
                    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
                    log(f"{V2_PRE} profile: one sample (index {int(sample['index'])}): wall {wall_ms:.1f} ms, "
                        f"device kernels {busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; B7 "
                        f"{sum(e.self_device_time_total for e in events if 'gn_silu_conv' in e.key) / 1e3:.1f} ms; "
                        f"flash forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms; B8 "
                        f"{small_seq_device_ms(events):.3f} ms; " + _norm_profile(events)
                        + " -> chiprun_out/profile_v2_preprocess.txt; top: "
                        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms" for e in top))
                    seconds = None  # not in s/sample: the profiler's own cost
                else:
                    path, sample, seconds = next(samples)
                index = int(sample["index"])
                want = index + 4 if motion else 2
                score = sample["score"]
                finite = all(np.isfinite(sample[k]).all() for k in ("z_t", "cond_teacher_out", "uncond_teacher_out",
                                                                    "score"))
                nonzero = bool(np.abs(score).max() > 0) if motion else not np.abs(score).any()
                ok = len(calls) == want and finite and nonzero and sample["use_motion_guide"] == motion
                log(f"{V2_PRE}: {os.path.basename(path)}: index {index}, teacher calls {len(calls)} (want "
                    f"{'index + 4' if motion else '2'} = {want}), z_t {sample['z_t'].shape}, score max|.| "
                    f"{float(np.abs(score).max()):.3e}, finite {finite}, "
                    f"{'profiled' if seconds is None else f'{seconds:.2f} s'} {'OK' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"{V2_PRE}: sample {path} is wrong")
                paths.append(path)
                if seconds is not None:
                    times.append((seconds, index if motion else None))
                calls.clear()
            hook.remove()
            del job
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS}
    log(f"{V2_PRE}: s/sample {' '.join(f'{s:.2f} (index {i})' if i is not None else f'{s:.2f} (no prior)' for s, i in times)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; kernel launches {launches}; "
        f"plain attention calls {plain.text(len(paths) - 1, 'sample with the prior')}")
    check_flash_routes(V2_PRE, len(paths), "sample")
    check_conv_routes(V2_PRE, 1)
    check_norm_routes(V2_PRE, len(paths), "sample")
    check_small_seq(V2_PRE, 1, "run", shapes=False)
    want_plain = {(64, True): 2 * 9 * (len(paths) - 1)}  # two captures of 9 layers a sample with the prior
    missing = [n for n, c in launches.items() if c <= 0]
    if dict(plain.counts) != want_plain or missing:
        raise AssertionError(f"{V2_PRE}: plain attention calls {dict(plain.counts)}, expected {want_plain}; "
                             f"kernels not launched {missing}")
    ds = MP4LatentDataset(sorted(paths))
    batch = next(ds.batches(len(paths), shuffle=False, loop=False))
    log(f"{V2_PRE}: MP4LatentDataset reads the {len(ds)} pickles: index {batch['index'].tolist()}, z_t "
        f"{batch['z_t'].shape}, use_motion_guide {batch['use_motion_guide'].tolist()}")
    _motion_score_card_vs_cpu()
    return os.path.join(V2_DIR, "latents", "*", "*.pkl")


def _motion_score_card_vs_cpu():
    """motion_prior_score of a small f32 UNet (heads of 64, 4 frames) on the
    card (kernels: B2/B3 at the spatial attentions, the plain captures) against the
    CPU (plain versions) on the same weights and latents."""
    import copy

    import torch

    from t2v_turbo_tpu_torch.diffusion import DDIMSolver, DiffusionSchedule, add_noise
    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel, seeded_init_
    from t2v_turbo_tpu_torch.training.motion import motion_prior_score, reverse_ddim_loop

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = UNetConfig(model_channels=64, num_res_blocks=1, attention_resolutions=(1, 2), channel_mult=(1, 2),
                     context_dim=64)
    cpu = seeded_init_(UNetModel(cfg), 31).requires_grad_(False)
    g = torch.Generator().manual_seed(32)
    lat, ctx = 0.5 * torch.randn((1, 4, 16, 16, 4), generator=g), torch.randn((1, 77, 64), generator=g)
    noise = torch.randn(lat.shape, generator=g)
    sched = DiffusionSchedule.create()
    solver = DDIMSolver.create(sched.alphas_cumprod.numpy())
    out = {}
    reset_launches()
    for device, model in (("cpu", cpu), ("cuda:0", copy.deepcopy(cpu).to(device="cuda:0"))):
        s = solver.to(device)
        x, c = lat.to(device), ctx.to(device)
        ts = s.ddim_timesteps[40:41]
        example = reverse_ddim_loop(model, x, c, s, 41, return_intermediates=False)
        z_t = add_noise(sched.to(device), x, noise.to(device), ts)
        score, cond, loss = motion_prior_score(model, z_t, ts, example, c, c, return_loss=True)
        out[device] = (score.cpu(), cond.cpu(), float(loss))
    (s0, c0, l0), (s1, c1, l1) = out["cpu"], out["cuda:0"]
    serr, smax = float((s1 - s0).abs().max()), float(s0.abs().max())
    cerr = float((c1 - c0).abs().max())
    launches = {n: c for n, c in read_launches().items() if c}
    ok = (smax > 0 and serr <= 1e-3 * smax and cerr <= 1e-4 * max(1.0, float(c0.abs().max()))
          and abs(l1 - l0) <= 1e-4 * max(1.0, abs(l0)) and launches.get("flash_attention_bwd_dq", 0) > 0)
    log(f"{V2_PRE}: card vs CPU, f32 (TF32 off), UNet 64/128 with heads of 64, 4x16x16 latents, 41 inversion "
        f"steps: rank loss {l1:.6e} vs {l0:.6e}; score max|diff| {serr:.3e} of max|ref| {smax:.3e} (<= 1e-3 x it: "
        f"a gradient through 41 inverted steps' capture and the top-1 mask); conditional output max|diff| "
        f"{cerr:.3e} (<= 1e-4*max(1,|ref|)); card launches {launches} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{V2_PRE}: the card's motion score disagrees with the CPU's")
    torch.backends.cudnn.allow_tf32 = True


def phase_v2_training(latent_glob):
    """apps/train_v2.py's trainer at the recipe's point on phase 11's
    pickles: batch 3 (or the largest that fits, said so), --use-remat, the
    motion embedding, the EMA target (decay 0.95), adamw8bit with the
    temporal group at 1e-5, HPSv2 (0.2) and ViCLIP (0.5) rewards; 4 steps,
    one profiled step, the export."""
    import gc

    import torch

    for batch in (3, 2, 1):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            _train_v2(latent_glob, batch)
            return
        except torch.cuda.OutOfMemoryError:
            if batch == 1:
                raise
            log(f"{V2_TRAIN}: out of memory at batch {batch} (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                f"GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}); running batch {batch - 1}")


def _train_v2(latent_glob, batch):
    import math
    import shutil

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import train_v2
    from t2v_turbo_tpu_torch.models import UNetModel

    out_dir = os.path.join(V2_DIR, "train")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--random-weights", "--latent-glob", latent_glob, "--device", "cuda:0", "--seed", "0",
            "--output-dir", out_dir, "--batch-size", str(batch), "--use-remat", "--use-motion-cond",
            "--use-target-unet", "--ema-decay", "0.95", "--optimizer", "adamw8bit", "--learning-rate", "1e-5",
            "--temporal-lr", "1e-5", "--reward-fn", "hpsv2", "--reward-scale", "0.2", "--video-rm-fn", "vi_clip",
            "--video-reward-scale", "0.5", "--vae-decode-batch-size", "16", "--max-steps", "4",
            "--checkpointing-steps", "1000000"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, data, ucfg = train_v2.build_trainer(train_v2.parse_args(argv))
    torch.cuda.synchronize()
    sizes = {lb: sum(p.numel() for p in opt.params) for lb, opt in trainer.optimizers.items()}
    log(f"{V2_TRAIN}: built in {time.perf_counter() - t0:.1f} s ({' '.join(argv)}); student "
        f"{sum(p.numel() for p in trainer.params)} parameters in {len(trainer.params)} tensors, f32 master "
        f"{trainer.master.numel()} elements, working copy {trainer.working.dtype} {trainer.working.numel()}; "
        f"optimizer groups (elements with padding) {sizes}, moments {trainer.optimizers['base'].moments}; EMA target "
        f"network {type(trainer.target).__name__}; memory after build {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    every = 1009  # the EMA check's sample of the flat buffers
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    with PlainAttentionCount() as plain:
        for i in range(4):
            ema0 = trainer.ema[::every].clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = trainer.step_once(next(data))
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            want = ema0.mul(0.95).add_(trainer.master[::every], alpha=1.0 - 0.95)
            got = trainer.ema[::every]
            ema_err = float(((got - want).abs() / (want.abs() * torch.finfo(torch.float32).eps).clamp_min(1e-30)).max())
            log(f"{V2_TRAIN}: step {i + 1}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.3f} s, "
                + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items())
                + f"; EMA vs 0.95*EMA + 0.05*master on {got.numel()} sampled elements: max |diff| "
                f"{ema_err:.2f} f32 eps relative (<= 1); max_memory_allocated "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and ema_err <= 1.0):
                raise AssertionError(f"{V2_TRAIN} step {i + 1}: loss {loss}, grad_norm {gnorm}, EMA error {ema_err}")
            if i == 0:
                _v2_gradient_check(trainer)
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS or n in D512_KERNELS}
    log(f"{V2_TRAIN}: kernel launches a step {dict((n, c / 4) for n, c in launches.items())}; plain attention "
        f"calls {plain.text(4, 'step')} (the reward towers' heads of 80; the UNet's none)")
    check_flash_routes(V2_TRAIN, 4, "step")
    check_conv_routes(V2_TRAIN, 4 * 3)  # a step: the student's forward, its recompute (remat), the target
    check_norm_routes(V2_TRAIN, 4, "step")
    check_small_seq(V2_TRAIN, 4, "step", shapes=False)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing or any(d == 64 for d, _ in plain.counts):
        raise AssertionError(f"{V2_TRAIN}: kernels not launched {missing}; plain calls {dict(plain.counts)}")
    log(f"{V2_TRAIN}: batch {batch}{'' if batch == 3 else ' (the recipe is 3: it did not fit)'}; s/step (steps "
        f"2-4) {' '.join(f'{s:.3f}' for s in step_s[1:])} (mean {np.mean(step_s[1:]):.3f}); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile_train_step(trainer, data, "profile_train_v2.txt")
    t0 = time.perf_counter()
    paths = train_v2.export_unets(trainer, out_dir)
    sizes = [os.path.getsize(p) for p in paths]
    log(f"{V2_TRAIN}: exported {[os.path.relpath(p, HERE) for p in paths]} ({[f'{s / 2**30:.2f} GiB' for s in sizes]}) "
        f"in {time.perf_counter() - t0:.1f} s")
    for path, flat in zip(paths, (trainer.master, trainer.ema)):
        with torch.device("meta"):
            fresh = UNetModel(ucfg)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        fresh.load_state_dict(sd, strict=True, assign=True)
        ref = trainer.state_dict_of(flat)
        same = all(torch.equal(sd[k], ref[k].cpu()) for k in list(ref)[::50])
        log(f"{V2_TRAIN}: {os.path.basename(path)} loads strictly into a fresh UNetModel ({len(sd)} tensors), "
            f"every 50th equal to the trainer's f32 {'master' if flat is trainer.master else 'EMA'}: {same}")
        if not same:
            raise AssertionError(f"{V2_TRAIN}: {path} does not hold the trainer's weights")
        del sd, fresh
    shutil.rmtree(out_dir, ignore_errors=True)  # the pickles stay for phase 16


def _v2_gradient_check(trainer):
    """After the first step: every UNet parameter's gradient (the step's
    flat gradient buffer, before the clip) finite; those exactly zero counted."""
    import torch

    finite = [n for n, g in zip(trainer.param_names, trainer._grad_views) if not bool(torch.isfinite(g).all())]
    zero = [n for n, g in zip(trainer.param_names, trainer._grad_views) if not bool(g.any())]
    norms = sum(p.dtype == torch.float32 for p in trainer.params) if trainer.working.dtype != torch.float32 else "f32"
    log(f"{V2_TRAIN}: step 1's gradients: {len(trainer.param_names)} UNet tensors ({norms} of them norm affines), "
        f"non-finite {len(finite)}, exactly zero {len(zero)}{' ' + str(zero[:5]) if zero else ''}")
    if finite:
        raise AssertionError(f"{V2_TRAIN}: non-finite gradients in {finite[:5]}")


# This slice's phases (13-16): MotionClone motion transfer, the DDIM
# inversion round trip, ModelScope generation and v2 training with the text
# encoder. MotionClone and the inversion start, as phase 8, at decoded
# frames: the card's host has no libav.
MOTION = "motion clone"
INVERSE = "inverse ddim"
MS = "ModelScope"
V2_TEXT = "v2 text encoder"
MS_KERNELS = ("flash_attention", "small_seq_attention", "fused_gn_silu_conv", "group_norm", "group_norm_stats",
              "layer_norm")


def _dry_run_shapes(parts, patches=(), grad=False):
    """{part: {kernel: Counter(shape)}} of the kernel launches, keyed as each
    wrapper's `by_shape` counts them, of each (part, fn) in `parts`, run on
    the meta device with the models' kernel entry points replaced by
    recorders that take the dispatch's own decisions (`sdpa`'s short-sequence
    gate, the fused conv's statistics launch, the partials' plan); `patches`:
    more (module, name, function) replacements for the run; `grad`: run with
    gradients enabled (the dispatch a training step's student pass takes:
    no short-sequence kernel, flash for every attention it can take)."""
    import collections

    import torch

    from t2v_turbo_tpu_torch.models import layers
    from t2v_turbo_tpu_torch.models import vae as vae_module
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    counts = collections.defaultdict(collections.Counter)

    def sdpa(q, k, v, scale=None):
        if A._small_seq(q, k, v):
            counts["small_seq_attention"][tuple(q.shape[:3])] += 1
        elif q.shape[-1] in A.FLASH_HEAD_DIMS:
            counts["flash_attention"][(q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3])] += 1
        return A.attention(q, k, v, scale=scale)

    def group_norm(x, w, b, g=32, eps=1e-5, act=None):
        counts["group_norm"][tuple(x.shape)] += 1
        return N.group_norm_plain(x, w, b, g, eps, act)

    def layer_norm(x, w, b, eps=1e-5, act=None):
        counts["layer_norm"][(x.numel() // x.shape[-1], x.shape[-1])] += 1
        return N.layer_norm_plain(x, w, b, eps)

    def conv(x, gs, gb, w, b, g, eps, *film):
        counts["fused_gn_silu_conv"][tuple(x.shape) + (w.shape[0],) + tuple(w.shape[2:])] += 1
        counts["group_norm_stats"][tuple(x.shape)] += 1
        if film and film[0] is not None:  # the launches with a FiLM, as `by_film_shape` counts them
            counts["fused_gn_silu_conv film"][tuple(x.shape) + (w.shape[0],) + tuple(w.shape[2:])] += 1
            counts["group_norm_stats film"][tuple(x.shape)] += 1
        return FC.fused_gn_silu_conv_plain(x, gs, gb, w, b, g, eps, *film)

    def partials(x, g=32):
        counts["group_norm_partials"][tuple(x.shape)] += 1
        n, c = x.shape[:2]
        k = N.partials_plan(n, c, g, prod(x.shape[2:]), x.dtype).k
        return x.new_empty((n * g, k, 2), dtype=torch.float32), x.new_empty((k,), dtype=torch.int32)

    def from_partials(x, parts, cnt, w, b, g=32, eps=1e-5, act=None):
        counts["group_norm_from_partials"][tuple(x.shape)] += 1
        return torch.empty_like(x)

    def affine_from_partials(parts, cnt, w, b, g=32, eps=1e-5, *film):
        n, c = parts.shape[0] // g, w.shape[0]
        counts["group_norm_affine_from_partials"][(n, c, parts.shape[1])] += 1
        return (parts.new_empty((n, c)), parts.new_empty((n, c)))

    def conv_ab(x, a, b, w, bias=None):
        counts["fused_gn_silu_conv_ab"][tuple(x.shape) + (w.shape[0],) + tuple(w.shape[2:])] += 1
        return x.new_empty((x.shape[0], w.shape[0], *x.shape[2:]))

    patched = [(layers, "sdpa", sdpa), (vae_module, "sdpa", sdpa), (layers, "group_norm", group_norm),
               (layers, "layer_norm", layer_norm), (layers, "fused_gn_silu_conv", conv),
               (layers, "group_norm_partials", partials), (layers, "group_norm_from_partials", from_partials),
               (layers, "group_norm_affine_from_partials", affine_from_partials),
               (layers, "fused_gn_silu_conv_ab", conv_ab)] + list(patches)
    saved = [(m, n, getattr(m, n)) for m, n, _ in patched]
    out = {}
    try:
        for m, n, f in patched:
            setattr(m, n, f)
        with torch.device("meta"), torch.set_grad_enabled(grad):
            for part, fn in parts:
                fn()
                out[part], counts = dict(counts), collections.defaultdict(collections.Counter)
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    return out


def ms_path_shapes():
    """`_dry_run_shapes` of one MS UNet pass at 16x256x256 (latents
    16x32x32), one decode of 16 frames by the VAE and one encode by the
    full-depth text tower. Phase 3 holds every shape, phase 15 expects
    exactly these launches."""
    import torch

    from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextConfig, CLIPTextModel, VAEConfig
    from t2v_turbo_tpu_torch.models.unet_ms import MSUNet3DConditionModel, MSUNetConfig

    return _dry_run_shapes([
        ("unet", lambda: MSUNet3DConditionModel(MSUNetConfig(time_cond_proj_dim=256)).to(torch.bfloat16)(
            torch.zeros(1, 16, 32, 32, 4), torch.zeros(1, dtype=torch.long), torch.zeros(1, 77, 1024),
            timestep_cond=torch.zeros(1, 256))),
        ("vae", lambda: AutoencoderKL(VAEConfig()).to(torch.bfloat16).decode(torch.zeros(16, 32, 32, 4))),
        ("text", lambda: CLIPTextModel(CLIPTextConfig(penultimate=False)).to(torch.bfloat16)(
            torch.zeros(1, 77, dtype=torch.long))),
    ])


def serving_48_shapes():
    """`_dry_run_shapes` of the 48-frame request (the envelope's top, the
    reference app.py's 48-frame limit): one VC2 UNet pass at 48x320x512
    (latents 48x40x64), one decode of a 16-frame chunk at 320x512 and one
    text encode. Phase 3 holds the UNet's shapes (the decode's and the text
    tower's are the 16-frame path's), the serving phase expects exactly
    these launches."""
    import torch

    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNetModel

    spec = vc2_spec()
    return _dry_run_shapes([
        ("unet", lambda: UNetModel(spec.unet).to(torch.bfloat16)(
            torch.zeros(1, 48, 40, 64, 4), torch.zeros(1, dtype=torch.long), torch.zeros(1, 77, 1024),
            fps=torch.full((1,), 16.0), timestep_cond=torch.zeros(1, 256))),
        ("vae", lambda: AutoencoderKL(spec.vae).to(torch.bfloat16).decode(torch.zeros(16, 40, 64, 4))),
        ("text", lambda: CLIPTextModel(spec.text).to(torch.bfloat16)(torch.zeros(1, 77, dtype=torch.long))),
    ])


IMG = "image conditioning"
SWITCHES = "UNet switches"
XT = "x_transformer"
IMG_STEPS, IMG_CFG = 25, 7.5
SWITCH_STEPS = 10
# the switch variant: the reference's temporal options on, the rest at VC2's defaults
SWITCH_UNET_KW = dict(use_relative_position=True, use_causal_attention=True, use_scale_shift_norm=True,
                      temporal_length=16)


def image_path_shapes():
    """`_dry_run_shapes` of the image-conditioned VC2 phase's parts: a UNet
    pass with `use_image_attention` over 16x40x64 latents with the
    finegrained context (200 text rows + 16 Resampler tokens) and with the
    coarse one (+ 4 ImageProjModel tokens), the finegrained and the coarse
    ImageCondEncoder on one 320x512 image (ViT-H/14 at 224 and the head),
    one text encode and one 16-frame decode."""
    import torch

    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNetConfig, UNetModel
    from t2v_turbo_tpu_torch.models.image_cond import ImageCondEncoder

    spec = vc2_spec()

    def unet(n_ctx):
        return lambda: UNetModel(UNetConfig(use_image_attention=True)).to(torch.bfloat16)(
            torch.zeros(1, 16, 40, 64, 4), torch.zeros(1, dtype=torch.long), torch.zeros(1, n_ctx, 1024))

    def encoder(finegrained):
        return lambda: ImageCondEncoder(finegrained).to(torch.bfloat16)(torch.zeros(1, 320, 512, 3))

    return _dry_run_shapes([
        ("unet", unet(216)), ("unet coarse", unet(204)), ("encoder", encoder(True)),
        ("encoder coarse", encoder(False)),
        ("text", lambda: CLIPTextModel(spec.text).to(torch.bfloat16)(torch.zeros(1, 77, dtype=torch.long))),
        ("vae", lambda: AutoencoderKL(spec.vae).to(torch.bfloat16).decode(torch.zeros(16, 40, 64, 4))),
    ])


def switch_path_shapes():
    """`_dry_run_shapes` of one pass of the switch variant's UNet
    (SWITCH_UNET_KW) over 16x40x64 latents with a 77-row context: its
    temporal attentions take the plain path (relative position, causal
    mask), every ResBlock's out_layers conv carries the FiLM."""
    import torch

    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel

    return _dry_run_shapes([("unet", lambda: UNetModel(UNetConfig(**SWITCH_UNET_KW)).to(torch.bfloat16)(
        torch.zeros(1, 16, 40, 64, 4), torch.zeros(1, dtype=torch.long), torch.zeros(1, 77, 1024)))])


def reference_clip():
    """A decoded reference video, seeded: 16 frames of 360x640 uint8, a
    colour ramp panning 12 pixels a frame with a bright bar crossing it (the
    motion the transfer copies)."""
    import numpy as np

    r = np.random.RandomState(7)
    yy, xx = np.mgrid[0:360, 0:640]
    ramp = r.uniform(40, 215, 3) + 40 * np.stack([np.sin(yy / 37), np.cos(xx / 53), np.sin((xx + yy) / 71)], -1)
    frames = []
    for t in range(16):
        f = np.roll(ramp, 12 * t, axis=1)
        f[:, 100 + 24 * t: 140 + 24 * t] = 250
        frames.append(f)
    return np.clip(np.stack(frames) + r.randint(0, 12, (16, 360, 640, 3)), 0, 255).astype(np.uint8)


def _path_checks(what, passes, per, kernels=TRAIN_KERNELS):
    """The routes of phases 4 and 6-12 on a path: every flash and B7 launch
    wgmma, every norm on its staged or vector route, every B8 launch bulk,
    each of `kernels` launched; returns the launches by kernel."""
    launches = {n: c for n, c in read_launches().items() if n in kernels}
    log(f"{what}: kernel launches {launches}")
    check_flash_routes(what, passes, per)
    check_conv_routes(what, passes)
    check_norm_routes(what, passes, per)
    check_small_seq(what, passes, per, shapes=False)
    missing = [n for n, c in launches.items() if c <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels not launched {missing}")
    return launches


def phase_motion_clone():
    """apps/motion_sample.py at full width with seeded weights (VC2 UNet,
    VAE, ViT-H text tower) on a decoded reference clip: the reference's
    50-point grid, guidance 7.5, percentage 0.3 (15 guided steps), rank-1
    loss x100; then the same run at temp_loss_scale 0, whose final in-band
    motion statistic the guided run's must undercut."""
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import motion_sample
    from t2v_turbo_tpu_torch.pipelines.motion_clone import guided_indices

    out_path = os.path.join(OUT_DIR, "motion_clone_video.npy")
    args = motion_sample.parse_args(["--random-weights", "--device", "cuda:0", "--seed", "0", "--prompt", PROMPTS[1],
                                     "--reference-prompt", PROMPTS[0], "--num-ddim-timesteps", "50",
                                     "--percentage", "0.3", "--temp-loss-scale", "100", "--output", out_path])
    t0 = time.perf_counter()
    job = motion_sample.build_job(args, frames=reference_clip())
    torch.cuda.synchronize()
    guided = guided_indices(job.cfg)
    ref = job.ref_latents
    log(f"{MOTION}: job built in {time.perf_counter() - t0:.1f} s (the clip 16x360x640 resized and cropped to "
        f"320x512 and VAE-encoded: latents {tuple(ref.shape)}, std {float(ref.std()):.4f}, finite "
        f"{bool(torch.isfinite(ref).all())}); {len(guided)} guided steps at indices {guided[0]}..{guided[-1]}")
    if len(guided) != 15 or not bool(torch.isfinite(ref).all()):
        raise AssertionError(f"{MOTION}: {len(guided)} guided steps, reference latents finite "
                             f"{bool(torch.isfinite(ref).all())}")
    traces, seconds = {}, {}
    for scale in (100.0, 0.0):
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with PlainAttentionCount() as plain:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            latents, trace = motion_sample.run(job, return_trace=True, temp_loss_scale=scale)
            torch.cuda.synchronize()
            seconds[scale] = time.perf_counter() - t0
        traces[scale] = trace["motion_loss"].float().cpu().numpy()
        peak = torch.cuda.max_memory_allocated() / 2**30
        finite = bool(torch.isfinite(latents).all()) and bool(np.isfinite(traces[scale]).all())
        log(f"{MOTION}: temp_loss_scale {scale:g}: {seconds[scale]:.2f} s (50 inversion steps, {len(guided)} guided "
            f"and {50 - len(guided)} plain DDIM steps; {50 + 3 * len(guided) + 2 * (50 - len(guided))} UNet "
            f"forwards and {len(guided)} backwards), latents {tuple(latents.shape)} finite {finite}; max_memory_"
            f"allocated {peak:.2f} GiB; motion statistic (unscaled rank loss) at the guided steps "
            f"{' '.join(f'{v:.5f}' for v in traces[scale])}; plain attention calls {plain.text()}")
        want_plain = {(64, True): 18 * len(guided)}  # two captures of nine layers a guided step
        if not finite or len(traces[scale]) != len(guided) or dict(plain.counts) != want_plain:
            raise AssertionError(f"{MOTION}: finite {finite}, {len(traces[scale])} statistics, plain calls "
                                 f"{dict(plain.counts)} (want {want_plain})")
        if scale:
            _path_checks(MOTION, 1, "run")
            t0 = time.perf_counter()
            path = motion_sample.write_output(job, latents, args)
            torch.cuda.synchronize()
            video = np.load(path)
            log(f"{MOTION}: decoded and written in {time.perf_counter() - t0:.2f} s: "
                f"{os.path.relpath(path, HERE)} {video.shape} {video.dtype}")
            if video.shape != (16, 320, 512, 3):
                raise AssertionError(f"{MOTION}: the written video is {video.shape}")
    down, flat = float(traces[100.0][-1]), float(traces[0.0][-1])
    ok = math.isclose(traces[100.0][0], traces[0.0][0], rel_tol=1e-3) and down < flat
    log(f"{MOTION}: s/video {seconds[100.0]:.2f} (guided), {seconds[0.0]:.2f} (scale 0); the first guided step's "
        f"statistic {traces[100.0][0]:.5f} vs {traces[0.0][0]:.5f} (the same latents), the last's {down:.5f} guided "
        f"against {flat:.5f} unguided (descending the statistic lowers it) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{MOTION}: the guided run's final motion statistic {down} is not below {flat}")


def phase_inverse_ddim():
    """apps/inverse_ddim.py at full width with seeded weights on the same
    decoded clip: invert 25 indices of the 50-point grid, DDIM back down,
    the round trip's rmse and relative error."""
    import math

    import torch

    from t2v_turbo_tpu_torch.apps import inverse_ddim

    args = inverse_ddim.parse_args(["--random-weights", "--device", "cuda:0", "--seed", "0", "--prompt", PROMPTS[0]])
    job = inverse_ddim.build_job(args, frames=reference_clip())
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    z_rec, err = inverse_ddim.round_trip(job)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    ok = all(math.isfinite(v) for v in err.values()) and bool(torch.isfinite(z_rec).all())
    log(f"{INVERSE}: {args.invert_steps} inversion and {args.invert_steps} DDIM steps of a {args.num_ddim_timesteps}-"
        f"point grid in {seconds:.2f} s; rmse {err['rmse']:.5f}, relative {err['relative']:.5f} (random weights: "
        f"the probe's figure, not a bar); max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"finite {ok}")
    if not ok:
        raise AssertionError(f"{INVERSE}: round trip {err}")
    _path_checks(INVERSE, 2 * args.invert_steps, "UNet pass", SERVING_KERNELS)


def phase_ms():
    """generate --backbone ms at full width with seeded weights: the MS UNet
    (320, 640, 1280, 1280; 1.41 B parameters), the SD VAE and the full-depth
    ViT-H text tower; 3 prompts, 4 steps, 16x256x256; every launch by kernel,
    route and shape against the meta-device dry run; one profiled video."""
    import collections

    import torch

    from t2v_turbo_tpu_torch.apps import generate
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    want_one = ms_path_shapes()
    steps = 4
    want = {k: collections.Counter() for k in MS_KERNELS}
    for part, n in (("unet", steps * len(PROMPTS)), ("vae", len(PROMPTS)), ("text", len(PROMPTS))):
        for k, c in want_one[part].items():
            for shape, m in c.items():
                want[k][shape] += n * m
    t0 = time.perf_counter()
    args = generate.parse_args(["--prompt", PROMPTS[0], "--backbone", "ms", "--random-weights", "--seed", "0",
                                "--device", "cuda:0", "--height", "256", "--width", "256"])
    pipe = generate.build_pipeline(args)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in m.parameters())
                for n, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_model))}
    log(f"{MS}: pipeline built in {time.perf_counter() - t0:.1f} s; parameters {n_params}; text tower "
        f"{pipe.text_model.cfg.layers_run} blocks run")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    video_s = []
    with PlainAttentionCount() as plain:
        for i, prompt in enumerate(PROMPTS):
            gen = torch.Generator(device="cuda").manual_seed(4000 + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video = pipe(prompt=prompt, height=256, width=256, frames=16, num_inference_steps=steps, generator=gen)
            torch.cuda.synchronize()
            video_s.append(time.perf_counter() - t0)
            v = video.float()
            finite = bool(torch.isfinite(v).all())
            log(f"{MS}: video {i}: shape {tuple(video.shape)}, finite {finite}, min {float(v.min()):.4f} max "
                f"{float(v.max()):.4f} std {float(v.std()):.4f}, {video_s[-1]:.3f} s")
            if tuple(video.shape) != (1, 16, 256, 256, 3) or not finite or not float(v.max() - v.min()) > 0:
                raise AssertionError(f"{MS}: video {i} is malformed")
    log(f"{MS}: s/video (videos 2-3) {' '.join(f'{s:.3f}' for s in video_s[1:])}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; plain attention calls {plain.text()}")
    wrappers_ = {"flash_attention": A.flash_attention, "small_seq_attention": A.small_seq_attention,
                 "fused_gn_silu_conv": FC.fused_gn_silu_conv, "group_norm": N.fused_group_norm,
                 "group_norm_stats": N.group_norm_affine_cuda, "layer_norm": N.fused_layer_norm}
    bad = []
    for name, w in wrappers_.items():
        got = collections.Counter(w.by_shape)
        ok = got == want[name]
        log(f"{MS}: {name} launches {w.launches} by route {dict(w.by_route)}, by shape {dict(sorted(got.items()))} "
            f"(the dry run's: {'equal' if ok else dict(sorted(want[name].items()))}) {'OK' if ok else 'FAIL'}")
        if not ok:
            bad.append(name)
    check_flash_routes(MS, steps * len(PROMPTS), "UNet pass")
    check_conv_routes(MS, steps * len(PROMPTS))
    check_norm_routes(MS, len(PROMPTS), "video")
    check_small_seq(MS, steps * len(PROMPTS), "UNet pass", shapes=False)
    if bad or plain.counts:
        raise AssertionError(f"{MS}: launches by shape differ from the dry run for {bad}; plain attention "
                             f"{dict(plain.counts)}")
    _profile_one_video(pipe, "profile_ms_video.txt", f"{MS} profile", height=256, width=256, frames=16)


SERVE = "serving"


def launch_snapshot():
    """{kernel: (launches, by route, by shape)} of every wrapper's counters."""
    return {n: (w.launches, dict(getattr(w, "by_route", {})), dict(getattr(w, "by_shape", {})))
            for n, w in wrappers().items()}


def _http(url, path, body=None):
    """(status, JSON or bytes) of a GET, or a POST of `body` as JSON."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            raw, ctype = r.read(), r.headers.get("Content-Type", "")
            return r.status, json.loads(raw) if ctype == "application/json" else raw
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _served(srv):
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def _post_video(url, what, body):
    """POST /generate; (the response, the client's wall s, the written frames)."""
    import numpy as np

    t0 = time.perf_counter()
    code, out = _http(url, "/generate", body)
    wall = time.perf_counter() - t0
    if code != 200:
        raise AssertionError(f"{what}: POST /generate {body} -> {code} {out}")
    frames = np.load(out["path"]) if out["path"].endswith(".npy") else None
    log(f"{what}: {body.get('frames', 16)} frames, seed {body['seed']}: latency_s {out['latency_s']}, wall "
        f"{wall:.3f} s, shape {out['shape']}, {out['video_url']}")
    return out, wall, frames


def phase_serving():
    """apps/serve.py on the card at full width (VC2 16x320x512, bf16, 4 steps,
    seeded weights), live and from `warmup --export` artifacts."""
    import collections
    import contextlib
    import io
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import serve, warmup
    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.pipelines.artifact import ArtifactPipeline, video_to_uint8

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_serving_", dir=os.path.join(HERE, "build"))
    try:
        # 1. serve live: serve.py's own composition, in a thread
        argv = ["--random-weights", "--device", "cuda:0", "--port", "0", "--output-dir", os.path.join(work, "live")]
        t0 = time.perf_counter()
        srv, pipe, _ = serve.build_server(argv)
        url = _served(srv)
        log(f"{SERVE}: live server built in {time.perf_counter() - t0:.1f} s at {url}")
        live, walls, snap = [], [], None
        for i, prompt in enumerate(PROMPTS):
            reset_launches()
            out, wall, frames = _post_video(url, f"{SERVE} live", {"prompt": prompt, "seed": 1000 + i})
            if i == 0:
                snap = launch_snapshot()
                check_flash_routes(f"{SERVE} live video", 4, "UNet pass")
                check_conv_routes(f"{SERVE} live video", 4)
                check_norm_routes(f"{SERVE} live video", 1, "video")
                check_small_seq(f"{SERVE} live video", 4, "UNet pass")
            if out["shape"] != [16, 320, 512, 3] or frames is None or frames.shape != (16, 320, 512, 3):
                raise AssertionError(f"{SERVE}: video {i} is malformed: {out}")
            live.append(frames)
            walls.append(wall)
        log(f"{SERVE} live: s/video (client wall, videos 2-3) {' '.join(f'{w:.3f}' for w in walls[1:])}")
        # two concurrent requests: each equals its sequential video
        with ThreadPoolExecutor(2) as ex:
            both = list(ex.map(lambda i: _post_video(url, f"{SERVE} concurrent", {"prompt": PROMPTS[i],
                                                                                 "seed": 1000 + i}), (1, 2)))
        equal = [bool(np.array_equal(f, live[i])) for (_, _, f), i in zip(both, (1, 2))]
        log(f"{SERVE}: two concurrent POSTs equal the sequential videos to the bit: {equal} "
            f"{'OK' if all(equal) else 'FAIL'}")
        if not all(equal):
            raise AssertionError(f"{SERVE}: concurrent videos differ from sequential ones")
        code, health = _http(url, "/healthz")
        code_g, gallery = _http(url, "/gallery")
        code_v, raw = _http(url, both[0][0]["video_url"])
        with open(both[0][0]["path"], "rb") as f:
            same = raw == f.read()
        log(f"{SERVE}: /healthz {code} {health}; /gallery {code_g} ({len(gallery)} videos); "
            f"{both[0][0]['video_url']} {code_v} ({len(raw)} bytes, the written file's: {same})")
        if (code, code_g, code_v) != (200, 200, 200) or not same or len(gallery) != 5 \
                or health["compiled_shapes"] != [[16, 320, 512, 4, 50]]:
            raise AssertionError(f"{SERVE}: GET routes {code}, {code_g}, {code_v}, health {health}")

        # 2. the 48-frame envelope, decoded 16 frames a chunk
        want = collections.defaultdict(collections.Counter)
        for part, n in (("unet", 4), ("vae", 3), ("text", 1)):
            for k, c in serving_48_shapes()[part].items():
                for shape, m in c.items():
                    want[k][shape] += n * m
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out, _, frames = _post_video(url, f"{SERVE} 48 frames", {"prompt": PROMPTS[0], "seed": 4800, "frames": 48,
                                                                 "decode_frame_chunk": 16})
        peak = torch.cuda.max_memory_allocated()
        if out["shape"] != [48, 320, 512, 3]:
            raise AssertionError(f"{SERVE}: the 48-frame video is malformed: {out}")
        by_shape = {n: collections.Counter(w[2]) for n, w in launch_snapshot().items() if n in want}
        bad = [n for n in want if by_shape.get(n) != want[n]]
        log(f"{SERVE} 48 frames: max_memory_allocated {peak / 2**30:.2f} GiB; launches by shape equal the dry "
            f"run's (4 UNet passes at 48 frames, 3 decodes of 16 frames, 1 text encode) "
            f"{'OK' if not bad else 'FAIL ' + str(bad)}")
        check_flash_routes(f"{SERVE} 48 frames", 4, "UNet pass")
        check_conv_routes(f"{SERVE} 48 frames", 4)
        check_norm_routes(f"{SERVE} 48 frames", 1, "video")
        if bad:
            raise AssertionError(f"{SERVE}: 48-frame launches by shape differ from the dry run for {bad}")
        gen = torch.Generator(device="cuda").manual_seed(4800)
        lat = pipe(prompt=PROMPTS[0], frames=48, generator=gen, output_type="latent").reshape(48, 40, 64, 4)
        chunked = torch.cat([pipe.decode_latents(lat[i:i + 16]) for i in range(0, 48, 16)])
        whole = pipe.decode_latents(lat)
        raw = (chunked.float() - whole.float()).abs()
        at = int(raw.argmax())
        err = float((chunked.float().clamp(-1, 1) - whole.float().clamp(-1, 1)).abs().max())
        same_as_served = bool(np.array_equal(video_to_uint8(chunked), frames))
        log(f"{SERVE} 48 frames: decoded in chunks of 16 against all 48 at once, max_abs_err on the [-1, 1] video "
            f"{err:.3e} (<= 1e-2: the decode's bf16 convs and GroupNorm plans at batch 48 may sum in another "
            f"order); before the clamp {float(raw.max()):.3e} at a value of {float(whole.flatten()[at]):.3f}; "
            f"the chunked decode equals the served video: {same_as_served} "
            f"{'OK' if err <= 1e-2 and same_as_served else 'FAIL'}")
        if err > 1e-2 or not same_as_served:
            raise AssertionError(f"{SERVE}: chunked decode {err}, served video equal {same_as_served}")
        del lat, chunked, whole, raw
        srv.shutdown()
        srv.server_close()

        # 3. export, then serve the same prompts from the artifacts
        art_dir = os.path.join(work, "pt2")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # its JSON summary: the numbers are logged below
            manifest = warmup.main(["--device", "cuda:0", "--export", art_dir])
        export_wall = time.perf_counter() - t0
        log(f"{SERVE} export: warmup --export in {export_wall:.1f} s: " + "; ".join(
            f"{n} export_s {e['export_s']}, {e['bytes']} bytes" for n, e in manifest["programs"].items()))
        t0 = time.perf_counter()
        art = ArtifactPipeline.from_dir(art_dir, unet_sd=pipe.unet.state_dict(), vae_sd=pipe.vae.state_dict(),
                                        text_sd=pipe.text_model.state_dict(), tokenizer=pipe.tokenizer,
                                        device="cuda:0")
        args = serve.parse_args(["--artifacts", art_dir, "--device", "cuda:0", "--port", "0", "--output-dir",
                                 os.path.join(work, "artifacts")])
        srv = serve.make_server(art, args)
        url = _served(srv)
        log(f"{SERVE} artifacts: programs loaded in {time.perf_counter() - t0:.1f} s")
        walls = []
        for i, prompt in enumerate(PROMPTS):
            reset_launches()
            out, wall, frames = _post_video(url, f"{SERVE} artifacts", {"prompt": prompt, "seed": 1000 + i})
            walls.append(wall)
            if i == 0:
                got = launch_snapshot()
                same = got == snap
                log(f"{SERVE} artifacts: launches by kernel, route and shape during a video equal a live video's: "
                    f"{same}; flash {dict(A.flash_attention.by_route)} {'OK' if same else 'FAIL'}")
                if not same:
                    diff = {n: (got[n], snap[n]) for n in got if got[n] != snap[n]}
                    raise AssertionError(f"{SERVE}: artifact launches differ from live: {diff}")
                check_flash_routes(f"{SERVE} artifact video", 4, "UNet pass")
            if not np.array_equal(frames, live[i]):
                d = np.abs(frames.astype(int) - live[i].astype(int)).max()
                raise AssertionError(f"{SERVE}: artifact video {i} differs from the live one, max|d| {d} (uint8)")
        log(f"{SERVE} artifacts: s/video (client wall, videos 2-3) {' '.join(f'{w:.3f}' for w in walls[1:])}; "
            f"the 3 videos equal the live ones to the bit (uint8) OK")
        code, health = _http(url, "/healthz")
        gen = [torch.Generator(device="cuda").manual_seed(1000) for _ in range(2)]
        v_art, v_live = art(prompt=PROMPTS[0], generator=gen[0]), pipe(prompt=PROMPTS[0], generator=gen[1])
        err = float((v_art.float() - v_live.float()).abs().max())
        log(f"{SERVE} artifacts: the [-1, 1] video of prompt 0 against the live pipeline's: max|d| {err:.3e} "
            f"(bit-equal {torch.equal(v_art, v_live)}); /healthz compiled_shapes {health['compiled_shapes']} "
            f"{'OK' if torch.equal(v_art, v_live) else 'FAIL'}")
        if not torch.equal(v_art, v_live):
            raise AssertionError(f"{SERVE}: artifact video differs from live, max|d| {err}")
        srv.shutdown()
        srv.server_close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"{SERVE}: phase wall {time.perf_counter() - t_phase:.1f} s")


LVDM_KERNELS = ("flash_attention", "small_seq_attention", "fused_gn_silu_conv", "group_norm", "group_norm_stats",
                "layer_norm")


def _want(dry, runs):
    """{kernel: Counter(shape)}: the dry run's parts, each times its count in `runs` ({part: n})."""
    import collections

    want = collections.defaultdict(collections.Counter)
    for part, n in runs.items():
        for k, c in dry[part].items():
            for shape, m in c.items():
                want[k][shape] += n * m
    return want


def _launches_as_dry_run(what, want):
    """Every wrapper's launches by shape (and B7's and the statistics mode's
    FiLM launches) against `want`; logs them and raises on a difference."""
    import collections

    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    got = {n: collections.Counter(w.by_shape) for n, w in wrappers().items() if n in LVDM_KERNELS}
    got["fused_gn_silu_conv film"] = collections.Counter(FC.fused_gn_silu_conv.by_film_shape)
    got["group_norm_stats film"] = collections.Counter(N.group_norm_affine_cuda.by_film_shape)
    bad = []
    for name, c in got.items():
        ok = c == want.get(name, collections.Counter())
        log(f"{what}: {name} launches {sum(c.values())} by shape {dict(sorted(c.items()))} (the dry run's: "
            f"{'equal' if ok else dict(sorted(want.get(name, {}).items()))}) {'OK' if ok else 'FAIL'}")
        bad += [] if ok else [name]
    if bad:
        raise AssertionError(f"{what}: launches by shape differ from the dry run for {bad}")
    return got


def _device_ms_line(what, wall_ms, busy_ms, events, name):
    b7_ms = sum(e.self_device_time_total for e in events if "gn_silu_conv" in e.key) / 1e3
    fwd_ms, _, fwd512_ms, _ = flash_device_ms(events)
    log(f"{what}: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; B7 {b7_ms:.1f} ms; B1 {fwd_ms:.2f} ms (D = 512 {fwd512_ms:.2f}); "
        f"B8 {small_seq_device_ms(events):.3f} ms; " + _norm_profile(events) + f" -> chiprun_out/{name}")


def phase_image_conditioning(records):
    """Image-conditioned VC2 at full width, bf16, seeded: the ViT-H/14 text
    tower's 77x1024 context, ImageCondEncoder(finegrained) on a seeded
    320x512 image (the tower's 257 tokens at 224 -> the 4-deep Resampler's 16
    tokens), append_image_context -> (1, 216, 1024), the UNet with
    use_image_attention over 16x40x64 latents sampled by ddim_sample_loop on
    the "sampler" grid (IMG_STEPS steps, CFG IMG_CFG against the empty
    prompt's rows with the same image tokens), the VAE's decode; every launch
    by kernel and shape against `image_path_shapes`' dry run; one profiled
    video; then one UNet pass in coarse mode (ImageProjModel, 4 tokens)."""
    import torch

    from t2v_turbo_tpu_torch.apps import generate
    from t2v_turbo_tpu_torch.config import VC2ModelSpec
    from t2v_turbo_tpu_torch.diffusion import DDIMSolver, ddim_sample_loop
    from t2v_turbo_tpu_torch.models import UNetConfig, cast_compute_dtype_, seeded_init_
    from t2v_turbo_tpu_torch.models.image_cond import ImageCondEncoder, append_image_context
    from t2v_turbo_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    dry = image_path_shapes()
    log(f"{IMG}: the dry run took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    args = generate.parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device", "cuda:0"])
    pipe = generate.build_pipeline(args, spec=VC2ModelSpec(unet=UNetConfig(use_image_attention=True)))
    encoders = {}
    for i, fine in enumerate((True, False)):
        with torch.device("cuda"):
            enc = seeded_init_(ImageCondEncoder(finegrained=fine), 7 + 1_000_000 * i)
        encoders[fine] = cast_compute_dtype_(enc, torch.bfloat16).eval().requires_grad_(False)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in m.parameters()) for n, m in (
        ("unet", pipe.unet), ("tower", encoders[True].tower), ("resampler", encoders[True].image_proj_model),
        ("image_proj", encoders[False].image_proj_model))}
    log(f"{IMG}: built in {time.perf_counter() - t0:.1f} s; parameters {n_params}")
    image = torch.rand((1, 320, 512, 3), generator=torch.Generator("cuda").manual_seed(5), device="cuda") * 2 - 1
    solver = DDIMSolver.create(pipe.schedule.alphas_cumprod.cpu().numpy(), ddim_timesteps=IMG_STEPS, device="cuda")

    @torch.no_grad()
    def video(prompt, seed):
        gen = torch.Generator("cuda").manual_seed(seed)
        tokens = encoders[True](image)
        ctx = append_image_context(pipe.encode_prompt(prompt), tokens)
        uncond = append_image_context(pipe.encode_prompt(""), tokens)
        x_t = torch.randn((1, 16, 40, 64, 4), generator=gen, device="cuda")
        z = ddim_sample_loop(lambda x, t: pipe.unet(x, t, ctx), solver, x_t, gen, cfg_scale=IMG_CFG,
                             uncond_model_fn=lambda x, t: pipe.unet(x, t, uncond), grid="sampler")
        return pipe.decode_latents(z.reshape(16, 40, 64, 4)).reshape(1, 16, 320, 512, 3), ctx

    passes = 2 * IMG_STEPS
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with PlainAttentionCount() as plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, ctx = video(PROMPTS[0], 5000)
        torch.cuda.synchronize()
        video_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    v = out.float()
    finite = bool(torch.isfinite(v).all())
    log(f"{IMG}: video: shape {tuple(out.shape)}, finite {finite}, min {float(v.min()):.4f} max "
        f"{float(v.max()):.4f} std {float(v.std()):.4f}; context {tuple(ctx.shape)}; {IMG_STEPS} DDIM steps at CFG "
        f"{IMG_CFG} ({passes} UNet passes), s/video {video_s:.3f} (the first: allocator warm-up included); "
        f"max_memory_allocated {peak / 2**30:.2f} GiB; plain attention calls {plain.text()}")
    if tuple(out.shape) != (1, 16, 320, 512, 3) or not finite or not float(v.max() - v.min()) > 0 \
            or tuple(ctx.shape) != (1, 216, 1024):
        raise AssertionError(f"{IMG}: the video is malformed")
    _launches_as_dry_run(IMG, _want(dry, {"unet": passes, "encoder": 1, "text": 2, "vae": 1}))
    check_flash_routes(IMG, passes, "UNet pass")
    check_conv_routes(IMG, passes)
    check_norm_routes(IMG, 1, "video")
    check_small_seq(IMG, passes, "UNet pass")
    by_sk = {sk: sum(c for shape, c in A.flash_attention.by_shape.items() if shape[3] == sk) for sk in (16, 200)}
    for sk, n in by_sk.items():
        records[SK_RECORDS[sk]]["launches"] = n
    log(f"{IMG}: B1 launches by key length {by_sk} (the image branch's 16 tokens, the text branch's 200 rows)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    video(PROMPTS[1], 5001)
    torch.cuda.synchronize()
    log(f"{IMG}: s/video, a second video {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    _, wall_ms, busy_ms, events = _profiled(lambda: video(PROMPTS[2], 5002), "profile_image_video.txt", cpu=False)
    log(f"{IMG} profile: the profiled video and its tables took {time.perf_counter() - t0:.1f} s")
    _device_ms_line(f"{IMG} profile", wall_ms, busy_ms, events, "profile_image_video.txt")

    # coarse mode: the pooled embedding -> ImageProjModel's 4 tokens, one UNet pass
    reset_launches()
    with torch.no_grad():
        tokens = encoders[False](image)
        ctx4 = append_image_context(ctx[:, :200], tokens)
        x = torch.randn((1, 16, 40, 64, 4), generator=torch.Generator("cuda").manual_seed(5003), device="cuda")
        eps = pipe.unet(x, torch.full((1,), 500, device="cuda"), ctx4)
    finite = bool(torch.isfinite(eps.float()).all())
    log(f"{IMG} coarse: tokens {tuple(tokens.shape)}, context {tuple(ctx4.shape)}, UNet output "
        f"{tuple(eps.shape)} finite {finite}")
    if tuple(ctx4.shape) != (1, 204, 1024) or not finite:
        raise AssertionError(f"{IMG}: the coarse pass is malformed")
    _launches_as_dry_run(f"{IMG} coarse", _want(dry, {"unet coarse": 1, "encoder coarse": 1}))
    check_flash_routes(f"{IMG} coarse", 1, "UNet pass")
    records[SK_RECORDS[4]]["launches"] = sum(c for shape, c in A.flash_attention.by_shape.items() if shape[3] == 4)


def phase_unet_switches(records):
    """The UNet's switches at full width, bf16, seeded: relative position and
    the causal mask in every temporal attention, the scale-shift norm in
    every ResBlock (SWITCH_UNET_KW), the rest at VC2's defaults, sampled by
    p_sample_loop over SWITCH_STEPS ancestral steps with a generator, on a
    seeded 77x1024 context; every launch by kernel and shape against
    `switch_path_shapes`' dry run: each ResBlock's out_layers conv through B7
    with its FiLM, the temporal attentions on the plain path (no B8 launch
    over 16 frames)."""
    import torch

    from t2v_turbo_tpu_torch.diffusion import DiffusionSchedule
    from t2v_turbo_tpu_torch.diffusion.ancestral import p_sample_loop
    from t2v_turbo_tpu_torch.models import UNetConfig, UNetModel, cast_compute_dtype_, seeded_init_
    from t2v_turbo_tpu_torch.models.layers import ResBlock
    from t2v_turbo_tpu_torch.ops import attention as A

    dry = switch_path_shapes()
    with torch.device("cuda"):
        unet = seeded_init_(UNetModel(UNetConfig(**SWITCH_UNET_KW)), 21)
    cast_compute_dtype_(unet, torch.bfloat16).eval().requires_grad_(False)
    n_res = sum(isinstance(m, ResBlock) for m in unet.modules())
    gen = torch.Generator("cuda").manual_seed(6)
    ctx = torch.randn((1, 77, 1024), generator=gen, device="cuda")
    x_t = torch.randn((1, 16, 40, 64, 4), generator=gen, device="cuda")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with PlainAttentionCount() as plain, torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = p_sample_loop(lambda x, t: unet(x, t, ctx), DiffusionSchedule.create(), x_t, gen,
                          timesteps=SWITCH_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(z).all())
    log(f"{SWITCHES}: {SWITCH_UNET_KW}: {SWITCH_STEPS} ancestral steps, latents {tuple(z.shape)} finite {finite}, "
        f"std {float(z.std()):.4f}; s/step {wall / SWITCH_STEPS:.4f} (the first step's allocator warm-up "
        f"included); max_memory_allocated {peak / 2**30:.2f} GiB; plain attention calls "
        f"{plain.text(SWITCH_STEPS, 'UNet pass')}")
    if tuple(z.shape) != (1, 16, 40, 64, 4) or not finite:
        raise AssertionError(f"{SWITCHES}: the sample is malformed")
    got = _launches_as_dry_run(SWITCHES, _want(dry, {"unet": SWITCH_STEPS}))
    check_flash_routes(SWITCHES, SWITCH_STEPS, "UNet pass")
    check_conv_routes(SWITCHES, SWITCH_STEPS)
    check_norm_routes(SWITCHES, SWITCH_STEPS, "UNet pass")
    check_small_seq(SWITCHES, SWITCH_STEPS, "UNet pass", shapes=False)
    temporal_b8 = sum(c for (r, t, h), c in A.small_seq_attention.by_shape.items() if t == 16)
    film = sum(got["fused_gn_silu_conv film"].values())
    log(f"{SWITCHES}: B8 launches over the 16 frames {temporal_b8} (the temporal attentions take the plain path) "
        f"{'OK' if temporal_b8 == 0 else 'FAIL'}; B7 launches with the FiLM {film}, {n_res} ResBlocks x "
        f"{SWITCH_STEPS} passes {'OK' if film == n_res * SWITCH_STEPS else 'FAIL'}")
    if temporal_b8 or film != n_res * SWITCH_STEPS:
        raise AssertionError(f"{SWITCHES}: B8 over 16 frames {temporal_b8}, B7 FiLM launches {film}")
    records["fused_gn_silu_conv_film"]["launches"] = film
    records["group_norm_stats_film"]["launches"] = sum(got["group_norm_stats film"].values())


def phase_x_transformer():
    """models/x_transformer.py at the width of latent-diffusion's txt2img
    BERTEmbedder (TransformerWrapper over an Encoder: vocabulary 30522, 77
    tokens, n_embed 1280, 32 layers, heads 8 of 64), seeded, f32: its
    embeddings on the card against the same module on the CPU (TF32 off;
    no kernel is involved)."""
    import copy

    import torch

    from t2v_turbo_tpu_torch.models.x_transformer import Encoder, TransformerWrapper

    torch.manual_seed(0)
    cpu = TransformerWrapper(num_tokens=30522, max_seq_len=77, attn_layers=Encoder(dim=1280, depth=32)).eval()
    card = copy.deepcopy(cpu).cuda()
    tokens = torch.randint(0, 30522, (2, 77), generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            ref = cpu(tokens, return_embeddings=True)
            cpu_s = time.perf_counter() - t0
            card(tokens.cuda(), return_embeddings=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = card(tokens.cuda(), return_embeddings=True)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            logits = card(tokens.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float((got.cpu() - ref).abs().max())
    tol = 1e-3 * max(1.0, float(ref.abs().max()))
    ok = err <= tol and bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (2, 77, 30522)
    log(f"{XT}: {sum(p.numel() for p in cpu.parameters())} parameters; embeddings {tuple(got.shape)} card vs CPU "
        f"max|diff| {err:.3e} (<= {tol:.3e}: f32, 32 layers summed in another order); logits "
        f"{tuple(logits.shape)}; ms a forward: card {1e3 * card_s:.1f}, CPU {1e3 * cpu_s:.1f} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{XT}: the card's forward differs from the CPU's by {err:.3e}")


def phase_v2_text_encoder(latent_glob):
    """apps/train_v2.py with --train-text-encoder at phase 12's point (batch
    3, else the largest that fits, said so): the text tower's last 3 blocks
    that run and ln_final train in their own group, the rest frozen; 3
    steps; the frozen text tensors bitwise unchanged and the trained ones
    moved; the EMA over the UNet alone; text_encoder.npz in JAX's layout."""
    import gc
    import shutil

    import torch

    try:
        for batch in (3, 2, 1):
            gc.collect()
            torch.cuda.empty_cache()
            try:
                _train_v2_text(latent_glob, batch)
                return
            except torch.cuda.OutOfMemoryError:
                if batch == 1:
                    raise
                log(f"{V2_TEXT}: out of memory at batch {batch} (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                    f"GiB); running batch {batch - 1}")
    finally:
        shutil.rmtree(V2_DIR, ignore_errors=True)


def _train_v2_text(latent_glob, batch):
    import math

    import numpy as np
    import torch

    from t2v_turbo_tpu_torch.apps import train_v2
    from t2v_turbo_tpu_torch.io.convert import clip_text_to_jax
    from t2v_turbo_tpu_torch.training.optim import TEXT_PREFIX

    out_dir = os.path.join(V2_DIR, "train_text")
    argv = ["--random-weights", "--latent-glob", latent_glob, "--device", "cuda:0", "--seed", "0",
            "--output-dir", out_dir, "--batch-size", str(batch), "--use-remat", "--use-motion-cond",
            "--use-target-unet", "--ema-decay", "0.95", "--optimizer", "adamw8bit", "--learning-rate", "1e-5",
            "--temporal-lr", "1e-5", "--reward-fn", "hpsv2", "--reward-scale", "0.2", "--video-rm-fn", "vi_clip",
            "--video-reward-scale", "0.5", "--vae-decode-batch-size", "16", "--max-steps", "3",
            "--checkpointing-steps", "1000000", "--train-text-encoder", "--unlocked-text-layers", "4"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, data, _ = train_v2.build_trainer(train_v2.parse_args(argv))
    torch.cuda.synchronize()
    text = trainer.text_encoder
    frozen = {n: p.detach().clone() for n, p in text.named_parameters() if not p.requires_grad}
    live = sorted(n[len(TEXT_PREFIX):] for n in trainer.param_names if n.startswith(TEXT_PREFIX))
    live0 = {k: v.clone() for k, v in trainer.text_state_dict().items() if k in live}
    blocks = sorted({int(n.split(".")[2]) for n in live if n.startswith("transformer.")})
    unet_names = {n for n, _ in trainer.student.named_parameters()}
    ema_ok = (trainer.ema.numel() == trainer._n_unet < trainer.master.numel()
              and set(trainer.state_dict_of(trainer.ema)) == unet_names
              and sum(p.numel() for p in trainer.target.parameters()) == sum(p.numel() for p in trainer.student.parameters()))
    sizes = {lb: sum(p.numel() for p in opt.params) for lb, opt in trainer.optimizers.items()}
    log(f"{V2_TEXT}: built in {time.perf_counter() - t0:.1f} s ({' '.join(argv)}); text tower "
        f"{text.cfg.layers_run} blocks run: {len(live)} tensors train ({sum(live0[k].numel() for k in live)} elements: "
        f"blocks {blocks} and ln_final), {len(frozen)} frozen; optimizer groups (elements with padding) {sizes}; "
        f"the EMA {trainer.ema.numel()} elements of the master's {trainer.master.numel()}, the UNet's alone "
        f"{'OK' if ema_ok else 'FAIL'}; memory after build {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if blocks != [text.cfg.layers_run - 3 + i for i in range(3)] or "ln_final.weight" not in live or not ema_ok:
        raise AssertionError(f"{V2_TEXT}: trained blocks {blocks}, ln_final {'ln_final.weight' in live}, EMA {ema_ok}")
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_s = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.step_once(next(data))
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        still = all(torch.equal(p, frozen[n]) for n, p in text.named_parameters() if n in frozen)
        now = trainer.text_state_dict()
        moved = sum(not torch.equal(now[k], live0[k]) for k in live)
        log(f"{V2_TEXT}: step {i + 1}{' (warm-up)' if i == 0 else ''}: {step_s[-1]:.3f} s, "
            + ", ".join(f"{k} {float(v):.6f}" for k, v in metrics.items())
            + f"; frozen text tensors bitwise unchanged {still}; trained ones moved {moved} of {len(live)}; "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not (math.isfinite(loss) and math.isfinite(gnorm) and gnorm > 0 and still and moved == len(live)):
            raise AssertionError(f"{V2_TEXT} step {i + 1}: loss {loss}, grad_norm {gnorm}, frozen unchanged {still}, "
                                 f"moved {moved} of {len(live)}")
    launches = {n: c for n, c in read_launches().items() if n in TRAIN_KERNELS or n in D512_KERNELS}
    log(f"{V2_TEXT}: kernel launches a step {dict((n, c / 3) for n, c in launches.items())}")
    check_flash_routes(V2_TEXT, 3, "step")
    check_conv_routes(V2_TEXT, 3 * 3)
    check_norm_routes(V2_TEXT, 3, "step")
    check_small_seq(V2_TEXT, 3, "step", shapes=False)
    if any(c <= 0 for c in launches.values()):
        raise AssertionError(f"{V2_TEXT}: kernels not launched {launches}")
    log(f"{V2_TEXT}: batch {batch}{'' if batch == 3 else ' (the recipe is 3: it did not fit)'}; s/step (steps 2-3) "
        f"{' '.join(f'{s:.3f}' for s in step_s[1:])}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    npz = clip_text_to_jax(trainer.text_state_dict())
    path = os.path.join(out_dir, "text_encoder.npz")
    np.savez(path, **npz)
    n_blocks = len({k.split("/")[1] for k in npz if k.startswith("params/resblocks_")})
    ok = all(v.dtype == np.float32 for v in npz.values()) and n_blocks == text.cfg.layers_run
    log(f"{V2_TEXT}: text_encoder.npz {len(npz)} arrays ({n_blocks} blocks, float32 {ok}), "
        f"{os.path.getsize(path) / 2**20:.1f} MiB")
    if not ok:
        raise AssertionError(f"{V2_TEXT}: text_encoder.npz is malformed")



SHARDED = "sharded sampling"
SHARD_SEED = 2100  # the generator seed of the phase's videos (every rank's and the reference's)
SHARD_CONFIGS = ((1, 2), (2, 1))  # (data, seq) of the bf16 videos: one prompt over seq, two over data
SHARD_CHECKED = ("flash_attention", "small_seq_attention", "fused_gn_silu_conv", "group_norm", "group_norm_stats",
                 "layer_norm") + SEQ_KERNELS


def _collective_stand_ins():
    """(module, name, function) patches of the seq collectives by shape-only
    versions, for a dry run of one rank."""
    import torch

    from t2v_turbo_tpu_torch.parallel import collectives as C

    def halo(x, group, dim):
        lo, hi = C.halo_sides(group)
        edge = x.narrow(dim, 0, 1)
        return torch.cat([edge] * lo + [x] + [edge] * hi, dim)

    def gather(parts, counts, group):
        return parts.repeat(1, group.size, 1), counts.repeat(group.size)

    def to_space(x, group):
        b, c, t, s = x.shape
        return x.new_empty((b, c, t * group.size, s // group.size))

    def to_seq(x, group):
        b, c, t, s = x.shape
        return x.new_empty((b, c, t // group.size, s * group.size))

    return [(C, "halo_exchange", halo), (C, "gather_partials", gather), (C, "seq_to_space", to_space),
            (C, "space_to_seq", to_seq)]


@functools.lru_cache(maxsize=1)
def sharded_path_shapes():
    """{(data, seq, rank): {part: {kernel: Counter(shape)}}}: `_dry_run_shapes`
    of each rank of phase 21's bf16 runs (SHARD_CONFIGS; 16x320x512): one
    UNet pass on the rank's (B / data, T / seq) block with the seq group a
    stand-in and the collectives replaced by shape-only versions, the
    decode of its share of the frames and the text encode of every prompt.
    Phase 3 holds every shape; phase 21 expects exactly these launches."""
    import torch

    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNetModel
    from t2v_turbo_tpu_torch.parallel.mesh import AxisGroup
    from t2v_turbo_tpu_torch.pipelines.vc2 import frame_split

    patches = _collective_stand_ins()
    spec = vc2_spec()
    out = {}
    for data, seq in SHARD_CONFIGS:
        prompts = data  # one prompt a data rank
        for rank in range(data * seq):
            def unet(index=rank % seq):
                model = UNetModel(spec.unet).to(torch.bfloat16)
                model.set_seq_group(AxisGroup("seq", seq, index, tuple(range(seq)), None, "gloo"))  # no group
                b = prompts // data
                model(torch.zeros(b, 16 // seq, 40, 64, 4), torch.zeros(b, dtype=torch.long),
                      torch.zeros(b, 77, 1024), fps=torch.full((b,), 16.0), timestep_cond=torch.zeros(b, 256))
            frames = frame_split(prompts * 16, data * seq)[rank]
            out[(data, seq, rank)] = _dry_run_shapes([
                ("unet", unet),
                ("vae", lambda n=frames: AutoencoderKL(spec.vae).to(torch.bfloat16).decode(torch.zeros(n, 40, 64, 4))),
                ("text", lambda: CLIPTextModel(spec.text).to(torch.bfloat16)(
                    torch.zeros(prompts, 77, dtype=torch.long))),
            ], patches)
    return out


def _sharded_cases(cases_before, attn, flash, conv, gn, gn_stats, ln, small_seq, norm_inputs, unfused, why_round):
    """Phase 3's cases for phase 21 (sequence- and data-parallel sampling):
    every (kernel, shape) of `sharded_path_shapes` must be held by a case,
    or fails. The sequence-parallel entries at every shape of the path,
    recorded under their own names (level 0 first, whose times the record
    keeps), each held to its plain twin on its route and launched twice
    with equal bits: B4's partials (`group_norm_partials`) of a rank's clip
    shard, B4's apply from two ranks' partials with their counts
    (`group_norm_from_partials`), B7's (a, b) from them
    (`group_norm_affine_from_partials`), B7 on given (a, b) over the clip
    extended by its halo frames (`fused_gn_silu_conv_ab`, T / seq + 1 frames
    at seq 2); and, checked only as "<kernel> (sharded)", the path's other
    shapes that no earlier case holds (B8 at B*H*W / seq rows, the per-frame
    kernels at T / seq frames, the decode of a rank's share, the text
    tower at two prompts)."""
    import collections

    import torch
    import torch.nn.functional as F

    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    bf = torch.bfloat16
    shapes = collections.defaultdict(set)
    for runs in list(sharded_path_shapes().values()) + list(sharded_training_shapes().values()):
        for part in runs.values():
            for k, c in part.items():
                shapes[k] |= set(c)
    held = {key for case in cases_before for key in case.get("holds", ())}

    def with_parts(shape, c):
        """x (a rank's clip shard), w, b, and the partials of x and of a
        second rank's shard with their counts, gathered in rank order."""
        base = norm_inputs(shape, c, bf)

        def make():
            x, w, b = base()
            g = torch.Generator("cuda").manual_seed(c + 1)
            other = (3.0 * torch.randn(shape, generator=g, device="cuda") + 1.0).to(bf)
            halves = [N.group_norm_partials_plain(t, 32) for t in (x, other)]
            return [x, w, b, torch.cat([p for p, _ in halves], 1).contiguous(), torch.cat([n for _, n in halves])]
        return make

    def partials(shape):
        plan = N.partials_plan(shape[0], shape[1], 32, prod(shape[2:]), bf)
        return dict(kernel="group_norm_partials", label=f"seq rank's clip {shape} bf16 [split, {plan.k} chunks of "
                    f"{plan.chunk}]", make=norm_inputs(shape, shape[1], bf),
                    fn=lambda x, w, b: N.group_norm_partials(x, 32),
                    plain=lambda x, w, b: N.group_norm_partials_plain(x, 32), outputs=("parts", "counts"),
                    tols=[_elementwise(1e-3, 1e-4), _elementwise(0.0, 0.0)], iters=20, graph=True,
                    why="f32 sums (and sums of squares about the chunk's mean) of up to 8192 bf16 values in another "
                        "order; the counts exact", route=(N.group_norm_partials, "split"),
                    library=lambda x, w, b: {"F.group_norm": lambda: F.group_norm(x, 32, w.to(bf), b.to(bf), 1e-6)},
                    bound=lambda x, *_: bound_ms(3 * x.numel(), x.numel() * x.element_size(), "float32"),
                    holds=[("group_norm_partials", shape)])

    def apply(shape):
        return dict(kernel="group_norm_from_partials", label=f"seq rank's clip {shape} bf16, 2 ranks' partials "
                    "[split]", make=with_parts(shape, shape[1]),
                    fn=lambda x, w, b, p, n: N.group_norm_from_partials(x, p, n, w, b, 32, 1e-6),
                    plain=lambda x, w, b, p, n: N.group_norm_from_partials_plain(x, p, n, w, b, 32, 1e-6),
                    outputs=("y",), tols=[_elementwise(1e-2, 1e-2)], iters=20, graph=True,
                    why="bf16 output; f32 statistics combined in another order can move a value by one bf16 ulp",
                    route=(N.group_norm_from_partials, "split"),
                    library=lambda x, w, b, *_: {"F.group_norm": lambda: F.group_norm(x, 32, w.to(bf), b.to(bf), 1e-6)},
                    bound=lambda x, *_: norm_bound(x, shape[1], 10), holds=[("group_norm_from_partials", shape)])

    def affine(key, shape):
        return dict(kernel="group_norm_affine_from_partials", label=f"(a, b) of {key[0]}x{key[1]} from {key[2]} "
                    f"partials (2 ranks of {shape}) [warp]", make=with_parts(shape, shape[1]),
                    fn=lambda x, w, b, p, n: N.group_norm_affine_from_partials(p, n, w, b, 32, 1e-5),
                    plain=lambda x, w, b, p, n: N.group_norm_affine_from_partials_plain(p, n, w, b, 32, 1e-5),
                    outputs=("a", "b"), tols=2 * [_elementwise(1e-5, 1e-5)], iters=20, graph=True,
                    why="f32 (N, C) vectors; the partials combined in another order",
                    route=(N.group_norm_affine_from_partials, "warp"), library=lambda *_: {},
                    bound=lambda x, w, b, p, n: bound_ms(
                        10 * p.numel(), p.numel() * 4 + 8 * key[0] * key[1] + 8 * key[1], "float32"),
                    holds=[("group_norm_affine_from_partials", key)])

    def conv_ab(shape):
        n, c, hh, ww, o, kh, kw = shape
        plan = FC.conv_plan(*shape, bf)

        def make():  # B7's inputs, the statistics folded into (a, b)
            g = torch.Generator("cuda").manual_seed(c + o + hh)
            x = (2.0 * torch.randn((n, c, hh, ww), generator=g, device="cuda") + 0.5).to(bf)
            gs = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            gb = 0.1 * torch.randn(c, generator=g, device="cuda")
            a, b = FC.gn_affine_vectors(x, gs, gb, 32, 1e-5)
            w = (torch.randn((o, c, kh, kw), generator=g, device="cuda") / (c * kh * kw) ** 0.5).to(bf)
            return [x, a, b, w, (0.1 * torch.randn(o, generator=g, device="cuda")).to(bf)]

        def library(x, a, b, w, bias):
            return {"x*a+b, F.silu, F.conv2d": lambda: F.conv2d(F.silu(x * a[:, :, None, None].to(bf)
                                                                    + b[:, :, None, None].to(bf)), w, bias,
                                                                    padding=(1, 0))}
        return dict(kernel="fused_gn_silu_conv_ab", label=f"halo-extended clip {c}->{o} ({kh},{kw}) {shape[:4]} bf16 "
                    f"[{plan.tw}x{plan.tr} tiles, {plan.splits} split(s), {prod(plan.grid)} blocks]", make=make,
                    fn=FC.fused_gn_silu_conv_ab, plain=FC.fused_gn_silu_conv_ab_plain, outputs=("y",),
                    tols=[_elementwise(2e-2, 2e-2)], iters=10,
                    why="bf16 output; both round silu(x*a+b) to bf16 (an activation may land one ulp apart) and the "
                        "kernel sums the C*kh*kw products in another order",
                    route=(FC.fused_gn_silu_conv_ab, plan.route), library=library,
                    bound=lambda x, a, b, w, bias: conv_bound(x, w, o), holds=[("fused_gn_silu_conv_ab", shape)])

    cases = []
    by_size = lambda s: (-prod(s[2:]), s)  # noqa: E731  (level 0 first: the record keeps its times)
    clips = sorted(shapes["group_norm_partials"], key=by_size)
    cases += [partials(s) for s in clips] + [apply(s) for s in sorted(shapes["group_norm_from_partials"], key=by_size)]
    for key in sorted(shapes["group_norm_affine_from_partials"], key=lambda k: (k[1], -k[2])):  # level 0 first
        clip = next(s for s in clips if s[:2] == key[:2] and 2 * N.partials_plan(
            s[0], s[1], 32, prod(s[2:]), bf).k == key[2])
        cases.append(affine(key, clip))
    cases += [conv_ab(s) for s in sorted(shapes["fused_gn_silu_conv_ab"], key=lambda s: (-s[2] * s[3], s))]
    held |= {key for case in cases for key in case["holds"]}
    others = {  # a checked-only case for a shape of the family
        "group_norm": lambda s: gn(f"sharded GN+SiLU {s} bf16", s, s[1], 1e-6, 3),
        "group_norm_stats": lambda s: gn_stats(f"B7 statistics, sharded {s} bf16", s, s[1], False, iters=3),
        "layer_norm": lambda s: ln(f"sharded LN {s} bf16", s, s[1], bf, 1e-2, "bf16 output; f32 statistics summed "
                                   "in another order can move a value by one bf16 ulp"),
        "fused_gn_silu_conv": lambda s: conv(f"sharded {s[1]}->{s[4]} ({s[5]},{s[6]}) {s[:4]} bf16", s, iters=3,
                                             f64=False),
        "small_seq_attention": lambda s: small_seq(f"sharded ({s[0]},{s[1]},{s[2]},64) bf16",
                                                   attn(s[0], s[1], s[2], 64, bf), s, iters=3),
        "flash_attention": lambda s: flash(f"sharded {s} bf16", attn(s[0], s[2], s[1], s[4], bf, sk=s[3]), 2e-2, 2e-2,
                                           3, why_round, f64=False),
    }
    for family, make in others.items():
        for shape in sorted(s for s in shapes[family] if (family, s) not in held):
            cases.append(make(shape))
            cases[-1]["kernel"] = f"{family} (sharded)"
            held |= set(cases[-1]["holds"])
    for case in cases:
        case["twice"] = True
    missing = sorted((k, s) for k, ss in shapes.items() for s in ss if (k, s) not in held)
    if missing:
        raise AssertionError(f"phase 3 holds no case for these launches of the sharded phases: {missing}")
    return cases


def _sharded_rank(rank, world, port, work, queue):
    """One rank of phase 21 (a spawned process): joins a gloo world on the
    one card, runs the f32 UNet pass at (1, 2), the bf16 videos at (1, 2)
    and (2, 1), the served request at (1, 2), and puts its counters (or its
    traceback) on `queue`."""
    try:
        queue.put((rank, True, _sharded_rank_work(rank, world, port, work)))
    except BaseException:  # report to the parent, which fails the phase
        queue.put((rank, False, traceback.format_exc()))
        raise


def _sharded_rank_work(rank, world, port, work):
    import dataclasses
    import threading

    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from t2v_turbo_tpu_torch.apps import generate, serve
    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.models import UNetModel, seeded_init_
    from t2v_turbo_tpu_torch.parallel import collectives, multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh, shard

    device = multihost.initialize(f"localhost:{port}", world, rank, backend="gloo", share_device=True, timeout_s=300)
    out = {"device": str(device)}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        seq_mesh = make_mesh(data=1, seq=2, device=device)
        data_mesh = make_mesh(data=2, seq=1, device=device)
        # (a) one f32 UNet pass on this rank's 8 frames
        x = torch.load(os.path.join(work, "unet_inputs.pt"))
        with torch.device(device):
            unet = UNetModel(vc2_spec().unet)
        seeded_init_(unet, 0)  # generate --random-weights --seed 0's UNet, in f32
        unet.eval().requires_grad_(False).set_seq_group(seq_mesh.axis("seq"))
        with torch.no_grad():
            y = unet(shard(seq_mesh, x["lat"], ("data", "seq")), x["t"].to(device), x["ctx"].to(device),
                     fps=x["fps"].to(device), timestep_cond=x["w_emb"].to(device))
        torch.save(y.cpu(), os.path.join(work, f"unet_f32_{rank}.pt"))
        del unet, y
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        out["peak_f32_gib"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        # (b) the bf16 4-step videos
        args = generate.parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device", "cuda"])
        pipe = generate.build_pipeline(args, mesh=seq_mesh)
        runs = {(1, 2): (pipe, PROMPTS[0]), (2, 1): (dataclasses.replace(pipe, mesh=data_mesh), list(PROMPTS[:2]))}
        for (data, seq), (p, prompt) in runs.items():
            p.unet.set_seq_group(p.mesh.axis("seq"))
            walls = []
            for i in range(2):  # a warm-up call, then the timed one with its counters
                reset_launches()
                collectives.reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                video = p(prompt=prompt, generator=torch.Generator(device=device).manual_seed(SHARD_SEED))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            out[(data, seq)] = {"s_video": walls, "launches": launch_snapshot(),
                                "collectives": collectives.read_counters()}
            if rank == 0:
                np.save(os.path.join(work, f"video_{data}x{seq}.npy"), video.float().cpu().numpy())
            elif video is not None:
                raise AssertionError(f"rank {rank} returned a video")
        pipe.unet.set_seq_group(seq_mesh.axis("seq"))
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30  # the bf16 runs: its own weights and 8 frames
        # (c) serve --seq-shards 2: rank 0 answers a POST, rank 1 follows
        sargs = serve.parse_args(["--random-weights", "--device", "cuda", "--seq-shards", "2", "--port", "0",
                                  "--output-dir", os.path.join(work, "served")])
        if rank == 0:
            srv = serve.make_server(pipe, sargs)
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            try:
                code, answer = _http(f"http://127.0.0.1:{srv.server_address[1]}", "/generate",
                                     {"prompt": PROMPTS[0], "seed": SHARD_SEED})
            finally:
                srv.shutdown()
                serve.stop(srv)
                srv.server_close()
            out["served"] = (code, answer)
        else:
            serve.follow(pipe)
            out["served"] = "followed"
    finally:
        multihost.shutdown()
    return out


def _nccl_world_of_one(pipe):
    """A world of one rank over NCCL on the card (initialize's CUDA path, one
    collective), and the pipeline over its mesh: the single-device path,
    its video and its launches by kernel, route and shape equal to the
    pipeline's without a mesh."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from t2v_turbo_tpu_torch.parallel import multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh

    def video(p):
        reset_launches()
        v = p(prompt=PROMPTS[0], generator=torch.Generator(device="cuda").manual_seed(SHARD_SEED))
        return v, launch_snapshot()

    plain, snap = video(pipe)
    t0 = time.perf_counter()
    device = multihost.initialize(f"localhost:{_free_port()}", 1, 0, timeout_s=120)
    try:
        one = torch.ones(4, device=device)
        dist.all_reduce(one)
        backend = dist.get_backend()
        got, got_snap = video(dataclasses.replace(pipe, mesh=make_mesh(device=device)))
    finally:
        multihost.shutdown()
        pipe.unet.set_seq_group(None)
    same = torch.equal(got, plain) and got_snap == snap
    log(f"{SHARDED}: a world of one rank on {device} over {backend} ({time.perf_counter() - t0:.1f} s, all_reduce "
        f"{one.tolist()}): its video and its launches by kernel, route and shape equal the pipeline's without a mesh "
        f"{'OK' if same and backend == 'nccl' and one.tolist() == [1.0] * 4 else 'FAIL'}")
    if not same or backend != "nccl":
        diff = {n: (got_snap[n], snap[n]) for n in snap if got_snap[n] != snap[n]}
        raise AssertionError(f"{SHARDED}: the world of one differs: video equal {torch.equal(got, plain)}, {diff}")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded(records):
    """Data- and sequence-parallel VC2 sampling at full width on two ranks
    that share the one card (gloo: NCCL refuses two ranks on one device;
    the collectives stage through host memory), against the single-rank
    run in this process."""
    import collections
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from t2v_turbo_tpu_torch.apps.generate import build_pipeline, parse_args
    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.diffusion import guidance_scale_embedding
    from t2v_turbo_tpu_torch.models import UNetModel, seeded_init_
    from t2v_turbo_tpu_torch.pipelines.vc2 import video_to_uint8

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_", dir=os.path.join(HERE, "build"))
    try:
        # the single-rank references: (a) one f32 UNet pass, TF32 off
        torch.backends.cudnn.allow_tf32 = False
        g = torch.Generator(device="cuda").manual_seed(SHARD_SEED)
        x = {"lat": torch.randn((1, 16, 40, 64, 4), generator=g, device="cuda"),
             "t": torch.full((1,), 500, dtype=torch.long),
             "ctx": torch.randn((1, 77, 1024), generator=g, device="cuda"),
             "fps": torch.full((1,), 16.0), "w_emb": guidance_scale_embedding(torch.full((1,), 7.5), 256)}
        torch.save({k: v.cpu() for k, v in x.items()}, os.path.join(work, "unet_inputs.pt"))
        with torch.device("cuda"):
            unet = UNetModel(vc2_spec().unet)
        seeded_init_(unet, 0)
        unet.eval().requires_grad_(False)
        with torch.no_grad():
            ref_f32 = unet(x["lat"], x["t"].cuda(), x["ctx"], fps=x["fps"].cuda(), timestep_cond=x["w_emb"].cuda())
        ref_f32 = ref_f32.cpu()
        del unet, x
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        # (b) the bf16 videos, (1, 1), timed as the ranks time theirs
        pipe = build_pipeline(parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device",
                                          "cuda:0"]))
        refs, single_s = {}, {}
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            for data, prompt in ((1, PROMPTS[0]), (2, list(PROMPTS[:2]))):
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    v = pipe(prompt=prompt, generator=torch.Generator(device="cuda").manual_seed(SHARD_SEED))
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                refs[data], single_s[data] = v.float().cpu(), walls[-1]
            single_peak = torch.cuda.max_memory_allocated() / 2**30
            _nccl_world_of_one(pipe)
        del pipe, v
        torch.cuda.empty_cache()

        # the two ranks, spawned (they load the library phase 2 built)
        log(f"{SHARDED}: spawning 2 ranks on cuda:0 over gloo with share_device=True (NCCL refuses two ranks on one "
            "device; gloo stages every collective through host memory)")
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        port = _free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_sharded_rank, args=(r, 2, port, work, queue)) for r in range(2)]
        for p in procs:
            p.start()
        results, deadline = {}, time.time() + 600
        try:
            while len(results) < 2:
                try:
                    rank, ok, res = queue.get(timeout=5)
                except Exception:  # queue.Empty: check that the ranks still live
                    if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                        raise AssertionError(f"{SHARDED}: ranks ended without a result (exit codes "
                                             f"{[p.exitcode for p in procs]})")
                    continue
                if not ok:
                    raise AssertionError(f"{SHARDED}: rank {rank} failed:\n{res}")
                results[rank] = res
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        log(f"{SHARDED}: both ranks done in {time.perf_counter() - t0:.1f} s (spawn, build, runs), exit codes "
            f"{[p.exitcode for p in procs]}; max_memory_allocated a rank: the f32 UNet pass "
            f"{[round(results[r]['peak_f32_gib'], 2) for r in (0, 1)]} GiB, the bf16 videos and the request "
            f"{[round(results[r]['peak_gib'], 2) for r in (0, 1)]} GiB (each rank its own copy of the weights), one "
            f"rank's two videos here {single_peak:.2f} GiB")
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{SHARDED}: rank exit codes {[p.exitcode for p in procs]}")

        # (a) the f32 UNet pass
        got = torch.cat([torch.load(os.path.join(work, f"unet_f32_{r}.pt")) for r in (0, 1)], dim=1)
        err = float((got - ref_f32).abs().max())
        log(f"{SHARDED}: f32 UNet pass at (data, seq) = (1, 2) against one process: max|d| {err:.3e} (<= 2e-4, the "
            f"North-star UNet tolerance; |ref| <= {float(ref_f32.abs().max()):.3f}) {'OK' if err <= 2e-4 else 'FAIL'}")
        if not err <= 2e-4:
            raise AssertionError(f"{SHARDED}: the f32 sharded UNet pass differs by {err}")
        # (b) the bf16 videos
        for data, seq in SHARD_CONFIGS:
            v = torch.from_numpy(np.load(os.path.join(work, f"video_{data}x{seq}.npy")))
            d = (v - refs[data]).abs()
            mean, most = float(d.mean()), float(d.max())
            log(f"{SHARDED}: bf16 4-step video at (data, seq) = ({data}, {seq}), {data} prompt(s), shape "
                f"{tuple(v.shape)}, against one rank: mean|d| {mean:.3e} (<= 1e-2 on [-1, 1]), max|d| {most:.3e} "
                f"{'OK' if mean <= 1e-2 and tuple(v.shape) == tuple(refs[data].shape) else 'FAIL'}")
            if not mean <= 1e-2 or tuple(v.shape) != tuple(refs[data].shape):
                raise AssertionError(f"{SHARDED}: the ({data}, {seq}) video differs: mean {mean}, max {most}")
        # (c) the served request
        code, answer = results[0]["served"]
        served = np.load(answer["path"]) if code == 200 else None
        want = video_to_uint8(torch.from_numpy(np.load(os.path.join(work, "video_1x2.npy"))))[0]
        same = served is not None and np.array_equal(served, want)
        log(f"{SHARDED}: serve --seq-shards 2: rank 0 answered {code} (latency_s {answer.get('latency_s')}, shape "
            f"{answer.get('shape')}), rank 1 {results[1]['served']}; the video equals the (1, 2) run's to the bit "
            f"(uint8) {'OK' if same and results[1]['served'] == 'followed' else 'FAIL'}")
        if not same or results[1]["served"] != "followed":
            raise AssertionError(f"{SHARDED}: serving failed: {code} {answer}")

        # every rank's launches: the dry run's, on the paths' routes
        dry = sharded_path_shapes()
        seq_launches = collections.Counter()
        for data, seq in SHARD_CONFIGS:
            for r in (0, 1):
                snap = results[r][(data, seq)]["launches"]
                want = _want(dry[(data, seq, r)], {"unet": 4, "vae": 1, "text": 1})
                bad = [n for n in SHARD_CHECKED
                       if collections.Counter(snap[n][2]) != want.get(n, collections.Counter())]
                routes = {n: snap[n][1] for n in ("flash_attention", "small_seq_attention", "fused_gn_silu_conv",
                                                  "fused_gn_silu_conv_ab", "group_norm_partials",
                                                  "group_norm_from_partials", "group_norm_affine_from_partials")}
                wrong = {n: r_ for n, r_ in routes.items() if set(r_) - {"wgmma", "bulk", "split", "warp"}}
                wrong.update({n: snap[n][1] for n in ("group_norm", "group_norm_stats")
                              if set(snap[n][1]) - {"cta", "cluster", "split"}})
                need = ["flash_attention", "group_norm", "layer_norm", "fused_gn_silu_conv", "small_seq_attention"]
                if seq > 1:
                    need += list(SEQ_KERNELS)
                    halo = [s for s in snap["fused_gn_silu_conv_ab"][2] if s[2] != 16 // seq + 1]
                    rows = sorted(snap["small_seq_attention"][2])
                    log(f"{SHARDED} ({data}, {seq}) rank {r}: B7 on given (a, b) by shape "
                        f"{dict(sorted(snap['fused_gn_silu_conv_ab'][2].items()))}; B8 by shape {rows}")
                    if halo:
                        raise AssertionError(f"{SHARDED}: B7 on given (a, b) at shapes without the halo: {halo}")
                    seq_launches.update({n: snap[n][0] for n in SEQ_KERNELS})
                missing = [n for n in need if snap[n][0] <= 0]
                log(f"{SHARDED} ({data}, {seq}) rank {r}: launches {({n: snap[n][0] for n in SHARD_CHECKED})} by "
                    f"route {({n: v for n, v in routes.items() if v})}; by kernel and shape equal the dry run's "
                    f"{'OK' if not (bad or wrong or missing) else 'FAIL'}")
                if bad or wrong or missing:
                    raise AssertionError(f"{SHARDED}: rank {r} at ({data}, {seq}): shapes differ for {bad}, routes "
                                         f"{wrong}, not launched {missing}")
        for name in SEQ_KERNELS:
            records.get(name, {})["launches"] = seq_launches[name]  # (a --phases run has no phase-3 records)

        # times; the collectives of the timed runs
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        line = [f"(1, 1) {single_s[1]:.3f} (one prompt), {single_s[2]:.3f} (two prompts)"]
        for data, seq in SHARD_CONFIGS:
            r0 = results[0][(data, seq)]
            coll = r0["collectives"]
            secs = sum(c["seconds"] for c in coll.values())
            staged = sum(c["staged_bytes"] for c in coll.values())
            calls = {n: c["calls"] for n, c in coll.items() if c["calls"]}
            line.append(f"({data}, {seq}) {r0['s_video'][-1]:.3f}")
            log(f"{SHARDED} ({data}, {seq}): rank 0's collectives in the timed video: {calls} calls, "
                f"{secs:.3f} s of transport (synchronised, staged through host memory), "
                f"{staged / 2**20:.1f} MiB staged")
        log(f"{SHARDED}: s/video {'; '.join(line)} [{smi}]; two ranks sharing one card, over gloo with every "
            "collective staged through host memory: not a scaling figure")
    finally:
        torch.backends.cudnn.allow_tf32 = True
        shutil.rmtree(work, ignore_errors=True)
    log(f"{SHARDED}: phase wall {time.perf_counter() - t_phase:.1f} s")


SHARDED_TRAIN = "sharded training"
TRAIN_SHARD_LR = 1e-3  # with Adam's eps = 1 (`_eps_one`) an element moves by ~lr x its clipped gradient
SAMPLE = 11  # the factors', gradients' and state slices' elements compared: every SAMPLE-th
GRAD_FLASH = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
TRAIN_SHARD_CHECKED = SHARD_CHECKED + GRAD_FLASH
# ((data, seq), a data rank's batch, extra flags, steps, the one-process reference): one clip a rank at
# both layouts (the global batch of 1 over seq, of 2 over data), the reward run at (1, 2), one step
V1_SHARD_RUNS = (((1, 2), 1, (), 2, "v1 B1"), ((2, 1), 1, (), 2, "v1 B2"),
                 ((1, 2), 1, ("--reward-fn", "hpsv2", "--use-remat"), 1, "v1 reward"))


@functools.lru_cache(maxsize=1)
def sharded_training_shapes():
    """{(data, seq, rank): {"nograd": {kernel: Counter(shape)}, "grad": ...}}:
    `_dry_run_shapes` of one UNet pass on each rank's block of phase 22's
    v1 runs without a reward (one clip a rank: T = 16 / seq, 40x64 latents,
    the 77x1024 context), without a gradient (a step's two teacher passes
    and its target pass: phase 21's dry run of the same block) and with one
    (the student's pass), the seq collectives shape-only stand-ins. Phase 3
    holds every shape; phase 22 expects exactly these launches
    (`_training_want`)."""
    import torch

    from t2v_turbo_tpu_torch.config import vc2_spec
    from t2v_turbo_tpu_torch.models import UNetModel
    from t2v_turbo_tpu_torch.parallel.mesh import AxisGroup

    spec = vc2_spec()
    sampling = sharded_path_shapes()
    out, grads = {}, {}
    for (data, seq), b, extra, _, _ in V1_SHARD_RUNS:
        if extra:
            continue
        t = 16 // seq
        for rank in range(data * seq):
            index = rank % seq
            key = (b, t, seq, index)  # a rank's pass depends on its seq index (its halo sides), not its data index

            def unet(index=index, b=b, t=t, seq=seq):
                model = UNetModel(spec.unet).to(torch.bfloat16)
                model.set_seq_group(AxisGroup("seq", seq, index, tuple(range(seq)), None, "gloo"))  # no group
                model(torch.zeros(b, t, 40, 64, 4), torch.zeros(b, dtype=torch.long), torch.zeros(b, 77, 1024),
                      fps=torch.full((b,), 16.0), timestep_cond=torch.zeros(b, 256))
            if key not in grads:
                grads[key] = _dry_run_shapes([("unet", unet)], _collective_stand_ins(), grad=True)["unet"]
            out[(data, seq, rank)] = {"nograd": sampling[(data, seq, rank)]["unet"], "grad": grads[key]}
    return out


def _training_want(dry, steps):
    """{kernel: Counter(shape)} of `steps` v1 steps (no remat) from a rank's
    dry run: the two teacher passes and the target's without a gradient;
    the student's with one, whose attention takes B2 forward and B3's two
    kernels back (the norms' and B7's backward are plain math)."""
    import collections

    want = collections.defaultdict(collections.Counter)
    for part, times in (("nograd", 3), ("grad", 1)):
        for k, c in dry[part].items():
            for name in (GRAD_FLASH if part == "grad" and k == "flash_attention" else (k,)):
                for shape, m in c.items():
                    want[name][shape] += times * steps * m
    return want


def _v1_train_argv(batch, out_dir, extra=()):
    return ["--random-weights", "--synthetic-data", "--device", "cuda:0", "--seed", "0", "--output-dir", out_dir,
            "--batch-size", str(batch), "--max-steps", "2", "--checkpointing-steps", "1000000", "--optimizer",
            "adamw", "--learning-rate", str(TRAIN_SHARD_LR)] + list(extra)


def _v2_train_argv(latent_glob, batch, out_dir, extra=()):
    return ["--random-weights", "--latent-glob", latent_glob, "--device", "cuda:0", "--seed", "0", "--output-dir",
            out_dir, "--batch-size", str(batch), "--use-remat", "--use-motion-cond", "--use-target-unet",
            "--ema-decay", "0.95", "--optimizer", "adamw8bit", "--learning-rate", "1e-5", "--max-steps", "3",
            "--checkpointing-steps", "1000000"] + list(extra)


def _write_v2_latents(root, n=4):
    """n v2 samples at full width (the preprocess's keys and dtypes: the
    16x40x64x4 latents, teacher outputs and motion score, the 77x1024
    context), seeded, as apps/preprocess.py writes them; the glob."""
    import pickle

    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(2200)
    for i in range(n):
        z = lambda s=1.0: (s * rng.randn(16, 40, 64, 4)).astype(np.float32)  # noqa: E731
        sample = {"index": np.int32(rng.randint(20, 50)), "z_t": z(), "cond_teacher_out": z(),
                  "uncond_teacher_out": z(), "score": z(0.1), "prompt_emb": rng.randn(77, 1024).astype(np.float32),
                  "use_motion_guide": True, "txt": PROMPTS[i % len(PROMPTS)], "short_txt": ""}
        with open(os.path.join(root, f"{i:05d}.pkl"), "wb") as f:
            pickle.dump(sample, f)
    return os.path.join(root, "*.pkl")


def _eps_one(trainer):
    """Adam's eps = 1 on a v1 trainer, before its first step: an element then
    moves by about lr x its clipped gradient, so the factors after a step
    carry the gradient (at eps = 1e-8 each moves by ~lr whatever its
    gradient, and two runs agree within 2 x lr x step by construction)."""
    for opt, _ in trainer._groups:
        opt.eps = 1.0
    return trainer


def _state_sample(trainer):
    """Every SAMPLE-th element of the trainer's f32 state (the LoRA factors or
    this rank's master slice), on the host."""
    return (trainer.flat if not trainer.full_model else trainer.master)[::SAMPLE].float().cpu()


def _train_steps(trainer, data, steps, skip=0):
    """`steps` timed step_once calls (after `skip` batches); per step (loss,
    grad_norm, the LoRA factors or the master slice and the gradient, every
    SAMPLE-th element, on the host)."""
    import torch

    for _ in range(skip):
        next(data)
    recs, walls = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.step_once(next(data))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        grad = trainer._grad_flat if trainer._shards is None else trainer._grad_shard
        recs.append((loss, gnorm, _state_sample(trainer), grad[::SAMPLE].float().cpu()))
    return recs, walls


def _free():
    """Return the card's memory of the objects just deleted."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _host_tree(obj):
    """obj with every tensor as a numpy array: a queue carries values, not the
    shared memory of a process that may have ended."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    return obj


def _sharded_train_rank(rank, world, port, work, queue):
    """One rank of phase 22 (a spawned process); puts its results (or its
    traceback) on `queue`."""
    try:
        queue.put((rank, True, _host_tree(_sharded_train_rank_work(rank, world, port, work))))
    except BaseException:  # report to the parent, which fails the phase
        queue.put((rank, False, traceback.format_exc()))
        raise




def _sharded_train_rank_work(rank, world, port, work):
    import torch

    sys.path.insert(0, HERE)
    from t2v_turbo_tpu_torch.apps import train_v1, train_v2
    from t2v_turbo_tpu_torch.parallel import collectives, multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh
    from t2v_turbo_tpu_torch.training.trainer import draws_seed

    device = multihost.initialize(f"localhost:{port}", world, rank, backend="gloo", share_device=True,
                                  timeout_s=900)
    out = {"device": str(device)}
    t_rank = time.perf_counter()

    def progress(what):
        print(f"{SHARDED_TRAIN} rank {rank}: {what} at {time.perf_counter() - t_rank:.1f} s", flush=True)
    try:
        for (data, seq), batch, extra, steps, _ in V1_SHARD_RUNS:
            key = f"{data}x{seq}" + (" reward" if extra else "")
            mesh = make_mesh(data=data, seq=seq, device=device)
            args = train_v1.parse_args(_v1_train_argv(batch, os.path.join(work, f"v1 {key}"), extra))
            t0 = time.perf_counter()
            trainer, it, _ = train_v1.build_trainer(args, mesh=mesh)
            build_s = time.perf_counter() - t0
            _eps_one(trainer)
            reset_launches()
            collectives.reset_counters()
            torch.cuda.reset_peak_memory_stats()
            recs, walls = _train_steps(trainer, it, steps)
            out[key] = {"build_s": build_s, "walls": walls, "launches": launch_snapshot(),
                        "collectives": collectives.read_counters(), "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                        "metrics": [r[:2] for r in recs], "flat_sum": [float(r[2].double().sum()) for r in recs]}
            if rank == 0:
                torch.save([r[2:] for r in recs], os.path.join(work, f"v1 {key}.pt"))
            progress(f"v1 {key} done")
            del trainer, it
            _free()
        # v2 --fsdp at (2, 1): two steps, a checkpoint, a third; a fresh trainer resumes and retakes the third
        mesh = make_mesh(data=2, seq=1, device=device)
        args = train_v2.parse_args(_v2_train_argv(os.path.join(work, "latents", "*.pkl"), 1,
                                                  os.path.join(work, "v2 fsdp"), ("--fsdp",)))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, it, _ = train_v2.build_trainer(args, mesh=mesh)
        v2 = {"build_s": time.perf_counter() - t0, "build_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
              "local": [trainer.master.numel(), trainer.ema.numel(), trainer._shards.size],
              "whole": trainer._segments[-1][1]}
        collectives.reset_counters()
        progress("v2 built")
        recs, walls = _train_steps(trainer, it, 2)
        progress("v2 steps 1-2 done")
        t0 = time.perf_counter()
        trainer.save(2)
        v2["save_s"] = time.perf_counter() - t0
        trainer.generator.manual_seed(draws_seed(trainer.cfg.seed, 2))  # as `run` restarting at step 2 draws

        def state(tr):
            opt = tr.optimizers["base"]
            return [tr.master[::SAMPLE].cpu(), tr.ema[::SAMPLE].cpu(), tr.working[::SAMPLE].cpu(),
                    opt.mu[0][0][::SAMPLE].cpu(), opt.nu[0][1].cpu()]
        saved = state(trainer)
        progress("v2 saved")
        more, walls3 = _train_steps(trainer, it, 1)
        after3 = [more[0][2], trainer.ema[::SAMPLE].cpu()]
        v2.update(walls=walls + walls3, metrics=[r[:2] for r in recs + more], peak_gib=torch.cuda.max_memory_allocated()
                  / 2**30, collectives=collectives.read_counters())
        del trainer, it
        _free()
        fresh, it, _ = train_v2.build_trainer(args, mesh=mesh)
        t0 = time.perf_counter()
        start = fresh.resume_if_available()
        v2["resume_s"] = time.perf_counter() - t0
        fresh.generator.manual_seed(draws_seed(fresh.cfg.seed, start))
        v2["restored_equal"] = [bool(torch.equal(a, b)) for a, b in zip(saved, state(fresh))]
        progress("v2 resumed")
        again, _ = _train_steps(fresh, it, 1, skip=2)
        # the retaken step against the uninterrupted one: metrics, the master's and EMA's slices
        ema3 = fresh.ema[::SAMPLE].cpu()
        v2["again"] = [again[0][:2], float((again[0][2] - after3[0]).abs().max()),
                       float((ema3 - after3[1]).abs().max())]
        v2["again_equal"] = [bool(torch.equal(again[0][2], after3[0])), bool(torch.equal(ema3, after3[1]))]
        v2["start"] = start
        out["v2"] = v2
        del fresh, it
        _free()
    finally:
        multihost.shutdown()
    return out


def _nccl_world_of_one_step(argv, want_recs, want_snap):
    """A world of one rank over NCCL: the v1 trainer built over its mesh takes
    the first step of the reference; its factors, loss, grad_norm and
    launches by kernel, route and shape equal the reference's to the bit.
    A mesh of one is no mesh to the trainer (every collective helper returns
    its input for a group of one): this checks that the flags and the
    process group leave the step alone, not a collective over NCCL; the
    all_reduce here is the one NCCL call."""
    import torch
    import torch.distributed as dist

    from t2v_turbo_tpu_torch.apps import train_v1
    from t2v_turbo_tpu_torch.parallel import multihost
    from t2v_turbo_tpu_torch.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    device = multihost.initialize(f"localhost:{_free_port()}", 1, 0, timeout_s=120)
    try:
        one = torch.ones(4, device=device)
        dist.all_reduce(one)
        backend = dist.get_backend()
        trainer, it, _ = train_v1.build_trainer(train_v1.parse_args(argv), mesh=make_mesh(device=device))
        _eps_one(trainer)
        reset_launches()
        recs, _ = _train_steps(trainer, it, 1)
        snap = launch_snapshot()
        del trainer, it
        _free()
    finally:
        multihost.shutdown()
    got, want = recs[0], want_recs[0]
    same = (got[0] == want[0] and got[1] == want[1] and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
            and snap == want_snap)
    log(f"{SHARDED_TRAIN}: a world of one rank on {device} over {backend} ({time.perf_counter() - t0:.1f} s, all_reduce "
        f"{one.tolist()}): the v1 step over its mesh (loss {got[0]:.6f}, grad_norm {got[1]:.6f}) equals the step "
        f"without one to the bit, factors, gradient and launches by kernel, route and shape "
        f"{'OK' if same and backend == 'nccl' else 'FAIL'}")
    if not same or backend != "nccl":
        diff = {n: (snap[n], want_snap[n]) for n in want_snap if snap[n] != want_snap[n]}
        raise AssertionError(f"{SHARDED_TRAIN}: the world of one differs: {got[:2]} vs {want[:2]}, launches {diff}")


def _held_to_reference(what, recs, ref, init):
    """A sharded run's steps against the one-process reference's, both with
    Adam's eps = 1 (an element moves by ~lr x its clipped gradient): the
    factors (sampled) within 5e-2 of the reference's largest move from
    their seeded start, the loss within 1e-2 and grad_norm within 2e-2
    relative, the gradients' cosine >= 0.999 (bf16 activations; statistics
    and sums in another order)."""
    import torch

    for i, ((loss, gnorm), (flat, grad)) in enumerate(zip(recs["metrics"], recs["arrays"])):
        r = ref[i]
        flat, grad = torch.as_tensor(flat), torch.as_tensor(grad)
        d_flat, moved = float((flat - r[2]).abs().max()), float((r[2] - init).abs().max())
        cos = float(torch.nn.functional.cosine_similarity(grad.double(), r[3].double(), dim=0))
        ok = (0 < moved and d_flat <= 5e-2 * moved and abs(loss - r[0]) <= 1e-2 * abs(r[0])
              and abs(gnorm - r[1]) <= 2e-2 * r[1] and cos >= 0.999)
        log(f"{SHARDED_TRAIN} {what} step {i + 1}: loss {loss:.6f} (one process {r[0]:.6f}), grad_norm {gnorm:.6f} "
            f"({r[1]:.6f}), factors max|d| {d_flat:.3e} (<= 5e-2 x one process's largest move {moved:.3e}), the "
            f"gradient's cosine to one process's {cos:.6f} (>= 0.999) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{SHARDED_TRAIN} {what} step {i + 1} differs from one process")


def phase_sharded_training():
    """v1 LoRA and v2 full-model training over the (data, seq) mesh at full
    width on two ranks that share the one card (gloo), against one process."""
    import collections
    import queue as queue_mod
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from t2v_turbo_tpu_torch.apps import train_v1, train_v2

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded_train_", dir=os.path.join(HERE, "build"))
    try:
        # (a) one process: two v1 steps at the global batch, the NCCL world of one, the reward reference
        refs, ref_init, ref_peak, ref_s = {}, {}, {}, {}
        for (data, _), batch, extra, steps, key in V1_SHARD_RUNS:  # at each run's global batch
            batch *= data
            argv = _v1_train_argv(batch, os.path.join(work, f"one {key}"), extra)
            trainer, it, _ = train_v1.build_trainer(train_v1.parse_args(argv))
            ref_init[key] = _state_sample(_eps_one(trainer))
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            first, walls = _train_steps(trainer, it, 1)
            snap = launch_snapshot()
            more, walls2 = _train_steps(trainer, it, steps - 1)
            refs[key], ref_peak[key], ref_s[key] = first + more, torch.cuda.max_memory_allocated() / 2**30, walls + walls2
            log(f"{SHARDED_TRAIN}: one process, {key} at batch {batch}: loss {[round(r[0], 6) for r in refs[key]]}, "
                f"grad_norm {[round(r[1], 6) for r in refs[key]]}, s/step {[round(w, 3) for w in ref_s[key]]}, "
                f"max_memory_allocated {ref_peak[key]:.2f} GiB")
            del trainer, it
            _free()
            if key == "v1 B1":
                _nccl_world_of_one_step(argv, refs[key], snap)
        # one process: two v2 steps at the global batch of 2 (the peak memory the fsdp ranks are held against)
        latent_glob = _write_v2_latents(os.path.join(work, "latents"))
        torch.cuda.reset_peak_memory_stats()
        trainer, it, _ = train_v2.build_trainer(train_v2.parse_args(_v2_train_argv(latent_glob, 2, os.path.join(
            work, "one v2"))))
        v2_build_peak = torch.cuda.max_memory_allocated() / 2**30
        v2_ref, v2_s = _train_steps(trainer, it, 2)
        ref_peak["v2"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{SHARDED_TRAIN}: one process, v2 at batch 2 (remat, EMA, adamw8bit): loss "
            f"{[round(r[0], 6) for r in v2_ref]}, grad_norm {[round(r[1], 6) for r in v2_ref]}, s/step "
            f"{[round(w, 3) for w in v2_s]}, max_memory_allocated {ref_peak['v2']:.2f} GiB (after the build "
            f"{v2_build_peak:.2f})")
        del trainer, it
        _free()

        # (b) the two ranks
        log(f"{SHARDED_TRAIN}: spawning 2 ranks on cuda:0 over gloo with share_device=True")
        ctx = mp.get_context("spawn")
        queue = ctx.Queue()
        port = _free_port()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_sharded_train_rank, args=(r, 2, port, work, queue)) for r in range(2)]
        for p in procs:
            p.start()
        results, deadline = {}, time.time() + 720
        try:
            while len(results) < 2:
                try:
                    rank, ok, res = queue.get(timeout=5)
                except queue_mod.Empty:  # check that the ranks still live
                    if time.time() > deadline or any(p.exitcode not in (None, 0) for p in procs):
                        raise AssertionError(f"{SHARDED_TRAIN}: ranks ended without a result (exit codes "
                                             f"{[p.exitcode for p in procs]})")
                    continue
                if not ok:
                    raise AssertionError(f"{SHARDED_TRAIN}: rank {rank} failed:\n{res}")
                results[rank] = res
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=30)
        log(f"{SHARDED_TRAIN}: both ranks done in {time.perf_counter() - t0:.1f} s, exit codes "
            f"{[p.exitcode for p in procs]}")

        # (c) v1: the steps against one process; launches against the dry run; times, memory, collectives
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
        dry = sharded_training_shapes()
        for (data, seq), batch, extra, _, ref_key in V1_SHARD_RUNS:
            key = f"{data}x{seq}" + (" reward" if extra else "")
            ref = refs[ref_key]
            r0, r1 = results[0][key], results[1][key]
            if r0["metrics"] != r1["metrics"] or r0["flat_sum"] != r1["flat_sum"]:
                raise AssertionError(f"{SHARDED_TRAIN} {key}: the ranks' metrics or factors differ: {r0['metrics']} "
                                     f"{r1['metrics']}")
            _held_to_reference(f"({data}, {seq}){' with HPSv2' if extra else ''}",
                               dict(r0, arrays=torch.load(os.path.join(work, f"v1 {key}.pt"))), ref, ref_init[ref_key])
            for r in (0, 1):
                res = results[r][key]
                snap = res["launches"]
                routes = {n: snap[n][1] for n in TRAIN_SHARD_CHECKED if snap[n][1]}
                wrong = {n: v for n, v in routes.items() if set(v) - {"wgmma", "bulk", "split", "warp", "cta",
                                                                      "cluster", "vector"}}
                bad = []
                if not extra:  # the reward towers' launches are not in the UNet's dry run
                    want = _training_want(dry[(data, seq, r)], 2)
                    bad = [n for n in TRAIN_SHARD_CHECKED
                           if collections.Counter(snap[n][2]) != want.get(n, collections.Counter())]
                need = ["flash_attention", "group_norm", "layer_norm", "fused_gn_silu_conv", "small_seq_attention"] \
                    + list(GRAD_FLASH) + (list(SEQ_KERNELS) if seq > 1 else [])
                missing = [n for n in need if snap[n][0] <= 0]
                coll = res["collectives"]
                log(f"{SHARDED_TRAIN} ({data}, {seq}){' HPSv2' if extra else ''} rank {r}: launches "
                    f"{({n: snap[n][0] for n in TRAIN_SHARD_CHECKED})}"
                    + ("" if extra else f"; by kernel and shape equal to the dry run's {'OK' if not bad else 'FAIL'}")
                    + f"; routes {routes}; s/step {[round(w, 3) for w in res['walls']]} (build {res['build_s']:.1f} s); "
                    f"max_memory_allocated {res['peak_gib']:.2f} GiB (one process at the global batch "
                    f"{ref_peak[ref_key]:.2f}); collectives "
                    f"{({n: c['calls'] for n, c in coll.items() if c['calls']})} calls, "
                    f"{sum(c['staged_bytes'] for c in coll.values()) / 2**20:.1f} MiB staged, "
                    f"{sum(c['seconds'] for c in coll.values()):.3f} s [{smi}]")
                if bad or wrong or missing:
                    raise AssertionError(f"{SHARDED_TRAIN} ({data}, {seq}) rank {r}: shapes differ for {bad}, routes "
                                         f"{wrong}, not launched {missing}")

        # (d) v2 --fsdp: the resume against the uninterrupted run; memory against one process
        for r in (0, 1):
            v2 = results[r]["v2"]
            (loss3, gnorm3), again = v2["metrics"][2], v2["again"]
            d_master, d_ema = again[1], again[2]
            # steps 1-2 against one process at the global batch (the v1 runs' tolerances)
            near = [abs(m[0] - x[0]) <= 1e-2 * abs(x[0]) and abs(m[1] - x[1]) <= 2e-2 * x[1]
                    for m, x in zip(v2["metrics"][:2], v2_ref)]
            ok = (all(near) and len(near) == 2 and v2["metrics"] == results[1 - r]["v2"]["metrics"]
                  and all(v2["restored_equal"]) and again[0][0] == loss3 and again[0][1] == gnorm3
                  and all(v2["again_equal"]) and v2["start"] == 2)
            local, whole = v2["local"], v2["whole"]
            coll = v2["collectives"]
            log(f"{SHARDED_TRAIN} v2 --fsdp (2, 1) rank {r}: this rank keeps {local[0]} of the master's {whole} "
                f"elements ({local[1]} of the EMA's), moments alike; steps 1-3 loss/grad_norm "
                f"{[tuple(round(v, 6) for v in m) for m in v2['metrics']]} (one process at batch 2, steps 1-2: "
                f"{[(round(x[0], 6), round(x[1], 6)) for x in v2_ref]}; loss within 1e-2, grad_norm within 2e-2 "
                f"relative: {near}); s/step {[round(w, 3) for w in v2['walls']]} "
                f"(build {v2['build_s']:.1f} s, the checkpoint gathered and written {v2['save_s']:.1f} s, read "
                f"{v2['resume_s']:.1f} s); the state resumed from the step-2 file equals the trainer's at the save "
                f"(master, EMA, working copy, int8 moments: {v2['restored_equal']}), the retaken step 3: loss "
                f"{again[0][0]:.6f} (uninterrupted {loss3:.6f}, equal bits {again[0][0] == loss3}), grad_norm "
                f"{again[0][1]:.6f} ({gnorm3:.6f}), master max|d| {d_master:.3e}, EMA {d_ema:.3e} (torch.equal: "
                f"{v2['again_equal']}) {'OK' if ok else 'FAIL'}; max_memory_allocated "
                f"{v2['peak_gib']:.2f} GiB (after the build {v2['build_peak_gib']:.2f}) against one process's "
                f"{ref_peak['v2']:.2f} at batch 2; collectives {({n: c['calls'] for n, c in coll.items() if c['calls']})} "
                f"calls, {sum(c['staged_bytes'] for c in coll.values()) / 2**30:.2f} GiB staged, "
                f"{sum(c['seconds'] for c in coll.values()):.3f} s [{smi}]")
            if not ok:
                raise AssertionError(f"{SHARDED_TRAIN} v2 --fsdp rank {r}: a step differs from one process's or "
                                     "the resumed step from the uninterrupted one")
        log(f"{SHARDED_TRAIN}: two ranks sharing one card over gloo, every collective staged through host memory: "
            "s/step is not a scaling figure")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"{SHARDED_TRAIN}: phase wall {time.perf_counter() - t_phase:.1f} s")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = ()
    if argv[:1] == ["--phases"] and len(argv) == 2:
        only = tuple(argv[1].split(","))
    elif argv:
        print("usage: chip_smoke.py [--phases name,name,...]", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "t2v_turbo_tpu_torch")):
        print("chip_smoke: t2v_turbo_tpu_torch is not beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    open(os.path.join(OUT_DIR, "chip_smoke.log"), "w").close()
    records = {}
    step_times = {}  # phase 6's s/step, logged beside phase 8's
    v2 = {}  # phase 11's pickles, for phase 12
    phases = [
        ("device", phase_device),
        ("build", phase_build),
        ("kernels", lambda: phase_kernels(records)),
        ("main path", lambda: phase_main_path(records)),
        ("reference", lambda: phase_reference(records)),
        ("training", lambda: phase_training(records, step_times)),
        ("training with rewards", lambda: phase_training_rewards(records)),
        (BLIP_IV2, phase_training_blip_iv2),
        ("training on real data", lambda: phase_training_real_data(step_times)),
        ("training reference", phase_training_reference),
        (V2_GEN, phase_v2_generation),
        (V2_PRE, lambda: v2.update(latent_glob=phase_v2_preprocess())),
        (V2_TRAIN, lambda: phase_v2_training(v2["latent_glob"])),
        (MOTION, phase_motion_clone),
        (INVERSE, phase_inverse_ddim),
        (MS, phase_ms),
        (V2_TEXT, lambda: phase_v2_text_encoder(v2["latent_glob"])),
        (SERVE, phase_serving),
        (IMG, lambda: phase_image_conditioning(records)),
        (SWITCHES, lambda: phase_unet_switches(records)),
        (XT, phase_x_transformer),
        (SHARDED, lambda: phase_sharded(records)),
        (SHARDED_TRAIN, phase_sharded_training),
    ]
    if only:  # a development run of some phases (no argument: all of them)
        phases = [(n, f) for n, f in phases if n in ("device", "build") + only]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
            if name in ("device", "build"):
                break
        log(f"phase {name}: {'FAIL' if name in failed else 'OK'} in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    phase_device()  # the card's name and power limit again, beside the record
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "graph_ms": r["graph_ms"]}
        for n, r in records.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
