"""Time the trainer's input path on the card: `LCDTrainer.run` (batches
pulled and moved to the device by the prefetcher's worker thread) against
another commit's `run`, in turns, on one full-width trainer and the same
batches.

Usage (from a checkout, on a CUDA card):
  git show <commit>:t2v_turbo_tpu_torch/training/trainer.py > build/baseline_trainer.py
  python3 -m t2v_turbo_tpu_torch.apps.time_prefetch --baseline-trainer build/baseline_trainer.py [--steps 5]

Builds one v1 trainer (apps/train_v1.py: seeded random weights, no
rewards, batch 1, 16 frames at 320x512) and the VC2 VAE, then takes
`--steps` steps through each `run` in the order baseline, this, this,
baseline: first on synthetic batches (`train_v1.synthetic_data`), then on
real ones: `decoded_clips` (seeded 16x360x640 uint8 clips, resized on the
short side and randomly cropped by the port's transforms, as a decoder's
output would be) through `train_v1.make_data_iter`'s full-width branch
(the VAE encode, the ViT-H text tower). `--baseline-trainer` is a
`training/trainer.py` of another commit; its `LCDTrainer.run` is called on
this trainer. Every run starts from the same LoRA factors, optimiser state
and draws, sees the same batches and writes no checkpoint, so the two
`run`s' losses must be equal. Per run it prints s/step (metrics.jsonl
`time_per_step_s`, steps 2 on), data_wait_frac and the host seconds a batch
spent in the raw iterator (resize and crop) and in the encode's calls, on
whichever thread pulled it. Then one profiled real-data run of each
(torch.profiler over the whole run): device kernel ms a step and the idle
share. Last, each part alone on an idle card: the resize and crop of a
batch on the host, and the encode and the text tower of a batch (CUDA
events). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import copy
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the decoded clips' source size (WebVid's 360p, 16:9) and their captions
SOURCE_HW = (360, 640)
CAPTIONS = ("a red kite over a windy beach", "traffic at night in the rain, seen from a bridge",
            "a cat jumping onto a kitchen table", "slow waves over rocks at dawn")


def decoded_clips(frames, size_hw, counter=None):
    """Endless raw batches {video (1, T, H, W, 3) f32 in [-1, 1], txt}: four
    seeded uint8 clips of frames x 360 x 640 (a colour ramp panning across
    the frame, a bright bar, noise), made first, then in turn resized on the
    short side and randomly cropped to `size_hw` with a seeded RandomState,
    as WebVideoDataset does after a decode. `counter["batches"]`, when
    given, counts what it yields."""
    from ..data.transforms import normalize_video, resize_crop

    h, w = SOURCE_HW
    yy, xx = np.mgrid[0:h, 0:w]
    clips = []
    for i in range(4):
        r = np.random.RandomState(100 + i)
        ramp = r.uniform(40, 215, 3) + 40 * np.stack([np.sin(yy / 37 + i), np.cos(xx / 53), np.sin((xx + yy) / 71)],
                                                     -1)
        clip = np.stack([np.roll(ramp, 12 * t, axis=1) for t in range(frames)])
        clip[:, :, 200 + 10 * i: 240 + 10 * i] = 250
        clips.append(np.clip(clip + r.randint(0, 12, clip.shape), 0, 255).astype(np.uint8))
    crop_rng = np.random.RandomState(1)
    i = 0
    while True:
        video = normalize_video(resize_crop(clips[i % 4], size_hw, random_crop=True, rng=crop_rng))
        if counter is not None:
            counter["batches"] += 1
        yield {"video": video[None], "txt": [CAPTIONS[i % len(CAPTIONS)]]}
        i += 1


def timed(it, seconds: list):
    """`it`, appending the seconds each of its items took to make to
    `seconds` (on the thread that pulls it; nothing is synchronised)."""
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        seconds.append(time.perf_counter() - t0)
        yield item


def load_run(path: str):
    """`LCDTrainer.run` of the trainer module at `path`, imported beside
    the port's own (its relative imports resolve in the port's package)."""
    spec = importlib.util.spec_from_file_location("t2v_turbo_tpu_torch.training.baseline_trainer", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module.LCDTrainer.run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline-trainer", required=True, help="another commit's training/trainer.py")
    ap.add_argument("--steps", type=int, default=5, help="steps a run (the first is not counted)")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--tiny-model", action="store_true", help="the tiny UNet and VAE, 4 frames at 16x16 (a CPU check)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="time_prefetch_") as out_dir:  # the runs' metrics.jsonl
        return measure(args, out_dir)


def measure(args, out_dir: str) -> int:
    import torch

    from ..models.vae import encode_video
    from . import train_v1

    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip())
    flags = ["--random-weights", "--synthetic-data", "--device", args.device, "--seed", "0", "--output-dir",
             out_dir, "--max-steps", str(args.steps)]
    if args.tiny_model:
        flags += ["--tiny-model", "--lora-rank", "4"]
    targs = train_v1.parse_args(flags)
    trainer, _, ucfg = train_v1.build_trainer(targs)
    trainer.save = lambda step: None  # no checkpoint: every run starts at step 0
    device = trainer.device
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    vae = train_v1.build_vae(targs, device, dtype)
    if args.tiny_model:  # the tiny VAE halves the frame: 16x16 -> 8x8 latents
        frames, size_hw, shape = 4, (16, 16), train_v1.DataShape(1, 4, (8, 8), 7, ucfg.context_dim)
    else:
        frames, size_hw = targs.n_frames, (targs.height, targs.width)
        shape = train_v1.DataShape(1, frames, (size_hw[0] // 8, size_hw[1] // 8), 77, ucfg.context_dim)
    flat0 = trainer.flat.detach().clone()
    optim0 = copy.deepcopy(trainer.optimizer.state_dict())
    runs = {"baseline": load_run(args.baseline_trainer), "this": type(trainer).run}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def one_run(which, source, profiler=None):
        """Steps of `runs[which]` from the starting state on fresh batches:
        (metrics rows, raw s a batch, encode s a batch, wall s)."""
        with torch.no_grad():
            trainer.flat.copy_(flat0)
        trainer.optimizer.load_state_dict(copy.deepcopy(optim0))
        trainer.step, trainer._acc, trainer._micro = 0, None, 0
        raw_s, data_s = [], []
        if source == "synthetic":
            data = train_v1.synthetic_data(shape, targs.fps)
        else:
            raw = timed(decoded_clips(frames, size_hw), raw_s)
            data = train_v1.make_data_iter(targs, shape, raw, vae)
        data = timed(data, data_s)
        n_rows = sum(1 for _ in open(trainer._metrics_path)) if os.path.exists(trainer._metrics_path) else 0
        sync()
        t0 = time.perf_counter()
        if profiler is None:
            runs[which](trainer, data, max_steps=args.steps)
        else:
            with profiler:
                runs[which](trainer, data, max_steps=args.steps)
                sync()
        sync()
        wall = time.perf_counter() - t0
        rows = [json.loads(line) for line in open(trainer._metrics_path)][n_rows:]
        enc_s = [d - r for d, r in zip(data_s, raw_s)] if raw_s else []
        return rows, raw_s, enc_s, wall

    def fmt(xs, digits=3):
        return " ".join(f"{x:.{digits}f}" for x in xs) + (f" (mean {np.mean(xs):.{digits}f})" if xs else "")

    losses = {}
    for source in ("synthetic", "real"):
        for which in ("baseline", "this", "this", "baseline"):
            rows, raw_s, enc_s, wall = one_run(which, source)
            losses.setdefault((source, which), [r["loss"] for r in rows])
            line = (f"{source} {which:8s}: s/step (steps 2-{args.steps}) {fmt([r['time_per_step_s'] for r in rows[1:]])}; "
                    f"data_wait_frac {fmt([r['data_wait_frac'] for r in rows[1:]], 4)}; wall {wall:.2f} s")
            if raw_s:
                line += (f"; {len(raw_s)} batches made: host s a batch in resize and crop {fmt(raw_s)}, "
                         f"in the encode's calls {fmt(enc_s)}")
            print(line, flush=True)
        same = losses[(source, "baseline")] == losses[(source, "this")]
        print(f"{source}: the two runs' losses {'equal' if same else 'DIFFER'}: {losses[(source, 'this')]}", flush=True)
        if not same:
            return 1

    if on_card:
        from torch.profiler import ProfilerActivity, profile

        for which in ("baseline", "this"):
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            rows, raw_s, enc_s, wall = one_run(which, "real", prof)
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
            print(f"real {which:8s} profiled ({args.steps} steps, {len(raw_s)} batches made; the profiler's own "
                  f"host cost included): wall {wall:.2f} s, device kernels {busy:.1f} ms ({busy / args.steps:.1f} "
                  f"ms a step), idle share {max(0.0, 1 - busy / 1e3 / wall):.3f}", flush=True)

    # each part alone
    raw_s = []
    clips = timed(decoded_clips(frames, size_hw), raw_s)
    batch = [next(clips) for _ in range(4)][-1]
    video = torch.as_tensor(batch["video"]).to(device)
    embed = train_v1.text_embedder(train_v1.build_text_tower(targs, device, dtype)) if not args.tiny_model else None

    def ms(fn, iters=3):
        for _ in range(2):
            fn()
        if not on_card:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return 1e3 * (time.perf_counter() - t0) / iters
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    with torch.no_grad():
        enc_ms = ms(lambda: encode_video(vae, video, scale_factor=0.18215))
        text_ms = ms(lambda: embed(batch["txt"])) if embed is not None else float("nan")
    print(f"alone: host resize and crop of a batch {fmt(raw_s[1:])} s (the clips are made at the first); "
          f"VAE encode {enc_ms:.1f} ms, text tower {text_ms:.1f} ms a batch", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
