"""Soak run of the v1 trainer on real shards under preemption (port of
t2v_turbo_tpu/apps/soak_v1.py): tar shards -> webdata loader -> native
decode -> VAE / text encode -> the LCD step, with a SIGTERM mid-run.

  1. writes tar shards of x264 mp4s made by the port's native encoder
     (data/videoio.py::encode), which the native decoder reads back: a
     codec round trip, not a numpy shortcut;
  2. phase A: runs `apps.train_v1` as a subprocess on the shards, waits
     for its first logged steps (metrics.jsonl rows, under a deadline of
     its own), sends SIGTERM, and requires a clean exit with the final
     checkpoint written;
  3. phase B: relaunches the same command and requires that the run
     resumes at that checkpoint's step + 1, not at step 1;
  4. writes summary.json: end-to-end s/step and samples/s, and
     `data_wait_frac` (the trainer's share of each window spent waiting
     for the prefetcher).

Usage (full shape on the card; needs libav to build the decoder):
  python -m t2v_turbo_tpu_torch.apps.soak_v1 --workdir runs/soak --phase-a-s 360 --phase-b-s 240
Tiny CPU shape (tests/test_torch_soak.py):
  python -m t2v_turbo_tpu_torch.apps.soak_v1 --workdir runs/soak --tiny --phase-a-s 0 --phase-b-s 0
"""

from __future__ import annotations

import argparse
import io
import json
import os
import re
import signal
import subprocess
import sys
import tarfile
import time

MIN_STEPS = 2  # logged steps each phase reaches before its SIGTERM
CLIP_FPS = 16.0
CLIP_FRAMES, TINY_CLIP_FRAMES = 64, 24  # frames of each shard's clips
# the tiny CPU shape; without --tiny, train_v1's own defaults govern the run
TINY_TRAIN_FLAGS = ["--tiny-model", "--device", "cpu", "--height", "16", "--width", "16", "--n-frames", "4",
                    "--optimizer", "adamw", "--lora-rank", "4"]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="T2V-Turbo v1 trainer + data soak (PyTorch port)")
    p.add_argument("--workdir", required=True)
    p.add_argument("--tiny", action="store_true", help="tiny model, 16x16 clips, on the CPU")
    p.add_argument("--n-shards", type=int, default=4)
    p.add_argument("--clips-per-shard", type=int, default=12)
    p.add_argument("--phase-a-s", type=float, default=360.0,
                   help="seconds (at least) before the mid-run SIGTERM")
    p.add_argument("--phase-b-s", type=float, default=240.0, help="seconds (at least) of the resumed run")
    p.add_argument("--deadline-s", type=float, default=3600.0,
                   help="a phase that has not logged MIN_STEPS steps by then fails")
    p.add_argument("--checkpointing-steps", type=int, default=50)
    return p.parse_args(argv)


def make_shards(shard_dir: str, n_shards: int, clips_per_shard: int, frames: int, h: int, w: int, seed: int = 0):
    """Tar shards of x264 mp4s at CLIP_FPS and captions. Each clip is a moving
    gradient, a drifting square and noise, so the encoder does real motion
    work (a black clip would compress to nothing and decode for free)."""
    import numpy as np

    from ..data import videoio

    os.makedirs(shard_dir, exist_ok=True)
    paths = []
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    clip_id = 0
    for s in range(n_shards):
        tar_path = os.path.join(shard_dir, f"soak-{s:04d}.tar")
        paths.append(tar_path)
        if os.path.exists(tar_path):
            clip_id += clips_per_shard
            continue
        with tarfile.open(tar_path, "w") as tf:
            for _ in range(clips_per_shard):
                phase, speed = rng.uniform(0, 2 * np.pi), rng.uniform(1.0, 4.0)
                vid = np.empty((frames, h, w, 3), np.uint8)
                for t in range(frames):
                    base = 127.5 * (1 + np.sin(0.02 * (xx + yy) + phase + speed * 0.2 * t))
                    fr = np.stack([base, np.roll(base, t, 1), np.roll(base, -t, 0)], -1)
                    cy = int((h - 40) * (0.5 + 0.4 * np.sin(0.3 * t + phase)))
                    cx = int((w - 40) * (0.5 + 0.4 * np.cos(0.2 * t)))
                    fr[max(cy, 0):cy + 32, max(cx, 0):cx + 32] = 255.0
                    fr += rng.randn(h, w, 3) * 6.0
                    vid[t] = np.clip(fr, 0, 255).astype(np.uint8)
                key = f"{clip_id:08d}"
                clip_id += 1
                mp4 = os.path.join(shard_dir, f"{key}.mp4")
                videoio.encode(mp4, vid, fps=CLIP_FPS)
                tf.add(mp4, arcname=f"{key}.mp4")
                os.remove(mp4)
                caption = f"synthetic soak clip {key}: moving gradient with a drifting square".encode()
                info = tarfile.TarInfo(f"{key}.txt")
                info.size = len(caption)
                tf.addfile(info, io.BytesIO(caption))
    return paths


def train_cmd(args, run_dir: str):
    cmd = [sys.executable, "-m", "t2v_turbo_tpu_torch.apps.train_v1", "--random-weights",
           "--data-shards", os.path.join(args.workdir, "shards", "*.tar"), "--output-dir", run_dir,
           "--max-steps", "1000000", "--checkpointing-steps", str(args.checkpointing_steps)]
    return cmd + TINY_TRAIN_FLAGS if args.tiny else cmd


def read_metrics(run_dir: str):
    """metrics.jsonl's rows, skipping a torn last line (the trainer appends
    while this polls)."""
    rows = []
    path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    return rows


def latest_checkpoint_step(run_dir: str):
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    steps = [int(m.group(1)) for m in (re.fullmatch(r"step_(\d+)\.pt", n) for n in
                                        (os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else [])) if m]
    return max(steps, default=None)


def run_phase(cmd, duration_s: float, log_path: str, run_dir: str, min_new_rows: int, deadline_s: float,
              env=None) -> None:
    """Run the trainer; once `duration_s` has passed and it has logged
    `min_new_rows` new steps (so start-up never eats the phase), send
    SIGTERM and require exit code 0. A trainer that dies first, or logs too
    few steps by `deadline_s`, fails the phase (and is killed and reaped)."""
    rows_before = len(read_metrics(run_dir))
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env)
        t0 = time.time()
        try:
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"trainer died before SIGTERM (rc={proc.returncode}); see {log_path}")
                elapsed, new_rows = time.time() - t0, len(read_metrics(run_dir)) - rows_before
                if elapsed >= duration_s and new_rows >= min_new_rows:
                    break
                if elapsed >= deadline_s:
                    raise RuntimeError(f"{new_rows} steps logged in {deadline_s:.0f} s; see {log_path}")
                time.sleep(0.2)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
    if rc != 0:
        raise RuntimeError(f"trainer exited rc={rc} after SIGTERM; see {log_path}")


def main(argv=None):
    from . import train_v1

    args = parse_args(argv)
    env = dict(os.environ)
    if args.tiny:
        env.setdefault("OMP_NUM_THREADS", "1")  # a tiny model gains nothing from more threads
    os.makedirs(args.workdir, exist_ok=True)
    run_dir = os.path.join(args.workdir, "run")
    cmd = train_cmd(args, run_dir)
    targs = train_v1.parse_args(cmd[3:])  # the trainer's clip shape: the shards are written at its size

    t0 = time.time()
    shards = make_shards(os.path.join(args.workdir, "shards"), args.n_shards, args.clips_per_shard,
                         TINY_CLIP_FRAMES if args.tiny else CLIP_FRAMES, targs.height, targs.width)
    print(f"# {len(shards)} shards ready in {time.time() - t0:.1f} s", file=sys.stderr)

    print("# phase A:", " ".join(cmd), file=sys.stderr)
    run_phase(cmd, args.phase_a_s, os.path.join(args.workdir, "phase_a.log"), run_dir, MIN_STEPS,
              args.deadline_s, env)
    rows_a, ckpt_a = read_metrics(run_dir), latest_checkpoint_step(run_dir)
    if not rows_a:
        raise RuntimeError("phase A logged no steps")
    if ckpt_a is None:
        raise RuntimeError("phase A left no checkpoint after SIGTERM")
    last_a = rows_a[-1]["step"]
    print(f"# phase A: reached step {last_a}, checkpoint at {ckpt_a}", file=sys.stderr)

    print("# phase B (resume)", file=sys.stderr)
    run_phase(cmd, args.phase_b_s, os.path.join(args.workdir, "phase_b.log"), run_dir, MIN_STEPS,
              args.deadline_s, env)
    rows_b = read_metrics(run_dir)
    new_rows = rows_b[len(rows_a):]
    resumed_from = new_rows[0]["step"] if new_rows else None
    if resumed_from != ckpt_a + 1:
        raise RuntimeError(f"phase B did not resume at the checkpoint + 1 (checkpoint {ckpt_a}, "
                           f"first new step {resumed_from})")

    # the steady state: each phase's first logged window folds start-up in
    steady = new_rows[1:] or new_rows
    import numpy as np

    tps = float(np.median([r["time_per_step_s"] for r in steady]))
    summary = {
        "steps_total": rows_b[-1]["step"],
        "ckpt_phase_a": ckpt_a,
        "resumed_at_step": resumed_from,
        "time_per_step_s": tps,
        "samples_per_sec_e2e": 1.0 / tps,
        "data_wait_frac": float(np.median([r.get("data_wait_frac", 0.0) for r in steady])),
        "shards": len(shards),
        "shape": f"{targs.n_frames}f_{targs.height}x{targs.width}",
    }
    with open(os.path.join(args.workdir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
