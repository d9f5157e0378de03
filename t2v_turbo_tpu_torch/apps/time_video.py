"""Time whole videos of the VC2 pipeline on the card: s/video and its device time.

Usage (from a checkout, on a CUDA card):
  for r in build/parent . . build/parent; do
      python3 t2v_turbo_tpu_torch/apps/time_video.py --root $r --label "[$r] "; done

Builds apps/generate.py's pipeline (seeded random weights, bf16, 16x320x512,
4 steps) from the `t2v_turbo_tpu_torch` of --root (another checkout, e.g. an
older commit unpacked with `git archive`, so two trees are timed in turns in
one run on one card), renders one warm-up video, then --videos timed videos
(wall time a pipeline call, synchronised) and one more under torch.profiler:
its device-kernel ms and the idle share 1 - device / wall of that call.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout whose t2v_turbo_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--videos", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from t2v_turbo_tpu_torch.apps import generate

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    pipe = generate.build_pipeline(generate.parse_args(["--prompt", "x", "--random-weights", "--seed", "0",
                                                        "--device", "cuda:0"]))

    def video(seed):
        pipe(prompt="A panda playing guitar", generator=torch.Generator(device="cuda").manual_seed(seed))
        torch.cuda.synchronize()

    video(0)
    secs = []
    for i in range(args.videos):
        t0 = time.perf_counter()
        video(1 + i)
        secs.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        video(100)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"{args.label}s/video {' '.join(f'{s:.4f}' for s in secs)} (median {statistics.median(secs):.4f}); "
          f"profiled video: device {device_ms:.1f} ms, wall {wall_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
