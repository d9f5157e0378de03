"""Time the fused GroupNorm+SiLU+conv (B7) on the card, shape by shape.

Usage (from a checkout, on a CUDA card):
  python3 t2v_turbo_tpu_torch/apps/time_fused_conv.py [--vae] [--root DIR] [--label NAME]

Times `fused_gn_silu_conv` (its statistics launches, weight permute and
kernel, as chip_smoke.py times it) at every distinct shape of a VC2 UNet
step (`UNET_STEP_SHAPES`), or with --vae at the VC2 VAE decoder's
GroupNorm -> SiLU -> conv shapes beside the unfused B4 + cuDNN pair. --root
imports `t2v_turbo_tpu_torch` from another checkout (e.g. an older commit
unpacked with `git archive`), so two trees can be timed in turns in one run
on one card. Prints the card's name and power limit, then one line per
shape: ms (CUDA events over 10 calls after 2 warm-ups).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# Every distinct fused-conv shape (N, C, H, W, O, kh, kw) of a VC2 UNet step
# at 16x320x512 (channel mult 1, 2, 4, 4; 2 ResBlocks a level): the 15
# spatial 3x3 convs on the 16 frames and the 4 temporal (3,1) convs on the
# clip viewed as (1, C, 16, H*W).
UNET_STEP_SHAPES = [(16, c, h, w, o, 3, 3) for c, h, w, o in (
    (320, 40, 64, 320), (960, 40, 64, 320), (640, 40, 64, 320), (320, 40, 64, 4),
    (320, 20, 32, 640), (640, 20, 32, 640), (1920, 20, 32, 640), (1280, 20, 32, 640), (960, 20, 32, 640),
    (640, 10, 16, 1280), (1280, 10, 16, 1280), (2560, 10, 16, 1280), (1920, 10, 16, 1280),
    (1280, 5, 8, 1280), (2560, 5, 8, 1280))] + [(1, c, 16, hw, o, 3, 1) for c, hw, o in (
    (320, 2560, 320), (640, 640, 640), (1280, 160, 1280), (1280, 40, 1280))]

# The VC2 VAE decoder's GroupNorm -> SiLU -> 3x3 conv shapes on 16 frames
# (channels 512, 512, 256, 128 at 40x64 .. 320x512), GroupNorm eps 1e-6.
VAE_SHAPES = [(16, 512, 40, 64, 512, 3, 3), (16, 512, 80, 128, 512, 3, 3), (16, 512, 160, 256, 512, 3, 3),
              (16, 512, 160, 256, 256, 3, 3), (16, 256, 160, 256, 256, 3, 3), (16, 256, 320, 512, 128, 3, 3),
              (16, 128, 320, 512, 128, 3, 3)]


def _time_ms(fn, iters=10):
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vae", action="store_true", help="the VAE decoder's shapes, beside B4 + cuDNN")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout to import t2v_turbo_tpu_torch from")
    ap.add_argument("--label", default="", help="prefix of every printed line")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from t2v_turbo_tpu_torch.ops import fused_conv as FC
    from t2v_turbo_tpu_torch.ops import norms as N

    if not torch.cuda.is_available():
        print("time_fused_conv: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    eps = 1e-6 if args.vae else 1e-5
    for n, c, h, w, o, kh, kw in VAE_SHAPES if args.vae else UNET_STEP_SHAPES:
        g = torch.Generator("cuda").manual_seed(c + o + kw)
        x = (2.0 * torch.randn((n, c, h, w), generator=g, device="cuda") + 0.5).bfloat16()
        gs = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
        gb = 0.1 * torch.randn(c, generator=g, device="cuda")
        wt = (torch.randn((o, c, kh, kw), generator=g, device="cuda") / (c * kh * kw) ** 0.5).bfloat16()
        b = (0.1 * torch.randn(o, generator=g, device="cuda")).bfloat16()
        line = f"{args.label}({n},{c},{h},{w})->{o} ({kh},{kw}): B7 "
        line += f"{_time_ms(lambda: FC.fused_gn_silu_conv(x, gs, gb, wt, b, 32, eps)):.4f} ms"
        if args.vae:
            pair = lambda: F.conv2d(N.fused_group_norm(x, gs, gb, 32, eps, "silu"), wt, b,  # noqa: E731
                                    padding=(kh // 2, kw // 2))
            line += f", B4 + cuDNN {_time_ms(pair):.4f} ms"
        print(line, flush=True)
        del x, wt
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
