"""Time the short-sequence attention kernel (B8) on the card, shape by shape.

Usage (from a checkout, on a CUDA card):
  python3 t2v_turbo_tpu_torch/apps/time_small_seq.py [--root DIR] [--label NAME] [--variants] [--video]

Times `small_seq_attention` at every shape the paths launch it at (`SHAPES`:
the temporal attention of the UNet's levels and of init_attn, the middle
block's temporal and spatial self-attention, with their launches a UNet
step), in bf16, and at L0 in f32, beside the fastest fused SDPA backend on
contiguous (B, H, S, D) copies of the inputs (the copies not timed; a
yardstick the port never calls) and the card's bound (q, k, v read once, o
written once, at 3.35 TB/s; the flops are far below the card's rate). Two
times a call: device ms by CUDA-graph replay over enough input copies that
the bytes come from device memory (`time_norms.graph_ms`), and the
back-to-back call time (host included, as chip_smoke.py's `ms`). --root
imports `t2v_turbo_tpu_torch` from another checkout (e.g. an older commit
unpacked with `git archive`), so two trees can be timed in turns in one
run on one card. --variants also times the kernel's other launches at
each shape (`ss_variants`: every other head group a block holds, and the
element-wise route on the same aligned views), one line each, each
checked first for the plan's output bits. --video
instead profiles one full-width video (apps/generate.py's pipeline, seeded
random weights, after two warm-up videos) and prints B8's device ms a video
(its kernels by name) beside all kernels'. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (R, T, H) of the paths' short-sequence calls (head dim 64), a label, and
# the launches a UNet step: the temporal self-attention (attn1 and attn2 of
# each temporal transformer) at levels 0-2 (5, 10, 20 heads over 16 frames
# at 40x64, 20x32, 10x16 pixels), init_attn's 8 heads, the middle block's
# temporal attention at 5x8 pixels and its spatial self-attention over its
# 40 tokens. 35 a step.
SHAPES = [((2560, 16, 5), "L0 temporal", 10), ((640, 16, 10), "L1 temporal", 10),
          ((160, 16, 20), "L2 temporal", 10), ((2560, 16, 8), "init_attn temporal", 2),
          ((40, 16, 20), "mid temporal", 2), ((16, 40, 20), "mid self", 1)]
F32_SHAPES = [((2560, 16, 5), "L0 temporal, f32", 0)]
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate


def ss_variants(A, shape, dtype):
    """(name, plan) of the kernel's launches at `shape` other than the
    plan's: every other head group (a divisor of H) within a block's
    threads, then the plan's head group on the element-wise route."""
    r, t, h = shape
    plan = A.ss_plan(r, t, h, dtype)
    out = []
    for heads in (d for d in range(h, 0, -1) if h % d == 0 and d != plan.heads):
        try:
            out.append((f"heads={heads}", A.ss_layout(r, t, h, dtype, "bulk", heads)))
        except ValueError:  # more units than a block has warps
            continue
    return out + [("element-wise route", plan._replace(route="elementwise"))]


def check_variant(got, want, what):
    """Raise unless a variant's output has the plan's bits: each (head,
    16-query tile) unit does the same arithmetic in every launch of the
    kernel (chip_smoke.py holds the plan's output against plain)."""
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{what}: max |variant - plan| {float((got.float() - want.float()).abs().max()):.3e}")


def profile_video(label):
    """B8's device ms in one profiled video: the kernels whose names hold
    `small_seq` (this tree's and older trees' alike)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from t2v_turbo_tpu_torch.apps.generate import build_pipeline, parse_args

    prompt = "An astronaut riding a horse on the moon"
    pipe = build_pipeline(parse_args(["--prompt", prompt, "--random-weights", "--seed", "0", "--device", "cuda:0"]))
    for seed in (0, 1):
        pipe(prompt=prompt, generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(prompt=prompt, generator=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device = sum(e.self_device_time_total for e in events)
    b8 = [e for e in events if "small_seq" in e.key]
    print(f"{label}a video: device kernels {device / 1e3:.1f} ms; B8 {sum(e.self_device_time_total for e in b8) / 1e3:.3f}"
          f" ms over {sum(e.count for e in b8)} launches", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout to import t2v_turbo_tpu_torch from")
    ap.add_argument("--label", default="", help="prefix of every printed line")
    ap.add_argument("--variants", action="store_true", help="also time the kernel's other launches")
    ap.add_argument("--video", action="store_true", help="B8's device ms in one profiled video instead")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from t2v_turbo_tpu_torch.apps.time_norms import call_ms, graph_ms, rotation
    from t2v_turbo_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("time_small_seq: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.video:
        profile_video(args.label)
        return 0
    g = torch.Generator("cuda").manual_seed(0)

    def library_ms(q, k, v, nbytes):
        """{backend: graph ms} of every fused SDPA backend that takes
        contiguous (B, H, S, D) copies of q, k, v."""
        out = {}
        qkv = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION):
            def sdpa(q, k, v, backend=backend):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(q, k, v)
            try:
                sdpa(*qkv)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            out[backend.name] = graph_ms(rotation(sdpa, qkv, nbytes))
        return out

    cases = [(*c, torch.bfloat16) for c in SHAPES] + [(*c, torch.float32) for c in F32_SHAPES]
    for (r, t, h), name, per_step, dtype in cases:
        q, k, v = (torch.randn((r, t, h, 64), generator=g, device="cuda").to(dtype) for _ in range(3))
        nbytes = 4 * q.numel() * q.element_size()
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        ms = graph_ms(rotation(A.small_seq_attention, [q, k, v], nbytes))
        lib = library_ms(q, k, v, nbytes)
        best = min(lib.values(), default=None)
        print(f"{args.label}B8 {name} {(r, t, h)} {str(dtype).replace('torch.', '')}: kernel {ms:.4f} ms "
              f"({bound / ms:.0%} of the bound), call {call_ms(lambda: A.small_seq_attention(q, k, v)):.4f} ms; "
              f"library " + ", ".join(f"{n} {x:.4f}" for n, x in lib.items())
              + (f" (kernel/fastest {ms / best:.2f})" if best else "")
              + f"; bound {bound:.4f} ms; {per_step} launches a UNet step", flush=True)
        if args.variants:
            for vname, plan in ss_variants(A, (r, t, h), dtype):
                fn = lambda q, k, v, p=plan: A._ss_launch(q, k, v, None, p)  # noqa: E731
                check_variant(fn(q, k, v), A.small_seq_attention(q, k, v), f"{vname} {plan}")
                vms = graph_ms(rotation(fn, [q, k, v], nbytes))
                print(f"{args.label}  {vname} {plan}: {vms:.4f} ms ({bound / vms:.0%} of the bound); "
                      "equal bits to the plan's", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
