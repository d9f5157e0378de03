"""Time the flash-attention forward (B1, and B2 with its lse) and the
head-dim-512 backward (B3) on the card, shape by shape.

Usage (from a checkout, on a CUDA card):
  python3 t2v_turbo_tpu_torch/apps/time_flash.py [--root DIR] [--label NAME] [--only fwd|bwd]

Times `flash_attention_cuda` (B1) and `flash_attention_lse` (B2), each on
bf16 (B, S, H, D) tensors, at every distinct head-dim-64 forward shape of
the serving, training and reward paths (`FWD_SHAPES`) and at the VAE mid
block's head of 512 (`D512_SHAPES`); then `flash_attention_bwd_dkv` and
`flash_attention_bwd_dq` (B3) at the two reward shapes of `D512_SHAPES`,
beside memory-efficient SDPA's whole backward (dq, dk and dv from one kept
forward, on contiguous (B, H, S, D) copies; call time only: a yardstick the
port never calls). --only times one of the two. --root imports
`t2v_turbo_tpu_torch` from another checkout (e.g. an older commit unpacked
with `git archive`), so two trees can be timed in turns in one run on one
card. Prints the card's name and power limit, then one line per shape and kernel: "call",
CUDA events over `iters` back-to-back calls after 2 warm-ups (as
chip_smoke.py times a kernel; at small shapes the host's time to issue a
call decides it), and "graph", the same calls captured in one CUDA graph
and replayed (the device's time); each the best of five runs, since the
host's time per call varies by tens of microseconds from run to run.
Then the route B1 (or B3) took.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# Every distinct bf16 head-dim-64 flash forward shape (B, H, Sq, Sk) of the
# paths at 16x320x512, with its launches: B1 a UNet pass (serving runs 4
# passes a video; a training step runs 3 without a gradient: the teacher
# twice and the target), B2 a training step (the student's one pass with a
# gradient) and B2 a step of the reward path on top (ViCLIP-L's 24 layers).
# Spatial self-attention of 5 transformers a level (levels 0-2: 2560, 640,
# 160 tokens; heads of 64 over 320, 640, 1280 channels), cross-attention
# to the 77 text tokens, the middle block at 40 tokens; the temporal
# attention over 16 frames (attn1 and attn2 of each temporal transformer,
# init_attn's 8 heads); without a gradient the temporal attention and the
# middle block's self-attention take the short-sequence kernel (B8).
FWD_SHAPES = [  # (B, H, Sq, Sk), label, B1 a UNet pass, B2 a training step, B2 a reward step
    ((16, 5, 2560, 2560), "L0 self", 5, 5, 0),
    ((16, 10, 640, 640), "L1 self", 5, 5, 0),
    ((16, 20, 160, 160), "L2 self", 5, 5, 0),
    ((16, 20, 40, 40), "mid self", 0, 1, 0),
    ((16, 5, 2560, 77), "L0 cross", 5, 5, 0),
    ((16, 10, 640, 77), "L1 cross", 5, 5, 0),
    ((16, 20, 160, 77), "L2 cross", 5, 5, 0),
    ((16, 20, 40, 77), "mid cross", 1, 1, 0),
    ((2560, 5, 16, 16), "L0 temporal", 0, 10, 0),
    ((2560, 8, 16, 16), "init_attn temporal", 0, 2, 0),
    ((640, 10, 16, 16), "L1 temporal", 0, 10, 0),
    ((160, 20, 16, 16), "L2 temporal", 0, 10, 0),
    ((40, 20, 16, 16), "mid temporal", 0, 2, 0),
    ((1, 16, 2049, 2049), "ViCLIP self", 0, 0, 24),
]
# The VAE mid block's one head of 512 (B, H, Sq, Sk), with its launches: B1
# once a video (the decode of 16 frames), B2 once in each of a rewards-ON
# training step's two decodes with gradient (8 frames for the video reward,
# 5 for the image reward).
D512_SHAPES = [
    ((16, 1, 2560, 2560), "VAE mid", "B1 1 a video"),
    ((8, 1, 2560, 2560), "VAE mid, video reward", "B2 1 a reward step"),
    ((5, 1, 2560, 2560), "VAE mid, image reward", "B2 1 a reward step"),
]


def _best_ms(run, iters):
    """The best of five timings of run() (CUDA events), per call."""
    import torch

    best = float("inf")
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def _time_ms(fn, iters):
    """(call ms, graph ms) of fn; see the module's docstring."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-ups, off the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    call = _best_ms(lambda: [fn() for _ in range(iters)], iters)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    return call, _best_ms(graph.replay, iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout to import t2v_turbo_tpu_torch from")
    ap.add_argument("--label", default="", help="prefix of every printed line")
    ap.add_argument("--only", choices=("fwd", "bwd"), help="time the forwards or the backward alone")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from t2v_turbo_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    shapes = [(shape, name, 64) for shape, name, *_ in FWD_SHAPES] + [(shape, name, 512) for shape, name, _ in D512_SHAPES]
    for (b, h, sq, sk), name, d in shapes if args.only != "bwd" else []:
        g = torch.Generator("cuda").manual_seed(sq + sk)
        q, k, v = (torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16() for s in (sq, sk, sk))
        iters = 10 if sq * sk >= 2**22 else 30
        by_route = getattr(A.flash_attention, "by_route", None)  # an older tree may not count routes
        before = by_route.copy() if by_route is not None else None
        t1 = _time_ms(lambda: A.flash_attention_cuda(q, k, v), iters)
        t2 = _time_ms(lambda: A.flash_attention_lse(q, k, v), iters)
        routes = sorted(by_route - before) if by_route is not None else "not counted"
        print(f"{args.label}{name} ({b},{h},{sq},{sk},{d}): B1 call {t1[0]:.4f} graph {t1[1]:.4f} ms, "
              f"B2 call {t2[0]:.4f} graph {t2[1]:.4f} ms, B1 route {routes}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    for (b, h, sq, sk), name, launches in D512_SHAPES if args.only != "fwd" else []:
        if "B2" in launches:  # the decodes with gradient, whose backward runs B3
            _time_bwd(A, args.label, name, (b, h, sq, sk, 512))
    return 0


def _time_bwd(A, label, name, shape):
    """One line: B3's dK/dV and dQ (call and graph ms, on the lse and delta
    of the plain forward) and memory-efficient SDPA's whole backward."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, h, sq, sk, d = shape
    g = torch.Generator("cuda").manual_seed(sq + sk)
    q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16() for s in (sq, sk, sk, sq))
    scale = d**-0.5
    o, lse = A.attention_lse_plain(q, k, v, scale)
    delta = A.attention_bwd_delta(do, o)
    before = A.flash_attention_bwd_dkv.by_route.copy()
    dkv = _time_ms(lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale), 10)
    dq = _time_ms(lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), 10)
    routes = sorted(A.flash_attention_bwd_dkv.by_route - before)
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dout = do.transpose(1, 2).contiguous()
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        out = F.scaled_dot_product_attention(qq, kk, vv)
        grad = lambda: torch.autograd.grad(out, (qq, kk, vv), dout, retain_graph=True)  # noqa: E731
        for _ in range(2):
            grad()
        sdpa = _best_ms(lambda: [grad() for _ in range(5)], 5)
    print(f"{label}{name} backward ({b},{h},{sq},{sk},{d}): B3 dK/dV call {dkv[0]:.4f} graph {dkv[1]:.4f} ms, "
          f"dQ call {dq[0]:.4f} graph {dq[1]:.4f} ms, sum of graphs {dkv[1] + dq[1]:.4f} ms; "
          f"mem-eff SDPA whole backward call {sdpa:.4f} ms; B3 route {routes}", flush=True)
    del q, k, v, do, o, lse, delta, qq, kk, vv, dout, out
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
