"""Time the flash-attention forward (B1, and B2 with its lse) and the
head-dim-512 backward (B3) on the card, shape by shape.

Usage (from a checkout, on a CUDA card):
  python3 t2v_turbo_tpu_torch/apps/time_flash.py [--root DIR] [--label NAME] [--only fwd|bwd] [--misaligned]

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

--misaligned times B6 instead, the same functions on (B, S, H, D) views that
TMA cannot read (each row one element past a 16-byte boundary, an odd row
stride: a (B, S, H * D + 1) buffer less its first element): at every shape
of FWD_SHAPES, B1 and B2 on those views (the `staged` route), then on
contiguous copies of the same values (the wgmma route fed by TMA), cuDNN's
SDPA on contiguous (B, H, S, D) copies, and cuDNN together with the three
copies a caller holding such views would make; each line with its bound
(operations over 989 TFLOP/s bf16, bytes over 3.35 TB/s: q, k, v read and o
written once). Then B6's backward (dK/dV, dQ; this tree's route: `packed`,
an older tree's `mma`) at (16,5,2560,2560,64) and (8,1,2560,2560,512) on
such views, beside B3 on contiguous copies (the wgmma route), an SDPA
backend's whole backward on copies (cuDNN at head dim 64, memory-efficient
at 512) and the same with the four copies (q, k, v, dO) a caller would
make; B6's forward at head dim 512 at (16,1,2560,2560,512) (`packed`, or
`mma`) beside B1 on copies and memory-efficient SDPA on copies, with and
without the copies; the pack kernel alone on one (16,2560,5,64) view
(`pack_bshd`) beside torch's copy (`contiguous()`), with its bytes bound;
and, measured only (no route takes it), the pack of q, k, v and the wgmma
forward at (16,5,2560,2560,64) beside the `staged` forward on the same
views. The pack lines need this tree (an older one has no pack kernel).
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
    ap.add_argument("--misaligned", action="store_true", help="time B6: the kernels on views TMA cannot read")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from t2v_turbo_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.misaligned:
        return _misaligned(A, args.label, args.only)
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


def _bound_ms(shape, products):
    """Least ms on an H100 for `products` products of 2 B H Sq Sk D
    operations (bf16, 989 TFLOP/s) or for reading q, k, v once and writing o
    once (3.35 TB/s), whichever is larger."""
    b, h, sq, sk, d = shape
    ops = products * 2 * b * h * sq * sk * d
    nbytes = 2 * b * h * d * (2 * sq + 2 * sk)
    return 1e3 * max(ops / 989e12, nbytes / 3.35e12)


def _views(shape, g, n=3):
    """q, k, v (and dO with n = 4): (B, S, H, D) bf16 views one element into
    (B, S, H * D + 1) buffers: rows off 16 bytes, an odd row stride."""
    import torch

    b, h, sq, sk, d = shape
    bufs = [torch.randn((b, s, h * d + 1), generator=g, device="cuda").bfloat16() for s in (sq, sk, sk, sq)[:n]]
    return [t[..., 1:].view(b, t.shape[1], h, d) for t in bufs]


def _misaligned(A, label, only):
    """B6's lines (the module's docstring, --misaligned)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def cudnn(fn):
        def run():
            with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
                return fn()
        return run

    for (b, h, sq, sk), name, *_ in FWD_SHAPES if only != "bwd" else []:
        shape = (b, h, sq, sk, 64)
        q, k, v = _views(shape, torch.Generator("cuda").manual_seed(sq + sk))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        iters = 10 if sq * sk >= 2**22 else 30
        before = A.flash_attention.by_route.copy()
        t1 = _time_ms(lambda: A.flash_attention_cuda(q, k, v), iters)
        t2 = _time_ms(lambda: A.flash_attention_lse(q, k, v), iters)
        routes = sorted(A.flash_attention.by_route - before)
        before = A.flash_attention.by_route.copy()
        c1 = _time_ms(lambda: A.flash_attention_cuda(qc, kc, vc), iters)
        c2 = _time_ms(lambda: A.flash_attention_lse(qc, kc, vc), iters)
        c_routes = sorted(A.flash_attention.by_route - before)
        try:
            lib = _time_ms(cudnn(lambda: F.scaled_dot_product_attention(qh, kh, vh)), iters)
            lib_copies = _time_ms(cudnn(lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2).contiguous() for t in (q, k, v)))), iters)
            lib_text = (f"cuDNN on copies call {lib[0]:.4f} graph {lib[1]:.4f} ms, with the copies call "
                        f"{lib_copies[0]:.4f} graph {lib_copies[1]:.4f} ms")
        except RuntimeError as e:  # cuDNN does not take every shape
            lib_text = f"cuDNN not measured ({str(e).splitlines()[0][:80]})"
        print(f"{label}B6 {name} misaligned ({b},{h},{sq},{sk},64): B1 call {t1[0]:.4f} graph {t1[1]:.4f} ms, "
              f"B2 call {t2[0]:.4f} graph {t2[1]:.4f} ms, route {routes}; contiguous copies: B1 call {c1[0]:.4f} "
              f"graph {c1[1]:.4f} ms, B2 call {c2[0]:.4f} graph {c2[1]:.4f} ms, route {c_routes}; {lib_text}; "
              f"bound {_bound_ms(shape, 2):.4f} ms", flush=True)
        del q, k, v, qc, kc, vc, qh, kh, vh
        torch.cuda.empty_cache()
    if only != "fwd":
        _time_bwd(A, label, "B6 L0 self misaligned", (16, 5, 2560, 2560, 64), misaligned=True,
                  backend=SDPBackend.CUDNN_ATTENTION)
        _time_bwd(A, label, "B6 VAE mid, video reward, misaligned", (8, 1, 2560, 2560, 512), misaligned=True)
    if only != "bwd":
        shape = (16, 1, 2560, 2560, 512)
        q, k, v = _views(shape, torch.Generator("cuda").manual_seed(512))
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        before = A.flash_attention.by_route.copy()
        t1 = _time_ms(lambda: A.flash_attention_cuda(q, k, v), 5)
        routes = sorted(A.flash_attention.by_route - before)
        c1 = _time_ms(lambda: A.flash_attention_cuda(qc, kc, vc), 5)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib = _time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 5)
            lib_copies = _time_ms(lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2).contiguous() for t in (q, k, v))), 5)
        print(f"{label}B6 VAE mid misaligned (16,1,2560,2560,512): B1 call {t1[0]:.4f} graph {t1[1]:.4f} ms, "
              f"route {routes}; contiguous copies: B1 call {c1[0]:.4f} graph {c1[1]:.4f} ms; mem-eff SDPA on "
              f"copies call {lib[0]:.4f} graph {lib[1]:.4f} ms, with the copies call {lib_copies[0]:.4f} graph "
              f"{lib_copies[1]:.4f} ms; bound {_bound_ms(shape, 2):.4f} ms", flush=True)
        del q, k, v, qc, kc, vc, qh, kh, vh
        torch.cuda.empty_cache()
    if hasattr(A, "pack_bshd") and only != "bwd":
        shape = (16, 5, 2560, 2560, 64)
        q, k, v = _views(shape, torch.Generator("cuda").manual_seed(64))
        pack = _time_ms(lambda: A.pack_bshd(q), 50)
        copy = _time_ms(lambda: q.contiguous(), 50)
        bound = 1e3 * 4 * q.numel() / 3.35e12  # read once, written once
        print(f"{label}B6 pack alone, one misaligned L0 view (16,2560,5,64): pack_bshd call {pack[0]:.4f} graph "
              f"{pack[1]:.4f} ms ({bound / pack[1]:.0%} of the bound); torch contiguous() call {copy[0]:.4f} "
              f"graph {copy[1]:.4f} ms; bound {bound:.4f} ms (bytes)", flush=True)
        staged = _time_ms(lambda: A.flash_attention_cuda(q, k, v), 10)
        packed = _time_ms(lambda: A.flash_attention_cuda(*(A.pack_bshd(t) for t in (q, k, v))), 10)
        print(f"{label}B6 L0 self misaligned (16,5,2560,2560,64), measured only: pack of q, k, v + the wgmma "
              f"forward call {packed[0]:.4f} graph {packed[1]:.4f} ms; staged call {staged[0]:.4f} graph "
              f"{staged[1]:.4f} ms; bound {_bound_ms(shape, 2):.4f} ms", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return 0


def _time_bwd(A, label, name, shape, misaligned=False, backend=None):
    """One line: B3's dK/dV and dQ (call and graph ms, on the lse and delta
    of the plain forward) and an SDPA backend's whole backward on contiguous
    copies (memory-efficient unless `backend`). If `misaligned`, on views
    TMA cannot read, and beside them B3 on contiguous copies of the same
    values and the SDPA backward with the four copies a caller would make
    (q, k, v and dO; the backward of a kept forward on copies)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backend = backend or SDPBackend.EFFICIENT_ATTENTION
    b, h, sq, sk, d = shape
    g = torch.Generator("cuda").manual_seed(sq + sk)
    if misaligned:
        q, k, v, do = _views(shape, g, 4)
    else:
        q, k, v, do = (torch.randn((b, s, h, d), generator=g, device="cuda").bfloat16() for s in (sq, sk, sk, sq))
    scale = d**-0.5
    o, lse = A.attention_lse_plain(q, k, v, scale)
    delta = A.attention_bwd_delta(do, o)
    before = A.flash_attention_bwd_dkv.by_route.copy()
    dkv = _time_ms(lambda: A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale), 10)
    dq = _time_ms(lambda: A.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale), 10)
    routes = sorted(A.flash_attention_bwd_dkv.by_route - before)
    copies = ""
    if misaligned:
        qc, kc, vc, gc = (t.contiguous() for t in (q, k, v, do))
        cdkv = _time_ms(lambda: A.flash_attention_bwd_dkv(qc, kc, vc, gc, lse, delta, scale), 10)
        cdq = _time_ms(lambda: A.flash_attention_bwd_dq(qc, kc, vc, gc, lse, delta, scale), 10)
        copies = (f"; contiguous copies: B3 dK/dV call {cdkv[0]:.4f} graph {cdkv[1]:.4f} ms, dQ call {cdq[0]:.4f} "
                  f"graph {cdq[1]:.4f} ms, sum of graphs {cdkv[1] + cdq[1]:.4f} ms")
        del qc, kc, vc, gc
    qq, kk, vv = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dout = do.transpose(1, 2).contiguous()
    with sdpa_kernel([backend]):
        out = F.scaled_dot_product_attention(qq, kk, vv)
        grad = lambda: torch.autograd.grad(out, (qq, kk, vv), dout, retain_graph=True)  # noqa: E731
        for _ in range(2):
            grad()
        sdpa = _best_ms(lambda: [grad() for _ in range(5)], 5)
        lib = f"{backend.name} SDPA whole backward on copies call {sdpa:.4f} ms"
        if misaligned:
            def with_copies():
                c = [t.transpose(1, 2).contiguous() for t in (q, k, v, do)]
                return torch.autograd.grad(out, (qq, kk, vv), c[3], retain_graph=True)
            for _ in range(2):
                with_copies()
            lib += f", with the four copies call {_best_ms(lambda: [with_copies() for _ in range(5)], 5):.4f} ms"
    print(f"{label}{name} backward ({b},{h},{sq},{sk},{d}): B3 dK/dV call {dkv[0]:.4f} graph {dkv[1]:.4f} ms, "
          f"dQ call {dq[0]:.4f} graph {dq[1]:.4f} ms, sum of graphs {dkv[1] + dq[1]:.4f} ms; B3 route {routes}"
          f"{copies}; {lib}; bound dK/dV {_bound_ms(shape, 4):.4f} dQ {_bound_ms(shape, 3):.4f} ms", flush=True)
    del q, k, v, do, o, lse, delta, qq, kk, vv, dout, out
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
