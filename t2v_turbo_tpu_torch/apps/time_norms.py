"""Time the norm kernels on the card, shape by shape: GroupNorm(+SiLU) (B4),
its statistics mode for the fused GroupNorm+SiLU+conv (B7), LayerNorm (B5).

Usage (from a checkout, on a CUDA card):
  python3 t2v_turbo_tpu_torch/apps/time_norms.py [--root DIR] [--label NAME] [--only gn|stats|ln]
      [--variants] [--video [--stats-l2 BYTES]]

Times each kernel's wrapper at every distinct shape the three paths launch
(serving, training, training with rewards; the lists below are the wrappers'
`by_shape` counts from a chip_smoke.py run) beside the PyTorch call that
computes the same function (F.group_norm + F.silu, F.layer_norm; none for
the statistics) and the card's bound (inputs read once, outputs written once
at 3.35 TB/s). Two times a call: device ms by CUDA-graph replay (`graph_ms`:
the calls rotate through enough copies of the inputs, and keep enough
outputs alive, that their bytes come from device memory and not from the
50 MB L2), for the kernel and the library call alike; and the back-to-back
call time (CUDA events over calls on one input, host time included, as
chip_smoke.py's `ms`). --root imports `t2v_turbo_tpu_torch` from another
checkout (e.g. an older commit unpacked with `git archive`), so two trees
can be timed in turns in one run on one card; a tree without the statistics
wrapper times the statistics through its C entry point. --variants also
times other launch plans of this tree's GroupNorm kernel at each shape
(other cluster sizes, the two-launch split route; for the statistics, the
staged plan), one line each (`gn_variants`). --video instead profiles one
full-width video (apps/generate.py's pipeline, seeded random weights, after
two warm-up videos) with each norm's C entry point inside a named profiler
range, and prints the device ms of B4, B7's statistics and B5 a video (a
tree's split between B4's and the statistics' launches, whatever its
kernels); --stats-l2 sets the statistics mode's GN_STATS_L2 (the largest
tensor it re-reads from L2 instead of staging) for that video. Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import collections
import functools
import os
import subprocess
import sys

# GroupNorm (N, C, *spatial): the UNet's per-frame norms (the spatial
# transformers' input norm at 40x64, 20x32, 10x16, 5x8), its whole-clip
# norms (the temporal transformers', init_attn's among them), the VAE
# decoder's at 16 frames (serving) and at 8 and 5 (the video and image
# rewards' decodes).
GN_SHAPES = [(16, 320, 40, 64), (16, 640, 20, 32), (16, 1280, 10, 16), (16, 1280, 5, 8),
             (1, 320, 16, 40, 64), (1, 640, 16, 20, 32), (1, 1280, 16, 10, 16), (1, 1280, 16, 5, 8)] + [
    (n, c, h, w) for n in (16, 8, 5) for c, h, w in (
        (512, 40, 64), (512, 80, 128), (512, 160, 256), (256, 160, 256), (256, 320, 512), (128, 320, 512))]
# The statistics mode: the fused conv's GroupNorm inputs (N, C, H, W) of a
# UNet step (time_fused_conv.UNET_STEP_SHAPES without the conv).
STATS_SHAPES = [(16, 320, 40, 64), (16, 960, 40, 64), (16, 640, 40, 64), (16, 320, 20, 32), (16, 640, 20, 32),
                (16, 1920, 20, 32), (16, 1280, 20, 32), (16, 960, 20, 32), (16, 640, 10, 16), (16, 1280, 10, 16),
                (16, 2560, 10, 16), (16, 1920, 10, 16), (16, 1280, 5, 8), (16, 2560, 5, 8),
                (1, 320, 16, 2560), (1, 640, 16, 640), (1, 1280, 16, 160), (1, 1280, 16, 40)]
# LayerNorm (rows, C) in bf16: the UNet's transformers at the four levels
# and init_attn's (8 heads of 64), the text tower, the reward towers (ViT-H/14
# on 5 frames and its class tokens, ViCLIP-L on 8 and its class token, their
# text towers); then the f32 row.
LN_SHAPES = [(40960, 320), (10240, 640), (2560, 1280), (640, 1280), (40960, 512), (77, 1024), (1285, 1280),
             (5, 1280), (2049, 1024), (1, 1024), (77, 768)]
LN_F32_SHAPES = [(2560, 1280)]
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published memory rate


L2_BYTES = 50 * 2**20  # the H100's L2
ROTATE_BYTES = 4 * L2_BYTES  # what a timed call's copies move in all
MAX_COPIES = 256


def copies_for(call_bytes):
    """Input sets a timed call rotates through so that what it moves comes
    from device memory: enough to move ROTATE_BYTES, at most MAX_COPIES (a
    call of under ~0.8 MB then stays partly in L2)."""
    return max(1, min(MAX_COPIES, -(-ROTATE_BYTES // max(1, call_bytes))))


def copy_inputs(inputs):
    """Each tensor of `inputs` copied to a new allocation at the same
    offset from a 16-byte boundary (a misaligned view stays misaligned);
    anything else as it is."""
    import torch

    out = []
    for t in inputs:
        if isinstance(t, torch.Tensor):
            off = t.data_ptr() % 16 // t.element_size()
            buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
            t = buf[off:].view(t.shape).copy_(t)
        out.append(t)
    return out


def rotation(fn, inputs, call_bytes):
    """fn over `inputs` and over copies of them (`copies_for(call_bytes)`
    input sets in all): the calls `graph_ms` rotates through."""
    sets = [list(inputs)] + [copy_inputs(inputs) for _ in range(copies_for(call_bytes) - 1)]
    return [functools.partial(fn, *s) for s in sets]


def graph_ms(fns, iters=20):
    """Device ms of one call by CUDA-graph replay: max(iters, len(fns))
    calls captured in one graph, taking the callables of `fns` in turn (one
    callable, or `rotation`'s over distinct inputs), each call's output kept
    alive over the next len(fns) calls so that the outputs rotate too; the
    graph replayed 3 times between CUDA events. No host time between the
    launches, which back-to-back calls of a small kernel are bound by."""
    import torch

    fns = list(fns) if isinstance(fns, (list, tuple)) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:2]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    calls = max(iters, len(fns))
    with torch.cuda.graph(graph):
        outs = collections.deque(maxlen=len(fns))
        for i in range(calls):
            outs.append(fns[i % len(fns)]())
        del outs
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (3 * calls)
    del graph
    return ms


def call_ms(fn, iters=20):
    """ms of one back-to-back call (CUDA events over `iters` calls after 2 warm-ups)."""
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


def _stats_fn(N):
    """The statistics launch of this tree as a function of (x, w, b): its
    wrapper, or (an older tree) its C entry point with the scratch it took."""
    import torch

    if hasattr(N, "group_norm_affine_cuda"):
        return lambda x, w, b: N.group_norm_affine_cuda(x, w, b, 32, 1e-5)
    from t2v_turbo_tpu_torch.ops import cuda_lib

    lib = cuda_lib.lib()

    def run(x, w, b):
        (n, c), s = x.shape[:2], x[0, 0].numel()
        a_out, b_out = (torch.empty((n, c), dtype=torch.float32, device=x.device) for _ in range(2))
        scratch = torch.empty(lib.t2v_group_norm_scratch(n, c, 32, s), dtype=torch.float32, device=x.device)
        cuda_lib.check(lib.t2v_group_norm_affine(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), None, None, a_out.data_ptr(), b_out.data_ptr(),
            scratch.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], n, c, 32, s, 1e-5, cuda_lib.stream_ptr(x.device)),
            "t2v_group_norm_affine")
        return a_out, b_out
    return run


def gn_variants(N, shape, dtype, stats=False):
    """(name, plan) of the GroupNorm kernel's plans at `shape`: the plan;
    for the statistics mode the staged plan (GN_STATS_L2 = 0); else the
    split route at 2 and 4 vectors a thread and the staged plans with 1-16
    blocks a row that the plan did not take (each holding what
    GN_BLOCKS_PER_SM blocks an SM may)."""
    n, c, s = shape[0], shape[1], 1
    for d in shape[2:]:
        s *= d
    e = dtype.itemsize
    rows_total, l = n * 32, (c // 32) * s
    plan = N.gn_plan(n, c, 32, s, dtype, stats=stats)
    out = [("plan", plan)]
    if stats:
        limit, N.GN_STATS_L2 = N.GN_STATS_L2, 0
        N.gn_plan.cache_clear()
        out.append(("staged", N.gn_plan(n, c, 32, s, dtype, stats=True)))
        N.GN_STATS_L2 = limit
        N.gn_plan.cache_clear()
        return out
    out += [(f"split, {v} vectors a thread", N.split_plan(rows_total, l, e, v)) for v in N.GN_SPLIT_VECS
            if N.split_plan(rows_total, l, e, v) != plan]
    held = N._held_bytes(N.GN_BLOCKS_PER_SM) // e
    for k in (1, 2, 4, 8, 16):
        chunk = N._chunk(l, k, 16 // e)
        if chunk is not None and (plan.route == "split" or k != plan.k):
            out.append((f"k={k}", N.staged_plan(rows_total, e, k, chunk, min(chunk, held // 8 * 8))))
    return out


# The norms' C entry points (the same names in older trees) and their ranges.
VIDEO_RANGES = (("t2v_group_norm_fwd", "B4"), ("t2v_group_norm_affine", "B7 statistics"),
                ("t2v_layer_norm_fwd", "B5"))


def profile_video(label):
    """Device ms of the norms in one profiled video, each C entry point's
    launches inside a named range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from t2v_turbo_tpu_torch.apps.generate import build_pipeline, parse_args
    from t2v_turbo_tpu_torch.ops import cuda_lib

    lib = cuda_lib.lib()
    for name, tag in VIDEO_RANGES:
        def ranged(*args, entry=getattr(lib, name), tag=tag):
            with record_function(tag):
                return entry(*args)
        setattr(lib, name, ranged)
    prompt = "An astronaut riding a horse on the moon"
    pipe = build_pipeline(parse_args(["--prompt", prompt, "--random-weights", "--seed", "0", "--device", "cuda:0"]))
    for seed in (0, 1):
        pipe(prompt=prompt, generator=torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe(prompt=prompt, generator=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    ranges = {e.key: e for e in events}
    print(f"{label}a video: device kernels {device / 1e3:.1f} ms; " + "; ".join(
        f"{tag} {ranges[tag].device_time_total / 1e3:.2f} ms over {ranges[tag].count} calls"
        for _, tag in VIDEO_RANGES if tag in ranges), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                    help="checkout to import t2v_turbo_tpu_torch from")
    ap.add_argument("--label", default="", help="prefix of every printed line")
    ap.add_argument("--only", choices=("gn", "stats", "ln"), help="time one kernel's shapes")
    ap.add_argument("--variants", action="store_true", help="also time the GroupNorm kernel's other plans")
    ap.add_argument("--video", action="store_true", help="the norms' device ms in one profiled video instead")
    ap.add_argument("--stats-l2", type=int, help="with --video: the statistics mode's GN_STATS_L2, in bytes")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.nn.functional as F

    from t2v_turbo_tpu_torch.ops import norms as N

    if not torch.cuda.is_available():
        print("time_norms: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.video:
        if args.stats_l2 is not None:
            N.GN_STATS_L2 = args.stats_l2
            N.gn_plan.cache_clear()
            args.label += f"GN_STATS_L2={args.stats_l2}: "
        profile_video(args.label)
        return 0
    g = torch.Generator("cuda").manual_seed(0)

    def inputs(shape, c, dtype):
        x = (3.0 * torch.randn(shape, generator=g, device="cuda") + 1.0).to(dtype)
        return [x, 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda"),
                0.1 * torch.randn(c, generator=g, device="cuda")]

    def report(what, shape, dtype, fn, library, args_, nbytes, moved):
        """One line: fn(*args_) (and the library's) by rotated graph replay
        and back-to-back; `nbytes` the bound's bytes, `moved` what a call
        writes and reads (the rotation's size)."""
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        ms = graph_ms(rotation(fn, args_, moved))
        line = (f"{args.label}{what} {tuple(shape)} {str(dtype).replace('torch.', '')}: kernel {ms:.4f} ms "
                f"({bound / ms:.0%} of the bound), call {call_ms(lambda: fn(*args_)):.4f} ms")
        if library is not None:
            lib_ms = graph_ms(rotation(library, args_, moved))
            line += (f"; library {lib_ms:.4f} ms (kernel/library {ms / lib_ms:.2f}), call "
                     f"{call_ms(lambda: library(*args_)):.4f} ms")
        print(line + f"; bound {bound:.4f} ms", flush=True)
        torch.cuda.empty_cache()

    def variants(shape, dtype, args_, nbytes, moved, stats):
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        for name, plan in gn_variants(N, shape, dtype, stats):
            if stats:
                fn = lambda x, w, b, p=plan: N.group_norm_affine_cuda(x, w, b, 32, 1e-5, plan=p)  # noqa: E731
            else:
                fn = lambda x, w, b, p=plan: N.group_norm_cuda(x, w, b, 32, 1e-6, "silu", plan=p)  # noqa: E731
            try:
                ms = f"{graph_ms(rotation(fn, args_, moved)):.4f} ms"
            except RuntimeError as err:  # a cluster the card cannot run
                ms = f"refused ({err})"
            print(f"{args.label}  {name} {plan}: {ms}" + (f" ({bound / float(ms[:-3]):.0%} of the bound)"
                                                         if ms.endswith(" ms") else ""), flush=True)
            torch.cuda.empty_cache()

    if args.only in (None, "gn"):
        for shape in GN_SHAPES:
            c = shape[1]
            xs = inputs(shape, c, torch.bfloat16)
            nbytes = 2 * xs[0].numel() * xs[0].element_size() + 8 * c
            report("GroupNorm+SiLU", shape, xs[0].dtype, lambda x, w, b: N.fused_group_norm(x, w, b, 32, 1e-6, "silu"),
                   lambda x, w, b: F.silu(F.group_norm(x, 32, w.to(x.dtype), b.to(x.dtype), 1e-6)), xs, nbytes,
                   nbytes)
            if args.variants:
                variants(shape, torch.bfloat16, xs, nbytes, nbytes, False)
            del xs
            torch.cuda.empty_cache()
    if args.only in (None, "stats"):
        stats = _stats_fn(N)
        for shape in STATS_SHAPES:
            c = shape[1]
            xs = inputs(shape, c, torch.bfloat16)
            nbytes = xs[0].numel() * xs[0].element_size() + 8 * shape[0] * c + 8 * c
            report("GroupNorm statistics", shape, xs[0].dtype, stats, None, xs, nbytes, nbytes)
            if args.variants:
                variants(shape, torch.bfloat16, xs, nbytes, nbytes, True)
    if args.only in (None, "ln"):
        for shapes, dtype in ((LN_SHAPES, torch.bfloat16), (LN_F32_SHAPES, torch.float32)):
            for rows, c in shapes:
                xs = inputs((rows, c), c, dtype)
                nbytes = 2 * xs[0].numel() * xs[0].element_size() + 8 * c
                report("LayerNorm", (rows, c), dtype, lambda x, w, b: N.fused_layer_norm(x, w, b, 1e-5),
                       lambda x, w, b, c=c: F.layer_norm(x, (c,), w.to(x.dtype), b.to(x.dtype), 1e-5), xs, nbytes,
                       nbytes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
