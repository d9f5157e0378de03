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
                bf16 forwards at head dims 64 and 512 and backwards at 64,
                mma for the unaligned views, the backward at 512 and a
                negative scale, f32), and at L0 and at the VAE mid block
                two launches of each flash forward must give equal bits
                (of B3 at L0); first, the wgmma forward's C entry must
                refuse an unaligned view, a scale <= 0 and f32 at both head
                dims (no fallback). The fused conv is also
                checked and timed at every distinct shape of a UNet step
                (15 spatial 3x3, 4 temporal (3,1)), each case on its route
                (wgmma for bf16, f32), and two launches at L0 must give
                equal bits.
  4. main path: full-width VC2 (UNet 320/640/1280, VAE ch 128, ViT-H text tower
                with 23 of 24 blocks), seeded random weights, bf16, through
                apps/generate.py's build_pipeline and the pipeline call:
                3 prompts, 4 steps, 16 frames at 320x512, timed as plain calls.
                Checks every video and that each kernel launched during this
                run (B1 at head dim 512 once a video, in the VAE's mid block);
                logs the fused conv's and the flash forward's launches a
                UNet step by shape and fails unless every bf16 launch of
                either took the wgmma route. Then one more
                video with each stage's forward timed (synchronised hooks),
                and one under torch.profiler (device time by kernel, the
                fused conv's and the flash forward's device time (the part
                at head dim 512 apart) and the device's idle share, into
                chiprun_out/profile.txt).
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
                the forwards' also by shape), and every fused conv launch the
                wgmma route.
                Runs without --use-remat, with it only if that does not fit.
  7. training with rewards: the same training with --reward-fn hpsv2
                --video-rm-fn vi_clip: random ViT-H/14 (image reward, 5 random
                frames) and ViCLIP-L (video reward, 8 strided frames) towers
                and a VC2 VAE decoding those 13 frames with gradient; first
                checks that the reward terms alone give a finite gradient,
                non-zero in every LoRA up factor; then 1 warm-up and 3 timed
                steps with finite reward losses, launches a step by head dim
                (the D = 512 kernels at least twice a step, once in each
                decode, at batch 8 and at batch 5: B2 on wgmma, B3 on mma,
                each shape held to its plain twin in phase 3; every D = 64
                flash launch on wgmma; every fused conv
                on wgmma), one profiled step
                (chiprun_out/profile_train_rewards.txt).
  8. training reference: one small f32 LCD step (heads of 64, so the flash
                kernels run) through the trainer's gradient path
                (LCDTrainer.loss_and_grads: the step's cached LoRA merge) on
                the card, with remat off and on, and with both rewards (the
                --tiny-model reward stack, decoding in checkpointed chunks),
                against the same weights, LoRA factors (non-zero ups) and
                draws on the CPU: loss, reward losses and every LoRA gradient.
The last lines of standard output are the card's name and power limit, the
kernels' JSON record and {"ok": true, "device": {...}}; the whole log is also
written to chiprun_out/chip_smoke.log.
"""

from __future__ import annotations

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
    "flash_attention_bwd_dkv_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_bwd.cu",
                                     "t2v_turbo_tpu/ops/attention.py:157"),
    "flash_attention_bwd_dq_d512": ("t2v_turbo_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "t2v_turbo_tpu/ops/attention.py:213"),
    "group_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "layer_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:136"),
    "fused_gn_silu_conv": ("t2v_turbo_tpu_torch/csrc/fused_conv.cu", "t2v_turbo_tpu/ops/fused_conv.py:71"),
    "small_seq_attention": ("t2v_turbo_tpu_torch/csrc/small_seq_attention.cu",
                            "tests_tpu/bench_small_seq_attention.py:60"),
}
SERVING_KERNELS = ("flash_attention", "group_norm", "layer_norm", "fused_gn_silu_conv", "small_seq_attention")
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
            "group_norm": N.fused_group_norm, "layer_norm": N.fused_layer_norm,
            "fused_gn_silu_conv": FC.fused_gn_silu_conv, "small_seq_attention": A.small_seq_attention}


def reset_launches():
    for w in wrappers().values():
        w.launches = 0
        for counts in ("by_head_dim", "by_route", "by_shape"):
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
    dim, and the forwards' launches by (B, H, Sq, Sk, D) shape over `passes`
    (UNet passes or training steps: `per` names them); raise unless every
    forward launch and every head-dim-64 backward launch went through wgmma
    (the path's bf16 tensors are TMA-aligned) and every backward launch at
    head dim 512 through mma."""
    from t2v_turbo_tpu_torch.ops import attention as A

    for w in (A.flash_attention, A.flash_attention_lse, A.flash_attention_bwd_dkv, A.flash_attention_bwd_dq):
        fwd = hasattr(w, "by_shape")
        d64, d512 = w.by_head_dim[64], w.by_head_dim[512]
        want = {r: n for r, n in (("wgmma", d64 + d512 if fwd else d64), ("mma", 0 if fwd else d512)) if n}
        ok = dict(w.by_route) == want
        shapes = f"; a {per} by shape {dict((k, c / passes) for k, c in sorted(w.by_shape.items()))}" if fwd else ""
        rule = "every launch on wgmma" if fwd else "D = 64 on wgmma, D = 512 on mma"
        log(f"{what}: {w.__name__} launches by route {dict(w.by_route)}, by head dim "
            f"{dict(sorted(w.by_head_dim.items()))} ({rule}) {'OK' if ok else 'FAIL'}" + shapes)
        if not ok:
            raise AssertionError(f"{what}: {w.__name__} took routes {dict(w.by_route)}, expected {want}")


def flash_device_ms(events):
    """(forward, backward, the forward at head dim 512) device ms of the flash
    kernels in profiler events (the wgmma kernel `flash_fwd_d512_...`, or
    the mma template's `<512, ...>` instance)."""
    fwd, bwd = (sum(e.self_device_time_total for e in events if name in e.key) / 1e3
                for name in ("flash_fwd", "flash_bwd"))
    d512 = sum(e.self_device_time_total for e in events
               if "flash_fwd" in e.key and ("d512" in e.key or "<512" in e.key)) / 1e3
    return fwd, bwd, d512


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


def record(records, name, max_err, ms, plain_ms, library_ms, bound):
    """Keep the first case's times (the path's main shape) and the largest error."""
    rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                                    "library_ms": library_ms, "bound_ms": bound[0],
                                    "bound_by": bound[1]})
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
        return make

    def norm_inputs(shape, c, dtype):
        def make():
            g = torch.Generator("cuda").manual_seed(c)
            x = (3.0 * torch.randn(shape, generator=g, device="cuda") + 1.0).to(dtype)
            w = 1.0 + 0.1 * torch.randn(c, generator=g, device="cuda")
            b = 0.1 * torch.randn(c, generator=g, device="cuda")
            return [x, w, b]
        return make

    bf, f32 = torch.bfloat16, torch.float32
    why_bf = "bf16 output (8-bit mantissa); the kernel rounds unnormalised probabilities, the plain path normalised ones"
    why_short = ("few keys: probabilities near 1, rounded to bf16 (2^-9) at different points "
                 "in the two paths, differ by up to 2^-8*max|v|, ~0.02 for N(0,1) values; "
                 "both are also held to f64 math below")
    why_f32 = "f32 with TF32 off; only the summation order and expf differ"
    why_norm_bf = "bf16 output; f32 statistics summed in another order can move a value by one bf16 ulp"
    def flash(label, make, atol, rtol, iters, why, f64=True, route="wgmma", kernel="flash_attention"):
        return dict(kernel=kernel, label=label, make=make, fn=A.flash_attention,
                    plain=A.attention, outputs=("o",), tols=[_elementwise(atol, rtol)], why=why,
                    route=(A.flash_attention, route), shape=getattr(make, "shape", None), iters=iters,
                    library=_sdpa_fwd,
                    bound=lambda q, k, v: attention_bound(q, k, "fwd"),
                    **({"exact": _attention_f64} if f64 else {}))

    def flash_lse(label, make, atol, rtol, iters, why):
        return dict(kernel="flash_attention_fwd_lse", label=label, make=make,
                    fn=lambda q, k, v: A.flash_attention_lse(q, k, v), plain=lambda q, k, v: A.attention_lse_plain(
                        q, k, v, q.shape[-1] ** -0.5), outputs=("o", "lse"),
                    tols=[_elementwise(atol, rtol), _elementwise(1e-3, 0.0)], iters=iters, library=_sdpa_fwd,
                    why=f"o: {why}; lse: f32 sums of exp in another order", route=(A.flash_attention_lse, "wgmma"),
                    shape=make.shape,
                    bound=lambda q, k, v: attention_bound(q, k, "fwd_lse"), exact=_attention_f64)

    def gn(label, shape, c, eps, iters):
        return dict(kernel="group_norm", label=label, make=norm_inputs(shape, c, bf),
                    fn=lambda x, w, b: N.fused_group_norm(x, w, b, 32, eps, "silu"),
                    plain=lambda x, w, b: N.group_norm_plain(x, w, b, 32, eps, "silu"),
                    outputs=("y",), tols=[_elementwise(1e-2, 1e-2)], iters=iters, why=why_norm_bf,
                    library=lambda x, w, b: {"F.group_norm+F.silu": lambda: F.silu(
                        F.group_norm(x, 32, w.to(x.dtype), b.to(x.dtype), eps))},
                    bound=lambda x, w, b: norm_bound(x, c, 10))

    def ln(label, shape, c, dtype, atol, why):
        return dict(kernel="layer_norm", label=label, make=norm_inputs(shape, c, dtype),
                    fn=lambda x, w, b: N.fused_layer_norm(x, w, b, 1e-5),
                    plain=lambda x, w, b: N.layer_norm_plain(x, w, b, 1e-5),
                    outputs=("y",), tols=[_elementwise(atol, atol)], iters=20, why=why,
                    library=lambda x, w, b: {"F.layer_norm": lambda: F.layer_norm(
                        x, (c,), w.to(x.dtype), b.to(x.dtype), 1e-5)},
                    bound=lambda x, w, b: norm_bound(x, c, 8))

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
                    **({"exact": _fused_conv_f64} if f64 and not f32_case else {}))

    def small_seq(label, make, iters=20, dtype=bf):
        f32_case = dtype == torch.float32
        return dict(kernel="small_seq_attention", label=label, make=make, fn=A.small_seq_attention,
                    plain=A.attention, outputs=("o",),
                    tols=[_elementwise(1e-5, 1e-4) if f32_case else _elementwise(2e-3, 2e-2)],
                    why=("f32; only the summation order and expf differ" if f32_case else
                         "bf16 output; both normalise P in f32 and round it to bf16 before P.V; the "
                         "logits are summed in another order; both are also held to f64 math below"),
                    iters=iters, library=_sdpa_fwd, beside={"B1 flash": A.flash_attention_cuda},
                    bound=lambda q, k, v: attention_bound(q, k, "fwd"),
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
        small_seq("UNet L0 temporal attn (2560,16,5,64) bf16", attn(2560, 16, 5, 64, bf)),
        small_seq("init_attn temporal (2560,16,8,64) bf16", attn(2560, 16, 8, 64, bf)),
        small_seq("UNet L1 temporal attn (640,16,10,64) bf16", attn(640, 16, 10, 64, bf)),
        small_seq("UNet L2 temporal attn (160,16,20,64) bf16", attn(160, 16, 20, 64, bf)),
        small_seq("ragged T = 13 (300,13,5,64) bf16", attn(300, 13, 5, 64, bf)),
        small_seq("T = 48 (200,48,5,64) bf16", attn(200, 48, 5, 64, bf)),
        small_seq("unaligned strided (300,16,5,64) bf16", _unaligned(300, 16, 16, 5, 64, 3)),
        small_seq("f32 (2560,16,5,64)", attn(2560, 16, 5, 64, f32), iters=5, dtype=f32),
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
              why_bf, route="mma"),
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
    # scale (mma route: the wgmma forward takes positive scales only), and
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
        tols=[_elementwise(2e-3, 2e-2), _elementwise(1e-3, 0.0)], route=(A.flash_attention_lse, "mma"),
        why=f"o: {why_bf}; lse: f32 sums of exp in another order; a scale <= 0 takes the mma route"))
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
    # view, which the wgmma forward cannot read (mma route)
    fwd_path += [
        flash("tile edges (2,1,129,129,512) bf16", attn(2, 129, 1, 512, bf), 2e-3, 2e-2, 3, why_bf,
              kernel="flash_attention_d512"),
        flash("tile edges (2,1,191,65,512) bf16", attn(2, 191, 1, 512, bf, sk=65), 2e-2, 2e-2, 3, why_short,
              kernel="flash_attention_d512"),
        flash("short keys (2,1,100,40,512) bf16", attn(2, 100, 1, 512, bf, sk=40), 2e-2, 2e-2, 3, why_short,
              kernel="flash_attention_d512"),
        # checked, not recorded: the record of flash_attention_d512 is the wgmma kernel's
        flash("unaligned strided q/k/v (2,1,300,300,512) bf16", _unaligned(2, 300, 300, 1, 512, 3), 2e-3, 2e-2, 3,
              why_bf, route="mma", kernel="flash_attention_d512 on mma"),
    ]
    return serving + train + fwd_path + b7_unet


# The training path's attentions (B, Sq, Sk, H, D): every UNet attention the
# student's gradient-carrying forward runs, plus ragged, strided and f32; and,
# with reward feedback, ViCLIP's and the VAE decoder's mid-block attention
# (one head of 512, recorded under the `_d512` names), once a step in each of
# the two decodes: 8 frames for the video reward, 5 for the image reward
# (the record keeps the first's times). The last field: the
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
    ("ragged unaligned strided (2,1,1111,1111,512) bf16", (2, 1111, 1111, 1, 512), "unaligned", 3, True),
    ("VAE mid attn (2,1,1111,1111,512) f32, TF32 off", (2, 1111, 1111, 1, 512), "float32", 2, True),
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
    # the forward takes wgmma at both head dims on aligned bf16, the backward at 64 only
    fwd_route = "f32" if not bf16 else "mma" if kind == "unaligned" else "wgmma"
    route = "mma" if fwd_route == "wgmma" and d == 512 else fwd_route
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
    ] + (determinism if shape == (16, 2560, 2560, 5, 64) else [])


def _unaligned(b, sq, sk, h, d, n):
    """n (B, S, H, D) bf16 tensors whose rows start one element past 16-byte
    alignment (strided views), so the kernels take their element-wise path."""
    def make():
        import torch

        g = torch.Generator("cuda").manual_seed(sq)
        bufs = [torch.randn((b, s, h * d + 1), generator=g, device="cuda").to(torch.bfloat16)
                for s in (sq, sk, sk, sq)[:n]]
        return [t[..., 1:].view(b, t.shape[1], h, d) for t in bufs]
    return make


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
    """No fallback in the C entry: a forward on the wgmma route that its
    kernels cannot take (an unaligned view, a scale <= 0, f32), at both head
    dims, returns an error instead of running."""
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


def phase_kernels(records):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    check_wgmma_refusals()
    for case in _kernel_cases():
        name, label = case["kernel"], case["label"]
        inputs = case["make"]()
        counter, route = case.get("route", (None, None))  # a backward kernel's expected route
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
        line = f"kernel {name}: {label}: finite {finite}; " + "".join(
            f"{n} max_abs_err {e:.3e} (<= {text}); " for n, e, (_, text) in zip(case["outputs"], errs, case["tols"])
        ) + (f"route {taken} (expected {route}); " if counter else "") + f"({case['why']}) {'OK' if ok else 'FAIL'}"
        if name in KERNELS:
            library = {n: cuda_time_ms(c, case["iters"]) for n, c in case["library"](*inputs).items()}
            times = (cuda_time_ms(lambda: case["fn"](*inputs), case["iters"]),
                     cuda_time_ms(lambda: case["plain"](*inputs), case["iters"]),
                     min(library.values(), default=None))  # the fastest library call
            bound = case["bound"](*inputs)
            line += "; " + _timing_line(*times[:2], library, bound)
            for n, c in case.get("beside", {}).items():  # logged only
                line += f"; {n} {cuda_time_ms(lambda c=c: c(*inputs), case['iters']):.4g} ms"
            record(records, name, max(errs), *times, bound)
        log(line)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {label}")
        if "exact" in case:
            for n, g, r, e in zip(case["outputs"], got, ref, case["exact"](*inputs)):
                _check_against_f64(name, f"{label} {n}", g, r, e)
        del inputs, got, ref
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True


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
    for name, n in launches.items():
        records[name]["launches"] = n
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
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


def _profile_one_video(pipe):
    """torch.profiler over one more video: device time by kernel and the
    device's idle share of the wall time, into chiprun_out/profile.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(2000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(prompt=PROMPTS[0], generator=gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40, max_name_column_width=90)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms\n{table}\n")
    b7_ms = sum(e.self_device_time_total for e in events if "gn_silu_conv" in e.key) / 1e3
    fwd_ms, _, fwd512_ms = flash_device_ms(events)
    log(f"profile: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the fused conv's kernels (B7) {b7_ms:.1f} ms; the flash "
        f"forward's kernels (B1) {fwd_ms:.2f} ms, of which D = 512 {fwd512_ms:.2f} -> chiprun_out/profile.txt")


def phase_reference():
    """A small f32 pipeline on the card (kernels) against the CPU (plain versions)."""
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


def phase_training(records):
    """Full-width v1 LoRA LCD training through apps/train_v1.py's builder."""
    import gc

    import torch

    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        try:
            return _train_full_width(records, remat)
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


def _profile_train_step(trainer, data, name):
    """torch.profiler over one more training step: device time by kernel and
    the idle share, into chiprun_out/<name>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    host_batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer.step_once(host_batch)["loss"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=50, max_name_column_width=90)
    with open(os.path.join(OUT_DIR, name), "w") as f:
        f.write(f"wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms\n{table}\n")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    b7_ms = sum(e.self_device_time_total for e in events if "gn_silu_conv" in e.key) / 1e3
    fwd_ms, bwd_ms, fwd512_ms = flash_device_ms(events)
    log(f"training profile: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; the fused conv's forward kernels (B7) {b7_ms:.1f} ms; flash "
        f"forward (B1, B2) {fwd_ms:.2f} ms (D = 512: {fwd512_ms:.2f}), backward (B3) {bwd_ms:.1f} ms "
        f"-> chiprun_out/{name}; top: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms" for e in top))


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


def _reward_gradient_check(trainer, host_batch):
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
    log(f"training with rewards: the reward terms' own gradient at the first step (reward_loss "
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


def main() -> int:
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
    phases = [
        ("device", phase_device),
        ("build", phase_build),
        ("kernels", lambda: phase_kernels(records)),
        ("main path", lambda: phase_main_path(records)),
        ("reference", phase_reference),
        ("training", lambda: phase_training(records)),
        ("training with rewards", lambda: phase_training_rewards(records)),
        ("training reference", phase_training_reference),
    ]
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
         "library_ms": r["library_ms"]}
        for n, r in records.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
