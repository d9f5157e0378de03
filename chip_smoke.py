#!/usr/bin/env python3
"""Smoke test of the PyTorch port (t2v_turbo_tpu_torch) on one CUDA card.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases; the script exits non-zero, without the final result line, if any fails:
  1. device:    a CUDA device must exist; prints the card's name and power limit.
  2. build:     compiles the hand-written kernels from csrc/ with nvcc.
  3. kernels:   each kernel against its plain PyTorch version on the card, at the
                main path's shapes, with the stated tolerance; bf16 flash
                attention and its plain version also against f64 math; times
                kernel and plain with CUDA events.
  4. main path: full-width VC2 (UNet 320/640/1280, VAE ch 128, ViT-H text tower
                with 23 of 24 blocks), seeded random weights, bf16, through
                apps/generate.py's build_pipeline and the pipeline call:
                3 prompts, 4 steps, 16 frames at 320x512, timed as plain calls.
                Checks every video and that each kernel launched during this
                run. Then one more video with each stage's forward timed
                (synchronised hooks), and one under torch.profiler (device time
                by kernel and the device's idle share, into
                chiprun_out/profile.txt).
  5. reference: a small pipeline (f32, 256x256, so flash attention still runs)
                on the card against the same weights on the CPU, where every
                kernel wrapper runs its plain version.
The last two lines of standard output are the kernels' JSON record and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
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
    "flash_attention": ("t2v_turbo_tpu_torch/csrc/flash_attention.cu",
                        "t2v_turbo_tpu/ops/attention.py:257"),
    "group_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:90"),
    "layer_norm": ("t2v_turbo_tpu_torch/csrc/norms.cu", "t2v_turbo_tpu/ops/fused_norms.py:136"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def _kernel_cases():
    """(kernel, label, make_inputs, kernel_fn, plain_fn, atol, rtol, iters, reason)."""
    import torch

    from t2v_turbo_tpu_torch.ops import attention as A
    from t2v_turbo_tpu_torch.ops import norms as N

    def attn(b, s, h, d, dtype, sk=None):
        def make():
            g = torch.Generator("cuda").manual_seed(s + d)
            shapes = [(b, s, h, d)] + 2 * [(b, sk or s, h, d)]
            return [torch.randn(sh, generator=g, device="cuda").to(dtype) for sh in shapes]
        return make

    def attn_unaligned(b, s, h, d):
        """q, k, v whose rows start one element past 16-byte alignment, so the
        kernels take their element-wise staging path."""
        def make():
            g = torch.Generator("cuda").manual_seed(s)
            bufs = [torch.randn((b, s, h * d + 1), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(3)]
            return [t[..., 1:].view(b, s, h, d) for t in bufs]
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
    gn = lambda x, w, b: N.fused_group_norm(x, w, b, 32, 1e-5, "silu")
    gn_plain = lambda x, w, b: N.group_norm_plain(x, w, b, 32, 1e-5, "silu")
    gn6 = lambda x, w, b: N.fused_group_norm(x, w, b, 32, 1e-6, "silu")
    gn6_plain = lambda x, w, b: N.group_norm_plain(x, w, b, 32, 1e-6, "silu")
    ln = lambda x, w, b: N.fused_layer_norm(x, w, b, 1e-5)
    ln_plain = lambda x, w, b: N.layer_norm_plain(x, w, b, 1e-5)
    return [
        ("flash_attention", "UNet L0 self-attn (16,5,2560,2560,64) bf16", attn(16, 2560, 5, 64, bf),
         A.flash_attention, A.attention, 2e-3, 2e-2, 10, why_bf),
        ("flash_attention", "UNet L0 self-attn (16,5,2560,2560,64) f32", attn(16, 2560, 5, 64, f32),
         A.flash_attention, A.attention, 1e-5, 1e-4, 5, why_f32),
        ("flash_attention", "VAE mid attn (16,1,2560,2560,512) bf16", attn(16, 2560, 1, 512, bf),
         A.flash_attention, A.attention, 2e-3, 2e-2, 5, why_bf),
        ("flash_attention", "UNet L1 self-attn (16,10,640,640,64) bf16", attn(16, 640, 10, 64, bf),
         A.flash_attention, A.attention, 2e-3, 2e-2, 20, why_bf),
        ("flash_attention", "UNet L0 cross-attn (16,5,2560,77,64) bf16",
         attn(16, 2560, 5, 64, bf, sk=77), A.flash_attention, A.attention, 2e-2, 2e-2, 20, why_short),
        ("flash_attention", "UNet L0 temporal attn (2560,5,16,16,64) bf16", attn(2560, 16, 5, 64, bf),
         A.flash_attention, A.attention, 2e-2, 2e-2, 20, why_short),
        ("flash_attention", "ragged S (2,5,1111,1111,64) bf16", attn(2, 1111, 5, 64, bf),
         A.flash_attention, A.attention, 2e-3, 2e-2, 5, why_bf),
        ("flash_attention", "ragged S (2,1,1111,1111,512) bf16", attn(2, 1111, 1, 512, bf),
         A.flash_attention, A.attention, 2e-3, 2e-2, 5, why_bf),
        ("flash_attention", "unaligned strided K/V (2,5,300,300,64) bf16", attn_unaligned(2, 300, 5, 64),
         A.flash_attention, A.attention, 2e-3, 2e-2, 5, why_bf),
        ("group_norm", "UNet L0 GN+SiLU per frame (16,320,40,64) bf16",
         norm_inputs((16, 320, 40, 64), 320, bf), gn, gn_plain, 1e-2, 1e-2, 20, why_norm_bf),
        ("group_norm", "whole-clip GN+SiLU (1,320,16,40,64) bf16",
         norm_inputs((1, 320, 16, 40, 64), 320, bf), gn, gn_plain, 1e-2, 1e-2, 20, why_norm_bf),
        ("group_norm", "VAE full-res GN+SiLU (16,128,320,512) bf16",
         norm_inputs((16, 128, 320, 512), 128, bf), gn6, gn6_plain, 1e-2, 1e-2, 10, why_norm_bf),
        ("group_norm", "odd spatial size, element-wise path (2,64,5,7) bf16",
         norm_inputs((2, 64, 5, 7), 64, bf), gn, gn_plain, 1e-2, 1e-2, 5, why_norm_bf),
        ("layer_norm", "transformer LN (40960,320) bf16", norm_inputs((40960, 320), 320, bf),
         ln, ln_plain, 1e-2, 1e-2, 20, why_norm_bf),
        ("layer_norm", "transformer LN (2560,1280) f32", norm_inputs((2560, 1280), 1280, f32),
         ln, ln_plain, 1e-5, 1e-5, 20, "f32; only the summation order differs"),
    ]


def _attention_f64(q, k, v):
    import torch

    logits = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * q.shape[-1] ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", logits.softmax(-1), v.double())


# A bf16 flash output must be no less accurate than the plain path's, both
# measured against f64 math on the same bf16 inputs. Both round their output
# to bf16, so their errors are quantised to bf16 ulps: the largest error may
# land one ulp (2x) apart, the mean error is the finer reading. A P.V product
# accumulated in bf16, or a row sum out of step with the rescaled
# accumulator, raises the mean error well past these factors.
F64_MEAN_FACTOR, F64_MAX_FACTOR = 1.25, 2.0


def _check_against_f64(label, inputs, got, ref):
    """Errors of kernel and plain against f64 attention; raises unless the
    kernel's are within the factors above of the plain path's."""
    exact = _attention_f64(*inputs)
    k_err, p_err = ((t.double() - exact).abs() for t in (got, ref))
    k_max, k_mean = float(k_err.max()), float(k_err.mean())
    p_max, p_mean = float(p_err.max()), float(p_err.mean())
    ok = k_mean <= F64_MEAN_FACTOR * p_mean and k_max <= F64_MAX_FACTOR * p_max
    log(f"kernel flash_attention: {label}: against f64 on the same bf16 inputs: kernel max {k_max:.3e} "
        f"mean {k_mean:.3e}, plain max {p_max:.3e} mean {p_mean:.3e} (kernel mean <= "
        f"{F64_MEAN_FACTOR:g}x plain's, max <= {F64_MAX_FACTOR:g}x) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"flash_attention is less accurate than the plain path at {label}")


def phase_kernels(records):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name, label, make, kern, plain, atol, rtol, iters, reason in _kernel_cases():
        inputs = make()
        got = kern(*inputs)
        torch.cuda.synchronize()
        ref = plain(*inputs)
        err = (got.float() - ref.float()).abs()
        bound = atol + rtol * ref.float().abs()
        ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
        max_err = float(err.max())
        ms = cuda_time_ms(lambda: kern(*inputs), iters)
        plain_ms = cuda_time_ms(lambda: plain(*inputs), iters)
        log(f"kernel {name}: {label}: max_abs_err {max_err:.3e} (atol {atol:g} + rtol {rtol:g}"
            f"*|ref|: {reason}) {'OK' if ok else 'FAIL'}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rec = records.setdefault(name, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms})
        rec["max_abs_err"] = max(rec["max_abs_err"], max_err)
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version at {label}")
        del err, bound
        if name == "flash_attention" and got.dtype == torch.bfloat16:
            _check_against_f64(label, inputs, got, ref)
        del inputs, got, ref
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True


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
    from t2v_turbo_tpu_torch.ops import flash_attention, fused_group_norm, fused_layer_norm
    from t2v_turbo_tpu_torch.pipelines.vc2 import video_to_uint8

    t0 = time.perf_counter()
    args = parse_args(["--prompt", PROMPTS[0], "--random-weights", "--seed", "0", "--device", "cuda:0"])
    pipe = build_pipeline(args)
    torch.cuda.synchronize()
    n_params = {n: sum(p.numel() for p in m.parameters())
                for n, m in (("unet", pipe.unet), ("vae", pipe.vae), ("text", pipe.text_model))}
    log(f"main path: pipeline built in {time.perf_counter() - t0:.1f} s; parameters {n_params}")

    wrappers = {"flash_attention": flash_attention, "group_norm": fused_group_norm,
                "layer_norm": fused_layer_norm}
    for w in wrappers.values():
        w.launches = 0
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
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f"main path: s/video (videos 2-3, no hooks) {' '.join(f'{s:.3f}' for s in video_s[1:])}; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    log(f"main path: kernel launches {launches}")
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
    log(f"profile: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f} -> chiprun_out/profile.txt")


def phase_reference():
    """A small f32 pipeline on the card (kernels) against the CPU (plain versions)."""
    import copy

    import torch

    from t2v_turbo_tpu_torch.config import VC2ModelSpec
    from t2v_turbo_tpu_torch.models import (
        AutoencoderKL, CLIPTextConfig, CLIPTextModel, UNetConfig, UNetModel, VAEConfig, seeded_init_,
    )
    from t2v_turbo_tpu_torch.ops import flash_attention
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
    flash_attention.launches = 0
    for (unet, vae, text), device in ((cpu, "cpu"), (gpu, "cuda:0")):
        pipe = T2VTurboVC2Pipeline(unet=unet.eval(), vae=vae.eval(), text_model=text.eval(),
                                   tokenizer=CLIPTokenizer(), schedule=spec.make_schedule(),
                                   device=device, dtype=torch.float32)
        videos.append(pipe(prompt=PROMPTS[0], height=256, width=256, frames=2, num_inference_steps=2,
                           latents=latents, noise=noise).cpu())
    err = float((videos[0] - videos[1]).abs().max())
    scale = float(videos[0].abs().max())
    ok = err <= 1e-3 * max(1.0, scale) and flash_attention.launches > 0
    log(f"reference: 2-step f32 pipeline, 2x256x256, card vs CPU: max_abs_err {err:.3e} "
        f"(|ref| max {scale:.3f}; bound 1e-3*max(1,|ref|): f32, TF32 off, sums in another order), "
        f"flash launches {flash_attention.launches} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the card's pipeline disagrees with the CPU's")
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
    records = {}
    phases = [
        ("device", phase_device),
        ("build", phase_build),
        ("kernels", lambda: phase_kernels(records)),
        ("main path", lambda: phase_main_path(records)),
        ("reference", phase_reference),
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
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": KERNELS[n][0], "replaces": KERNELS[n][1],
         "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"]}
        for n, r in records.items()
    ]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
