"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

The kernels are compiled by `nvcc` into one shared library with a plain C
interface and bound with `ctypes` (no PyTorch headers, so the build takes
seconds): one `nvcc -c` per source, all started together, then one link.
The build happens at first use, from the sources in this package,
into `build/t2v_turbo_tpu_torch/<hash of the sources>/` beside the package,
so a changed source rebuilds and an unchanged one loads the existing library.
Nothing here runs when the module is imported.

There is no fallback: without `nvcc`, or on a card that is not sm_90, the
build or the load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "t2v_turbo_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xcompiler", "-fPIC",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _sources():
    names = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith((".cu", ".cuh")))
    return [os.path.join(CSRC_DIR, n) for n in names]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libt2v_kernels.so")


def build() -> str:
    """Compile the library if it is missing; return its path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)))
        objs.append(obj)
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        outputs = [proc.communicate()[0] for _, proc in procs]  # wait for every compile
        for (cmd, proc), output in zip(procs, outputs):
            _finish(cmd, output, proc.returncode)
        proc = subprocess.run(link, capture_output=True, text=True)
        _finish(link, proc.stdout + proc.stderr, proc.returncode)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def _finish(cmd, output, returncode):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n{output}")


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded library with its C signatures declared (built on first use)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    major, minor = torch.cuda.get_device_capability()
    if (major, minor) != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a, device is sm_{major}{minor}")
    so = ctypes.CDLL(build())
    vp, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    so.t2v_flash_attention_fwd.argtypes = [
        vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, ctypes.POINTER(i64), f32, vp,
    ]
    so.t2v_flash_attention_fwd.restype = i32
    pi64 = ctypes.POINTER(i64)
    so.t2v_flash_attention_fwd_lse.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, pi64, pi64, f32, vp,
    ]
    so.t2v_flash_attention_fwd_lse.restype = i32
    so.t2v_flash_attention_bwd_dkv.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, pi64, pi64, f32, i32, vp,
    ]
    so.t2v_flash_attention_bwd_dkv.restype = i32
    so.t2v_flash_attention_bwd_dq.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, pi64, pi64, f32, i32, vp,
    ]
    so.t2v_flash_attention_bwd_dq.restype = i32
    so.t2v_group_norm_scratch.argtypes = [i64, i32, i32, i32]
    so.t2v_group_norm_scratch.restype = i64
    so.t2v_group_norm_fwd.argtypes = [vp, vp, vp, vp, vp, i32, i64, i32, i32, i32, f32, i32, vp]
    so.t2v_group_norm_fwd.restype = i32
    so.t2v_layer_norm_fwd.argtypes = [vp, vp, vp, vp, i32, i64, i32, f32, i32, vp]
    so.t2v_layer_norm_fwd.restype = i32
    so.t2v_group_norm_affine.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, i32, i64, i32, i32, i32, f32, vp,
    ]
    so.t2v_group_norm_affine.restype = i32
    so.t2v_gn_silu_conv_fwd.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp,
    ]
    so.t2v_gn_silu_conv_fwd.restype = i32
    so.t2v_small_seq_attention.argtypes = [vp, vp, vp, vp, i32, i64, i32, i32, i32, pi64, f32, vp]
    so.t2v_small_seq_attention.restype = i32
    so.t2v_error_string.argtypes = [i32]
    so.t2v_error_string.restype = ctypes.c_char_p
    return so


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib().t2v_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
