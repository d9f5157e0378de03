"""Attention: plain PyTorch math, the CUDA flash-attention forward, and `sdpa`.

Tensors are (B, S, H, D) ("BSHD"), the layout the q/k/v Linears produce, as
in the JAX package's `attention_xla_bshd` / `sdpa_bshd`
(t2v_turbo_tpu/ops/attention.py).

- `attention`: the reference semantics of `attention_xla(_bshd)`: f32 logits
  and softmax, an optional additive bias and causal mask, the probabilities
  cast to v's dtype before the product, optional `return_probs`. It is the
  path for short, biased or causal attention and the flash kernel's oracle.
  It uses matmul and softmax, never F.scaled_dot_product_attention.
- `flash_attention`: the hand-written kernel of csrc/flash_attention.cu for a
  CUDA tensor (head dims 64 and 512), `attention` for a CPU tensor. It raises
  on anything else; it never falls back. `flash_attention.launches` counts
  kernel launches.
- `sdpa`: the dispatcher for unbiased, non-causal attention. Flash takes
  every call whose head dim the kernel has (64 and 512): on the main path
  that is the spatial self-attention at every level, the cross-attention to
  the 77 text tokens, the temporal self-attention over 16 frames and the VAE
  mid-block. The JAX package gated flash at Sq, Sk >= 1024 (XLA won below on
  the TPU); on the H100 the kernel beat the plain path at every one of those
  shapes (PERF.md), so the gate is the head dim alone. The causal CLIP
  tower calls `attention` directly.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_HEAD_DIMS = (64, 512)


def attention(q, k, v, bias=None, causal=False, scale=None, return_probs=False):
    """softmax(q k^T * scale + bias) v on (B, S, H, D); probs are (B, H, Sq, Sk)."""
    sq, sk = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~keep, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v).to(q.dtype)
    if return_probs:
        return out, probs
    return out


def flash_attention(q, k, v, scale=None):
    """Flash-attention forward on (B, S, H, D): the kernel for a CUDA
    tensor, `attention` for a CPU tensor.

    Replaces t2v_turbo_tpu/ops/attention.py::flash_attention (forward only).
    """
    if q.device.type == "cpu":
        return attention(q, k, v, scale=scale)
    return flash_attention_cuda(q, k, v, scale)


flash_attention.launches = 0


def flash_attention_cuda(q, k, v, scale=None):
    """Launch csrc/flash_attention.cu; raises on anything it does not take."""
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_cuda: no kernel for device {q.device}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in cuda_lib.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported")
    if d not in FLASH_HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in {FLASH_HEAD_DIMS}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: shapes {q.shape}, {k.shape}, {v.shape}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_cuda: q, k and v must share a device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_cuda: the head dimension must be contiguous")
    if scale is None:
        scale = d**-0.5
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *(t.stride(i) for t in (q, k, v, o) for i in (0, 1, 2))
    )
    err = cuda_lib.lib().t2v_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, sk, d, strides, float(scale),
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_cuda")
    flash_attention.launches += 1
    return o


def sdpa(q, k, v, scale=None):
    """(B, S, H, D) attention dispatcher: flash for the head dims the kernel
    has, `attention` otherwise."""
    if q.shape[-1] in FLASH_HEAD_DIMS:
        return flash_attention(q, k, v, scale)
    return attention(q, k, v, scale=scale)
