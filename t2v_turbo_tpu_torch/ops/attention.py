"""Attention: plain PyTorch math, the CUDA flash-attention kernels, and `sdpa`.

Tensors are (B, S, H, D) ("BSHD"), the layout the q/k/v Linears produce, as
in the JAX package's `attention_xla_bshd` / `sdpa_bshd`
(t2v_turbo_tpu/ops/attention.py).

- `attention`: the reference semantics of `attention_xla(_bshd)`: f32 logits
  and softmax, an optional additive bias and causal mask, the probabilities
  cast to v's dtype before the product, optional `return_probs`. It is the
  path for short, biased or causal attention and the flash kernels' oracle.
  It uses matmul and softmax, never F.scaled_dot_product_attention.
- `flash_attention`: `attention` for a CPU tensor. For a CUDA tensor, the
  hand-written kernels of csrc/: when q, k or v needs a gradient, the
  `FlashAttention` autograd function (forward with log-sum-exp, then the
  two backward kernels), else the plain forward kernel. It raises on
  anything else; it never falls back.
- The kernel wrappers, each with its plain twin (run for CPU tensors, and
  the card's oracle) and a `launches` counter:
  `flash_attention` (B1: forward; counters on `flash_attention`),
  `flash_attention_lse` (B2: forward + lse),
  `flash_attention_bwd_dkv` and `flash_attention_bwd_dq` (B3). The kernels
  take (batch, seq, head) strides, so the same wrappers are the BSHD family
  (B6) of the JAX package. Each also counts its launches by head dim
  (`by_head_dim`) and by route (`by_route`), and the two forwards by shape
  (`by_shape`, (B, H, Sq, Sk, D)). All four pick their route with
  `flash_route` (bf16 on tensors TMA can read, at head dims 64 and 512: the
  wgmma kernels of csrc/flash_attention_sm90.cu; other bf16, and a forward
  whose scale is not positive: the mma.sync kernels; f32: the scalar ones).
- `small_seq_attention` (B8): the short-sequence kernel of
  csrc/small_seq_attention.cu, one warp per (batch, head) at Sq = Sk <= 64,
  head dim 64, forward only (the JAX package has no backward for it either);
  its plain twin is `attention`.
- `sdpa`: the dispatcher for unbiased, non-causal attention.
  Self-shaped calls (Sq == Sk <= 64, head dim 64) that need no gradient go
  to `small_seq_attention`: on the main path that is the temporal
  self-attention over 16 frames (`attn1` and `attn2` of every
  TemporalTransformer, `init_attn` included), in serving and in the LCD
  teacher and target passes; B1's 64-row tiles would spend 75% of their
  work on padding there. Every other call whose head dim the flash kernels
  have (64 and 512) goes to flash: the spatial self-attention at every
  level, the cross-attention to the 77 text tokens, the VAE mid-block, and
  the temporal attention when it needs a gradient (the student's
  forward). The JAX package gated flash at Sq, Sk >= 1024 (XLA won below on
  the TPU); on the H100 the kernel beat the plain path at every one of
  those shapes (PERF.md), so the flash gate is the head dim alone. The
  causal CLIP tower calls `attention` directly. The backward kernels take
  both head dims: the UNet's and ViCLIP's heads of 64 and the VAE
  decoder's one head of 512, which reward feedback differentiates.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from . import cuda_lib

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_HEAD_DIMS = (64, 512)
FLASH_BWD_HEAD_DIMS = (64, 512)
# the kernels' routes, as csrc/flash_mma.cuh's Route codes
ROUTES = {"mma": 0, "f32": 0, "wgmma": 1}
SMALL_SEQ_HEAD_DIM, SMALL_SEQ_MAX = 64, 64


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


# ---------------------------------------------------------------------------
# plain twins of the training kernels (B2, B3)
# ---------------------------------------------------------------------------


def _logits(q, k, scale):
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def attention_lse_plain(q, k, v, scale):
    """(o, lse): `attention` and the (B, H, Sq) f32 log-sum-exp of its logits."""
    logits = _logits(q, k, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1).to(v.dtype), v).to(q.dtype)
    return out, torch.logsumexp(logits, -1)


def attention_bwd_delta(do, o):
    """delta = rowsum(dO * O) in f32, (B, H, Sq): the backward's row term
    (JAX `_flash_attention_bwd_impl`, computed outside its kernels)."""
    return torch.einsum("bqhd,bqhd->bhq", do.float(), o.float()).contiguous()


def _bwd_terms(q, k, v, do, lse, delta, scale):
    p = torch.exp(_logits(q, k, scale) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale):
    """(dk, dv) from the saved lse: P = exp(s - lse), dV = P^T dO,
    dS = P (dO V^T - delta), dK = scale dS^T Q (JAX `_flash_bwd_dkv_kernel`)."""
    p, ds = _bwd_terms(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_dq_plain(q, k, v, do, lse, delta, scale):
    """dq = scale dS K from the saved lse (JAX `_flash_bwd_dq_kernel`)."""
    _, ds = _bwd_terms(q, k, v, do, lse, delta, scale)
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_flash(what, q, k, v, head_dims, *more):
    """Raise unless the kernels take these (B, S, H, D) tensors."""
    if q.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {q.device}")
    b, _, h, d = q.shape
    tensors = (q, k, v) + more
    dtype, device = q.dtype, q.device
    if dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {dtype} not supported")
    if d not in head_dims:
        raise ValueError(f"{what}: head dim {d} not in {head_dims}")
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}")
    # one loop, not a generator per check: this runs before every launch, and
    # at the path's small shapes the host's time per call is the call's time
    for i, t in enumerate(tensors):
        if t.dtype != dtype:
            raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]} not supported")
        if i > 2 and t.shape != q.shape:
            raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}")
        if t.device != device:
            raise ValueError(f"{what}: the tensors must share a device")
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: the head dimension must be contiguous")


def _strides(*tensors):
    """(batch, seq, head) element strides of each (B, S, H, D) tensor."""
    vals = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _row_stats_strides(lse):
    """(batch, head) strides of a (B, H, Sq) f32 row-statistics tensor."""
    sb, sh, ss = lse.stride()
    if lse.dtype != torch.float32 or ss != 1:
        raise ValueError("row statistics must be f32 with a contiguous sequence")
    return (ctypes.c_longlong * 2)(sb, sh)


def flash_attention(q, k, v, scale=None):
    """Flash attention on (B, S, H, D): `attention` for a CPU tensor; for a
    CUDA tensor the autograd function when a gradient is needed, else the
    forward kernel.

    Replaces t2v_turbo_tpu/ops/attention.py::flash_attention (and
    flash_attention_bshd) with its custom VJP.
    """
    if q.device.type == "cpu":
        return attention(q, k, v, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_attention_cuda(q, k, v, scale)


def _count(wrapper, route, shape):
    """One launch of a flash kernel wrapper: its total, by head dim, by route
    and, for the forwards, by (B, H, Sq, Sk, D)."""
    wrapper.launches += 1
    wrapper.by_head_dim[shape[-1]] += 1
    wrapper.by_route[route] += 1
    if hasattr(wrapper, "by_shape"):
        wrapper.by_shape[shape] += 1


def _counters(wrapper, shapes=False):
    wrapper.launches = 0
    wrapper.by_head_dim = collections.Counter()
    wrapper.by_route = collections.Counter()
    if shapes:
        wrapper.by_shape = collections.Counter()


_counters(flash_attention, shapes=True)


def flash_attention_cuda(q, k, v, scale=None):
    """Launch the forward kernel (B1) on the route `flash_route` picks
    (csrc/flash_attention_sm90.cu or flash_attention.cu); raises on anything
    no kernel takes."""
    _check_flash("flash_attention_cuda", q, k, v, FLASH_HEAD_DIMS)
    b, sq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    route, strides = _layout((q, k, v, o), 3, scale)
    err = cuda_lib.lib().t2v_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, strides,
        float(scale), ROUTES[route], cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_cuda")
    _count(flash_attention, route, (b, h, sq, k.shape[1], d))
    return o


def flash_attention_lse(q, k, v, scale=None):
    """(o, lse (B, H, Sq) f32): the forward with log-sum-exp (B2) for a CUDA
    tensor, `attention_lse_plain` for a CPU tensor.

    Replaces t2v_turbo_tpu/ops/attention.py::_flash_attention_fwd_lse_impl.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_lse_plain(q, k, v, scale)
    _check_flash("flash_attention_lse", q, k, v, FLASH_HEAD_DIMS)
    b, sq, h, d = q.shape
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    route, strides = _layout((q, k, v, o), 3, scale)
    err = cuda_lib.lib().t2v_flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, strides,
        _row_stats_strides(lse), float(scale), ROUTES[route], cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_lse")
    _count(flash_attention_lse, route, (b, h, sq, k.shape[1], d))
    return o, lse


_counters(flash_attention_lse, shapes=True)


def _layout(tensors, n_read, fwd_scale=None):
    """(route, strides) of a flash launch on (B, S, H, D) tensors: the C entry
    points' (batch, seq, head) element strides of each tensor, and the route.
    "wgmma" for bf16 at head dim 64 or 512 when TMA can read the first
    n_read tensors (16-byte aligned bases, strides of multiples of 16 bytes;
    the kernels write their outputs, which the wrappers allocate, without
    TMA): a backward (no fwd_scale) at any scale, a forward (fwd_scale
    given) at a positive one (the wgmma forwards' running max is over the
    unscaled logits); "f32" for f32; else "mma". One stride() call a tensor: this runs before
    every launch, and at the path's small shapes the host's time per call is
    the call's time."""
    strides = [t.stride() for t in tensors]
    q = tensors[0]
    wgmma_shape = q.shape[-1] in (64, 512) and (fwd_scale is None or fwd_scale > 0)
    if q.dtype == torch.float32:
        route = "f32"
    elif q.dtype == torch.bfloat16 and wgmma_shape and all(
            t.data_ptr() % 16 == 0 and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0  # bf16: 8 elements a 16 bytes
            for t, (sb, ss, sh, _) in zip(tensors[:n_read], strides)):
        route = "wgmma"
    else:
        route = "mma"
    vals = [x for st in strides for x in st[:3]]
    return route, (ctypes.c_longlong * len(vals))(*vals)


def flash_route(q, k, v, *more, fwd_scale=None):
    """The flash kernels' route, by `_layout`'s rule: a forward on (q, k, v)
    at fwd_scale, or a backward (more = dO)."""
    tensors = (q, k, v) + more
    return _layout(tensors, len(tensors), fwd_scale)[0]


def _bwd_args(what, q, k, v, do, lse, delta):
    _check_flash(what, q, k, v, FLASH_BWD_HEAD_DIMS, do)
    b, sq, h, _ = q.shape
    for t in (lse, delta):
        if t.shape != (b, h, sq) or t.device != q.device:
            raise ValueError(f"{what}: row statistics of shape {tuple(t.shape)}, expected {(b, h, sq)}")
    if delta.stride() != lse.stride():
        raise ValueError(f"{what}: lse and delta must share strides")
    return _row_stats_strides(lse)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=None):
    """(dk, dv): the dK/dV backward kernel (B3) for a CUDA tensor,
    `attention_bwd_dkv_plain` for a CPU tensor.

    Replaces t2v_turbo_tpu/ops/attention.py::_flash_bwd_dkv_kernel.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    lst = _bwd_args("flash_attention_bwd_dkv", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dk, dv = (torch.empty(k.shape, dtype=k.dtype, device=k.device) for _ in range(2))
    route, strides = _layout((q, k, v, do, q, dk, dv), 4)
    err = cuda_lib.lib().t2v_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d,
        strides, lst, float(scale), ROUTES[route],
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_bwd_dkv")
    _count(flash_attention_bwd_dkv, route, (b, h, sq, k.shape[1], d))
    return dk, dv


_counters(flash_attention_bwd_dkv)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=None):
    """dq: the dQ backward kernel (B3) for a CUDA tensor,
    `attention_bwd_dq_plain` for a CPU tensor.

    Replaces t2v_turbo_tpu/ops/attention.py::_flash_bwd_dq_kernel.
    """
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if q.device.type == "cpu":
        return attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    lst = _bwd_args("flash_attention_bwd_dq", q, k, v, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    route, strides = _layout((q, k, v, do, dq, k, v), 4)
    err = cuda_lib.lib().t2v_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d,
        strides, lst, float(scale), ROUTES[route],
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_bwd_dq")
    _count(flash_attention_bwd_dq, route, (b, h, sq, k.shape[1], d))
    return dq


_counters(flash_attention_bwd_dq)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward, as `flash_attention`'s custom VJP
    (t2v_turbo_tpu/ops/attention.py:1020-1057): the forward keeps
    (q, k, v, o, lse); the backward forms delta = rowsum(dO * O) in f32 and
    runs the dK/dV and dQ kernels. On CPU tensors the wrappers run their
    plain twins, so the same function runs (and is tested) there."""

    @staticmethod
    def forward(ctx, q, k, v, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        o, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        delta = attention_bwd_delta(do, o)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def small_seq_attention(q, k, v, scale=None):
    """Self-attention over short sequences on (B, S, H, 64), S <= 64 (B8):
    `attention` for a CPU tensor, the kernel for a CUDA one (forward only).

    Replaces tests_tpu/bench_small_seq_attention.py::small_seq_attention.
    """
    if q.device.type == "cpu":
        return attention(q, k, v, scale=scale)
    return small_seq_attention_cuda(q, k, v, scale)


small_seq_attention.launches = 0


def small_seq_attention_cuda(q, k, v, scale=None):
    """Launch the kernel of csrc/small_seq_attention.cu; raises on anything
    it does not take."""
    what = "small_seq_attention_cuda"
    _check_flash(what, q, k, v, (SMALL_SEQ_HEAD_DIM,))
    b, s, h, d = q.shape
    if k.shape[1] != s or not 1 <= s <= SMALL_SEQ_MAX:
        raise ValueError(f"{what}: Sq = {s}, Sk = {k.shape[1]}; the kernel takes Sq == Sk <= {SMALL_SEQ_MAX}")
    scale = d**-0.5 if scale is None else scale
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    err = cuda_lib.lib().t2v_small_seq_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype],
        b, s, h, d, _strides(q, k, v, o), float(scale), cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, what)
    small_seq_attention.launches += 1
    return o


def _small_seq(q, k, v):
    """True for self-shaped, short, head-dim-64 calls that need no gradient."""
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    return (q.shape[-1] == SMALL_SEQ_HEAD_DIM and q.shape[1] == k.shape[1] <= SMALL_SEQ_MAX
            and not needs_grad)


def sdpa(q, k, v, scale=None):
    """(B, S, H, D) attention dispatcher: the short-sequence kernel for
    self-shaped calls at S <= 64 without a gradient, flash for the other
    calls at the head dims it has, `attention` otherwise."""
    if _small_seq(q, k, v):
        return small_seq_attention(q, k, v, scale)
    if q.shape[-1] in FLASH_HEAD_DIMS:
        return flash_attention(q, k, v, scale)
    return attention(q, k, v, scale=scale)
