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
  anything else; it never falls back. Without a gradient it calls the
  operator `t2v_turbo::flash_attention` (cuda_lib.define_op), whose CUDA
  kernel is `flash_attention_cuda` and whose CPU kernel is `attention`, so
  `torch.export` records the call as one node (`small_seq_attention` too).
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
  wgmma kernels of csrc/flash_attention_sm90.cu; a bf16 forward at head dim
  64 on other views, or whose scale is not positive: the same file's
  `staged` kernel, whose producer realigns each row in registers
  (`staged_row` describes one row's load); other bf16 (the backward on
  views TMA cannot read, the forward at head dim 512 on them or at a scale
  <= 0): `packed`, the wgmma kernels on contiguous copies that the pack
  kernel of csrc/pack_bshd.cu makes (`pack_bshd`, counted on its own;
  `pack_slice` describes one slice's loads); f32: the scalar kernels).
- `small_seq_attention` (B8): the short-sequence kernel of
  csrc/small_seq_attention.cu at Sq = Sk <= 64, head dim 64, forward only
  (the JAX package has no backward for it either); its plain twin is
  `attention`. `ss_plan`, a pure function of the shape, dtype and whether
  bulk copies can read the views, picks its route (`bulk`: a block a (row,
  head group) item, which 1-D bulk copies stage in shared memory;
  `elementwise`: the same math on views off 16 bytes) and the heads of an
  item. It counts `launches`, `by_route` and `by_shape` ((B, S, H)).
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
import functools
from typing import NamedTuple

import torch

from . import cuda_lib

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
FLASH_HEAD_DIMS = (64, 512)
FLASH_BWD_HEAD_DIMS = (64, 512)
# the kernels' route codes, as csrc/flash_mma.cuh's Route enum (the packed
# route launches the wgmma code on its packed copies)
ROUTES = {"f32": 0, "wgmma": 1, "staged": 2}
# The staged forward's producer (csrc/flash_attention_sm90.cu): a warpgroup
# of STAGED_PRODUCER_WARPS warps reads each (row, head) slice of 64 bf16
# (STAGED_ROW_BYTES) as the 16-byte aligned chunks that enclose it and
# stores each output chunk where TMA's 128-byte swizzle puts it in a 64-row
# tile (`staged_row`); `staged_lane_rows` is its map of lanes to rows.
STAGED_ROW_BYTES, STAGED_PRODUCER_WARPS = 128, 4
# The pack kernel (csrc/pack_bshd.cu): 128-byte units, PACK_UNITS a thread,
# blocks of PACK_THREADS; its modes store a slice as is, negated or as zeros.
PACK_UNIT_BYTES, PACK_UNITS, PACK_THREADS = 128, 4, 256
PACK_MODES = {"as_is": 0, "negated": 1, "zero": 2}
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
    """Flash attention on (B, S, H, D). When a gradient is needed: the
    autograd function for a CUDA tensor, `attention` for a CPU one. Else the
    operator `t2v_turbo::flash_attention`: the forward kernel for a CUDA
    tensor, `attention` for a CPU one.

    Replaces t2v_turbo_tpu/ops/attention.py::flash_attention (and
    flash_attention_bshd) with its custom VJP.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if q.device.type == "cpu":
            return attention(q, k, v, scale=scale)
        return FlashAttention.apply(q, k, v, scale)
    return torch.ops.t2v_turbo.flash_attention(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


def _count(wrapper, route, shape):
    """One launch of a flash kernel wrapper: its total, by head dim, by route
    and by (B, H, Sq, Sk, D)."""
    with cuda_lib.COUNT_LOCK:
        wrapper.launches += 1
        wrapper.by_head_dim[shape[-1]] += 1
        wrapper.by_route[route] += 1
        wrapper.by_shape[shape] += 1


def _counters(wrapper):
    wrapper.launches = 0
    wrapper.by_head_dim = collections.Counter()
    wrapper.by_route = collections.Counter()
    wrapper.by_shape = collections.Counter()


_counters(flash_attention)


def flash_attention_cuda(q, k, v, scale=None):
    """Launch the forward kernel (B1) on the route `flash_route` picks
    (csrc/flash_attention_sm90.cu or flash_attention.cu); raises on anything
    no kernel takes."""
    _check_flash("flash_attention_cuda", q, k, v, FLASH_HEAD_DIMS)
    b, sq, h, d = q.shape
    scale = d**-0.5 if scale is None else scale
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    route, (q, k, v, _), strides, code, run_scale = _prepare((q, k, v, o), 3, scale)
    err = cuda_lib.lib().t2v_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, strides,
        float(run_scale), code, cuda_lib.stream_ptr(q.device),
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
    route, (q, k, v, _), strides, code, run_scale = _prepare((q, k, v, o), 3, scale)
    err = cuda_lib.lib().t2v_flash_attention_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d, strides,
        _row_stats_strides(lse), float(run_scale), code, cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, "flash_attention_lse")
    _count(flash_attention_lse, route, (b, h, sq, k.shape[1], d))
    return o, lse


_counters(flash_attention_lse)


def _tma_readable(t, strides):
    """True if TMA can read (B, S, H, D) bf16 tensor t at (batch, seq, head,
    head-dim) strides `strides`: a 16-byte aligned base, (batch, seq, head)
    strides of multiples of 16 bytes (8 bf16 elements)."""
    sb, ss, sh, _ = strides
    return t.data_ptr() % 16 == 0 and sb % 8 == 0 and ss % 8 == 0 and sh % 8 == 0


def _layout(tensors, n_read, fwd_scale=None):
    """(route, strides) of a flash launch on (B, S, H, D) tensors: the C entry
    points' (batch, seq, head) element strides of each tensor, then each
    tensor's head-dim stride (which the staged route checks), and the route.
    "wgmma" for bf16 at head dim 64 or 512 when TMA can read the first
    n_read tensors (the kernels write their outputs, which the wrappers
    allocate, without TMA): a backward (no fwd_scale) at any scale, a
    forward (fwd_scale given) at a positive one (the wgmma forwards' running
    max is over the unscaled logits); "staged" for any other bf16 forward at
    head dim 64; "packed" for any other bf16 (`_prepare`); "f32" for f32.
    One stride() call a tensor: this runs before every launch, and at the
    path's small shapes the host's time per call is the call's time."""
    strides = [t.stride() for t in tensors]
    q = tensors[0]
    if q.dtype == torch.float32:
        route = "f32"
    elif (fwd_scale is None or fwd_scale > 0) and all(
            _tma_readable(t, st) for t, st in zip(tensors[:n_read], strides)):
        route = "wgmma"
    elif q.shape[-1] == 64 and fwd_scale is not None:
        route = "staged"
    else:
        route = "packed"
    vals = [x for st in strides for x in st[:3]] + [st[3] for st in strides]
    return route, (ctypes.c_longlong * len(vals))(*vals)


def _prepare(tensors, n_read, fwd_scale=None):
    """(route, the tensors to launch on, their strides, the kernels' route
    code, the scale the kernels run at) of a flash launch on `tensors` by
    `_layout`'s rule. On the packed route the pack kernel copies each of the
    first n_read tensors that TMA cannot read into a contiguous tensor, and
    the wgmma kernels run on the copies, which they can read. A forward at a
    scale <= 0 always packs q: negated at a scale < 0, run at -scale (the
    same logits, and a max over the raw ones that is the scaled ones'), or
    as zeros at a scale of 0, run at scale 1 (every logit 0)."""
    route, strides = _layout(tensors, n_read, fwd_scale)
    if route != "packed":
        return route, tensors, strides, ROUTES[route], fwd_scale
    out = list(tensors)
    for i, t in enumerate(tensors[:n_read]):
        if i == 0 and fwd_scale is not None and fwd_scale <= 0:
            out[0] = pack_bshd_cuda(t, "negated" if fwd_scale < 0 else "zero")
        elif not _tma_readable(t, t.stride()):
            out[i] = pack_bshd_cuda(t)
    run_scale = fwd_scale if fwd_scale is None or fwd_scale > 0 else -fwd_scale if fwd_scale < 0 else 1.0
    launch, strides = _layout(out, n_read, run_scale)
    if launch != "wgmma":
        raise RuntimeError(f"flash: packed copies take route {launch!r}, not wgmma")
    return route, tuple(out), strides, ROUTES["wgmma"], run_scale


class StagedRow(NamedTuple):
    start: int   # byte address of the first 16-byte aligned chunk read
    chunks: int  # aligned 16-byte chunks read: 8 when the slice is aligned, else 9
    shift: int   # bytes the slice starts past `start`: even, 0..14
    dest: tuple  # byte offset in the 64-row tile of output chunk c = 0..7


def staged_row(addr, tile_row):
    """The staged producer's load of one (row, head) slice of 64 bf16 at
    byte address `addr` (even) that lands on row `tile_row` of a 64 x 64
    tile: the aligned chunks it reads, the shift it realigns them by (bytes
    [shift, shift + 128) of the chunks are the slice), and where each of the
    8 output chunks goes (chunk c of row r at r * 128 + 16 * (c ^ (r % 8)))."""
    if addr % 2 or not 0 <= tile_row < 64:
        raise ValueError(f"staged_row: address {addr}, tile row {tile_row}")
    shift = addr % 16
    dest = tuple(tile_row * STAGED_ROW_BYTES + 16 * (c ^ (tile_row % 8)) for c in range(8))
    return StagedRow(addr - shift, 8 if shift == 0 else 9, shift, dest)


def staged_lane_rows(warp, lane):
    """The staged producer's lane map: the 4 (tile row, output chunk) pairs
    that lane `lane` of producer warp `warp` loads, realigns and stores in
    every tile. A warp instruction takes a group of 4 rows r0 + 8 k + 32 h
    (lane = 8 k + c: row k, chunk c); warp w's groups are (r0, h) in
    {w, w + 4} x {0, 1}."""
    if not (0 <= warp < STAGED_PRODUCER_WARPS and 0 <= lane < 32):
        raise ValueError(f"staged_lane_rows: warp {warp}, lane {lane}")
    k, c = divmod(lane, 8)
    return tuple((warp + 4 * (u % 2) + 8 * k + 32 * (u // 2), c) for u in range(4))


def flash_route(q, k, v, *more, fwd_scale=None):
    """The flash kernels' route, by `_layout`'s rule: a forward on (q, k, v)
    at fwd_scale, or a backward (more = dO)."""
    tensors = (q, k, v) + more
    return _layout(tensors, len(tensors), fwd_scale)[0]


# ---------------------------------------------------------------------------
# the pack kernel (the packed route's copies)
# ---------------------------------------------------------------------------


def pack_bshd_plain(x, mode="as_is"):
    """The pack kernel's plain twin: x as a contiguous (B, S, H, D) tensor,
    negated (mode "negated") or zeros (mode "zero")."""
    if mode == "zero":
        return torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    return (-x if mode == "negated" else x).contiguous()


def pack_bshd(x, mode="as_is"):
    """`pack_bshd_plain` for a CPU tensor, the pack kernel for a CUDA one."""
    if x.device.type == "cpu":
        return pack_bshd_plain(x, mode)
    return pack_bshd_cuda(x, mode)


pack_bshd.launches = 0


def pack_bshd_cuda(x, mode="as_is"):
    """Launch the pack kernel of csrc/pack_bshd.cu on a bf16 (B, S, H, D)
    view (D = 64 or 512, a contiguous head dimension, any (batch, seq, head)
    strides): a new contiguous tensor holding x, -x or zeros (`PACK_MODES`);
    raises on anything the kernel does not take. Counted on `pack_bshd`."""
    what = "pack_bshd_cuda"
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    if x.dim() != 4 or x.shape[-1] not in FLASH_HEAD_DIMS or x.stride(-1) != 1 or mode not in PACK_MODES:
        raise ValueError(f"{what}: shape {tuple(x.shape)}, strides {x.stride()}, mode {mode!r}")
    b, s, h, d = x.shape
    out = torch.empty((b, s, h, d), dtype=x.dtype, device=x.device)
    err = cuda_lib.lib().t2v_pack_bshd(
        x.data_ptr(), out.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], b, s, h, d,
        (ctypes.c_longlong * 4)(*x.stride()), PACK_MODES[mode], cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, what)
    with cuda_lib.COUNT_LOCK:
        pack_bshd.launches += 1
    return out


class PackPiece(NamedTuple):
    start: int   # byte address of the first 16-byte aligned chunk read
    chunks: int  # aligned 16-byte chunks read: 8 when the unit is aligned, else 9
    shift: int   # bytes the unit starts past `start`: even, 0..14
    dest: int    # byte offset of the unit in the slice's contiguous copy


def pack_slice(addr, d):
    """The pack kernel's loads of one (b, s, h) slice of d bf16 (d = 64 or
    512) at byte address `addr` (even): its d / 64 units of 128 bytes, each
    read as the aligned chunks that enclose it (bytes [shift, shift + 128)
    of the chunks are the unit) and stored whole at `dest` in the slice's
    place in the contiguous copy."""
    if addr % 2 or d not in FLASH_HEAD_DIMS:
        raise ValueError(f"pack_slice: address {addr}, head dim {d}")
    shift = addr % 16
    return tuple(PackPiece(addr + PACK_UNIT_BYTES * p - shift, 8 if shift == 0 else 9, shift,
                           PACK_UNIT_BYTES * p) for p in range(d // 64))


def pack_fast_div(d):
    """(m, l) of the kernel's division n / d = (umulhi(n, m) + n) >> l, exact
    for 0 <= n < 2^31 (`FastDiv`)."""
    l = max(d - 1, 0).bit_length()
    return ((1 << 32) * ((1 << l) - d)) // d + 1, l


def pack_unit(i, s, h, d):
    """(b, s, h, unit of the slice) of the pack kernel's unit i of a
    (B, S, H, d) view, by its two divisions: by H * d / 64, then by S."""
    def div(n, by):
        m, l = pack_fast_div(by)
        return (((n * m) >> 32) + n) >> l
    per_row = h * (d // 64)
    row = div(i, per_row)
    j = i - row * per_row
    b = div(row, s)
    return b, row - b * s, j // (d // 64), j % (d // 64)


def pack_lane_units(lane):
    """The pack kernel's lane map: the (unit, 16-byte chunk) that lane
    `lane` of a warp loads, realigns and stores in each of its PACK_UNITS
    instructions, the unit counted from the warp's first (a warp takes
    4 PACK_UNITS consecutive units)."""
    if not 0 <= lane < 32:
        raise ValueError(f"pack_lane_units: lane {lane}")
    k, c = divmod(lane, 8)
    return tuple((4 * u + k, c) for u in range(PACK_UNITS))


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
    route, (q, k, v, do, *_), strides, code, _ = _prepare((q, k, v, do, q, dk, dv), 4)
    err = cuda_lib.lib().t2v_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d,
        strides, lst, float(scale), code,
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
    route, (q, k, v, do, *_), strides, code, _ = _prepare((q, k, v, do, dq, k, v), 4)
    err = cuda_lib.lib().t2v_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype], b, h, sq, k.shape[1], d,
        strides, lst, float(scale), code,
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
    """Self-attention over short sequences on (B, S, H, 64), S <= 64 (B8),
    through the operator `t2v_turbo::small_seq_attention`: `attention` for a
    CPU tensor, the kernel for a CUDA one (forward only).

    Replaces tests_tpu/bench_small_seq_attention.py::small_seq_attention.
    """
    return torch.ops.t2v_turbo.small_seq_attention(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


small_seq_attention.launches = 0
small_seq_attention.by_route = collections.Counter()
small_seq_attention.by_shape = collections.Counter()

# The short-sequence kernel's limits (csrc/small_seq_attention.cu): threads
# a block (a warp a (head, 16-query tile) unit of its item), elements
# padding each staged bf16 row.
SS_MAX_THREADS = 128
SS_PAD = {torch.bfloat16: 8, torch.float32: 0}
SS_ROUTES = {"bulk": 0, "elementwise": 1}
# The plan's choice: the most warps a block. Small blocks, many to an SM,
# measured faster than larger items at every path shape (PERF.md §6).
SS_WARPS = 2


class SsPlan(NamedTuple):
    route: str      # "bulk" or "elementwise"
    heads: int      # heads an item (a group of a row's heads); a block an item
    threads: int    # 32 a (head, 16-query tile) unit of the item
    rows: int       # staged rows of a tensor: 16 * ceil(T / 16) in bf16, T in f32
    pitch: int      # elements between staged rows
    smem: int       # dynamic shared memory a block
    grid: int       # blocks: (row, head group) items


def ss_layout(r, t, h, dtype, route, heads):
    """The launch the kernel makes of (route, heads) on (r, t, h, 64), as
    its C entry derives it; raises on what it refuses."""
    if dtype not in SS_PAD:
        raise TypeError(f"no short-sequence kernel for dtype {dtype}")
    if not 1 <= t <= SMALL_SEQ_MAX or route not in SS_ROUTES:
        raise ValueError(f"ss_layout: T = {t} (at most {SMALL_SEQ_MAX}), route {route!r}")
    kt = -(-t // 16)
    if h % heads or 32 * heads * kt > SS_MAX_THREADS:
        raise ValueError(f"ss_layout: {heads} heads an item of {h} at T = {t}: at most {SS_MAX_THREADS} threads")
    rows = 16 * kt if dtype == torch.bfloat16 else t
    pitch = heads * 64 + SS_PAD[dtype]
    return SsPlan(route, heads, 32 * heads * kt, rows, pitch, 3 * rows * pitch * dtype.itemsize, r * (h // heads))


@functools.lru_cache(maxsize=None)
def ss_plan(r, t, h, dtype=torch.bfloat16, aligned=True):
    """Route and launch of the short-sequence kernel on (r, t, h, 64).

    `aligned`: q, k and v start on 16-byte boundaries with strides of whole
    16-byte pieces, so bulk copies can read them: the `bulk` route;
    otherwise `elementwise` (the item loaded element by element). An item
    is a row's group of `heads` heads: the most heads (a divisor of h) whose
    (head, 16-query tile) units fill at most SS_WARPS warps, else one head.
    A block takes one item."""
    kt = -(-t // 16)
    heads = max(d for d in range(1, h + 1) if h % d == 0 and (d == 1 or d * kt <= SS_WARPS))
    return ss_layout(r, t, h, dtype, "bulk" if aligned else "elementwise", heads)


def ss_readable(*tensors):
    """True if bulk copies can read these (B, S, H, D) tensors: 16-byte
    aligned bases, (batch, seq, head) strides of whole 16-byte pieces."""
    ve = 16 // tensors[0].element_size()
    return all(t.data_ptr() % 16 == 0 and all(st % ve == 0 for st in t.stride()[:3]) for t in tensors)


def small_seq_attention_cuda(q, k, v, scale=None):
    """Launch the kernel of csrc/small_seq_attention.cu on `ss_plan`'s plan;
    raises on anything it does not take."""
    return _ss_launch(q, k, v, scale, None)


def _ss_launch(q, k, v, scale, plan):
    """small_seq_attention_cuda on `plan` (an `ss_layout`; None: `ss_plan`'s),
    which time_small_seq.py --variants times."""
    what = "small_seq_attention_cuda"
    _check_flash(what, q, k, v, (SMALL_SEQ_HEAD_DIM,))
    b, s, h, d = q.shape
    if k.shape[1] != s or not 1 <= s <= SMALL_SEQ_MAX:
        raise ValueError(f"{what}: Sq = {s}, Sk = {k.shape[1]}; the kernel takes Sq == Sk <= {SMALL_SEQ_MAX}")
    scale = d**-0.5 if scale is None else scale
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    plan = plan or ss_plan(b, s, h, q.dtype, ss_readable(q, k, v))
    err = cuda_lib.lib().t2v_small_seq_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), cuda_lib.DTYPE_CODES[q.dtype],
        b, s, h, d, _strides(q, k, v, o), float(scale), SS_ROUTES[plan.route], plan.heads,
        cuda_lib.stream_ptr(q.device),
    )
    cuda_lib.check(err, what)
    with cuda_lib.COUNT_LOCK:
        small_seq_attention.launches += 1
        small_seq_attention.by_route[plan.route] += 1
        small_seq_attention.by_shape[(b, s, h)] += 1
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


def _attention_cpu(q, k, v, scale):
    """The operators' CPU kernel: `attention`, laid out as the kernels' outputs."""
    return attention(q, k, v, scale=scale).contiguous()


def _attention_fake(q, k, v, scale):
    return q.new_empty(q.shape)


cuda_lib.define_op("flash_attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
                   flash_attention_cuda, _attention_cpu, _attention_fake)
cuda_lib.define_op("small_seq_attention(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
                   small_seq_attention_cuda, _attention_cpu, _attention_fake)
