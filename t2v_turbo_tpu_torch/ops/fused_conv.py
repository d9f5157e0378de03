"""GroupNorm(+FiLM)+SiLU+convolution fused (B7): plain PyTorch and the CUDA kernel.

The port's counterpart of t2v_turbo_tpu/ops/fused_conv.py, in the port's
channels-first layout: x is (N, C, H, W), the weight (O, C, kh, kw), stride
1, zero padding of kh // 2, kw // 2 applied AFTER the activation (a halo
element is 0, not silu(b)). It computes

    y = conv(silu(film(group_norm(x))), w) + bias

for the UNet's GroupNorm -> SiLU -> conv pairs: each ResBlock's `in_layers`
and `out_layers`, the four (3,1) stages of each TemporalConvBlock (the clip
(B, C, T, H, W) viewed as (B, C, T, H*W), so the statistics span the clip)
and the `out` head.

- `gn_affine_vectors`: the per-(N, C) f32 a, b with film(group_norm(x)) =
  x*a + b (JAX `_gn_affine_vectors`).
- `fused_gn_silu_conv_plain`: the f32 GroupNorm and affine, the FiLM, the
  SiLU, one cast to x's dtype and `F.conv2d`. The CPU path and the kernel's
  oracle: the activation is rounded where the kernel rounds it.
- `conv_plan`: the launch plan, a pure function of the shape and dtype:
  route (`wgmma` for bf16, `f32`), the bf16 kernel's pixel tile (TR image
  rows x TW columns over all N*H rows, so a tile may span images), its
  output-channel tile BN, the slab size, and the split of the 64-channel
  input chunks that fills the card when the tiles alone would not.
- `fused_gn_silu_conv_cuda`: the launcher: the statistics and a, b from
  the GroupNorm kernel's statistics mode (`norms.group_norm_affine_cuda`:
  one launch), the weight permuted to (O, kh, kw, C), then the fused kernel
  of csrc/fused_conv.cu on the plan. It raises on a CPU tensor or anything
  else the kernels do not take.
- `fused_gn_silu_conv`: the entry point, with a `launches` counter and its
  split `by_route` and `by_shape` ((N, C, H, W, O, kh, kw)); `by_film_shape`
  counts the launches that carried a FiLM. CPU: the plain
  version. CUDA: the kernel, through `FusedGnSiluConv` when an input needs
  a gradient.
- `fused_gn_silu_conv_ab` (with `_cuda` and `_plain`): the fused kernel
  alone on a given (a, b), for the sequence-parallel temporal convs
  (models/layers.py), whose statistics span every seq rank's frames
  (ops/norms.py::group_norm_affine_from_partials) and whose input carries
  the neighbours' halo frames. Its own counters; with a gradient through
  `FusedGnSiluConvAB` (the kernel forward, the plain composition's
  gradient).
- `FusedGnSiluConv`: the forward is the kernel (the plain version on CPU
  tensors, so the backward runs in the CPU tests) and keeps only the inputs;
  the backward is the unfused composition's gradient, as JAX `_fused_bwd`:
  it recomputes h = silu(film(group_norm(x))) under autograd, takes the
  conv's part with `conv2d_input` / `conv2d_weight` and the bias's with a
  sum, and back-propagates dh through h. Under remat only x is kept.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_lib
from .norms import group_norm_affine_cuda, group_norm_f32, group_stats


def _check_film(film_scale, film_shift):
    if (film_scale is None) != (film_shift is None):
        raise ValueError(
            "film_scale and film_shift must be given together "
            f"(got scale={'set' if film_scale is not None else 'None'}, "
            f"shift={'set' if film_shift is not None else 'None'})"
        )


def gn_affine_vectors(x, gn_scale, gn_bias, num_groups=32, eps=1e-5, film_scale=None,
                      film_shift=None):
    """(a, b), each (N, C) f32: film(group_norm(x)) = x*a + b per (sample,
    channel), with the FiLM film(h) = h*(1 + film_scale) + film_shift."""
    _check_film(film_scale, film_shift)
    n, c = x.shape[:2]
    mean, rstd = (t.reshape(n, num_groups).repeat_interleave(c // num_groups, dim=1)
                  for t in group_stats(x, num_groups, eps))
    a = rstd * gn_scale.float()
    b = gn_bias.float() - mean * a
    if film_scale is not None:
        s = 1.0 + film_scale.float()
        a, b = a * s, b * s + film_shift.float()
    return a, b


def _activated(x, gn_scale, gn_bias, num_groups, eps, film_scale, film_shift):
    """silu(film(group_norm(x))) in f32, cast once to x's dtype."""
    h = group_norm_f32(x, gn_scale, gn_bias, num_groups, eps)
    if film_scale is not None:
        h = h * (1.0 + film_scale.float()[:, :, None, None]) + film_shift.float()[:, :, None, None]
    return F.silu(h).to(x.dtype)


def _padding(conv_kernel):
    return conv_kernel.shape[-2] // 2, conv_kernel.shape[-1] // 2


def fused_gn_silu_conv_plain(x, gn_scale, gn_bias, conv_kernel, conv_bias=None, num_groups=32,
                             eps=1e-5, film_scale=None, film_shift=None):
    """Plain conv(silu(film(group_norm(x)))) + bias on (N, C, H, W)."""
    _check_film(film_scale, film_shift)
    h = _activated(x, gn_scale, gn_bias, num_groups, eps, film_scale, film_shift)
    bias = None if conv_bias is None else conv_bias.to(x.dtype)
    return F.conv2d(h, conv_kernel.to(x.dtype), bias, padding=_padding(conv_kernel))


# The bf16 kernel's fixed sizes (csrc/fused_conv.cu): pixels a block,
# input channels a chunk, slab positions a buffer, SMs of the H100.
PIXELS, CHUNK, MAX_SLAB, SMS = 128, 64, 480, 132


class ConvPlan(NamedTuple):
    route: str             # "wgmma" (bf16) or "f32"
    bn: int = 0            # output channels a block: 160, or 32 for O <= 32
    tw: int = 0            # pixel tile: tw columns ...
    tr: int = 0            # ... of tr image rows, counted over all N*H rows
    npos: int = 0          # slab positions a buffer: the most any tile needs
    chunks_per_split: int = 0
    splits: int = 1        # a cluster of that many CTAs adds its f32 sums in split order
    grid: tuple = ()       # (pixel tiles, output-channel tiles, splits)


def _ext(r, h, kh):
    """Extended row of image row r (of all N*H): each image's h rows stand
    between its kh // 2 halo rows above and below."""
    return (r // h) * (h + kh - 1) + r % h + kh // 2


def slab_positions(n, h, kh, kw, tw, tr):
    """The most slab positions a tile of tr rows x tw columns needs: the
    extended rows its image rows span, with the halo, tw + kw - 1 wide. The
    pattern repeats every h tiles; the clipped last tile needs fewer."""
    rows = n * h
    most = 0
    for r0 in range(0, min(rows, tr * h), tr):
        last = min(r0 + tr, rows) - 1
        most = max(most, (_ext(last, h, kh) - _ext(r0, h, kh) + kh) * (tw + kw - 1))
    return most


@functools.lru_cache(maxsize=None)
def conv_plan(n, c, h, w, o, kh, kw, dtype=torch.bfloat16):
    """Tiles, grid and route of the fused conv on (n, c, h, w) -> o channels.

    bf16: BN = 160 output channels a block (it divides 320, 640 and 1280;
    32 when o <= 32). The pixel tile is tw columns x tr rows (tr * tw <= 128,
    the slab at most 480 positions): of the widths 16, 32, 64, 128 and w
    itself (up to w; w itself when w < 16) the one with the least
    tiles x (128 + positions / 4), i.e. the fewest blocks first, then the
    least staging.

    The input channels' 64-wide chunks may be split over 2, 4 or 8 blocks:
    the splits of a tile are one thread block cluster, which adds their f32
    sums in split order in shared memory. One block an SM, so a launch takes
    ceil(blocks / 132) waves of blocks that each stream their chunks plus
    about one chunk's worth of fill and epilogue, and a split costs about
    two chunks more a doubling (the cluster's sum; clusters of 3, 5 or 6
    packed the card worse). The split with the least waves x (chunks a
    split + 1 + 2 log2 splits) wins, the smaller on a tie. So, as measured
    on the H100 (PERF.md), the level-3 temporal conv (48 blocks) runs 2
    splits, 96 blocks in one wave, rather than 4 in two, and the 10x16
    convs run 2 splits, not 4.
    """
    if dtype == torch.float32:
        return ConvPlan("f32")
    if dtype != torch.bfloat16:
        raise TypeError(f"conv_plan: no kernel for dtype {dtype}")
    bn = 32 if o <= 32 else 160
    widths = sorted({min(w, t) for t in (16, 32, 64, 128)} | ({w} if w <= PIXELS else set()))
    best = None
    for tw in widths:
        tr = PIXELS // tw
        while tr > 1 and slab_positions(n, h, kh, kw, tw, tr) > MAX_SLAB:
            tr -= 1
        npos = slab_positions(n, h, kh, kw, tw, tr)
        tiles = math.ceil(n * h / tr) * math.ceil(w / tw)
        score = tiles * (PIXELS + npos / 4)
        if best is None or score < best[0]:
            best = (score, tw, tr, npos, tiles)
    _, tw, tr, npos, tiles = best
    blocks = tiles * math.ceil(o / bn)
    chunks = math.ceil(c / CHUNK)
    cost = []
    for splits in (1, 2, 4, 8):
        cps = math.ceil(chunks / splits)
        if math.ceil(chunks / cps) == splits:
            waves = math.ceil(blocks * splits / SMS)
            cost.append((waves * (cps + 1 + 2 * math.log2(splits)), splits, cps))
    _, splits, cps = min(cost)
    return ConvPlan("wgmma", bn, tw, tr, npos, cps, splits, (tiles, math.ceil(o / bn), splits))


def _f32_vector(t, shape, device, what):
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if tuple(t.shape) != shape:
        raise ValueError(f"fused_gn_silu_conv_cuda: {what} of shape {tuple(t.shape)}, expected {shape}")
    return t


def _check_conv_inputs(what, x, conv_kernel, conv_bias):
    """B7's refusals of x, the kernel and the bias -> (n, c, hh, ww, o, kh, kw)."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported by the kernel")
    if x.dim() != 4 or conv_kernel.dim() != 4:
        raise ValueError(f"{what}: x {tuple(x.shape)} and kernel {tuple(conv_kernel.shape)} must be 4-d")
    n, c, hh, ww = x.shape
    o, ci, kh, kw = conv_kernel.shape
    if ci != c or (kh, kw) not in ((3, 3), (3, 1)):
        raise ValueError(f"{what}: kernel {tuple(conv_kernel.shape)} for {c} input channels "
                         "(the UNet's 3x3 and (3,1) convs)")
    if n > 65535:
        raise ValueError(f"{what}: bad shape {tuple(x.shape)}: at most 65535 images")
    tensors = [conv_kernel] + ([] if conv_bias is None else [conv_bias])
    if any(t.dtype != x.dtype or t.device != x.device for t in tensors):
        raise TypeError(f"{what}: the kernel and bias must have x's dtype {x.dtype} and device")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous x")
    if x.dtype == torch.bfloat16 and (c % 8 or x.numel() >= 2**31):
        raise ValueError(f"{what}: the bf16 kernel streams channels in runs of 8 and indexes x with "
                         f"32-bit offsets; x {tuple(x.shape)}")
    if conv_bias is not None and tuple(conv_bias.shape) != (o,):
        raise ValueError(f"{what}: bias of shape {tuple(conv_bias.shape)}, expected ({o},)")
    return n, c, hh, ww, o, kh, kw


def _launch_conv(what, x, a, b, conv_kernel, conv_bias, shape):
    """The fused kernel of csrc/fused_conv.cu on x with the (N, C) f32 a, b
    -> (y, the plan's route)."""
    n, c, hh, ww, o, kh, kw = shape
    y = torch.empty((n, o, hh, ww), dtype=x.dtype, device=x.device)
    w_ohwc = conv_kernel.permute(0, 2, 3, 1).contiguous()  # one tap's channels are one TMA row
    plan = conv_plan(n, c, hh, ww, o, kh, kw, x.dtype)
    err = cuda_lib.lib().t2v_gn_silu_conv_fwd(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w_ohwc.data_ptr(),
        None if conv_bias is None else conv_bias.data_ptr(), y.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], n, c, hh,
        ww, o, kh, kw, plan.bn, plan.tw, plan.tr, plan.npos, plan.chunks_per_split, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, what)
    return y, plan.route


def fused_gn_silu_conv_cuda(x, gn_scale, gn_bias, conv_kernel, conv_bias=None, num_groups=32,
                            eps=1e-5, film_scale=None, film_shift=None):
    """Launch the statistics kernel and the fused kernel; raises on anything
    they do not take."""
    what = "fused_gn_silu_conv_cuda"
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    _check_film(film_scale, film_shift)
    shape = _check_conv_inputs(what, x, conv_kernel, conv_bias)
    n, c, hh, ww = shape[:4]
    if c % num_groups or (c // num_groups) * hh * ww >= 2**31:
        raise ValueError(f"{what}: bad shape {tuple(x.shape)} for {num_groups} groups")
    gs = _f32_vector(gn_scale, (c,), x.device, "gn_scale")
    gb = _f32_vector(gn_bias, (c,), x.device, "gn_bias")
    film = [None, None]
    if film_scale is not None:
        film = [_f32_vector(t, (n, c), x.device, name)
                for t, name in ((film_scale, "film_scale"), (film_shift, "film_shift"))]
    a, b = group_norm_affine_cuda(x, gs, gb, num_groups, eps, *film)
    y, route = _launch_conv(what, x, a, b, conv_kernel, conv_bias, shape)
    with cuda_lib.COUNT_LOCK:
        fused_gn_silu_conv.launches += 1
        fused_gn_silu_conv.by_route[route] += 1
        fused_gn_silu_conv.by_shape[shape] += 1
        if film_scale is not None:
            fused_gn_silu_conv.by_film_shape[shape] += 1
    return y


def fused_gn_silu_conv_ab_plain(x, a, b, conv_kernel, conv_bias=None):
    """Plain conv(silu(x*a + b)) + bias on (N, C, H, W) with given (N, C) f32
    a, b (the activation cast once to x's dtype, as the kernel rounds it)."""
    h = F.silu(x.float() * a.float()[:, :, None, None] + b.float()[:, :, None, None]).to(x.dtype)
    bias = None if conv_bias is None else conv_bias.to(x.dtype)
    return F.conv2d(h, conv_kernel.to(x.dtype), bias, padding=_padding(conv_kernel))


def fused_gn_silu_conv_ab_cuda(x, a, b, conv_kernel, conv_bias=None):
    """Launch the fused kernel alone on given (a, b): the statistics come
    from elsewhere (a seq-sharded clip's, ops/norms.py's
    group_norm_affine_from_partials). B7's refusals hold."""
    what = "fused_gn_silu_conv_ab_cuda"
    shape = _check_conv_inputs(what, x, conv_kernel, conv_bias)
    n, c = shape[:2]
    a = _f32_vector(a, (n, c), x.device, "a")
    b = _f32_vector(b, (n, c), x.device, "b")
    y, route = _launch_conv(what, x, a, b, conv_kernel, conv_bias, shape)
    with cuda_lib.COUNT_LOCK:
        fused_gn_silu_conv_ab.launches += 1
        fused_gn_silu_conv_ab.by_route[route] += 1
        fused_gn_silu_conv_ab.by_shape[shape] += 1
    return y


class FusedGnSiluConvAB(torch.autograd.Function):
    """B7 on given (a, b) forward (the plain version on CPU tensors), keeping
    only the inputs; the backward recomputes h = silu(x*a + b) at the
    kernel's rounding point and takes the conv's part with `conv2d_input` /
    `conv2d_weight`, the bias's with a sum (JAX `_fused_bwd`'s rule with the
    statistics given)."""

    @staticmethod
    def forward(ctx, x, a, b, conv_kernel, conv_bias):
        ctx.save_for_backward(x, a, b, conv_kernel, conv_bias)
        run = fused_gn_silu_conv_ab_plain if x.device.type == "cpu" else fused_gn_silu_conv_ab_cuda
        return run(x, a, b, conv_kernel, conv_bias)

    @staticmethod
    def backward(ctx, g):
        x, a, b, w, bias = ctx.saved_tensors
        needs = ctx.needs_input_grad
        leaves = [t.detach().requires_grad_(n) for t, n in zip((x, a, b), needs)]
        wanted = [i for i in range(3) if needs[i]]
        with torch.enable_grad():
            h = F.silu(leaves[0].float() * leaves[1].float()[:, :, None, None]
                       + leaves[2].float()[:, :, None, None]).to(x.dtype)
        pad = _padding(w)
        grads = [None] * 5
        if needs[3]:
            grads[3] = torch.nn.grad.conv2d_weight(h.detach(), w.shape, g, padding=pad).to(w.dtype)
        if needs[4] and bias is not None:
            grads[4] = g.sum(dim=(0, 2, 3)).to(bias.dtype)
        if wanted:
            dh = torch.nn.grad.conv2d_input(h.shape, w.to(h.dtype), g, padding=pad)
            for i, gi in zip(wanted, torch.autograd.grad(h, [leaves[i] for i in wanted], dh)):
                grads[i] = gi
        return tuple(grads)


def fused_gn_silu_conv_ab(x, a, b, conv_kernel, conv_bias=None):
    """y = conv(silu(x*a + b)) + bias on (N, C, H, W), fused, for given a, b.
    CPU: the plain version; CUDA: `fused_gn_silu_conv_ab_cuda`, counted in
    `launches`, `by_route`, `by_shape`; through `FusedGnSiluConvAB` when an
    input needs a gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, a, b, conv_kernel, conv_bias)):
        return FusedGnSiluConvAB.apply(x, a, b, conv_kernel, conv_bias)
    if x.device.type == "cpu":
        return fused_gn_silu_conv_ab_plain(x, a, b, conv_kernel, conv_bias)
    return fused_gn_silu_conv_ab_cuda(x, a, b, conv_kernel, conv_bias)


fused_gn_silu_conv_ab.launches = 0
fused_gn_silu_conv_ab.by_route = collections.Counter()
fused_gn_silu_conv_ab.by_shape = collections.Counter()


class FusedGnSiluConv(torch.autograd.Function):
    """The fused forward with the unfused composition's gradient (JAX
    `_fused_op`'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, gn_scale, gn_bias, conv_kernel, conv_bias, film_scale, film_shift,
                num_groups, eps):
        ctx.save_for_backward(x, gn_scale, gn_bias, conv_kernel, conv_bias, film_scale, film_shift)
        ctx.cfg = (num_groups, eps)
        run = fused_gn_silu_conv_plain if x.device.type == "cpu" else fused_gn_silu_conv_cuda
        return run(x, gn_scale, gn_bias, conv_kernel, conv_bias, num_groups, eps, film_scale, film_shift)

    @staticmethod
    def backward(ctx, g):
        x, gs, gb, w, bias, fs, fsh = ctx.saved_tensors
        needs = ctx.needs_input_grad
        # the inputs of h = silu(film(gn(x))): x, the GN affine, the FiLM
        h_in = {0: x, 1: gs, 2: gb, 5: fs, 6: fsh}
        leaves = {i: t.detach().requires_grad_(needs[i]) for i, t in h_in.items() if t is not None}
        wanted = [i for i in leaves if needs[i]]
        with torch.enable_grad():
            h = _activated(leaves[0], leaves[1], leaves[2], *ctx.cfg, leaves.get(5), leaves.get(6))
        pad = _padding(w)
        grads = [None] * 9
        if needs[3]:
            grads[3] = torch.nn.grad.conv2d_weight(h.detach(), w.shape, g, padding=pad).to(w.dtype)
        if needs[4] and bias is not None:
            grads[4] = g.sum(dim=(0, 2, 3)).to(bias.dtype)
        if wanted:
            dh = torch.nn.grad.conv2d_input(h.shape, w.to(h.dtype), g, padding=pad)
            for i, gi in zip(wanted, torch.autograd.grad(h, [leaves[i] for i in wanted], dh)):
                grads[i] = gi
        return tuple(grads)


def fused_gn_silu_conv(x, gn_scale, gn_bias, conv_kernel, conv_bias=None, num_groups=32, eps=1e-5,
                       film_scale=None, film_shift=None):
    """y = conv(silu(film(group_norm(x)))) + bias on (N, C, H, W), fused.

    CPU: `fused_gn_silu_conv_plain`. CUDA: the kernel, through
    `FusedGnSiluConv` when an input needs a gradient. Without a gradient,
    through the operator `t2v_turbo::fused_gn_silu_conv`, whose kernels are
    `fused_gn_silu_conv_cuda` (the statistics launch included) and the
    plain version. Replaces
    t2v_turbo_tpu/ops/fused_conv.py::fused_gn_silu_conv.
    """
    _check_film(film_scale, film_shift)
    args = (x, gn_scale, gn_bias, conv_kernel, conv_bias, num_groups, eps, film_scale, film_shift)
    inputs = (x, gn_scale, gn_bias, conv_kernel, conv_bias, film_scale, film_shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        if x.device.type == "cpu":
            return fused_gn_silu_conv_plain(*args)
        return FusedGnSiluConv.apply(x, gn_scale, gn_bias, conv_kernel, conv_bias, film_scale,
                                     film_shift, num_groups, eps)
    return torch.ops.t2v_turbo.fused_gn_silu_conv(*args)


fused_gn_silu_conv.launches = 0
fused_gn_silu_conv.by_route = collections.Counter()
fused_gn_silu_conv.by_shape = collections.Counter()
fused_gn_silu_conv.by_film_shape = collections.Counter()  # the launches with a FiLM


def _conv_fake(x, gn_scale, gn_bias, conv_kernel, *rest):
    return x.new_empty((x.shape[0], conv_kernel.shape[0], *x.shape[2:]))


cuda_lib.define_op("fused_gn_silu_conv(Tensor x, Tensor gn_scale, Tensor gn_bias, Tensor conv_kernel, "
                   "Tensor? conv_bias, int num_groups, float eps, Tensor? film_scale, Tensor? film_shift) -> Tensor",
                   fused_gn_silu_conv_cuda, fused_gn_silu_conv_plain, _conv_fake)
