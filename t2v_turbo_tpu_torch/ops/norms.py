"""GroupNorm and LayerNorm (optionally + SiLU): plain PyTorch, the CUDA kernels and their launch plans.

Semantics are the JAX package's (`t2v_turbo_tpu/ops/norms.py`, the reference
GroupNorm32): f32 statistics, the mean first and then the centred variance,
the affine in f32, the optional activation, and the result cast back to the
input dtype.

Layout: `group_norm` takes channels-first tensors (N, C, *spatial), the
layout the port's models run in; statistics are per (sample, group) over
(C/G, *spatial), one contiguous row of L = (C/G) * S elements. The
TemporalTransformer and TemporalConvBlock pass the whole clip (B, C, T, H,
W), so their statistics span all frames; the per-frame call sites pass
(B*T, C, H, W). `layer_norm` normalises the last axis.

Dispatch: `group_norm` / `layer_norm` call the hand-written kernels
(`csrc/norms.cu`) through `fused_group_norm` / `fused_layer_norm`. Those
wrappers run the plain version only for a tensor on the CPU; a CUDA tensor
goes to the kernel, or the wrapper raises. Calls that need no gradient go
through the operators `t2v_turbo::group_norm` / `t2v_turbo::layer_norm`
(cuda_lib.define_op: the launcher for CUDA, the plain version for the CPU),
which `torch.export` records as nodes. Each wrapper counts its kernel
launches in `launches`, split by route in `by_route` and by shape in
`by_shape`. `group_norm_affine_cuda` is the GroupNorm kernel's statistics
mode for the fused GroupNorm+SiLU+conv (ops/fused_conv.py), with the same
counters.

Plans: `gn_plan` and `ln_plan` are pure functions of the shape and dtype
(and whether the pointers are 16-byte aligned) that pick each kernel's
route and launch shape; the wrappers pass the plan to the C entry points,
which run it or refuse it. GroupNorm's routes: `cta` (a row, or several
tiny rows, staged whole in one block's shared memory), `cluster` (a row
split over a thread-block cluster of up to 16 blocks that exchange partial
sums through distributed shared memory; the VAE's largest rows hold part of
each chunk and re-read the rest from L2), `split` (rows too few to fill the
card, the whole-clip norms: a launch of per-chunk partials, then one that
combines them and re-reads x from L2) and `elementwise` (misaligned
pointers or a spatial size that is not a multiple of the 16-byte vector).
The statistics mode takes `cta` or `cluster`. LayerNorm's:
`vector` (each row read once into registers as 16-byte vectors) and
`elementwise`.

Sequence parallelism: a clip sharded along T over seq ranks normalises
with the whole clip's statistics through the split route's two halves as
entries of their own: `group_norm_partials` (this rank's chunk partials and
their element counts), gathered over the seq ranks
(parallel/collectives.py), then `group_norm_from_partials` (B4's apply) or
`group_norm_affine_from_partials` (B7's (a, b)). Each has a plain twin and
counters. With a gradient each goes through an `autograd.Function`
(`_PartialsFn`, `_FromPartialsFn`, `_AffineFromPartialsFn`): the forward
is the kernel, the backward the plain twin's math recomputed and
differentiated; the counts carry no gradient.

Gradients: when an input needs one, a CUDA call goes through an
`autograd.Function` whose forward is the kernel and whose backward
differentiates the plain version on the saved (x, weight, bias), as the JAX
package's `_gn_bwd` / `_ln_bwd` do (t2v_turbo_tpu/ops/fused_norms.py); the
TPU has no backward kernel for the norms either.
"""

from __future__ import annotations

import collections
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import cuda_lib


def apply_act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act is None:
        return y
    if act == "silu":
        return F.silu(y)
    raise ValueError(f"unsupported fused activation: {act}")


def _act_code(act: Optional[str]) -> int:
    if act not in (None, "silu"):
        raise ValueError(f"unsupported fused activation: {act}")
    return 1 if act == "silu" else 0


def group_stats(x, num_groups, eps):
    """Per-(sample, group) f32 mean and rstd of (N, C, *spatial), each (N, G, 1)."""
    n, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return mean, torch.rsqrt(var + eps)


def group_norm_f32(x, weight, bias, num_groups=32, eps=1e-5):
    """GroupNorm with its affine on (N, C, *spatial), left in f32."""
    n, c = x.shape[:2]
    mean, rstd = group_stats(x, num_groups, eps)
    xf = ((x.float().reshape(n, num_groups, -1) - mean) * rstd).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return xf * weight.float().reshape(shape) + bias.float().reshape(shape)


def group_norm_plain(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """Plain GroupNorm(+act) on (N, C, *spatial); the kernel's oracle."""
    return apply_act(group_norm_f32(x, weight, bias, num_groups, eps), act).to(x.dtype)


def layer_norm_plain(x, weight, bias, eps=1e-5, act=None):
    """Plain LayerNorm(+act) over the last axis; the kernel's oracle."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float() + bias.float()
    return apply_act(y, act).to(x.dtype)


def _affine(t: torch.Tensor, c: int, device) -> torch.Tensor:
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if t.shape != (c,):
        raise ValueError(f"affine parameter of shape {tuple(t.shape)}, expected ({c},)")
    return t


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"{what}: dtype {x.dtype} is not supported by the kernel")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the kernel needs a contiguous tensor")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plain_vjp(plain, ctx, dy):
    """Gradients of `plain(x, weight, bias, *ctx.cfg)` at the saved inputs."""
    needs = ctx.needs_input_grad[:3]
    inputs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
    with torch.enable_grad():
        y = plain(*inputs, *ctx.cfg)
    grads = iter(torch.autograd.grad(y, [t for t, n in zip(inputs, needs) if n], dy))
    return tuple(next(grads) if n else None for n in needs)


class _GroupNormFn(torch.autograd.Function):
    """Kernel forward, plain-math backward (JAX `_gn_fwd` / `_gn_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, act)
        return group_norm_cuda(x, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        return _plain_vjp(group_norm_plain, ctx, dy) + (None, None, None)


class _LayerNormFn(torch.autograd.Function):
    """Kernel forward, plain-math backward (JAX `_ln_fwd` / `_ln_bwd`)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, act):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (eps, act)
        return layer_norm_cuda(x, weight, bias, eps, act)

    @staticmethod
    def backward(ctx, dy):
        return _plain_vjp(layer_norm_plain, ctx, dy) + (None, None)


# The H100's and the staged GroupNorm kernel's limits (csrc/norms.cu): SMs,
# shared memory an SM has and a block may use, the kernel's static reserve
# (plus the 1 KB the card reserves a block), threads an SM, barriers (rows x
# pieces) and rows a block, blocks a cluster (above 8 non-portable).
SMS, SM_THREADS = 132, 2048
SMEM_SM, SMEM_BLOCK = 233472, 232448
GN_STATIC_SMEM = 1024
GN_MAX_THREADS, GN_MAX_BARS, GN_MAX_ROWS = 512, 32, 16
GN_MAX_CLUSTER, GN_PORTABLE_CLUSTER = 16, 8
# The plan's choices: the blocks an SM it aims at, the bytes the blocks on
# the card may re-read from L2 (a block reads its re-read part three times
# within its life), the smallest chunk a row is split into only to fill the
# SMs, bytes a bulk copy.
GN_BLOCKS_PER_SM = 4
GN_L2_BUDGET = 20 * 2**20
GN_STATS_L2 = 32 * 2**20  # the statistics mode holds nothing for a tensor up to this size
GN_MIN_SPLIT = 8 * 1024
GN_PIECE = 16 * 1024
GN_ROUTES = {"cta": 0, "cluster": 1, "split": 2, "elementwise": 3}
# The split route's blocks: threads, the 16-byte vectors a thread the kernel
# takes (csrc/norms.cu); the largest tensor it takes (its second launch
# re-reads x from L2).
GN_SPLIT_THREADS, GN_SPLIT_VECS = 256, (2, 4)
GN_SPLIT_L2 = 32 * 2**20
GN_STAGED = ("cta", "cluster")


class GnPlan(NamedTuple):
    route: str       # "cta", "cluster", "split" or "elementwise"
    k: int = 1       # blocks a row: the cluster's size (split: the row's chunks)
    chunk: int = 0   # elements of a row a block takes; the last block of a row takes the rest
    staged: int = 0  # of which the first `staged` are held in shared memory, the rest re-read
    rows: int = 1    # rows a block (cta only)
    threads: int = 0
    pieces: int = 1  # bulk copies (one mbarrier each) the held part of a row arrives in
    smem: int = 0    # shared memory a block, the static reserve included
    grid: int = 0    # blocks

    @property
    def nonportable(self) -> bool:
        """A cluster above the portable 8 blocks (the kernel allows it)."""
        return self.k > GN_PORTABLE_CLUSTER


def _vector(dtype) -> int:
    """Elements of `dtype` in a 16-byte vector."""
    if dtype not in cuda_lib.DTYPE_CODES:
        raise TypeError(f"no norm kernel for dtype {dtype}")
    return 16 // dtype.itemsize


def _chunk(l, k, ve):
    """Elements a block takes when k blocks share a row of l: ceil(l / k) in
    whole vectors, or None unless every one of the k chunks is non-empty."""
    chunk = -(-(-(-l // k)) // ve) * ve
    return chunk if (k - 1) * chunk < l else None


def _held_bytes(per_sm):
    """The most bytes a block may hold for `per_sm` blocks to share an SM."""
    return (SMEM_SM // per_sm - GN_STATIC_SMEM - 1024) // 16 * 16


def staged_plan(rows_total, e, k, chunk, staged, rows=1):
    """The `cta` (k = 1) or `cluster` plan holding `staged` of each block's
    `chunk` elements (of e bytes), `rows` rows a block (k = 1 only).
    Threads: a power of two from 128 to 512, about an eighth of the block's
    held vectors, at most an SM's threads over the blocks an SM holds;
    pieces: 16 KB a bulk copy when a block holds more than 48 KB."""
    ve = 16 // e
    eighth = max(1, rows * staged // ve // 8)
    per_sm = min(32, SMEM_SM // (rows * staged * e + GN_STATIC_SMEM + 1024))
    threads = max(128, 32 * rows, min(GN_MAX_THREADS, SM_THREADS // per_sm, 1 << (eighth.bit_length() - 1)))
    pieces = max(1, min(GN_MAX_BARS // rows, -(-staged * e // GN_PIECE))) if staged * e > 48 * 1024 else 1
    return GnPlan("cta" if k == 1 else "cluster", k, chunk, staged, rows, threads, pieces,
                  rows * staged * e + GN_STATIC_SMEM, -(-rows_total // rows) * k)


def split_plan(rows_total, l, e, vecs=GN_SPLIT_VECS[-1]):
    """The `split` plan: chunks of GN_SPLIT_THREADS x `vecs` vectors."""
    chunk = GN_SPLIT_THREADS * vecs * (16 // e)
    k = -(-l // chunk)
    return GnPlan("split", k, chunk, 0, 1, GN_SPLIT_THREADS, 1, 0, rows_total * k)


@functools.lru_cache(maxsize=None)
def gn_plan(n, c, g, s, dtype=torch.bfloat16, aligned=True, stats=False):
    """Route and launch shape of the GroupNorm kernel on (n, c, s) in g groups
    (`stats`: its statistics mode).

    `aligned`: x and y start on 16-byte boundaries. The staged routes need
    that and s a multiple of the 16-byte vector; otherwise `elementwise`.
    A row of l = (c / g) * s elements is split into k = 1, 2, 4, 8 or 16
    chunks of whole vectors (power-of-two clusters pack the card's GPCs). The
    plan takes the smallest k whose chunk fits GN_BLOCKS_PER_SM blocks an
    SM, held whole. Failing that (the VAE's largest rows), k = 16 and each
    block holds the first `staged` elements of its chunk in shared memory
    and re-reads the rest from L2: as much as the most blocks an SM
    (GN_BLOCKS_PER_SM, then fewer, down to one block holding all its shared
    memory) may hold while the re-read parts of the blocks on the card stay
    within GN_L2_BUDGET. While the rows' blocks would not fill the SMs, k
    doubles (chunks of at least GN_MIN_SPLIT). k = 1 is `cta`: tiny rows
    then share a block (up to 8 KB of them, if twice the SMs' worth of
    blocks remain). Threads and pieces: `staged_plan`. A cluster plan for
    fewer rows than SMs (the whole-clip norms), on a tensor of at most
    GN_SPLIT_L2 bytes, becomes `split_plan`: there the clusters all load at
    once and each waits for its slowest block (PERF.md §6). Its chunks are
    4 vectors a thread, or 2 where 4 would give under GN_BLOCKS_PER_SM
    blocks an SM.

    The statistics mode reads x twice (no y): for a tensor of at most
    GN_STATS_L2 bytes it holds nothing and re-reads from L2, with k doubled
    while the rows' blocks would not fill the SMs (chunks of at least
    GN_MIN_SPLIT); larger tensors take the plan above.
    """
    ve = _vector(dtype)
    e = 16 // ve
    rows_total, l = n * g, (c // g) * s
    if not aligned or s % ve:
        return GnPlan("elementwise", grid=rows_total)
    chunks = {k: chunk for k in (1, 2, 4, 8, 16) if (chunk := _chunk(l, k, ve)) is not None}
    if stats and n * c * s * e <= GN_STATS_L2:
        k = 1
        while rows_total * k < SMS and 2 * k in chunks and chunks[2 * k] * e >= GN_MIN_SPLIT:
            k *= 2
        return GnPlan("cta" if k == 1 else "cluster", k, chunks[k], 0, 1, 256, 1, GN_STATIC_SMEM,
                      rows_total * k)
    whole = _held_bytes(GN_BLOCKS_PER_SM) // e
    k = next((k for k in sorted(chunks) if chunks[k] <= whole), None)
    if k is not None:
        staged = chunks[k]
    else:
        k = max(chunks)
        for per_sm in range(GN_BLOCKS_PER_SM, 0, -1):
            staged = min(chunks[k], _held_bytes(per_sm) // e // ve * ve)
            if SMS * per_sm * (chunks[k] - staged) * e <= GN_L2_BUDGET:
                break
    while rows_total * k < SMS and 2 * k in chunks and chunks[2 * k] * e >= GN_MIN_SPLIT:
        k *= 2
        staged = min(chunks[k], staged)
    chunk, rows = chunks[k], 1
    if k == 1 and staged == chunk:
        while (2 * rows <= GN_MAX_ROWS and 2 * rows * l * e <= GN_MIN_SPLIT
               and -(-rows_total // (2 * rows)) >= 2 * SMS):
            rows *= 2
        staged = chunk = l
    if k > 1 and rows_total < SMS and n * c * s * e <= GN_SPLIT_L2:
        plan = split_plan(rows_total, l, e)
        return plan if plan.grid >= GN_BLOCKS_PER_SM * SMS else split_plan(rows_total, l, e, GN_SPLIT_VECS[0])
    return staged_plan(rows_total, e, k, chunk, staged, rows)


@functools.lru_cache(maxsize=None)
def _clusters_fit(plan: GnPlan, dtype, stats: bool) -> int:
    """Once a plan: how many of its clusters the card runs at once; raises
    if it cannot run one (the launch would be refused)."""
    n = cuda_lib.lib().t2v_group_norm_max_clusters(cuda_lib.DTYPE_CODES[dtype], int(stats), plan.k,
                                                   plan.staged, plan.rows, plan.threads)
    if n < 0:
        cuda_lib.check(-n, "group norm cluster occupancy")
    if n == 0:
        raise RuntimeError(f"the card cannot run a cluster of {plan.k} blocks of {plan.threads} threads and "
                           f"{plan.smem} bytes of shared memory ({plan})")
    return n


def _launch_args(plan: GnPlan, x, dtype, stats, n, c, g, s):
    """(scratch, (route code, k, chunk, staged, rows, threads, pieces)) for the
    C entry points; the split and element-wise routes' f32 scratch stays
    alive on `x`'s stream until it is freed (the caching allocator orders
    reuse)."""
    if plan.route == "cluster":
        _clusters_fit(plan, dtype, stats)
    scratch = None
    if plan.route in ("split", "elementwise"):
        size = 2 * n * g * plan.k if plan.route == "split" else cuda_lib.lib().t2v_group_norm_scratch(n, c, g, s)
        scratch = torch.empty(size, dtype=torch.float32, device=x.device)
    return scratch, (GN_ROUTES[plan.route], plan.k, plan.chunk, plan.staged, plan.rows, plan.threads, plan.pieces)


def _count(wrapper, route, shape):
    with cuda_lib.COUNT_LOCK:
        wrapper.launches += 1
        wrapper.by_route[route] += 1
        wrapper.by_shape[shape] += 1


def _counters(wrapper):
    wrapper.launches = 0
    wrapper.by_route = collections.Counter()
    wrapper.by_shape = collections.Counter()


def _group_shape(x, num_groups, what):
    n, c = x.shape[:2]
    if x.dim() < 3 or c % num_groups:
        raise ValueError(f"{what}: bad shape {tuple(x.shape)} for {num_groups} groups")
    s = math.prod(x.shape[2:])
    if (c // num_groups) * s >= 2**31:
        raise ValueError(f"{what}: a group of 2^31 elements or more")
    return n, c, s


def fused_group_norm(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) on a contiguous (N, C, *spatial) tensor.

    CUDA: the kernel of csrc/norms.cu on `gn_plan`'s route (any group size;
    no shape gate), through `_GroupNormFn` when an input needs a gradient.
    CPU: `group_norm_plain`. Without a gradient, through the operator
    `t2v_turbo::group_norm`, whose kernels are these two.
    Replaces t2v_turbo_tpu/ops/fused_norms.py::fused_group_norm.
    """
    if _needs_grad(x, weight, bias):
        if x.device.type == "cpu":
            return group_norm_plain(x, weight, bias, num_groups, eps, act)
        return _GroupNormFn.apply(x, weight, bias, num_groups, eps, act)
    return torch.ops.t2v_turbo.group_norm(x, weight, bias, num_groups, eps, act)


_counters(fused_group_norm)


def group_norm_cuda(x, weight, bias, num_groups=32, eps=1e-5, act=None, plan=None):
    """Launch the GroupNorm kernel of csrc/norms.cu on `plan` (by default
    `gn_plan`'s); raises on what it does not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_cuda: no kernel for device {x.device}")
    _check_cuda_input(x, "group_norm_cuda")
    n, c, s = _group_shape(x, num_groups, "group_norm_cuda")
    w, b = _affine(weight, c, x.device), _affine(bias, c, x.device)
    plan = plan or gn_plan(n, c, num_groups, s, x.dtype, x.data_ptr() % 16 == 0)
    scratch, plan_args = _launch_args(plan, x, x.dtype, False, n, c, num_groups, s)
    y = torch.empty_like(x)
    err = cuda_lib.lib().t2v_group_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), None if scratch is None else scratch.data_ptr(),
        cuda_lib.DTYPE_CODES[x.dtype], n, c, num_groups, s, eps, _act_code(act), *plan_args,
        cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "group_norm_cuda")
    _count(fused_group_norm, plan.route, tuple(x.shape))
    return y


def group_norm_affine_cuda(x, gn_scale, gn_bias, num_groups=32, eps=1e-5, film_scale=None, film_shift=None,
                           plan=None):
    """(a, b), each (N, C) f32, with film(group_norm(x)) = x*a + b: the
    GroupNorm kernel's statistics mode, on `plan` (by default `gn_plan`'s), for the fused
    GroupNorm+SiLU+conv. x: (N, C, *spatial) contiguous on the card;
    gn_scale, gn_bias: (C,) f32 and the FiLM (N, C) f32 (or both None), on
    x's device (ops/fused_conv.py checks them). Counts its launches as
    `fused_group_norm` does, and those with a FiLM in `by_film_shape`. The plain version is
    `ops.fused_conv.gn_affine_vectors`."""
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_affine_cuda: no kernel for device {x.device}")
    _check_cuda_input(x, "group_norm_affine_cuda")
    n, c, s = _group_shape(x, num_groups, "group_norm_affine_cuda")
    plan = plan or gn_plan(n, c, num_groups, s, x.dtype, x.data_ptr() % 16 == 0, stats=True)
    scratch, plan_args = _launch_args(plan, x, x.dtype, True, n, c, num_groups, s)
    a, b = (torch.empty((n, c), dtype=torch.float32, device=x.device) for _ in range(2))
    film = [None if t is None else t.data_ptr() for t in (film_scale, film_shift)]
    err = cuda_lib.lib().t2v_group_norm_affine(
        x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(), *film, a.data_ptr(), b.data_ptr(),
        None if scratch is None else scratch.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], n, c, num_groups, s,
        eps, *plan_args, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "group_norm_affine_cuda")
    _count(group_norm_affine_cuda, plan.route, tuple(x.shape))
    if film_scale is not None:
        with cuda_lib.COUNT_LOCK:
            group_norm_affine_cuda.by_film_shape[tuple(x.shape)] += 1
    return a, b


_counters(group_norm_affine_cuda)
group_norm_affine_cuda.by_film_shape = collections.Counter()  # the launches with a FiLM


# ---- GroupNorm over a clip sharded along T: the split route's two halves ----
# A clip (B, C, T, H, W) split over seq ranks along T holds, on each rank, a
# part of every (sample, group) row. `group_norm_partials` gives this rank's
# f32 partials of each row's chunks, (sum, sum of squares about the chunk's
# own mean), with each chunk's element count; parallel/collectives.py's
# gather_partials concatenates every rank's in rank order; then
# `group_norm_from_partials` normalises this rank's part (B4's apply) and
# `group_norm_affine_from_partials` folds them into B7's (a, b), both with
# the whole clip's statistics. The counts travel with the partials: once
# several ranks' chunks are concatenated, a rank's short last chunk sits in
# the middle of the row, where the apply kernel cannot infer its size.


def partials_plan(n, c, g, s, dtype=torch.bfloat16) -> GnPlan:
    """The `split` plan the partials and apply entries run on (n, c, s): the
    chunking `gn_plan` gives the whole-clip norms (4 vectors a thread, or 2
    where 4 would give under GN_BLOCKS_PER_SM blocks an SM)."""
    e = 16 // _vector(dtype)
    rows, l = n * g, (c // g) * s
    plan = split_plan(rows, l, e)
    return plan if plan.grid >= GN_BLOCKS_PER_SM * SMS else split_plan(rows, l, e, GN_SPLIT_VECS[0])


@functools.lru_cache(maxsize=None)
def _chunk_counts(l, chunk, device):
    """(P,) int32 on `device`: the elements of each chunk of a row of l (the
    last the rest); made once a shape, so a launch copies nothing to the card."""
    return torch.tensor([min(chunk, l - q * chunk) for q in range(-(-l // chunk))], dtype=torch.int32, device=device)


def group_norm_partials_plain(x, num_groups=32, chunk=None):
    """(parts (N*G, P, 2) f32, counts (P,) int32) of (N, C, *spatial): each
    row's chunks of `chunk` elements (the last the rest; default:
    `partials_plan`'s), their sum and sum of squares about their own mean."""
    n, c, s = _group_shape(x, num_groups, "group_norm_partials")
    l = (c // num_groups) * s
    chunk = chunk or partials_plan(n, c, num_groups, s, x.dtype).chunk
    p = -(-l // chunk)
    counts = _chunk_counts(l, chunk, x.device)
    xf = F.pad(x.float().reshape(n * num_groups, l), (0, p * chunk - l)).view(-1, p, chunk)
    valid = torch.arange(chunk, device=x.device)[None, :] < counts[:, None]
    sums = xf.sum(-1)
    dev = torch.where(valid, xf - (sums / counts)[..., None], 0.0)
    return torch.stack([sums, dev.square().sum(-1)], -1), counts


def _stats_from_partials(parts, counts, eps):
    """Each row's (mean, rstd), (R,) each, from its chunks' partials: the
    mean, then the centred sum of squares as the chunks' sums plus n_r (m_r -
    mean)^2 (the kernels' combination)."""
    n_r = counts.to(parts.device, torch.float32)
    total = n_r.sum()
    mean = parts[..., 0].sum(-1) / total
    dr = parts[..., 0] / n_r - mean[:, None]
    var = (parts[..., 1] + n_r * dr * dr).sum(-1) / total
    return mean, torch.rsqrt(var + eps)


def group_norm_from_partials_plain(x, parts, counts, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) of (N, C, *spatial) with the statistics of `parts`."""
    n, c = x.shape[:2]
    mean, rstd = (t.view(n, num_groups, 1) for t in _stats_from_partials(parts, counts, eps))
    y = ((x.float().reshape(n, num_groups, -1) - mean) * rstd).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    return apply_act(y * weight.float().reshape(shape) + bias.float().reshape(shape), act).to(x.dtype)


def group_norm_affine_from_partials_plain(parts, counts, weight, bias, num_groups=32, eps=1e-5, film_scale=None,
                                          film_shift=None):
    """(a, b), each (N, C) f32, with film(group_norm(x)) = x*a + b for the
    statistics of `parts` ((N*G, P, 2)); B7's fold (ops.fused_conv.gn_affine_vectors)."""
    c = weight.shape[0]
    n = parts.shape[0] // num_groups
    mean, rstd = (t.view(n, num_groups).repeat_interleave(c // num_groups, dim=1)
                  for t in _stats_from_partials(parts, counts, eps))
    a = rstd * weight.float()
    b = bias.float() - mean * a
    if film_scale is not None:
        s = 1.0 + film_scale.float()
        a, b = a * s, b * s + film_shift.float()
    return a, b


def _split_ready(x, num_groups, what):
    """(n, c, s, plan) of a CUDA input the split kernels take; raises otherwise."""
    if x.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {x.device}")
    _check_cuda_input(x, what)
    n, c, s = _group_shape(x, num_groups, what)
    if x.data_ptr() % 16 or s % _vector(x.dtype):
        raise ValueError(f"{what}: the split kernels read 16-byte vectors: x must be 16-byte aligned with a "
                         f"spatial size that is whole vectors; x {tuple(x.shape)}")
    plan = partials_plan(n, c, num_groups, s, x.dtype)
    if plan.k > 65535:
        raise ValueError(f"{what}: {plan.k} chunks a row (at most 65535)")
    return n, c, s, plan


def _partials_ready(parts, counts, rows, device, what):
    if parts.dtype != torch.float32 or parts.dim() != 3 or parts.shape[0] != rows or parts.shape[2] != 2:
        raise ValueError(f"{what}: partials of shape {tuple(parts.shape)} {parts.dtype}, expected ({rows}, P, 2) f32")
    if counts.dtype != torch.int32 or tuple(counts.shape) != (parts.shape[1],):
        raise ValueError(f"{what}: counts of shape {tuple(counts.shape)} {counts.dtype}, expected ({parts.shape[1]},) "
                         "int32")
    if parts.device != device or counts.device != device or not (parts.is_contiguous() and counts.is_contiguous()):
        raise ValueError(f"{what}: partials and counts must be contiguous on {device}")


def group_norm_partials_cuda(x, num_groups=32):
    """Launch the split route's partials kernel (csrc/norms.cu
    gn_split_part_kernel) alone -> (parts, counts) as the plain version."""
    what = "group_norm_partials_cuda"
    n, c, s, plan = _split_ready(x, num_groups, what)
    parts = torch.empty((n * num_groups, plan.k, 2), dtype=torch.float32, device=x.device)
    err = cuda_lib.lib().t2v_group_norm_partials(x.data_ptr(), parts.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], n, c,
                                                 num_groups, s, plan.chunk, plan.k, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, what)
    _count(group_norm_partials, plan.route, tuple(x.shape))
    return parts, _chunk_counts((c // num_groups) * s, plan.chunk, x.device)


def group_norm_from_partials_cuda(x, parts, counts, weight, bias, num_groups=32, eps=1e-5, act=None):
    """Launch the split route's apply kernel (gn_split_apply_kernel) on x
    with the statistics of `parts` / `counts` (explicit: any number of
    chunks of any sizes, e.g. every seq rank's)."""
    what = "group_norm_from_partials_cuda"
    n, c, s, plan = _split_ready(x, num_groups, what)
    _partials_ready(parts, counts, n * num_groups, x.device, what)
    w, b = _affine(weight, c, x.device), _affine(bias, c, x.device)
    y = torch.empty_like(x)
    err = cuda_lib.lib().t2v_group_norm_from_partials(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), parts.data_ptr(), counts.data_ptr(), parts.shape[1],
        cuda_lib.DTYPE_CODES[x.dtype], n, c, num_groups, s, eps, _act_code(act), plan.chunk, plan.k,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, what)
    _count(group_norm_from_partials, plan.route, tuple(x.shape))
    return y


def group_norm_affine_from_partials_cuda(parts, counts, weight, bias, num_groups=32, eps=1e-5, film_scale=None,
                                         film_shift=None):
    """Launch gn_partials_affine_kernel: B7's (a, b) from `parts` / `counts`,
    one warp a row combining its partials in the apply kernel's order."""
    what = "group_norm_affine_from_partials_cuda"
    if parts.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {parts.device}")
    c = weight.shape[0]
    if parts.dim() != 3 or c % num_groups or parts.shape[0] % num_groups:
        raise ValueError(f"{what}: partials {tuple(parts.shape)} for {c} channels in {num_groups} groups")
    n = parts.shape[0] // num_groups
    _partials_ready(parts, counts, n * num_groups, parts.device, what)
    w, b = _affine(weight, c, parts.device), _affine(bias, c, parts.device)
    film = [None, None]
    if (film_scale is None) != (film_shift is None):
        raise ValueError(f"{what}: film_scale and film_shift must be given together")
    if film_scale is not None:
        film = [t.to(parts.device, torch.float32).contiguous() for t in (film_scale, film_shift)]
        if any(tuple(t.shape) != (n, c) for t in film):
            raise ValueError(f"{what}: the FiLM must be ({n}, {c})")
    a_out, b_out = (torch.empty((n, c), dtype=torch.float32, device=parts.device) for _ in range(2))
    err = cuda_lib.lib().t2v_group_norm_affine_from_partials(
        parts.data_ptr(), counts.data_ptr(), parts.shape[1], w.data_ptr(), b.data_ptr(),
        *[None if t is None else t.data_ptr() for t in film], a_out.data_ptr(), b_out.data_ptr(), n, c, num_groups,
        eps, cuda_lib.stream_ptr(parts.device))
    cuda_lib.check(err, what)
    _count(group_norm_affine_from_partials, "warp", (n, c, parts.shape[1]))
    return a_out, b_out


def _split_vjp(plain, ctx, grads_out, n_inputs):
    """Gradients of `plain(*saved inputs, *ctx.cfg)` at the saved inputs, None
    for every input whose `needs_input_grad` is false (and for the int
    counts), through the outputs that carry a cotangent."""
    needs = ctx.needs_input_grad[:n_inputs]
    saved = ctx.saved_tensors
    leaves = [t if t is None or not n else t.detach().requires_grad_() for t, n in zip(saved, needs)]
    wanted = [i for i, n in enumerate(needs) if n]
    with torch.enable_grad():
        outs = plain(*leaves, *ctx.cfg)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, g) for o, g in zip(outs, grads_out) if g is not None and o.requires_grad]
    got = torch.autograd.grad([o for o, _ in pairs], [leaves[i] for i in wanted], [g for _, g in pairs],
                              allow_unused=True, materialize_grads=True)
    grads = [None] * n_inputs
    for i, g in zip(wanted, got):
        grads[i] = g
    return tuple(grads)


class _PartialsFn(torch.autograd.Function):
    """B4's partials kernel forward (the plain version on a CPU tensor),
    the plain partials' gradient backward."""

    @staticmethod
    def forward(ctx, x, num_groups):
        ctx.save_for_backward(x)
        ctx.cfg = (num_groups,)
        run = group_norm_partials_plain if x.device.type == "cpu" else group_norm_partials_cuda
        parts, counts = run(x, num_groups)
        counts = counts.clone()  # not the shape's cached tensor
        ctx.mark_non_differentiable(counts)
        return parts, counts

    @staticmethod
    def backward(ctx, dparts, _dcounts):
        return _split_vjp(lambda x, g: group_norm_partials_plain(x, g)[0], ctx, (dparts,), 1) + (None,)


class _FromPartialsFn(torch.autograd.Function):
    """B4's apply kernel forward, the plain apply's gradient backward (to x,
    the partials and the affine)."""

    @staticmethod
    def forward(ctx, x, parts, counts, weight, bias, num_groups, eps, act):
        ctx.save_for_backward(x, parts, counts, weight, bias)
        ctx.cfg = (num_groups, eps, act)
        run = group_norm_from_partials_plain if x.device.type == "cpu" else group_norm_from_partials_cuda
        return run(x, parts, counts, weight, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, dy):
        return _split_vjp(group_norm_from_partials_plain, ctx, (dy,), 5) + (None, None, None)


class _AffineFromPartialsFn(torch.autograd.Function):
    """B7's (a, b) fold forward, the plain fold's gradient backward (to the
    partials, the affine and the FiLM)."""

    @staticmethod
    def forward(ctx, parts, counts, weight, bias, film_scale, film_shift, num_groups, eps):
        ctx.save_for_backward(parts, counts, weight, bias, film_scale, film_shift)
        ctx.cfg = (num_groups, eps)
        run = group_norm_affine_from_partials_plain if parts.device.type == "cpu" else \
            group_norm_affine_from_partials_cuda
        return run(parts, counts, weight, bias, num_groups, eps, film_scale, film_shift)

    @staticmethod
    def backward(ctx, da, db):
        def plain(parts, counts, weight, bias, film_scale, film_shift, num_groups, eps):
            return group_norm_affine_from_partials_plain(parts, counts, weight, bias, num_groups, eps, film_scale,
                                                         film_shift)

        return _split_vjp(plain, ctx, (da, db), 6) + (None, None)


def group_norm_partials(x, num_groups=32):
    """(parts, counts) of x's (sample, group) rows, chunked as `partials_plan`
    says. CUDA: `group_norm_partials_cuda`; CPU: the plain version; through
    `_PartialsFn` when x needs a gradient."""
    if _needs_grad(x):
        return _PartialsFn.apply(x, num_groups)
    if x.device.type == "cpu":
        return group_norm_partials_plain(x, num_groups)
    return group_norm_partials_cuda(x, num_groups)


def group_norm_from_partials(x, parts, counts, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) of x with the statistics of `parts` / `counts`. CUDA:
    the kernel; CPU: the plain version; through `_FromPartialsFn` when an
    input needs a gradient."""
    if _needs_grad(x, parts, weight, bias):
        return _FromPartialsFn.apply(x, parts, counts, weight, bias, num_groups, eps, act)
    if x.device.type == "cpu":
        return group_norm_from_partials_plain(x, parts, counts, weight, bias, num_groups, eps, act)
    return group_norm_from_partials_cuda(x, parts, counts, weight, bias, num_groups, eps, act)


def group_norm_affine_from_partials(parts, counts, weight, bias, num_groups=32, eps=1e-5, film_scale=None,
                                    film_shift=None):
    """B7's (a, b) for the statistics of `parts` / `counts`. CUDA: the
    kernel; CPU: the plain version; through `_AffineFromPartialsFn` when an
    input needs a gradient."""
    if _needs_grad(*(t for t in (parts, weight, bias, film_scale, film_shift) if t is not None)):
        return _AffineFromPartialsFn.apply(parts, counts, weight, bias, film_scale, film_shift, num_groups, eps)
    if parts.device.type == "cpu":
        return group_norm_affine_from_partials_plain(parts, counts, weight, bias, num_groups, eps, film_scale,
                                                     film_shift)
    return group_norm_affine_from_partials_cuda(parts, counts, weight, bias, num_groups, eps, film_scale, film_shift)


for _fn in (group_norm_partials, group_norm_from_partials, group_norm_affine_from_partials):
    _counters(_fn)

# The LayerNorm kernel's limits (csrc/norms.cu): threads a block, 16-byte
# vectors a lane holds.
LN_THREADS, LN_MAX_VECS = 256, 10


class LnPlan(NamedTuple):
    route: str       # "vector" or "elementwise"
    lanes: int = 0   # lanes a row (a power of two; 32 / lanes rows a warp)
    vecs: int = 0    # 16-byte vectors a lane holds
    rows_per_block: int = 0
    grid: int = 0


@functools.lru_cache(maxsize=None)
def ln_plan(rows, c, dtype=torch.bfloat16, aligned=True):
    """Route and launch shape of the LayerNorm kernel on (rows, c).

    `aligned`: x, y, weight and bias start on 16-byte boundaries. The vector
    route holds a row's v = c / (16-byte vector) vectors in `lanes` lanes:
    the fewest lanes (a power of two) that divide v into at most 5 vectors a
    lane, else at most LN_MAX_VECS; else 32 lanes with the last vectors
    masked. While the rows' lanes would not fill the card's threads, the
    lanes double (the last vectors masked): at (10240, 640) bf16, 32 lanes
    of 3 vectors measured faster than 16 of 5 (PERF.md §6).
    Misaligned, c not whole vectors, or too long a row -> `elementwise` (a
    warp a row)."""
    ve = _vector(dtype)
    v = c // ve
    if aligned and c % ve == 0:
        for most in (5, LN_MAX_VECS):
            lanes = next((n for n in (1, 2, 4, 8, 16, 32) if v % n == 0 and v // n <= most), None)
            if lanes:
                break
        else:
            lanes = 32 if -(-v // 32) <= LN_MAX_VECS else None
        while lanes and lanes < 32 and rows * lanes < SMS * SM_THREADS:
            lanes *= 2
        if lanes:
            per_block = LN_THREADS // 32 * (32 // lanes)
            return LnPlan("vector", lanes, -(-v // lanes), per_block, -(-rows // per_block))
    return LnPlan("elementwise", rows_per_block=8, grid=-(-rows // 8))


def fused_layer_norm(x, weight, bias, eps=1e-5, act=None):
    """LayerNorm(+act) over the last axis of a contiguous tensor.

    CUDA: the kernel of csrc/norms.cu on `ln_plan`'s route, through
    `_LayerNormFn` when an input needs a gradient. CPU: `layer_norm_plain`.
    Without a gradient, through the operator `t2v_turbo::layer_norm`. Replaces t2v_turbo_tpu/ops/fused_norms.py::fused_layer_norm.
    """
    if _needs_grad(x, weight, bias):
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps, act)
        return _LayerNormFn.apply(x, weight, bias, eps, act)
    return torch.ops.t2v_turbo.layer_norm(x, weight, bias, eps, act)


_counters(fused_layer_norm)


def layer_norm_cuda(x, weight, bias, eps=1e-5, act=None):
    """Launch the LayerNorm kernel of csrc/norms.cu; raises on what it does not take."""
    if x.device.type != "cuda":
        raise RuntimeError(f"layer_norm_cuda: no kernel for device {x.device}")
    _check_cuda_input(x, "layer_norm_cuda")
    c = x.shape[-1]
    rows = x.numel() // c
    w, b = _affine(weight, c, x.device), _affine(bias, c, x.device)
    y = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, b))
    plan = ln_plan(rows, c, x.dtype, aligned)
    err = cuda_lib.lib().t2v_layer_norm_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), cuda_lib.DTYPE_CODES[x.dtype], rows, c, eps,
        _act_code(act), plan.lanes, plan.vecs, cuda_lib.stream_ptr(x.device),
    )
    cuda_lib.check(err, "layer_norm_cuda")
    _count(fused_layer_norm, plan.route, (rows, c))
    return y


def group_norm(x, weight, bias, num_groups=32, eps=1e-5, act=None):
    """GroupNorm(+act) on (N, C, *spatial): the models' entry point."""
    return fused_group_norm(x.contiguous(), weight, bias, num_groups, eps, act)


def layer_norm(x, weight, bias, eps=1e-5, act=None):
    """LayerNorm(+act) over the last axis: the models' entry point."""
    return fused_layer_norm(x.contiguous(), weight, bias, eps, act)


def _norm_fake(x, weight, bias, *cfg):
    return torch.empty_like(x)


cuda_lib.define_op("group_norm(Tensor x, Tensor weight, Tensor bias, int num_groups, float eps, str? act) -> Tensor",
                   group_norm_cuda, group_norm_plain, _norm_fake)
cuda_lib.define_op("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps, str? act) -> Tensor",
                   layer_norm_cuda, layer_norm_plain, _norm_fake)
