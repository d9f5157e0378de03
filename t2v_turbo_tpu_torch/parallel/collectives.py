"""The collectives of sequence- and data-parallel sampling and training, written out.

The JAX package shards a clip (B, T, ...) over its "seq" mesh axis and
GSPMD inserts what the temporal layers then need. Here the layers call
these helpers on an `AxisGroup` (parallel/mesh.py) of the seq axis:

- `halo_exchange(x, group, dim)`: each rank's clip shard gains its
  neighbours' edge frames (one frame each side where a neighbour exists;
  `halo_sides` says which) for the (3, 1, 1) temporal convs.
- `gather_partials(parts, counts, group)`: every rank's GroupNorm chunk
  partials ((sum, centred sum of squares) per row and chunk,
  ops/norms.py::group_norm_partials) and their element counts, in rank
  order, so each rank normalises with the whole clip's statistics.
- `seq_to_space(x, group)` / `space_to_seq(x, group)`: an all-to-all that
  switches a (B, C, T, S) clip between T-sharded (every rank all S columns
  of its T / n frames) and S-sharded (all T frames of S / n columns), for
  the temporal attention, which needs every frame of a pixel.
- `gather_to_all` / `gather_to_root`: whole tensors from every rank of a
  group (the sampled latents, a reward's frames; the decoded frames on
  rank 0).

Gradients: each of the first five is an `autograd.Function` whose backward
sends every cotangent back to the rank that owns the value. The halo
frames' gradients go back to their owners and add to the owners' edge
frames; the gathers' backward is a reduce-scatter of the gradients (every
rank used every rank's values); the two all-to-alls are each other's
backward. The counts carry no gradient; `gather_to_root` refuses one.

The trainer's data-parallel helpers, over flat buffers: `all_reduce_`
(in place, a sum), `reduce_scatter_flat` (n * c elements in, this rank's
c-element block of the sum out) and `all_gather_flat` (the inverse
layout: every rank's c elements, in rank order). The model axis's one
collective, `model_all_reduce`: the row-parallel layers' partial outputs
summed out of place (parallel/tp.py), forward only.

Transport: the group's backend. gloo takes no CUDA tensor in these
collectives, so when the group's backend is gloo and the tensor lies on
the card, the helper stages it through host memory (a copy to the host,
the collective there, a copy back) and counts the staged bytes. That is
the transport gloo implies, not a fallback: the kernels still run on the
card. NCCL takes the card's tensors directly.

Counters (each helper's attributes, read by chip_smoke.py): `calls`,
`staged_bytes` (bytes copied to and from the host), `seconds` (host wall
time inside the helper; for a staged call the stream is synchronised first,
so it holds the transport alone, not the kernels queued before it). A
backward's transport counts on its helper.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


def _counters(fn):
    fn.calls, fn.staged_bytes, fn.seconds = 0, 0, 0.0
    return fn


def _refuse_grad(x: torch.Tensor, what: str,
                 why: str = "the decoded frames on one rank are not trained through") -> None:
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(f"{what}: no backward ({why})")


class _Transport:
    """One collective call: stage through the host when gloo meets a CUDA
    tensor, time it, and count it on `fn`."""

    def __init__(self, fn, group, x: torch.Tensor):
        self.fn, self.group, self.device = fn, group, x.device
        self.staged = group.backend == "gloo" and x.is_cuda

    def __enter__(self):
        if self.staged:
            torch.cuda.current_stream(self.device).synchronize()
        self.t0 = time.perf_counter()
        return self

    def send(self, x: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return x.contiguous()
        self.fn.staged_bytes += x.numel() * x.element_size()
        return x.contiguous().cpu()

    def back(self, x: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return x
        self.fn.staged_bytes += x.numel() * x.element_size()
        return x.to(self.device)

    def back_into(self, dst: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if x is not dst:
            if self.staged:
                self.fn.staged_bytes += x.numel() * x.element_size()
            dst.copy_(x)
        return dst

    def __exit__(self, *exc):
        self.fn.calls += 1
        self.fn.seconds += time.perf_counter() - self.t0
        return False


def _all_gather(fn, x: torch.Tensor, group) -> torch.Tensor:
    """(group.size, *x.shape): every rank's x in rank order."""
    with _Transport(fn, group, x) as t:
        src = t.send(x)
        outs = [torch.empty_like(src) for _ in range(group.size)]
        dist.all_gather(outs, src, group=group.pg)
        return t.back(torch.stack(outs))


def _reduce_scatter(fn, x: torch.Tensor, group) -> torch.Tensor:
    """x: (group.size, ...) -> block `group.index` of the sum of every rank's x."""
    with _Transport(fn, group, x) as t:
        src = t.send(x)
        out = torch.empty(src[0].numel(), dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src.reshape(-1), group=group.pg)
        return t.back(out.view(src.shape[1:]))


def _all_to_all(fn, x: torch.Tensor, group) -> torch.Tensor:
    """x: (group.size, ...): block j goes to rank j; block i of the result
    came from rank i."""
    with _Transport(fn, group, x) as t:
        src = t.send(x)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group.pg)
        return t.back(out)


def halo_sides(group) -> Tuple[int, int]:
    """(frames added before, after) by `halo_exchange` on this rank: a rank at
    a clip edge adds none on that side."""
    return int(group.index > 0), int(group.index < group.size - 1)


def _halo(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    edges = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)], dim)
    every = _all_gather(halo_exchange, edges, group)
    lo, hi = halo_sides(group)
    parts = [every[group.index - 1].narrow(dim, 1, 1)] if lo else []
    parts.append(x)
    if hi:
        parts.append(every[group.index + 1].narrow(dim, 0, 1))
    return torch.cat(parts, dim)


def _halo_grad(g: torch.Tensor, group, dim: int, t: int) -> torch.Tensor:
    """The VJP of `_halo`: this rank's frames' part of g, plus the gradients
    of the copies of its edge frames that its neighbours held as halos."""
    lo, hi = halo_sides(group)
    zero = g.new_zeros(g.shape[:dim] + (1,) + g.shape[dim + 1:])
    sent = torch.cat([g.narrow(dim, 0, 1) if lo else zero, g.narrow(dim, lo + t, 1) if hi else zero], dim)
    every = _all_gather(halo_exchange, sent, group)  # rank r: (its halo before, its halo after)
    core = g.narrow(dim, lo, t).clone()
    if lo:  # the previous rank's halo after it is my first frame
        core.narrow(dim, 0, 1).add_(every[group.index - 1].narrow(dim, 1, 1))
    if hi:  # the next rank's halo before it is my last frame
        core.narrow(dim, t - 1, 1).add_(every[group.index + 1].narrow(dim, 0, 1))
    return core


class _HaloFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.t = group, dim, x.shape[dim]
        return _halo(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _halo_grad(g.contiguous(), ctx.group, ctx.dim, ctx.t), None, None


@_counters
def halo_exchange(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x extended along `dim` by the previous rank's last frame and the next
    rank's first frame (where those ranks exist). The edges of all ranks go
    out in one all_gather of two frames a rank; the backward sends the halo
    frames' gradients back the same way."""
    if group.size == 1:
        return x
    return _HaloFn.apply(x, group, dim)


def _gather_parts(parts, counts, group):
    r, p = parts.shape[:2]
    packed = torch.cat([parts, counts.to(parts.dtype)[None, :, None].expand(1, p, 2)])
    every = _all_gather(gather_partials, packed, group)  # (n, R + 1, P, 2)
    return (every[:, :r].transpose(0, 1).reshape(r, group.size * p, 2).contiguous(),
            every[:, r, :, 0].reshape(-1).to(torch.int32))


class _GatherPartialsFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, parts, counts, group):
        ctx.group = group
        out, all_counts = _gather_parts(parts, counts, group)
        ctx.mark_non_differentiable(all_counts)
        return out, all_counts

    @staticmethod
    def backward(ctx, g, _gcounts):
        n = ctx.group.size
        r, np_, two = g.shape
        blocks = g.reshape(r, n, np_ // n, two).transpose(0, 1).contiguous()  # block i: rank i's chunks
        return _reduce_scatter(gather_partials, blocks, ctx.group), None, None


@_counters
def gather_partials(parts: torch.Tensor, counts: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, P, 2) f32 partials and (P,) int32 counts of this rank -> (R, n*P,
    2) and (n*P,) of every rank of the group, in rank order. One all_gather:
    the counts ride as an extra row of f32 (exact: a chunk holds far fewer
    than 2^24 elements). Backward: a reduce-scatter of the partials'
    gradients (every rank normalised with every rank's partials)."""
    if group.size == 1:
        return parts, counts
    return _GatherPartialsFn.apply(parts, counts, group)


def _to_space(x, group):
    n = group.size
    b, c, t, s = x.shape
    if s % n:
        raise ValueError(f"seq_to_space: {s} columns (H*W) do not split over {n} seq ranks")
    blocks = x.reshape(b, c, t, n, s // n).permute(3, 0, 1, 2, 4).contiguous()
    got = _all_to_all(seq_to_space, blocks, group)  # block i: rank i's frames of my columns
    return got.permute(1, 2, 0, 3, 4).reshape(b, c, n * t, s // n)


def _to_seq(x, group):
    n = group.size
    b, c, t, s = x.shape
    if t % n:
        raise ValueError(f"space_to_seq: {t} frames do not split over {n} seq ranks")
    blocks = x.reshape(b, c, n, t // n, s).permute(2, 0, 1, 3, 4).contiguous()
    got = _all_to_all(space_to_seq, blocks, group)  # block i: my frames of rank i's columns
    return got.permute(1, 2, 3, 0, 4).reshape(b, c, t // n, n * s)


class _SeqToSpaceFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_space(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g.contiguous(), ctx.group), None


class _SpaceToSeqFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_space(g.contiguous(), ctx.group), None


@_counters
def seq_to_space(x: torch.Tensor, group) -> torch.Tensor:
    """(B, C, T / n, S) frames of this rank -> (B, C, T, S / n): all T frames
    of this rank's S / n columns (rank i holds columns i*S/n ...). Backward:
    `space_to_seq` of the gradient."""
    if group.size == 1:
        return x
    return _SeqToSpaceFn.apply(x, group)


@_counters
def space_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """The inverse of `seq_to_space`: (B, C, T, S / n) -> (B, C, T / n, S).
    Backward: `seq_to_space` of the gradient."""
    if group.size == 1:
        return x
    return _SpaceToSeqFn.apply(x, group)


class _GatherToAllFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(gather_to_all, x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(gather_to_all, g.contiguous(), ctx.group), None


@_counters
def gather_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(group.size, *x.shape): every rank's x (same shape on every rank), on
    every rank. Backward: a reduce-scatter (this rank's x gets the sum of
    every rank's gradient of its block)."""
    if group.size == 1:
        return x[None]
    return _GatherToAllFn.apply(x, group)


@_counters
def gather_to_root(x: torch.Tensor, counts: List[int], group, root: int = 0) -> Optional[torch.Tensor]:
    """Rows (dim 0) of every rank, `counts[i]` from rank i (uneven allowed),
    concatenated in rank order on the group's rank `root`; None on the other
    ranks. The shorter blocks are padded for the transfer."""
    _refuse_grad(x, "gather_to_root")
    if x.shape[0] != counts[group.index]:
        raise ValueError(f"gather_to_root: rank {group.index} holds {x.shape[0]} rows, counts say "
                         f"{counts[group.index]}")
    if group.size == 1:
        return x
    most = max(counts)
    if x.shape[0] < most:
        x = torch.cat([x, x.new_zeros((most - x.shape[0],) + x.shape[1:])])
    with _Transport(gather_to_root, group, x) as t:
        src = t.send(x)
        dst = group.ranks[root]
        outs = [torch.empty_like(src) for _ in range(group.size)] if group.index == root else None
        dist.gather(src, outs, dst=dst, group=group.pg)
        if group.index != root:
            return None
        return t.back(torch.cat([o[:n] for o, n in zip(outs, counts)]))


@_counters
def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group's ranks, in place; returns x."""
    if group.size == 1:
        return x
    with _Transport(all_reduce_, group, x) as t:
        src = t.send(x)
        dist.all_reduce(src, group=group.pg)
        return t.back_into(x, src)


@_counters
def model_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks, out of place: a row-parallel
    layer's partial outputs over the model axis (parallel/tp.py), summed in
    x's dtype, as GSPMD's psum of the dot's output is. Forward only: the
    backward (Megatron's f / g pair) belongs to the training half."""
    _refuse_grad(x, "model_all_reduce", "Megatron's backward pair over the model axis is the training half of "
                                        "A12b.2 (A12b.2b)")
    if group.size == 1:
        return x
    with _Transport(model_all_reduce, group, x) as t:
        src = t.send(x)
        if src is x:  # NCCL, or a CPU tensor: the collective writes its input
            src = x.clone()
        dist.all_reduce(src, group=group.pg)
        return t.back(src)


@_counters
def reduce_scatter_flat(x: torch.Tensor, group) -> torch.Tensor:
    """A flat buffer of n * c elements -> this rank's block of c elements of
    its sum over the group's n ranks (block i: elements i*c ... of every
    rank's buffer)."""
    n = group.size
    if x.numel() % n:
        raise ValueError(f"reduce_scatter_flat: {x.numel()} elements do not split over {n} ranks")
    if n == 1:
        return x.reshape(-1).clone()
    return _reduce_scatter(reduce_scatter_flat, x.reshape(n, -1), group)


@_counters
def all_gather_flat(x: torch.Tensor, group) -> torch.Tensor:
    """c elements of every rank -> n * c, in rank order."""
    if group.size == 1:
        return x.reshape(-1).clone()
    return _all_gather(all_gather_flat, x.reshape(-1), group).reshape(-1)


def reset_counters() -> None:
    for fn in COLLECTIVES:
        fn.calls, fn.staged_bytes, fn.seconds = 0, 0, 0.0


def read_counters() -> dict:
    """{helper name: {"calls", "staged_bytes", "seconds"}}."""
    return {fn.__name__: {"calls": fn.calls, "staged_bytes": fn.staged_bytes, "seconds": fn.seconds}
            for fn in COLLECTIVES}


COLLECTIVES = (halo_exchange, gather_partials, seq_to_space, space_to_seq, gather_to_all, gather_to_root, all_reduce_,
               model_all_reduce, reduce_scatter_flat, all_gather_flat)
