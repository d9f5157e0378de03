"""ZeRO over the data axis of the trainer's flat buffers (port of
t2v_turbo_tpu/parallel/fsdp.py's role; its `fsdp_spec_for` :34 and
`fsdp_shardings` :65 shard every large leaf of the parameters, the
optimizer state and the EMA over "data", and XLA inserts the gathers and
the gradient's reduce-scatter).

The port's trainer holds its state in flat buffers (training/trainer.py):
an f32 master laid out in segments, one run of tensors a (optimizer group,
norm or not), each segment starting and ending on an `optim.BLOCK` (256)
boundary. `FlatShards` cuts every segment into `n` contiguous slices of
`chunk` elements (a multiple of BLOCK; the last slice the rest, maybe
empty), and data rank i owns slice i of each. A rank keeps only its slices
of the f32 master, the optimizer's moments (so an int8 moment's 256-value
blocks are the unsharded ones), the EMA and the reduced gradient, in one
local buffer: its slices in segment order.

- `reduce_scatter(full)`: every rank's full gradient summed, this rank's
  slices out (one `reduce_scatter_flat` a segment, over n * chunk
  elements read in place; past a segment's end they belong to no slice).
- `gather(local, k, dtype)`: segment k whole on every rank from the ranks'
  slices (one `all_gather_flat`), cast to `dtype` before the transfer.
- `take(full)` / `take_rows(t, k, unit)` and `gather_rows(t, k, unit)`:
  this rank's part of a whole buffer or of one segment's tensor, and back;
  `unit` elements a row (1 for a flat moment, BLOCK for an int8 moment's
  (blocks, 256) values and (blocks, 1) scales), so a one-process
  checkpoint loads on any data size and is written from any.

What stays whole on every rank: the working copy in the compute dtype and
the live f32 norm affines (all-gathered after each update), the EMA
target's copy, the frozen towers. JAX's ZeRO-3 shards those too; the
difference is memory only (ROADMAP §C).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..training.optim import BLOCK, square_sum_f32
from . import collectives


class FlatShards:
    """Each segment [lo, hi) of a flat buffer split over the ranks of `group`
    (an AxisGroup of the data axis)."""

    def __init__(self, segments: Sequence[Tuple[int, int]], group):
        self.group = group
        n, i = group.size, group.index
        self.segments: List[Tuple[int, int]] = [(int(lo), int(hi)) for lo, hi in segments]
        self.chunks, self.mine, self.local = [], [], []
        at = 0
        for lo, hi in self.segments:
            if lo % BLOCK or hi % BLOCK:
                raise ValueError(f"FlatShards: segment [{lo}, {hi}) is not on {BLOCK}-element boundaries")
            chunk = -(-(hi - lo) // (BLOCK * n)) * BLOCK
            a, b = min(hi, lo + i * chunk), min(hi, lo + (i + 1) * chunk)
            self.chunks.append(chunk)
            self.mine.append((a, b))
            self.local.append(slice(at, at + b - a))
            at += b - a
        self.size = at

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's slices of a whole flat buffer, as a new local buffer on
        `full`'s device."""
        out = full.new_empty(self.size)
        for (a, b), loc in zip(self.mine, self.local):
            out[loc] = full[a:b]
        return out

    def reduce_scatter(self, full: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """`out` (local) <- this rank's slices of the sum over the group of
        every rank's `full` buffer."""
        n = self.group.size
        for (lo, hi), chunk, (a, b), loc in zip(self.segments, self.chunks, self.mine, self.local):
            span = full[lo:lo + n * chunk]
            if span.numel() < n * chunk:  # the buffer ends before the last slice's room
                span = F.pad(span, (0, n * chunk - span.numel()))
            out[loc] = collectives.reduce_scatter_flat(span, self.group)[:b - a]
        return out

    def gather(self, local: torch.Tensor, k: int, dtype=None, to_host: bool = False) -> torch.Tensor:
        """Segment k whole (hi - lo elements) on every rank, from every rank's
        slice of it in `local`, in `dtype` (default: local's). `to_host`: the
        result on the host (over gloo gathered there, so the card holds no
        copy of the whole segment)."""
        lo, hi = self.segments[k]
        mine = local[self.local[k]].to(dtype or local.dtype)
        if to_host and self.group.backend == "gloo":
            mine = mine.cpu()
        if mine.numel() < self.chunks[k]:
            mine = F.pad(mine, (0, self.chunks[k] - mine.numel()))
        whole = collectives.all_gather_flat(mine, self.group)[:hi - lo]
        return whole.cpu() if to_host else whole

    def gather_rows(self, t: torch.Tensor, k: int, unit: int = 1) -> torch.Tensor:
        """Segment k's tensor whole from this rank's rows of it (`unit`
        elements of the segment a row): (rows of the segment, *t.shape[1:])."""
        lo, hi = self.segments[k]
        room = self.chunks[k] // unit
        rows = t.reshape(t.shape[0], math.prod(t.shape[1:]))
        if self.group.backend == "gloo":  # gathered on the host (a checkpoint's moments)
            rows = rows.cpu()
        if rows.shape[0] < room:
            rows = torch.cat([rows, rows.new_zeros((room - rows.shape[0], rows.shape[1]))])
        flat = collectives.all_gather_flat(rows.reshape(-1), self.group)
        return flat.view(self.group.size * room, *t.shape[1:])[:(hi - lo) // unit]

    def take_rows(self, t: torch.Tensor, k: int, unit: int = 1) -> torch.Tensor:
        """This rank's rows of segment k's whole tensor (the inverse of
        `gather_rows`)."""
        lo = self.segments[k][0]
        a, b = self.mine[k]
        return t[(a - lo) // unit:(b - lo) // unit].clone()

    def square_norm(self, local: torch.Tensor) -> torch.Tensor:
        """The squared 2-norm, in f32, of the whole buffer that the ranks'
        `local` slices make up: the local sum of squares summed over the
        group."""
        sq = square_sum_f32(local).reshape(1) if local.numel() else local.new_zeros(1, dtype=torch.float32)
        return collectives.all_reduce_(sq, self.group)[0]
