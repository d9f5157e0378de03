"""The (data, seq, model) mesh over a torch.distributed world (port of t2v_turbo_tpu/parallel/mesh.py).

The JAX package names the axes of one device mesh and lets GSPMD insert the
collectives; here every rank is one device, and the mesh says where this
rank sits and which ranks share each axis:

- axis "data": batch data parallelism (each data index holds B / data rows),
- axis "seq": temporal sequence parallelism (each seq index holds T / seq
  frames; the temporal layers exchange halos, gather GroupNorm partials and
  switch to space-sharded layouts through parallel/collectives.py),
- axis "model": tensor parallelism, not ported yet (A12b): it must be 1.

Ranks are laid out row-major over (data, seq, model), as JAX reshapes its
device list: rank = (d * seq + s) * model + m. `make_mesh` builds one
process group for each set of ranks that differ along one axis only (every
rank takes part in creating every group, as torch.distributed requires).
`shard` / `shard_batch` / `replicated` keep JAX's meaning: split a global
tensor by a spec of axis names, or keep it whole.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXES = ("data", "seq", "model")


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: the ranks that differ from this
    one along the axis only (`ranks`, in axis order), this rank's `index`
    among them, their process group (None when the axis has one rank) and
    its backend."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    pg: Any
    backend: str


@dataclasses.dataclass(frozen=True)
class Mesh:
    data: int
    seq: int
    model: int
    rank: int
    device: torch.device
    axes: Tuple[AxisGroup, ...]  # data, seq, model, then "world" (every rank)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seq": self.seq, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.seq * self.model

    def axis(self, name: str) -> AxisGroup:
        for a in self.axes:
            if a.name == name:
                return a
        raise KeyError(name)

    def coords(self, rank: Optional[int] = None) -> Tuple[int, int, int]:
        """(data, seq, model) index of `rank` (default: this rank)."""
        r = self.rank if rank is None else rank
        return r // (self.seq * self.model), (r // self.model) % self.seq, r % self.model


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1,
              device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the initialised world; `data` defaults to the world over
    seq * model. `device`: this rank's (default: the current CUDA device if
    there is one, else the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised (call parallel.multihost.initialize(), "
                           "or launch under torchrun)")
    n = dist.get_world_size()
    if data is None:
        if n % (seq * model) != 0:
            raise ValueError(
                f"make_mesh: need a world size divisible by seq*model={seq}*{model}={seq * model}, but the world "
                f"has {n} rank(s); launch data*seq*model ranks (torchrun --nproc-per-node N)")
        data = n // (seq * model)
    if data * seq * model != n:
        raise ValueError(
            f"make_mesh: data*seq*model = {data}*{seq}*{model} = {data * seq * model} does not match the world "
            f"of {n} rank(s).")
    if model != 1:
        raise NotImplementedError(
            f"make_mesh: model={model}: tensor parallelism (the model axis) is not ported yet (A12b); use model=1")
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else \
            torch.device("cpu")
    rank, backend = dist.get_rank(), dist.get_backend()
    sizes = (data, seq, model)
    here = (rank // (seq * model), (rank // model) % seq, rank % model)
    axes = []
    for i, name in enumerate(AXES):
        mine = None
        others = [range(s) for j, s in enumerate(sizes) if j != i]
        for rest in itertools.product(*others):  # every rank creates every group, in one order
            ranks = []
            for k in range(sizes[i]):
                c = list(rest)
                c.insert(i, k)
                ranks.append((c[0] * seq + c[1]) * model + c[2])
            pg = dist.new_group(ranks) if sizes[i] > 1 else None
            if rank in ranks:
                mine = AxisGroup(name, sizes[i], here[i], tuple(ranks), pg, backend)
        axes.append(mine)
    axes.append(AxisGroup("world", n, rank, tuple(range(n)), dist.group.WORLD if n > 1 else None, backend))
    return Mesh(data, seq, model, rank, torch.device(device), tuple(axes))


def seq_submesh(mesh: Mesh) -> Mesh:
    """The mesh of this rank's data index alone (data = 1): its seq ranks,
    which then form the world, e.g. for rendering one prompt over the seq
    ranks while every data index renders its own."""
    seq = mesh.axis("seq")
    axes = (AxisGroup("data", 1, 0, (mesh.rank,), None, seq.backend), seq, mesh.axis("model"),
            AxisGroup("world", seq.size, seq.index, seq.ranks, seq.pg, seq.backend))
    return Mesh(1, mesh.seq, mesh.model, seq.index, mesh.device, axes)


def batch_sharding(mesh: Mesh) -> Tuple[str, str]:
    """(B, T, ...) video batches: B over data, T over seq."""
    return ("data", "seq")


def replicated(mesh: Mesh) -> Tuple[()]:
    """A tensor every rank holds whole."""
    return ()


def shard(mesh: Mesh, x: torch.Tensor, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """This rank's block of a global tensor: dimension i split evenly over
    axis spec[i] (None or missing: kept whole), on the mesh's device."""
    for dim, name in enumerate(spec):
        if name is None:
            continue
        a = mesh.axis(name)
        if x.shape[dim] % a.size:
            raise ValueError(f"shard: dimension {dim} of {tuple(x.shape)} does not split over the {name} axis "
                             f"({a.size})")
        step = x.shape[dim] // a.size
        x = x.narrow(dim, a.index * step, step)
    return x.to(mesh.device)


def shard_batch(mesh: Mesh, batch):
    """This rank's shard of a global batch (a dict, list or tuple of
    tensors): (B, T, ...) tensors of 5 or more dimensions over (data, seq),
    other (B, ...) tensors over data, 0-d ones whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    x = torch.as_tensor(batch)
    spec = batch_sharding(mesh) if x.dim() >= 5 else ("data",) if x.dim() >= 1 else replicated(mesh)
    return shard(mesh, x, spec)
