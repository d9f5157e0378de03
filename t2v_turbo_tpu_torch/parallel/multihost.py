"""Multi-process start-up and batch assembly (port of t2v_turbo_tpu/parallel/multihost.py).

The JAX package calls `jax.distributed.initialize()` and then sees every
process's devices as one global mesh. Here each process is one rank of a
`torch.distributed` world that drives one device:

- `initialize()` joins the world: torchrun's environment (`MASTER_ADDR`,
  `MASTER_PORT`, `RANK`, `WORLD_SIZE`, `LOCAL_RANK`) or explicit arguments,
  the `nccl` backend for a CUDA device and `gloo` for the CPU. The device is
  `cuda:{local rank}`; a local rank past the host's cards raises, unless the
  caller passes `share_device=True` (several ranks on one card; NCCL refuses
  that, so it takes gloo). Ranks are never mapped onto cards modulo the card
  count in silence.
- `host_local_batch_to_global()` takes the rows of this rank's data index
  and returns this rank's shard: the rows as given, and for (B, T, ...)
  tensors of 5 or more dimensions the frames of its seq index. Keys starting
  with `_` are dropped, as in JAX. No rank ever holds the global batch.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

# Every collective of the world waits at most this long (torch.distributed's
# process-group timeout): a rank that dies or hangs fails the others instead
# of stalling them.
DEFAULT_TIMEOUT_S = 600.0

TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def torchrun_env() -> bool:
    """Whether this process was started with torchrun's variables."""
    return all(v in os.environ for v in TORCHRUN_VARS)


def _local_index(local_device_ids: Union[int, Sequence[int], None], rank: int) -> int:
    if local_device_ids is None:
        return int(os.environ.get("LOCAL_RANK", rank))
    if isinstance(local_device_ids, int):
        return local_device_ids
    ids = list(local_device_ids)
    if len(ids) != 1:
        raise ValueError(f"a rank drives one device; got local_device_ids={ids}")
    return ids[0]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Union[int, Sequence[int], None] = None,
    backend: Optional[str] = None,
    share_device: bool = False,
    device_type: str = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the torch.distributed world; returns this rank's device.

    `coordinator_address` ("host:port"), `num_processes` and `process_id`
    default to torchrun's MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK;
    `local_device_ids` (this rank's card, an int or a one-element list) to
    LOCAL_RANK, else the rank. `device_type="cpu"` runs the rank on the CPU
    over gloo. Once a process."""
    if dist.is_initialized():
        raise RuntimeError("initialize: torch.distributed is already initialised in this process")
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise RuntimeError("initialize: no coordinator address and no MASTER_ADDR/MASTER_PORT "
                               "(launch under torchrun, or pass coordinator_address)")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    if not 0 <= rank < world:
        raise ValueError(f"initialize: rank {rank} outside a world of {world}")

    if device_type == "cpu":
        device = torch.device("cpu")
        backend = backend or "gloo"
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device (pass device_type='cpu' to run the rank on the CPU)")
        local, count = _local_index(local_device_ids, rank), torch.cuda.device_count()
        if local >= count and not share_device:
            raise RuntimeError(
                f"initialize: rank {rank} wants cuda:{local}, but this host has {count} CUDA device(s); launch "
                f"at most {count} rank(s) a host, or pass share_device=True to put several ranks on one card")
        index = local % count  # share_device: the caller asked for several ranks a card
        backend = backend or "nccl"
        if backend == "nccl" and local >= count:
            raise ValueError(f"initialize: rank {rank} would share cuda:{index} with another rank, which NCCL "
                             "refuses; pass backend='gloo' with share_device=True")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    else:
        raise ValueError(f"initialize: device_type {device_type!r} is not 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def shutdown() -> None:
    """Leave the world (destroy the default process group) if joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def host_local_batch_to_global(mesh, batch: dict) -> dict:
    """This rank's shard of a batch from the rows of its data index.

    Each rank passes its LOCAL rows (global B / data ranks), as each JAX
    process passes its host's. (B, T, ...) tensors of 5 or more dimensions
    keep the frames of this rank's seq index; (B, ...) rows and scalars are
    kept whole. Values become tensors on the mesh's device; keys starting
    with `_` are dropped."""
    from .mesh import shard

    def put(x):
        t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        return shard(mesh, t, (None, "seq") if t.dim() >= 5 else ())

    return {k: put(v) for k, v in batch.items() if not k.startswith("_")}
