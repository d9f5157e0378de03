"""Multi-process parallelism over torch.distributed (port of t2v_turbo_tpu/parallel/).

- `multihost`: join the process group (torchrun's environment or explicit
  arguments) and pick this rank's device; assemble a rank's batch shard.
- `mesh`: the (data, seq, model) mesh over the initialised world: this rank's
  coordinates and each axis's process group; `shard_batch` / `replicated`.
- `collectives`: the collectives that GSPMD inserted for the JAX package's
  sequence parallelism, written out (halo exchange, the GroupNorm partials'
  gather, the seq <-> space all-to-all), each with its backward, and the
  data-parallel trainer's (all-reduce, reduce-scatter and all-gather of
  flat buffers).
- `fsdp`: ZeRO over the data axis of the trainer's flat state.
- `tp`: the UNet's Megatron column / row split over the model axis.

The batch splits over `data`, the frames T over `seq`, the UNet's weights
over `model` (sampling and serving; the training half is A12b.2b).
"""
