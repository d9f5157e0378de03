"""Tensor parallelism of the VC2 UNet over the mesh's "model" axis (port of t2v_turbo_tpu/parallel/tp.py).

The JAX package gives the UNet's kernels PartitionSpecs and GSPMD inserts
the all-reduces. Here `tp_plan` is the same Megatron column / row split as
a plan over the port's (the reference's) state-dict keys, and
`shard_unet_tp_` replaces each split parameter by this rank's block and
points the modules that run the split layers at the model group
(models/layers.py); each row layer then sums its partial outputs with
`collectives.model_all_reduce`, where GSPMD put its psum.

The rules are JAX's `tp_spec_for` / `tp_param_shardings` (with
`head_dim=cfg.num_head_channels, conv_channels=True`, as its pipeline
passes them, vc2.py:231-248):
- `to_q` / `to_k` / `to_v` / `to_k_ip` / `to_v_ip`: column (output rows,
  this rank's heads); `to_out.0`: row (input columns). Only where the
  projection's own width is a whole number of `head_dim`-wide heads that
  the axis divides: `init_attn` (8 heads of 64 over 320 channels) splits at
  2 and 4, the level-0 transformers' 5 heads stay whole.
- the GEGLU: `ff.net.0.proj` column, `ff.net.2` row, where F divides.
- with `conv_channels`, inside input_blocks / middle_block / output_blocks
  and only where the axis divides GroupNorm's 32 groups: the ResBlock's
  `in_layers.2` and `emb_layers.1` column, `out_layers.3` row; the
  TemporalConvBlock's conv1 / conv3 column, conv2 / conv4 row. `conv_in`,
  the top-level `out`, the skip 1x1s and Down/Upsample stay whole.
Everything else stays whole, and between the split layers every activation
is whole on every rank of the model group.

What JAX leaves to GSPMD, the plan states: a column layer's bias splits
with its rows; a row layer's bias stays whole and is added once, after the
sum; the GroupNorm in front of a row conv (`out_layers.0`, `conv2.0`,
`conv4.0`) normalises this rank's channel block, so its affine splits and
its group count becomes 32 / n (the block holds whole groups).

Layouts: JAX holds a Dense kernel as (in, out), the port a Linear weight as
(out, in); a conv kernel (kh, kw, in, out) against (O, C, kh, kw). JAX's
GEGLU projection is (C, 2, F) and splits F; the port's `ff.net.0.proj` is
(2F, C), value rows first, so this rank's rows are the value rows r*F/n ...
and the gate rows F + r*F/n ... (`Split.pieces` = 2). With
`use_scale_shift_norm` the ResBlock's `emb_layers.1` is (2 * out, E),
(scale, shift), split the same way (JAX splits it contiguously and GSPMD
reshards after its split into scale and shift).

This slice runs sampling and serving only: the row layers' sum has no
backward, and the trainer, the preprocess and every export refuse the model
axis (`refuse_model_axis`; A12b.2b, the training half).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

GN_GROUPS = 32  # the UNet's GroupNorm groups: a conv split needs n to divide them
TRAINING_HALF = "the training half of A12b.2 (A12b.2b)"

_QKV = ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")
_BLOCKS = ("input_blocks.", "middle_block.", "output_blocks.")
# (module suffix, kind) of the conv pairs; the norm in front of each row conv splits with it
_CONVS = {"in_layers.2": "column", "emb_layers.1": "column", "out_layers.3": "row", "out_layers.0": "norm",
          "temopral_conv.conv1.2": "column", "temopral_conv.conv2.3": "row", "temopral_conv.conv2.0": "norm",
          "temopral_conv.conv3.3": "column", "temopral_conv.conv4.3": "row", "temopral_conv.conv4.0": "norm"}


class Split(NamedTuple):
    """How one tensor splits over the model axis: along `dim`, as a
    `kind` of layer ("column": output rows; "row": input columns; "bias":
    a column layer's bias; "norm": the affine of the GroupNorm in front of
    a row conv), in `pieces` equal parts split alike (2: GEGLU's value and
    gate, a scale-shift embedding's scale and shift)."""

    dim: int
    kind: str
    pieces: int = 1


def _split(key: str, shape: Tuple[int, ...], shapes: Dict[str, Tuple[int, ...]], n: int,
           head_dim: Optional[int], conv_channels: bool) -> Optional[Split]:
    module, param = key.rsplit(".", 1)
    name = module.rsplit(".", 1)[-1]
    attn_out = module.endswith(".to_out.0")
    if name in _QKV or attn_out:
        if param != "weight":
            return None  # q/k/v have no bias; to_out's is added after the sum
        dim = 1 if attn_out else 0
        size = shape[dim]
        ok = size % n == 0 and (head_dim is None or (size % head_dim == 0 and (size // head_dim) % n == 0))
        return Split(dim, "row" if attn_out else "column") if ok else None
    if module.endswith(".ff.net.0.proj"):  # (2F, C): value rows, then gate rows
        return Split(0, "column" if param == "weight" else "bias", 2) if (shape[0] // 2) % n == 0 else None
    if module.endswith(".ff.net.2"):
        return Split(1, "row") if param == "weight" and shape[1] % n == 0 else None
    if not (conv_channels and key.startswith(_BLOCKS)):
        return None
    for suffix, kind in _CONVS.items():
        if not module.endswith("." + suffix):
            continue
        if kind == "row":
            return Split(1, "row") if param == "weight" and shape[1] % n == 0 else None
        pieces = 1
        if suffix == "emb_layers.1":  # (out, E), or (2 * out, E) = (scale, shift) with use_scale_shift_norm
            pieces = shape[0] // shapes[module[:-len(suffix)] + "in_layers.2.weight"][0]
        if shape[0] % (n * pieces):
            return None
        return Split(0, kind if kind == "norm" or param == "weight" else "bias", pieces)
    return None


def tp_plan(shapes: Dict[str, Tuple[int, ...]], n: int, head_dim: Optional[int] = None,
            conv_channels: bool = True) -> Dict[str, Optional[Split]]:
    """{state-dict key: its Split, or None (whole)} of a VC2 UNet's tensors
    (`shapes`: key -> shape) over a model axis of n ranks; JAX's rules (the
    module docstring). n = 1: every tensor whole."""
    conv_channels = conv_channels and GN_GROUPS % n == 0
    if n <= 1:
        return {k: None for k in shapes}
    return {k: _split(k, tuple(s), shapes, n, head_dim, conv_channels) for k, s in shapes.items()}


def block(t: torch.Tensor, split: Optional[Split], index: int, n: int) -> torch.Tensor:
    """Rank `index`'s block of the whole tensor t under `split` (t itself
    when whole): of each of its `pieces` parts along `split.dim`, the
    index-th of n equal slices, concatenated."""
    if split is None:
        return t
    part = t.shape[split.dim] // split.pieces
    step = part // n
    return torch.cat([t.narrow(split.dim, p * part + index * step, step) for p in range(split.pieces)], split.dim)


def row_layers(plan: Dict[str, Optional[Split]]) -> int:
    """The plan's row layers that split: the model all-reduces of one UNet pass."""
    return sum(1 for s in plan.values() if s is not None and s.kind == "row")


def is_sharded(module: torch.nn.Module) -> bool:
    return getattr(module, "tp_plan", None) is not None


def _refuse_state_dict(module, prefix, keep_vars):
    raise RuntimeError(f"the UNet holds this rank's slices of the model axis: its state dict is no checkpoint "
                       f"(exporting a sharded UNet is {TRAINING_HALF})")


def shard_unet_tp_(unet: torch.nn.Module, group) -> Optional[Dict[str, Optional[Split]]]:
    """Split the whole, loaded VC2 UNet over `group` (an AxisGroup of the
    mesh's model axis) in place, once, by `tp_plan` with the UNet's head
    dim and the conv channels split (JAX's vc2.py:231-248): each split
    parameter becomes this rank's block, the GroupNorms in front of the row
    convs take 32 / n groups, and the modules that run split layers get
    `model_group` (their heads: this rank's). Returns the plan (also
    `unet.tp_plan`); a group of one rank changes nothing (None). Afterwards
    the UNet refuses `state_dict()` (a rank's slices are never a
    checkpoint) and a second split."""
    from ..models.layers import CrossAttention, FeedForward, ResBlock, TemporalConvBlock

    if is_sharded(unet):
        raise ValueError("the UNet is split over the model axis already: it cannot be whole again or split again")
    n = 1 if group is None else group.size
    if n <= 1:
        return None
    params = dict(unet.named_parameters())
    plan = tp_plan({k: tuple(p.shape) for k, p in params.items()}, n, unet.cfg.num_head_channels)
    with torch.no_grad():
        for key, split in plan.items():
            if split is not None:
                params[key].data = block(params[key].data, split, group.index, n).clone()
    split = {k.rsplit(".", 1)[0] for k, s in plan.items() if s is not None}
    for name, m in unet.named_modules():
        if isinstance(m, CrossAttention) and f"{name}.to_q" in split:
            m.heads //= n
        elif isinstance(m, ResBlock) and f"{name}.out_layers.3" in split:
            m.out_layers[0].num_groups //= n
        elif isinstance(m, TemporalConvBlock) and f"{name}.conv2.3" in split:
            for stage in (m.conv2, m.conv4):
                stage[0].num_groups //= n
        elif not (isinstance(m, FeedForward) and f"{name}.net.2" in split):
            continue
        m.model_group = group
    unet.tp_plan = plan
    unet.register_state_dict_pre_hook(_refuse_state_dict)
    return plan


def refuse_model_axis(mesh, what: str) -> None:
    """Raise when `mesh` has a model axis of more than one rank: `what`
    does not take it yet."""
    if mesh is not None and mesh.model > 1:
        raise NotImplementedError(f"{what}: the model axis (tensor parallelism, --model-shards {mesh.model}) runs "
                                  f"VC2 sampling and serving only; {what} under it is {TRAINING_HALF}")
