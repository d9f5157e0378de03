"""The reference's `unet_lora.pt` LoRA files for the VC2 UNet (port of
t2v_turbo_tpu/io/lora_import.py, VC2 part, and of the LoRA half of
t2v_turbo_tpu/io/torch_export.py).

The file is a flat list [up_0, down_0, up_1, down_1, ...] in the reference's
`named_modules()` order over every Linear, Conv2d and Conv3d of the UNet
(reference utils/lora.py:263-307, 582-596). `lora_module_order` gives that
order from the UNet config (the reference registers `ff` before `attn2`
in a BasicTransformerBlock and `proj_in`, the blocks, `proj_out` in every
transformer; the port's modules hold the same names). The tensors are the
`lora_up` / `lora_down` weights, the layout `lora.py` keeps its factors in.

- `load_lora_pt`: the list, as f32 tensors.
- `apply_lora_pt`: fold it into a UNet state dict with alpha = 1
  (`collapse_lora`, reference utils/lora.py:793-860).
- `export_lora_pt`: factors -> the list (zero pairs for modules without a
  factor), for the reference's loader.
- `flax_path`: a module name -> the JAX package's parameter path, so the
  factors can be written in the JAX trainer's `unet_lora.npz` layout
  (io/convert.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..models.unet_vc2 import UNetConfig


def _btb_order(prefix: str) -> List[Tuple[str, str]]:
    """BasicTransformerBlock: attn1, ff, attn2 (the reference registers ff before attn2)."""
    attn = lambda a: [(f"{prefix}.{a}.{t}", "linear") for t in ("to_q", "to_k", "to_v", "to_out.0")]
    return attn("attn1") + [(f"{prefix}.ff.net.0.proj", "linear"), (f"{prefix}.ff.net.2", "linear")] \
        + attn("attn2")


def _transformer_order(prefix: str, depth: int, linear_proj: bool = True) -> List[Tuple[str, str]]:
    blocks = [x for d in range(depth) for x in _btb_order(f"{prefix}.transformer_blocks.{d}")]
    if not linear_proj:  # init_attn: Conv1d projections, not in the search classes
        return blocks
    return [(f"{prefix}.proj_in", "linear")] + blocks + [(f"{prefix}.proj_out", "linear")]


def _resblock_order(prefix: str, has_skip: bool) -> List[Tuple[str, str]]:
    out = [(f"{prefix}.in_layers.2", "conv2d"), (f"{prefix}.emb_layers.1", "linear"),
           (f"{prefix}.out_layers.3", "conv2d")]
    if has_skip:
        out.append((f"{prefix}.skip_connection", "conv2d"))
    return out + [(f"{prefix}.temopral_conv.conv{i}.{2 if i == 1 else 3}", "conv3d")
                  for i in range(1, 5)]


def lora_module_order(cfg: UNetConfig) -> List[Tuple[str, str]]:
    """(module name, kind) of every LoRA-injected layer, in `unet_lora.pt` order."""
    mc = cfg.model_channels
    order = [("time_embed.0", "linear"), ("time_embed.2", "linear"),
             ("fps_embedding.0", "linear"), ("fps_embedding.2", "linear")]
    if cfg.time_cond_proj_dim is not None:
        order.append(("time_cond_proj", "linear"))

    order.append(("input_blocks.0.0", "conv2d"))
    ds, ch, ti = 1, mc, 1
    chans = [mc]
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            order += _resblock_order(f"input_blocks.{ti}.0", has_skip=ch != mult * mc)
            ch = mult * mc
            chans.append(ch)
            if ds in cfg.attention_resolutions:
                order += _transformer_order(f"input_blocks.{ti}.1", cfg.transformer_depth)
                order += _transformer_order(f"input_blocks.{ti}.2", cfg.temporal_transformer_depth)
            ti += 1
        if level != len(cfg.channel_mult) - 1:
            order.append((f"input_blocks.{ti}.0.op", "conv2d"))
            chans.append(ch)
            ti += 1
            ds *= 2

    # input_blocks is registered before init_attn
    order += _transformer_order("init_attn.0", cfg.temporal_transformer_depth, linear_proj=False)
    order += _resblock_order("middle_block.0", False)
    order += _transformer_order("middle_block.1", cfg.transformer_depth)
    order += _transformer_order("middle_block.2", cfg.temporal_transformer_depth)
    order += _resblock_order("middle_block.3", False)

    oi = 0
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            out_ch = mult * mc
            order += _resblock_order(f"output_blocks.{oi}.0", has_skip=ch + chans.pop() != out_ch)
            ch = out_ch
            j = 0
            if ds in cfg.attention_resolutions:
                order += _transformer_order(f"output_blocks.{oi}.1", cfg.transformer_depth)
                order += _transformer_order(f"output_blocks.{oi}.2", cfg.temporal_transformer_depth)
                j = 2
            if level and i == cfg.num_res_blocks:
                order.append((f"output_blocks.{oi}.{j + 1}.conv", "conv2d"))
                ds //= 2
            oi += 1
    order.append(("out.2", "conv2d"))
    return order


def load_lora_pt(path: str) -> List[torch.Tensor]:
    """A reference `unet_lora.pt`: the flat [up, down, ...] list, in f32."""
    weights = torch.load(path, map_location="cpu", weights_only=True)
    return [w.float() for w in weights]


def apply_lora_pt(state_dict: Dict[str, torch.Tensor], weights, cfg: UNetConfig,
                  alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """Fold a [up, down, ...] list into a UNet state dict: W += alpha * up @ down."""
    order = lora_module_order(cfg)
    if len(weights) != 2 * len(order):
        raise ValueError(
            f"lora file has {len(weights)} tensors, expected {2 * len(order)} for this config"
        )
    out = dict(state_dict)
    for idx, (name, _) in enumerate(order):
        w = out[f"{name}.weight"]
        up, down = (torch.as_tensor(t, dtype=torch.float32) for t in weights[2 * idx: 2 * idx + 2])
        delta = (up.flatten(1) @ down.flatten(1)).reshape(w.shape)
        out[f"{name}.weight"] = (w.float() + alpha * delta.to(w.device)).to(w.dtype)
    return out


def export_lora_pt(factors, cfg: UNetConfig, shapes: Dict[str, torch.Size],
                   rank: int = None) -> List[torch.Tensor]:
    """Factors -> the reference's [up_0, down_0, ...] list in `unet_lora.pt`
    order (f32, CPU). Modules without a factor get zero pairs (a no-op on
    load), shaped from `shapes` (module name -> weight shape)."""
    order = lora_module_order(cfg)
    names = {n for n, _ in order}
    extra = sorted(set(factors) - names)
    if extra:
        raise ValueError(f"{len(extra)} factors have no unet_lora.pt slot (first: {extra[0]})")
    if rank is None:
        if not factors:
            raise ValueError("no factors and no rank: pass rank= for an all-zero list")
        rank = next(iter(factors.values()))["down"].shape[0]
    out: List[torch.Tensor] = []
    for name, _ in order:
        if name in factors:
            fac = factors[name]
            out += [fac["up"].detach().float().cpu(), fac["down"].detach().float().cpu()]
        else:
            shape = tuple(shapes[name])
            out += [torch.zeros((shape[0], rank) + (1,) * (len(shape) - 2)),
                    torch.zeros((rank,) + shape[1:])]
    return out


# module name -> the JAX package's parameter path (its `_translate`)
_REST_MAP = {
    "in_layers.2": ("in_conv",), "emb_layers.1": ("emb_proj",), "out_layers.3": ("out_conv",),
    "skip_connection": ("skip_connection",), "proj_in": ("proj_in",), "proj_out": ("proj_out",),
}


def _rest_path(rest: List[str], name: str) -> Tuple[str, ...]:
    joined = ".".join(rest)
    if joined in _REST_MAP:
        return _REST_MAP[joined]
    if rest[0] == "temopral_conv":
        return ("temporal_conv", rest[1])
    if rest[0] == "transformer_blocks":
        inner = rest[2:]
        if inner[0] in ("attn1", "attn2"):
            return (f"blocks_{rest[1]}", inner[0], inner[1])
        if inner[0] == "ff":
            return (f"blocks_{rest[1]}", "ff", "proj" if inner[-1] == "proj" else "out")
    raise KeyError(name)


def flax_path(name: str) -> Tuple[str, ...]:
    """A LoRA target's module name -> its kernel's path in the JAX UNet params."""
    parts = name.split(".")
    if name == "out.2":
        return ("out_conv",)
    if parts[0] in ("time_embed", "fps_embedding"):
        return (f"{parts[0]}_{parts[1]}",)
    if parts[0] == "time_cond_proj":
        return ("time_cond_proj",)
    if name == "input_blocks.0.0":
        return ("conv_in",)
    if parts[0] == "init_attn":
        return ("init_attn",) + _rest_path(parts[2:], name)
    if parts[0] == "input_blocks":
        if parts[3] == "op":
            return (f"input_blocks_{int(parts[1]) - 1}_0", "op")
        return (f"input_blocks_{int(parts[1]) - 1}_{parts[2]}",) + _rest_path(parts[3:], name)
    if parts[0] == "middle_block":
        return (f"middle_block_{parts[1]}",) + _rest_path(parts[2:], name)
    if parts[0] == "output_blocks":
        if parts[3] == "conv":
            return (f"output_blocks_{parts[1]}_{parts[2]}", "conv")
        return (f"output_blocks_{parts[1]}_{parts[2]}",) + _rest_path(parts[3:], name)
    raise KeyError(name)
