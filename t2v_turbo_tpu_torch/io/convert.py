"""Weight carry-over into the port's modules.

- JAX parameter trees (nested dicts of numpy arrays, as `flax` `init` or
  `t2v_turbo_tpu.io.torch_import` produce them) -> the port's state dicts,
  for the UNet, the VAE, the CLIP text towers and the reward vision towers.
  Each is the inverse of the JAX package's `import_unet_params` /
  `import_vae_params` / `import_clip_text_params` /
  `import_clip_text_pooled_params` / `import_clip_vision_params` /
  `import_viclip_params` (t2v_turbo_tpu/io/torch_import.py), written with
  numpy alone: this module imports neither jax nor flax.
- `split_vc2_checkpoint`: a VideoCrafter2 LatentDiffusion state dict ->
  (unet, vae, clip) state dicts with their prefixes stripped.
- `load_clip_text`: strict load of an open_clip text-tower state dict minus
  exactly the keys the penultimate tower does not hold.
- `lora_to_jax` / `lora_from_jax`: the port's LoRA factors (the reference's
  `LoraInjected*` layout, lora.py) <-> the JAX package's factor tree
  ({path: {"down" (in_f, r), "up" (r, out)}}, t2v_turbo_tpu/lora.py), which
  folds a conv kernel's (kh, kw, I) or (kt, 1, I) into in_f and keeps
  GEGLU's proj as in = C, out = 2F.

Layout conventions (JAX -> reference torch):
  Dense kernel (in, out)           -> Linear weight (out, in)
  Conv kernel (kh, kw, I, O)       -> Conv2d weight (O, I, kh, kw)
  temporal Conv kernel (3, 1, I, O) -> Conv3d weight (O, I, 3, 1, 1)
  Dense kernel of a 1x1 conv       -> Conv1d (O, I, 1) / Conv2d (O, I, 1, 1)
  GEGLU kernel (C, 2, F), bias (2, F) -> Linear (2F, C), (2F,)
  norm scale / bias                -> weight / bias
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.clip_text import unused_checkpoint_keys
from ..models.vae import VAEConfig

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=np.float32)))


def _lin(node, name, sd, conv_dims=0):
    """Dense -> Linear; with conv_dims > 0, a 1x1 Conv with that many
    trailing unit dims."""
    w = np.asarray(node["kernel"]).T
    sd[f"{name}.weight"] = _t(w.reshape(w.shape + (1,) * conv_dims))
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _conv2d(node, name, sd):
    sd[f"{name}.weight"] = _t(np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in node:
        sd[f"{name}.bias"] = _t(node["bias"])


def _conv_temporal(node, name, sd):
    k = np.asarray(node["kernel"])  # (kt, 1, I, O)
    kt, _, i, o = k.shape
    sd[f"{name}.weight"] = _t(k.reshape(kt, i, o).transpose(2, 1, 0).reshape(o, i, kt, 1, 1))
    sd[f"{name}.bias"] = _t(node["bias"])


def _norm(node, name, sd):
    sd[f"{name}.weight"] = _t(node["scale"])
    sd[f"{name}.bias"] = _t(node["bias"])


def _attn(node, p, sd):
    for n in ("to_q", "to_k", "to_v"):
        _lin(node[n], f"{p}.{n}", sd)
    _lin(node["to_out"], f"{p}.to_out.0", sd)


def _block(node, p, sd):
    _attn(node["attn1"], f"{p}.attn1", sd)
    _attn(node["attn2"], f"{p}.attn2", sd)
    for n in ("norm1", "norm2", "norm3"):
        _norm(node[n], f"{p}.{n}", sd)
    k = np.asarray(node["ff"]["proj"]["kernel"])  # (C, 2, F)
    sd[f"{p}.ff.net.0.proj.weight"] = _t(k.reshape(k.shape[0], -1).T)
    sd[f"{p}.ff.net.0.proj.bias"] = _t(np.asarray(node["ff"]["proj"]["bias"]).reshape(-1))
    _lin(node["ff"]["out"], f"{p}.ff.net.2", sd)


def _transformer(node, p, sd, conv1d_proj=False):
    _norm(node["norm"], f"{p}.norm", sd)
    _lin(node["proj_in"], f"{p}.proj_in", sd, conv_dims=int(conv1d_proj))
    _lin(node["proj_out"], f"{p}.proj_out", sd, conv_dims=int(conv1d_proj))
    d = 0
    while f"blocks_{d}" in node:
        _block(node[f"blocks_{d}"], f"{p}.transformer_blocks.{d}", sd)
        d += 1


def _resblock(node, p, sd):
    _norm(node["in_norm"], f"{p}.in_layers.0", sd)
    _conv2d(node["in_conv"], f"{p}.in_layers.2", sd)
    _lin(node["emb_proj"], f"{p}.emb_layers.1", sd)
    _norm(node["out_norm"], f"{p}.out_layers.0", sd)
    _conv2d(node["out_conv"], f"{p}.out_layers.3", sd)
    if "skip_connection" in node:
        _conv2d(node["skip_connection"], f"{p}.skip_connection", sd)
    if "temporal_conv" in node:
        tc = node["temporal_conv"]
        for i in range(1, 5):
            q = f"{p}.temopral_conv.conv{i}"  # the reference's spelling
            _norm(tc[f"norm{i}"], f"{q}.0", sd)
            _conv_temporal(tc[f"conv{i}"], f"{q}.{2 if i == 1 else 3}", sd)


def _layer(node, p, sd):
    """One entry of a UNet block list, told apart by its parameters."""
    if "in_norm" in node:
        _resblock(node, p, sd)
    elif "proj_in" in node:
        _transformer(node, p, sd)
    elif "op" in node:
        _conv2d(node["op"], f"{p}.op", sd)
    else:
        _conv2d(node["conv"], f"{p}.conv", sd)


def _blocks(p, prefix):
    """JAX names `{prefix}_{i}_{j}` -> {i: {j: node}}."""
    out: Dict[int, Dict[int, Mapping]] = {}
    for name, node in p.items():
        if name.startswith(prefix + "_"):
            i, j = (int(s) for s in name[len(prefix) + 1:].split("_"))
            out.setdefault(i, {})[j] = node
    return out


def unet_state_dict_from_jax(params: Mapping) -> StateDict:
    """flax UNetModel params -> the port's (and the reference's) UNet state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _conv2d(p["conv_in"], "input_blocks.0.0", sd)
    for name in ("time_embed", "fps_embedding"):
        _lin(p[f"{name}_0"], f"{name}.0", sd)
        _lin(p[f"{name}_2"], f"{name}.2", sd)
    if "time_cond_proj" in p:
        _lin(p["time_cond_proj"], "time_cond_proj", sd)
    _transformer(p["init_attn"], "init_attn.0", sd, conv1d_proj=True)
    # JAX input block i is torch input block i + 1 (torch block 0 is conv_in)
    for i, layers in _blocks(p, "input_blocks").items():
        for j, node in layers.items():
            _layer(node, f"input_blocks.{i + 1}.{j}", sd)
    j = 0
    while f"middle_block_{j}" in p:
        _layer(p[f"middle_block_{j}"], f"middle_block.{j}", sd)
        j += 1
    for i, layers in _blocks(p, "output_blocks").items():
        for j, node in layers.items():
            _layer(node, f"output_blocks.{i}.{j}", sd)
    _norm(p["out_norm"], "out.0", sd)
    _conv2d(p["out_conv"], "out.2", sd)
    return sd


def _ae_resblock(node, p, sd):
    for n in ("norm1", "norm2"):
        _norm(node[n], f"{p}.{n}", sd)
    for n in ("conv1", "conv2", "nin_shortcut"):
        if n in node:
            _conv2d(node[n], f"{p}.{n}", sd)


def _ae_mid(node, p, sd):
    _ae_resblock(node["mid_block_1"], f"{p}.mid.block_1", sd)
    _ae_resblock(node["mid_block_2"], f"{p}.mid.block_2", sd)
    a = node["mid_attn_1"]
    _norm(a["norm"], f"{p}.mid.attn_1.norm", sd)
    for n in ("q", "k", "v", "proj_out"):
        _lin(a[n], f"{p}.mid.attn_1.{n}", sd, conv_dims=2)


def vae_state_dict_from_jax(params: Mapping, cfg: VAEConfig = VAEConfig()) -> StateDict:
    """flax AutoencoderKL params -> the port's (and the reference's) VAE state dict."""
    p = params.get("params", params)
    enc, dec = p["encoder"], p["decoder"]
    sd: StateDict = {}
    n_levels = len(cfg.ch_mult)
    _conv2d(enc["conv_in"], "encoder.conv_in", sd)
    for lv in range(n_levels):
        for i in range(cfg.num_res_blocks):
            _ae_resblock(enc[f"down_{lv}_block_{i}"], f"encoder.down.{lv}.block.{i}", sd)
        if lv != n_levels - 1:
            _conv2d(enc[f"down_{lv}_downsample"], f"encoder.down.{lv}.downsample.conv", sd)
    _ae_mid(enc, "encoder", sd)
    _norm(enc["norm_out"], "encoder.norm_out", sd)
    _conv2d(enc["conv_out"], "encoder.conv_out", sd)

    _conv2d(dec["conv_in"], "decoder.conv_in", sd)
    _ae_mid(dec, "decoder", sd)
    for lv in range(n_levels):
        for i in range(cfg.num_res_blocks + 1):
            _ae_resblock(dec[f"up_{lv}_block_{i}"], f"decoder.up.{lv}.block.{i}", sd)
        if lv != 0:
            _conv2d(dec[f"up_{lv}_upsample"], f"decoder.up.{lv}.upsample.conv", sd)
    _norm(dec["norm_out"], "decoder.norm_out", sd)
    _conv2d(dec["conv_out"], "decoder.conv_out", sd)
    _lin(p["quant_conv"], "quant_conv", sd, conv_dims=2)
    _lin(p["post_quant_conv"], "post_quant_conv", sd, conv_dims=2)
    return sd


def _clip_blocks(p, sd):
    """`resblocks_{i}` (text or vision) -> `transformer.resblocks.{i}`."""
    for i in range(sum(k.startswith("resblocks_") for k in p)):
        node, rp = p[f"resblocks_{i}"], f"transformer.resblocks.{i}"
        _norm(node["ln_1"], f"{rp}.ln_1", sd)
        _norm(node["ln_2"], f"{rp}.ln_2", sd)
        sd[f"{rp}.attn.in_proj_weight"] = _t(np.asarray(node["in_proj"]["kernel"]).T)
        sd[f"{rp}.attn.in_proj_bias"] = _t(node["in_proj"]["bias"])
        _lin(node["out_proj"], f"{rp}.attn.out_proj", sd)
        _lin(node["c_fc"], f"{rp}.mlp.c_fc", sd)
        _lin(node["c_proj"], f"{rp}.mlp.c_proj", sd)


def clip_text_state_dict_from_jax(params: Mapping) -> StateDict:
    """flax CLIPTextModel params -> the port's open_clip-keyed state dict."""
    p = params.get("params", params)
    sd: StateDict = {
        "token_embedding.weight": _t(p["token_embedding"]),
        "positional_embedding": _t(p["positional_embedding"]),
    }
    _norm(p["ln_final"], "ln_final", sd)
    _clip_blocks(p, sd)
    return sd


def clip_text_pooled_state_dict_from_jax(params: Mapping) -> StateDict:
    """flax CLIPTextPooled params ({"tower", "text_projection"}) -> the
    port's `CLIPTextPooled` state dict (open_clip's text keys)."""
    p = params.get("params", params)
    return {**clip_text_state_dict_from_jax(p["tower"]), "text_projection": _t(p["text_projection"])}


def _vision_tower(p, sd):
    for n in ("class_embedding", "positional_embedding", "proj"):
        sd[n] = _t(p[n])
    _norm(p["ln_pre"], "ln_pre", sd)
    _norm(p["ln_post"], "ln_post", sd)
    _clip_blocks(p, sd)


def vit_state_dict_from_jax(params: Mapping) -> StateDict:
    """flax rewards.vit.VisionTransformer params -> the port's (open_clip's
    `visual.*` without the prefix) state dict."""
    p = params.get("params", params)
    sd: StateDict = {}
    _conv2d(p["conv1"], "conv1", sd)
    _vision_tower(p, sd)
    return sd


def video_vit_state_dict_from_jax(params: Mapping) -> StateDict:
    """flax rewards.vit.VideoVisionTransformer params -> the port's (ViCLIP's
    `vision_encoder.*` without the prefix) state dict; conv1 becomes the
    reference's Conv3d weight (O, I, 1, P, P)."""
    p = params.get("params", params)
    sd: StateDict = {"temporal_positional_embedding": _t(p["temporal_positional_embedding"])}
    _conv2d(p["conv1"], "conv1", sd)
    sd["conv1.weight"] = sd["conv1.weight"][:, :, None]
    _vision_tower(p, sd)
    return sd


def split_vc2_checkpoint(sd: Mapping) -> Tuple[dict, dict, dict]:
    """A VideoCrafter2 LatentDiffusion state dict -> (unet, vae, clip)."""
    prefixes = ("model.diffusion_model.", "first_stage_model.", "cond_stage_model.model.")
    parts: Tuple[dict, dict, dict] = ({}, {}, {})
    for k, v in sd.items():
        for prefix, part in zip(prefixes, parts):
            if k.startswith(prefix):
                part[k[len(prefix):]] = v
    return parts


def load_checkpoint(path: str) -> StateDict:
    """torch.load a reference checkpoint (a Lightning `state_dict` or a bare one)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj.get("state_dict", obj)


def load_clip_text(model, sd: Mapping) -> None:
    """Strictly load an open_clip text-tower state dict into the penultimate
    tower, after dropping exactly `unused_checkpoint_keys`."""
    drop = set(unused_checkpoint_keys(sd, model.cfg))
    model.load_state_dict({k: v for k, v in sd.items() if k not in drop}, strict=True)


def _lora_kind(shape) -> str:
    return {2: "linear", 4: "conv2d", 5: "conv3d"}[len(shape)]


def lora_to_jax(factors, prefix=("params",)) -> Dict[tuple, Dict[str, np.ndarray]]:
    """The port's factors -> the JAX factor tree, keyed by the kernel's
    path `prefix + flax path + ("kernel",)`, as the JAX trainer keys them."""
    from .lora_import import flax_path

    out = {}
    for name, fac in factors.items():
        down = fac["down"].detach().float().cpu().numpy()  # (r, I, *k)
        up = fac["up"].detach().float().cpu().numpy()  # (O, r, 1...)
        r, o = down.shape[0], up.shape[0]
        kind = _lora_kind(down.shape)
        if kind == "linear":
            d = down.T
        elif kind == "conv2d":  # (r, I, kh, kw) -> (kh, kw, I, r)
            d = down.transpose(2, 3, 1, 0).reshape(-1, r)
        else:  # (r, I, kt, 1, 1) -> (kt, 1, I, r)
            d = down.reshape(r, down.shape[1], down.shape[2]).transpose(2, 1, 0).reshape(-1, r)
        out[tuple(prefix) + flax_path(name) + ("kernel",)] = {
            "down": np.ascontiguousarray(d), "up": np.ascontiguousarray(up.reshape(o, r).T)}
    return out


def lora_from_jax(lora_flat, shapes) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX factor tree -> the port's factors; `shapes` maps each target
    module name to its weight shape (the JAX factors do not carry the
    conv kernel's spatial size)."""
    from .lora_import import flax_path

    by_path = {flax_path(name) + ("kernel",): name for name in shapes}
    out = {}
    for path, fac in lora_flat.items():
        key = tuple(path[1:]) if path and path[0] == "params" else tuple(path)
        name = by_path[key]
        shape = tuple(shapes[name])
        down, up = np.asarray(fac["down"], np.float32), np.asarray(fac["up"], np.float32)
        r = down.shape[1]
        kind = _lora_kind(shape)
        if kind == "linear":
            d = down.T
        elif kind == "conv2d":  # (kh * kw * I, r) -> (r, I, kh, kw)
            o, i, kh, kw = shape
            d = down.reshape(kh, kw, i, r).transpose(3, 2, 0, 1)
        else:  # (kt * I, r) -> (r, I, kt, 1, 1)
            o, i, kt = shape[:3]
            d = down.reshape(kt, i, r).transpose(2, 1, 0).reshape(r, i, kt, 1, 1)
        u = up.T.reshape((shape[0], r) + (1,) * (len(shape) - 2))
        out[name] = {"down": _t(d), "up": _t(u)}
    return out
