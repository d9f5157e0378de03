"""The ModelScope backbone's diffusers multi-file folder (port of
t2v_turbo_tpu/io/torch_import.py:832-1025; the reference's app_ms.py:181-227
loads its tokenizer/, text_encoder/, vae/ and unet/ subfolders with
`from_pretrained`).

- `read_safetensors`: a `.safetensors` file without the `safetensors`
  package: an 8-byte little-endian header length, a JSON header of
  {name: {dtype, shape, data_offsets}} (and "__metadata__"), then the raw
  little-endian buffers.
- `find_weight_file` / `load_state_dict_any`: a subfolder's weight file, by
  JAX's search order (diffusion_pytorch_model.bin, pytorch_model.bin,
  *.bin, *.safetensors, *.pt, *.ckpt).
- `ms_unet_state_dict`: a diffusers UNet3DConditionModel state dict ready
  for a strict load into models/unet_ms.py: 1x1-conv transformer
  projections (use_linear_projection=False checkpoints) made Linear, and a
  zero `time_embedding.cond_proj` where the config has one and the teacher
  does not (as `convert.student_unet_state_dict` does for VC2).
- `diffusers_vae_to_orig`: a diffusers AutoencoderKL state dict renamed to
  the original (lvdm / SD) layout the port's VAE holds: down_blocks ->
  down.{l}.block, the decoder's up_blocks reversed (diffusers numbers them
  in execution order, the original by resolution), mid_block ->
  mid.block_1 / attn_1 / block_2 with the attention's Linear weights made
  1x1 convs, conv_shortcut -> nin_shortcut, conv_norm_out -> norm_out.
- `hf_clip_text_config`: the text tower's config from an HF CLIPTextModel
  state dict and its config.json (the layer count from the keys;
  quick_gelu from `hidden_act`; the heads from `num_attention_heads`,
  width / 64 without one; penultimate off: MS conditions on the last
  layer).
- `load_ms_components`: all three, as state dicts the port's modules load
  strictly, and the text config.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..models.clip_text import CLIPTextConfig

StateDict = Dict[str, torch.Tensor]

_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> StateDict:
    """Every tensor of a .safetensors file, on the CPU (sharing one buffer
    read from the file)."""
    if sys.byteorder != "little":
        raise RuntimeError("read_safetensors reads little-endian buffers on a little-endian host only")
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    if len(blob) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    n = int.from_bytes(blob[:8], "little")
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} runs past the file's {len(blob)} bytes")
    header = json.loads(blob[8:8 + n].decode("utf-8"))
    header.pop("__metadata__", None)
    data = memoryview(blob)[8 + n:]
    out: StateDict = {}
    for name, info in header.items():
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which the reader does not take")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(data) or end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name}'s offsets {begin}..{end} do not hold {shape} {info['dtype']}")
        t = torch.frombuffer(data[begin:end], dtype=dtype) if count else torch.empty(0, dtype=dtype)
        out[name] = t.reshape(shape)
    return out


def find_weight_file(folder: str) -> str:
    for pattern in ("diffusion_pytorch_model.bin", "pytorch_model.bin", "*.bin", "*.safetensors", "*.pt", "*.ckpt"):
        hits = sorted(glob.glob(os.path.join(folder, pattern)))
        if hits:
            return hits[0]
    raise FileNotFoundError(f"no weight file under {folder}")


def load_state_dict_any(path: str) -> StateDict:
    """A .safetensors file by `read_safetensors`, anything else by torch.load."""
    from .convert import load_checkpoint

    return read_safetensors(path) if path.endswith(".safetensors") else dict(load_checkpoint(path))


_PROJ = re.compile(r".*(attentions|transformer_in)(\.\d+)?\.(proj_in|proj_out)\.weight$")


def ms_unet_state_dict(sd: Mapping, cfg) -> StateDict:
    """A diffusers MS UNet state dict -> one that models/unet_ms.py of
    config `cfg` loads strictly (see the module docstring)."""
    out = {k: (v.reshape(v.shape[:2]) if _PROJ.match(k) and v.dim() == 4 else v) for k, v in sd.items()}
    key = "time_embedding.cond_proj.weight"
    if cfg.time_cond_proj_dim is not None and key not in out:
        out[key] = torch.zeros(cfg.block_out_channels[0], cfg.time_cond_proj_dim)
    return out


def diffusers_vae_to_orig(sd: Mapping) -> StateDict:
    """A diffusers AutoencoderKL state dict in the original layout (see the
    module docstring; JAX `_diffusers_vae_to_orig`)."""
    n_up = 1 + max((int(m.group(1)) for k in sd for m in [re.match(r"decoder\.up_blocks\.(\d+)\.", k)] if m),
                   default=-1)
    out: StateDict = {}
    for k, v in sd.items():
        nk = k
        for pat, rep in ((r"mid_block\.resnets\.0\.", "mid.block_1."), (r"mid_block\.resnets\.1\.", "mid.block_2."),
                         (r"mid_block\.attentions\.0\.group_norm\.", "mid.attn_1.norm."),
                         (r"mid_block\.attentions\.0\.to_q\.", "mid.attn_1.q."),
                         (r"mid_block\.attentions\.0\.to_k\.", "mid.attn_1.k."),
                         (r"mid_block\.attentions\.0\.to_v\.", "mid.attn_1.v."),
                         (r"mid_block\.attentions\.0\.to_out\.0\.", "mid.attn_1.proj_out."),
                         (r"down_blocks\.(\d+)\.resnets\.(\d+)\.", r"down.\1.block.\2."),
                         (r"down_blocks\.(\d+)\.downsamplers\.0\.conv\.", r"down.\1.downsample.conv.")):
            nk = re.sub(pat, rep, nk)
        m = re.match(r"decoder\.up_blocks\.(\d+)\.(.+)", nk)
        if m:
            rest = re.sub(r"^resnets\.(\d+)\.", r"block.\1.", m.group(2))
            rest = re.sub(r"^upsamplers\.0\.conv\.", "upsample.conv.", rest)
            nk = f"decoder.up.{n_up - 1 - int(m.group(1))}.{rest}"
        nk = nk.replace("conv_shortcut", "nin_shortcut").replace("conv_norm_out", "norm_out")
        if ".mid.attn_1." in f".{nk}" and nk.endswith(".weight") and v.dim() == 2:
            v = v[:, :, None, None]  # diffusers' Linear -> the original's 1x1 conv
        out[nk] = v
    return out


def hf_clip_text_config(sd: Mapping, hf_config: Optional[dict] = None) -> CLIPTextConfig:
    """The CLIPTextConfig of an HF CLIPTextModel state dict (see the module
    docstring)."""
    from ..rewards.reward_fn import hf_text_prefix

    tp = hf_text_prefix(sd)
    vocab, width = sd[f"{tp}embeddings.token_embedding.weight"].shape
    layers = 0
    while f"{tp}encoder.layers.{layers}.self_attn.q_proj.weight" in sd:
        layers += 1
    hf_config = hf_config or {}
    return CLIPTextConfig(vocab_size=int(vocab), width=int(width),
                          heads=int(hf_config.get("num_attention_heads", int(width) // 64)), layers=layers,
                          context_length=int(sd[f"{tp}embeddings.position_embedding.weight"].shape[0]),
                          penultimate=False, quick_gelu=hf_config.get("hidden_act", "quick_gelu") == "quick_gelu")


def load_ms_components(ms_dir: str):
    """{"unet": the diffusers UNet state dict (keys as they are), "vae": the
    VAE's in the original layout, "text": the text tower's in open_clip's
    layout, "text_cfg": its CLIPTextConfig} from a diffusers folder with
    unet/, vae/ and text_encoder/ subfolders. The tokenizer/ folder holds
    the CLIP BPE vocabulary the port's tokenizer already carries."""
    from ..rewards.reward_fn import hf_clip_text_to_open_clip

    def weights(sub):
        return load_state_dict_any(find_weight_file(os.path.join(ms_dir, sub)))

    text_sd = weights("text_encoder")
    cfg_path = os.path.join(ms_dir, "text_encoder", "config.json")
    hf_config = None
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            hf_config = json.load(f)
    return {"unet": weights("unet"), "vae": diffusers_vae_to_orig(weights("vae")),
            "text": hf_clip_text_to_open_clip(text_sd), "text_cfg": hf_clip_text_config(text_sd, hf_config)}
