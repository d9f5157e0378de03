"""CLIP-style vision towers of the reward models (port of
t2v_turbo_tpu/rewards/vit.py).

- `VisionTransformer`: the per-image open_clip ViT (class token, patch conv,
  pre/post LayerNorm, projection); ViT-H/14 is the tower behind the `clip`,
  `hpsv2` and `pick` image rewards.
- `VideoVisionTransformer`: ViCLIP's joint space-time ViT-L/14: a (1, P, P)
  Conv3d patch embedding, a spatial position per patch and a temporal one
  per frame, one transformer over [cls] + N*T tokens ordered (n, t).

Both take channels-last normalised pixels, as the JAX modules, and are
differentiable with respect to them: the reward losses backpropagate
through decoded frames into the student. Submodule names are the reference
checkpoints' (`conv1.weight`, `transformer.resblocks.{i}.attn.in_proj_weight`,
`ln_post`, `proj`, ...; ViCLIP's `temporal_positional_embedding` and its
Conv3d `conv1.weight` of shape (O, I, 1, P, P)), so a tower's state dict
loads strictly. The blocks are the text tower's without the causal mask;
their attention goes through `sdpa` (flash for ViCLIP's heads of 64, the
plain path for ViT-H's 80, as the JAX package keeps `attention_xla` there).
The JAX package's `scan_layers` (one scanned block over stacked weights)
only shrinks XLA's programs and has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from ..models.clip_text import ResidualAttentionBlock, quick_gelu  # noqa: F401 (re-exported)
from ..models.layers import LayerNorm, compute_dtype


class ViTBlock(ResidualAttentionBlock):
    """A vision block: the text block's keys, no causal mask."""

    def __init__(self, width: int, heads: int, quick_gelu: bool = False):
        super().__init__(width, heads, quick_gelu=quick_gelu, causal=False)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_dim: int = 1024
    quick_gelu: bool = False


VIT_H_14 = ViTConfig()  # open_clip ViT-H/14 (HPSv2 / CLIP-H / PickScore)
VIT_L_14 = ViTConfig(width=1024, layers=24, heads=16, output_dim=768)


@dataclasses.dataclass(frozen=True)
class VideoViTConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    output_dim: int = 768
    num_frames: int = 8
    quick_gelu: bool = True  # ViCLIP uses QuickGELU


class _Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ViTBlock(cfg.width, cfg.heads, cfg.quick_gelu) for _ in range(cfg.layers)
        )


class _Tower(nn.Module):
    """What the two towers share: the class token, the positional table,
    pre/post LayerNorm, the blocks and the projection of the class token."""

    def __init__(self, cfg, n_tokens: int):
        super().__init__()
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(n_tokens + 1, cfg.width))
        self.ln_pre = LayerNorm(cfg.width)
        self.transformer = _Transformer(cfg)
        self.ln_post = LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.empty(cfg.width, cfg.output_dim))

    def _encode(self, x):
        """(B, 1 + N, width) tokens, class token first -> (B, output_dim)."""
        x = self.ln_pre(x)
        for block in self.transformer.resblocks:
            x = block(x)
        x = self.ln_post(x[:, 0])
        return x @ self.proj.to(x.dtype)


class VisionTransformer(_Tower):
    def __init__(self, cfg: ViTConfig = VIT_H_14):
        super().__init__(cfg, (cfg.image_size // cfg.patch_size) ** 2)
        p = cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, p, stride=p, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised images -> (B, output_dim) features."""
        dtype = compute_dtype(self)
        x = self.conv1(x.permute(0, 3, 1, 2).to(dtype)).flatten(2).transpose(1, 2)  # (B, N, W)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        return self._encode(x)


class VideoVisionTransformer(_Tower):
    """ViCLIP's joint space-time tower (reference viclip_vision.py:105-199)."""

    def __init__(self, cfg: VideoViTConfig = VideoViTConfig()):
        super().__init__(cfg, (cfg.image_size // cfg.patch_size) ** 2)
        p = cfg.patch_size
        self.conv1 = nn.Conv3d(3, cfg.width, (1, p, p), stride=(1, p, p), bias=False)
        self.temporal_positional_embedding = nn.Parameter(torch.zeros(1, cfg.num_frames, cfg.width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) normalised frames -> (B, output_dim)."""
        dtype = compute_dtype(self)
        b, t = x.shape[:2]
        xf = self.conv1(x.permute(0, 4, 1, 2, 3).to(dtype))  # (B, W, T, gh, gw)
        xf = xf.flatten(3).permute(0, 2, 3, 1)  # (B, T, N, W)
        pos = self.positional_embedding.to(dtype)
        tpos = self.temporal_positional_embedding.to(dtype)
        xf = xf + pos[None, None, 1:]
        if t == 1:  # a single frame takes the mean temporal position
            xf = xf + tpos.mean(1)[:, None, None]
        else:
            xf = xf + tpos[:, :t, None]
        # tokens ordered (n, t), as the reference's '(b n) t m -> b (n t) m'
        xf = xf.transpose(1, 2).reshape(b, -1, xf.shape[-1])
        cls = (self.class_embedding.to(dtype) + pos[0]).expand(b, 1, -1)
        return self._encode(torch.cat([cls, xf], dim=1))
