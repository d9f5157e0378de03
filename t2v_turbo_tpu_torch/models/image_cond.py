"""Image-conditioned generation glue (port of t2v_turbo_tpu/models/image_cond.py).

The reference's image-conditioning stack (LatentVisualDiffusion,
ddpm3d.py:835-887, and its FrozenOpenCLIPImageEmbedder(V2),
lvdm/modules/encoders/condition.py:289-485):

- `clip_image_preprocess`: [-1, 1] images -> CLIP-normalised 224x224, by a
  bicubic resize that antialiases when it shrinks, as `jax.image.resize`
  and the reference's kornia resize do (without antialias it is off by
  ~0.5 at 320x512).
- `ImageCondEncoder`: the open_clip ViT-H/14 tower (`rewards.vit`) and a
  projection head: coarse, the pooled embedding -> `ImageProjModel`, 4
  tokens; finegrained, the tower's (1 + 256)-token output -> a 4-deep
  `Resampler`, 16 tokens (`get_image_embeds`, ddpm3d.py:881-887).
- `append_image_context`: the combined context that the image-attention
  UNet (`UNetConfig.use_image_attention`) splits back apart: the text rows
  padded by repeating the last one, or truncated, to 200, then the image
  tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..rewards.reward_fn import CLIP_MEAN, CLIP_STD  # open_clip's (reference condition.py:324-330)
from ..rewards.vit import VIT_H_14, ViTConfig, VisionTransformer
from .ip_resampler import ImageProjModel, Resampler
from .layers import TEXT_CONTEXT_LEN


def clip_image_preprocess(x: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[-1, 1] images (B, H, W, 3) -> CLIP-normalised (B, size, size, 3) f32
    (reference condition.py:332-345)."""
    x = F.interpolate(x.permute(0, 3, 1, 2).float(), size=(size, size), mode="bicubic", antialias=True,
                      align_corners=False)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)


class ImageCondEncoder(nn.Module):
    """The frozen image tower and its projection head -> (B, N,
    cross_attention_dim) context tokens; `finegrained` picks the Resampler
    (16 tokens from the tower's tokens) over ImageProjModel (4 from the
    pooled embedding), as LatentVisualDiffusion does (ddpm3d.py:836-879)."""

    def __init__(self, finegrained: bool = False, cross_attention_dim: int = 1024,
                 vit_cfg: Optional[ViTConfig] = None):
        super().__init__()
        cfg = vit_cfg or VIT_H_14
        self.finegrained = finegrained
        self.tower = VisionTransformer(cfg)
        if finegrained:
            self.image_proj_model = Resampler(dim=cfg.output_dim, depth=4, dim_head=64, heads=12, num_queries=16,
                                              embedding_dim=cfg.width, output_dim=cross_attention_dim)
        else:
            self.image_proj_model = ImageProjModel(cross_attention_dim, cfg.output_dim, 4)

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        """[-1, 1] images (B, H, W, 3) -> (B, N, cross_attention_dim)."""
        x = clip_image_preprocess(imgs, self.tower.cfg.image_size)
        return self.image_proj_model(self.tower(x, return_tokens=self.finegrained))


def append_image_context(text_ctx: torch.Tensor, img_tokens: torch.Tensor) -> torch.Tensor:
    """(B, S, D) text rows and (B, N, D) image tokens -> (B, TEXT_CONTEXT_LEN
    + N, D) in the text's dtype. Padding repeats the last text row, not
    zeros: a zero row would be a key with logit exactly 0 (to_k has no
    bias) and dilute the softmax over the real tokens."""
    b, s, d = text_ctx.shape
    n = TEXT_CONTEXT_LEN
    if s > n:
        text_ctx = text_ctx[:, :n]
    elif s < n:
        text_ctx = torch.cat([text_ctx, text_ctx[:, -1:].expand(b, n - s, d)], dim=1)
    return torch.cat([text_ctx, img_tokens.to(text_ctx.dtype)], dim=1)
