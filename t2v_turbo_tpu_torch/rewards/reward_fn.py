"""Differentiable reward models, image and video (port of
t2v_turbo_tpu/rewards/reward_fn.py).

Every reward is the cosine similarity of L2-normalised tower features,
    score(images, text_feats) = <img / (|img| + 1e-8), text_feats>,
with gradients through the image or video branch only: the text features
are computed once per batch without a graph (`encode_texts`), as the
reference's no-grad text branches.

Names follow the reference factory (reward_fn.py:342-358):
  clip, hpsv2, pick      the open_clip ViT-H/14 model (one architecture;
                         the checkpoints differ)
  weighted_hpsv2_clip    w0 * hpsv2 + w1 * clip
  vi_clip                ViCLIP-L video-text score
`img_reward` (BLIP) and `vi_clip2` (InternVideo2) are not ported yet.

Checkpoints: `ImageRewardModel.load_open_clip` takes an open_clip CLIP state
dict (`visual.*`, the text tower's keys, `logit_scale`);
`VideoRewardModel.load_viclip` a ViCLIP one (`vision_encoder.*`,
`text_encoder.*`). Both load strictly.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.clip_text import CLIPTextConfig, CLIPTextPooled
from ..models.layers import seeded_init_
from ..utils.tokenizer import CLIPTokenizer
from .vit import VIT_H_14, VideoViTConfig, VideoVisionTransformer, VisionTransformer, ViTConfig

# CLIP / ViCLIP pixel normalisation (reference CLIP_NORMALIZE / ViCLIP_NORMALIZE)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
VICLIP_MEAN = (0.485, 0.456, 0.406)
VICLIP_STD = (0.229, 0.224, 0.225)

OPEN_CLIP_H14_TEXT = CLIPTextConfig(vocab_size=49408, width=1024, heads=16, layers=24,
                                    context_length=77, penultimate=False)
VICLIP_TEXT = CLIPTextConfig(vocab_size=49408, width=768, heads=12, layers=12, context_length=77,
                             penultimate=False, quick_gelu=True)


def preprocess_images(images: torch.Tensor, size: int = 224, mean=CLIP_MEAN, std=CLIP_STD):
    """(..., H, W, 3) in [0, 1] -> resized, centre-cropped, normalised
    (..., size, size, 3), in f32.

    The short side goes to `size` (Python's `round` for the long side) by a
    bicubic resize that antialiases when it shrinks, as `jax.image.resize`
    does by default; `F.interpolate`'s default (no antialias) is off by
    ~0.5 at 320x512 -> 224x358. Differentiable (the reference resizes
    inside the gradient path).
    """
    lead, (h, w, c) = images.shape[:-3], images.shape[-3:]
    flat = images.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    scale = size / min(h, w)
    nh, nw = max(size, round(h * scale)), max(size, round(w * scale))
    flat = F.interpolate(flat, size=(nh, nw), mode="bicubic", antialias=True, align_corners=False)
    y, x = (nh - size) // 2, (nw - size) // 2
    flat = flat[:, :, y:y + size, x:x + size]
    m = torch.tensor(mean, device=flat.device)[:, None, None]
    s = torch.tensor(std, device=flat.device)[:, None, None]
    return ((flat - m) / s).permute(0, 2, 3, 1).reshape(*lead, size, size, c)


def _norm(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class _RewardModel(nn.Module):
    """The text side both models share."""

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """(B, proj_dim) normalised f32 text features, without a graph."""
        tower = self.text_tower()
        tokens = torch.as_tensor(self.tokenizer(list(texts)),
                                 device=tower.positional_embedding.device)
        with torch.no_grad():
            return _norm(tower(tokens).float())


class ImageRewardModel(_RewardModel):
    """CLIP-style image reward: a vision tower and a pooled text tower."""

    def __init__(self, vit_cfg: ViTConfig = VIT_H_14, text_cfg: CLIPTextConfig = OPEN_CLIP_H14_TEXT,
                 tokenizer=None):
        super().__init__()
        self.visual = VisionTransformer(vit_cfg)
        self.text = CLIPTextPooled(text_cfg, vit_cfg.output_dim)
        self.register_buffer("logit_scale", torch.tensor(math.log(100.0)))
        self.tokenizer = tokenizer or CLIPTokenizer(context_length=text_cfg.context_length)

    def text_tower(self):
        return self.text

    def score(self, images: torch.Tensor, text_feats: torch.Tensor, logits: bool = False):
        """images (B, H, W, 3) in [0, 1]; text_feats (B, D) normalised -> (B,) f32."""
        px = preprocess_images(images, self.visual.cfg.image_size, CLIP_MEAN, CLIP_STD)
        s = (_norm(self.visual(px).float()) * text_feats.detach()).sum(-1)
        return s * self.logit_scale.exp() if logits else s

    def forward(self, images, texts):
        return self.score(images, self.encode_texts(texts))

    def load_open_clip(self, sd) -> None:
        """Strictly load an open_clip CLIP state dict: `visual.*` into the
        vision tower, `logit_scale`, and every other key into the text tower."""
        visual = {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
        text = {k: v for k, v in sd.items() if not k.startswith("visual.") and k != "logit_scale"}
        self.visual.load_state_dict(visual, strict=True)
        self.text.load_state_dict(text, strict=True)
        with torch.no_grad():
            self.logit_scale.copy_(torch.as_tensor(sd["logit_scale"]).reshape(()))


class VideoRewardModel(_RewardModel):
    """ViCLIP-style video reward; submodules keyed as a ViCLIP checkpoint."""

    def __init__(self, vit_cfg: VideoViTConfig = VideoViTConfig(),
                 text_cfg: CLIPTextConfig = VICLIP_TEXT, tokenizer=None):
        super().__init__()
        self.vision_encoder = VideoVisionTransformer(vit_cfg)
        self.text_encoder = CLIPTextPooled(text_cfg, vit_cfg.output_dim)
        self.tokenizer = tokenizer or CLIPTokenizer(context_length=text_cfg.context_length)

    def text_tower(self):
        return self.text_encoder

    def score(self, videos: torch.Tensor, text_feats: torch.Tensor):
        """videos (B, T, H, W, 3) in [0, 1]; text_feats (B, D) -> (B,) f32."""
        px = preprocess_images(videos, self.vision_encoder.cfg.image_size, VICLIP_MEAN, VICLIP_STD)
        return (_norm(self.vision_encoder(px).float()) * text_feats.detach()).sum(-1)

    def forward(self, videos, texts):
        return self.score(videos, self.encode_texts(texts))

    def load_viclip(self, sd) -> None:
        """Strictly load a ViCLIP state dict; its contrastive temperature
        `temp`, which scoring does not use, is the one key dropped."""
        self.load_state_dict({k: v for k, v in sd.items() if k != "temp"}, strict=True)


def build_image_reward_model(state_dict=None, tokenizer=None, vit_cfg: ViTConfig = VIT_H_14,
                             text_cfg: CLIPTextConfig = OPEN_CLIP_H14_TEXT, seed: int = 0,
                             device=None) -> ImageRewardModel:
    """An open_clip state dict, or seeded random weights when it is None."""
    with torch.device(device or "cpu"):
        model = ImageRewardModel(vit_cfg, text_cfg, tokenizer)
    if state_dict is None:
        seeded_init_(model, seed)
    else:
        model.load_open_clip(state_dict)
    return model


def build_video_reward_model(state_dict=None, tokenizer=None,
                             vit_cfg: VideoViTConfig = VideoViTConfig(),
                             text_cfg: CLIPTextConfig = VICLIP_TEXT, seed: int = 0,
                             device=None) -> VideoRewardModel:
    """A ViCLIP state dict, or seeded random weights when it is None."""
    with torch.device(device or "cpu"):
        model = VideoRewardModel(vit_cfg, text_cfg, tokenizer)
    if state_dict is None:
        seeded_init_(model, seed)
    else:
        model.load_viclip(state_dict)
    return model


def get_reward_fn(name: str, state_dict=None, **kw) -> Callable:
    """The reference factory's names (reward_fn.py:342-358)."""
    if name in ("clip", "hpsv2", "pick"):
        return build_image_reward_model(state_dict, **kw)
    if name == "weighted_hpsv2_clip":
        w: Tuple[float, float] = kw.pop("weights_pair", (1.0, 5.0))
        hps = build_image_reward_model(kw.pop("hpsv2_state_dict", None), **kw)
        clip = build_image_reward_model(kw.pop("clip_state_dict", None), **kw)

        def score(images, texts):
            return w[0] * hps(images, texts) + w[1] * clip(images, texts)

        return score
    if name == "vi_clip":
        return build_video_reward_model(state_dict, **kw)
    if name in ("img_reward", "vi_clip2"):
        raise NotImplementedError(
            f"reward {name!r} (the BLIP / InternVideo2 towers) is not ported yet: ROADMAP A10")
    raise ValueError(f"unknown reward fn {name!r}")
