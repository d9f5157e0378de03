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
  img_reward             ImageReward (BLIP, rewards/blip.py)
  vi_clip2               InternVideo2-Stage2 (rewards/internvideo2.py)
For the trainer, `BlipTrainReward` and `InternVideo2TrainReward` give the
last two the interface the LCD adapters call: `encode_texts` makes the
per-batch field (BERT token ids for BLIP, whose text branch reads the
image states; normalised features for InternVideo2) and
`score(images in [0, 1], field)` resizes and normalises, then scores.

Checkpoints: `ImageRewardModel.load_open_clip` takes an open_clip CLIP state
dict (`visual.*`, the text tower's keys, `logit_scale`), `load_hf_clip` an
HF transformers `CLIPModel` one (`text_model.*`, `vision_model.*`,
`text_projection`, `visual_projection`, `logit_scale`: PickScore's layout);
`VideoRewardModel.load_viclip` a ViCLIP one (`vision_encoder.*`,
`text_encoder.*`). All load strictly.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
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

    def load_hf_clip(self, sd) -> None:
        """Strictly load an HF `CLIPModel` state dict (`hf_clip_to_open_clip`)."""
        self.load_open_clip(hf_clip_to_open_clip(sd))

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


def _hf_tower(rest: dict, tower: str, dst: str, out: dict, names: list) -> None:
    """Move an HF CLIP encoder's layers `{tower}encoder.layers.{i}` from
    `rest` into `out` as open_clip's `{dst}resblocks.{i}` (q, k and v packed
    into `attn.in_proj_*`); the other per-layer tensors are added to
    `names` as (HF name, open_clip name) pairs for the caller to move."""
    take, i = rest.pop, 0
    while f"{tower}encoder.layers.{i}.layer_norm1.weight" in rest:
        src, blk = f"{tower}encoder.layers.{i}", f"{dst}resblocks.{i}"
        for n in ("weight", "bias"):
            out[f"{blk}.attn.in_proj_{n}"] = torch.cat(
                [torch.as_tensor(take(f"{src}.self_attn.{p}_proj.{n}")) for p in "qkv"])
        names += [(f"{src}.{hf}", f"{blk}.{oc}") for hf, oc in (
            ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"), ("self_attn.out_proj", "attn.out_proj"),
            ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"))]
        i += 1


def _move_pairs(rest: dict, out: dict, names: list, what: str) -> dict:
    for hf, oc in names:
        for n in ("weight", "bias"):
            out[f"{oc}.{n}"] = rest.pop(f"{hf}.{n}")
    if rest:
        raise RuntimeError(f"keys outside the HF {what} layout: {sorted(rest)[:5]}")
    return out


def hf_clip_to_open_clip(sd) -> dict:
    """An HF transformers `CLIPModel` state dict (PickScore's layout) -> the
    open_clip keys `load_open_clip` takes: the key table of the JAX
    package's `import_hf_clip_params` (t2v_turbo_tpu/io/torch_import.py:610),
    each layer's q, k and v packed into `in_proj` and the projections
    transposed from Linear weights to open_clip's matrices. The
    `position_ids` buffers HF keeps beside the position tables are dropped;
    any other key left unused raises."""
    rest = {k: v for k, v in sd.items() if not k.endswith("embeddings.position_ids")}
    take = rest.pop
    out = {
        "token_embedding.weight": take("text_model.embeddings.token_embedding.weight"),
        "positional_embedding": take("text_model.embeddings.position_embedding.weight"),
        "text_projection": torch.as_tensor(take("text_projection.weight")).T.contiguous(),
        "visual.conv1.weight": take("vision_model.embeddings.patch_embedding.weight"),
        "visual.class_embedding": take("vision_model.embeddings.class_embedding"),
        "visual.positional_embedding": take("vision_model.embeddings.position_embedding.weight"),
        "visual.proj": torch.as_tensor(take("visual_projection.weight")).T.contiguous(),
        "logit_scale": take("logit_scale"),
    }
    names = [("text_model.final_layer_norm", "ln_final"), ("vision_model.pre_layrnorm", "visual.ln_pre"),
             ("vision_model.post_layernorm", "visual.ln_post")]
    _hf_tower(rest, "text_model.", "transformer.", out, names)
    _hf_tower(rest, "vision_model.", "visual.transformer.", out, names)
    return _move_pairs(rest, out, names, "CLIPModel")


def hf_text_prefix(sd) -> str:
    """"text_model." for an HF CLIPTextModel state dict, "" for a bare one."""
    return "text_model." if any(k.startswith("text_model.") for k in sd) else ""


def hf_clip_text_to_open_clip(sd) -> dict:
    """An HF transformers `CLIPTextModel` state dict (the ModelScope
    backbone's text encoder) -> the open_clip text keys the port's
    `CLIPTextModel` loads (the JAX `import_hf_clip_text_model_params`
    table, t2v_turbo_tpu/io/torch_import.py:908-958): the embeddings, the
    layers packed as `hf_clip_to_open_clip` packs them, final_layer_norm ->
    ln_final. `position_ids` is dropped; any other key left unused raises."""
    tp = hf_text_prefix(sd)
    rest = {k: v for k, v in sd.items() if not k.endswith("embeddings.position_ids")}
    out = {"token_embedding.weight": rest.pop(f"{tp}embeddings.token_embedding.weight"),
           "positional_embedding": rest.pop(f"{tp}embeddings.position_embedding.weight")}
    names = [(f"{tp}final_layer_norm", "ln_final")]
    _hf_tower(rest, tp, "transformer.", out, names)
    return _move_pairs(rest, out, names, "CLIPTextModel")


def build_image_reward_model(state_dict=None, tokenizer=None, vit_cfg: ViTConfig = VIT_H_14,
                             text_cfg: CLIPTextConfig = OPEN_CLIP_H14_TEXT, seed: int = 0,
                             device=None) -> ImageRewardModel:
    """An open_clip or HF `CLIPModel` state dict (told apart by its
    `text_model.*` keys), or seeded random weights when it is None."""
    with torch.device(device or "cpu"):
        model = ImageRewardModel(vit_cfg, text_cfg, tokenizer)
    if state_dict is None:
        seeded_init_(model, seed)
    elif any(k.startswith("text_model.") for k in state_dict):
        model.load_hf_clip(state_dict)
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


class _HashTokenizer:
    """Deterministic stand-in for a BERT vocabulary (smoke runs and tests
    without a vocab.txt): a stable per-word hash id, [CLS] 101 ... [SEP]
    102, zero padding; -> (ids, mask) int32, as the JAX package's. Not for
    real training: pass a `BertWordPieceTokenizer` (utils/bert_tokenizer.py)."""

    def __init__(self, max_length: int = 35, vocab_size: int = 30522):
        self.max_length, self.vocab_size = max_length, vocab_size

    def __call__(self, texts):
        import hashlib

        out = np.zeros((len(texts), self.max_length), np.int32)
        for i, t in enumerate(texts):
            words = str(t).lower().split()[: self.max_length - 2]
            ids = [101] + [
                int(hashlib.md5(w.encode()).hexdigest()[:6], 16) % (self.vocab_size - 999) + 999
                for w in words
            ] + [102]
            out[i, : len(ids)] = ids
        return out, (out != 0).astype(np.int32)


class BlipTrainReward(nn.Module):
    """The trainer's facade over rewards.blip.ImageRewardModel (reference
    reward_fn.py:128-174): the per-batch field is BERT token ids at the
    BLIP tokenizer's max length 35, which ride through the
    `reward_text_feats` batch slot as integers; `score` resizes to the
    ViT's size (bicubic, CLIP normalisation), masks the padding (id 0) and
    returns -relu(-r + 2)."""

    def __init__(self, rm, tokenizer=None):
        super().__init__()
        self.rm = rm
        self.tokenizer = tokenizer or _HashTokenizer(max_length=35)

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        """(B, max_length) int32 token ids, on the host."""
        ids = self.tokenizer(list(texts))
        return torch.as_tensor(ids[0] if isinstance(ids, tuple) else ids, dtype=torch.int32)

    def score(self, images: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1]; token_ids (B, S) -> (B,) f32."""
        px = preprocess_images(images, self.rm.vit_cfg.image_size, CLIP_MEAN, CLIP_STD)
        if token_ids.is_floating_point():
            raise TypeError("BLIP's text field is token ids; got a floating-point tensor")
        r = self.rm.score(px, token_ids, token_ids != 0)
        return -F.relu(-r + 2.0)  # reference reward_fn.py:172


class InternVideo2TrainReward(nn.Module):
    """The trainer's facade over rewards.internvideo2.InternVideo2RewardModel
    (reference reward_fn.py:234-281; the v1 trainer's default video reward,
    train_t2v_turbo_v1_lora.py:518-520): text features computed once,
    without a graph (hashed ids at max length 40 when the model has no
    tokenizer); `score` resizes the short side to `image_size` (bicubic,
    ViCLIP normalisation) on the gradient path."""

    def __init__(self, rm, tokenizer=None, image_size: int = 224):
        super().__init__()
        self.rm, self.image_size = rm, image_size
        if tokenizer is not None:
            self.rm.tokenizer = tokenizer

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        if self.rm.tokenizer is None:
            return self.rm.encode_texts_tokens(*_HashTokenizer(max_length=40)(list(texts)))
        return self.rm.encode_texts(list(texts))

    def score(self, videos: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
        """videos (B, T, H, W, 3) in [0, 1]; text_feats (B, D) -> (B,) f32."""
        return self.rm.score(preprocess_images(videos, self.image_size, VICLIP_MEAN, VICLIP_STD), text_feats)


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
    if name == "img_reward":
        from .blip import build_image_reward_blip

        return build_image_reward_blip(state_dict, **kw)
    if name == "vi_clip2":
        from .internvideo2 import build_internvideo2_reward

        return build_internvideo2_reward(state_dict, **kw)
    raise ValueError(f"unknown reward fn {name!r}")
