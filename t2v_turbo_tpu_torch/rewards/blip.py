"""BLIP towers and the ImageReward head (port of t2v_turbo_tpu/rewards/blip.py):
the reference's `img_reward` (reward_fn/reward_fn.py:128-174), which loads
the ImageReward package: a BLIP ViT-L/16, a BERT text encoder that
cross-attends to the image states in every layer, and an MLP scoring head
on the [CLS] row.

- `BlipViT`: packed-QKV pre-LN blocks, class token, post LayerNorm.
- `BertCrossEncoder`: post-LN BERT (LayerNorm eps 1e-12) with an optional
  cross-attention in every layer; the self-attention takes an additive
  mask bias (0 where the mask is set, -1e9 elsewhere).
- `ImageRewardModel`: score(pixels, token ids, mask) -> (B,) rewards
  standardised by IMAGE_REWARD_MEAN / STD. The gradient flows through the
  whole model (ViT, cross-BERT, head), as the reference's differentiable
  reward.

Submodule names are the ImageReward checkpoint's (the layout
t2v_turbo_tpu/io/torch_import.py::import_image_reward_params reads):
`blip.visual_encoder.{patch_embed.proj, cls_token, pos_embed, blocks.{i}.
{norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2}, norm}`,
`blip.text_encoder.bert.{embeddings.*, encoder.layer.{j}.{attention,
crossattention}.{self.{query,key,value}, output.{dense,LayerNorm}},
intermediate.dense, output.{dense,LayerNorm}}` and `mlp.layers.{idx}`. The
head's Sequential holds a placeholder where the upstream head has a
Dropout (identity when scoring), so its Linear indices are the
checkpoint's: 0, 2, 4, 6, 7 for the published five. A checkpoint loads
strictly (`load_image_reward`).

Attention: the ViT's self-attention and the cross-attention to the image
states go through `sdpa` (flash at the heads of 64, with a gradient
through `FlashAttention`); the masked self-attention takes the plain
`attention` with its bias, as the JAX package's `attention_xla`. The
LayerNorms run the LayerNorm kernel (ViT eps 1e-5, as the JAX package's;
BERT 1e-12).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import LayerNorm, compute_dtype, seeded_init_
from ..ops.attention import attention, sdpa


@dataclasses.dataclass(frozen=True)
class BlipViTConfig:
    image_size: int = 224
    patch_size: int = 16
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_ratio: int = 4


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, C) -> (B, S, H, C / H): a view, so split Linear outputs stay views."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads))


class _Mlp(nn.Module):
    def __init__(self, width: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(width, hidden)
        self.fc2 = nn.Linear(hidden, width)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _BlipAttention(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(width, 3 * width)
        self.proj = nn.Linear(width, width)

    def forward(self, x):
        q, k, v = (_heads(t, self.heads) for t in self.qkv(x).chunk(3, dim=-1))
        return self.proj(sdpa(q, k, v).flatten(2))


class BlipViTBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = _BlipAttention(width, heads)
        self.norm2 = LayerNorm(width)
        self.mlp = _Mlp(width, width * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class BlipViT(nn.Module):
    def __init__(self, cfg: BlipViTConfig = BlipViTConfig()):
        super().__init__()
        self.cfg = cfg
        p, n = cfg.patch_size, (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, cfg.width, p, stride=p)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.empty(1, n + 1, cfg.width))
        self.blocks = nn.ModuleList(BlipViTBlock(cfg.width, cfg.heads, cfg.mlp_ratio) for _ in range(cfg.layers))
        self.norm = LayerNorm(cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalised images -> (B, 1 + N, width) token states."""
        dtype = compute_dtype(self)
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2).to(dtype)).flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        for block in self.blocks:
            x = block(x)
        return self.norm(x)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30524  # BLIP's extended bert-base-uncased vocabulary
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_position: int = 512
    cross_attention: bool = True
    encoder_width: int = 1024  # the image states' width, for the cross-attention


class BertSelfOut(nn.Module):
    """dense -> residual -> LayerNorm (post-LN)."""

    def __init__(self, hidden: int, in_dim: Optional[int] = None):
        super().__init__()
        self.dense = nn.Linear(in_dim or hidden, hidden)
        self.LayerNorm = LayerNorm(hidden, eps=1e-12)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class _BertSelf(nn.Module):
    def __init__(self, hidden: int, kv_dim: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(kv_dim, hidden)
        self.value = nn.Linear(kv_dim, hidden)


class BertAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.self = _BertSelf(hidden, kv_dim or hidden)
        self.output = BertSelfOut(hidden)

    def forward(self, x, kv, mask=None):
        s = self.self
        q, k, v = (_heads(lin(t), self.heads) for lin, t in ((s.query, x), (s.key, kv), (s.value, kv)))
        if mask is None:
            out = sdpa(q, k, v)
        else:  # (B, Sk) -> an additive bias on the logits (B, H, Sq, Sk)
            bias = torch.where(mask[:, None, None, :].bool(), 0.0, -1e9)
            out = attention(q, k, v, bias=bias)
        return self.output(out.flatten(2), x)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg.hidden, cfg.heads)
        if cfg.cross_attention:
            self.crossattention = BertAttention(cfg.hidden, cfg.heads, kv_dim=cfg.encoder_width)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(cfg.hidden, cfg.intermediate)
        self.output = BertSelfOut(cfg.hidden, cfg.intermediate)

    def forward(self, x, image_states=None, mask=None):
        x = self.attention(x, x, mask)
        if image_states is not None and hasattr(self, "crossattention"):
            x = self.crossattention(x, image_states)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class BertCrossEncoder(nn.Module):
    """(B, S) token ids [, image states (B, N, encoder_width), mask (B, S)]
    -> (B, S, hidden)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        self.embeddings = nn.Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.embeddings.position_embeddings = nn.Embedding(cfg.max_position, cfg.hidden)
        self.embeddings.token_type_embeddings = nn.Embedding(2, cfg.hidden)
        self.embeddings.LayerNorm = LayerNorm(cfg.hidden, eps=1e-12)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.layers))

    def forward(self, token_ids, image_states=None, mask=None):
        e, s = self.embeddings, token_ids.shape[1]
        dtype = compute_dtype(self)
        x = (e.word_embeddings.weight[token_ids.long()] + e.position_embeddings.weight[:s]
             + e.token_type_embeddings.weight[0]).to(dtype)
        x = e.LayerNorm(x)
        if image_states is not None:
            image_states = image_states.to(dtype)
        for layer in self.encoder.layer:
            x = layer(x, image_states, mask)
        return x


# ImageReward-v1.0's published standardisation constants
IMAGE_REWARD_MEAN = 0.16717362830052426
IMAGE_REWARD_STD = 1.0333394966054072
IMAGE_REWARD_HEAD = (1024, 128, 64, 16, 1)


def _head(in_dim: int, dims: Sequence[int]) -> nn.Sequential:
    """The upstream head's Sequential: a Linear to each of `dims`, with a
    Dropout after each but the last two (here an identity: scoring runs
    with dropout off), so the Linears sit at the checkpoint's indices."""
    mods, prev = [], in_dim
    for i, d in enumerate(dims):
        mods.append(nn.Linear(prev, d))
        if i < len(dims) - 2:
            mods.append(nn.Identity())
        prev = d
    return nn.Sequential(*mods)


class ImageRewardModel(nn.Module):
    def __init__(self, vit_cfg: BlipViTConfig = BlipViTConfig(), bert_cfg: BertConfig = BertConfig(),
                 head_dims: Sequence[int] = IMAGE_REWARD_HEAD):
        super().__init__()
        self.vit_cfg = vit_cfg
        self.blip = nn.Module()
        self.blip.visual_encoder = BlipViT(vit_cfg)
        self.blip.text_encoder = nn.Module()
        self.blip.text_encoder.bert = BertCrossEncoder(bert_cfg)
        self.mlp = nn.Module()
        # the published head is a linear stack: its activations are commented
        # out upstream, so none is applied between the layers
        self.mlp.layers = _head(bert_cfg.hidden, head_dims)

    def score(self, images: torch.Tensor, token_ids: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """images (B, H, W, 3) normalised; token_ids (B, S) -> (B,) f32
        standardised rewards."""
        states = self.blip.visual_encoder(images)
        txt = self.blip.text_encoder.bert(token_ids, image_states=states, mask=mask)
        raw = self.mlp.layers(txt[:, 0])[:, 0].float()
        return (raw - IMAGE_REWARD_MEAN) / IMAGE_REWARD_STD

    def forward(self, images, token_ids, mask=None):
        return self.score(images, token_ids, mask)

    def load_image_reward(self, sd) -> None:
        """Strictly load an ImageReward state dict. `embeddings.position_ids`,
        a buffer transformers' BERT keeps in its state dict and that scoring
        does not read, is the one key dropped."""
        self.load_state_dict({k: v for k, v in sd.items() if not k.endswith("embeddings.position_ids")},
                             strict=True)


def build_image_reward_blip(state_dict=None, vit_cfg: BlipViTConfig = BlipViTConfig(),
                            bert_cfg: BertConfig = BertConfig(), head_dims: Sequence[int] = IMAGE_REWARD_HEAD,
                            seed: int = 0, device=None) -> ImageRewardModel:
    """An ImageReward state dict, or seeded random weights when it is None.
    Its text input is token ids: `reward_fn.BlipTrainReward` tokenises."""
    with torch.device(device or "cpu"):
        model = ImageRewardModel(vit_cfg, bert_cfg, head_dims)
    if state_dict is None:
        seeded_init_(model, seed)
    else:
        model.load_image_reward(state_dict)
    return model
