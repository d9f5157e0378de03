"""InternVideo2-Stage2 video-text reward tower, `vi_clip2` (port of
t2v_turbo_tpu/rewards/internvideo2.py; the reference's
intern_vid2/demo_utils.py:152-361 and reward_fn/reward_fn.py:234-281).

- `IV2VisionEncoder`: a per-frame patch conv (a Conv3d of tubelet 1), the
  class token and one position embedding over the joint space-time tokens
  (8 x 16 x 16 + 1 = 2049 at 224 px), pre-RMSNorm blocks with a packed
  no-bias QKV, full-width q/k RMSNorm, LayerScale and a 48/11 MLP, then the
  attention-pooling clip projector (LayerNorm q/k/v, one query, separate
  q/k/v biases).
- `InternVideo2RewardModel`: score = <normalize(vision_proj(pooled)),
  text features>, the text features from a BERT-large (rewards/blip.py's
  `BertCrossEncoder` without cross-attention) at the [CLS] row through
  `text_proj`, computed without a graph; the gradient flows through the
  video branch only (the reference's get_vid_feat_with_grad).

Submodule names are the Stage2 checkpoint's (the layout
t2v_turbo_tpu/io/torch_import.py::import_internvideo2_params reads):
`vision_encoder.{patch_embed.proj, cls_token, pos_embed, blocks.{i}.{norm1,
attn.{qkv, q_norm, k_norm, proj}, ls1.gamma, norm2, mlp.{fc1, fc2},
ls2.gamma}, clip_projector.{norm1_q, norm1_k, norm1_v, cross_attn.{q, k, v,
q_bias, k_bias, v_bias, proj}}}`, `text_encoder.bert.*`, `vision_proj`,
`text_proj`. `load_stage2` loads one strictly.

Attention: the heads are 1408 / 16 = 88 wide, which the flash kernels do
not take, so the blocks and the pooling use the plain `attention`, as the
JAX package uses `attention_xla`. With `remat`, each block recomputes its
activations in the backward (torch.utils.checkpoint): the same numbers,
the f32 softmax of one block held at a time instead of all of them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..models.layers import LayerNorm, compute_dtype, seeded_init_
from ..ops.attention import attention
from .blip import BertConfig, BertCrossEncoder, _heads, _Mlp


class RMSNorm(nn.Module):
    """x * w / sqrt(mean(x^2) + eps): f32 statistics, rounded to x's dtype
    before the weight (reference internvideo2.py:127-138)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return y.to(x.dtype) * self.weight.to(x.dtype)


class LayerScale(nn.Module):
    """A learned per-channel residual gain (reference internvideo2.py:141-156)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class IV2VisionConfig:
    img_size: int = 224
    patch_size: int = 14
    width: int = 1408
    depth: int = 40
    heads: int = 16
    mlp_hidden: int = 6144  # int(1408 * 48 / 11)
    num_frames: int = 8
    clip_embed_dim: int = 768
    attn_pool_heads: int = 16


class _IV2Attention(nn.Module):
    def __init__(self, c: IV2VisionConfig):
        super().__init__()
        self.heads = c.heads
        self.qkv = nn.Linear(c.width, 3 * c.width, bias=False)
        self.q_norm = RMSNorm(c.width)  # over the whole width, before the heads split
        self.k_norm = RMSNorm(c.width)
        self.proj = nn.Linear(c.width, c.width)

    def forward(self, x):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        out = attention(*(_heads(t, self.heads) for t in (self.q_norm(q), self.k_norm(k), v)))
        return self.proj(out.flatten(2))


class IV2Block(nn.Module):
    def __init__(self, c: IV2VisionConfig):
        super().__init__()
        self.norm1 = RMSNorm(c.width)
        self.attn = _IV2Attention(c)
        self.ls1 = LayerScale(c.width)
        self.norm2 = RMSNorm(c.width)
        self.mlp = _Mlp(c.width, c.mlp_hidden)
        self.ls2 = LayerScale(c.width)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class _PoolCrossAttention(nn.Module):
    """q/k/v Linears without bias and the biases as separate parameters,
    as the checkpoint stores them (reference internvideo2.py:93-124)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        for n in "qkv":
            setattr(self, n, nn.Linear(dim, dim, bias=False))
            setattr(self, f"{n}_bias", nn.Parameter(torch.zeros(dim)))
        self.proj = nn.Linear(dim, out_dim)


class AttentionPooling(nn.Module):
    """Single-query cross-attention pooling: (B, S, dim) -> (B, out_dim)."""

    def __init__(self, dim: int, heads: int, out_dim: int):
        super().__init__()
        self.heads = heads
        self.norm1_q = LayerNorm(dim)
        self.norm1_k = LayerNorm(dim)
        self.norm1_v = LayerNorm(dim)
        self.cross_attn = _PoolCrossAttention(dim, out_dim)

    def forward(self, x):
        a = self.cross_attn
        xq = self.norm1_q(x.mean(dim=1, keepdim=True))
        q = F.linear(xq, a.q.weight, a.q_bias)
        k = F.linear(self.norm1_k(x), a.k.weight, a.k_bias)
        v = F.linear(self.norm1_v(x), a.v.weight, a.v_bias)
        out = attention(*(_heads(t, self.heads) for t in (q, k, v)))
        return a.proj(out.flatten(2))[:, 0]


class IV2VisionEncoder(nn.Module):
    def __init__(self, cfg: IV2VisionConfig = IV2VisionConfig(), remat: bool = False):
        super().__init__()
        c, self.cfg, self.remat = cfg, cfg, remat
        p = c.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv3d(3, c.width, (1, p, p), stride=(1, p, p))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.width))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + c.num_frames * (c.img_size // p) ** 2, c.width))
        self.blocks = nn.ModuleList(IV2Block(c) for _ in range(c.depth))
        self.clip_projector = AttentionPooling(c.width, c.attn_pool_heads, c.clip_embed_dim)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        """(B, T, H, W, 3) normalised frames -> pooled (B, clip_embed_dim).
        Tokens are ordered (t, n), as the reference's per-frame patches."""
        dtype = compute_dtype(self)
        x = self.patch_embed.proj(video.permute(0, 4, 1, 2, 3).to(dtype))  # (B, W, T, gh, gw)
        x = x.flatten(2).transpose(1, 2)
        cls = self.cls_token.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed[:, :x.shape[1]].to(dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return self.clip_projector(x)


BERT_LARGE = BertConfig(vocab_size=30522, hidden=1024, layers=24, heads=16, intermediate=4096,
                        max_position=512, cross_attention=False, encoder_width=1024)


def _norm(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


class InternVideo2RewardModel(nn.Module):
    def __init__(self, vision_cfg: IV2VisionConfig = IV2VisionConfig(), text_cfg: BertConfig = BERT_LARGE,
                 embed_dim: int = 512, tokenizer=None, remat: bool = False):
        super().__init__()
        self.tokenizer = tokenizer
        self.vision_encoder = IV2VisionEncoder(vision_cfg, remat)
        self.text_encoder = nn.Module()
        self.text_encoder.bert = BertCrossEncoder(text_cfg)
        self.vision_proj = nn.Linear(vision_cfg.clip_embed_dim, embed_dim)
        self.text_proj = nn.Linear(text_cfg.hidden, embed_dim)

    def encode_texts_tokens(self, token_ids, mask=None) -> torch.Tensor:
        """(B, S) ids [, mask] -> (B, embed_dim) normalised f32 features, without a graph."""
        device = self.text_proj.weight.device
        with torch.no_grad():
            cls = self.text_encoder.bert(torch.as_tensor(token_ids, device=device),
                                         mask=None if mask is None else torch.as_tensor(mask, device=device))[:, 0]
            return _norm(self.text_proj(cls).float())

    def encode_texts(self, texts: Sequence[str]) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("provide a BERT tokenizer, or call encode_texts_tokens with token ids")
        toks = self.tokenizer(list(texts))
        # BERT tokenizers return (ids, attention_mask); the mask must reach
        # the encoder, or the padding changes the [CLS] feature
        if isinstance(toks, tuple):
            return self.encode_texts_tokens(*toks)
        return self.encode_texts_tokens(toks)

    def score(self, videos: torch.Tensor, text_feats: torch.Tensor) -> torch.Tensor:
        """videos (B, T, H, W, 3) preprocessed; text_feats (B, D) normalised
        -> (B,) f32 cosine scores (reference reward_fn.py:264-266)."""
        vfeat = _norm(self.vision_proj(self.vision_encoder(videos)).float())
        return (vfeat * text_feats.detach()).sum(-1)

    def forward(self, videos, texts):
        return self.score(videos, self.encode_texts(texts))

    def load_stage2(self, sd) -> None:
        """Strictly load an InternVideo2-Stage2 state dict. Its contrastive
        temperature `temp`, which scoring does not use, is the one key
        dropped; a 4-D patch weight (O, I, P, P) is taken as the tubelet-1
        Conv3d's (O, I, 1, P, P)."""
        sd = {k: v for k, v in sd.items() if k != "temp"}
        key = "vision_encoder.patch_embed.proj.weight"
        if key in sd and sd[key].dim() == 4:
            sd[key] = sd[key][:, :, None]
        self.load_state_dict(sd, strict=True)


def build_internvideo2_reward(state_dict=None, tokenizer=None, vision_cfg: IV2VisionConfig = IV2VisionConfig(),
                              text_cfg: BertConfig = BERT_LARGE, embed_dim: int = 512, seed: int = 0,
                              device=None, remat: bool = False) -> InternVideo2RewardModel:
    """A Stage2 state dict, or seeded random weights when it is None."""
    with torch.device(device or "cpu"):
        model = InternVideo2RewardModel(vision_cfg, text_cfg, embed_dim, tokenizer, remat)
    if state_dict is None:
        seeded_init_(model, seed)
    else:
        model.load_stage2(state_dict)
    return model
