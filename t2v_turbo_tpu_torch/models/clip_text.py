"""OpenCLIP ViT-H/14 text tower, penultimate layer (port of t2v_turbo_tpu/models/clip_text.py).

Token + positional embedding, a causal transformer run for `layers - 1`
blocks (the reference FrozenOpenCLIPEmbedder's layer="penultimate"), then
ln_final: (B, 77) tokens -> (B, 77, 1024) context. Submodule names are
open_clip's (`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`, ...).

A checkpoint also holds the last block, `text_projection` and `logit_scale`,
which the penultimate tower never runs; `unused_checkpoint_keys` names them
so the loader drops exactly those and loads the rest strictly.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from .layers import LayerNorm, compute_dtype


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77

    @property
    def layers_run(self) -> int:
        return self.layers - 1  # penultimate


class _MultiheadAttention(nn.Module):
    """Packed-QKV causal self-attention with torch MultiheadAttention's keys."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(c, dim=-1)
        split = lambda t: t.reshape(b, s, self.heads, c // self.heads)
        out = attention(split(q), split(k), split(v), causal=True)
        return self.out_proj(out.reshape(b, s, c))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = _MultiheadAttention(width, heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.Sequential(collections.OrderedDict(
            c_fc=nn.Linear(width, 4 * width),
            gelu=nn.GELU(),
            c_proj=nn.Linear(4 * width, width),
        ))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads) for _ in range(cfg.layers_run)
        )


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg)
        self.ln_final = LayerNorm(cfg.width)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, context_length) int tokens -> (B, context_length, width)."""
        dtype = compute_dtype(self)
        x = self.token_embedding(tokens.long()).to(dtype) + self.positional_embedding.to(dtype)
        for block in self.transformer.resblocks:
            x = block(x)
        return self.ln_final(x)


def unused_checkpoint_keys(sd, cfg: CLIPTextConfig = CLIPTextConfig()):
    """Keys of an open_clip text-tower state dict that the penultimate tower
    does not hold: the last block, the projection and the logit scale."""
    last = f"transformer.resblocks.{cfg.layers - 1}."
    return sorted(k for k in sd if k.startswith(last) or k in ("text_projection", "logit_scale"))
