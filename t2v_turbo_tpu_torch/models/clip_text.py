"""OpenCLIP text towers (port of t2v_turbo_tpu/models/clip_text.py).

`CLIPTextModel`: token + positional embedding, a causal transformer run for
`layers - 1` blocks (the reference FrozenOpenCLIPEmbedder's
layer="penultimate"; all `layers` with `penultimate=False`), then ln_final:
(B, 77) tokens -> (B, 77, 1024) context. `CLIPTextPooled`: the full-depth
tower, the EOT token's row and `text_projection`: the reward models' text
branch (JAX rewards/reward_fn.py::CLIPTextPooled). Submodule names are
open_clip's (`transformer.resblocks.{i}.attn.in_proj_weight`, `mlp.c_fc`,
..., `text_projection`). The blocks also serve the reward vision towers
(rewards/vit.py), without the causal mask.

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

from ..ops.attention import attention, sdpa
from .layers import LayerNorm, compute_dtype


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1024
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    penultimate: bool = True  # layer="penultimate", the UNet conditioning
    quick_gelu: bool = False  # ViCLIP's text tower

    @property
    def layers_run(self) -> int:
        return self.layers - 1 if self.penultimate else self.layers


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class QuickGELU(nn.Module):
    def forward(self, x):
        return quick_gelu(x)


class _MultiheadAttention(nn.Module):
    """Packed-QKV self-attention with torch MultiheadAttention's keys: causal
    through `attention` (the text towers), else through `sdpa` (the vision
    towers: flash for heads of 64, the plain path for ViT-H's 80)."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads, self.causal = heads, causal
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        b, s, c = x.shape
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).split(c, dim=-1)
        q, k, v = (t.reshape(b, s, self.heads, c // self.heads) for t in (q, k, v))
        out = attention(q, k, v, causal=True) if self.causal else sdpa(q, k, v)
        return self.out_proj(out.reshape(b, s, c))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool = False, causal: bool = True):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = _MultiheadAttention(width, heads, causal)
        self.ln_2 = LayerNorm(width)
        self.mlp = nn.Sequential(collections.OrderedDict(
            c_fc=nn.Linear(width, 4 * width),
            gelu=QuickGELU() if quick_gelu else nn.GELU(),
            c_proj=nn.Linear(4 * width, width),
        ))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(cfg.width, cfg.heads, cfg.quick_gelu) for _ in range(cfg.layers_run)
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


class CLIPTextPooled(CLIPTextModel):
    """The full-depth tower, pooled at the EOT token (the largest id) and
    projected: (B, context_length) tokens -> (B, proj_dim)."""

    def __init__(self, cfg: CLIPTextConfig, proj_dim: int):
        super().__init__(dataclasses.replace(cfg, penultimate=False))
        self.text_projection = nn.Parameter(torch.empty(cfg.width, proj_dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = super().forward(tokens)
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return pooled @ self.text_projection.to(pooled.dtype)


def unused_checkpoint_keys(sd, cfg: CLIPTextConfig = CLIPTextConfig()):
    """Keys of an open_clip text-tower state dict that the penultimate tower
    does not hold: the last block, the projection and the logit scale."""
    last = f"transformer.resblocks.{cfg.layers - 1}."
    return sorted(k for k in sd if k.startswith(last) or k in ("text_projection", "logit_scale"))
