"""Image-conditioning projection heads (port of t2v_turbo_tpu/models/ip_resampler.py).

The reference's lvdm/modules/encoders/ip_resampler.py:7-148, used by the
image-conditioned VC2 (LatentVisualDiffusion, ddpm3d.py:835-887):

- `ImageProjModel`: a pooled CLIP image embedding (B, D_clip) -> N context
  tokens (B, N, D_ctx) (`proj`, `norm`).
- `PerceiverAttention`: learned latents attending to [image features ++
  latents], q and k each scaled by dim_head**-0.25 before their product (the
  reference's sqrt-sqrt scaling, JAX :62-64).
- `Resampler`: the perceiver resampler, image patch features -> num_queries
  tokens (`latents`, `proj_in`, `layers.{i}.0` the attention,
  `layers.{i}.1.{0,1,3}` the LayerNorm -> Linear -> GELU -> Linear
  feed-forward, `proj_out`, `norm_out`).

Submodule names follow the reference's layout (the IP-Adapter resampler's),
so its state dict loads strictly; no checkpoint of it was at hand to confirm
them, so `proj` / `norm` and `layers.{i}.{0,1}.*` stand unconfirmed against
a real file. The attention is the plain `attention` (the JAX module's is XLA
einsums, no Pallas); the LayerNorms go through B5 (`models.layers.LayerNorm`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.attention import attention
from .layers import LayerNorm, compute_dtype


class ImageProjModel(nn.Module):
    """(B, clip_embeddings_dim) -> (B, clip_extra_context_tokens, cross_attention_dim)."""

    def __init__(self, cross_attention_dim: int = 1024, clip_embeddings_dim: int = 1024,
                 clip_extra_context_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim, self.clip_extra_context_tokens = cross_attention_dim, clip_extra_context_tokens
        self.proj = nn.Linear(clip_embeddings_dim, clip_extra_context_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj(image_embeds.to(compute_dtype(self)))
        return self.norm(x.reshape(-1, self.clip_extra_context_tokens, self.cross_attention_dim))


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        """x: (B, N, dim) image features; latents: (B, L, dim) -> (B, L, dim)."""
        x, latents = self.norm1(x), self.norm2(latents)
        b, l, _ = latents.shape
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        split = lambda t: t.reshape(b, -1, self.heads, self.dim_head)  # noqa: E731
        s = self.dim_head**-0.25
        out = attention(split(q) * s, split(k) * s, split(v), scale=1.0)
        return self.to_out(out.reshape(b, l, -1))


class Resampler(nn.Module):
    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64, heads: int = 16,
                 num_queries: int = 8, embedding_dim: int = 768, output_dim: int = 1024, ff_mult: int = 4):
        super().__init__()
        self.latents = nn.Parameter(torch.randn(1, num_queries, dim) / dim**0.5)
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PerceiverAttention(dim, dim_head, heads),
                nn.Sequential(LayerNorm(dim), nn.Linear(dim, dim * ff_mult, bias=False), nn.GELU(),
                              nn.Linear(dim * ff_mult, dim, bias=False)),
            ])
            for _ in range(depth)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, embedding_dim) image features -> (B, num_queries, output_dim)."""
        dtype = compute_dtype(self)
        latents = self.latents.to(dtype).expand(x.shape[0], -1, -1)
        x = self.proj_in(x.to(dtype))
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return self.norm_out(self.proj_out(latents))
