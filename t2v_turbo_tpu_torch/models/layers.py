"""Building blocks of the VideoCrafter2 3D UNet (port of t2v_turbo_tpu/models/layers.py).

Layout: channels-first inside, the reference's own: spatial blocks run on
frames (N, C, H, W) with N = B*T, temporal blocks on clips (B, C, T, H, W),
so every GroupNorm group is one contiguous span. Submodule names follow the
reference checkpoint keys (lvdm/modules/attention.py,
lvdm/modules/networks/openaimodel3d.py), so a reference state dict loads with
`load_state_dict(strict=True)`, quirks included: `temopral_conv`, the
`conv{i}.{2|3}` indices, (3,1,1) Conv3d temporal kernels, `ff.net.0.proj`,
`to_out.0`, and Conv1d projections in `init_attn`.

Norm parameters stay float32 (`cast_compute_dtype_` skips them), as the JAX
package feeds norm affines in f32; every other parameter is held in the
compute dtype (bf16 on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_gn_silu_conv, group_norm, layer_norm, sdpa
from ..ops.attention import attention


class GroupNorm(nn.Module):
    """GroupNorm with f32 statistics on (N, C, *spatial); `act="silu"` fuses
    the activation that follows it at most call sites."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, act: Optional[str] = None):
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps, act)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, act: Optional[str] = None):
        return layer_norm(x, self.weight, self.bias, self.eps, act)


def gn_silu_conv(norm: GroupNorm, conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """conv(silu(norm(x))) through the fused kernel (B7): a 'same' Conv2d on
    frames (N, C, H, W), or a (k, 1, 1) Conv3d on a clip (B, C, T, H, W),
    run as a (k, 1) conv on the clip viewed as (B, C, T, H*W), so the
    statistics span the clip. `conv.weight` is the module's parametrised
    (LoRA-merged) weight, so the LoRA factors get their gradient."""
    w, shape = conv.weight, x.shape
    if x.dim() == 5:
        x, w = x.reshape(*shape[:3], -1), w.reshape(*w.shape[:3], 1)
    y = fused_gn_silu_conv(x.contiguous(), norm.weight, norm.bias, w.contiguous(), conv.bias,
                           norm.num_groups, norm.eps)
    return y.view(shape[0], -1, *shape[2:])


def dense(layer: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply a Linear, or a 1x1 Conv1d/Conv2d, to channels-last rows."""
    w = layer.weight
    return F.linear(x, w.reshape(w.shape[0], -1), layer.bias)


def to_clip(h: torch.Tensor, batch: int) -> torch.Tensor:
    """(B*T, C, H, W) frames -> (B, C, T, H, W) clip, contiguous."""
    n, c, hh, ww = h.shape
    return h.view(batch, n // batch, c, hh, ww).transpose(1, 2).contiguous()


def to_frames(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) clip -> (B*T, C, H, W) frames, contiguous."""
    b, c, t, hh, ww = x.shape
    return x.transpose(1, 2).reshape(b * t, c, hh, ww)


class CrossAttention(nn.Module):
    """Multi-head attention on (B, S, C) rows; self-attention when `context`
    is None (reference attention.py:50-240, without the image and rel-pos
    branches). `record_probs` takes the plain `attention` and also returns
    its f32 probabilities as (B*heads, Sq, Sk), the reference's
    attention_probs (the MotionClone capture); every other call goes
    through `sdpa`'s kernels."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x, context=None, record_probs: bool = False):
        ctx = x if context is None else context
        b, sq, _ = x.shape
        q = self.to_q(x).view(b, sq, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, -1, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, -1, self.heads, self.dim_head)
        scale = self.dim_head**-0.5
        if record_probs:
            out, probs = attention(q, k, v, scale=scale, return_probs=True)
        else:
            out = sdpa(q, k, v, scale=scale)
        out = self.to_out(out.reshape(b, sq, self.heads * self.dim_head))
        if record_probs:
            return out, probs.reshape(b * self.heads, sq, -1)
        return out


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        value, gate = self.proj(x).chunk(2, dim=-1)  # value first, as torch chunk
        return value * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU MLP stored as the reference's `net.0.proj` / `net.2`."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> GEGLU FF with pre-LN residuals;
    `record_probs` also returns attn1's probabilities (JAX layers.py:380-414)."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None, record_probs: bool = False):
        a = self.attn1(self.norm1(x), record_probs=record_probs)
        probs = None
        if record_probs:
            a, probs = a
        x = x + a
        x = x + self.attn2(self.norm2(x), context)
        x = x + self.ff(self.norm3(x))
        return (x, probs) if record_probs else x


class SpatialTransformer(nn.Module):
    """Per-frame transformer on (N, C, H, W) with Linear projections."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(in_channels, 32, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)
        )
        self.proj_out = nn.Linear(inner, in_channels)

    def forward(self, x, context=None):
        n, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
        h = self.proj_in(h)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return x + h.view(n, hh, ww, c).permute(0, 3, 1, 2)


class TemporalTransformer(nn.Module):
    """Self-attention over T at each pixel of a clip (B, C, T, H, W). The
    GroupNorm's statistics span the whole clip. `conv1d_proj` stores the
    projections as Conv1d, as the reference's `init_attn` does.
    `record_probs` also returns the list of each block's attn1
    probabilities, (B*H*W*heads, T, T) each."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 conv1d_proj: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(in_channels, 32, eps=1e-6)
        if conv1d_proj:
            self.proj_in = nn.Conv1d(in_channels, inner, 1)
            self.proj_out = nn.Conv1d(inner, in_channels, 1)
        else:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head) for _ in range(depth)
        )

    def forward(self, x, record_probs: bool = False):
        b, c, t, hh, ww = x.shape
        h = self.norm(x).permute(0, 3, 4, 2, 1).reshape(b * hh * ww, t, c)
        h = dense(self.proj_in, h)
        probs = []
        for block in self.transformer_blocks:
            if record_probs:
                h, p = block(h, record_probs=True)
                probs.append(p)
            else:
                h = block(h)
        h = dense(self.proj_out, h)
        out = x + h.view(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return (out, probs) if record_probs else out


def _temporal_conv(ch: int) -> nn.Conv3d:
    return nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))


class TemporalConvBlock(nn.Module):
    """Four GN(whole clip)+SiLU -> (3,1,1) conv stages with an identity
    residual, on (B, C, T, H, W) (reference openaimodel3d.py:257-309)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Sequential(GroupNorm(channels), nn.SiLU(), _temporal_conv(channels))
        self.conv2, self.conv3, self.conv4 = (
            nn.Sequential(GroupNorm(channels), nn.SiLU(), nn.Dropout(0.0), _temporal_conv(channels))
            for _ in range(3)
        )

    def forward(self, x):
        h = x
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            h = gn_silu_conv(stage[0], stage[-1], h)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class ResBlock(nn.Module):
    """GN-SiLU-conv residual block with the timestep embedding added, then a
    TemporalConvBlock. x: (B*T, C, H, W); emb: (B*T, E)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None):
        super().__init__()
        out = out_channels or channels
        self.in_layers = nn.Sequential(
            GroupNorm(channels), nn.SiLU(), nn.Conv2d(channels, out, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, out))
        self.out_layers = nn.Sequential(
            GroupNorm(out), nn.SiLU(), nn.Dropout(0.0), nn.Conv2d(out, out, 3, padding=1)
        )
        self.skip_connection = nn.Conv2d(channels, out, 1) if out != channels else nn.Identity()
        self.temopral_conv = TemporalConvBlock(out)  # the reference's spelling

    def forward(self, x, emb, batch_size: int):
        h = gn_silu_conv(self.in_layers[0], self.in_layers[2], x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        h = gn_silu_conv(self.out_layers[0], self.out_layers[3], h)
        h = self.skip_connection(x) + h
        return to_frames(self.temopral_conv(to_clip(h, batch_size)))


def cast_compute_dtype_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every parameter except the norms' affines (kept f32) to `dtype`."""
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return module


def compute_dtype(module: nn.Module) -> torch.dtype:
    """The dtype of the first non-norm parameter."""
    for m in module.modules():
        if not isinstance(m, (GroupNorm, LayerNorm)):
            for p in m.parameters(recurse=False):
                return p.dtype
    return torch.float32


@torch.no_grad()
def seeded_init_(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter with seeded non-zero values: norm scales
    1 + 0.1 N(0,1), norm shifts and other vectors 0.1 N(0,1), matrices and
    kernels N(0,1)/sqrt(fan_in). No zero-initialised tail survives, so a
    wrong kernel changes the output."""
    norm_params = {
        id(p) for m in module.modules() if isinstance(m, (GroupNorm, LayerNorm))
        for p in m.parameters(recurse=False)
    }
    norm_weights = {
        id(m.weight) for m in module.modules() if isinstance(m, (GroupNorm, LayerNorm))
    }
    for _, p in module.named_parameters():
        g = torch.Generator(device=p.device)
        g.manual_seed(seed)
        seed += 1
        r = torch.randn(p.shape, generator=g, device=p.device, dtype=torch.float32)
        if id(p) in norm_weights:
            r = 1.0 + 0.1 * r
        elif id(p) in norm_params or p.dim() == 1:
            r = 0.1 * r
        else:
            r = r / (p[0].numel() ** 0.5)
        p.copy_(r)
    return module
