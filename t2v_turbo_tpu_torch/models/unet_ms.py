"""The ModelScope text-to-video 3D UNet, diffusers' UNet3DConditionModel
layout (port of t2v_turbo_tpu/models/unet_ms.py; the reference's
model_scope/unet_3d_condition.py:55-470 and unet_3d_blocks.py).

conv_in -> transformer_in (a temporal transformer, 8 heads of 64) -> three
CrossAttnDownBlock3D and a DownBlock3D -> the mid block -> an UpBlock3D and
three CrossAttnUpBlock3D -> GroupNorm + SiLU -> conv_out, channels (320,
640, 1280, 1280). Each layer of a block is ResnetBlock2D -> TemporalConvLayer
-> [Transformer2DModel (self- and text cross-attention per frame) ->
TransformerTemporalModel (self-attention over the frames)].

Submodule names are the diffusers checkpoint's keys (`down_blocks.{i}.resnets.{j}.conv1`,
`temp_convs`, `attentions`, `temp_attentions`, `downsamplers.0.conv`,
`time_embedding.linear_1`, ...), so a diffusers `unet` state dict loads with
strict `load_state_dict` (io/ms.py makes 1x1-conv projections Linear). The
blocks are the port's VC2 ones with diffusers' init (no zero tails):
`TemporalConvBlock` is diffusers' TemporalConvLayer (its GroupNorm over the
whole clip), `SpatialTransformer` its Transformer2DModel with Linear
projections, `TemporalTransformer` its TransformerTemporalModel: the
GroupNorm's statistics span the whole clip (B, C, T, H, W), as diffusers
normalises the 5-D tensor (PARITY.md:38; in the port B4's whole-clip
`split` mode), and attn2, given no encoder states, attends to itself.

The LCM w-embedding enters through TimestepEmbedding's `cond_proj`, added
to the sinusoidal embedding before linear_1 (:144-149); there is no fps
conditioning. `forward` takes and returns channels-last (B, T, H, W, C),
as the VC2 UNet's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..diffusion.lcm import timestep_embedding
from .layers import (
    GroupNorm,
    SpatialTransformer,
    TemporalConvBlock,
    TemporalTransformer,
    Upsample,
    compute_dtype,
    gn_silu_conv,
    to_clip,
    to_frames,
)


@dataclasses.dataclass(frozen=True)
class MSUNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 64
    cross_attention_dim: int = 1024
    norm_eps: float = 1e-5
    time_cond_proj_dim: Optional[int] = None  # 256 for the LCM student

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


class TimestepEmbedding(nn.Module):
    def __init__(self, channels: int, dim: int, cond_proj_dim: Optional[int] = None):
        super().__init__()
        self.linear_1 = nn.Linear(channels, dim)
        if cond_proj_dim is not None:
            self.cond_proj = nn.Linear(cond_proj_dim, channels, bias=False)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, sample, condition=None):
        if condition is not None:
            sample = sample + self.cond_proj(condition)
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (time_embedding_norm "default"): GN-SiLU-conv
    twice through the fused kernel, the embedding added between, a 1x1
    conv_shortcut when the width changes. x: (N, C, H, W), emb: (N, E)."""

    def __init__(self, in_channels: int, out_channels: int, emb_channels: int, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = nn.Linear(emb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, 32, eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels else None

    def forward(self, x, emb):
        h = gn_silu_conv(self.norm1, self.conv1, x)
        h = h + self.time_emb_proj(F.silu(emb))[:, :, None, None]
        h = gn_silu_conv(self.norm2, self.conv2, h)
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Downsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class MSBlock3D(nn.Module):
    """A down, mid or up block's layers: resnets[j] -> temp_convs[j] ->
    [attentions[j] -> temp_attentions[j]] (diffusers registers them in these
    lists); `layer` runs one such quartet on frames (B*T, C, H, W)."""

    def __init__(self, resnets, channels: int, cfg: MSUNetConfig, n_attn: int, resample: Optional[nn.Module] = None):
        """n_attn: the layers with attention (all, none, or the mid block's
        first); `resample`: the down block's Downsample2D or the up block's
        Upsample, run after the layers."""
        super().__init__()
        heads, hd = channels // cfg.attention_head_dim, cfg.attention_head_dim
        self.resnets = nn.ModuleList(resnets)
        self.temp_convs = nn.ModuleList(TemporalConvBlock(channels) for _ in resnets)
        self.attentions = self.temp_attentions = None
        if n_attn:
            self.attentions = nn.ModuleList(
                SpatialTransformer(channels, heads, hd, 1, cfg.cross_attention_dim) for _ in range(n_attn))
            self.temp_attentions = nn.ModuleList(TemporalTransformer(channels, heads, hd) for _ in range(n_attn))
        self.downsamplers = self.upsamplers = None
        if isinstance(resample, Downsample2D):
            self.downsamplers = nn.ModuleList([resample])
        elif resample is not None:
            self.upsamplers = nn.ModuleList([resample])

    def layer(self, j: int, h, emb, ctx, batch: int):
        h = self.resnets[j](h, emb)
        h = to_frames(self.temp_convs[j](to_clip(h, batch)))
        if self.attentions is not None and j < len(self.attentions):
            h = self.attentions[j](h, ctx)
            h = to_frames(self.temp_attentions[j](to_clip(h, batch)))
        return h


class MSUNet3DConditionModel(nn.Module):
    def __init__(self, cfg: MSUNetConfig = MSUNetConfig()):
        super().__init__()
        self.cfg = cfg
        chans, ch0, L = cfg.block_out_channels, cfg.block_out_channels[0], cfg.layers_per_block
        n = len(chans)
        res = functools.partial(ResnetBlock2D, emb_channels=cfg.time_embed_dim, eps=cfg.norm_eps)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, cfg.time_embed_dim, cfg.time_cond_proj_dim)
        self.transformer_in = TemporalTransformer(ch0, 8, cfg.attention_head_dim)

        # diffusers registers up_blocks before mid_block (io/lora_import.py's MS order)
        self.down_blocks = nn.ModuleList()
        ch = ch0
        for i, out_ch in enumerate(chans):  # the last level is a plain DownBlock3D
            last = i == n - 1
            self.down_blocks.append(MSBlock3D(
                [res(ch if j == 0 else out_ch, out_ch) for j in range(L)], out_ch, cfg, 0 if last else L,
                None if last else Downsample2D(out_ch)))
            ch = out_ch
        rev = list(reversed(chans))
        self.up_blocks = nn.ModuleList()
        prev = rev[0]
        for i, out_ch in enumerate(rev):  # the first level is a plain UpBlock3D
            skip_last = rev[min(i + 1, n - 1)]
            resnets = [res((prev if j == 0 else out_ch) + (skip_last if j == L else out_ch), out_ch)
                       for j in range(L + 1)]
            self.up_blocks.append(MSBlock3D(resnets, out_ch, cfg, L + 1 if i else 0,
                                            Upsample(out_ch, out_ch) if i < n - 1 else None))
            prev = out_ch
        # resnet, temp_conv, attn, temp_attn, resnet, temp_conv
        self.mid_block = MSBlock3D([res(ch, ch), res(ch, ch)], ch, cfg, 1)
        self.conv_norm_out = GroupNorm(ch0, 32, cfg.norm_eps)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def set_model_group(self, group) -> None:
        """The model axis is not the MS UNet's: JAX's MS pipeline takes no
        mesh. None or a group of one rank changes nothing."""
        if group is not None and group.size > 1:
            raise NotImplementedError("the MS UNet takes no model axis (JAX's MS pipeline takes no mesh); the "
                                      "model axis runs the VC2 UNet's sampling, its training half is A12b.2b")

    def forward(
        self,
        x: torch.Tensor,  # (B, T, H, W, C)
        timesteps: torch.Tensor,  # (B,)
        context: torch.Tensor,  # (B, L, cross_attention_dim)
        timestep_cond: Optional[torch.Tensor] = None,  # (B, time_cond_proj_dim)
    ) -> torch.Tensor:
        cfg = self.cfg
        b, t, hh, ww, cin = x.shape
        dtype, device = compute_dtype(self), x.device
        t_emb = timestep_embedding(timesteps.to(device), cfg.block_out_channels[0]).to(dtype)
        cond = None if timestep_cond is None else timestep_cond.to(device, dtype)
        emb = self.time_embedding(t_emb, cond).repeat_interleave(t, dim=0)
        ctx = context.to(device, dtype).repeat_interleave(t, dim=0)

        h = x.reshape(b * t, hh, ww, cin).permute(0, 3, 1, 2).to(dtype).contiguous()
        h = self.conv_in(h)
        h = to_frames(self.transformer_in(to_clip(h, b)))
        skips = [h]
        for block in self.down_blocks:
            for j in range(len(block.resnets)):
                h = block.layer(j, h, emb, ctx, b)
                skips.append(h)
            if block.downsamplers is not None:
                h = block.downsamplers[0](h)
                skips.append(h)
        for j in range(2):
            h = self.mid_block.layer(j, h, emb, ctx, b)
        for block in self.up_blocks:
            for j in range(len(block.resnets)):
                h = block.layer(j, torch.cat([h, skips.pop()], dim=1), emb, ctx, b)
            if block.upsamplers is not None:
                h = block.upsamplers[0](h)

        h = gn_silu_conv(self.conv_norm_out, self.conv_out, h)
        return h.view(b, t, cfg.out_channels, hh, ww).permute(0, 1, 3, 4, 2).to(x.dtype).contiguous()
