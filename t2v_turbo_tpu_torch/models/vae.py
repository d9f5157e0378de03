"""2D image VAE, AutoencoderKL (port of t2v_turbo_tpu/models/vae.py).

f = 8, z = 4, ch = 128, ch_mult (1, 2, 4, 4); attention only at the
bottleneck. Submodule names are the reference's
(lvdm/modules/networks/ae_modules.py): `encoder.down.{l}.block.{i}`,
`encoder.down.{l}.downsample.conv`, `*.mid.{block_1, attn_1, block_2}`,
`decoder.up.{l}.block.{i}`, `decoder.up.{l}.upsample.conv`, and 1x1-conv
`quant_conv` / `post_quant_conv` / attention q, k, v, proj_out.

Public `encode` / `decode` take and return channels-last (N, H, W, C) frames
like the JAX module; inside, the layout is (N, C, H, W). Video is per frame:
frames fold into N.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import sdpa
from .layers import GroupNorm, compute_dtype, dense


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """configs/vc2_t2v_512.yaml's VAE: RGB in and out, a double-z encoder
    (mean and log-variance), embed_dim = z_channels."""

    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, 32, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(out_channels, 32, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv1(self.norm1(x, act="silu"))
        h = self.conv2(self.norm2(h, act="silu"))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over H*W; one head of width C (512 in VC2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, eps=1e-6)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(channels, channels, 1) for _ in range(4))

    def forward(self, x):
        n, c, hh, ww = x.shape
        hn = self.norm(x).permute(0, 2, 3, 1).reshape(n, hh * ww, c)
        q, k, v = (dense(m, hn).view(n, hh * ww, 1, c) for m in (self.q, self.k, self.v))
        out = dense(self.proj_out, sdpa(q, k, v, scale=c**-0.5).reshape(n, hh * ww, c))
        return x + out.view(n, hh, ww, c).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, h):
        return self.block_2(self.attn_1(self.block_1(h)))


class _Level(nn.Module):
    """One resolution: `block.{i}` ResnetBlocks, then an optional resampler
    stored as `downsample.conv` / `upsample.conv`."""

    def __init__(self, blocks, resample: Optional[str], ch: int):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample == "down":
            self.downsample = nn.Module()
            self.downsample.conv = nn.Conv2d(ch, ch, 3, stride=2, padding=0)
        elif resample == "up":
            self.upsample = nn.Module()
            self.upsample.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, h):
        for block in self.block:
            h = block(h)
        if hasattr(self, "downsample"):
            # asymmetric (0, 1) padding, then a stride-2 valid conv
            h = self.downsample.conv(F.pad(h, (0, 1, 0, 1)))
        if hasattr(self, "upsample"):
            h = self.upsample.conv(F.interpolate(h, scale_factor=2, mode="nearest"))
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.conv_in = nn.Conv2d(3, cfg.ch, 3, padding=1)
        block_in = cfg.ch
        self.down = nn.ModuleList()
        for level, mult in enumerate(cfg.ch_mult):
            out = cfg.ch * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(block_in, out))
                block_in = out
            last = level == len(cfg.ch_mult) - 1
            self.down.append(_Level(blocks, None if last else "down", block_in))
        self.mid = _Mid(block_in)
        self.norm_out = GroupNorm(block_in, 32, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            h = level(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, act="silu"))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = nn.Conv2d(cfg.z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        levels = []
        for level in reversed(range(len(cfg.ch_mult))):
            out = cfg.ch * cfg.ch_mult[level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(block_in, out))
                block_in = out
            levels.insert(0, _Level(blocks, "up" if level != 0 else None, block_in))
        self.up = nn.ModuleList(levels)  # indexed by level, as the reference
        self.norm_out = GroupNorm(block_in, 32, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, 3, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            h = level(h)
        return self.conv_out(self.norm_out(h, act="silu"))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.z_channels, 2 * cfg.z_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.z_channels, cfg.z_channels, 1)

    def encode(self, x: torch.Tensor):
        """(N, H, W, 3) in [-1, 1] -> posterior (mean, logvar), each (N, H/8, W/8, z)."""
        h = x.permute(0, 3, 1, 2).to(compute_dtype(self)).contiguous()
        moments = self.quant_conv(self.encoder(h))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean.contiguous(), logvar.clamp(-30.0, 20.0).contiguous()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, h, w, z) latents (already divided by the scale factor) -> (N, H, W, 3)."""
        h = z.permute(0, 3, 1, 2).to(compute_dtype(self)).contiguous()
        return self.decoder(self.post_quant_conv(h)).permute(0, 2, 3, 1).contiguous()
