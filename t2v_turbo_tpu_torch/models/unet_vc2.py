"""VideoCrafter2 3D UNet (port of t2v_turbo_tpu/models/unet_vc2.py).

Per level: ResBlock(+TemporalConvBlock) -> SpatialTransformer ->
TemporalTransformer, a temporal transformer after conv_in (`init_attn`),
timestep + fps + LCM w-embedding (`time_cond_proj`) conditioning.
Submodule names are the reference UNetModel's state-dict keys
(lvdm/modules/networks/openaimodel3d.py:312-740).

The public `forward` takes and returns channels-last (B, T, H, W, C), like
the JAX module; inside, frames are (B*T, C, H, W).

`use_remat` recomputes each ResBlock, SpatialTransformer and
TemporalTransformer (init_attn included) in the backward instead of keeping
its activations, as the JAX module's `nn.remat` and the reference's
`use_checkpoint` do: `torch.utils.checkpoint` (non-reentrant) around each
call, which re-enters the same kernels' autograd functions when it
recomputes. It acts only while gradients are being recorded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..diffusion.lcm import timestep_embedding
from .layers import (
    Downsample,
    GroupNorm,
    ResBlock,
    SpatialTransformer,
    TemporalTransformer,
    Upsample,
    compute_dtype,
    gn_silu_conv,
    to_clip,
    to_frames,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The VC2 UNet hyper-parameters; the defaults are configs/vc2_t2v_512.yaml.

    That file's switches are all on and fixed here: temporal convs in every
    ResBlock, a temporal transformer after every spatial one, `init_attn`,
    fps conditioning; self-only temporal attention without relative
    position or causal mask."""

    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 1
    temporal_transformer_depth: int = 1
    context_dim: int = 1024
    time_cond_proj_dim: Optional[int] = None  # 256 for the LCM students

    @property
    def time_embed_dim(self) -> int:
        return self.model_channels * 4


def _embedding_mlp(dim_in: int, dim: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim_in, dim), nn.SiLU(), nn.Linear(dim, dim))


class UNetModel(nn.Module):
    def __init__(self, cfg: UNetConfig = UNetConfig(), use_remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_remat = use_remat
        mc, ted, nhc = cfg.model_channels, cfg.time_embed_dim, cfg.num_head_channels

        self.time_embed = _embedding_mlp(mc, ted)
        self.fps_embedding = _embedding_mlp(mc, ted)
        if cfg.time_cond_proj_dim is not None:
            self.time_cond_proj = nn.Linear(cfg.time_cond_proj_dim, mc, bias=False)

        def spatial(ch):
            return SpatialTransformer(ch, ch // nhc, nhc, cfg.transformer_depth, cfg.context_dim)

        def temporal(ch, n_heads=None, conv1d_proj=False):
            return TemporalTransformer(
                ch, n_heads or ch // nhc, nhc, cfg.temporal_transformer_depth, conv1d_proj
            )

        def res(ch_in, ch_out):
            return ResBlock(ch_in, ted, ch_out)

        def attn_layers(ch):
            return [spatial(ch), temporal(ch)]

        self.input_blocks = nn.ModuleList([nn.ModuleList([nn.Conv2d(cfg.in_channels, mc, 3, padding=1)])])
        # reference init_attn: 8 heads, Conv1d projections (openaimodel3d.py:439-453)
        self.init_attn = nn.Sequential(temporal(mc, n_heads=8, conv1d_proj=True))

        ch, ds = mc, 1
        input_chans = [ch]
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                layers = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers += attn_layers(ch)
                self.input_blocks.append(nn.ModuleList(layers))
                input_chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([Downsample(ch, ch)]))
                input_chans.append(ch)
                ds *= 2

        self.middle_block = nn.ModuleList([res(ch, ch)] + attn_layers(ch) + [res(ch, ch)])

        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                layers = [res(ch + input_chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    layers += attn_layers(ch)
                if level and i == cfg.num_res_blocks:
                    layers.append(Upsample(ch, ch))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))

        self.out = nn.Sequential(GroupNorm(mc), nn.SiLU(), nn.Conv2d(mc, cfg.out_channels, 3, padding=1))

    def _block(self, layer, *args):
        """A ResBlock or transformer call, recomputed in the backward under use_remat."""
        if self.use_remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False)
        return layer(*args)

    def _run(self, layers, h, emb, context, batch):
        for layer in layers:
            if isinstance(layer, ResBlock):
                h = self._block(layer, h, emb, batch)
            elif isinstance(layer, SpatialTransformer):
                h = self._block(layer, h, context)
            elif isinstance(layer, TemporalTransformer):
                h = to_frames(self._block(layer, to_clip(h, batch)))
            else:  # Downsample / Upsample
                h = layer(h)
        return h

    def forward(
        self,
        x: torch.Tensor,  # (B, T, H, W, C)
        timesteps: torch.Tensor,  # (B,)
        context: torch.Tensor,  # (B, L, context_dim)
        fps=None,  # scalar or (B,)
        timestep_cond: Optional[torch.Tensor] = None,  # (B, time_cond_proj_dim)
    ) -> torch.Tensor:
        cfg = self.cfg
        b, t, hh, ww, cin = x.shape
        dtype = compute_dtype(self)
        device = x.device

        t_emb = timestep_embedding(timesteps.to(device), cfg.model_channels).to(dtype)
        if timestep_cond is not None:
            t_emb = t_emb + self.time_cond_proj(timestep_cond.to(device, dtype))
        emb = self.time_embed(t_emb)
        fps = torch.as_tensor(16.0 if fps is None else fps, dtype=torch.float32, device=device).expand(b)
        emb = emb + self.fps_embedding(timestep_embedding(fps, cfg.model_channels).to(dtype))

        emb_f = emb.repeat_interleave(t, dim=0)
        ctx_f = context.to(device, dtype).repeat_interleave(t, dim=0)

        h = x.reshape(b * t, hh, ww, cin).permute(0, 3, 1, 2).to(dtype).contiguous()
        h = self.input_blocks[0][0](h)
        h = to_frames(self._block(self.init_attn[0], to_clip(h, b)))

        hs = [h]
        for layers in self.input_blocks[1:]:
            h = self._run(layers, h, emb_f, ctx_f, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb_f, ctx_f, b)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), emb_f, ctx_f, b)

        h = gn_silu_conv(self.out[0], self.out[2], h)
        return h.view(b, t, cfg.out_channels, hh, ww).permute(0, 1, 3, 4, 2).to(x.dtype).contiguous()
