"""Building blocks of the VideoCrafter2 3D UNet (port of t2v_turbo_tpu/models/layers.py).

Layout: channels-first inside, the reference's own: spatial blocks run on
frames (N, C, H, W) with N = B*T, temporal blocks on clips (B, C, T, H, W),
so every GroupNorm group is one contiguous span. Submodule names follow the
reference checkpoint keys (lvdm/modules/attention.py,
lvdm/modules/networks/openaimodel3d.py), so a reference state dict loads with
`load_state_dict(strict=True)`, quirks included: `temopral_conv`, the
`conv{i}.{2|3}` indices, (3,1,1) Conv3d temporal kernels, `ff.net.0.proj`,
`to_out.0`, Conv1d projections in `init_attn`, and the switches' own keys
(`relative_position_{k,v}.embeddings_table`, `to_k_ip` / `to_v_ip`, the
scale-shift `emb_layers.1` of width 2 * out).

Norm parameters stay float32 (`cast_compute_dtype_` skips them), as the JAX
package feeds norm affines in f32; every other parameter is held in the
compute dtype (bf16 on the card).

Sequence parallelism: a `TemporalConvBlock` or `TemporalTransformer` whose
`seq_group` (an AxisGroup of parallel/mesh.py, set by
`UNetModel.set_seq_group`) has more than one rank runs on this rank's T /
seq frames of the clip with the collectives that GSPMD inserts in the JAX
package written out (parallel/collectives.py):
- the whole-clip GroupNorms take the clip's statistics: this rank's chunk
  partials (B4's split route), gathered over the seq ranks, then B4's apply
  (`group_norm_from_partials`) or B7's (a, b)
  (`group_norm_affine_from_partials`);
- each (3, 1, 1) conv runs B7 on given (a, b) (`fused_gn_silu_conv_ab`) on
  the clip extended by one neighbour frame each side (`halo_exchange`; a
  rank at a clip edge adds none there, so B7's zero halo, after the
  activation, stays the clip's edge) and drops the halo frames' outputs;
- the temporal attention switches the normalised clip to all T frames of H
  * W / seq columns (`seq_to_space`), runs proj_in, the blocks (B8 at full
  T, so relative position and the causal mask need no change) and proj_out
  there, and switches back (`space_to_seq`) before the residual add.
Without a group, or with a group of one rank, the code path and the kernel
launches are the single-device ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import fused_gn_silu_conv, group_norm, layer_norm, sdpa
from ..ops.attention import attention
from ..ops.fused_conv import fused_gn_silu_conv_ab
from ..ops.norms import group_norm_affine_from_partials, group_norm_from_partials, group_norm_partials
from ..parallel import collectives

# The text rows of an image-conditioned context; the image tokens follow
# (the reference's text_context_len, JAX layers.py:217).
TEXT_CONTEXT_LEN = 200


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


def gn_silu_conv(norm: GroupNorm, conv: nn.Module, x: torch.Tensor, film=None) -> torch.Tensor:
    """conv(silu(norm(x))) through the fused kernel (B7): a 'same' Conv2d on
    frames (N, C, H, W), or a (k, 1, 1) Conv3d on a clip (B, C, T, H, W),
    run as a (k, 1) conv on the clip viewed as (B, C, T, H*W), so the
    statistics span the clip. `conv.weight` is the module's parametrised
    (LoRA-merged) weight, so the LoRA factors get their gradient. `film`:
    (scale, shift), each (N, C), applied as h * (1 + scale) + shift between
    the norm and the SiLU."""
    w, shape = conv.weight, x.shape
    if x.dim() == 5:
        x, w = x.reshape(*shape[:3], -1), w.reshape(*w.shape[:3], 1)
    y = fused_gn_silu_conv(x.contiguous(), norm.weight, norm.bias, w.contiguous(), conv.bias,
                           norm.num_groups, norm.eps, *(film or (None, None)))
    return y.view(shape[0], -1, *shape[2:])


def _sharded(group) -> bool:
    return group is not None and group.size > 1


def clip_partials(norm: GroupNorm, x: torch.Tensor, group):
    """(parts, counts) of the whole clip's GroupNorm rows from this rank's
    frames x (B, C, T / seq, H, W): its chunk partials, gathered over the
    seq group in rank order."""
    parts, counts = group_norm_partials(x.contiguous(), norm.num_groups)
    return collectives.gather_partials(parts, counts, group)


def gn_silu_conv_seq(norm: GroupNorm, conv: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """`gn_silu_conv` of a (k, 1, 1) Conv3d on this rank's frames x (B, C, T
    / seq, H, W) of a clip sharded over `group`: the clip's statistics, B7
    on x with its neighbours' halo frames, the halo outputs dropped."""
    b, c, t, hh, ww = x.shape
    a, sh = group_norm_affine_from_partials(*clip_partials(norm, x, group), norm.weight, norm.bias, norm.num_groups,
                                            norm.eps)
    lo, _ = collectives.halo_sides(group)
    xh = collectives.halo_exchange(x, group, 2)
    w = conv.weight
    y = fused_gn_silu_conv_ab(xh.reshape(b, c, xh.shape[2], hh * ww), a, sh, w.reshape(*w.shape[:3], 1).contiguous(),
                              conv.bias)
    return y[:, :, lo:lo + t].contiguous().view(b, -1, t, hh, ww)


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


class RelativePosition(nn.Module):
    """The learned relative-position table (reference attention.py:24-47):
    (length_q, length_k, num_units) rows of `embeddings_table`, indexed by
    key - query clipped to +-max_relative_position."""

    def __init__(self, num_units: int, max_relative_position: int):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.embeddings_table = nn.Parameter(torch.empty(2 * max_relative_position + 1, num_units))
        nn.init.xavier_uniform_(self.embeddings_table)

    def forward(self, length_q: int, length_k: int) -> torch.Tensor:
        m, dev = self.max_relative_position, self.embeddings_table.device
        dist = torch.arange(length_k, device=dev)[None, :] - torch.arange(length_q, device=dev)[:, None]
        return self.embeddings_table[dist.clamp(-m, m) + m]


class CrossAttention(nn.Module):
    """Multi-head attention on (B, S, C) rows; self-attention when `context`
    is None (reference attention.py:50-240, JAX layers.py:200-316).

    - `relative_position` (temporal blocks): the logits gain q . k2 and the
      output probs . v2 from two `RelativePosition` tables over
      `temporal_length`.
    - `causal` masks keys after the query.
    - `record_probs` also returns the f32 probabilities as (B*heads, Sq,
      Sk), the reference's attention_probs (the MotionClone capture).
    These three take the plain `attention` (with its bias and mask); every
    other call goes through `sdpa`'s kernels, which take neither.
    - `img_cross_attention` (attn2 of the image-conditioned UNet): the
      context's rows past TEXT_CONTEXT_LEN are image tokens, attended
      through `to_k_ip` / `to_v_ip` with the same queries (through `sdpa`)
      and added (the reference's image_cross_attention_scale, 1). A context
      with no rows past it is refused, as JAX refuses it."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None, heads: int = 8,
                 dim_head: int = 64, relative_position: bool = False, temporal_length: Optional[int] = None,
                 img_cross_attention: bool = False):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(0.0))
        self.relative_position = relative_position
        if relative_position:
            if temporal_length is None:
                raise ValueError("relative_position needs temporal_length")
            self.relative_position_k = RelativePosition(dim_head, temporal_length)
            self.relative_position_v = RelativePosition(dim_head, temporal_length)
        self.img_cross_attention = img_cross_attention
        if img_cross_attention:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)

    def forward(self, x, context=None, causal: bool = False, record_probs: bool = False):
        ctx = x if context is None else context
        ctx_img = None
        if self.img_cross_attention:
            if ctx.shape[1] <= TEXT_CONTEXT_LEN:
                raise ValueError(
                    f"img_cross_attention=True needs image tokens appended beyond text_context_len="
                    f"{TEXT_CONTEXT_LEN}, but context has only {ctx.shape[1]} tokens; append image "
                    "context (models/image_cond.py append_image_context) or build the UNet without "
                    "use_image_attention.")
            ctx, ctx_img = ctx[:, :TEXT_CONTEXT_LEN], ctx[:, TEXT_CONTEXT_LEN:]
        b, sq, _ = x.shape
        split = lambda t: t.view(b, -1, self.heads, self.dim_head)  # noqa: E731
        q, k, v = split(self.to_q(x)), split(self.to_k(ctx)), split(self.to_v(ctx))
        scale = self.dim_head**-0.5
        if self.relative_position or causal or record_probs:
            sk = k.shape[1]
            bias = None
            if self.relative_position:
                k2 = self.relative_position_k(sq, sk)
                bias = torch.einsum("bqhd,qkd->bhqk", q.float(), k2.float()) * scale
            out, probs = attention(q, k, v, bias=bias, causal=causal, scale=scale, return_probs=True)
            if self.relative_position:
                v2 = self.relative_position_v(sq, sk)
                out = out + torch.einsum("bhqk,qkd->bqhd", probs.to(out.dtype), v2.to(out.dtype))
        else:
            out = sdpa(q, k, v, scale=scale)
        if ctx_img is not None:
            out = out + sdpa(q, split(self.to_k_ip(ctx_img)), split(self.to_v_ip(ctx_img)), scale=scale)
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
    `record_probs` also returns attn1's probabilities (JAX layers.py:380-414).
    Relative position and `causal` apply to both attentions (the temporal
    blocks'); the image branch to attn2 only."""

    def __init__(self, dim: int, n_heads: int, d_head: int, context_dim: Optional[int] = None,
                 relative_position: bool = False, temporal_length: Optional[int] = None,
                 img_cross_attention: bool = False):
        super().__init__()
        rel = dict(relative_position=relative_position, temporal_length=temporal_length)
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, **rel)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, img_cross_attention=img_cross_attention,
                                    **rel)
        self.norm1, self.norm2, self.norm3 = LayerNorm(dim), LayerNorm(dim), LayerNorm(dim)

    def forward(self, x, context=None, record_probs: bool = False, causal: bool = False):
        a = self.attn1(self.norm1(x), causal=causal, record_probs=record_probs)
        probs = None
        if record_probs:
            a, probs = a
        x = x + a
        x = x + self.attn2(self.norm2(x), context, causal=causal)
        x = x + self.ff(self.norm3(x))
        return (x, probs) if record_probs else x


class SpatialTransformer(nn.Module):
    """Per-frame transformer on (N, C, H, W) with Linear projections;
    `img_cross_attention` gives attn2 the image branch."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 context_dim: Optional[int] = None, img_cross_attention: bool = False):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm(in_channels, 32, eps=1e-6)
        self.proj_in = nn.Linear(in_channels, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, context_dim, img_cross_attention=img_cross_attention)
            for _ in range(depth)
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
    probabilities, (B*H*W*heads, T, T) each. `relative_position` (over
    `temporal_length`) and `causal_attention` apply to both attentions of
    every block. Self-only: the reference's temporal cross-attention
    (`only_self_att=False`) is not ported, as the JAX package cannot build it.
    With a `seq_group` of more than one rank, x holds this rank's T / seq
    frames (the module docstring's sequence parallelism)."""

    seq_group = None  # set by UNetModel.set_seq_group

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 conv1d_proj: bool = False, relative_position: bool = False, causal_attention: bool = False,
                 temporal_length: Optional[int] = None):
        super().__init__()
        self.causal_attention = causal_attention
        inner = n_heads * d_head
        self.norm = GroupNorm(in_channels, 32, eps=1e-6)
        if conv1d_proj:
            self.proj_in = nn.Conv1d(in_channels, inner, 1)
            self.proj_out = nn.Conv1d(inner, in_channels, 1)
        else:
            self.proj_in = nn.Linear(in_channels, inner)
            self.proj_out = nn.Linear(inner, in_channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, relative_position=relative_position,
                                  temporal_length=temporal_length)
            for _ in range(depth)
        )

    def forward(self, x, record_probs: bool = False):
        if _sharded(self.seq_group):
            if record_probs:
                raise NotImplementedError("record_probs under sequence parallelism is not ported")
            return self._forward_seq(x, self.seq_group)
        b, c, t, hh, ww = x.shape
        h = self.norm(x).permute(0, 3, 4, 2, 1).reshape(b * hh * ww, t, c)
        h = dense(self.proj_in, h)
        probs = []
        for block in self.transformer_blocks:
            if record_probs:
                h, p = block(h, record_probs=True, causal=self.causal_attention)
                probs.append(p)
            else:
                h = block(h, causal=self.causal_attention)
        h = dense(self.proj_out, h)
        out = x + h.view(b, hh, ww, t, c).permute(0, 4, 3, 1, 2)
        return (out, probs) if record_probs else out

    def _forward_seq(self, x, group):
        """This rank's frames (B, C, T / seq, H, W): the clip's norm, then
        every block on all T frames of H * W / seq columns."""
        b, c, t, hh, ww = x.shape
        norm = self.norm
        h = group_norm_from_partials(x, *clip_partials(norm, x, group), norm.weight, norm.bias, norm.num_groups,
                                     norm.eps)
        h = collectives.seq_to_space(h.view(b, c, t, hh * ww), group)  # (B, C, T, S / seq)
        frames, cols = h.shape[2:]
        h = dense(self.proj_in, h.permute(0, 3, 2, 1).reshape(b * cols, frames, c))
        for block in self.transformer_blocks:
            h = block(h, causal=self.causal_attention)
        h = dense(self.proj_out, h)
        h = collectives.space_to_seq(h.view(b, cols, frames, c).permute(0, 3, 2, 1).contiguous(), group)
        return x + h.view(b, c, t, hh, ww)


def _temporal_conv(ch: int) -> nn.Conv3d:
    return nn.Conv3d(ch, ch, (3, 1, 1), padding=(1, 0, 0))


class TemporalConvBlock(nn.Module):
    """Four GN(whole clip)+SiLU -> (3,1,1) conv stages with an identity
    residual, on (B, C, T, H, W) (reference openaimodel3d.py:257-309). With a
    `seq_group` of more than one rank, x holds this rank's T / seq frames
    (`gn_silu_conv_seq`)."""

    seq_group = None  # set by UNetModel.set_seq_group

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Sequential(GroupNorm(channels), nn.SiLU(), _temporal_conv(channels))
        self.conv2, self.conv3, self.conv4 = (
            nn.Sequential(GroupNorm(channels), nn.SiLU(), nn.Dropout(0.0), _temporal_conv(channels))
            for _ in range(3)
        )

    def forward(self, x):
        h, group = x, self.seq_group
        for stage in (self.conv1, self.conv2, self.conv3, self.conv4):
            if _sharded(group):
                h = gn_silu_conv_seq(stage[0], stage[-1], h, group)
            else:
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
    """GN-SiLU-conv residual block with the timestep embedding, then a
    TemporalConvBlock (`use_temporal_conv`). x: (B*T, C, H, W); emb: (B*T, E).
    With `use_scale_shift_norm` the embedding is (scale, shift), 2 * out
    wide, and FiLMs the out norm (h * (1 + scale) + shift before the SiLU,
    JAX layers.py:622-633), inside the fused kernel; else it is added to h
    before the out norm."""

    def __init__(self, channels: int, emb_channels: int, out_channels: Optional[int] = None,
                 use_temporal_conv: bool = True, use_scale_shift_norm: bool = False):
        super().__init__()
        out = out_channels or channels
        self.use_scale_shift_norm, self.use_temporal_conv = use_scale_shift_norm, use_temporal_conv
        self.in_layers = nn.Sequential(
            GroupNorm(channels), nn.SiLU(), nn.Conv2d(channels, out, 3, padding=1)
        )
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out if use_scale_shift_norm else out))
        self.out_layers = nn.Sequential(
            GroupNorm(out), nn.SiLU(), nn.Dropout(0.0), nn.Conv2d(out, out, 3, padding=1)
        )
        self.skip_connection = nn.Conv2d(channels, out, 1) if out != channels else nn.Identity()
        if use_temporal_conv:
            self.temopral_conv = TemporalConvBlock(out)  # the reference's spelling

    def forward(self, x, emb, batch_size: int):
        h = gn_silu_conv(self.in_layers[0], self.in_layers[2], x)
        emb_out = self.emb_layers(emb)
        if self.use_scale_shift_norm:
            h = gn_silu_conv(self.out_layers[0], self.out_layers[3], h, film=emb_out.chunk(2, dim=-1))
        else:
            h = gn_silu_conv(self.out_layers[0], self.out_layers[3], h + emb_out[:, :, None, None])
        h = self.skip_connection(x) + h
        if not self.use_temporal_conv:
            return h
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
