"""The x-transformers stack (port of t2v_turbo_tpu/models/x_transformer.py).

The reference's vendored lucidrains library (lvdm/modules/x_transformer.py:
19-704), the BERT-style text-encoder toolkit latent-diffusion shipped for its
BERTEmbedder: `TransformerWrapper`, `Encoder`, `AttentionLayers` and the
layer schedule `build_layer_types`, with every knob the JAX module keeps:
causal, cross_attend, only_cross, scalenorm / rmsnorm / rezero,
position-infused attention, macaron, sandwich_coef, par_ratio,
custom_layers, residual_attn, cross_residual_attn, pre / post norm,
gate_residual (GRU), talking heads, sparse_topk, memory key / values,
attention on attention, the GLU feed-forward, memory tokens, tied
embeddings. entmax15 and the `mems` recurrence raise, as in JAX.

Plain PyTorch with materialised probabilities, as the JAX module is by
design: the API exposes the pre- and post-softmax maps, talking-heads
mixing and residual-attention chaining, which need the (h, i, j) tensor.
It has no kernel.

Submodules carry the reference's names, so its state dicts (the ones
tests/goldens/x_transformer.npz stores) load strictly: `token_emb`,
`pos_emb.emb`, `project_emb`, `memory_tokens`, `attn_layers.layers.{i}.{0:
norm, 1: block (a Rezero's `g` and `fn`, a macaron Scale's `fn`), 2: GRU
residual `gru`}`, attention `to_q/to_k/to_v`, `to_out` (`to_out.0` with
attention on attention), `pre/post_softmax_proj`, `mem_k/mem_v`,
feed-forward `net.0.0` (`net.0.proj` with GLU) and `net.2`,
`pia_pos_emb.inv_freq`, `norm`, `to_logits`. The attention's and the
feed-forward's knobs go in as the JAX module's `attn_kwargs` / `ff_kwargs`
dicts. The reference's macaron Scale crashes on its own
FeedForward (x_transformer.py:129-131 vs :562); here, as in JAX, it applies
the intended 0.5.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

DEFAULT_DIM_HEAD = 64


class FixedPositionalEmbedding(nn.Module):
    """Sinusoids, the sin block then the cos block (reference :33-46)."""

    def __init__(self, dim: int):
        super().__init__()
        self.register_buffer("inv_freq", 1.0 / (10000 ** (torch.arange(0, dim, 2).float() / dim)))

    def forward(self, n: int) -> torch.Tensor:
        t = torch.arange(n, device=self.inv_freq.device, dtype=torch.float32)
        sinusoid = torch.einsum("i,j->ij", t, self.inv_freq)
        return torch.cat([sinusoid.sin(), sinusoid.cos()], dim=-1)[None]


class AbsolutePositionalEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)

    def forward(self, n: int) -> torch.Tensor:
        return self.emb(torch.arange(n, device=self.emb.weight.device))[None]


class ScaleNorm(nn.Module):
    """An L2 norm with one learned gain (reference :145-154)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.scale, self.eps = dim**-0.5, eps
        self.g = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale).clamp(min=self.eps) * self.g


class RMSNorm(ScaleNorm):
    """A per-channel gain over the same L2 norm (reference :157-166)."""

    def __init__(self, dim: int, eps: float = 1e-8):
        super().__init__(dim, eps)
        self.g = nn.Parameter(torch.ones(dim))


class Rezero(nn.Module):
    """fn's output times a learned scalar, zero at init (reference :133-142)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.g = nn.Parameter(torch.zeros(1))

    def forward(self, x, **kw):
        out, inter = self.fn(x, **kw)
        return out * self.g, inter


class Scale(nn.Module):
    """fn's output times a constant: the macaron halves (reference :122-130)."""

    def __init__(self, value: float, fn: nn.Module):
        super().__init__()
        self.value, self.fn = value, fn

    def forward(self, x):
        return self.fn(x) * self.value


class GRUGating(nn.Module):
    """The residual through a GRU cell: input the block's output, hidden the
    residual stream (reference :174-184)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gru = nn.GRUCell(dim, dim)

    def forward(self, x, residual):
        b, n, d = x.shape
        return self.gru(x.reshape(b * n, d), residual.reshape(b * n, d)).reshape(b, n, d)


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate)


class FeedForward(nn.Module):
    """(reference :200-216)"""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4, glu: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        inner = int(dim * mult)
        project_in = GEGLU(dim, inner) if glu else nn.Sequential(nn.Linear(dim, inner), nn.GELU())
        self.net = nn.Sequential(project_in, nn.Dropout(dropout), nn.Linear(inner, dim_out or dim))

    def forward(self, x):
        return self.net(x)


class Attention(nn.Module):
    """Self or cross attention with the x-transformers extras (reference
    :220-390). Returns (out, (pre-softmax logits, post-softmax probs))."""

    def __init__(self, dim: int, dim_head: int = DEFAULT_DIM_HEAD, heads: int = 8, causal: bool = False,
                 talking_heads: bool = False, sparse_topk: Optional[int] = None, use_entmax15: bool = False,
                 num_mem_kv: int = 0, dropout: float = 0.0, on_attn: bool = False):
        super().__init__()
        if use_entmax15:
            raise NotImplementedError("entmax15 is unimplemented in the reference too (x_transformer.py:236-239)")
        inner = dim_head * heads
        self.heads, self.dim_head, self.causal, self.sparse_topk = heads, dim_head, causal, sparse_topk
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.dropout = nn.Dropout(dropout)
        self.talking_heads = talking_heads
        if talking_heads:
            self.pre_softmax_proj = nn.Parameter(torch.randn(heads, heads))
            self.post_softmax_proj = nn.Parameter(torch.randn(heads, heads))
        self.num_mem_kv = num_mem_kv
        if num_mem_kv > 0:
            self.mem_k = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
            self.mem_v = nn.Parameter(torch.randn(heads, num_mem_kv, dim_head))
        self.to_out = nn.Sequential(nn.Linear(inner, dim * 2), nn.GLU()) if on_attn else nn.Linear(inner, dim)

    def forward(self, x, context=None, mask=None, context_mask=None, sinusoidal_emb=None, prev_attn=None):
        b, n, _ = x.shape
        kv_input = x if context is None else context
        q_input, k_input = x, kv_input
        if sinusoidal_emb is not None:  # position-infused attention
            q_input = q_input + sinusoidal_emb(n).to(x.dtype)
            k_input = k_input + sinusoidal_emb(k_input.shape[1]).to(x.dtype)
        heads = lambda t: t.reshape(b, -1, self.heads, self.dim_head).transpose(1, 2)  # noqa: E731
        q, k, v = heads(self.to_q(q_input)), heads(self.to_k(k_input)), heads(self.to_v(kv_input))

        input_mask = None
        if mask is not None or context_mask is not None:
            q_mask = mask if mask is not None else torch.ones((b, n), dtype=torch.bool, device=x.device)
            k_mask = q_mask if context is None else context_mask
            if k_mask is None:
                k_mask = torch.ones((b, k.shape[2]), dtype=torch.bool, device=x.device)
            input_mask = q_mask[:, None, :, None] & k_mask[:, None, None, :]
        if self.num_mem_kv > 0:
            k = torch.cat([self.mem_k.expand(b, -1, -1, -1), k], dim=2)
            v = torch.cat([self.mem_v.expand(b, -1, -1, -1), v], dim=2)
            if input_mask is not None:
                input_mask = F.pad(input_mask, (self.num_mem_kv, 0), value=True)

        dots = torch.einsum("bhid,bhjd->bhij", q, k) * self.dim_head**-0.5
        neg = -torch.finfo(dots.dtype).max
        if prev_attn is not None:
            dots = dots + prev_attn
        pre_softmax = dots
        if self.talking_heads:
            dots = torch.einsum("bhij,hk->bkij", dots, self.pre_softmax_proj)
        if input_mask is not None:
            dots = dots.masked_fill(~input_mask, neg)
        if self.causal:
            i, j = dots.shape[-2:]
            # queries may sit at the end of a longer key sequence
            later = torch.arange(i, device=x.device)[:, None] < torch.arange(j, device=x.device)[None, :] - (j - i)
            dots = dots.masked_fill(later, neg)
        if self.sparse_topk is not None and self.sparse_topk < dots.shape[-1]:
            top = dots.topk(self.sparse_topk, dim=-1).values
            dots = dots.masked_fill(dots < top[..., -1:], neg)
        attn = dots.softmax(dim=-1)
        post_softmax = attn
        attn = self.dropout(attn)
        if self.talking_heads:
            attn = torch.einsum("bhij,hk->bkij", attn, self.post_softmax_proj)
        out = torch.einsum("bhij,bhjd->bhid", attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out), (pre_softmax, post_softmax)


def build_layer_types(depth: int, cross_attend: bool, only_cross: bool, macaron: bool,
                      custom_layers: Optional[Sequence[str]], sandwich_coef: Optional[int],
                      par_ratio: Optional[int]) -> Tuple[str, ...]:
    """The layer-type schedule (reference :451-488): the default block, the
    macaron prefix, the PAR layout or the sandwich layout."""
    if cross_attend and not only_cross:
        default_block: Tuple[str, ...] = ("a", "c", "f")
    elif cross_attend and only_cross:
        default_block = ("c", "f")
    else:
        default_block = ("a", "f")
    if macaron:
        default_block = ("f",) + default_block
    if custom_layers is not None:
        return tuple(custom_layers)
    if par_ratio is not None:
        par_depth = depth * len(default_block)
        assert 1 < par_ratio <= par_depth, "par ratio out of range"
        default_block = tuple(t for t in default_block if t != "f")
        par_attn = par_depth // par_ratio
        depth_cut = par_depth * 2 // 3
        par_width = (depth_cut + depth_cut // par_attn) // par_attn
        assert len(default_block) <= par_width, "default block is too large for par_ratio"
        par_head = (default_block + ("f",) * (par_width - len(default_block))) * par_attn
        return par_head + ("f",) * (par_depth - len(par_head))
    if sandwich_coef is not None:
        assert 0 < sandwich_coef <= depth, "sandwich coefficient should be less than the depth"
        return ("a",) * sandwich_coef + default_block * (depth - sandwich_coef) + ("f",) * sandwich_coef
    return default_block * depth


class AttentionLayers(nn.Module):
    """The (norm, block, residual) layer stack (reference :393-584)."""

    def __init__(self, dim: int, depth: int, heads: int = 8, causal: bool = False, cross_attend: bool = False,
                 only_cross: bool = False, use_scalenorm: bool = False, use_rmsnorm: bool = False,
                 use_rezero: bool = False, position_infused_attn: bool = False,
                 custom_layers: Optional[Sequence[str]] = None, sandwich_coef: Optional[int] = None,
                 par_ratio: Optional[int] = None, residual_attn: bool = False, cross_residual_attn: bool = False,
                 macaron: bool = False, pre_norm: bool = True, gate_residual: bool = False, attn_kwargs=None,
                 ff_kwargs=None):
        super().__init__()
        attn_kw, ff_kw = dict(attn_kwargs or {}), dict(ff_kwargs or {})
        self.dim, self.pre_norm, self.gate_residual = dim, pre_norm, gate_residual
        self.residual_attn, self.cross_residual_attn = residual_attn, cross_residual_attn
        self.has_pos_emb = position_infused_attn
        self.pia_pos_emb = FixedPositionalEmbedding(dim) if position_infused_attn else None
        self.layer_types = build_layer_types(depth, cross_attend, only_cross, macaron, custom_layers,
                                             sandwich_coef, par_ratio)
        self.layers = nn.ModuleList()
        for lt in self.layer_types:
            if lt == "a":
                block = Attention(dim, heads=heads, causal=causal, **attn_kw)
            elif lt == "c":
                block = Attention(dim, heads=heads, **attn_kw)
            elif lt == "f":
                block = FeedForward(dim, **ff_kw)
                block = Scale(0.5, block) if macaron else block
            else:
                raise ValueError(f"invalid layer type {lt}")
            if use_rezero and lt in ("a", "c"):  # Rezero wraps the attentions only (reference :504-505)
                block = Rezero(block)
            if use_rezero:
                norm = nn.Identity()
            elif use_rmsnorm:
                norm = RMSNorm(dim)
            elif use_scalenorm:
                norm = ScaleNorm(dim)
            else:
                norm = nn.LayerNorm(dim)
            residual = GRUGating(dim) if gate_residual else nn.Identity()
            self.layers.append(nn.ModuleList([norm, block, residual]))

    def forward(self, x, context=None, mask=None, context_mask=None, mems=None, return_hiddens: bool = False):
        if mems is not None:
            raise NotImplementedError("the shortformer mems recurrence is not carried over (no caller anywhere "
                                      "in the reference)")
        hiddens, intermediates = [], []
        prev_attn = prev_cross_attn = None
        for i, (lt, (norm, block, residual_fn)) in enumerate(zip(self.layer_types, self.layers)):
            is_last = i == len(self.layers) - 1
            if lt == "a":
                hiddens.append(x)
            residual = x
            if self.pre_norm:
                x = norm(x)
            if lt == "a":
                out, inter = block(x, mask=mask, sinusoidal_emb=self.pia_pos_emb, prev_attn=prev_attn)
            elif lt == "c":
                out, inter = block(x, context=context, mask=mask, context_mask=context_mask,
                                   prev_attn=prev_cross_attn)
            else:
                out = block(x)
            x = residual_fn(out, residual) if self.gate_residual else out + residual
            if lt in ("a", "c"):
                intermediates.append(inter)
            if lt == "a" and self.residual_attn:
                prev_attn = inter[0]
            elif lt == "c" and self.cross_residual_attn:
                prev_cross_attn = inter[0]
            if not self.pre_norm and not is_last:
                x = norm(x)
        if return_hiddens:
            return x, {"hiddens": hiddens, "attn_intermediates": intermediates}
        return x


class Encoder(AttentionLayers):
    """Non-causal AttentionLayers (reference :587-590)."""

    def __init__(self, **kwargs):
        assert not kwargs.get("causal", False), "cannot set causality on encoder"
        super().__init__(causal=False, **kwargs)


class TransformerWrapper(nn.Module):
    """Token embedding + AttentionLayers + the logits head (reference
    :593-704), around an AttentionLayers module as the reference takes it
    (the JAX module takes its arguments as a dict)."""

    def __init__(self, num_tokens: int, max_seq_len: int, attn_layers: AttentionLayers,
                 emb_dim: Optional[int] = None, emb_dropout: float = 0.0, num_memory_tokens: int = 0,
                 tie_embedding: bool = False, use_pos_emb: bool = True):
        super().__init__()
        dim = attn_layers.dim
        emb_dim = emb_dim or dim
        self.max_seq_len, self.num_memory_tokens, self.tie_embedding = max_seq_len, num_memory_tokens, tie_embedding
        self.token_emb = nn.Embedding(num_tokens, emb_dim)
        nn.init.normal_(self.token_emb.weight, std=0.02)
        self.pos_emb = (AbsolutePositionalEmbedding(emb_dim, max_seq_len)
                        if use_pos_emb and not attn_layers.has_pos_emb else None)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.project_emb = nn.Linear(emb_dim, dim) if emb_dim != dim else nn.Identity()
        self.attn_layers = attn_layers
        self.norm = nn.LayerNorm(dim)
        self.to_logits = None if tie_embedding else nn.Linear(dim, num_tokens)
        if num_memory_tokens > 0:
            self.memory_tokens = nn.Parameter(torch.randn(num_memory_tokens, dim))

    def forward(self, x, return_embeddings: bool = False, mask=None, return_attn: bool = False, **layer_kwargs):
        b, n = x.shape
        h = self.token_emb(x)
        if self.pos_emb is not None:
            h = h + self.pos_emb(n)
        h = self.project_emb(self.emb_dropout(h))
        num_mem = self.num_memory_tokens
        if num_mem > 0:
            h = torch.cat([self.memory_tokens.expand(b, -1, -1), h], dim=1)
            if mask is not None:
                mask = F.pad(mask, (num_mem, 0), value=True)
        h, inter = self.attn_layers(h, mask=mask, return_hiddens=True, **layer_kwargs)
        h = self.norm(h)[:, num_mem:]
        if return_embeddings:
            out = h
        elif self.tie_embedding:
            out = h @ self.token_emb.weight.t()
        else:
            out = self.to_logits(h)
        if return_attn:
            return out, [post for _, post in inter["attn_intermediates"]]
        return out
