"""AdamW with f32, bf16 or blockwise-int8 moments, in plain PyTorch (port
of t2v_turbo_tpu/training/optim.py's `make_optimizer` and its moment
variants; the reference uses bitsandbytes' AdamW8bit, which is not
available here).

One update rule, optax's `adamw` (eps outside the square root, bias
correction by the step count, decoupled weight decay added to the step
before the learning rate), with the moments stored as:

- "adamw":      f32 (optax.adamw),
- "adamw_bf16": bf16, computed in f32 (`adamw_bf16_states`),
- "adamw8bit":  int8 in 256-value blocks of the flattened parameter, each
  with an f32 absmax / 127 scale; the second moment is stored as
  quantised sqrt(v) for range (`adamw_q8_states`).

`make_optimizer` defaults to weight_decay = 0, as the JAX package's does
(torch.optim.AdamW would default to 0.01). The learning rate is constant
(the JAX factory's warmup and cosine schedules have no caller here yet).

The v2 groups (`is_temporal_param`, `make_v2_optimizer`): init_attn and
the temporal transformers train at --temporal-lr, the rest at the base
rate (reference train_latent_t2v_turbo_v2.py:799-845). The JAX package
runs one Adam and scales the temporal leaves' updates by t_lr / lr
(t2v_turbo_tpu/training/optim.py:212-290), numerically the same as one
optimizer a group, which is what the port's full-model trainer holds: an
optimizer over each group's segments of its flat master, under one global
clip. With the text encoder trained (`v2_param_label`'s text arguments; the
text tower's parameters named "text.<its own key>"), only the last
`unlocked_text_layers` blocks of the reference's full tower and ln_final
train, in a "text" group at the base rate (JAX's "base" label for them:
Adam is elementwise, so a group of its own computes the same); the rest of
the tower is "frozen": no optimizer slot and no gradient
(`requires_grad=False`), which leaves them out of the global norm as JAX's
pre-clip `frozen_grad_mask` does (JAX `make_v2_label_fn`,
t2v_turbo_tpu/training/optim.py:293-335).

`flat_buffer` lays many tensors into one f32 buffer at 256-aligned offsets
with zeros between them: an optimizer over that one buffer computes what
one over the separate tensors computes (the int8 blocks are each tensor's
own blocks, zero-padded as the JAX package pads them; the padding's
gradient is zero, so it stays zero), in a few launches instead of a few per
tensor.
"""

from __future__ import annotations

import re
from typing import List, Optional

import torch
import torch.nn.functional as F

BLOCK = 256
STEP_CHUNK = 1 << 24  # elements an optimizer step takes at a time (a multiple of BLOCK)
MOMENTS = {"adamw": "f32", "adamw_bf16": "bf16", "adamw8bit": "q8"}


def flat_buffer(tensors: List[torch.Tensor]):
    """(one f32 buffer holding `tensors` at BLOCK-aligned offsets, zeros
    between; views of it shaped as the tensors)."""
    sizes = [t.numel() for t in tensors]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // BLOCK) * BLOCK)
    flat = torch.zeros(offsets[-1], dtype=torch.float32, device=tensors[0].device)
    views = [flat[o:o + n].view(t.shape) for o, n, t in zip(offsets, sizes, tensors)]
    with torch.no_grad():
        for v, t in zip(views, tensors):
            v.copy_(t)
    return flat, views


def square_sum_f32(g: torch.Tensor) -> torch.Tensor:
    """The sum of squares of a flat buffer in f32, chunk by chunk (no f32 copy
    of a bf16 buffer is made; each chunk's sum is pairwise: on the CPU
    `torch.linalg.vector_norm` of an 820K-element f32 gradient erred by
    1.6e-5 relative, this by 1e-7). On the card, one `vector_norm`, squared:
    its reduction is a tree already."""
    if g.is_cuda:
        return torch.square(torch.linalg.vector_norm(g, dtype=torch.float32))
    return sum(torch.sum(torch.square(c.float())) for c in g.reshape(-1).split(STEP_CHUNK))


def q8_quantize(x: torch.Tensor):
    """(int8 blocks (n_blocks, 256), f32 scales (n_blocks, 1)) of x's flattening."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8), scale


class AdamW:
    """AdamW over a list of f32 parameters, updated in place by `step(grads)`."""

    def __init__(self, params, learning_rate: float = 1e-5, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, moments: str = "f32"):
        if moments not in ("f32", "bf16", "q8"):
            raise ValueError(f"unknown moment storage {moments!r}")
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.weight_decay, self.moments = weight_decay, moments
        self.count = 0
        self.mu = [self._zeros(p) for p in self.params]
        self.nu = [self._zeros(p) for p in self.params]

    @property
    def row_elements(self) -> int:
        """The parameter elements one row of a moment holds: a 256-element
        int8 block (and its scale), or one element."""
        return BLOCK if self.moments == "q8" else 1

    def _zeros(self, p: torch.Tensor):
        """A zero moment for p in its storage: int8 blocks and their scales,
        bf16 or f32."""
        if self.moments == "q8":
            n_blocks = -(-p.numel() // BLOCK)
            return (torch.zeros((n_blocks, BLOCK), dtype=torch.int8, device=p.device),
                    torch.zeros((n_blocks, 1), dtype=torch.float32, device=p.device))
        return torch.zeros_like(p, dtype=torch.bfloat16 if self.moments == "bf16" else torch.float32)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], scale=None) -> None:
        """One update with grads (times `scale`, a scalar tensor, when given:
        the clip; a bf16 gradient is scaled, rounded back to bf16, then
        taken in f32, as the JAX trainer's bf16 gradient tree). Runs over
        STEP_CHUNK elements of each parameter at a time, so the f32
        temporaries stay small beside a full model's flat master; the chunks
        end on int8 block boundaries, so the result is the whole tensor's."""
        lr = self.learning_rate
        self.count += 1
        b1, b2 = self.b1, self.b2
        count = torch.tensor(float(self.count))
        bc1 = float(1 - torch.tensor(b1) ** count)  # f32 powers, as optax and JAX
        bc2 = float(1 - torch.tensor(b2) ** count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            pf, gf = p.view(-1), g.reshape(-1)
            for lo in range(0, pf.numel(), STEP_CHUNK):
                hi = min(pf.numel(), lo + STEP_CHUNK)
                gc = gf[lo:hi]
                if scale is not None:
                    gc = gc * scale
                    if g.dtype != torch.float32:
                        gc = gc.to(g.dtype)
                gc = gc.float()
                m = b1 * self._load(self.mu[i], lo, hi) + (1 - b1) * gc
                if self.moments == "q8":
                    v = b2 * self._load(self.nu[i], lo, hi) ** 2 + (1 - b2) * gc * gc
                else:
                    v = b2 * self._load(self.nu[i], lo, hi) + (1 - b2) * gc * gc
                step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                if self.weight_decay > 0:
                    step = step + self.weight_decay * pf[lo:hi].float()
                pf[lo:hi].add_((-lr * step).to(p.dtype))
                self._put(self.mu[i], lo, m)
                self._put(self.nu[i], lo, torch.sqrt(v) if self.moments == "q8" else v)

    def _load(self, stored, lo: int, hi: int) -> torch.Tensor:
        """Elements [lo, hi) of a stored moment, in f32."""
        if self.moments == "q8":
            q, scale = stored
            b0, b1 = lo // BLOCK, -(-hi // BLOCK)
            return (q[b0:b1].float() * scale[b0:b1]).reshape(-1)[: hi - lo]
        return stored.view(-1)[lo:hi].float()

    def _put(self, stored, lo: int, x: torch.Tensor) -> None:
        """Store x (f32) as elements [lo, lo + len) of a moment, in place."""
        if self.moments == "q8":
            q, scale = stored
            xq, xs = q8_quantize(x)
            b0 = lo // BLOCK
            q[b0:b0 + xq.shape[0]] = xq
            scale[b0:b0 + xs.shape[0]] = xs
        else:
            stored.view(-1)[lo:lo + x.numel()] = x

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu, "moments": self.moments}

    def load_state_dict(self, state: dict) -> None:
        if state["moments"] != self.moments:
            raise ValueError(f"state holds {state['moments']} moments, optimizer {self.moments}")

        def on(x, p):
            return tuple(t.to(p.device) for t in x) if isinstance(x, tuple) else x.to(p.device)

        self.count = int(state["count"])
        self.mu = [on(m, p) for m, p in zip(state["mu"], self.params)]
        self.nu = [on(n, p) for n, p in zip(state["nu"], self.params)]


def make_optimizer(params, name: str = "adamw", learning_rate: float = 1e-5,
                   weight_decay: float = 0.0, **kw) -> AdamW:
    """The JAX package's flag-level factory: "adamw", "adamw_bf16" or "adamw8bit"."""
    if name not in MOMENTS:
        raise ValueError(name)
    return AdamW(params, learning_rate, weight_decay=weight_decay, moments=MOMENTS[name], **kw)


_TEMPORAL = re.compile(r"init_attn\.|(input|output)_blocks\.\d+\.2\.|middle_block\.2\.")


def is_temporal_param(name: str) -> bool:
    """True for the parameters of init_attn and of the temporal transformers
    (index 2 of every block that has attention), under the port's (the
    reference's) UNet keys. JAX's flax names put the same modules at
    `input_blocks_{i}_2` with i one less (the port's input block 0 is
    conv_in), `middle_block_2`, `output_blocks_{i}_2` and `init_attn`."""
    return _TEMPORAL.match(name) is not None


TEXT_PREFIX = "text."
_TEXT_BLOCK = re.compile(r"transformer\.resblocks\.(\d+)\.")


def v2_text_label(name: str, unlocked_text_layers: int = 4, text_resblocks: int = 23) -> str:
    """The group of a text-tower parameter (its own key): "text" for
    ln_final and for the blocks whose index counted in the reference's full
    tower of text_resblocks + 1 blocks lies among the last
    `unlocked_text_layers` (the full tower's last block, which the
    penultimate tower does not run, is one of them: unlocked - 1 live
    blocks train), "frozen" for the rest (the embeddings included).
    `text_resblocks` is the number of blocks the tower runs."""
    if name.startswith("ln_final."):
        return "text"
    m = _TEXT_BLOCK.match(name)
    if m and int(m.group(1)) >= text_resblocks + 1 - unlocked_text_layers:
        return "text"
    return "frozen"


def v2_param_label(name: str, unlocked_text_layers: int = 4, text_resblocks: int = 23) -> str:
    """The v2 optimizer group of a trainable parameter: a UNet parameter's
    "temporal" or "base"; a text-tower parameter's (named TEXT_PREFIX + its
    key) `v2_text_label`."""
    if name.startswith(TEXT_PREFIX):
        return v2_text_label(name[len(TEXT_PREFIX):], unlocked_text_layers, text_resblocks)
    return "temporal" if is_temporal_param(name) else "base"


def make_v2_optimizer(params, label: str, name: str = "adamw", learning_rate: float = 1e-5,
                      temporal_learning_rate: Optional[float] = None, **kw) -> AdamW:
    """The optimizer of one v2 group (`v2_param_label`): the temporal group
    at `temporal_learning_rate` (the base rate when None), the rest (the
    text group too) at `learning_rate`. The frozen label has none."""
    if label == "frozen":
        raise ValueError("the frozen group has no optimizer")
    lr = temporal_learning_rate if label == "temporal" and temporal_learning_rate is not None else learning_rate
    return make_optimizer(params, name, lr, **kw)
