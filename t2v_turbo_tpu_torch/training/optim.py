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

`flat_buffer` lays many tensors into one f32 buffer at 256-aligned offsets
with zeros between them: an optimizer over that one buffer computes what
one over the separate tensors computes (the int8 blocks are each tensor's
own blocks, zero-padded as the JAX package pads them; the padding's
gradient is zero, so it stays zero), in a few launches instead of a few per
tensor.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

BLOCK = 256
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


def q8_quantize(x: torch.Tensor):
    """(int8 blocks (n_blocks, 256), f32 scales (n_blocks, 1)) of x's flattening."""
    flat = x.reshape(-1).float()
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    return torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8), scale


def q8_dequantize(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[: like.numel()].reshape(like.shape)


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
        self.mu = [self._store(torch.zeros_like(p, dtype=torch.float32)) for p in self.params]
        self.nu = [self._store(torch.zeros_like(p, dtype=torch.float32)) for p in self.params]

    def _store(self, x: torch.Tensor):
        if self.moments == "q8":
            return q8_quantize(x)
        return x.to(torch.bfloat16) if self.moments == "bf16" else x

    def _load(self, stored, like: torch.Tensor) -> torch.Tensor:
        if self.moments == "q8":
            return q8_dequantize(*stored, like)
        return stored.float()

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        lr = self.learning_rate
        self.count += 1
        b1, b2 = self.b1, self.b2
        count = torch.tensor(float(self.count))
        bc1 = float(1 - torch.tensor(b1) ** count)  # f32 powers, as optax and JAX
        bc2 = float(1 - torch.tensor(b2) ** count)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = g.float()
            m = b1 * self._load(self.mu[i], p) + (1 - b1) * g
            if self.moments == "q8":
                v = b2 * self._load(self.nu[i], p) ** 2 + (1 - b2) * g * g
            else:
                v = b2 * self._load(self.nu[i], p) + (1 - b2) * g * g
            step = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.weight_decay > 0:
                step = step + self.weight_decay * p.float()
            p.add_((-lr * step).to(p.dtype))
            self.mu[i] = self._store(m)
            self.nu[i] = self._store(torch.sqrt(v) if self.moments == "q8" else v)

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
