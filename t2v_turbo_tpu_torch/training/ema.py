"""EMA of parameters: the v2 trainer's target network (port of
t2v_turbo_tpu/training/ema.py; reference train_latent_t2v_turbo_v2.py:
671-675, 1272-1276 and lvdm/ema.py)."""

from __future__ import annotations

import torch


@torch.no_grad()
def update_ema(ema: torch.Tensor, params: torch.Tensor, decay: float = 0.95) -> torch.Tensor:
    """ema <- decay * ema + (1 - decay) * params, in place, in ema's dtype
    (reference utils/common_utils.py:307-312). On the trainer's flat f32
    buffers this is two launches for the whole UNet."""
    return ema.mul_(decay).add_(params.to(ema.dtype), alpha=1.0 - decay)


def warmup_decay(step, decay: float = 0.9999) -> torch.Tensor:
    """LitEma-style warmup: min(decay, (1 + t) / (10 + t)) in f32
    (reference lvdm/ema.py:14-26)."""
    t = torch.as_tensor(step, dtype=torch.float32)
    return torch.clamp((1.0 + t) / (10.0 + t), max=decay)
