"""The training-time DDIM solver (port of t2v_turbo_tpu/diffusion/ddim.py).

Precomputed tables over a uniform grid of `ddim_timesteps` steps, held as
plain tensors on one device (`to(device)` moves them next to the latents),
and the deterministic DDIM step, its inversion and the index -> timestep
map. The tables are computed in float64 numpy as the JAX package does, then
held in float32. The VC2 latent-scale variant (`use_scale`) and eta > 0
belong to v2 training and are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .schedule import extract


@dataclasses.dataclass(frozen=True)
class DDIMSolver:
    alpha_cumprods: torch.Tensor  # (T,) f32
    ddim_timesteps: torch.Tensor  # (N,) int64
    ddim_alpha_cumprods: torch.Tensor  # (N,) f32
    ddim_alpha_cumprods_prev: torch.Tensor  # (N,) f32
    step_ratio: int

    @classmethod
    def create(cls, alpha_cumprods, timesteps: int = 1000, ddim_timesteps: int = 50,
               device=None) -> "DDIMSolver":
        ac_full = np.asarray(alpha_cumprods, dtype=np.float64)
        step_ratio = timesteps // ddim_timesteps
        ts = (np.arange(1, ddim_timesteps + 1) * step_ratio).round().astype(np.int64) - 1
        ac_prev = np.concatenate([ac_full[:1], ac_full[ts[:-1]]])

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

        return cls(
            alpha_cumprods=f32(ac_full),
            ddim_timesteps=torch.tensor(ts, device=device),
            ddim_alpha_cumprods=f32(ac_full[ts]),
            ddim_alpha_cumprods_prev=f32(ac_prev),
            step_ratio=step_ratio,
        )

    def to(self, device) -> "DDIMSolver":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self) if f.name != "step_ratio"}
        )

    def ddim_step(self, pred_x0, pred_noise, timestep_index):
        """Deterministic DDIM step x_t -> x_{t - step_ratio} at grid indices (B,)."""
        ac_prev = extract(self.ddim_alpha_cumprods_prev, timestep_index, pred_x0.dim())
        return torch.sqrt(ac_prev) * pred_x0 + torch.sqrt(1.0 - ac_prev) * pred_noise

    def ddim_reverse_step(self, x_prev, pred_noise, ts):
        """DDIM inversion x_{t - step_ratio} -> x_t at absolute timesteps ts (B,)."""
        nd = x_prev.dim()
        ac_next = extract(self.alpha_cumprods, ts, nd)
        ac = extract(self.alpha_cumprods, (ts - self.step_ratio).clamp_min(0), nd)
        return ((x_prev - torch.sqrt(1.0 - ac) * pred_noise) * torch.sqrt(ac_next / ac)
                + torch.sqrt(1.0 - ac_next) * pred_noise)

    def index_to_timestep(self, index):
        """DDIM grid index (B,) -> absolute diffusion timestep (B,)."""
        return self.ddim_timesteps[index.to(self.ddim_timesteps.device)]
