"""The training-time DDIM solver (port of t2v_turbo_tpu/diffusion/ddim.py).

Precomputed tables over a uniform grid of `ddim_timesteps` steps, held as
plain tensors on one device (`to(device)` moves them next to the latents),
and the DDIM step, its inversion and the index -> timestep map. The tables
are computed in float64 numpy as the JAX package does, then held in
float32. With `use_scale` the step applies VideoCrafter2's latent scale
(the reference ode_solver/ddim_solver.py:36-87) and, at `ddim_eta` > 0, adds
sigma_t times a noise draw the caller passes in or draws from an explicit
`torch.Generator`; the inversion refuses `use_scale`, as JAX's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .schedule import extract, make_vc2_scale_arr


@dataclasses.dataclass(frozen=True)
class DDIMSolver:
    alpha_cumprods: torch.Tensor  # (T,) f32
    ddim_timesteps: torch.Tensor  # (N,) int64
    ddim_alpha_cumprods: torch.Tensor  # (N,) f32
    ddim_alpha_cumprods_prev: torch.Tensor  # (N,) f32
    ddim_scale_arr: torch.Tensor  # (N,) f32, ones without use_scale
    ddim_scale_arr_prev: torch.Tensor  # (N,) f32
    ddim_sigmas: torch.Tensor  # (N,) f32, zeros at eta 0
    step_ratio: int
    use_scale: bool = False

    @classmethod
    def create(cls, alpha_cumprods, timesteps: int = 1000, ddim_timesteps: int = 50,
               device=None, scale_a: float = 1.0, scale_b: float = 0.7, mid_step: int = 400,
               ddim_eta: float = 0.0, use_scale: bool = False) -> "DDIMSolver":
        ac_full = np.asarray(alpha_cumprods, dtype=np.float64)
        step_ratio = timesteps // ddim_timesteps
        ts = (np.arange(1, ddim_timesteps + 1) * step_ratio).round().astype(np.int64) - 1
        ac, ac_prev = ac_full[ts], np.concatenate([ac_full[:1], ac_full[ts[:-1]]])
        if use_scale:
            scale = make_vc2_scale_arr(timesteps, scale_a, scale_b, mid_step)
            s, s_prev = scale[ts], np.concatenate([scale[:1], scale[ts[:-1]]])
        else:
            s = s_prev = np.ones_like(ac)
        sigmas = ddim_eta * np.sqrt((1 - ac_prev) / (1 - ac) * (1 - ac / ac_prev))

        def f32(a):
            return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

        return cls(
            alpha_cumprods=f32(ac_full),
            ddim_timesteps=torch.tensor(ts, device=device),
            ddim_alpha_cumprods=f32(ac),
            ddim_alpha_cumprods_prev=f32(ac_prev),
            ddim_scale_arr=f32(s),
            ddim_scale_arr_prev=f32(s_prev),
            ddim_sigmas=f32(sigmas),
            step_ratio=step_ratio,
            use_scale=use_scale,
        )

    def to(self, device) -> "DDIMSolver":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self) if f.name not in ("step_ratio", "use_scale")}
        )

    def ddim_step(self, pred_x0, pred_noise, timestep_index, noise=None,
                  generator: Optional[torch.Generator] = None):
        """DDIM step x_t -> x_{t - step_ratio} at grid indices (B,).
        Deterministic without use_scale. With use_scale, pred_x0 is carried
        by scale_prev / scale_t and sigma_t * noise is added: `noise` as
        given, else drawn from `generator` (on its device) when there is
        one, else none (JAX's step without a noise argument)."""
        nd = pred_x0.dim()
        ac_prev = extract(self.ddim_alpha_cumprods_prev, timestep_index, nd)
        dir_xt = torch.sqrt(1.0 - ac_prev) * pred_noise
        if not self.use_scale:
            return torch.sqrt(ac_prev) * pred_x0 + dir_xt
        coef = (extract(self.ddim_scale_arr_prev, timestep_index, nd)
                / extract(self.ddim_scale_arr, timestep_index, nd))
        out = torch.sqrt(ac_prev) * coef * pred_x0 + dir_xt
        if noise is None and generator is not None:
            noise = torch.randn(pred_x0.shape, generator=generator, device=generator.device)
        if noise is not None:
            out = out + extract(self.ddim_sigmas, timestep_index, nd) * noise.to(out.device)
        return out

    def ddim_reverse_step(self, x_prev, pred_noise, ts):
        """DDIM inversion x_{t - step_ratio} -> x_t at absolute timesteps ts (B,)
        (deterministic; a solver with use_scale refuses, as JAX's)."""
        if self.use_scale:
            raise ValueError("the DDIM inversion has no use_scale variant")
        nd = x_prev.dim()
        ac_next = extract(self.alpha_cumprods, ts, nd)
        ac = extract(self.alpha_cumprods, (ts - self.step_ratio).clamp_min(0), nd)
        return ((x_prev - torch.sqrt(1.0 - ac) * pred_noise) * torch.sqrt(ac_next / ac)
                + torch.sqrt(1.0 - ac_next) * pred_noise)

    def index_to_timestep(self, index):
        """DDIM grid index (B,) -> absolute diffusion timestep (B,)."""
        return self.ddim_timesteps[index.to(self.ddim_timesteps.device)]
