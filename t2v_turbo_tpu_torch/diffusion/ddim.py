"""The training-time DDIM solver (port of t2v_turbo_tpu/diffusion/ddim.py).

Precomputed tables over a uniform grid of `ddim_timesteps` steps, held as
plain tensors on one device (`to(device)` moves them next to the latents),
and the DDIM step, its inversion and the index -> timestep map. The tables
are computed in float64 numpy as the JAX package does, then held in
float32. With `use_scale` the step applies VideoCrafter2's latent scale
(the reference ode_solver/ddim_solver.py:36-87) and, at `ddim_eta` > 0, adds
sigma_t times a noise draw the caller passes in or draws from an explicit
`torch.Generator`; the inversion refuses `use_scale`, as JAX's does.

`ddim_sample_loop` is the lvdm API's whole DDIM chain (eta noise, CFG, the
latent scale) on either of the two grids the reference samples on.
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


def ddim_sample_loop(model_fn, solver: DDIMSolver, x_T: torch.Tensor,
                     generator: Optional[torch.Generator] = None, cfg_scale: float = 1.0,
                     uncond_model_fn=None, temperature: float = 1.0, grid: str = "sampler",
                     eta: float = 0.0, noise_fn=None) -> torch.Tensor:
    """The whole DDIM chain with eta noise, CFG and VideoCrafter2's latent
    scale: the reference's standalone DDIMSampler (lvdm/models/samplers/
    ddim.py:306-430), as JAX's `ddim_sample_loop`, a Python loop over the
    grid from its end.

    `grid="sampler"`: DDIMSampler's uniform grid i*(T//N) + 1, its tables
    from the solver's full alpha table, its sigmas from `eta`; a solver with
    use_scale is refused (it holds no full scale table). `grid="solver"`: the
    solver's own grid (i+1)*(T//N) - 1 and tables, its ddim_eta sigmas (`eta`
    is ignored) and, with use_scale, pred_x0 / scale_t carried by scale_prev.

    `model_fn(x, t_batch) -> eps` has the conditioning closed over, and so
    has `uncond_model_fn`, which cfg_scale != 1 needs. Each step adds
    sigma * temperature * noise: step i's noise (grid index n-1-i) is
    `noise_fn(i)` when given, else a draw from `generator` on x's device
    (made at every step, as JAX draws at sigma 0 too)."""
    if cfg_scale != 1.0 and uncond_model_fn is None:
        raise ValueError("cfg_scale != 1 requires uncond_model_fn")
    dev = x_T.device
    solver = solver.to(dev)
    n, b = solver.ddim_timesteps.shape[0], x_T.shape[0]
    scale_t = scale_prev = None
    if grid == "sampler":
        if solver.use_scale:
            raise NotImplementedError("use_scale needs the full scale_arr; use grid='solver'")
        big_t = solver.alpha_cumprods.shape[0]
        ts = torch.arange(n, device=dev) * (big_t // n) + 1
        ac = solver.alpha_cumprods[ts]
        ac_prev = torch.cat([solver.alpha_cumprods[:1], ac[:-1]])
        sigmas = eta * torch.sqrt((1 - ac_prev) / (1 - ac) * (1 - ac / ac_prev))
    elif grid == "solver":
        ts, ac, ac_prev = solver.ddim_timesteps, solver.ddim_alpha_cumprods, solver.ddim_alpha_cumprods_prev
        sigmas = solver.ddim_sigmas
        if solver.use_scale:
            scale_t, scale_prev = solver.ddim_scale_arr, solver.ddim_scale_arr_prev
    else:
        raise ValueError(f"unknown grid: {grid!r}")

    x = x_T
    nd = x.dim()
    for step, i in enumerate(range(n - 1, -1, -1)):
        tb = ts[i].expand(b)
        e_t = model_fn(x, tb)
        if cfg_scale != 1.0:
            e_u = uncond_model_fn(x, tb)
            e_t = e_u + cfg_scale * (e_t - e_u)
        idx = torch.full((b,), i, dtype=torch.long, device=dev)
        a_t, a_prev, sigma = (extract(tab, idx, nd) for tab in (ac, ac_prev, sigmas))
        pred_x0 = (x - torch.sqrt(1.0 - a_t) * e_t) / torch.sqrt(a_t)
        dir_xt = torch.sqrt(torch.clamp_min(1.0 - a_prev - sigma**2, 0.0)) * e_t
        z = noise_fn(step) if noise_fn is not None else torch.randn(
            x.shape, generator=generator, device=dev, dtype=x.dtype)
        noise = sigma * z.to(dev, x.dtype) * temperature
        if scale_t is not None:
            pred_x0 = pred_x0 / extract(scale_t, idx, nd)
            x0_term = torch.sqrt(a_prev) * extract(scale_prev, idx, nd) * pred_x0
        else:
            x0_term = torch.sqrt(a_prev) * pred_x0
        x = x0_term + dir_xt + noise
    return x
