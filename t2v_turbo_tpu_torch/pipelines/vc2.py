"""T2V-Turbo (VideoCrafter2) prompt -> video (port of t2v_turbo_tpu/pipelines/vc2.py).

Encode the prompt with the CLIP text tower, draw N(0, 1) latents, run the
LCM loop (UNet, boundary-condition combine, renoise) as a plain Python loop
over the 4 timesteps [999, 759, 519, 279], then decode every frame with the
VAE. Randomness comes from an explicit `torch.Generator`; tests may pass the
latents and the per-step noise instead, so two implementations can share them.

T2V-Turbo-v2's students also take a motion-guidance embedding
(`use_motion_cond`): guidance_scale_embedding(motion_gs) at the steps whose
timestep t >= num_timesteps * (1 - percentage), of 0 below that (JAX
pipelines/vc2.py:107-120, the reference pipeline :190-204). The v2
operating point is 16 steps from an LCM origin grid of 200.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..diffusion import DiffusionSchedule, LCMScheduler, guidance_scale_embedding


@dataclasses.dataclass
class T2VTurboVC2Pipeline:
    unet: torch.nn.Module
    vae: torch.nn.Module
    text_model: torch.nn.Module
    tokenizer: Any
    schedule: DiffusionSchedule
    device: torch.device
    scale_factor: float = 0.18215
    vae_scale: int = 8
    w_embedding_dim: int = 256
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.scheduler = LCMScheduler(schedule=self.schedule.to(self.device))

    @torch.no_grad()
    def encode_prompt(self, prompt: str | Sequence[str]) -> torch.Tensor:
        """prompt(s) -> (B, 77, 1024) cross-attention context."""
        tokens = torch.from_numpy(self.tokenizer(prompt)).to(self.device)
        return self.text_model(tokens)

    def _randn(self, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
        dev = generator.device if generator is not None else self.device
        return torch.randn(shape, generator=generator, device=dev).to(self.device)

    @torch.no_grad()
    def __call__(
        self,
        prompt: str | Sequence[str] | None = None,
        height: int = 320,
        width: int = 512,
        frames: int = 16,
        fps: int = 16,
        guidance_scale: float = 7.5,
        num_videos_per_prompt: int = 1,
        num_inference_steps: int = 4,
        lcm_origin_steps: int = 50,
        generator: Optional[torch.Generator] = None,
        latents: Optional[torch.Tensor] = None,
        prompt_embeds: Optional[torch.Tensor] = None,
        noise: Optional[Sequence[torch.Tensor]] = None,
        output_type: str = "video",
        use_motion_cond: bool = False,
        motion_gs: float = 0.1,
        percentage: float = 0.3,
    ) -> torch.Tensor:
        """-> video (B, T, H, W, 3) in [-1, 1], or the final latents when
        output_type="latent". `noise`, when given, is the renoise draw of
        each step (used only when there is more than one step)."""
        if use_motion_cond and getattr(self.unet, "motion_cond_proj", None) is None:
            raise ValueError("use_motion_cond needs a UNet built with motion_cond_proj_dim")
        levels = len(self.unet.cfg.channel_mult)
        multiple = self.vae_scale * 2 ** (levels - 1)
        if height % multiple or width % multiple:
            raise ValueError(f"height/width must be multiples of {multiple} (got {height}x{width})")
        if prompt_embeds is None:
            if prompt is None:
                raise ValueError("pass a prompt or prompt_embeds")
            prompt_embeds = self.encode_prompt(prompt)
        ctx = prompt_embeds.to(self.device, self.dtype)
        if num_videos_per_prompt != 1:
            ctx = ctx.repeat_interleave(num_videos_per_prompt, dim=0)
        bs = ctx.shape[0]

        shape = (bs, frames, height // self.vae_scale, width // self.vae_scale,
                 self.unet.cfg.in_channels)
        if latents is None:
            latents = self._randn(shape, generator)
        lat = latents.to(self.device, self.dtype)

        w = torch.full((bs,), guidance_scale, device=self.device)
        w_emb = guidance_scale_embedding(w, self.w_embedding_dim).to(self.dtype)
        fps_arr = torch.full((bs,), float(fps), device=self.device)

        ts = [int(t) for t in self.scheduler.timesteps(num_inference_steps, lcm_origin_steps)]
        prev_ts = ts[1:] + ts[-1:]
        denoised = lat
        for i, (t, pt) in enumerate(zip(ts, prev_ts)):
            tb = torch.full((bs,), t, dtype=torch.long, device=self.device)
            kw = {}
            if use_motion_cond:
                gs = motion_guidance_scale(t, motion_gs, percentage, self.schedule.num_timesteps)
                kw["motion_cond"] = guidance_scale_embedding(
                    torch.full((bs,), gs, device=self.device), self.w_embedding_dim).to(self.dtype)
            eps = self.unet(lat, tb, ctx, fps=fps_arr, timestep_cond=w_emb, **kw)
            step_noise = None
            if num_inference_steps > 1:
                step_noise = noise[i].to(self.device) if noise is not None else self._randn(shape, generator)
            lat_next, denoised = self.scheduler.step(eps.float(), t, pt, lat.float(), step_noise)
            lat = lat_next.to(self.dtype)

        if output_type == "latent":
            return denoised
        b, t, hh, ww, c = denoised.shape
        video = self.vae.decode(denoised.reshape(b * t, hh, ww, c).to(self.dtype) / self.scale_factor)
        return video.reshape(b, t, *video.shape[1:])


def motion_guidance_scale(t: int, motion_gs: float, percentage: float, num_timesteps: int = 1000) -> float:
    """The motion-guidance scale the v2 student is given at timestep t:
    `motion_gs` in the top `percentage` of the schedule, else 0."""
    return 0.0 if t < num_timesteps * (1.0 - percentage) else float(motion_gs)


def video_to_uint8(video: torch.Tensor) -> np.ndarray:
    """[-1, 1] float video -> uint8 numpy, on the host."""
    v = ((video.float() + 1.0) / 2.0).clamp(0, 1).cpu().numpy()
    return (v * 255).round().astype(np.uint8)
