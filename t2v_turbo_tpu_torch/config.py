"""The VideoCrafter2 model spec, in code.

The JAX package parses configs/vc2_t2v_512.yaml (t2v_turbo_tpu/config.py);
the port keeps the same values as dataclass defaults, so it needs no YAML
parser: `UNetConfig()` and `VAEConfig()` already are that file's UNet and VAE,
and `VC2ModelSpec` adds its text tower, noise schedule and latent scale.
(The file's `use_scale` latent scaling acts only in training's q_sample.)
"""

from __future__ import annotations

import dataclasses

from .diffusion import DiffusionSchedule
from .models.clip_text import CLIPTextConfig
from .models.unet_vc2 import UNetConfig
from .models.vae import VAEConfig


@dataclasses.dataclass(frozen=True)
class VC2ModelSpec:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    text: CLIPTextConfig = CLIPTextConfig()
    scale_factor: float = 0.18215  # latent scale of the VAE

    def make_schedule(self) -> DiffusionSchedule:
        return DiffusionSchedule.create(num_timesteps=1000, linear_start=0.00085, linear_end=0.012)


def vc2_spec(motion_cond: bool = False) -> VC2ModelSpec:
    """The T2V-Turbo VC2 student: the teacher's UNet plus the 256-d
    w-embedding projection (`time_cond_proj`); with `motion_cond`, the v2
    student's 256-d motion-guidance projection and `combine_proj` too."""
    return VC2ModelSpec(unet=UNetConfig(time_cond_proj_dim=256,
                                        motion_cond_proj_dim=256 if motion_cond else None))
