from .clip_text import CLIPTextConfig, CLIPTextModel
from .layers import cast_compute_dtype_, seeded_init_
from .unet_vc2 import UNetConfig, UNetModel
from .vae import AutoencoderKL, VAEConfig

__all__ = [
    "AutoencoderKL",
    "CLIPTextConfig",
    "CLIPTextModel",
    "UNetConfig",
    "UNetModel",
    "VAEConfig",
    "cast_compute_dtype_",
    "seeded_init_",
]
