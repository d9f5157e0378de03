from .attention import flash_attention, sdpa
from .norms import fused_group_norm, fused_layer_norm, group_norm, layer_norm

__all__ = [
    "flash_attention",
    "fused_group_norm",
    "fused_layer_norm",
    "group_norm",
    "layer_norm",
    "sdpa",
]
