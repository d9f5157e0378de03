from .attention import flash_attention, sdpa, small_seq_attention
from .fused_conv import fused_gn_silu_conv
from .norms import fused_group_norm, fused_layer_norm, group_norm, layer_norm

__all__ = [
    "flash_attention",
    "fused_gn_silu_conv",
    "fused_group_norm",
    "fused_layer_norm",
    "group_norm",
    "layer_norm",
    "sdpa",
    "small_seq_attention",
]
