"""Shared helpers for the tests that hold the PyTorch port (t2v_turbo_tpu_torch)
against the JAX package.

Weights and inputs come from seeded numpy; data crosses between the two
frameworks as numpy arrays. The tiny configurations are the ones the JAX
tests already use (tests/test_pipeline.py, tests/test_torch_import.py).
"""

import numpy as np
import torch

# tests/test_pipeline.py's tiny UNet / VAE / text tower
TINY_UNET_KW = dict(
    model_channels=32,
    num_res_blocks=1,
    attention_resolutions=(2, 1),
    channel_mult=(1, 2),
    num_head_channels=16,
    context_dim=16,
    time_cond_proj_dim=8,
)
TINY_VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY_TEXT_KW = dict(vocab_size=50, width=16, heads=2, layers=3, context_length=8)
# tests/test_torch_import.py's golden UNet (context 24)
GOLDEN_UNET_KW = dict(TINY_UNET_KW, context_dim=24)


def numpy_state_dict(module):
    return {k: v.detach().cpu().numpy() for k, v in module.state_dict().items()}


def seeded_numpy_state_dict(module, seed):
    """A state dict of the module's shapes filled from numpy with non-zero
    values: norm weights 1 + 0.1 N, vectors 0.1 N, matrices N / sqrt(fan_in)."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        r = rng.randn(*shape).astype(np.float32)
        if len(shape) <= 1:
            is_norm_weight = k.endswith(".weight") and _is_norm(module, k)
            r = 1.0 + 0.1 * r if is_norm_weight else 0.1 * r
        else:
            r = r / np.sqrt(np.prod(shape[1:]))
        out[k] = r.astype(np.float32)
    return out


def _is_norm(module, key):
    from t2v_turbo_tpu_torch.models.layers import GroupNorm, LayerNorm

    sub = module.get_submodule(key.rsplit(".", 1)[0])
    return isinstance(sub, (GroupNorm, LayerNorm))


def to_torch(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def assert_no_zeros(sd):
    for k, v in sd.items():
        v = np.asarray(v)
        assert np.count_nonzero(v) == v.size, f"{k} holds zeros"
