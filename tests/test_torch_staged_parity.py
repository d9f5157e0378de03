"""The forward on views TMA cannot read (B6's forward, the staged route on
the card) against the JAX package's BSHD flash forward, on the CPU.

Views one element off a 16-byte boundary with an odd row stride (a
(B, S, H * 64 + 1) buffer less its first element), at (B, Sq, Sk, H, D) =
(2, 130, 130, 5, 64) and scales 0.125 and -0.125, in f32 and bf16, from
seeded numpy values. The port's `flash_attention` and `flash_attention_lse`
(their plain versions on CPU tensors) against JAX `flash_attention_bshd`
and `_flash_fwd_lse_bshd_impl` in interpret mode. On the card these views
take the staged kernel at both scales (checked here through `flash_route`).

Tolerances: f32 2e-5 absolute (sums in another order; the Pallas kernel
accumulates per block). bf16: o within 2e-3 + 2e-2 |ref| (chip_smoke's bf16
flash bound: the Pallas kernel rounds unnormalised probabilities to bf16,
the plain path normalised ones), lse within 1e-3 (f32 sums of exp in
another order over bf16 logits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.ops import attention as jattn
from t2v_turbo_tpu_torch.ops import attention as A

B, S, H, D = 2, 130, 5, 64
TOLS = {torch.float32: (2e-5, 0.0, 2e-5), torch.bfloat16: (2e-3, 2e-2, 1e-3)}  # o atol, o rtol, lse atol


def _views(dtype, seed=0):
    """q, k, v: (B, S, H, D) views one element into (B, S, H * D + 1) buffers."""
    rng = np.random.RandomState(seed)
    bufs = [torch.from_numpy(rng.randn(B, S, H * D + 1).astype(np.float32)).to(dtype) for _ in range(3)]
    return [t[..., 1:].view(B, S, H, D) for t in bufs]


def _jax(t):
    x = jnp.asarray(t.float().numpy())
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scale", [0.125, -0.125])
def test_misaligned_forward_matches_jax_bshd(scale, dtype):
    q, k, v = _views(dtype)
    assert q.stride(1) % 2 == 1 and q.storage_offset() == 1
    if dtype == torch.bfloat16:
        assert A.flash_route(q, k, v, fwd_scale=scale) == "staged"
    o_atol, o_rtol, lse_atol = TOLS[dtype]
    jq, jk, jv = (_jax(t) for t in (q, k, v))

    o = A.flash_attention(q, k, v, scale).float().numpy()
    ref = np.asarray(jattn.flash_attention_bshd(jq, jk, jv, scale).astype(jnp.float32))
    np.testing.assert_allclose(o, ref, atol=o_atol, rtol=o_rtol)

    o2, lse = A.flash_attention_lse(q, k, v, scale)
    ref_o, ref_lse = jattn._flash_fwd_lse_bshd_impl(jq, jk, jv, scale=scale, interpret=True)
    np.testing.assert_allclose(o2.float().numpy(), np.asarray(ref_o.astype(jnp.float32)), atol=o_atol, rtol=o_rtol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=lse_atol)
