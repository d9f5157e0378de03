"""The packed route's attention (B6's backward at head dims 64 and 512, and
its forward at head dim 512, on views TMA cannot read) against the JAX
package's BSHD flash attention, on the CPU.

Views one element off a 16-byte boundary with an odd row stride (a
(B, S, H * D + 1) buffer less its first element), as
tests/test_torch_staged_parity.py makes them, from seeded numpy values, in
f32 and bf16. The backward: dq, dk and dv through the port's
`FlashAttention.apply` (its kernel wrappers run their plain twins on CPU
tensors) against `jax.vjp` of `flash_attention_bshd` (its Pallas kernels in
interpret mode), at (B, Sq, Sk, H, D) = (2, 130, 130, 5, 64) and
(1, 130, 130, 1, 512). The forward at head dim 512: `flash_attention` and
`flash_attention_lse` at scales 0.125, -0.125 and 0 against
`flash_attention_bshd` and `_flash_fwd_lse_bshd_impl`. On the card these
bf16 calls take the packed route (checked here through `flash_route`): the
pack kernel copies the views and the wgmma kernels run on the copies.

Tolerances, as test_torch_staged_parity.py states them: f32 2e-5 absolute
(sums in another order; the Pallas kernels accumulate per block), on the
outputs and on the gradients (values of O(1)). bf16: o and each gradient
within 2e-3 + 2e-2 |ref| (chip_smoke's bf16 flash bound: the Pallas kernels
round unnormalised probabilities, and P and dS, to bf16, the plain path
normalised f32 ones), lse within 1e-3 (f32 sums of exp in another order
over bf16 logits). One exception: the bf16 forward at head dim 512 and
|scale| = 1/8, whose logits (std 512^0.5 / 8 = 2.8, against 1 at the
default scale) put probabilities near 1, so that the two roundings of P
differ by up to 2^-8 max|v| (chip_smoke's bound for few keys, the same
effect): o within 2^-8 max|v| + 2e-2 |ref|. Measured over seeds 0-3, the
largest difference there is 2^-6, one bf16 ulp of an |o| in [2, 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.ops import attention as jattn
from t2v_turbo_tpu_torch.ops import attention as A

S = 130
TOLS = {torch.float32: (2e-5, 0.0, 2e-5), torch.bfloat16: (2e-3, 2e-2, 1e-3)}  # o atol, o rtol, lse atol
DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])


def _views(b, h, d, dtype, n, seed=0):
    """n (B, S, H, D) views one element into (B, S, H * D + 1) buffers."""
    rng = np.random.RandomState(seed)
    bufs = [torch.from_numpy(rng.randn(b, S, h * d + 1).astype(np.float32)).to(dtype) for _ in range(n)]
    views = [t[..., 1:].view(b, S, h, d) for t in bufs]
    assert all(t.stride(1) % 2 == 1 and t.storage_offset() == 1 for t in views)
    return views


def _jax(t):
    x = jnp.asarray(t.detach().float().numpy())
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


def _close(got, ref, atol, rtol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=atol,
                               rtol=rtol, err_msg=what)


@DTYPES
@pytest.mark.parametrize("b, h, d", [(2, 5, 64), (1, 1, 512)], ids=["d64", "d512"])
def test_misaligned_backward_matches_jax_bshd(b, h, d, dtype):
    q, k, v, do = _views(b, h, d, dtype, 4)
    if dtype == torch.bfloat16:
        assert A.flash_route(q, k, v, do) == "packed"
    scale = d**-0.5
    atol, rtol, _ = TOLS[dtype]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    assert leaves[0].stride() == q.stride() and leaves[0].storage_offset() == 1  # still the misaligned view
    o = A.FlashAttention.apply(*leaves, scale)
    grads = torch.autograd.grad(o, leaves, do)

    jq, jk, jv, jdo = (_jax(t) for t in (q, k, v, do))
    ref_o, vjp = jax.vjp(lambda x, y, z: jattn.flash_attention_bshd(x, y, z, scale), jq, jk, jv)
    _close(o, ref_o, atol, rtol, "o")
    for name, got, ref in zip(("dq", "dk", "dv"), grads, vjp(jdo)):
        _close(got, ref, atol, rtol, name)


@DTYPES
@pytest.mark.parametrize("scale", [0.125, -0.125, 0.0])
def test_misaligned_forward_d512_matches_jax_bshd(scale, dtype):
    q, k, v = _views(1, 1, 512, dtype, 3, seed=1)
    if dtype == torch.bfloat16:
        assert A.flash_route(q, k, v, fwd_scale=scale) == "packed"
    atol, rtol, lse_atol = TOLS[dtype]
    if dtype == torch.bfloat16 and scale != 0:  # probabilities near 1 (the module's docstring)
        atol = 2**-8 * float(v.abs().max())
    jq, jk, jv = (_jax(t) for t in (q, k, v))

    _close(A.flash_attention(q, k, v, scale), jattn.flash_attention_bshd(jq, jk, jv, scale), atol, rtol, "o")
    o, lse = A.flash_attention_lse(q, k, v, scale)
    ref_o, ref_lse = jattn._flash_fwd_lse_bshd_impl(jq, jk, jv, scale=scale, interpret=True)
    _close(o, ref_o, atol, rtol, "o (lse)")
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=lse_atol)
