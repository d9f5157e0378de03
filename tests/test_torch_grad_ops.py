"""Gradients of the port's attention and norm ops against the JAX package's
custom VJPs, on the CPU.

The JAX side runs its Pallas kernels in interpret mode: `flash_attention`'s
VJP is the forward with log-sum-exp (B2) and the dK/dV and dQ backward
kernels (B3), `flash_attention_bshd`'s the BSHD family (B6), and the fused
norms' VJPs differentiate their reference math. The port's side is its
`FlashAttention` autograd function (whose kernel wrappers run their plain
twins for CPU tensors), the plain attention under autograd (what
`flash_attention` runs on the CPU), and the norm autograd functions with
their forward kernel swapped for the plain version (the CUDA kernels are
held against those plain versions on the card by chip_smoke.py).

Inputs come from seeded numpy; all f32. Tolerance: 2e-5 absolute on
outputs and gradients of O(1) (f32 sums in another order; the Pallas
kernels accumulate per 128-512 block).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t2v_turbo_tpu.ops import attention as jattn
from t2v_turbo_tpu.ops import fused_norms as jfused
from t2v_turbo_tpu_torch.ops import attention as A
from t2v_turbo_tpu_torch.ops import norms as N

ATOL = 2e-5
# (B, Sq, Sk, H, D): ragged S, Sk = 77, S = 16, the VAE's one head of 512,
# and one row past a 128-row (queries) and a 64-row (keys) tile
CASES = [(1, 200, 200, 2, 64), (1, 40, 77, 2, 64), (2, 16, 16, 3, 64), (1, 40, 40, 1, 512),
         (1, 129, 65, 2, 64)]
IDS = ["ragged", "cross77", "temporal16", "vae_head512", "tile_edge"]


def _qkvg(b, sq, sk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, s, h, d).astype(np.float32) for s in (sq, sk, sk, sq)]


def _bhsd(t):
    return jnp.asarray(np.swapaxes(t, 1, 2))


def _from_bhsd(t):
    return np.swapaxes(np.asarray(t), 1, 2)


def _port_grads(fn, q, k, v, g):
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = fn(qt, kt, vt)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(g))
    return out.detach().numpy(), [t.numpy() for t in grads]


@pytest.fixture(scope="module", params=list(zip(CASES, IDS)), ids=IDS)
def jax_flash_vjp(request):
    """Inputs and JAX flash_attention's output and (dq, dk, dv), (B, S, H, D)."""
    case, _ = request.param
    q, k, v, g = _qkvg(*case)
    out, vjp = jax.vjp(jattn.flash_attention, _bhsd(q), _bhsd(k), _bhsd(v))
    grads = vjp(_bhsd(g))
    return (q, k, v, g), _from_bhsd(out), [_from_bhsd(t) for t in grads]


@pytest.mark.parametrize("route", ["autograd_function", "plain_autograd"])
def test_attention_grads_match_flash_vjp(jax_flash_vjp, route):
    (q, k, v, g), ref_out, ref_grads = jax_flash_vjp
    fn = (lambda a, b, c: A.FlashAttention.apply(a, b, c, None)) if route == "autograd_function" \
        else A.flash_attention
    out, grads = _port_grads(fn, q, k, v, g)
    np.testing.assert_allclose(out, ref_out, atol=ATOL)
    for name, got, ref in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2])
def test_attention_grads_match_bshd_vjp(case):
    """The port's strided kernels stand for the BSHD family (B6): the same
    (B, S, H, D) tensors against `flash_attention_bshd`'s VJP."""
    q, k, v, g = _qkvg(*case, seed=1)
    out, vjp = jax.vjp(jattn.flash_attention_bshd, *(jnp.asarray(t) for t in (q, k, v)))
    ref_grads = vjp(jnp.asarray(g))
    got_out, grads = _port_grads(lambda a, b, c: A.FlashAttention.apply(a, b, c, None), q, k, v, g)
    np.testing.assert_allclose(got_out, np.asarray(out), atol=ATOL)
    for name, got, ref in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_twins_match_pallas_impls(case):
    """The plain twins of B2 and B3 against the Pallas implementations
    they replace, on the same inputs: lse from `_flash_attention_fwd_lse_impl`,
    and dq, dk, dv from `_flash_attention_bwd_impl` given that lse."""
    q, k, v, g = _qkvg(*case, seed=2)
    scale = case[-1] ** -0.5
    o_ref, lse_ref = jattn._flash_attention_fwd_lse_impl(_bhsd(q), _bhsd(k), _bhsd(v), scale=scale,
                                                          interpret=True)
    qt, kt, vt, gt = (torch.from_numpy(t) for t in (q, k, v, g))
    o, lse = A.flash_attention_lse(qt, kt, vt, scale)
    np.testing.assert_allclose(o.numpy(), _from_bhsd(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=ATOL)
    ref = jattn._flash_attention_bwd_impl(_bhsd(q), _bhsd(k), _bhsd(v), o_ref, lse_ref, _bhsd(g),
                                          scale=scale, interpret=True)
    lse_t = torch.from_numpy(np.array(lse_ref))
    delta = A.attention_bwd_delta(gt, torch.from_numpy(_from_bhsd(o_ref)))
    dk, dv = A.flash_attention_bwd_dkv(qt, kt, vt, gt, lse_t, delta, scale)
    dq = A.flash_attention_bwd_dq(qt, kt, vt, gt, lse_t, delta, scale)
    for name, got, r in zip("qkv", (dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), _from_bhsd(r), atol=ATOL, err_msg=f"d{name}")


def test_backward_counts_no_launch_on_cpu():
    counters = (A.flash_attention_lse, A.flash_attention_bwd_dkv, A.flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    q, k, v, g = _qkvg(1, 16, 16, 1, 64)
    _port_grads(lambda a, b, c: A.FlashAttention.apply(a, b, c, None), q, k, v, g)
    assert [f.launches for f in counters] == before


def _norm_inputs(shape, c, seed):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*shape) + 1.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, w, b, g


def _grads(fn, *arrays, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out.detach().numpy(), [t.numpy() for t in torch.autograd.grad(out, ts, torch.from_numpy(g))]


@pytest.fixture(params=["plain_autograd", "autograd_function"])
def norm_route(request, monkeypatch):
    """The CPU route (plain math under autograd), or the CUDA route's
    autograd functions with their kernel swapped for the plain version."""
    if request.param == "autograd_function":
        monkeypatch.setattr(N, "group_norm_cuda", N.group_norm_plain)
        monkeypatch.setattr(N, "layer_norm_cuda", N.layer_norm_plain)
        return {
            "gn": lambda x, w, b, *a: N._GroupNormFn.apply(x, w, b, *a),
            "ln": lambda x, w, b, *a: N._LayerNormFn.apply(x, w, b, *a),
        }
    return {"gn": N.fused_group_norm, "ln": N.fused_layer_norm}


@pytest.mark.parametrize(
    "shape,eps,act",
    [((2, 64, 4, 8), 1e-5, "silu"),  # per-frame ResBlock GN (N, C, H, W)
     ((1, 64, 4, 3, 5), 1e-6, None)],  # whole clip (B, C, T, H, W)
    ids=["per_frame", "whole_clip"],
)
def test_group_norm_grads_match_fused_vjp(norm_route, shape, eps, act):
    x, w, b, g = _norm_inputs(shape, shape[1], 0)
    cl = lambda a: np.moveaxis(a, 1, -1).reshape(shape[0], -1, shape[1])  # (N, HW, C)
    out, vjp = jax.vjp(lambda xx, ww, bb: jfused.fused_group_norm(xx, ww, bb, 32, eps, act, interpret=True),
                       jnp.asarray(cl(x)), jnp.asarray(w), jnp.asarray(b))
    ref_dx, ref_dw, ref_db = vjp(jnp.asarray(cl(g)))
    got, (dx, dw, db) = _grads(lambda xx, ww, bb: norm_route["gn"](xx, ww, bb, 32, eps, act), x, w, b, g=g)
    np.testing.assert_allclose(cl(got), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(cl(dx), np.asarray(ref_dx), atol=ATOL)
    np.testing.assert_allclose(dw, np.asarray(ref_dw), atol=1e-3, rtol=1e-5)  # sums of 10^3 terms
    np.testing.assert_allclose(db, np.asarray(ref_db), atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("act", [None, "silu"])
def test_layer_norm_grads_match_fused_vjp(norm_route, act):
    x, w, b, g = _norm_inputs((300, 64), 64, 1)
    out, vjp = jax.vjp(lambda xx, ww, bb: jfused.fused_layer_norm(xx, ww, bb, 1e-5, act, interpret=True),
                       jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = vjp(jnp.asarray(g))
    got, grads = _grads(lambda xx, ww, bb: norm_route["ln"](xx, ww, bb, 1e-5, act), x, w, b, g=g)
    np.testing.assert_allclose(got, np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(grads[0], np.asarray(ref[0]), atol=ATOL)
    for got_g, ref_g in zip(grads[1:], ref[1:]):
        np.testing.assert_allclose(got_g, np.asarray(ref_g), atol=1e-3, rtol=1e-5)
