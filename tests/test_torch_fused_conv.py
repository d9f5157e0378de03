"""The port's fused GroupNorm+SiLU+conv (t2v_turbo_tpu_torch/ops/fused_conv.py,
B7) against the JAX package's `fused_gn_silu_conv`, on the CPU.

The JAX side runs its Pallas kernel in interpret mode (off-TPU, as
tests/test_ops.py runs it) and its custom VJP; the port runs its plain
version (the tensors lie on the CPU), and `FusedGnSiluConv` on CPU tensors
for the backward. Inputs come from seeded numpy in JAX's NHWC / HWIO layout
and are transposed to the port's NCHW / OIHW.

Tolerances (f32): forward 1e-5 absolute (test_ops.py's own bound for the
Pallas kernel against the XLA composition: only the order of f32 sums
differs); gradients 1e-4 x each tensor's largest entry (the backward
differentiates the same composition, sums in another order); the model-level
stages 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.ops import fused_conv as jfc
from t2v_turbo_tpu_torch.models import layers as players
from t2v_turbo_tpu_torch.ops import fused_conv as FC

G, EPS = 32, 1e-5


def _inputs(n, h, w, c, o, kh, kw, seed, film=False):
    """NHWC / HWIO numpy inputs, as tests/test_ops.py makes them."""
    rng = np.random.RandomState(seed)
    arrays = {
        "x": rng.randn(n, h, w, c),
        "gs": 1.0 + 0.1 * rng.randn(c),
        "gb": 0.1 * rng.randn(c),
        "wk": rng.randn(kh, kw, c, o) * 0.05,
        "bias": rng.randn(o),
    }
    if film:
        arrays.update(fs=rng.randn(n, c) * 0.1, fh=rng.randn(n, c) * 0.1)
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _port_args(a):
    """The port's arguments: x NCHW, the kernel OIHW."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    t["x"] = t["x"].permute(0, 3, 1, 2).contiguous()
    t["wk"] = t["wk"].permute(3, 2, 0, 1).contiguous()
    return t


def _nchw(y):
    return np.moveaxis(np.asarray(y), -1, 1)


SHAPES = [
    (2, 8, 8, 32, 64, 3, 3),   # spatial 3x3
    (1, 4, 16, 32, 32, 3, 1),  # temporal (3,1)
    (2, 12, 8, 64, 32, 3, 3),  # 12 rows: the TPU kernel's row-chunk remainder
]


@pytest.mark.parametrize("film", [False, True], ids=["no_film", "film"])
@pytest.mark.parametrize("n,h,w,c,o,kh,kw", SHAPES)
def test_plain_matches_jax_fused_gn_silu_conv(n, h, w, c, o, kh, kw, film):
    a = _inputs(n, h, w, c, o, kh, kw, seed=kh * 10 + c, film=film)
    fj = (jnp.asarray(a["fs"]), jnp.asarray(a["fh"])) if film else (None, None)
    ref = jfc.fused_gn_silu_conv(jnp.asarray(a["x"]), jnp.asarray(a["gs"]), jnp.asarray(a["gb"]),
                                 jnp.asarray(a["wk"]), jnp.asarray(a["bias"]), G, EPS, *fj)
    t = _port_args(a)
    ft = (t["fs"], t["fh"]) if film else (None, None)
    got = FC.fused_gn_silu_conv(t["x"], t["gs"], t["gb"], t["wk"], t["bias"], G, EPS, *ft)
    assert got.shape == (n, o, h, w)
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=1e-5, rtol=1e-5)


def test_affine_vectors_match_jax():
    a = _inputs(2, 6, 5, 64, 8, 3, 3, seed=3, film=True)
    ref = jfc._gn_affine_vectors(jnp.asarray(a["x"]), jnp.asarray(a["gs"]), jnp.asarray(a["gb"]), G, EPS,
                                 jnp.asarray(a["fs"]), jnp.asarray(a["fh"]))
    t = _port_args(a)
    got = FC.gn_affine_vectors(t["x"], t["gs"], t["gb"], G, EPS, t["fs"], t["fh"])
    for g_, r in zip(got, ref):
        np.testing.assert_allclose(g_.numpy(), np.asarray(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kh,kw", [(3, 3), (3, 1)])
def test_function_gradients_match_jax_custom_vjp(kh, kw):
    """`FusedGnSiluConv`'s backward on CPU tensors against jax.grad through
    `fused_gn_silu_conv`'s custom VJP, for x, the kernel, the GN affine, the
    conv bias and the FiLM."""
    n, h, w, c, o = 2, 6, 8, 32, 16
    a = _inputs(n, h, w, c, o, kh, kw, seed=7 + kh * kw, film=True)
    rng = np.random.RandomState(8)
    gy = rng.randn(n, h, w, o).astype(np.float32)
    names = ("x", "gs", "gb", "wk", "bias", "fs", "fh")

    def jloss(x, gs, gb, wk, bias, fs, fh):
        return jnp.sum(jfc.fused_gn_silu_conv(x, gs, gb, wk, bias, G, EPS, fs, fh) * gy)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(*(jnp.asarray(a[k]) for k in names))
    t = _port_args(a)
    leaves = [t[k].requires_grad_() for k in names]
    y = FC.FusedGnSiluConv.apply(*leaves[:5], leaves[5], leaves[6], G, EPS)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy).permute(0, 3, 1, 2))
    ref = dict(zip(names, (np.asarray(r) for r in ref)))
    ref["x"] = _nchw(ref["x"])
    ref["wk"] = np.transpose(ref["wk"], (3, 2, 0, 1))
    for name, g_ in zip(names, got):
        r = ref[name]
        np.testing.assert_allclose(g_.numpy(), r, atol=1e-4 * float(np.abs(r).max()), rtol=0, err_msg=name)


def test_wrapper_keeps_the_plain_gradient_on_cpu():
    """On CPU tensors the entry point is the plain version, so autograd
    through it equals autograd through `FusedGnSiluConv`'s backward."""
    t = _port_args(_inputs(1, 5, 4, 32, 8, 3, 3, seed=11))
    grads = []
    for fn in (FC.fused_gn_silu_conv, lambda *a: FC.FusedGnSiluConv.apply(*a, None, None, G, EPS)):
        leaves = [t[k].clone().requires_grad_() for k in ("x", "gs", "gb", "wk", "bias")]
        grads.append(torch.autograd.grad(fn(*leaves).square().sum(), leaves))
    for a_, b_ in zip(*grads):
        torch.testing.assert_close(a_, b_, atol=1e-5 * float(b_.abs().max()), rtol=0)


def test_film_needs_scale_and_shift_together():
    t = _port_args(_inputs(1, 4, 4, 32, 8, 3, 3, seed=12, film=True))
    with pytest.raises(ValueError, match="together"):
        FC.fused_gn_silu_conv(t["x"], t["gs"], t["gb"], t["wk"], t["bias"], G, EPS, t["fs"], None)


@pytest.mark.parametrize("stage", ["resblock_conv2d", "temporal_conv3d"])
def test_model_stage_equals_the_unfused_modules(stage):
    """`layers.gn_silu_conv` on the UNet's own modules equals GroupNorm(act=
    "silu") followed by the module's conv: a 3x3 Conv2d on frames, and a
    (3,1,1) Conv3d on a clip, run as a (3,1) conv on (B, C, T, H*W)."""
    torch.manual_seed(0)
    if stage == "resblock_conv2d":
        block = players.ResBlock(32, 64, 48)
        norm, conv, x = block.in_layers[0], block.in_layers[2], torch.randn(3, 32, 6, 5)
    else:
        block = players.TemporalConvBlock(32)
        norm, conv, x = block.conv2[0], block.conv2[-1], torch.randn(2, 32, 4, 3, 5)
    players.seeded_init_(block, 5)
    want = conv(norm(x, act="silu"))
    got = players.gn_silu_conv(norm, conv, x)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
