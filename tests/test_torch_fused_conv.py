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
from t2v_turbo_tpu_torch.apps.time_fused_conv import UNET_STEP_SHAPES
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


# ---- the bf16 kernel's launch plan (ops/fused_conv.py::conv_plan), checked
# on the CPU by enumerating its tiles and replaying its slab indexing.

# Every distinct fused-conv shape of a VC2 UNet step, and an odd size.
PLAN_SHAPES = UNET_STEP_SHAPES + [(2, 96, 5, 300, 70, 3, 1)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids(PLAN_SHAPES))
def test_plan_takes_the_wgmma_route(shape):
    n, c, h, w, o, kh, kw = shape
    plan = FC.conv_plan(*shape)
    assert plan.route == "wgmma"
    assert plan.bn in (32, 160) and plan.tw * plan.tr <= FC.PIXELS
    assert plan.npos == FC.slab_positions(n, h, kh, kw, plan.tw, plan.tr) <= FC.MAX_SLAB
    chunks = -(-c // FC.CHUNK)
    assert plan.splits == -(-chunks // plan.chunks_per_split)
    assert plan.grid == (-(-n * h // plan.tr) * -(-w // plan.tw), -(-o // plan.bn), plan.splits)
    assert FC.conv_plan(*shape, torch.float32).route == "f32"


def _plan_tiles(plan, n, h, w):
    """The pixels of each block of a bf16 plan, as the kernel maps its 128
    rows (csrc/fused_conv.cu: r0 = (tile / tiles_w) * TR, w0 = (tile %
    tiles_w) * TW, row m at image row r0 + m / TW, column w0 + m % TW):
    {(tile, row): (image, h, w)} for the rows it stores."""
    rows, tiles_w = n * h, -(-w // plan.tw)
    out = {}
    for tile in range(plan.grid[0]):
        r0, w0 = (tile // tiles_w) * plan.tr, (tile % tiles_w) * plan.tw
        for m in range(plan.tr * plan.tw):
            r, col = r0 + m // plan.tw, w0 + m % plan.tw
            if r < rows and col < w:
                out[(tile, m)] = (r // h, r % h, col)
    return out


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=_ids(PLAN_SHAPES))
def test_plan_tiles_cover_every_output_pixel_once(shape):
    """The kernel's map from (tile, row) to (image, h, w), replayed in
    Python: every pixel of every image exactly once, tiles that span images
    and ragged edges included."""
    n, c, h, w, o, kh, kw = shape
    plan = FC.conv_plan(*shape)
    pixels = list(_plan_tiles(plan, n, h, w).values())
    assert len(pixels) == n * h * w
    assert set(pixels) == {(i, r, col) for i in range(n) for r in range(h) for col in range(w)}


def test_plan_folds_images_and_splits_the_small_levels():
    """At 5x8 a tile holds three frames and more. Where the tiles alone
    leave most of the 132 SMs idle (the 5x8 level: 40 blocks; the level-3
    temporal conv: 48) the input channels are split, in 2, 4 or 8 (a
    cluster); the L0 convs, 640 blocks, are not."""
    plan = FC.conv_plan(16, 2560, 5, 8, 1280, 3, 3)
    tiles = _plan_tiles(plan, 16, 5, 8)
    assert max(len({img for (t, _), (img, _, _) in tiles.items() if t == tile}) for tile in range(plan.grid[0])) >= 3
    for shape in ((16, 2560, 5, 8, 1280, 3, 3), (16, 1280, 5, 8, 1280, 3, 3), (1, 1280, 16, 40, 1280, 3, 1)):
        assert FC.conv_plan(*shape).splits > 1
    assert FC.conv_plan(16, 320, 40, 64, 320, 3, 3).splits == 1
    assert all(FC.conv_plan(*shape).splits in (1, 2, 4, 8) for shape in PLAN_SHAPES)


def _replay(plan, h_act, wk):
    """conv(h_act, wk) ('same', stride 1) computed as the bf16 kernel indexes
    it: each tile's slab filled from the extended rows its positions map to
    (zeros in the halo), each output row reading its slab position plus the
    tap's shift. h_act (N, C, H, W), wk (O, C, kh, kw); numpy f64."""
    n, c, h, w = h_act.shape
    o, _, kh, kw = wk.shape
    eh, sw = h + kh - 1, plan.tw + kw - 1
    ext = lambda r: (r // h) * eh + r % h + kh // 2  # noqa: E731
    rows = n * h
    tiles_w = -(-w // plan.tw)
    y = np.full((n, o, h, w), np.nan)
    for tile in range(plan.grid[0]):
        r0, w0 = (tile // tiles_w) * plan.tr, (tile % tiles_w) * plan.tw
        e0 = ext(r0)
        npos = (ext(min(r0 + plan.tr, rows) - 1) - e0 + kh) * sw
        assert npos <= plan.npos
        slab = np.zeros((npos, c))
        for pos in range(npos):
            es = e0 - kh // 2 + pos // sw
            img, hh, ww = es // eh, es % eh - kh // 2, w0 - kw // 2 + pos % sw
            if img < n and 0 <= hh < h and 0 <= ww < w:
                slab[pos] = h_act[img, :, hh, ww]
        for m in range(plan.tr * plan.tw):
            r, col = r0 + m // plan.tw, w0 + m % plan.tw
            if r >= rows or col >= w:
                continue
            base = (ext(r) - e0) * sw + m % plan.tw
            acc = np.zeros(o)
            for i in range(kh):
                for j in range(kw):
                    acc += wk[:, :, i, j] @ slab[base + i * sw + j]
            assert np.isnan(y[r // h, :, r % h, col]).all()
            y[r // h, :, r % h, col] = acc
    return y


@pytest.mark.parametrize("shape", [(16, 8, 5, 8, 4, 3, 3), (3, 8, 7, 9, 4, 3, 3), (2, 8, 5, 300, 4, 3, 1),
                                   (1, 8, 16, 40, 4, 3, 1), (5, 8, 1, 1, 4, 3, 3)],
                         ids=["5x8_frames", "odd_7x9", "temporal_300", "temporal_40", "1x1"])
def test_plan_slab_indexing_replays_the_conv(shape):
    """The plan's tiles and the kernel's slab indexing, replayed in numpy,
    equal a 'same' convolution of the activation (zero halo after it)."""
    n, c, h, w, o, kh, kw = shape
    rng = np.random.RandomState(sum(shape))
    h_act = rng.randn(n, c, h, w)
    wk = rng.randn(o, c, kh, kw)
    want = torch.nn.functional.conv2d(torch.from_numpy(h_act), torch.from_numpy(wk), padding=(kh // 2, kw // 2))
    got = _replay(FC.conv_plan(*shape), h_act, wk)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-10, rtol=1e-10)


def test_cuda_wrapper_raises_and_counts_nothing_off_the_card():
    """No fallback: a tensor that is not on the CPU goes to the kernel
    launcher, which raises where no kernel takes it; the counters move only
    on a launch. A dtype no route takes is refused by the plan."""
    t = _port_args(_inputs(1, 4, 4, 32, 8, 3, 3, seed=13))
    meta = [t[k].to("meta") for k in ("x", "gs", "gb", "wk", "bias")]
    before = (FC.fused_gn_silu_conv.launches, dict(FC.fused_gn_silu_conv.by_route))
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        FC.fused_gn_silu_conv(*meta, G, EPS)
    with pytest.raises(RuntimeError, match="no kernel for device cpu"):
        FC.fused_gn_silu_conv_cuda(t["x"], t["gs"], t["gb"], t["wk"], t["bias"], G, EPS)
    FC.fused_gn_silu_conv(t["x"], t["gs"], t["gb"], t["wk"], t["bias"], G, EPS)  # the plain version
    assert (FC.fused_gn_silu_conv.launches, dict(FC.fused_gn_silu_conv.by_route)) == before
    with pytest.raises(TypeError, match="no kernel for dtype"):
        FC.conv_plan(1, 32, 4, 4, 8, 3, 3, torch.float16)
