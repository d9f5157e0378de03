"""The flash kernels' route choice (`ops/attention.py::flash_route`), for
the backward (q, k, v, dO) and the forward (q, k, v, o).

bf16 goes to the wgmma kernels when TMA can read every tensor (16-byte
aligned bases, (batch, seq, head) strides of multiples of 16 bytes) at head
dims 64 and 512, a forward only at a positive scale; any other bf16 forward
at head dim 64 to the staged kernel (the same consumers, fed by a producer
that realigns rows in registers); other bf16 to the packed route (the wgmma
kernels on contiguous copies made by the pack kernel), f32 to the scalar
kernels. No rule returns the deleted mma.sync route. CPU tensors have real
addresses, so the predicate is tested on them; on the CPU the wrappers run
their plain twins and count no route.
"""

import pytest

import numpy as np
import torch

from t2v_turbo_tpu_torch.ops import attention as A


def _bshd(b=2, s=40, h=3, d=64, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, h, d), generator=g).to(dtype)


def test_contiguous_bf16_head64_takes_wgmma():
    q, k, v, do = (_bshd(seed=i) for i in range(4))
    assert A.flash_route(q, k, v, do) == "wgmma"


def test_aligned_fused_qkv_view_takes_wgmma():
    """q, k, v as strided views of one (B, S, 3, H, D) projection."""
    qkv = torch.randn((2, 40, 3, 3, 64)).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * 3 * 64
    assert A.flash_route(q, k, v, _bshd()) == "wgmma"


def test_views_one_element_off_take_packed():
    """Rows that start one element past 16-byte alignment (as chip_smoke's
    unaligned cases): base and sequence stride both break TMA's rule."""
    bufs = [torch.randn((2, 40, 3 * 64 + 1)).to(torch.bfloat16) for _ in range(4)]
    views = [t[..., 1:].view(2, 40, 3, 64) for t in bufs]
    assert all(t.data_ptr() % 16 != 0 for t in views)
    assert A.flash_route(*views) == "packed"
    aligned = [_bshd(seed=i) for i in range(4)]
    for i in range(4):  # one misaligned tensor is enough
        assert A.flash_route(*(views[j] if j == i else aligned[j] for j in range(4))) == "packed"


@pytest.mark.parametrize("kind, route", [("aligned", "wgmma"), ("off_by_one", "packed")])
def test_head_dim_512_takes_packed(kind, route):
    """The backward at head dim 512 (q, k, v, dO): wgmma when TMA can read
    every tensor, packed for a view one element off."""
    q, k, v, do = (_bshd(b=1, s=16, h=1, d=512, seed=i) for i in range(4))
    if kind == "off_by_one":
        q = torch.randn((1, 16, 513)).to(torch.bfloat16)[..., 1:].view(1, 16, 1, 512)
        assert q.data_ptr() % 16 != 0
    assert A.flash_route(q, k, v, do) == route


def test_f32_takes_the_f32_route():
    for d in (64, 512):
        q, k, v, do = (_bshd(h=1, d=d, dtype=torch.float32, seed=i) for i in range(4))
        assert A.flash_route(q, k, v, do) == "f32"


def test_cpu_twins_count_no_route():
    q, k, v, do = (_bshd(seed=i).float() for i in range(4))
    scale = 64 ** -0.5
    o, lse = A.attention_lse_plain(q, k, v, scale)
    delta = A.attention_bwd_delta(do, o)
    before = [dict(A.flash_attention_bwd_dkv.by_route), dict(A.flash_attention_bwd_dq.by_route)]
    dk, dv = A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale)
    dq = A.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale)
    assert [dict(A.flash_attention_bwd_dkv.by_route), dict(A.flash_attention_bwd_dq.by_route)] == before
    assert all(np.isfinite(t.numpy()).all() for t in (dk, dv, dq))


def _fwd_case(kind):
    """(q, k, v) of one forward call; a "d512_" prefix: the same at the VAE
    mid block's one head of 512."""
    d, h = (512, 1) if kind.startswith("d512") else (64, 3)
    kind = kind.removeprefix("d512_")
    if kind == "fused_qkv":  # strided views of one (B, S, 3, H, D) projection
        q, k, v = torch.randn((2, 40, 3, 3, 64)).to(torch.bfloat16).unbind(2)
    elif kind.startswith("off_by_one_"):  # one tensor's rows one element past alignment
        q, k, v = (_bshd(h=h, d=d, seed=i) for i in range(3))
        bad = torch.randn((2, 40, h * d + 1)).to(torch.bfloat16)[..., 1:].view(2, 40, h, d)
        q, k, v = (bad if "qkv"[i] == kind[-1] else t for i, t in enumerate((q, k, v)))
    elif kind == "cross_77":  # 77 text tokens as keys
        q, k, v = _bshd(s=160, h=5, seed=0), _bshd(s=77, h=5, seed=1), _bshd(s=77, h=5, seed=2)
    elif kind == "d512":
        q, k, v = (_bshd(b=1, s=16, h=1, d=512, seed=i) for i in range(3))
    elif kind == "f32":
        q, k, v = (_bshd(h=1, d=d, dtype=torch.float32, seed=i) for i in range(3))
    else:
        q, k, v = (_bshd(h=h, d=d, seed=i) for i in range(3))
    return q, k, v


@pytest.mark.parametrize("kind, route", [
    ("contiguous", "wgmma"), ("fused_qkv", "wgmma"), ("cross_77", "wgmma"),
    ("off_by_one_q", "staged"), ("off_by_one_k", "staged"), ("off_by_one_v", "staged"),
    ("d512", "wgmma"), ("f32", "f32"),
    ("d512_contiguous", "wgmma"), ("d512_off_by_one_q", "packed"), ("d512_off_by_one_k", "packed"),
    ("d512_off_by_one_v", "packed"), ("d512_f32", "f32"),
])
def test_forward_route(kind, route):
    q, k, v = _fwd_case(kind)
    assert A.flash_route(q, k, v, fwd_scale=q.shape[-1] ** -0.5) == route  # the wrappers' default scale


@pytest.mark.parametrize("scale, route", [(0.125, "wgmma"), (2.0, "wgmma"), (-0.125, "staged"), (0.0, "staged")])
def test_forward_route_by_scale(scale, route):
    """The wgmma forward's running max is over the unscaled logits, so it
    takes positive scales only; the staged kernel takes the others at head
    dim 64; the backward's route ignores the scale."""
    q, k, v = _fwd_case("contiguous")
    assert A.flash_route(q, k, v, fwd_scale=scale) == route
    assert A.flash_route(q, k, v, _bshd(seed=3)) == "wgmma"


@pytest.mark.parametrize("scale, route", [(0.125, "wgmma"), (2.0, "wgmma"), (-0.125, "packed"), (0.0, "packed")])
def test_forward_route_by_scale_d512(scale, route):
    """The same rule at head dim 512; the backward's route ignores the scale
    there too."""
    q, k, v = _fwd_case("d512_contiguous")
    assert A.flash_route(q, k, v, fwd_scale=scale) == route
    assert A.flash_route(q, k, v, _bshd(h=1, d=512, seed=3)) == "wgmma"


@pytest.mark.parametrize("kind", ["contiguous", "fused_qkv"])
def test_aligned_backward_d512_takes_packed(kind):
    """A TMA-readable backward at head dim 512, as the flash_attention_bwd_dkv
    and _dq wrappers lay it out (q, k, v, dO read; their outputs after),
    takes the wgmma kernels; the same layout with dO one element off takes
    the packed route."""
    if kind == "fused_qkv":
        q, k, v = torch.randn((2, 40, 3, 1, 512)).to(torch.bfloat16).unbind(2)
    else:
        q, k, v = (_bshd(h=1, d=512, seed=i) for i in range(3))
    do = _bshd(h=1, d=512, seed=3)
    assert A.flash_route(q, k, v, do) == "wgmma"
    assert A._layout((q, k, v, do, q, k, v), 4)[0] == "wgmma"
    assert A._layout((q, k, v, do, do, k, v), 4)[0] == "wgmma"
    bad = torch.randn((2, 40, 513)).to(torch.bfloat16)[..., 1:].view(2, 40, 1, 512)
    assert A._layout((q, k, v, bad, q, k, v), 4)[0] == "packed"


@pytest.mark.parametrize("kind", ["off_by_one_q", "off_by_one_k", "off_by_one_v"])
def test_misaligned_view_at_negative_scale_takes_staged(kind):
    """A view TMA cannot read at a negative scale: the staged forward; its
    backward takes the packed route."""
    q, k, v = _fwd_case(kind)
    assert A.flash_route(q, k, v, fwd_scale=-0.125) == "staged"
    assert A.flash_route(q, k, v, _bshd(seed=3)) == "packed"


@pytest.mark.parametrize("which", ["seq", "head", "batch"])
def test_aligned_bases_odd_strides_take_staged(which):
    """Bases on 16-byte boundaries but an odd (batch, seq or head) element
    stride: TMA cannot read the rows, so the forward goes to the staged
    kernel (at head dim 512 to the packed route), whatever the scale's sign."""
    b, s, h = 2, 40, 3
    size = {"seq": (b, s, h * 64 + 1), "head": (b, s, h, 65), "batch": (b * s * h * 64 + 1,)}[which]
    buf = torch.randn(size).to(torch.bfloat16)
    if which == "seq":
        q = buf.as_strided((b, s, h, 64), (s * (h * 64 + 1), h * 64 + 1, 64, 1))
    elif which == "head":
        q = buf[..., :64]
    else:
        q = buf.as_strided((b, s, h, 64), (s * h * 64 + 1, h * 64, 64, 1))
    assert q.data_ptr() % 16 == 0 and q.stride()[:3] != _bshd().stride()[:3]
    assert any(st % 2 for st in q.stride()[:3])
    k, v = _bshd(seed=1), _bshd(seed=2)
    for scale in (0.125, -0.125, 0.0):
        assert A.flash_route(q, k, v, fwd_scale=scale) == "staged"
        assert A.flash_route(k, q, v, fwd_scale=scale) == "staged"
        assert A.flash_route(k, v, q, fwd_scale=scale) == "staged"
    q512 = torch.randn((1, 16, 513)).to(torch.bfloat16).as_strided((1, 16, 1, 512), (16 * 513, 513, 512, 1))
    assert q512.data_ptr() % 16 == 0
    k512, v512 = (_bshd(b=1, s=16, h=1, d=512, seed=i) for i in (1, 2))
    assert A.flash_route(q512, k512, v512, fwd_scale=512 ** -0.5) == "packed"


def test_staged_strides_carry_head_dim_strides():
    """The strides the C entries get: each tensor's (batch, seq, head)
    strides, then each tensor's head-dim stride, which the staged kernel's
    entry checks (1: contiguous)."""
    q, k, v = _fwd_case("off_by_one_q")
    o = torch.empty(q.shape, dtype=q.dtype)
    route, strides = A._layout((q, k, v, o), 3, 0.125)
    assert route == "staged"
    assert list(strides) == [x for t in (q, k, v, o) for x in t.stride()[:3]] + [1, 1, 1, 1]


@pytest.mark.parametrize("fwd", ["flash_attention", "flash_attention_lse"])
def test_cpu_forward_twins_count_nothing(fwd):
    _cpu_forward_counts_nothing(fwd, 64)


@pytest.mark.parametrize("fwd", ["flash_attention", "flash_attention_lse"])
def test_cpu_forward_twins_count_nothing_d512(fwd):
    _cpu_forward_counts_nothing(fwd, 512)


def _cpu_forward_counts_nothing(fwd, d):
    wrapper = getattr(A, fwd)
    q, k, v = (_bshd(h=1 if d == 512 else 3, d=d, seed=i).float() for i in range(3))
    before = (wrapper.launches, dict(wrapper.by_route), dict(wrapper.by_shape), dict(wrapper.by_head_dim))
    out = wrapper(q, k, v)
    assert (wrapper.launches, dict(wrapper.by_route), dict(wrapper.by_shape), dict(wrapper.by_head_dim)) == before
    o = out[0] if isinstance(out, tuple) else out
    np.testing.assert_allclose(o.numpy(), A.attention(q, k, v).numpy(), rtol=1e-5, atol=1e-6)


def test_forward_kernel_raises_off_the_card():
    """No fallback: the kernel wrapper refuses a CPU tensor instead of running
    the plain twin."""
    q, k, v = _fwd_case("contiguous")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        A.flash_attention_cuda(q, k, v)


def test_no_rule_returns_mma():
    """The mma.sync flash kernels are gone: over every layout and scale the
    tests above use, forward and backward, at both head dims and in both
    dtypes, the route is one of wgmma, staged, packed and f32, and the C
    route codes have no mma."""
    routes = set()
    kinds = ["contiguous", "fused_qkv", "cross_77", "off_by_one_q", "off_by_one_k", "off_by_one_v", "d512", "f32"]
    for kind in kinds + ["d512_" + k for k in kinds if k not in ("fused_qkv", "cross_77", "d512")]:
        q, k, v = _fwd_case(kind)
        do = torch.randn(q.shape).to(q.dtype)
        for scale in (0.125, -0.125, 0.0):
            routes.add(A.flash_route(q, k, v, fwd_scale=scale))
        routes.add(A.flash_route(q, k, v, do))
    assert routes == {"wgmma", "staged", "packed", "f32"}
    assert "mma" not in A.ROUTES
