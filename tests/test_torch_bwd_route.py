"""The flash kernels' route choice (`ops/attention.py::flash_route`), for
the backward (q, k, v, dO) and the forward (q, k, v, o).

bf16 goes to the wgmma kernels when TMA can read every tensor (16-byte
aligned bases, (batch, seq, head) strides of multiples of 16 bytes) at head
dims 64 and 512, a forward only at a positive scale; other bf16 to the
mma.sync kernels, f32 to the scalar ones. CPU tensors have real addresses,
so the predicate is tested on them; on the CPU the wrappers run their plain
twins and count no route.
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


def test_views_one_element_off_take_mma():
    """Rows that start one element past 16-byte alignment (as chip_smoke's
    unaligned cases): base and sequence stride both break TMA's rule."""
    bufs = [torch.randn((2, 40, 3 * 64 + 1)).to(torch.bfloat16) for _ in range(4)]
    views = [t[..., 1:].view(2, 40, 3, 64) for t in bufs]
    assert all(t.data_ptr() % 16 != 0 for t in views)
    assert A.flash_route(*views) == "mma"
    aligned = [_bshd(seed=i) for i in range(4)]
    for i in range(4):  # one misaligned tensor is enough
        assert A.flash_route(*(views[j] if j == i else aligned[j] for j in range(4))) == "mma"


@pytest.mark.parametrize("kind, route", [("aligned", "wgmma"), ("off_by_one", "mma")])
def test_head_dim_512_takes_mma(kind, route):
    """The backward at head dim 512 (q, k, v, dO): wgmma when TMA can read
    every tensor, mma.sync for a view one element off."""
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
    ("off_by_one_q", "mma"), ("off_by_one_k", "mma"), ("off_by_one_v", "mma"),
    ("d512", "wgmma"), ("f32", "f32"),
    ("d512_contiguous", "wgmma"), ("d512_off_by_one_q", "mma"), ("d512_off_by_one_k", "mma"),
    ("d512_off_by_one_v", "mma"), ("d512_f32", "f32"),
])
def test_forward_route(kind, route):
    q, k, v = _fwd_case(kind)
    assert A.flash_route(q, k, v, fwd_scale=q.shape[-1] ** -0.5) == route  # the wrappers' default scale


@pytest.mark.parametrize("scale, route", [(0.125, "wgmma"), (2.0, "wgmma"), (-0.125, "mma"), (0.0, "mma")])
def test_forward_route_by_scale(scale, route):
    """The wgmma forward's running max is over the unscaled logits, so it
    takes positive scales only; the backward's route ignores the scale."""
    q, k, v = _fwd_case("contiguous")
    assert A.flash_route(q, k, v, fwd_scale=scale) == route
    assert A.flash_route(q, k, v, _bshd(seed=3)) == "wgmma"


@pytest.mark.parametrize("scale, route", [(0.125, "wgmma"), (2.0, "wgmma"), (-0.125, "mma"), (0.0, "mma")])
def test_forward_route_by_scale_d512(scale, route):
    """The same rule at head dim 512; the backward's route ignores the scale
    there too."""
    q, k, v = _fwd_case("d512_contiguous")
    assert A.flash_route(q, k, v, fwd_scale=scale) == route
    assert A.flash_route(q, k, v, _bshd(h=1, d=512, seed=3)) == "wgmma"


@pytest.mark.parametrize("kind", ["contiguous", "fused_qkv"])
def test_aligned_backward_d512_takes_mma(kind):
    """A TMA-readable backward at head dim 512, as the flash_attention_bwd_dkv
    and _dq wrappers lay it out (q, k, v, dO read; their outputs after),
    takes the wgmma kernels; the same layout with dO one element off takes
    the mma.sync kernels."""
    if kind == "fused_qkv":
        q, k, v = torch.randn((2, 40, 3, 1, 512)).to(torch.bfloat16).unbind(2)
    else:
        q, k, v = (_bshd(h=1, d=512, seed=i) for i in range(3))
    do = _bshd(h=1, d=512, seed=3)
    assert A.flash_route(q, k, v, do) == "wgmma"
    assert A._layout((q, k, v, do, q, k, v), 4)[0] == "wgmma"
    assert A._layout((q, k, v, do, do, k, v), 4)[0] == "wgmma"
    bad = torch.randn((2, 40, 513)).to(torch.bfloat16)[..., 1:].view(2, 40, 1, 512)
    assert A._layout((q, k, v, bad, q, k, v), 4)[0] == "mma"


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
