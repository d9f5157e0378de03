"""The flash backward's route choice (`ops/attention.py::flash_bwd_route`).

bf16 at head dim 64 goes to the wgmma kernels when TMA can read q, k, v and
dO (16-byte aligned bases, (batch, seq, head) strides of multiples of 16
bytes); other bf16 to the mma.sync kernels, f32 to the scalar ones. CPU
tensors have real addresses, so the predicate is tested on them; on the
CPU the wrappers run their plain twins and count no route.
"""

import numpy as np
import torch

from t2v_turbo_tpu_torch.ops import attention as A


def _bshd(b=2, s=40, h=3, d=64, dtype=torch.bfloat16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, h, d), generator=g).to(dtype)


def test_contiguous_bf16_head64_takes_wgmma():
    q, k, v, do = (_bshd(seed=i) for i in range(4))
    assert A.flash_bwd_route(q, k, v, do) == "wgmma"


def test_aligned_fused_qkv_view_takes_wgmma():
    """q, k, v as strided views of one (B, S, 3, H, D) projection."""
    qkv = torch.randn((2, 40, 3, 3, 64)).to(torch.bfloat16)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous() and q.stride(1) == 3 * 3 * 64
    assert A.flash_bwd_route(q, k, v, _bshd()) == "wgmma"


def test_views_one_element_off_take_mma():
    """Rows that start one element past 16-byte alignment (as chip_smoke's
    unaligned cases): base and sequence stride both break TMA's rule."""
    bufs = [torch.randn((2, 40, 3 * 64 + 1)).to(torch.bfloat16) for _ in range(4)]
    views = [t[..., 1:].view(2, 40, 3, 64) for t in bufs]
    assert all(t.data_ptr() % 16 != 0 for t in views)
    assert A.flash_bwd_route(*views) == "mma"
    aligned = [_bshd(seed=i) for i in range(4)]
    for i in range(4):  # one misaligned tensor is enough
        assert A.flash_bwd_route(*(views[j] if j == i else aligned[j] for j in range(4))) == "mma"


def test_head_dim_512_takes_mma():
    q, k, v, do = (_bshd(b=1, s=16, h=1, d=512, seed=i) for i in range(4))
    assert A.flash_bwd_route(q, k, v, do) == "mma"


def test_f32_takes_the_f32_route():
    for d in (64, 512):
        q, k, v, do = (_bshd(h=1, d=d, dtype=torch.float32, seed=i) for i in range(4))
        assert A.flash_bwd_route(q, k, v, do) == "f32"


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
