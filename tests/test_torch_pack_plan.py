"""The pack kernel's loads (t2v_turbo_tpu_torch/ops/attention.py `pack_slice`,
`pack_unit` and `pack_lane_units`, mirroring csrc/pack_bshd.cu), and its
plain twin, on the CPU.

The kernel runs only on the card. Its addressing is checked here: a numpy
replay over bf16 (B, S, H, D) views that TMA cannot read, at D = 64 and
512 (all 8 even byte offsets; odd row strides, odd head strides, and
aligned ones), takes each 128-byte unit the kernel's warps take, finds its
slice by the kernel's divisions (`pack_unit`), reads the aligned chunks
`pack_slice` names and keeps the bytes it names, and rebuilds the
contiguous copy byte for byte; in the negate mode the copy with each bf16's
sign bit flipped, in the zero mode zeros (reading nothing). No read leaves
the 16-byte granules that the slice's bytes lie in. The lane map writes
each 16-byte chunk of a warp's units once. The CPU twin `pack_bshd` equals
`contiguous()` and its negated and zeroed forms, bit for bit. The kernel's
constants are mirrored.

No tolerance: the replay copies bytes.
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.ops import attention as A
from t2v_turbo_tpu_torch.ops import cuda_lib


def _views():
    """(label, buffer, view) for (2, 9, 3, D) bf16 views at every even byte
    offset (element offset 0..7), D = 64 and 512, with an odd row stride, an
    aligned one, and an odd head stride with an odd row stride."""
    g = torch.Generator().manual_seed(0)
    b, s, h = 2, 9, 3
    out = []
    for d in (64, 512):
        for off in range(8):
            for row_stride, head_stride in ((h * d + 1, d), (h * d, d), (h * (d + 1) + 2, d + 1)):
                n = off + (b * s - 1) * row_stride + (h - 1) * head_stride + d
                buf = torch.randn(n, generator=g).to(torch.bfloat16)
                view = buf.as_strided((b, s, h, d), (s * row_stride, row_stride, head_stride, 1), off)
                out.append((f"D {d}, offset {2 * off} B, row stride {row_stride}, head stride {head_stride}",
                            buf, view))
    return out


def _bytes(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint8).reshape(-1)


def _replay(mem, base, view, mode):
    """The contiguous copy the kernel writes: each warp's 4 PACK_UNITS units,
    each lane's (unit, chunk) by `pack_lane_units`, the unit's slice by
    `pack_unit`, its loads by `pack_slice`; asserts that no read leaves the
    slice's granules and that every chunk of the output is written once."""
    b, s, h, d = view.shape
    e = view.element_size()
    units = b * s * h * (d // 64)
    out = np.zeros(units * A.PACK_UNIT_BYTES, dtype=np.uint8)
    written = np.zeros(units * 8, dtype=np.int64)
    per_warp = 4 * A.PACK_UNITS
    for first in range(0, units, per_warp):
        for lane in range(32):
            for unit, c in A.pack_lane_units(lane):
                i = first + unit
                if i >= units:
                    continue
                bi, si, hi, piece = A.pack_unit(i, s, h, d)
                addr = base + e * (view.storage_offset() + bi * view.stride(0) + si * view.stride(1)
                                   + hi * view.stride(2))
                plan = A.pack_slice(addr, d)[piece]
                assert plan.start % 16 == 0 and plan.dest == A.PACK_UNIT_BYTES * piece
                lo, hi_ = plan.start - base, plan.start - base + 16 * plan.chunks
                assert addr - addr % 16 <= plan.start and plan.start + 16 * plan.chunks <= -(-(addr + e * d) // 16) * 16
                chunk = np.zeros(16, dtype=np.uint8)
                if mode != "zero":  # the zero mode reads nothing
                    raw = np.zeros(16 * plan.chunks, dtype=np.uint8)
                    got = mem[lo:hi_]
                    raw[:len(got)] = got
                    chunk = raw[plan.shift + 16 * c:plan.shift + 16 * c + 16].copy()
                    if mode == "negated":
                        chunk[1::2] ^= 0x80  # the high byte of each little-endian bf16
                out[i * A.PACK_UNIT_BYTES + 16 * c:i * A.PACK_UNIT_BYTES + 16 * c + 16] = chunk
                written[i * 8 + c] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("mode", list(A.PACK_MODES))
@pytest.mark.parametrize("label, buf, view", _views(), ids=lambda x: x if isinstance(x, str) else "")
def test_replay_rebuilds_the_contiguous_copy(label, buf, view, mode):
    mem = _bytes(buf)
    base = buf.data_ptr()
    assert base % 16 == 0  # an allocation: the granules of mem start at mem[0]
    want = _bytes(A.pack_bshd_plain(view, mode))
    np.testing.assert_array_equal(_replay(mem, base, view, mode), want, err_msg=f"{label}, {mode}")


def test_slice_loads():
    """All 8 even offsets at both head dims: 8 chunks a unit at offset 0, 9
    otherwise, the shift being the offset, units 128 bytes apart; odd
    addresses and other head dims are refused."""
    for d in (64, 512):
        for off in range(0, 16, 2):
            plans = A.pack_slice(4096 + off, d)
            assert len(plans) == d // 64
            for p, plan in enumerate(plans):
                assert plan == (4096 + 128 * p, 8 if off == 0 else 9, off, 128 * p)
    with pytest.raises(ValueError):
        A.pack_slice(4097, 64)
    with pytest.raises(ValueError):
        A.pack_slice(4096, 128)


@pytest.mark.parametrize("d", [1, 2, 3, 5, 8, 40, 77, 640, 2560, 2049, 12345, 2**20 + 7, 2**31 - 1])
def test_fast_division_is_exact(d):
    """The kernel's n / d as (umulhi(n, m) + n) >> l, for n < 2^31: the
    divisors of its shapes (S, H * D / 64) and others, at the edges and at
    random n."""
    m, l = A.pack_fast_div(d)
    assert 0 < m < 2**32
    rng = np.random.RandomState(d % 1000)
    ns = [0, 1, d - 1, d, d + 1, 2**31 - 1, 2**31 - d] + list(rng.randint(0, 2**31, size=2000))
    for n in ns:
        n = int(n)
        if 0 <= n < 2**31:
            t = (n * m) >> 32
            assert t < 2**32 and t + n < 2**32
            assert (t + n) >> l == n // d, (n, d)


def test_units_map_to_slices():
    """`pack_unit` walks the (b, s, h, unit) of a view in the contiguous
    copy's order, at both head dims."""
    for b, s, h, d in ((2, 7, 3, 64), (3, 5, 1, 512), (1, 2560, 5, 64), (2, 11, 2, 512)):
        p = d // 64
        got = [A.pack_unit(i, s, h, d) for i in range(b * s * h * p)]
        assert got == [(bi, si, hi, u) for bi in range(b) for si in range(s) for hi in range(h) for u in range(p)]


def test_lane_map():
    """A warp's lanes cover its 4 PACK_UNITS units x 8 chunks once each; in
    each of a lane's instructions the warp stores 4 consecutive units, 512
    contiguous bytes."""
    seen = np.zeros((4 * A.PACK_UNITS, 8), dtype=np.int64)
    for lane in range(32):
        for unit, c in A.pack_lane_units(lane):
            seen[unit, c] += 1
    assert (seen == 1).all()
    for u in range(A.PACK_UNITS):
        offsets = sorted(A.PACK_UNIT_BYTES * A.pack_lane_units(lane)[u][0] + 16 * A.pack_lane_units(lane)[u][1]
                         for lane in range(32))
        assert offsets == list(range(offsets[0], offsets[0] + 512, 16))
    with pytest.raises(ValueError):
        A.pack_lane_units(32)


@pytest.mark.parametrize("d", [64, 512])
def test_cpu_twin_is_contiguous_copy(d):
    """`pack_bshd` on a CPU tensor: contiguous(), its negation (each sign bit
    flipped) and zeros, bit for bit; no launch counted."""
    buf = torch.randn(2 * 5 * (3 * d + 1) + 1).to(torch.bfloat16)
    x = buf[1:].as_strided((2, 5, 3, d), (5 * (3 * d + 1), 3 * d + 1, d, 1))
    before = A.pack_bshd.launches
    bits = x.contiguous().view(torch.int16)
    for mode, want in (("as_is", bits), ("negated", bits ^ torch.tensor(-0x8000, dtype=torch.int16)),
                       ("zero", torch.zeros_like(bits))):
        got = A.pack_bshd(x, mode)
        assert got.is_contiguous() and got.shape == x.shape and got.dtype == x.dtype
        assert torch.equal(got.view(torch.int16), want), mode
    assert A.pack_bshd.launches == before


def test_kernel_raises_off_the_card():
    """No fallback: the kernel wrapper refuses a CPU tensor."""
    with pytest.raises(RuntimeError, match="no kernel for device"):
        A.pack_bshd_cuda(torch.zeros((1, 2, 1, 64), dtype=torch.bfloat16))


def test_kernel_constants_are_mirrored():
    """The pack kernel's threads, units a thread and modes, as the kernel
    has them; its C entry is declared."""
    src = open(os.path.join(cuda_lib.CSRC_DIR, "pack_bshd.cu")).read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kPackThreads"] == A.PACK_THREADS and const["kPackUnits"] == A.PACK_UNITS
    modes = dict(re.findall(r"kPack(AsIs|Negated|Zero) = (\d)", src))
    assert {"as_is": int(modes["AsIs"]), "negated": int(modes["Negated"]), "zero": int(modes["Zero"])} == A.PACK_MODES
    assert "128 * (j & ((1u << a.lp) - 1))" in src and A.PACK_UNIT_BYTES == 128
    assert "t2v_pack_bshd" in open(os.path.join(os.path.dirname(cuda_lib.__file__), "cuda_lib.py")).read()
