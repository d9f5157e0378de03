"""The staged flash forward's row loads (t2v_turbo_tpu_torch/ops/attention.py
`staged_row`, mirroring the producer warp of csrc/flash_attention_sm90.cu),
on the CPU.

The kernel runs only on the card. Its addressing is checked here: a numpy
replay of `staged_row` over (B, S, H, 64) bf16 views that TMA cannot read
(all 8 even byte offsets of a row, odd row and head strides, a ragged S
whose last tile has zero rows) rebuilds, byte for byte, the 64 x 64 tile
that a TMA box with the 128-byte swizzle holds. The box is defined here on
its own, from the swizzle's address bits, not from `staged_row`. The
aligned chunks a row reads never leave the 16-byte granules its bytes lie
in. The producer warpgroup's lane map (`staged_lane_rows`) writes every
16-byte chunk of a tile once, and the 4 rows one warp instruction takes
share their shift and their swizzle row. The kernel's constants are
mirrored.

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


def _tma_box(rows):
    """The 64 x 128-byte tile a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
    writes for up to 64 rows of 128 bytes (rows past them zero-filled):
    byte b of row r at linear offset r * 128 + b, whose bits [4, 7) are
    XORed with bits [7, 10)."""
    box = np.zeros(64 * 128, dtype=np.uint8)
    for r, row in enumerate(rows):
        lin = r * 128 + np.arange(128)
        box[lin ^ (((lin >> 7) & 7) << 4)] = row
    return box


def _replay(mem, base, rows):
    """The tile the producer builds from slices at byte addresses `rows`
    (relative to `base`, the address of mem[0]) by `staged_row`: the
    aligned chunks read, bytes [shift, shift + 128) kept, each 16-byte
    output chunk stored at its destination; rows past the slices zero.
    Also asserts that no read leaves the 16-byte granules of the memory."""
    tile = np.zeros(64 * 128, dtype=np.uint8)
    end = -(-len(mem) // 16) * 16  # the last granule's end
    for r, addr in enumerate(rows):
        plan = A.staged_row(base + addr, r)
        lo = plan.start - base
        assert plan.start % 16 == 0
        assert 0 <= lo and lo + 16 * plan.chunks <= end
        raw = np.zeros(16 * plan.chunks, dtype=np.uint8)
        got = mem[lo:lo + 16 * plan.chunks]
        raw[:len(got)] = got
        row = raw[plan.shift:plan.shift + A.STAGED_ROW_BYTES]
        assert len(row) == 128
        for c, dst in enumerate(plan.dest):
            tile[dst:dst + 16] = row[16 * c:16 * c + 16]
    return tile


def _views():
    """(label, buffer, view) for (2, 100, 3, 64) bf16 views: every even byte
    offset (element offset 0..7) with an odd row stride (3 * 64 + 1 elements)
    and with an aligned one, and an odd head stride (65 elements)."""
    g = torch.Generator().manual_seed(0)
    b, s, h = 2, 100, 3
    out = []
    for off in range(8):
        for row_stride, head_stride in ((h * 64 + 1, 64), (h * 64, 64), (h * 65 + 3, 65)):
            n = off + (b - 1) * s * row_stride + (s - 1) * row_stride + (h - 1) * head_stride + 64
            buf = torch.randn(n, generator=g).to(torch.bfloat16)
            view = buf.as_strided((b, s, h, 64), (s * row_stride, row_stride, head_stride, 1), off)
            out.append((f"offset {2 * off} B, row stride {row_stride}, head stride {head_stride}", buf, view))
    return out


def _bytes(t):
    return t.contiguous().view(torch.int16).numpy().view(np.uint8)


@pytest.mark.parametrize("label, buf, view", _views(), ids=lambda x: x if isinstance(x, str) else "")
def test_replay_rebuilds_the_tma_box(label, buf, view):
    """Every 64-row tile of every (batch, head) of the view: the replay of
    `staged_row` gives the TMA box's bytes, zero rows past S included
    (S = 100: the second tile holds 36 rows)."""
    mem = _bytes(buf)
    base = buf.data_ptr()
    assert base % 16 == 0  # an allocation: the granules of mem start at mem[0]
    e = view.element_size()
    b, s, h, _ = view.shape
    for bi in range(b):
        for hi in range(h):
            for j in range(0, s, 64):
                rows = range(j, min(j + 64, s))
                addrs = [(view.storage_offset() + bi * view.stride(0) + r * view.stride(1) + hi * view.stride(2)) * e
                         for r in rows]
                want = _tma_box([_bytes(view[bi, r, hi]) for r in rows])
                np.testing.assert_array_equal(_replay(mem, base, addrs), want, err_msg=f"{label} b{bi} h{hi} tile {j}")


def test_shifts_and_chunks():
    """All 8 even offsets: 8 chunks read at offset 0, 9 otherwise, the
    shift being the offset; odd addresses are refused (bf16)."""
    for off in range(0, 16, 2):
        plan = A.staged_row(4096 + off, 0)
        assert plan.start == 4096 and plan.shift == off and plan.chunks == (8 if off == 0 else 9)
    with pytest.raises(ValueError):
        A.staged_row(4097, 0)


def test_destinations_are_a_permutation():
    """The 64 rows' 8 output chunks fill the 8 KB tile once each, and row r
    keeps its own 128 bytes."""
    dests = [d for r in range(64) for d in A.staged_row(0, r).dest]
    assert sorted(dests) == list(range(0, 64 * 128, 16))
    assert all(r * 128 <= d < (r + 1) * 128 for r in range(64) for d in A.staged_row(0, r).dest)


def test_lane_map_writes_each_chunk_once():
    """The producer warpgroup's lanes: each (tile row, output chunk) of the
    64 x 8 once, at `staged_row`'s destination; replayed with the tile of a
    misaligned row layout, it rebuilds the TMA box."""
    seen = np.zeros((64, 8), dtype=np.int64)
    for w in range(A.STAGED_PRODUCER_WARPS):
        for lane in range(32):
            for row, chunk in A.staged_lane_rows(w, lane):
                seen[row, chunk] += 1
    assert (seen == 1).all()
    rng = np.random.RandomState(0)
    mem = rng.randint(0, 256, size=64 * 642 + 64, dtype=np.uint8)
    tile = np.zeros(64 * 128, dtype=np.uint8)
    for w in range(A.STAGED_PRODUCER_WARPS):
        for lane in range(32):
            for row, chunk in A.staged_lane_rows(w, lane):
                plan = A.staged_row(2 + 642 * row, row)
                raw = mem[plan.start:plan.start + 16 * plan.chunks]
                tile[plan.dest[chunk]:plan.dest[chunk] + 16] = raw[plan.shift + 16 * chunk:plan.shift + 16 * chunk + 16]
    want = _tma_box([mem[2 + 642 * r:2 + 642 * r + 128] for r in range(64)])
    np.testing.assert_array_equal(tile, want)


def test_warp_instructions_share_shift_and_swizzle():
    """One warp instruction takes lanes 8 k + c of one group u: rows r0 + 8 k
    + 32 h. At every even offset and odd stride, their 4 rows share the
    shift (the word select and funnel shift are uniform) and r % 8 (the
    swizzle row)."""
    for w in range(A.STAGED_PRODUCER_WARPS):
        for u in range(4):
            rows = [A.staged_lane_rows(w, 8 * k)[u][0] for k in range(4)]
            assert len({r % 8 for r in rows}) == 1
            for base in range(0, 16, 2):
                for stride in (65, 193, 321):
                    assert len({A.staged_row(base + 2 * stride * r, r).shift for r in rows}) == 1
    with pytest.raises(ValueError):
        A.staged_lane_rows(A.STAGED_PRODUCER_WARPS, 0)


@pytest.mark.parametrize("stride", [1, 3, 64, 65, 193, 321, 1283])
def test_realign_rows_share_shift_and_swizzle(stride):
    """One realigning instruction takes rows r0 + 8 k (k = 0..3) of a unit:
    for any element stride their shifts are equal (8 rows are 16 * stride
    bytes apart) and so is r % 8, so the kernel's word select and swizzle
    are uniform across the warp."""
    for base in range(0, 16, 2):
        for r0 in range(8):
            plans = [A.staged_row(base + 2 * stride * (r0 + 8 * k), r0 + 8 * k) for k in range(4)]
            assert len({p.shift for p in plans}) == 1
            assert len({(p.dest[0] % 128) for p in plans}) == 1


def test_kernel_constants_are_mirrored():
    """The staged producer's warps and the route codes, as the kernel has
    them; two blocks of a consumer and a producer warpgroup fit an SM's
    registers at 128 a thread and its shared memory."""
    src = open(os.path.join(cuda_lib.CSRC_DIR, "flash_attention_sm90.cu")).read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kStagedProducerWarps"] == A.STAGED_PRODUCER_WARPS
    assert const["kStagedBlocksPerSM"] == 2
    routes = open(os.path.join(cuda_lib.CSRC_DIR, "flash_mma.cuh")).read()
    codes = dict(re.findall(r"kRoute(\w+) = (\d)", routes))
    assert {k.lower(): int(v) for k, v in codes.items()} == A.ROUTES
    threads = 128 + 32 * A.STAGED_PRODUCER_WARPS
    assert 2 * threads * 128 <= 65536
    alloc = (1 + 3 * 2) * 64 * 128 + 8 * 7 + 1024  # the Q tile, three stages of K and V, barriers
    assert 2 * (alloc + 1024) <= 233472  # 228 KB an SM, 1 KB reserved a block
