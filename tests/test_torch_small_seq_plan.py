"""The launch plan of the port's short-sequence attention kernel (B8:
t2v_turbo_tpu_torch/ops/attention.py `ss_plan`), on the CPU.

The kernel (csrc/small_seq_attention.cu) runs only on the card. What
surrounds it is checked here: at every path shape and at T in {1, 13, 16,
48, 64}, H in {1, 5, 8, 10, 20}, in both dtypes, aligned and not, the
plan's blocks and warps cover every (row, head, 16-query tile) exactly
once (a replay of the kernel's map of blocks to items and warps to units), its
shared memory fits a block with each tensor's stage sized to the item's
rows (16 * ceil(T / 16) in bf16, T in f32; never 64 for T <= 48), every
aligned path shape takes the bulk route and a misaligned view the
element-wise route; a numpy replay of the bulk copies' addressing stages
each item's q, k and v where the kernel reads them; the kernel's limits
are mirrored; the wrapper counts nothing off the card.

No tolerance: plans are integers, and the staging replay copies exactly.
"""

import os
import re

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu_torch.apps.time_small_seq import F32_SHAPES, SHAPES
from t2v_turbo_tpu_torch.ops import attention as A
from t2v_turbo_tpu_torch.ops import cuda_lib

BF, F32 = torch.bfloat16, torch.float32
PATH = [(shape, BF) for shape, _, _ in SHAPES] + [(shape, F32) for shape, _, _ in F32_SHAPES]
GRID = [(t, h) for t in (1, 13, 16, 48, 64) for h in (1, 5, 8, 10, 20)]


def _coverage(plan, r, t, h):
    """(r, h, ceil(T / 16)) counts of the units the kernel computes: block b
    takes item b -> (row, head group); warp w of a block takes unit w ->
    (head w // ceil(T / 16) of the group, query tile w % ceil(T / 16))."""
    kt = -(-t // 16)
    groups = h // plan.heads
    counts = np.zeros((r, h, kt), dtype=np.int64)
    for item in range(plan.grid):
        row, h0 = item // groups, (item % groups) * plan.heads
        for w in range(plan.threads // 32):
            counts[row, h0 + w // kt, w % kt] += 1
    return counts


def _check_plan(plan, r, t, h, dtype, route):
    kt = -(-t // 16)
    e = dtype.itemsize
    assert plan.route == route
    assert h % plan.heads == 0 and plan.grid == r * (h // plan.heads)
    assert plan.rows == (16 * kt if dtype == BF else t) and (t > 48 or plan.rows < 64)
    assert plan.pitch == plan.heads * 64 + A.SS_PAD[dtype]
    assert plan.pitch * e % 16 == 0 and plan.rows * plan.pitch * e % 16 == 0  # bulk copies land 16-byte aligned
    if dtype == BF:  # 8 consecutive staged rows: 8 distinct 16-byte bank groups for ldmatrix
        assert plan.pitch * e % 128 == 16
    assert plan.smem == 3 * plan.rows * plan.pitch * e <= 232448
    assert plan.threads == 32 * plan.heads * kt <= A.SS_MAX_THREADS
    assert (_coverage(plan, r, t, h) == 1).all()


@pytest.mark.parametrize("shape,dtype", PATH, ids=lambda a: "x".join(map(str, a)) if isinstance(a, tuple) else str(a))
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_ss_plan_covers_every_path_item_once(shape, dtype, aligned):
    """Every path shape: the bulk route when aligned, element-wise when not;
    a block an item of at most SS_WARPS warps (or one head's query tiles);
    every (row, head, query tile) once."""
    r, t, h = shape
    plan = A.ss_plan(r, t, h, dtype, aligned)
    _check_plan(plan, r, t, h, dtype, "bulk" if aligned else "elementwise")
    assert plan.threads <= 32 * max(A.SS_WARPS, -(-t // 16))


@pytest.mark.parametrize("t,h", GRID, ids=[f"T{t}_H{h}" for t, h in GRID])
@pytest.mark.parametrize("dtype", [BF, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_ss_plan_grid(t, h, dtype, aligned):
    """T in {1, 13, 16, 48, 64}, H in {1, 5, 8, 10, 20}: the plan, and on
    its route every head group a block holds, cover every (row, head, query
    tile) once within a block's shared memory; a group of more units than a
    block has warps is refused."""
    r = 7
    route = "bulk" if aligned else "elementwise"
    _check_plan(A.ss_plan(r, t, h, dtype, aligned), r, t, h, dtype, route)
    for heads in (d for d in range(1, h + 1) if h % d == 0):
        if 32 * heads * -(-t // 16) > A.SS_MAX_THREADS:
            with pytest.raises(ValueError):
                A.ss_layout(r, t, h, dtype, route, heads)
            continue
        _check_plan(A.ss_layout(r, t, h, dtype, route, heads), r, t, h, dtype, route)


def test_ss_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError):  # not a divisor of the heads
        A.ss_layout(4, 16, 5, BF, "bulk", 3)
    with pytest.raises(ValueError):  # 5 heads of one query tile: 5 warps, more than a block has
        A.ss_layout(4, 16, 5, BF, "bulk", 5)
    with pytest.raises(ValueError):
        A.ss_layout(4, 16, 5, BF, "stream", 1)
    with pytest.raises(ValueError):
        A.ss_plan(4, 65, 5)
    with pytest.raises(TypeError):
        A.ss_plan(4, 16, 5, torch.float16)


def _bits(t):
    """A tensor's whole storage as numpy integers of its element size."""
    flat = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
    return flat.view(torch.int16 if t.element_size() == 2 else torch.int32).numpy()


def _stage_replay(plan, q, k, v, item):
    """The staged item as the kernel's bulk copies lay it out: tensor x,
    staged row t at x * tile + t * pitch, from element r*st0 + t*st1 +
    h0*st2 of x's storage, heads * 64 elements a copy; -1 where no copy
    writes."""
    tile = plan.rows * plan.pitch
    t_, h = q.shape[1:3]
    stage = np.full(3 * tile, -1, dtype=_bits(q).dtype)
    groups = h // plan.heads
    row, h0 = item // groups, (item % groups) * plan.heads
    piece = plan.heads * 64
    for x, ten in enumerate((q, k, v)):
        src, st = _bits(ten), ten.stride()
        base = ten.storage_offset() + row * st[0] + h0 * st[2]
        for t in range(t_):
            off = base + t * st[1]
            stage[x * tile + t * plan.pitch:][:piece] = src[off:off + piece]
    return stage, row, h0


@pytest.mark.parametrize("r,t,h,dtype,heads", [(6, 16, 5, BF, None), (4, 13, 8, BF, 2), (3, 40, 20, BF, None),
                                               (5, 16, 8, BF, 4), (6, 16, 5, F32, None), (2, 13, 10, F32, 2)],
                         ids=["L0_rows", "ragged_group", "mid_self", "four_heads", "f32_rows", "f32_ragged_group"])
def test_bulk_copies_stage_what_the_units_read(r, t, h, dtype, heads):
    """Replay of the bulk route's copies on views of (R, T, H*64) Linear
    outputs: the unit (head hh, all queries) reads q/k/v[row, t, h0 + hh, :]
    at x * tile + t * pitch + hh * 64 + d, for every item."""
    g = torch.Generator().manual_seed(r + t)
    q, k, v = (torch.randn((r, t, h * 64), generator=g).to(dtype).view(r, t, h, 64) for _ in range(3))
    assert A.ss_readable(q, k, v)
    plan = A.ss_plan(r, t, h, dtype) if heads is None else A.ss_layout(r, t, h, dtype, "bulk", heads)
    tile = plan.rows * plan.pitch
    for item in range(plan.grid):
        stage, row, h0 = _stage_replay(plan, q, k, v, item)
        for x, ten in enumerate((q, k, v)):
            want = _bits(ten.contiguous()).reshape(ten.shape)
            for hh in range(plan.heads):
                got = np.stack([stage[x * tile + tt * plan.pitch + hh * 64:][:64] for tt in range(t)])
                np.testing.assert_array_equal(got, want[row, :, h0 + hh])


def test_ss_readable():
    """Bulk copies read 16-byte aligned bases with strides of whole 16-byte
    pieces: the Linear outputs' views, not a view one element in."""
    for dtype in (BF, F32):
        x = torch.zeros(4, 16, 5 * 64 + 1, dtype=dtype)
        assert A.ss_readable(x[..., :320].view(4, 16, 5, 64)) == (x.stride(1) * x.element_size() % 16 == 0)
        assert not A.ss_readable(x[..., 1:].view(4, 16, 5, 64))
        y = torch.zeros(4, 16, 5 * 64, dtype=dtype)
        assert A.ss_readable(y.view(4, 16, 5, 64), y.view(4, 16, 5, 64))


def test_kernel_limits_are_mirrored():
    """The plan's limits equal the kernel's constants; the shared memory
    the kernel allows a block is the most any launch asks for."""
    src = open(os.path.join(cuda_lib.CSRC_DIR, "small_seq_attention.cu")).read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kSsPadBf16"] == A.SS_PAD[BF] and A.SS_PAD[F32] == 0
    assert const["kSsMaxThreads"] == A.SS_MAX_THREADS
    assert const["kSsMaxT"] == A.SMALL_SEQ_MAX and const["kSsD"] == A.SMALL_SEQ_HEAD_DIM
    routes = dict(re.findall(r"kSs(Bulk|Elementwise) = (\d)", src))
    assert {k.lower(): int(v) for k, v in routes.items()} == A.SS_ROUTES
    most = max(A.ss_layout(1, t, 4, dtype, "bulk", heads).smem for t in range(1, A.SMALL_SEQ_MAX + 1)
               for dtype in (BF, F32) for heads in (1, 2, 4) if 32 * heads * -(-t // 16) <= A.SS_MAX_THREADS)
    assert const["kSsMaxSmem"] == most


def test_wrapper_counts_nothing_off_the_card():
    """A CPU tensor runs the plain twin and counts no launch; the kernel
    wrapper itself refuses a CPU tensor."""
    w = A.small_seq_attention
    before = (w.launches, dict(w.by_route), dict(w.by_shape))
    q = torch.randn(2, 16, 5, 64)
    np.testing.assert_array_equal(A.small_seq_attention(q, q, q).numpy(), A.attention(q, q, q).numpy())
    assert (w.launches, dict(w.by_route), dict(w.by_shape)) == before
    with pytest.raises(RuntimeError, match="no kernel"):
        A.small_seq_attention_cuda(q, q, q)
