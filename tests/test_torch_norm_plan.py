"""The launch plans of the port's norm kernels (t2v_turbo_tpu_torch/ops/norms.py
`gn_plan`, `ln_plan`) and the GroupNorm kernel's summation order, on the CPU.

The kernels (csrc/norms.cu) run only on the card. What surrounds them is
checked here: every path shape's plan tiles each row exactly once in 16-byte
chunks within the card's shared memory and cluster limits and takes a
staged route; a numpy replay of the kernel's reduction order (per-thread f32
sums in the order the threads visit their vectors, xor-butterfly warp sums,
warps in order, blocks in rank order, each block's squares about its own
mean re-centred exactly) matches the JAX package's GroupNorm reference
(`_gn_ref`) and its fold (`_gn_affine_vectors`); the wrappers count nothing
off the card.

Tolerance: 1e-5 absolute, f32 on both sides: only the order of the f32 sums
(and the kernel's rsqrt, here exact) differs.
"""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one intra-op thread for the port's CPU tests)
from t2v_turbo_tpu.ops import fused_conv as jfc
from t2v_turbo_tpu.ops import fused_norms as jfn
from t2v_turbo_tpu_torch.apps.time_norms import GN_SHAPES, LN_F32_SHAPES, LN_SHAPES, STATS_SHAPES
from t2v_turbo_tpu_torch.ops import cuda_lib
from t2v_turbo_tpu_torch.ops import norms as N

ATOL = 1e-5
BF, F32 = torch.bfloat16, torch.float32
PATH_GN = [(shape, False) for shape in GN_SHAPES] + [(shape, True) for shape in STATS_SHAPES]


def _split(shape):
    return shape[0], shape[1], math.prod(shape[2:])


def _tiling(plan, l):
    """(start, length) of each of the k chunks of a row."""
    return [(r * plan.chunk, min(plan.chunk, l - r * plan.chunk)) for r in range(plan.k)]


def _check_staged_plan(plan, n, c, g, s, dtype, stats=False):
    e = dtype.itemsize
    ve = 16 // e
    rows_total, l = n * g, (c // g) * s
    assert plan.route == ("cta" if plan.k == 1 else "cluster")
    assert plan.k in (1, 2, 4, 8, 16) and plan.nonportable == (plan.k > N.GN_PORTABLE_CLUSTER)
    tiles = _tiling(plan, l)
    assert all(length > 0 for _, length in tiles) and sum(length for _, length in tiles) == l
    assert all(start * e % 16 == 0 and length * e % 16 == 0 for start, length in tiles)
    assert plan.chunk % ve == 0 and plan.staged % ve == 0 and 0 <= plan.staged <= plan.chunk
    if plan.staged == 0:  # holding nothing: the statistics mode, on a tensor L2 holds
        assert stats and n * c * s * e <= N.GN_STATS_L2
    if plan.rows > 1:
        assert plan.k == 1 and plan.staged == plan.chunk == l
    assert plan.smem == plan.rows * plan.staged * e + N.GN_STATIC_SMEM <= N.SMEM_BLOCK
    assert plan.threads % (32 * plan.rows) == 0 and 128 <= plan.threads <= N.GN_MAX_THREADS
    assert 1 <= plan.pieces and plan.rows * plan.pieces <= N.GN_MAX_BARS and plan.rows <= N.GN_MAX_ROWS
    assert plan.grid == -(-rows_total // plan.rows) * plan.k
    if 0 < plan.staged < plan.chunk:  # the re-read parts of the blocks an SM holds stay within the L2 budget
        per_sm = N.SMEM_SM // (plan.smem + 1024)
        assert N.SMS * per_sm * (plan.chunk - plan.staged) * e <= N.GN_L2_BUDGET


@pytest.mark.parametrize("shape,stats", PATH_GN, ids=lambda a: "x".join(map(str, a)) if isinstance(a, tuple) else
                         ("stats" if a else "apply"))
def test_gn_plan_tiles_every_path_row_on_a_staged_route(shape, stats):
    """Every bf16 path shape takes cta or cluster, or (B4's whole-clip rows,
    too few to fill the card) split; none the element-wise route."""
    n, c, s = _split(shape)
    plan = N.gn_plan(n, c, 32, s, BF, stats=stats)
    if plan.route == "split":
        _check_split_plan(plan, n, c, 32, s, BF)
        assert not stats and shape[0] == 1 and len(shape) == 5  # the whole-clip norms
        return
    assert plan.route in N.GN_STAGED, plan
    _check_staged_plan(plan, n, c, 32, s, BF, stats)


def _check_split_plan(plan, n, c, g, s, dtype):
    e = dtype.itemsize
    l = (c // g) * s
    first = N.GN_SPLIT_THREADS * 4 * 16 // e  # 4 vectors a thread; 2 only for a grid under 4 blocks an SM
    vecs = 4 if n * g * -(-l // first) >= N.GN_BLOCKS_PER_SM * N.SMS else 2
    assert plan.threads == N.GN_SPLIT_THREADS and plan.chunk * e == N.GN_SPLIT_THREADS * vecs * 16
    tiles = _tiling(plan, l)
    assert plan.k == -(-l // plan.chunk) and all(length > 0 for _, length in tiles)
    assert sum(length for _, length in tiles) == l and all(start * e % 16 == 0 for start, _ in tiles)
    assert plan.grid == n * g * plan.k and n * g < N.SMS and n * c * s * e <= N.GN_SPLIT_L2


@pytest.mark.parametrize("shape,dtype", [
    ((2, 320, 40, 64), F32), ((1, 128, 320, 512), F32), ((16, 512, 160, 256), F32), ((3, 96, 7, 8), BF),
    ((4096, 32, 8, 8), BF), ((1, 32, 1, 8), BF), ((5, 64, 1000, 8), BF), ((1, 2560, 16, 1024), BF),
    ((1, 256, 320, 512), F32),
], ids=str)
def test_gn_plan_odd_shapes(shape, dtype):
    n, c, s = _split(shape)
    plan = N.gn_plan(n, c, 32, s, dtype)
    if plan.route == "split":
        _check_split_plan(plan, n, c, 32, s, dtype)
    else:
        _check_staged_plan(plan, n, c, 32, s, dtype)


def test_gn_plan_routes_what_no_block_can_stage():
    # S not a multiple of the 16-byte vector, or a misaligned pointer: element-wise
    assert N.gn_plan(2, 64, 32, 35, BF).route == "elementwise"
    assert N.gn_plan(16, 320, 32, 2560, BF, aligned=False).route == "elementwise"
    # an f32 row of 5.2 MB is beyond 16 blocks' shared memory: 16 blocks each
    # hold all they may and re-read the rest of their chunk
    plan = N.gn_plan(1, 256, 32, 320 * 512, F32)
    assert (plan.route, plan.k) == ("cluster", 16) and plan.staged < plan.chunk
    assert plan.smem == N.SMEM_BLOCK and plan.chunk * 16 >= 8 * 320 * 512
    # tiny rows share a block
    plan = N.gn_plan(4096, 32, 32, 64, BF)
    assert plan.route == "cta" and plan.rows > 1


def test_gn_plan_holds_rows_whole_where_blocks_share_an_sm():
    """The UNet's per-frame rows stay whole in one block; the 2.6 MB VAE row
    takes 16 blocks, each holding part of its chunk and re-reading the rest."""
    plan = N.gn_plan(16, 320, 32, 40 * 64, BF)
    assert (plan.route, plan.staged) == ("cta", plan.chunk)
    plan = N.gn_plan(16, 256, 32, 320 * 512, BF)
    assert plan.k == 16 and plan.nonportable and plan.staged < plan.chunk


# ---- the kernel's summation order, replayed ---------------------------------

def _warp_sums(v):
    """The xor butterfly over each warp of 32 threads (every lane the same)."""
    v = v.reshape(-1, 32).copy()
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = (v + v[:, lanes ^ off]).astype(np.float32)
    return v[:, 0]


def _ordered_sum(values):
    total = np.float32(0.0)
    for x in values:
        total = np.float32(total + x)
    return total


def _fma(a, b, c):
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _sweep(vecs, v0, v1, tpr, visit):
    """visit(mask, vectors) in the order the threads' loops take them."""
    first = v0 + np.arange(tpr)
    for i in range(max(0, -(-(v1 - v0) // tpr))):
        idx = first + i * tpr
        mask = idx < v1
        visit(mask, vecs[np.minimum(idx, v1 - 1)])


def _block_partials(vecs, nst, plan):
    """One block's f32 (sum, sum of squares about its own mean) of its
    vectors (nvec, ve), in csrc/norms.cu gn_staged's order."""
    tpr = plan.threads // plan.rows
    nvec, ve = vecs.shape
    s = np.zeros(tpr, np.float32)

    def add(mask, rows):
        for i in range(ve):
            s[mask] = (s[mask] + rows[mask, i]).astype(np.float32)

    _sweep(vecs, nst, nvec, tpr, add)  # the re-read part first
    pvec = -(-nst // plan.pieces)
    for q in range(plan.pieces):
        if q * pvec < nst:
            _sweep(vecs, q * pvec, min((q + 1) * pvec, nst), tpr, add)
    total = _ordered_sum(_warp_sums(s))
    local_mean = np.float32(total / np.float32(nvec * ve))
    s2 = np.zeros(tpr, np.float32)

    def add_sq(mask, rows):
        for i in range(ve):
            d = (rows[mask, i] - local_mean).astype(np.float32)
            s2[mask] = [_fma(a, a, b) for a, b in zip(d, s2[mask])]

    _sweep(vecs, 0, nst, tpr, add_sq)
    _sweep(vecs, nst, nvec, tpr, add_sq)
    return total, _ordered_sum(_warp_sums(s2))


def _split_combine(parts, tiles, l):
    """The split route's second launch: lane i of a warp adds the partials
    i, i + 32, ... in order, then the xor butterfly; the mean, then the
    centred sum of squares."""
    def lanes(values):
        acc = np.zeros(32, np.float32)
        for q, v in enumerate(values):
            acc[q % 32] = np.float32(acc[q % 32] + v)
        return _warp_sums(acc)[0]

    mean = np.float32(lanes(p[0] for p in parts) / np.float32(l))
    terms = []
    for (sr, qr), (_, length) in zip(parts, tiles):
        nr = np.float32(length)
        dr = np.float32(np.float32(sr / nr) - mean)
        terms.append(_fma(np.float32(nr * dr), dr, qr))
    return mean, lanes(terms)


def _replay_stats(rows, plan, ve):
    """Per-row f32 (mean, rstd) of rows (R, L) as the kernel forms them (eps 1e-5)."""
    _, l = rows.shape
    out = []
    for row in rows:
        parts = []
        for start, length in _tiling(plan, l):
            vecs = row[start:start + length].reshape(-1, ve)
            parts.append(_block_partials(vecs, min(plan.staged // ve, len(vecs)), plan))
        if plan.route == "split":
            mean, s2 = _split_combine(parts, _tiling(plan, l), l)
        elif plan.k == 1:
            mean, s2 = np.float32(parts[0][0] / np.float32(l)), parts[0][1]
        else:
            mean = np.float32(_ordered_sum(p[0] for p in parts) / np.float32(l))
            terms = []
            for (sr, qr), (_, length) in zip(parts, _tiling(plan, l)):
                nr = np.float32(length)
                dr = np.float32(np.float32(sr / nr) - mean)
                terms.append(_fma(np.float32(nr * dr), dr, qr))
            s2 = _ordered_sum(terms)
        out.append((mean, np.float32(1.0 / np.sqrt(np.float64(np.float32(s2 / np.float32(l)) + np.float32(1e-5))))))
    return np.array(out, np.float32)


def _bf16_inputs(n, c, s, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((3.0 * rng.randn(n, c, s) + 1.0).astype(np.float32)).bfloat16().float().numpy()
    return x, (1.0 + 0.1 * rng.randn(c)).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)


# Each variant: (n, c, s) and the plan made of gn_plan's there. The split
# route's first launch visits its chunk as a block of its threads holding
# nothing (each thread its vectors t, t + threads, ... in order): the same
# order as a staged block with nothing held.
REPLAY_PLANS = {
    "cta": lambda p: p,
    "split": lambda p: N.split_plan(32, 10240, 2),
    "cluster_nothing_held": lambda p: p._replace(route="cluster", k=2, chunk=2560, staged=0, threads=256, pieces=1),
    "cta_rows": lambda p: p._replace(rows=4, threads=128, pieces=2),
    "cluster_reread": lambda p: p._replace(route="cluster", k=4, chunk=1280, staged=512, threads=128, pieces=3),
    "cluster_ragged": lambda p: p._replace(route="cluster", k=3, chunk=1712, staged=1712, threads=256, pieces=2),
}


@pytest.mark.parametrize("variant", REPLAY_PLANS)
def test_replayed_reduction_matches_jax_group_norm(variant):
    # rows of 5,120 elements; for split 10,240 (two chunks, the second ragged)
    n, c, s = (1, 64, 5120) if variant == "split" else (2, 64, 2560)
    plan = REPLAY_PLANS[variant](N.gn_plan(n, c, 32, s, BF))
    if variant == "split":
        assert (plan.k, plan.chunk, plan.staged) == (2, 8192, 0)
    x, w, b = _bf16_inputs(n, c, s, 0)
    stats = _replay_stats(x.reshape(n * 32, -1), plan, 8)
    mean, rstd = (stats[:, i].reshape(n, 32, 1, 1) for i in (0, 1))
    xg = x.reshape(n, 32, c // 32, s)
    y = (xg - mean) * (rstd * w.reshape(1, 32, -1, 1)) + b.reshape(1, 32, -1, 1)
    y = (y / (1.0 + np.exp(-y))).reshape(n, c, s)
    ref = np.asarray(jfn._gn_ref(jnp.asarray(np.swapaxes(x, 1, 2)), w, b, 32, 1e-5, "silu"))
    np.testing.assert_allclose(np.swapaxes(y, 1, 2), ref, atol=ATOL)


def test_replayed_fold_matches_jax_affine_vectors():
    """The statistics mode: the replayed statistics folded as the kernel
    folds them, against JAX `_gn_affine_vectors` (FiLM on)."""
    n, c, s = 2, 64, 2560
    plan = REPLAY_PLANS["cluster_reread"](N.gn_plan(n, c, 32, s, BF))
    x, w, b = _bf16_inputs(n, c, s, 1)
    rng = np.random.RandomState(2)
    fs, fh = (0.1 * rng.randn(n, c)).astype(np.float32), (0.1 * rng.randn(n, c)).astype(np.float32)
    stats = _replay_stats(x.reshape(n * 32, -1), plan, 8)
    mean, rstd = (np.repeat(stats[:, i].reshape(n, 32), c // 32, axis=1) for i in (0, 1))
    a = rstd * w
    bb = (b - mean * a) * (1.0 + fs) + fh
    a = a * (1.0 + fs)
    ra, rb = jfc._gn_affine_vectors(jnp.asarray(np.swapaxes(x, 1, 2).reshape(n, 1, s, c)), w, b, 32, 1e-5, fs, fh)
    np.testing.assert_allclose(a, np.asarray(ra), atol=ATOL)
    np.testing.assert_allclose(bb, np.asarray(rb), atol=ATOL)


# ---- LayerNorm --------------------------------------------------------------

# (C, dtype) -> (lanes a row, 16-byte vectors a lane) at the paths' rows
LN_LANES = {(320, BF): (8, 5), (512, BF): (16, 4), (640, BF): (32, 3), (1280, BF): (32, 5), (1024, BF): (32, 4),
            (768, BF): (32, 3), (1280, F32): (32, 10)}


@pytest.mark.parametrize("rows,c,dtype", [(r, c, BF) for r, c in LN_SHAPES] + [(r, c, F32) for r, c in LN_F32_SHAPES],
                         ids=str)
def test_ln_plan_holds_each_row_in_whole_vectors(rows, c, dtype):
    plan = N.ln_plan(rows, c, dtype)
    v = c * dtype.itemsize // 16
    assert plan.route == "vector"
    assert (plan.lanes, plan.vecs) == LN_LANES[(c, dtype)]
    assert plan.lanes * (plan.vecs - 1) < v <= plan.lanes * plan.vecs and plan.vecs <= N.LN_MAX_VECS
    assert plan.rows_per_block == N.LN_THREADS // 32 * (32 // plan.lanes)
    assert plan.grid * plan.rows_per_block >= rows > (plan.grid - 1) * plan.rows_per_block


def test_ln_plan_routes_the_rest_element_wise():
    assert N.ln_plan(300, 100, BF).route == "elementwise"  # not whole vectors
    assert N.ln_plan(300, 320, BF, aligned=False).route == "elementwise"
    assert N.ln_plan(8, 8192, BF).route == "elementwise"  # more than 32 lanes x 10 vectors
    plan = N.ln_plan(10, 360, BF)  # 45 vectors: 32 lanes, the last masked
    assert (plan.route, plan.lanes, plan.vecs) == ("vector", 32, 2)
    # a whole number of vectors a lane where the rows fill the card: 8 lanes of 5
    assert (N.ln_plan(40960, 320, BF).lanes, N.ln_plan(40960, 320, BF).vecs) == (8, 5)
    assert N.ln_plan(10240, 640, BF).lanes == 32  # fewer rows: more lanes a row


# ---- the wrappers and the C side --------------------------------------------

def test_wrappers_count_nothing_off_the_card():
    counters = (N.fused_group_norm, N.group_norm_affine_cuda, N.fused_layer_norm)
    before = [(f.launches, dict(f.by_route), dict(f.by_shape)) for f in counters]
    x = torch.randn(2, 64, 4, 4)
    N.group_norm(x, torch.ones(64), torch.zeros(64), act="silu")
    N.layer_norm(x, torch.ones(4), torch.zeros(4))
    with pytest.raises(RuntimeError, match="no kernel"):
        N.group_norm_affine_cuda(x, torch.ones(64), torch.zeros(64))
    assert [(f.launches, dict(f.by_route), dict(f.by_shape)) for f in counters] == before


def test_kernel_limits_are_mirrored():
    """The plan's limits equal the kernel's constants."""
    src = open(os.path.join(cuda_lib.CSRC_DIR, "norms.cu")).read()
    const = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kGnMaxThreads"] == N.GN_MAX_THREADS
    assert const["kGnMaxBars"] == N.GN_MAX_BARS
    assert const["kGnMaxRows"] == N.GN_MAX_ROWS
    assert const["kGnMaxCluster"] == N.GN_MAX_CLUSTER
    assert const["kSmemBlock"] == N.SMEM_BLOCK
    assert const["kGnStaticSmem"] == N.GN_STATIC_SMEM
    assert const["kLnVecThreads"] == N.LN_THREADS
    assert const["kLnMaxVecs"] == N.LN_MAX_VECS
    assert const["kSplitThreads"] == N.GN_SPLIT_THREADS
    assert (const["kSplitMinVecs"], const["kSplitMaxVecs"]) == N.GN_SPLIT_VECS
    routes = dict(re.findall(r"kGn(Cta|Cluster|Split|Elementwise) = (\d)", src))
    assert {k.lower(): int(v) for k, v in routes.items()} == N.GN_ROUTES
