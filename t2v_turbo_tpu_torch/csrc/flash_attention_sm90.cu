// Flash attention in bf16 for Hopper (sm_90a): the forward and the backward
// at head dims 64 and 512, on wgmma products fed by TMA. The `wgmma` route of
// flash_attention.cu's and flash_attention_bwd.cu's entry points. Its `staged`
// route: the head-dim-64 forward on views TMA cannot read, and at scales <= 0,
// the same consumers fed by a producer warpgroup that realigns each row in
// registers (below). The other bf16 views TMA cannot read (the backward at
// both head dims, the forward at D = 512, also at scales <= 0) take the
// `packed` route: the wrapper packs them into contiguous copies
// (pack_bshd.cu) and launches these kernels unchanged. f32 takes those
// files' scalar kernels.
//
// Replaces the Pallas TPU kernels of t2v_turbo_tpu/ops/attention.py at head
// dim 64, and through their (batch, seq, head) strides the BSHD family's
// counterparts (B6: _flash_fwd_kernel_bshd(_lse), _flash_bwd_dkv_kernel_bshd,
// _flash_bwd_dq_kernel_bshd):
// - forward: _flash_fwd_kernel (implementation _flash_attention_fwd_impl;
//   "B1") and _flash_fwd_kernel_lse (_flash_attention_fwd_lse_impl; "B2"):
//   o = softmax(s) v with s = q_i . k_j * scale, an online softmax (running
//   max m, sum l, f32 accumulator), keys past Sk masked, P rounded to bf16
//   before P V, and for B2 lse = m + log(l) per row in f32;
// - backward: _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel
//   (_flash_attention_bwd_impl; "B3"), with delta_i = dO_i . O_i:
//     P = exp(s - lse_i);  dV = P^T dO;  dS = P (dO V^T - delta);
//     dK = scale dS^T Q;   dQ = scale dS K;   P = 0 past Sq or Sk.
//
// Bounds on the H100 (989 TFLOP/s bf16, 3.35 TB/s, 16 exp2 a cycle an SM):
// - The forward does 2 products of 2 B H Sq Sk 64 operations (Q K^T, P V).
//   At the UNet's level 0 (16 x 5 heads x 2560 x 2560) the operations bound
//   it: 0.136 ms, against 0.016 ms for its bytes (q, k, v read once, o
//   written once). At head dim 64 its exp2 (one a logit) takes the special
//   function units about as long as the products take the tensor cores, so
//   the two must overlap. The design: both products on wgmma; exp2 of one
//   fused multiply-add a logit; three blocks of one consumer warpgroup an
//   SM, whose softmax and products interleave.
// - With the cross-attention's 77 keys the bytes bound the forward (q read
//   and o written once: 0.016 ms at level 0). The design: q is read once
//   by TMA; the head's two K/V tiles stream through a three-stage ring, so
//   both are in flight at once and stay in L2 for the head's other query
//   tiles.
// - The backward does 7 such products (the logits and dP in each of its two
//   kernels, then dV and dK, and dQ); the operations bound it.
// - At the VAE's one head of 512 (16 x 2560 x 2560) the forward's operations
//   bound it at 0.217 ms. Each of a head's 40 query tiles reads the head's K
//   and V (5.2 MB) from L2, 3.4 GB a call, which L2's rate may make the
//   real floor. Its kernel and design are under "forward at head dim 512";
//   the backward's, which cannot keep the D = 64 design's two accumulators a
//   block, under "backward at head dim 512".
//
// Design at head dim 64. Every kernel is one block of a consumer warpgroup
// owning 64 rows of one side of one (batch, head), loaded once by TMA, and one
// producer warp that streams the other side's 64-row tiles through a ring
// (`Ring`).
//   forward: owns Q; streams K, V:
//            S = Q K^T, online softmax, O = O * alpha + P V.
//   dK/dV:   owns K, V; streams Q, dO (and lse, delta rows):
//            S^T = K Q^T, dP^T = V dO^T; dV += P^T dO, dK += dS^T Q.
//   dQ:      owns Q, dO (lse, delta in registers); streams K, V:
//            S = Q K^T, dP = dO V^T; dQ += dS K.
// - Products on wgmma m64n64k16 (bf16 in, f32 accumulate). The logit
//   products read both operands from shared memory (own tile A, streamed
//   tile a K-major B); P and dS are rounded to bf16 in registers and become
//   the A operand of the second products, whose B is a streamed tile read
//   MN-major (sm90.cuh).
// - Loads by TMA: one 4-D tensor map per tensor over (D, H, S, B) with the
//   tensor's own strides and a (64, 1, 64, 1) box, 128-byte swizzled. Rows
//   past S are zero-filled by the hardware, so ragged S needs no masked
//   loads; keys past Sk are masked on the last key tile (P = 0: the
//   reference's mask value times log2(e) would overflow, so the masked
//   logits are set to -inf, which leaves the running max finite). The
//   producer fills a ring of stages (the two streamed tiles, 16 KB, plus
//   for dK/dV the stage's lse and delta rows), each with a full and an
//   empty mbarrier; the consumers wait on full and release empty, so the
//   next tiles load while this one is multiplied. The forward's loop holds
//   tile j - 1's V while it reads K_j, so its ring has three stages.
// - Grid: x = the own side's tiles of one (batch, head), y = batch * head,
//   so the blocks that stream one head's K/V (655 KB at level 0) are
//   neighbours in launch order and find them in L2.
// - Block shapes, measured (PERF.md): one consumer warpgroup (160 threads)
//   a block, 2 (dK/dV, ~164 registers a thread) or 3 (dQ, forward) blocks
//   an SM. Two warpgroups a block were slower at every shape: for the
//   backward with setmaxnreg; for the forward over 128 query rows sharing
//   one K/V stream (half the L2 -> shared traffic), also with the two
//   warpgroups taking turns to issue their products (FlashAttention-3's
//   ping-pong). For the forward a two-stage ring was slower, and waiting
//   for the logits alone, so that a tile's softmax overlaps the previous
//   tile's P V, no faster.
// - Softmax in the exp2 domain: log2(e) is folded into the scale (and into
//   the backward's lse), so P = exp2 of one fused multiply-add; the forward
//   rescales its accumulator by exp2((m_old - m_new) * scale * log2(e)) and
//   writes lse back in natural-log units, as the backward reads it. The
//   forward's running max is over the raw logits, so it takes scale > 0
//   only (the staged route maps any other scale onto a positive one); the
//   backward takes any scale.
// Deterministic: no atomics; every output row is written once, by the one
// thread that accumulated it over the streamed tiles in a fixed order.
#include "flash_mma.cuh"  // rows_aligned16, quad_sum
#include "sm90.cuh"

namespace t2v {

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBwdStages = 2;  // 3 measured no faster, 4 slower for dQ
constexpr int kFwdStages = 3;  // tile j - 1's V is held while K_j is read; 2 measured slower
constexpr int kThreads = 160;   // a consumer warpgroup, then the producer warp

// The streamed side's ring: STAGES stages of two 64 x 64 tiles, each with a
// full barrier (the producer warp's 32 lanes arrive, and TMA's bytes complete
// it) and an empty barrier (every consumer thread arrives once it is done).
template <int STAGES>
struct Ring {
  unsigned char* tiles;  // [STAGES][2] tiles, 1024-byte aligned
  uint64_t* full;        // [STAGES]
  uint64_t* empty;       // [STAGES]

  __device__ unsigned char* tile(int s, int i) const { return tiles + (2 * s + i) * kTileBytes; }

  // One thread, before mbar_fence_init and the block barrier.
  __device__ void init(int consumers, int producers = 32) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], producers);
      mbar_init(&empty[s], consumers);
    }
  }

  // The producer warp: n pairs, pair j the rows [64 j, 64 j + 64) of m1 and
  // m2 at head h of batch b. fill(j, s, lane) runs on every lane before it
  // marks stage s full: per-stage data the consumers read with the tiles.
  template <typename Fill>
  __device__ void produce(const CUtensorMap* m1, const CUtensorMap* m2, int h, int b, int n,
                          Fill fill) const {
    const int lane = threadIdx.x % 32;
    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      fill(j, s, lane);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(tile(s, 0), m1, &full[s], 0, h, j * 64, b);
        tma_load_4d(tile(s, 1), m2, &full[s], 0, h, j * 64, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
  }

  // A consumer thread: wait for pair j; returns its stage.
  __device__ int wait(int j) const {
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    return s;
  }

  // A consumer thread is done with pair j.
  __device__ void release(int j) const { mbar_arrive(&empty[j % STAGES]); }
};

// Shared memory of a block with OWN own tiles, a ring of STAGES stages and
// STATS bytes of per-stage rows: own tiles, the ring, the stats, then the
// own tiles' barrier and the ring's full[] and empty[].
template <int OWN, int STAGES, int STATS>
struct Layout {
  static constexpr int own = 0;
  static constexpr int ring = own + OWN * kTileBytes;
  static constexpr int stats = ring + STAGES * 2 * kTileBytes;
  static constexpr int bars = stats + STATS;
  static constexpr int alloc = bars + 8 * (1 + 2 * STAGES) + 1024;  // room to align to 1024

  __device__ static unsigned char* base(unsigned char* raw) {
    return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  }
  __device__ static Ring<STAGES> ring_of(unsigned char* smem) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + bars) + 1;
    return Ring<STAGES>{smem + ring, full, full + STAGES};
  }
};

// ---- forward ---------------------------------------------------------------

struct Sm90FwdArgs {
  __nv_bfloat16* o;   // (B, Sq, H, D) at (sb, ss, sh) = os
  float* lse;         // B2: (B, H, Sq) f32 at (l_sb, l_sh), contiguous seq; B1: null
  long long os[3];
  long long l_sb, l_sh;
  int H, Sq, Sk;
  float scale;
};

using FwdLayout = Layout<1, kFwdStages, 0>;

// The online softmax of one 64 x 64 logits tile in the accumulator layout
// (this thread's rows g and g + 8, columns 8 i + 2 t, + 1), `valid` of its
// keys inside Sk: sc <- P = exp2((s - m_new) * sl2), unnormalised (0 past
// Sk); m <- the new running max of the raw logits; l <- l * alpha + the
// thread's partial row sums; alpha = exp2((m_old - m_new) * sl2), the
// output's rescale (0 on the first tile, where m_old = -inf). The max of the
// raw logits is that of the scaled ones only for sl2 > 0: flash_fwd_sm90
// refuses other scales, and the staged route turns them into a positive one
// by the sign of the Q it stores. (Taking the max after the scale cost 10%
// at level 0, PERF.md.)
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], int valid, int t, float sl2) {
  if (valid < 64) {  // keys past Sk: -inf, not the reference's mask value, whose
                     // product with sl2 overflows; the row max stays finite
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (8 * i + 2 * t + (e & 1) >= valid) sc[4 * i + e] = -INFINITY;
  }
  float mx[2] = {m[0], m[1]}, ms[2];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    alpha[e] = ex2((m[e] - mx[e]) * sl2);
    m[e] = mx[e];
    ms[e] = mx[e] * sl2;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(sc[4 * i + e], sl2, -ms[e >> 1]));
      sc[4 * i + e] = p;
      rs[e >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// The consumer warpgroup of the D = 64 forward, on either route: query rows
// q0 + [0, 64) of (batch b, head h), its Q tile at `qt` (complete when
// own_full's phase 0 does), the K/V pairs through `ring`.
__device__ __forceinline__ void fwd_consume(const unsigned char* qt, uint64_t* own_full,
                                            const Ring<kFwdStages>& ring, const Sm90FwdArgs& a, int b,
                                            int h, int q0, int n_tiles) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const float sl2 = a.scale * kLog2e;

  float acc[32], sc[32], alpha[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = sc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // raw-logit max, partial sums
  uint32_t pa[4][4];

  // Tile j's logits are issued together with tile j - 1's P V: S_j = Q K_j^T
  // and O += P_{j-1} V_{j-1}; both are waited for, then P_j is computed, tile
  // j - 1 released and O rescaled.
  mbar_wait(own_full, 0);
  ring.wait(0);
  wgmma_fence();
  gemm_xyt(sc, qt, ring.tile(0, 0));  // S_0 = Q K_0^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  online_softmax(sc, m, l, alpha, a.Sk, t, sl2);  // acc is 0: no rescale
  acc_to_a(pa, sc);
  for (int j = 1; j < n_tiles; ++j) {
    const int s = ring.wait(j);
    wgmma_fence();
    gemm_xyt(sc, qt, ring.tile(s, 0));                        // S_j = Q K_j^T
    gemm_ay(acc, pa, ring.tile((j - 1) % kFwdStages, 1));     // O += P_{j-1} V_{j-1}
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(acc);
    fence_regs(pa);
    online_softmax(sc, m, l, alpha, a.Sk - j * 64, t, sl2);
    ring.release(j - 1);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * i + e] *= alpha[e >> 1];
    acc_to_a(pa, sc);
  }
  wgmma_fence();
  gemm_ay(acc, pa, ring.tile((n_tiles - 1) % kFwdStages, 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  ring.release(n_tiles - 1);

  __nv_bfloat16* o = a.o + b * a.os[0] + h * a.os[2];
  l[0] = quad_sum(l[0]);  // every lane of the warp, before any leaves
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    if (r >= a.Sq) continue;
    const float inv = 1.0f / l[e];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + r * a.os[1] + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e] * inv, acc[4 * i + 2 * e + 1] * inv);
    if (a.lse != nullptr && t == 0) a.lse[b * a.l_sb + h * a.l_sh + r] = m[e] * a.scale + logf(l[e]);
  }
}

__global__ void __launch_bounds__(kThreads, 3)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, const Sm90FwdArgs a) {
  using L = FwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = L::base(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const auto ring = L::ring_of(smem);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * 64;
  const int n_tiles = (a.Sk + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    ring.init(128);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      tma_prefetch(&mq);
      tma_prefetch(&mk);
      tma_prefetch(&mv);
      mbar_arrive_expect_tx(own_full, kTileBytes);
      tma_load_4d(smem + L::own, &mq, own_full, 0, h, q0, b);
    }
    ring.produce(&mk, &mv, h, b, n_tiles, [](int, int, int) {});
    return;
  }
  fwd_consume(smem + L::own, own_full, ring, a, b, h, q0, n_tiles);
}

// ---- forward at head dim 64 on views TMA cannot read ("staged") -------------
//
// B1/B2 (and B6, their (batch, seq, head) stride form) on bf16 views whose
// rows TMA cannot read (a base or a stride off 16 bytes, as a slice of a
// wider buffer one element in), and at any scale. The consumer warpgroup is
// fwd_consume above, unchanged; only the way the tiles reach shared memory
// differs. A producer warpgroup lays each 64 x 64 tile out exactly as TMA's
// 128-byte swizzle does, so at a positive scale the result has the TMA
// route's bits.
// - A (row, head) slice is 64 bf16, 128 bytes, starting at an even byte
//   offset o = address % 16. Its bytes lie in the 16-byte aligned span that
//   encloses it: 8 aligned chunks when o = 0, else 9. The extra bytes share
//   aligned granules with valid ones, so no page or allocation edge is
//   crossed (ops/attention.py::staged_row; tests/test_torch_staged_plan.py).
// - A tile's 64 rows are 16 groups of 4 rows r0 + 8 k + 32 h (k = 0..3): 8
//   rows are 16 s bytes apart for any element stride s, so a group's rows
//   share o and r % 8. One warp instruction takes a group, 8 lanes a row:
//   lane (k, c) loads aligned chunk c with ld.global.nc.v4, takes chunk c + 1
//   from the next lane by a shuffle (lane 7 loads the 9th chunk itself),
//   keeps bytes [o, o + 16) of the 32 (two rounds of word selects, then a
//   funnel shift by 8 (o % 4) bits; no branch) and stores them with one
//   st.shared.v4 at chunk c ^ (r % 8) of tile row r: the layout TMA's
//   CU_TENSOR_MAP_SWIZZLE_128B writes and the wgmma descriptors read. Rows
//   past S load nothing and are stored as zeros, as TMA's out-of-bounds
//   fill.
// - Producer rate. At the UNet's level 0 a block takes 16 KB a stage; one
//   producer warp (160 threads, 3 blocks an SM) or two (192 threads) could
//   not keep up, nor could copies through shared memory (16-byte cp.async
//   or one 1-D bulk copy a row, each realigned from a staging area) (PERF.md
//   §6). So the producer is a warpgroup: warp w takes the groups (r0, h) in
//   {w, w + 4} x {0, 1} of every tile, each lane's rows and store offsets
//   fixed for the kernel; tile n + 1's 8 loads a lane are in flight while
//   tile n (Q, then K_0, V_0, K_1, ...) is realigned and stored; with one
//   key tile (Sk <= 64: the temporal attention's 16 frames) Q's, K's and V's
//   loads all go out first. 256 threads: 2 blocks an SM, no spills.
// - Proxy fence: wgmma reads shared memory through the async proxy, and the
//   producer's st.shared are generic-proxy writes. Each lane executes
//   fence.proxy.async after its stores and before it arrives on the
//   stage's full barrier (a plain 128-arrival barrier: no transaction
//   bytes); without it the consumers may multiply stale bytes.
// - Trap: the predicated load of the 9th chunk must not take the main
//   chunk's register as its initial value, or it waits for that load to
//   land and the two loads of every row run one after the other.
// - Any finite scale. The consumer's running max is over the raw logits,
//   which orders the scaled ones only for a positive scale. For scale < 0
//   the producer stores -Q (a sign flip of each bf16, exact) and the kernel
//   runs at -scale: (-q).k (-scale) = q.k scale bit for bit, and the max of
//   the logits of -Q is the min of those of Q. For scale == 0 it stores
//   zeros for Q and runs at scale 1: every logit is 0, P = 1 for every key
//   inside Sk, lse = log(Sk), as softmax(0) gives.
constexpr int kStagedProducerWarps = 4;  // a warpgroup
constexpr int kStagedThreads = 128 + 32 * kStagedProducerWarps;
constexpr int kStagedBlocksPerSM = 2;  // 256 threads x 128 registers: the register file

// One (B, S, H, 64) bf16 source of the staged producer, in bytes.
struct StagedSrc {
  const unsigned char* p;
  long long sb, ss, sh;
  int S;
};

struct Sm90StagedArgs {
  StagedSrc src[3];  // q, k, v
  int qmode;         // Q as stored: kQAsIs, kQNegated (scale < 0), kQZero (scale == 0)
};
enum StagedQ : int { kQAsIs = 0, kQNegated = 1, kQZero = 2 };

// The producer warpgroup of the staged forward (threads 128..255). Tile n:
// 0 = Q's rows q0 + [0, 64) into the own tile; 2 j + 1 = K_j, 2 j + 2 = V_j
// into ring stage j % kFwdStages. Tile n + 1's loads are in flight while
// tile n is realigned and stored.
__device__ __forceinline__ void staged_produce(unsigned char* smem, uint64_t* own_full, const Ring<kFwdStages>& ring,
                                               const Sm90StagedArgs& sa, int b, int h, int q0, int n_tiles) {
  const int warp = threadIdx.x / 32 - 4, lane = threadIdx.x % 32, k = lane / 8, c = lane % 8;
  const unsigned char* qb = sa.src[0].p + b * sa.src[0].sb + h * sa.src[0].sh;
  const unsigned char* kb = sa.src[1].p + b * sa.src[1].sb + h * sa.src[1].sh;
  const unsigned char* vb = sa.src[2].p + b * sa.src[2].sb + h * sa.src[2].sh;
  const long long qs = sa.src[0].ss, ks = sa.src[1].ss, vs = sa.src[2].ss;
  const int Sq = sa.src[0].S, Sk = sa.src[1].S, qmode = sa.qmode;
  int trow[4];      // this lane's tile row in each of its warp's 4 groups
  uint32_t sto[4];  // and where its output chunk goes in the tile
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r0 = warp + 4 * (u & 1);
    trow[u] = r0 + 8 * k + 32 * (u >> 1);
    sto[u] = trow[u] * 128 + 16 * (c ^ r0);  // (r % 8) == r0: the 128-byte swizzle
  }
  // tile n's rows: its first row's address in its tensor's (batch, head),
  // the row stride, the rows inside S
  const auto tile_of = [&](int n, const unsigned char*& base, long long& st, int& rows) {
    const int j = (n - 1) >> 1;
    base = n == 0 ? qb + q0 * qs : (n & 1) ? kb + 64 * j * ks : vb + 64 * j * vs;
    st = n == 0 ? qs : (n & 1) ? ks : vs;
    rows = n == 0 ? Sq - q0 : Sk - 64 * j;
  };
  struct Batch {  // one tile's 4 groups as this lane loaded them
    uint4 lo[4], ex[4];
  };
  const int n_last = 2 * n_tiles;
  // Rows past S load nothing (zeros). Both loads start from zeros, not from
  // each other: a load whose register holds another load's result waits
  // for it, and the two loads of a row would run one after the other.
  const auto load = [&](int n, Batch& bt) {
    if (n > n_last) return;
    const unsigned char* base;
    long long st;
    int rows;
    tile_of(n, base, st, rows);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned char* rp = base + trow[u] * st;
      const uint32_t o = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(rp)) & 15;
      rp -= o;
      bt.lo[u] = bt.ex[u] = make_uint4(0u, 0u, 0u, 0u);
      ldg_nc128_if(bt.lo[u], rp + 16 * c, trow[u] < rows);
      ldg_nc128_if(bt.ex[u], rp + 128, trow[u] < rows && c == 7 && o);  // inside the row's last granule
    }
  };
  const auto store = [&](int n, Batch& bt) {
    const unsigned char* base;
    long long st;
    int rows;
    tile_of(n, base, st, rows);
    uint4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint32_t o = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(base + trow[u] * st)) & 15;
      uint4 hi;  // chunk c + 1: the next lane's, lane 7's 9th
      hi.x = __shfl_down_sync(0xffffffffu, bt.lo[u].x, 1, 8);
      hi.y = __shfl_down_sync(0xffffffffu, bt.lo[u].y, 1, 8);
      hi.z = __shfl_down_sync(0xffffffffu, bt.lo[u].z, 1, 8);
      hi.w = __shfl_down_sync(0xffffffffu, bt.lo[u].w, 1, 8);
      if (c == 7) hi = bt.ex[u];
      v[u] = realign16(bt.lo[u], hi, o);
      // Q negated (scale < 0) or zeros (scale == 0); rows past S are zeros
      const uint32_t m = n == 0 && qmode == kQZero ? 0u : ~0u;
      const uint32_t x = n == 0 && qmode == kQNegated && trow[u] < rows ? 0x80008000u : 0u;
      v[u] = make_uint4((v[u].x & m) ^ x, (v[u].y & m) ^ x, (v[u].z & m) ^ x, (v[u].w & m) ^ x);
    }
    const int j = (n - 1) >> 1;
    unsigned char* tile = smem + FwdLayout::own;
    if (n > 0) {
      if (n & 1) mbar_wait(&ring.empty[j % kFwdStages], ((j / kFwdStages) & 1) ^ 1);  // K_j: a free stage
      tile = ring.tile(j % kFwdStages, (n & 1) ? 0 : 1);
    }
    const uint32_t t = smem_addr(tile);
#pragma unroll
    for (int u = 0; u < 4; ++u) sts128(t + sto[u], v[u]);
    if (n == 0 || !(n & 1)) {  // Q, or V_j: the tiles are complete
      fence_proxy_async();    // the stores above, before wgmma reads them (async proxy)
      mbar_arrive(n == 0 ? own_full : &ring.full[j % kFwdStages]);
    }
  };

  // two batches, loaded and stored in turns (no register copies, which
  // would wait for the loads); with one key tile, Q's, K's and V's loads
  // all go out first (one load latency a block, not two)
  Batch ba, bb;
  if (n_last == 2) {
    Batch bc;
    load(0, ba);
    load(1, bb);
    load(2, bc);
    store(0, ba);
    store(1, bb);
    store(2, bc);
    return;
  }
  load(0, ba);
  for (int n = 0; n <= n_last; n += 2) {
    load(n + 1, bb);
    store(n, ba);
    if (n + 1 > n_last) break;
    load(n + 2, ba);
    store(n + 1, bb);
  }
}

__global__ void __launch_bounds__(kStagedThreads, kStagedBlocksPerSM)
flash_fwd_staged_sm90_kernel(const Sm90FwdArgs a, const Sm90StagedArgs sa) {
  using L = FwdLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = L::base(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const auto ring = L::ring_of(smem);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * 64;
  const int n_tiles = (a.Sk + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 32 * kStagedProducerWarps);  // every producer lane arrives
    ring.init(128, 32 * kStagedProducerWarps);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    staged_produce(smem, own_full, ring, sa, b, h, q0, n_tiles);
    return;
  }
  fwd_consume(smem + L::own, own_full, ring, a, b, h, q0, n_tiles);
}

// ---- forward at head dim 512 -----------------------------------------------
//
// The VAE mid block's one head of 512 (B1 when serving, B2 in reward
// training). A 64 x 512 f32 output accumulator would take one warpgroup 256
// registers a thread, so a block has two warpgroups, each owning half of the
// head dim (64 x 256 f32, 128 registers a thread). With no producer warp a
// thread may hold 255 registers; one thread of the first warpgroup issues
// the TMA loads. One block an SM (225 KB of shared memory).
// - Shared memory: Q (64 rows x 512, eight 64 x 64 tiles, loaded once), one
//   K slot and one V slot of 64 keys x 512 (eight tiles each) with their full
//   barriers, V's empty barrier, and the two warpgroups' partial logits.
//   K_{j+1} is issued once both warpgroups are done with S_j and loads under
//   tile j's softmax and P V; V_{j+1} is issued once both are done with
//   P_j V_j and loads under S_{j+1} and its softmax.
// - Logits: warpgroup w computes the partial S_w = Q[:, 256 w +: 256]
//   K_j[:, 256 w +: 256]^T (16 k16 slices of m64n64k16). The two partials are
//   exchanged through shared memory behind a named barrier of the 256
//   threads; each warpgroup adds the other's to its own (the same sum, f32
//   addition being commutative), so both run the same online softmax on the
//   same numbers. Deterministic: no atomics, a fixed order.
// - P V: P (64 x 64 keys, bf16 A fragments from registers) times warpgroup
//   w's 256 columns of V_j, four m64n256k16 a tile; V is read MN-major, its
//   256 columns four swizzle atoms 8 KB (one tile) apart.
// - Named barriers: 1, both partials written (so both warpgroups are done
//   with K_j); 2 + w, warpgroup 1 - w has read warpgroup w's partial, so w
//   may overwrite it.
// - Measured against the alternatives (PERF.md): a producer warp beside the
//   two warpgroups caps ptxas at 168 registers a thread (setmaxnreg did not
//   lift it), which spilled; one warpgroup computing the whole S and the
//   softmax for both, the role alternating by tile, and a CTA pair
//   multicasting K and V to each other were slower.
constexpr int kD512Threads = 256;  // two warpgroups
constexpr int kRowTiles = 8;        // 64 x 64 tiles a 64-row slab of 512 columns

struct D512Layout {
  static constexpr int slab = kRowTiles * kTileBytes;  // 64 KB
  static constexpr int q = 0, k = slab, v = 2 * slab;
  static constexpr int xch = 3 * slab;  // [2 warpgroups][32 values][128 threads] f32
  static constexpr int bars = xch + 2 * 32 * 128 * 4;
  static constexpr int alloc = bars + 8 * 4 + 1024;  // room to align to 1024
};

// The ROWS rows from `row` of one (head, batch) of a D = 512 map whose box is
// 64 columns x ROWS rows: eight boxes of ROWS * 128 bytes, completing on `bar`.
template <int ROWS = 64>
__device__ __forceinline__ void load_slab(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                          int row, int b) {
  mbar_arrive_expect_tx(bar, kRowTiles * ROWS * 128);
#pragma unroll
  for (int c = 0; c < kRowTiles; ++c) tma_load_4d(dst + c * ROWS * 128, map, bar, 64 * c, h, row, b);
}

// d (+)= X Y^T over one warpgroup's half of the 512-deep head dim: X its four
// 64 x 64 own tiles, Y four boxes of N rows (N * 128 bytes apart), both
// K-major; 16 k16 slices, issued, not waited for.
template <int N>
__device__ __forceinline__ void gemm_half_xyt(float (&d)[N / 2], const unsigned char* x, const unsigned char* y) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t dx = desc_sw128(x + c * kTileBytes), dy = desc_sw128(y + c * N * 128);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, dx + 2 * kk, dy + 2 * kk, c | kk);
  }
}

__global__ void __launch_bounds__(kD512Threads, 1)
flash_fwd_d512_sm90_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv, const Sm90FwdArgs a) {
  using L = D512Layout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = FwdLayout::base(smem_raw);  // any Layout's 1024-byte alignment
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t *q_full = bar, *k_full = bar + 1, *v_full = bar + 2, *v_empty = bar + 3;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * 64;
  const int n_tiles = (a.Sk + 63) / 64;
  const bool loader = threadIdx.x == 0;

  if (loader) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(v_empty, 8);  // a lane of each warp
    mbar_fence_init();
  }
  __syncthreads();
  if (loader) {
    tma_prefetch(&mq);
    tma_prefetch(&mk);
    tma_prefetch(&mv);
    load_slab(smem + L::q, &mq, q_full, h, q0, b);
    load_slab(smem + L::k, &mk, k_full, h, 0, b);
    load_slab(smem + L::v, &mv, v_full, h, 0, b);
  }

  // warpgroup wg: query rows q0 + [0, 64), head-dim columns 256 wg + [0, 256)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const unsigned char* qt = smem + L::q + 4 * wg * kTileBytes;
  const unsigned char* kt = smem + L::k + 4 * wg * kTileBytes;
  const unsigned char* vt = smem + L::v + 4 * wg * kTileBytes;
  float* xch_own = reinterpret_cast<float*>(smem + L::xch) + wg * 32 * 128 + tid;
  const float* xch_peer = reinterpret_cast<float*>(smem + L::xch) + (1 - wg) * 32 * 128 + tid;
  const float sl2 = a.scale * kLog2e;

  float acc[128], sc[32], alpha[2];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // raw-logit max, partial sums
  uint32_t pa[4][4];

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    mbar_wait(k_full, j & 1);
    wgmma_fence();
    gemm_half_xyt<64>(sc, qt, kt);  // this half's partial S = Q K_j^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if (j > 0) named_bar_sync(2 + wg, 256);  // the peer has read this warpgroup's last partial
#pragma unroll
    for (int i = 0; i < 32; ++i) xch_own[i * 128] = sc[i];
    named_bar_sync(1, 256);
    if (loader && j + 1 < n_tiles) load_slab(smem + L::k, &mk, k_full, h, 64 * (j + 1), b);
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] += xch_peer[i * 128];
    if (j + 1 < n_tiles) named_bar_arrive(3 - wg, 256);  // the peer may overwrite its partial

    online_softmax(sc, m, l, alpha, a.Sk - j * 64, t, sl2);
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * i + e] *= alpha[e >> 1];
    acc_to_a(pa, sc);

    mbar_wait(v_full, j & 1);
    wgmma_fence();
    const uint64_t dv = desc_sw128(vt, kTileBytes);  // 4 atoms along N, a tile apart
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(acc, pa[kk], dv + 128 * kk);  // +2048 bytes a slice
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(v_empty);
    if (loader && j + 1 < n_tiles) {
      mbar_wait(v_empty, j & 1);  // both warpgroups are done with V_j
      load_slab(smem + L::v, &mv, v_full, h, 64 * (j + 1), b);
    }
  }

  __nv_bfloat16* o = a.o + b * a.os[0] + h * a.os[2] + 256 * wg;
  l[0] = quad_sum(l[0]);  // every lane of the warp, before any leaves
  l[1] = quad_sum(l[1]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    if (r >= a.Sq) continue;
    const float inv = 1.0f / l[e];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + r * a.os[1] + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e] * inv, acc[4 * i + 2 * e + 1] * inv);
    if (a.lse != nullptr && wg == 0 && t == 0) a.lse[b * a.l_sb + h * a.l_sh + r] = m[e] * a.scale + logf(l[e]);
  }
}

// ---- backward --------------------------------------------------------------

struct Sm90BwdArgs {
  const float *lse, *delta;  // (B, H, Sq) f32 at (l_sb, l_sh), contiguous seq
  __nv_bfloat16 *out1, *out2;  // dK and dV, or dQ (D = 512: dV, dK or dQ): (B, S_own, H, D)
  long long o1[3], o2[3];      // (sb, ss, sh) of out1, out2
  long long l_sb, l_sh;
  int H, own_len, str_len;     // rows of the own side and of the streamed side
  float scale;
};

template <bool DKV>
using BwdLayout = Layout<2, kBwdStages, DKV ? kBwdStages * 2 * 64 * 4 : 0>;  // dK/dV: [stages][2][64] f32

template <bool DKV>
__global__ void __launch_bounds__(kThreads, DKV ? 2 : 3)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap own1,
                      const __grid_constant__ CUtensorMap own2,
                      const __grid_constant__ CUtensorMap str1,
                      const __grid_constant__ CUtensorMap str2, const Sm90BwdArgs a) {
  using L = BwdLayout<DKV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = L::base(smem_raw);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  const auto ring = L::ring_of(smem);
  float* stats = reinterpret_cast<float*>(smem + L::stats);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own0 = blockIdx.x * 64;
  const int n_tiles = (a.str_len + 63) / 64;
  const float* lse = a.lse + b * a.l_sb + h * a.l_sh;
  const float* delta = a.delta + b * a.l_sb + h * a.l_sh;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    ring.init(128);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    if (threadIdx.x % 32 == 0) {
      tma_prefetch(&own1);
      tma_prefetch(&own2);
      tma_prefetch(&str1);
      tma_prefetch(&str2);
      mbar_arrive_expect_tx(own_full, 2 * kTileBytes);
      tma_load_4d(smem + L::own, &own1, own_full, 0, h, own0, b);
      tma_load_4d(smem + L::own + kTileBytes, &own2, own_full, 0, h, own0, b);
    }
    ring.produce(&str1, &str2, h, b, n_tiles, [&](int j, int s, int lane) {
      if constexpr (DKV) {  // the stage's queries: lse * log2(e) (+inf past Sq), delta
        for (int r = lane; r < 64; r += 32) {
          const int q = j * 64 + r;
          const bool in = q < a.str_len;
          stats[(2 * s) * 64 + r] = in ? lse[q] * kLog2e : INFINITY;
          stats[(2 * s + 1) * 64 + r] = in ? delta[q] : 0.0f;
        }
      }
    });
    return;
  }

  // the consumer warpgroup: own rows own0 + [0, 64)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const unsigned char* x1 = smem + L::own;
  const unsigned char* x2 = x1 + kTileBytes;
  const float sl2 = a.scale * kLog2e;
  const int row = own0 + 16 * warp + g;  // this thread's rows: row, row + 8

  float lse2[2] = {0.0f, 0.0f}, dl[2] = {0.0f, 0.0f};  // dQ: the own rows' statistics
  if constexpr (!DKV) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row + 8 * e < a.own_len) {
        lse2[e] = lse[row + 8 * e] * kLog2e;
        dl[e] = delta[row + 8 * e];
      }
  }
  float acc1[32], acc2[32], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc1[i] = acc2[i] = sc[i] = dp[i] = 0.0f;
  uint32_t pa[4][4], da[4][4];

  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = ring.wait(j);
    const unsigned char* y1 = ring.tile(s, 0);
    const unsigned char* y2 = ring.tile(s, 1);
    wgmma_fence();
    gemm_xyt(sc, x1, y1);  // S^T = K Q^T, or S = Q K^T
    gemm_xyt(dp, x2, y2);  // dP^T = V dO^T, or dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    if constexpr (DKV) {
      const float* st = stats + (2 * s) * 64;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * i + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(st + c);
        const float2 d = *reinterpret_cast<const float2*>(st + 64 + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[4 * i + e], sl2, -((e & 1) ? l.y : l.x)));
          sc[4 * i + e] = p;
          dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? d.y : d.x));
        }
      }
      acc_to_a(pa, sc);
    } else {
      const int valid = a.str_len - j * 64;  // keys of this tile inside Sk
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sc[4 * i + e], sl2, -lse2[e >> 1]));
          if (valid < 64 && 8 * i + 2 * t + (e & 1) >= valid) p = 0.0f;
          dp[4 * i + e] = p * (dp[4 * i + e] - dl[e >> 1]);
        }
    }
    acc_to_a(da, dp);
    wgmma_fence();
    if constexpr (DKV) gemm_ay(acc2, pa, y2);  // dV += P^T dO
    gemm_ay(acc1, da, y1);                     // dK += dS^T Q, or dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc1);
    if constexpr (DKV) {
      fence_regs(acc2);
      fence_regs(pa);
    }
    fence_regs(da);
    ring.release(j);
  }

  // out1 = scale * acc1 (dK or dQ), out2 = acc2 (dV)
  __nv_bfloat16* o1 = a.out1 + b * a.o1[0] + h * a.o1[2];
  __nv_bfloat16* o2 = DKV ? a.out2 + b * a.o2[0] + h * a.o2[2] : nullptr;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    if (r >= a.own_len) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * i + 2 * t, k = 4 * i + 2 * e;
      *reinterpret_cast<__nv_bfloat162*>(o1 + r * a.o1[1] + c) =
          __floats2bfloat162_rn(acc1[k] * a.scale, acc1[k + 1] * a.scale);
      if constexpr (DKV)
        *reinterpret_cast<__nv_bfloat162*>(o2 + r * a.o2[1] + c) =
            __floats2bfloat162_rn(acc2[k], acc2[k + 1]);
    }
  }
}

// ---- backward at head dim 512 ----------------------------------------------
//
// The VAE mid block's one head of 512 with gradient (reward feedback): B3's
// dK/dV and dQ. What one block can hold decides the design:
// - Registers: a 64-row own tile's dK and dV accumulators are 2 x 64 x 512
//   f32 = 256 KB, the SM's whole register file. Two warpgroups can each hold
//   64 x 256 f32 of one accumulator (128 registers a thread), not of two.
// - Shared memory: a 64 x 512 bf16 slab is 64 KB. dK/dV reads K, V, Q_i and
//   dO_i, dQ reads Q, dO, K_j and V_j: 256 KB at 64 rows each, past the
//   227 KB a block may have.
// So three kernels, each owning 64 rows and one output of 64 x 512, with two
// warpgroups each owning 256 of its columns (m64n256k16, as the forward):
//   dV: owns K; streams Q_i (the logits' tile) and dO_i (the product's), 64
//       rows each: S^T = K Q_i^T, P^T = exp(S^T - lse_i), dV += P^T dO_i;
//   dK: owns K, V; streams dO_i and Q_i, 32 rows each: dP^T = V dO_i^T,
//       S^T = K Q_i^T, dS^T = P^T (dP^T - delta_i), dK += dS^T Q_i;
//   dQ: owns Q, dO; streams V_j and K_j, 32 rows each: dP = dO V_j^T,
//       S = Q K_j^T, dS = P (dP - delta), dQ += dS K_j.
// 8 products in all (the logits three times), not 7: the price of one
// accumulator a block. dK and dV are one launch (z = 0 and 1).
// - Logits: each warpgroup computes a partial over its half of the depth
//   (m64n64k16 for dV, m64n32k16 for dK and dQ; both operands K-major in
//   shared memory). The partials are summed through shared memory in the
//   streamed slot the logits just read (`xs`), so no exchange buffer is
//   needed: named barrier 1 (both warpgroups are done reading xs), each
//   writes its 16 KB, named barrier 2, each adds the peer's to its own (the
//   same sum in both, f32 addition being commutative), every warp arrives on
//   xs's empty mbarrier and thread 0 reloads xs with the next tile.
// - The product's streamed tile (`fs`, read MN-major: 256 columns as four
//   swizzle atoms a box apart) has slots of its own: one of 64 rows for dV,
//   loaded under the next tile's logits and exchange; two stages of 32 rows
//   for dK and dQ, whose logits read it too, so that tile j + 1's is in place
//   when tile j ends.
// - Shared memory: dV 64 (K) + 64 (xs) + 64 (fs) = 192 KB; dK, dQ 128 (own)
//   + 32 (xs) + 2 x 32 (fs) = 224 KB. One block an SM. 256 threads, thread 0
//   issuing every TMA load: no producer warp, which capped ptxas at 168
//   registers in the forward.
// - Registers a thread: the accumulator 128, the logits 32 (S, or S and dP),
//   P or dS as A fragments 16 or 8, the streamed rows' lse and delta 16;
//   ptxas: 227 (dK/dV) and 209 (dQ), no spills.
// - Measured against the alternatives (PERF.md): dV and dK as two launches
//   (each 2.4 waves at batch 8) took 31% longer than one; keeping tile j's
//   product in flight under tile j + 1's logits, and a dedicated exchange
//   buffer for dV with three 32-row buffers rotating through the roles for
//   dK and dQ (so that each tile loads earlier), were slower. With the
//   loads after the first tile skipped the pair took 30% less time; with
//   the exp2 skipped 3-4% less, with the exchange skipped dQ 6% less.
// - P = exp2(s * scale * log2(e) - lse * log2(e)) from the saved lse, so any
//   scale works (no running max). Queries past Sq read lse = +inf (P = 0;
//   their Q and dO rows are TMA's zeros); keys past Sk get P = 0 in dQ; in dV
//   and dK their rows are not stored. The grid is the forward's: x = own
//   tiles, y = batch * head, so a head's streamed 5.2 MB stays in L2.
// Deterministic: no atomics, a fixed order; each output row is written once.
enum Bwd512Mode : int { kModeDV, kModeDK, kModeDQ };

template <int MODE>
struct Bwd512Layout {
  static constexpr int BN = MODE == kModeDV ? 64 : 32;  // streamed rows a tile
  static constexpr int OWN = MODE == kModeDV ? 1 : 2;   // own 64 x 512 slabs
  static constexpr int FS = MODE == kModeDV ? 1 : 2;    // stages of fs
  static constexpr int box = BN * 128;                  // a streamed tile's 64-column box
  static constexpr int tile = kRowTiles * box;          // a streamed tile
  static constexpr int xs = OWN * kRowTiles * kTileBytes;
  static constexpr int fs = xs + tile;
  static constexpr int bars = fs + FS * tile;  // own_full, xs_full, xs_empty, fs_full[FS], fs_empty[FS]
  static constexpr int alloc = bars + 8 * (3 + 2 * FS) + 1024;  // room to align to 1024
  static_assert(tile >= 2 * 32 * 128 * 4, "xs holds the two warpgroups' partial logits");
};

// One block of the MODE kernel: own rows 64 x, the maps' tensors as above.
template <int MODE>
__device__ __forceinline__ void bwd_d512_block(const CUtensorMap* own1, const CUtensorMap* own2,
                                               const CUtensorMap* xs_map, const CUtensorMap* fs_map,
                                               const Sm90BwdArgs& a, int x) {
  using L = Bwd512Layout<MODE>;
  constexpr int BN = L::BN, FS = L::FS, NA = BN / 16;  // NA: k16 slices of P or dS
  constexpr bool DV = MODE == kModeDV, DQ = MODE == kModeDQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = FwdLayout::base(smem_raw);  // any Layout's 1024-byte alignment
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t *own_full = bar, *xs_full = bar + 1, *xs_empty = bar + 2, *fs_full = bar + 3, *fs_empty = bar + 3 + FS;

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own0 = x * 64;
  const int n_tiles = (a.str_len + BN - 1) / BN;
  const bool loader = threadIdx.x == 0;

  if (loader) {
    mbar_init(own_full, L::OWN);
    mbar_init(xs_full, 1);
    mbar_init(xs_empty, 8);  // a lane of each warp
    for (int s = 0; s < FS; ++s) {
      mbar_init(&fs_full[s], 1);
      mbar_init(&fs_empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (loader) {
    tma_prefetch(own1);
    tma_prefetch(xs_map);
    tma_prefetch(fs_map);
    load_slab(smem, own1, own_full, h, own0, b);
    if constexpr (!DV) {
      tma_prefetch(own2);
      load_slab(smem + kRowTiles * kTileBytes, own2, own_full, h, own0, b);
    }
    load_slab<BN>(smem + L::xs, xs_map, xs_full, h, 0, b);
    for (int s = 0; s < FS && s < n_tiles; ++s) load_slab<BN>(smem + L::fs + s * L::tile, fs_map, &fs_full[s], h, BN * s, b);
  }

  // warpgroup wg: own rows own0 + [0, 64), head-dim columns 256 wg + [0, 256)
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = own0 + 16 * warp + g;  // this thread's own rows: row, row + 8
  const unsigned char* x1 = smem + 4 * wg * kTileBytes;  // this half of own slab 1 (K, or Q)
  const unsigned char* x2 = x1 + kRowTiles * kTileBytes;  // and of own slab 2 (V, or dO)
  unsigned char* xs = smem + L::xs;
  float* xch_own = reinterpret_cast<float*>(xs) + wg * 32 * 128 + tid;
  const float* xch_peer = reinterpret_cast<float*>(xs) + (1 - wg) * 32 * 128 + tid;
  const float sl2 = a.scale * kLog2e;
  const float* lse = a.lse + b * a.l_sb + h * a.l_sh;
  const float* delta = a.delta + b * a.l_sb + h * a.l_sh;

  float lse_r[2] = {0.0f, 0.0f}, dl_r[2] = {0.0f, 0.0f};  // dQ: the own rows' statistics
  if constexpr (DQ) {
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (row + 8 * e < a.own_len) {
        lse_r[e] = lse[row + 8 * e] * kLog2e;
        dl_r[e] = delta[row + 8 * e];
      }
  }
  float acc[128], sc[BN / 2], dp[DV ? 1 : BN / 2];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  uint32_t pa[NA][4];

  mbar_wait(own_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % FS;
    const unsigned char* xt = xs + 4 * wg * L::box;                        // this half of xs_j
    const unsigned char* ft = smem + L::fs + s * L::tile + 4 * wg * L::box;  // and of fs_j
    // dV, dK: the streamed queries' statistics, columns 8 i + 2 t (+ 1)
    float lse_c[DQ ? 1 : BN / 4], dl_c[DQ ? 1 : BN / 4];
    if constexpr (!DQ) {
#pragma unroll
      for (int c = 0; c < BN / 4; ++c) {
        const int q = j * BN + 8 * (c / 2) + 2 * t + (c & 1);
        const bool in = q < a.str_len;
        lse_c[c] = in ? lse[q] * kLog2e : INFINITY;
        dl_c[c] = in && !DV ? delta[q] : 0.0f;
      }
    }
    mbar_wait(xs_full, j & 1);
    wgmma_fence();
    if constexpr (DV)
      gemm_half_xyt<BN>(sc, x1, xt);  // S^T = K Q_j^T, this half's partial
    else
      gemm_half_xyt<BN>(dp, x2, xt);  // dP^T = V dO_j^T, or dP = dO V_j^T
    wgmma_commit();
    if constexpr (!DV) {
      mbar_wait(&fs_full[s], (j / FS) & 1);
      gemm_half_xyt<BN>(sc, x1, ft);  // S^T = K Q_j^T, or S = Q K_j^T
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(sc);
    if constexpr (!DV) fence_regs(dp);

    named_bar_sync(1, 256);  // both warpgroups are done reading xs_j
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) xch_own[i * 128] = sc[i];
    if constexpr (!DV) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) xch_own[(BN / 2 + i) * 128] = dp[i];
    }
    named_bar_sync(2, 256);  // both partials written
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] += xch_peer[i * 128];
    if constexpr (!DV) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) dp[i] += xch_peer[(BN / 2 + i) * 128];
    }
    fence_proxy_async();  // the partials' writes before TMA's refill of xs
    __syncwarp();
    if (lane == 0) mbar_arrive(xs_empty);
    if (loader && j + 1 < n_tiles) {
      mbar_wait(xs_empty, j & 1);  // every warp has read both partials
      load_slab<BN>(xs, xs_map, xs_full, h, BN * (j + 1), b);
    }

    // P, or dS = P (dP - delta), in the accumulator layout (this thread's
    // rows g and g + 8, columns 8 i + 2 t and + 1)
    const int valid = a.str_len - j * BN;  // dQ: keys of this tile inside Sk
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * i + e;
        if constexpr (DQ) {
          float p = ex2(fmaf(sc[k], sl2, -lse_r[e >> 1]));
          if (valid < BN && 8 * i + 2 * t + (e & 1) >= valid) p = 0.0f;
          dp[k] = p * (dp[k] - dl_r[e >> 1]);
        } else {
          const float p = ex2(fmaf(sc[k], sl2, -lse_c[2 * i + (e & 1)]));
          if constexpr (DV)
            sc[k] = p;
          else
            dp[k] = p * (dp[k] - dl_c[2 * i + (e & 1)]);
        }
      }
    if constexpr (DV)
      acc_to_a(pa, sc);
    else
      acc_to_a(pa, dp);

    if constexpr (DV) mbar_wait(&fs_full[s], (j / FS) & 1);
    wgmma_fence();
    const uint64_t df = desc_sw128(ft, L::box);  // 4 atoms along N, a box apart
#pragma unroll
    for (int kk = 0; kk < NA; ++kk) wgmma_rs_mn(acc, pa[kk], df + 128 * kk);  // +2048 bytes a k16 slice
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&fs_empty[s]);
    if (loader && j + FS < n_tiles) {
      mbar_wait(&fs_empty[s], (j / FS) & 1);  // both warpgroups are done with fs_j
      load_slab<BN>(smem + L::fs + s * L::tile, fs_map, &fs_full[s], h, BN * (j + FS), b);
    }
  }

  // out1 = acc (dV), or scale * acc (dK, dQ)
  const float mult = DV ? 1.0f : a.scale;
  __nv_bfloat16* o = a.out1 + b * a.o1[0] + h * a.o1[2] + 256 * wg;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row + 8 * e;
    if (r >= a.own_len) continue;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      *reinterpret_cast<__nv_bfloat162*>(o + r * a.o1[1] + 8 * i + 2 * t) =
          __floats2bfloat162_rn(acc[4 * i + 2 * e] * mult, acc[4 * i + 2 * e + 1] * mult);
  }
}

// dK and dV in one grid (z = 0: the dK blocks, z = 1: the dV blocks), so
// that the two share waves: at (8, 1, 2560, 2560) each has 320 blocks, 2.4
// waves of one block an SM. The dK blocks, which take about twice as long,
// are launched first and the dV blocks fill the tail (13% less time at
// batch 5, 2% at batch 8, than dV first). Maps: k, v, q, dO in 64-row
// boxes, dO and q in 32-row boxes; av writes dV, ak dK.
__global__ void __launch_bounds__(kD512Threads, 1)
flash_bwd_d512_dkv_sm90_kernel(const __grid_constant__ CUtensorMap k64, const __grid_constant__ CUtensorMap v64,
                               const __grid_constant__ CUtensorMap q64, const __grid_constant__ CUtensorMap g64,
                               const __grid_constant__ CUtensorMap g32, const __grid_constant__ CUtensorMap q32,
                               const Sm90BwdArgs av, const Sm90BwdArgs ak) {
  if (blockIdx.z == 0)
    bwd_d512_block<kModeDK>(&k64, &v64, &g32, &q32, ak, blockIdx.x);
  else
    bwd_d512_block<kModeDV>(&k64, &k64, &q64, &g64, av, blockIdx.x);
}

// dQ. Maps: q, dO in 64-row boxes, v, k in 32-row boxes.
__global__ void __launch_bounds__(kD512Threads, 1)
flash_bwd_d512_dq_sm90_kernel(const __grid_constant__ CUtensorMap q64, const __grid_constant__ CUtensorMap g64,
                              const __grid_constant__ CUtensorMap v32, const __grid_constant__ CUtensorMap k32,
                              const Sm90BwdArgs a) {
  bwd_d512_block<kModeDQ>(&q64, &g64, &v32, &k32, a, blockIdx.x);
}

// ---- host side -------------------------------------------------------------

// The 4-D map over (D, H, S, B) of a (B, S, H, D) bf16 tensor at element
// strides st = (sb, ss, sh): boxes of 64 columns x `rows` rows (D / 64 of
// them across a row), 128-byte swizzle, rows past S read as zeros.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B, int S, int H, int D,
              const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One map to make: a (B, S, H, D) tensor at `ptr` over S rows at element
// strides st, in boxes of `rows` rows.
struct MapSpec {
  const void* ptr;
  const long long* st;
  int S, rows;
};

// The maps of N tensors; cudaErrorInvalidValue unless TMA can read every
// one (16-byte aligned bases, strides of multiples of 16 bytes).
template <int N>
cudaError_t make_maps(CUtensorMap (&maps)[N], const MapSpec (&spec)[N], int B, int H, int D) {
  for (const MapSpec& m : spec)
    if (!rows_aligned16(m.ptr, m.st)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  for (int i = 0; i < N; ++i)
    if (!make_map(&maps[i], encode, spec[i].ptr, B, spec[i].S, H, D, spec[i].st, spec[i].rows))
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Launch kernel K with `smem` bytes of dynamic shared memory (the attribute
// is set once per kernel: the port drives one card).
template <auto K, typename... Args>
cudaError_t launch(int smem, dim3 grid, int threads, cudaStream_t st, Args... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  K<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// The wgmma route of flash_attention.cu's entry points (bf16, D = 64 or 512;
// arguments as there): o, and lse when it is not null. Refuses another head
// dim, tensors that break TMA's rule, and a scale that is not positive.
int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int Sq, int Sk, int D, const long long* strides, const long long* lse_strides,
                   float scale, void* stream) {
  if (D != 64 && D != 512) return (int)cudaErrorInvalidValue;
  CUtensorMap m[3];  // q, k, v; o is written by the threads
  const cudaError_t err =
      make_maps(m, {{q, strides, Sq, 64}, {k, strides + 3, Sk, 64}, {v, strides + 6, Sk, 64}}, B, H, D);
  if (err != cudaSuccess) return (int)err;
  if (!(scale > 0.0f)) return (int)cudaErrorInvalidValue;  // online_softmax's max
  Sm90FwdArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  const dim3 grid((Sq + 63) / 64, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 512)
    return (int)launch<flash_fwd_d512_sm90_kernel>(D512Layout::alloc, grid, kD512Threads, st, m[0], m[1], m[2], a);
  return (int)launch<flash_fwd_sm90_kernel>(FwdLayout::alloc, grid, kThreads, st, m[0], m[1], m[2], a);
}

// The staged route of flash_attention.cu's entry points: bf16 at D = 64 on
// any views whose head dimension is contiguous, at any finite scale; `strides`
// as there, followed by the head-dim strides of q, k, v and o. Refuses
// another head dim, a head dimension that is not contiguous, an o whose bf16
// pairs are not 4-byte aligned (o is written in pairs), and a non-finite
// scale; flash_fwd refuses f32.
int flash_fwd_staged_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                          int Sq, int Sk, int D, const long long* strides, const long long* lse_strides,
                          float scale, void* stream) {
  if (D != 64 || !isfinite(scale)) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (strides[12 + i] != 1) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(o) % 4 != 0 || strides[9] % 2 || strides[10] % 2 || strides[11] % 2)
    return (int)cudaErrorInvalidValue;
  Sm90FwdArgs a;
  a.o = static_cast<__nv_bfloat16*>(o);
  a.lse = lse;
  for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale > 0.0f ? scale : scale < 0.0f ? -scale : 1.0f;  // the consumers' scale (> 0)
  Sm90StagedArgs sa;
  sa.qmode = scale > 0.0f ? kQAsIs : scale < 0.0f ? kQNegated : kQZero;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* st = strides + 3 * i;
    sa.src[i] = {static_cast<const unsigned char*>(ptrs[i]), 2 * st[0], 2 * st[1], 2 * st[2], i == 0 ? Sq : Sk};
  }
  const dim3 grid((Sq + 63) / 64, B * H);
  return (int)launch<flash_fwd_staged_sm90_kernel>(FwdLayout::alloc, grid, kStagedThreads,
                                                   static_cast<cudaStream_t>(stream), a, sa);
}

// The wgmma route of flash_attention_bwd.cu's entry points (bf16, D = 64 or
// 512; arguments as there). Refuses another head dim and tensors that break
// TMA's rule.
int flash_bwd_sm90(bool dkv, const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, int D, const long long* strides, const long long* lse_strides,
                   float scale, void* stream) {
  if (D != 64 && D != 512) return (int)cudaErrorInvalidValue;
  Sm90BwdArgs a{};
  a.lse = lse;
  a.delta = delta;
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.H = H;
  a.scale = scale;
  a.own_len = dkv ? Sk : Sq;
  a.str_len = dkv ? Sq : Sk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long *sq = strides, *sk = strides + 3, *sv = strides + 6, *sg = strides + 9;
  const auto out = [&](void* p, int i) {  // out1 = tensor i of (dq, dk, dv)
    a.out1 = static_cast<__nv_bfloat16*>(p);
    for (int c = 0; c < 3; ++c) a.o1[c] = strides[12 + 3 * i + c];
  };
  if (D == 512) {
    constexpr int T = kD512Threads;
    if (!dkv) {
      CUtensorMap m[4];
      const cudaError_t err =
          make_maps(m, {{q, sq, Sq, 64}, {g, sg, Sq, 64}, {v, sv, Sk, 32}, {k, sk, Sk, 32}}, B, H, D);
      if (err != cudaSuccess) return (int)err;
      out(dq, 0);
      return (int)launch<flash_bwd_d512_dq_sm90_kernel>(Bwd512Layout<kModeDQ>::alloc, dim3((Sq + 63) / 64, B * H),
                                                         T, st, m[0], m[1], m[2], m[3], a);
    }
    CUtensorMap m[6];
    const cudaError_t err = make_maps(
        m, {{k, sk, Sk, 64}, {v, sv, Sk, 64}, {q, sq, Sq, 64}, {g, sg, Sq, 64}, {g, sg, Sq, 32}, {q, sq, Sq, 32}},
        B, H, D);
    if (err != cudaSuccess) return (int)err;
    out(dv, 2);
    const Sm90BwdArgs av = a;
    out(dk, 1);
    constexpr int smem = Bwd512Layout<kModeDK>::alloc;
    static_assert(smem >= Bwd512Layout<kModeDV>::alloc, "the dK blocks need the most");
    return (int)launch<flash_bwd_d512_dkv_sm90_kernel>(smem, dim3((Sk + 63) / 64, B * H, 2), T, st, m[0], m[1], m[2],
                                                        m[3], m[4], m[5], av, a);
  }
  CUtensorMap m[4];  // q, k, v, dO
  const cudaError_t err = make_maps(
      m, {{q, sq, Sq, 64}, {k, sk, Sk, 64}, {v, sv, Sk, 64}, {g, sg, Sq, 64}}, B, H, D);
  if (err != cudaSuccess) return (int)err;
  if (dkv) {
    out(dk, 1);
    a.out2 = static_cast<__nv_bfloat16*>(dv);
    for (int c = 0; c < 3; ++c) a.o2[c] = strides[18 + c];
    return (int)launch<flash_bwd_sm90_kernel<true>>(BwdLayout<true>::alloc, dim3((Sk + 63) / 64, B * H),
                                                    kThreads, st, m[1], m[2], m[0], m[3], a);
  }
  out(dq, 0);
  a.out2 = nullptr;
  return (int)launch<flash_bwd_sm90_kernel<false>>(BwdLayout<false>::alloc, dim3((Sq + 63) / 64, B * H),
                                                   kThreads, st, m[0], m[3], m[1], m[2], a);
}

}  // namespace t2v
