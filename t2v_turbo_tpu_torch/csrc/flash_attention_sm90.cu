// Flash attention in bf16 for Hopper (sm_90a): the forward at head dims 64
// and 512 and the backward at head dim 64, on wgmma products fed by TMA. The
// `wgmma` route of flash_attention.cu's and flash_attention_bwd.cu's entry
// points; misaligned views, the backward at D = 512 and f32 take those
// files' kernels.
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
//   real floor. Its kernel and design are under "forward at head dim 512".
//
// Design. Every kernel is one block of a consumer warpgroup owning 64 rows
// of one side of one (batch, head), loaded once by TMA, and one producer
// warp that streams the other side's 64-row tiles through a ring (`Ring`).
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
//   only; the backward takes any scale.
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
  __device__ void init(int consumers) const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);
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
// raw logits is that of the scaled ones only for sl2 > 0: the wrappers send
// other scales to the mma route, and flash_fwd_sm90 refuses them. (Taking
// the max after the scale cost 10% at level 0, PERF.md.)
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

  // the consumer warpgroup: query rows q0 + [0, 64)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const unsigned char* qt = smem + L::own;
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

// The 64 rows from `row` of one (head, batch) of a D = 512 map: eight boxes
// of 64 columns, completing on `bar`.
__device__ __forceinline__ void load_slab(unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int h,
                                          int row, int b) {
  mbar_arrive_expect_tx(bar, kRowTiles * kTileBytes);
#pragma unroll
  for (int c = 0; c < kRowTiles; ++c) tma_load_4d(dst + c * kTileBytes, map, bar, 64 * c, h, row, b);
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
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // this half's partial S = Q K_j^T, 4 tiles of 4 k16 slices
      const uint64_t dq = desc_sw128(qt + c * kTileBytes), dk = desc_sw128(kt + c * kTileBytes);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(sc, dq + 2 * kk, dk + 2 * kk, c | kk);
    }
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
  __nv_bfloat16 *out1, *out2;  // dK and dV, or dQ: (B, S_own, H, 64)
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

// ---- host side -------------------------------------------------------------

// The 4-D map over (D, H, S, B) of a (B, S, H, D) bf16 tensor at element
// strides st = (sb, ss, sh): 64 x 64 boxes (D / 64 of them across a row),
// 128-byte swizzle, rows past S read as zeros.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B, int S, int H, int D,
              const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of n (B, S, H, D) tensors, tensor i over S[i] rows at strides
// strides + 3 i; cudaErrorInvalidValue unless TMA can read every one
// (16-byte aligned bases, strides of multiples of 16 bytes).
template <int N>
cudaError_t make_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N], const int (&S)[N], int B,
                      int H, int D, const long long* strides) {
  for (int i = 0; i < N; ++i)
    if (!rows_aligned16(ptrs[i], strides + 3 * i)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  for (int i = 0; i < N; ++i)
    if (!make_map(&maps[i], encode, ptrs[i], B, S[i], H, D, strides + 3 * i)) return cudaErrorInvalidValue;
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
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {Sq, Sk, Sk};
  const cudaError_t err = make_maps(m, ptrs, rows, B, H, D, strides);
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

// The wgmma route of flash_attention_bwd.cu's entry points (bf16, D = 64;
// arguments as there). Refuses tensors that break TMA's rule.
int flash_bwd_sm90(bool dkv, const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, const long long* strides, const long long* lse_strides,
                   float scale, void* stream) {
  CUtensorMap m[4];  // q, k, v, dO
  const void* const ptrs[4] = {q, k, v, g};
  const int rows[4] = {Sq, Sk, Sk, Sq};
  const cudaError_t err = make_maps(m, ptrs, rows, B, H, 64, strides);
  if (err != cudaSuccess) return (int)err;
  Sm90BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.H = H;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) {
    a.out1 = static_cast<__nv_bfloat16*>(dk);
    a.out2 = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 3; ++i) {
      a.o1[i] = strides[15 + i];
      a.o2[i] = strides[18 + i];
    }
    a.own_len = Sk;
    a.str_len = Sq;
    return (int)launch<flash_bwd_sm90_kernel<true>>(BwdLayout<true>::alloc, dim3((Sk + 63) / 64, B * H),
                                                    kThreads, st, m[1], m[2], m[0], m[3], a);
  }
  a.out1 = static_cast<__nv_bfloat16*>(dq);
  a.out2 = nullptr;
  for (int i = 0; i < 3; ++i) a.o1[i] = a.o2[i] = strides[12 + i];
  a.own_len = Sq;
  a.str_len = Sk;
  return (int)launch<flash_bwd_sm90_kernel<false>>(BwdLayout<false>::alloc, dim3((Sq + 63) / 64, B * H),
                                                   kThreads, st, m[0], m[3], m[1], m[2], a);
}

}  // namespace t2v
