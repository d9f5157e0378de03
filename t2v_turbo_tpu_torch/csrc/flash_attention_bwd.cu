// Flash-attention backward for Hopper: the gradients of
// o = softmax(q k^T * scale) v from the saved log-sum-exp rows, never
// materialising the (Sq, Sk) probabilities in device memory.
//
// Replaces the Pallas TPU kernels t2v_turbo_tpu/ops/attention.py::
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (implementation
// _flash_attention_bwd_impl, the backward rule of flash_attention's custom
// VJP; "B3"). Through its (batch, seq, head) strides it is also the BSHD
// family's backward (B6: _flash_bwd_dkv_kernel_bshd, _flash_bwd_dq_kernel_bshd).
// On the training path it runs the backward of every attention in the
// student's gradient-carrying UNet forward (heads of 64); with reward
// feedback, also of ViCLIP's attention (heads of 64) and of the VAE
// decoder's mid-block attention (one head of 512), which the reward
// gradients pass through.
//
// Per (query i, key j), with s = q_i . k_j * scale and delta_i = dO_i . O_i
// (computed by the caller, in f32):
//   P = exp(s - lse_i);  dV_j += P dO_i;  dS = P (dO_i . v_j - delta_i);
//   dK_j += scale dS q_i;  dQ_i += scale dS k_j.
// Keys past Sk and queries past Sq get P = 0 inside the kernel (the TPU pads
// the queries with lse = 1e9 to the same effect), so any S works without
// padding copies. Two kernels, as on the TPU, both deterministic (no
// atomics, a fixed summation order): the TPU's sequential grid axis becomes
// a loop in the block.
// - dK/dV: one block per (batch*head, tile of keys), looping over query
//   tiles; the key tile's dK and dV accumulate in registers.
// - dQ: one block per (batch*head, tile of queries), looping over key
//   tiles; the query tile's dQ accumulates in registers.
// Each recomputes P, so the logits are computed twice in all, as on the TPU.
//
// What bounds it on the H100: 7 matrix products of Sq x Sk x D each (two
// logit recomputations, dP twice, and dV, dK, dQ once) against reading
// q, k, v, dO and writing dq, dk, dv once: the arithmetic, as in the
// forward. Three routes do it; the wrapper picks one and passes it in:
// - wgmma (bf16 at D = 64, TMA-aligned tensors): flash_attention_bwd_sm90.cu,
//   wgmma products fed by a TMA ring.
// - mma (bf16: D = 64 views that TMA cannot read, and D = 512): tensor
//   cores through mma.sync.m16n8k16 (flash_mma.cuh). Each warp
//   keeps its rows of the block's own side (K and V for dK/dV; Q and dO for
//   dQ) in registers as A fragments for the whole loop; the other side is
//   staged in shared memory per tile (BwdTiling says how the warps split
//   rows and head dim). P and dS are rounded to bf16 for their products
//   (P dO, dS q, dS k) and every product accumulates in f32; the scale is
//   applied once at the end.
// - f32: scalar FMAs out of shared memory, exact enough to hold against
//   the plain f32 math; shared-memory bandwidth is its limit.
#include "flash_mma.cuh"

namespace t2v {

// route codes shared with the Python wrappers (ops/attention.py BWD_ROUTES):
// the mma.sync or f32 kernels of this file, or the sm_90a wgmma kernels
enum BwdRoute : int { kRouteMma = 0, kRouteWgmma = 1 };

int flash_bwd_sm90(bool dkv, const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, const long long* strides, const long long* lse_strides,
                   float scale, void* stream);

template <typename T>
struct BwdArgs {
  const T *q, *k, *v, *g;        // g = dO
  const float *lse, *delta;      // (B, H, Sq) f32, strides (l_sb, l_sh), contiguous seq
  T *dq, *dk, *dv;
  int H, Sq, Sk;
  long long st[21];              // (sb, ss, sh) of q, k, v, g, dq, dk, dv
  long long l_sb, l_sh;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16 on tensor cores
// ---------------------------------------------------------------------------

// Tilings of the two mma kernels. Each warp owns 16 rows of the block's own
// side and a DW = D / D_SLICES = 64 wide slice of the head dim, so a warp's
// fragments and accumulators are the same size at both head dims.
// - D = 64: 4 warps own 64 rows (4 row groups, one slice); the other side
//   comes in tiles of BT = 64 rows.
// - D = 512: a 64 x 512 tile of K or V is 64 KB of bf16 and the dK/dV
//   accumulators 2 x 64 x 512 f32, far past the registers, so 8 warps own
//   16 rows together, each a 64-wide slice of the head dim (its slice of
//   the own rows as A fragments, its slice of dK, dV or dQ in registers).
//   The other side comes in tiles of BT = 32 rows staged whole in shared
//   memory. Each warp computes partial logits S and dP over its slice; the
//   8 partials are summed through shared memory in a fixed order (as the
//   D = 512 forward does), so every warp holds the same P and dS.
template <int D> struct BwdTiling;
template <> struct BwdTiling<64> {
  static constexpr int WARPS = 4, ROW_GROUPS = 4, D_SLICES = 1, BT = 64;
};
template <> struct BwdTiling<512> {
  static constexpr int WARPS = 8, ROW_GROUPS = 1, D_SLICES = 8, BT = 32;
};

template <int D> struct BwdSmem {
  using Tl = BwdTiling<D>;
  static constexpr int LD = D + 8;         // staged rows (bf16)
  static constexpr int LDS = Tl::BT + 4;   // partial-logit rows (f32)
  static constexpr size_t tile_bytes = sizeof(__nv_bfloat16) * 2 * Tl::BT * LD;
  static constexpr size_t red_bytes =
      Tl::D_SLICES > 1 ? sizeof(float) * 2 * Tl::WARPS * 16 * LDS : 0;
  static constexpr size_t dq_bytes = tile_bytes + red_bytes;
  static constexpr size_t dkv_bytes = dq_bytes + sizeof(float) * 2 * Tl::BT;  // + lse, delta
};

// Sum the D_SLICES warps' partial logit tiles S and dP of one row group
// through shared memory `red`, in a fixed order, so every warp of the group
// ends with the full tiles. The caller's next write to `red` must follow a
// __syncthreads.
template <int D, int NT>
__device__ __forceinline__ void sum_slices(float (&s)[NT][4], float (&dp)[NT][4], float* red,
                                           int group, int slice, int g, int t) {
  using Tl = BwdTiling<D>;
  constexpr int LDS = BwdSmem<D>::LDS;
  float* red_dp = red + Tl::WARPS * 16 * LDS;
  auto at = [&](int sl, int e, int nt) {
    return ((sl * Tl::ROW_GROUPS + group) * 16 + g + (e >> 1) * 8) * LDS + nt * 8 + 2 * t + (e & 1);
  };
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      red[at(slice, e, nt)] = s[nt][e];
      red_dp[at(slice, e, nt)] = dp[nt][e];
    }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float ts = 0.0f, tp = 0.0f;
#pragma unroll
      for (int sl = 0; sl < Tl::D_SLICES; ++sl) {
        ts += red[at(sl, e, nt)];
        tp += red_dp[at(sl, e, nt)];
      }
      s[nt][e] = ts;
      dp[nt][e] = tp;
    }
}

template <int D, bool VEC>
__global__ void __launch_bounds__(32 * BwdTiling<D>::WARPS)
flash_bwd_dkv_mma_kernel(const BwdArgs<__nv_bfloat16> a) {
  using Tl = BwdTiling<D>;
  using Sm = BwdSmem<D>;
  constexpr int NTHREADS = 32 * Tl::WARPS, BQ = Tl::BT, LD = Sm::LD;
  constexpr int DW = D / Tl::D_SLICES, NT = BQ / 8, KC = DW / 16, DT = DW / 8;
  static_assert(Tl::ROW_GROUPS * Tl::D_SLICES == Tl::WARPS, "warps tile rows x head dim");
  static_assert(Sm::tile_bytes % 16 == 0 && Sm::red_bytes % 16 == 0, "smem carve alignment");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* sG = sQ + BQ * LD;                                  // [BQ][LD]
  float* sRed = reinterpret_cast<float*>(smem_raw + Sm::tile_bytes);
  float* sL = reinterpret_cast<float*>(smem_raw + Sm::tile_bytes + Sm::red_bytes);  // [BQ]
  float* sDl = sL + BQ;                                                              // [BQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / Tl::D_SLICES, slice = warp % Tl::D_SLICES, d0 = slice * DW;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const __nv_bfloat16* qb = a.q + b * st[0] + h * st[2];
  const __nv_bfloat16* kb = a.k + b * st[3] + h * st[5];
  const __nv_bfloat16* vb = a.v + b * st[6] + h * st[8];
  const __nv_bfloat16* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int r0 = (blockIdx.x * Tl::ROW_GROUPS + group) * 16 + g;  // this lane's keys r0, r0 + 8

  uint32_t ka[KC][4], va[KC][4];
  load_a_frags<KC>(ka, kb, r0, a.Sk, st[4], d0, t);
  load_a_frags<KC>(va, vb, r0, a.Sk, st[7], d0, t);
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.0f;

  for (int q0 = 0; q0 < a.Sq; q0 += BQ) {
    __syncthreads();  // the previous tile's reads are done
    stage_pair<D, BQ, LD, NTHREADS, VEC>(sQ, sG, qb, gb, st[1], st[10], q0, a.Sq);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      const bool in = q0 + i < a.Sq;
      sL[i] = in ? lb[q0 + i] : 0.0f;
      sDl[i] = in ? db[q0 + i] : 0.0f;
    }
    __syncthreads();
    float s[NT][4], dp[NT][4];
    qk_tile<NT, KC, LD>(s, ka, sQ, d0, g, t);   // S^T: keys x queries
    qk_tile<NT, KC, LD>(dp, va, sG, d0, g, t);  // dP^T = V dO^T
    if constexpr (Tl::D_SLICES > 1) sum_slices<D, NT>(s, dp, sRed, group, slice, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        const bool in = q0 + c < a.Sq && r0 + (e >> 1) * 8 < a.Sk;
        const float p = in ? expf(s[nt][e] * a.scale - sL[c]) : 0.0f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDl[c]);
      }
    pv_tile<NT, DT, LD>(dv, s, sG, d0, lane);   // dV += P^T dO
    pv_tile<NT, DT, LD>(dk, dp, sQ, d0, lane);  // dK += dS^T Q (scaled below)
  }
  store_acc<DT>(dk, a.scale, a.scale, a.dk + b * st[15] + h * st[17], st[16], r0, a.Sk, d0, t);
  store_acc<DT>(dv, 1.0f, 1.0f, a.dv + b * st[18] + h * st[20], st[19], r0, a.Sk, d0, t);
}

template <int D, bool VEC>
__global__ void __launch_bounds__(32 * BwdTiling<D>::WARPS)
flash_bwd_dq_mma_kernel(const BwdArgs<__nv_bfloat16> a) {
  using Tl = BwdTiling<D>;
  using Sm = BwdSmem<D>;
  constexpr int NTHREADS = 32 * Tl::WARPS, BK = Tl::BT, LD = Sm::LD;
  constexpr int DW = D / Tl::D_SLICES, NT = BK / 8, KC = DW / 16, DT = DW / 8;
  static_assert(Tl::ROW_GROUPS * Tl::D_SLICES == Tl::WARPS, "warps tile rows x head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LD]
  __nv_bfloat16* sV = sK + BK * LD;                                  // [BK][LD]
  float* sRed = reinterpret_cast<float*>(smem_raw + Sm::tile_bytes);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp / Tl::D_SLICES, slice = warp % Tl::D_SLICES, d0 = slice * DW;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const __nv_bfloat16* qb = a.q + b * st[0] + h * st[2];
  const __nv_bfloat16* kb = a.k + b * st[3] + h * st[5];
  const __nv_bfloat16* vb = a.v + b * st[6] + h * st[8];
  const __nv_bfloat16* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int r0 = (blockIdx.x * Tl::ROW_GROUPS + group) * 16 + g;  // this lane's queries r0, r0 + 8

  uint32_t qa[KC][4], ga[KC][4];
  load_a_frags<KC>(qa, qb, r0, a.Sq, st[1], d0, t);
  load_a_frags<KC>(ga, gb, r0, a.Sq, st[10], d0, t);
  const bool in0 = r0 < a.Sq, in1 = r0 + 8 < a.Sq;
  const float lse0 = in0 ? lb[r0] : 0.0f, lse1 = in1 ? lb[r0 + 8] : 0.0f;
  const float dl0 = in0 ? db[r0] : 0.0f, dl1 = in1 ? db[r0 + 8] : 0.0f;
  float dq[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) dq[dt][0] = dq[dt][1] = dq[dt][2] = dq[dt][3] = 0.0f;

  for (int k0 = 0; k0 < a.Sk; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    stage_pair<D, BK, LD, NTHREADS, VEC>(sK, sV, kb, vb, st[4], st[7], k0, a.Sk);
    __syncthreads();
    float s[NT][4], dp[NT][4];
    qk_tile<NT, KC, LD>(s, qa, sK, d0, g, t);   // S: queries x keys
    qk_tile<NT, KC, LD>(dp, ga, sV, d0, g, t);  // dP = dO V^T
    if constexpr (Tl::D_SLICES > 1) sum_slices<D, NT>(s, dp, sRed, group, slice, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi = e >> 1;
        const bool in = k0 + nt * 8 + 2 * t + (e & 1) < a.Sk && (hi ? in1 : in0);
        const float p = in ? expf(s[nt][e] * a.scale - (hi ? lse1 : lse0)) : 0.0f;
        s[nt][e] = p * (dp[nt][e] - (hi ? dl1 : dl0));
      }
    pv_tile<NT, DT, LD>(dq, s, sK, d0, lane);  // dQ += dS K (scaled below)
  }
  store_acc<DT>(dq, a.scale, a.scale, a.dq + b * st[12] + h * st[14], st[13], r0, a.Sq, d0, t);
}

// ---------------------------------------------------------------------------
// f32, scalar
// ---------------------------------------------------------------------------

constexpr int kBwdD = 64, kBwdTile = 64, kBwdThreads = 256;
constexpr int kDP = kBwdD + 1, kTP = kBwdTile + 1;  // padded rows: conflict-free reads

// acc[i][j] += sum_k A[r_i * a_r + k * a_k] * B[c_j * b_c + k * b_k] for this
// thread's rows r_i = rg + 16 i and columns c_j = cg + 16 j of a 64 x 64 tile.
template <int K>
__device__ __forceinline__ void smem_gemm64(float (&acc)[4][4], const float* A, int a_r, int a_k,
                                            const float* B, int b_c, int b_k, int rg, int cg) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(rg + 16 * i) * a_r + k * a_k];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = B[(cg + 16 * j) * b_c + k * b_k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// rows [r0, r0 + 64) of two (seq, 64) slices into [row][kDP] tiles; zeros past n.
__device__ __forceinline__ void stage_pair_f32(float* sA, float* sB, const float* a,
                                               const float* b, long long a_ss, long long b_ss,
                                               int r0, int n) {
  for (int i = threadIdx.x; i < kBwdTile * kBwdD; i += kBwdThreads) {
    const int r = i / kBwdD, d = i % kBwdD, row = r0 + r;
    sA[r * kDP + d] = row < n ? a[(long long)row * a_ss + d] : 0.0f;
    sB[r * kDP + d] = row < n ? b[(long long)row * b_ss + d] : 0.0f;
  }
}

__device__ __forceinline__ void zero44(float (&x)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[i][j] = 0.0f;
}

__device__ __forceinline__ void store44(const float (&x)[4][4], float mult, float* out,
                                        long long o_ss, int r0, int n, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + rg + 16 * i;
    if (row >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(long long)row * o_ss + cg + 16 * j] = x[i][j] * mult;
  }
}

constexpr size_t kDkvF32Smem = sizeof(float) * (6 * kBwdTile * kDP + 2 * kBwdTile);
constexpr size_t kDqF32Smem = sizeof(float) * (5 * kBwdTile * kDP + 2 * kBwdTile);

__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dkv_f32_kernel(const BwdArgs<float> a) {
  constexpr int D = kBwdD, T = kBwdTile;
  extern __shared__ float smem[];
  float* sK = smem;            // [T][kDP]
  float* sV = sK + T * kDP;    // [T][kDP]
  float* sQ = sV + T * kDP;    // [T][kDP]
  float* sG = sQ + T * kDP;    // [T][kDP]
  float* sP = sG + T * kDP;    // [key][kTP]  P^T
  float* sS = sP + T * kDP;    // [key][kTP]  dS^T
  float* sL = sS + T * kDP;    // [T]
  float* sDl = sL + T;         // [T]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[2];
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
  const float* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int k0 = blockIdx.x * T;

  stage_pair_f32(sK, sV, kb, vb, st[4], st[7], k0, a.Sk);
  float dk[4][4], dv[4][4];
  zero44(dk);
  zero44(dv);
  for (int q0 = 0; q0 < a.Sq; q0 += T) {
    __syncthreads();  // the previous tile's reads are done
    stage_pair_f32(sQ, sG, qb, gb, st[1], st[10], q0, a.Sq);
    if (tid < T) {
      const bool in = q0 + tid < a.Sq;
      sL[tid] = in ? lb[q0 + tid] : 0.0f;
      sDl[tid] = in ? db[q0 + tid] : 0.0f;
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    zero44(s);
    zero44(dp);
    smem_gemm64<D>(s, sK, kDP, 1, sQ, kDP, 1, rg, cg);   // S^T[key][q]
    smem_gemm64<D>(dp, sV, kDP, 1, sG, kDP, 1, rg, cg);  // dP^T[key][q]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + 16 * i, c = cg + 16 * j;
        const bool in = k0 + r < a.Sk && q0 + c < a.Sq;
        const float p = in ? expf(s[i][j] * a.scale - sL[c]) : 0.0f;
        sP[r * kTP + c] = p;
        sS[r * kTP + c] = p * (dp[i][j] - sDl[c]);
      }
    __syncthreads();
    smem_gemm64<T>(dv, sP, kTP, 1, sG, 1, kDP, rg, cg);  // dV[key][d] += P^T[key][q] dO[q][d]
    smem_gemm64<T>(dk, sS, kTP, 1, sQ, 1, kDP, rg, cg);  // dK[key][d] += dS^T[key][q] Q[q][d]
  }
  store44(dk, a.scale, a.dk + b * st[15] + h * st[17], st[16], k0, a.Sk, rg, cg);
  store44(dv, 1.0f, a.dv + b * st[18] + h * st[20], st[19], k0, a.Sk, rg, cg);
}

__global__ void __launch_bounds__(kBwdThreads) flash_bwd_dq_f32_kernel(const BwdArgs<float> a) {
  constexpr int D = kBwdD, T = kBwdTile;
  extern __shared__ float smem[];
  float* sQ = smem;            // [T][kDP]
  float* sG = sQ + T * kDP;    // [T][kDP]
  float* sK = sG + T * kDP;    // [T][kDP]
  float* sV = sK + T * kDP;    // [T][kDP]
  float* sS = sV + T * kDP;    // [q][kTP]  dS
  float* sL = sS + T * kDP;    // [T]
  float* sDl = sL + T;         // [T]

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[2];
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
  const float* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int q0 = blockIdx.x * T;

  stage_pair_f32(sQ, sG, qb, gb, st[1], st[10], q0, a.Sq);
  if (tid < T) {
    const bool in = q0 + tid < a.Sq;
    sL[tid] = in ? lb[q0 + tid] : 0.0f;
    sDl[tid] = in ? db[q0 + tid] : 0.0f;
  }
  float dq[4][4];
  zero44(dq);
  for (int k0 = 0; k0 < a.Sk; k0 += T) {
    __syncthreads();  // the previous tile's reads are done
    stage_pair_f32(sK, sV, kb, vb, st[4], st[7], k0, a.Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero44(s);
    zero44(dp);
    smem_gemm64<D>(s, sQ, kDP, 1, sK, kDP, 1, rg, cg);   // S[q][key]
    smem_gemm64<D>(dp, sG, kDP, 1, sV, kDP, 1, rg, cg);  // dP[q][key]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + 16 * i, c = cg + 16 * j;
        const bool in = q0 + r < a.Sq && k0 + c < a.Sk;
        const float p = in ? expf(s[i][j] * a.scale - sL[r]) : 0.0f;
        sS[r * kTP + c] = p * (dp[i][j] - sDl[r]);
      }
    __syncthreads();
    smem_gemm64<T>(dq, sS, kTP, 1, sK, 1, kDP, rg, cg);  // dQ[q][d] += dS[q][key] K[key][d]
  }
  store44(dq, a.scale, a.dq + b * st[12] + h * st[14], st[13], q0, a.Sq, rg, cg);
}

// f32 at D = 512: the 64 x 64 register tiles above would need 64 KB a
// staged operand, so the tiles shrink to 16 rows of the block's own side and
// 32 of the other side, each row whole in shared memory (197 KB). Of the 256
// threads, thread (r, c) = (tid / 16, tid % 16) computes the logits of own
// row r against other rows c and c + 16 (a 512-long dot product each), and
// owns head-dim columns c + 16 j (j < 32) of own row r's gradient.
constexpr int kW = 512, kWP = kW + 1, kOwn = 16, kOther = 32, kOtherP = kOther + 1;
constexpr int kWCols = kW / 16;  // gradient columns a thread owns
constexpr size_t kDkv512F32Smem =
    sizeof(float) * (2 * kOwn * kWP + 2 * kOther * kWP + 2 * kOwn * kOtherP + 2 * kOther);
constexpr size_t kDq512F32Smem =
    sizeof(float) * (2 * kOwn * kWP + 2 * kOther * kWP + kOwn * kOtherP + 2 * kOwn);

// rows [r0, r0 + rows) of two (seq, 512) slices into [row][kWP] tiles; zeros past n.
__device__ __forceinline__ void stage_rows512(float* sA, float* sB, const float* a, const float* b,
                                              long long a_ss, long long b_ss, int r0, int n,
                                              int rows) {
  for (int i = threadIdx.x; i < rows * kW; i += kBwdThreads) {
    const int r = i / kW, d = i % kW, row = r0 + r;
    sA[r * kWP + d] = row < n ? a[(long long)row * a_ss + d] : 0.0f;
    sB[r * kWP + d] = row < n ? b[(long long)row * b_ss + d] : 0.0f;
  }
}

// (A[r] . B[c], A[r] . B[c + 16], C[r] . E[c], C[r] . E[c + 16]) over 512 dims.
__device__ __forceinline__ void dots512(float (&out)[4], const float* A, const float* B,
                                        const float* C, const float* E, int r, int c) {
  out[0] = out[1] = out[2] = out[3] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < kW; ++d) {
    const float x = A[r * kWP + d], y = C[r * kWP + d];
    out[0] = fmaf(x, B[c * kWP + d], out[0]);
    out[1] = fmaf(x, B[(c + 16) * kWP + d], out[1]);
    out[2] = fmaf(y, E[c * kWP + d], out[2]);
    out[3] = fmaf(y, E[(c + 16) * kWP + d], out[3]);
  }
}

__device__ __forceinline__ void store_row512(const float (&x)[kWCols], float mult, float* out,
                                             long long o_ss, int row, int n, int c) {
  if (row >= n) return;
#pragma unroll
  for (int j = 0; j < kWCols; ++j) out[(long long)row * o_ss + c + 16 * j] = x[j] * mult;
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_f32_d512_kernel(const BwdArgs<float> a) {
  extern __shared__ float smem[];
  float* sK = smem;                 // [kOwn][kWP]
  float* sV = sK + kOwn * kWP;      // [kOwn][kWP]
  float* sQ = sV + kOwn * kWP;      // [kOther][kWP]
  float* sG = sQ + kOther * kWP;    // [kOther][kWP]
  float* sP = sG + kOther * kWP;    // [key][kOtherP]  P^T
  float* sS = sP + kOwn * kOtherP;  // [key][kOtherP]  dS^T
  float* sL = sS + kOwn * kOtherP;  // [kOther]
  float* sDl = sL + kOther;         // [kOther]

  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[2];
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
  const float* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int k0 = blockIdx.x * kOwn;

  stage_rows512(sK, sV, kb, vb, st[4], st[7], k0, a.Sk, kOwn);
  float dk[kWCols], dv[kWCols];
#pragma unroll
  for (int j = 0; j < kWCols; ++j) dk[j] = dv[j] = 0.0f;
  for (int q0 = 0; q0 < a.Sq; q0 += kOther) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows512(sQ, sG, qb, gb, st[1], st[10], q0, a.Sq, kOther);
    if (tid < kOther) {
      const bool in = q0 + tid < a.Sq;
      sL[tid] = in ? lb[q0 + tid] : 0.0f;
      sDl[tid] = in ? db[q0 + tid] : 0.0f;
    }
    __syncthreads();
    float x[4];  // S^T[r][c], S^T[r][c + 16], dP^T[r][c], dP^T[r][c + 16]
    dots512(x, sK, sQ, sV, sG, r, c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cc = c + 16 * i;
      const bool in = k0 + r < a.Sk && q0 + cc < a.Sq;
      const float p = in ? expf(x[i] * a.scale - sL[cc]) : 0.0f;
      sP[r * kOtherP + cc] = p;
      sS[r * kOtherP + cc] = p * (x[2 + i] - sDl[cc]);
    }
    __syncthreads();
#pragma unroll 4
    for (int q = 0; q < kOther; ++q) {
      const float p = sP[r * kOtherP + q], ds = sS[r * kOtherP + q];
#pragma unroll
      for (int j = 0; j < kWCols; ++j) {
        dv[j] = fmaf(p, sG[q * kWP + c + 16 * j], dv[j]);   // dV += P^T dO
        dk[j] = fmaf(ds, sQ[q * kWP + c + 16 * j], dk[j]);  // dK += dS^T Q
      }
    }
  }
  store_row512(dk, a.scale, a.dk + b * st[15] + h * st[17], st[16], k0 + r, a.Sk, c);
  store_row512(dv, 1.0f, a.dv + b * st[18] + h * st[20], st[19], k0 + r, a.Sk, c);
}

__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32_d512_kernel(const BwdArgs<float> a) {
  extern __shared__ float smem[];
  float* sQ = smem;                 // [kOwn][kWP]
  float* sG = sQ + kOwn * kWP;      // [kOwn][kWP]
  float* sK = sG + kOwn * kWP;      // [kOther][kWP]
  float* sV = sK + kOther * kWP;    // [kOther][kWP]
  float* sS = sV + kOther * kWP;    // [query][kOtherP]  dS
  float* sL = sS + kOwn * kOtherP;  // [kOwn]
  float* sDl = sL + kOwn;           // [kOwn]

  const int tid = threadIdx.x, r = tid / 16, c = tid % 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const long long* st = a.st;
  const float* qb = a.q + b * st[0] + h * st[2];
  const float* kb = a.k + b * st[3] + h * st[5];
  const float* vb = a.v + b * st[6] + h * st[8];
  const float* gb = a.g + b * st[9] + h * st[11];
  const float* lb = a.lse + b * a.l_sb + h * a.l_sh;
  const float* db = a.delta + b * a.l_sb + h * a.l_sh;
  const int q0 = blockIdx.x * kOwn;

  stage_rows512(sQ, sG, qb, gb, st[1], st[10], q0, a.Sq, kOwn);
  if (tid < kOwn) {
    const bool in = q0 + tid < a.Sq;
    sL[tid] = in ? lb[q0 + tid] : 0.0f;
    sDl[tid] = in ? db[q0 + tid] : 0.0f;
  }
  float dq[kWCols];
#pragma unroll
  for (int j = 0; j < kWCols; ++j) dq[j] = 0.0f;
  for (int k0 = 0; k0 < a.Sk; k0 += kOther) {
    __syncthreads();  // the previous tile's reads are done
    stage_rows512(sK, sV, kb, vb, st[4], st[7], k0, a.Sk, kOther);
    __syncthreads();
    float x[4];  // S[r][c], S[r][c + 16], dP[r][c], dP[r][c + 16]
    dots512(x, sQ, sK, sG, sV, r, c);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int cc = c + 16 * i;
      const bool in = q0 + r < a.Sq && k0 + cc < a.Sk;
      const float p = in ? expf(x[i] * a.scale - sL[r]) : 0.0f;
      sS[r * kOtherP + cc] = p * (x[2 + i] - sDl[r]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kOther; ++kk) {
      const float ds = sS[r * kOtherP + kk];
#pragma unroll
      for (int j = 0; j < kWCols; ++j) dq[j] = fmaf(ds, sK[kk * kWP + c + 16 * j], dq[j]);
    }
  }
  store_row512(dq, a.scale, a.dq + b * st[12] + h * st[14], st[13], q0 + r, a.Sq, c);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
static BwdArgs<T> make_args(const void* q, const void* k, const void* v, const void* g,
                            const float* lse, const float* delta, void* dq, void* dk, void* dv,
                            int H, int Sq, int Sk, const long long* strides,
                            const long long* lse_strides, float scale) {
  BwdArgs<T> a;
  a.q = static_cast<const T*>(q);
  a.k = static_cast<const T*>(k);
  a.v = static_cast<const T*>(v);
  a.g = static_cast<const T*>(g);
  a.lse = lse;
  a.delta = delta;
  a.dq = static_cast<T*>(dq);
  a.dk = static_cast<T*>(dk);
  a.dv = static_cast<T*>(dv);
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int i = 0; i < 21; ++i) a.st[i] = strides[i];
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.scale = scale;
  return a;
}

template <typename Kern, typename Args>
static cudaError_t launch(Kern kern, const Args& a, int tiles, int BH, int threads, size_t smem,
                          cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(tiles, BH), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int D, bool VEC>
static cudaError_t launch_mma(bool dkv, const BwdArgs<__nv_bfloat16>& a, int BH, cudaStream_t st) {
  using Tl = BwdTiling<D>;
  constexpr int rows = 16 * Tl::ROW_GROUPS, threads = 32 * Tl::WARPS;
  const int tiles = ((dkv ? a.Sk : a.Sq) + rows - 1) / rows;
  return dkv ? launch(flash_bwd_dkv_mma_kernel<D, VEC>, a, tiles, BH, threads, BwdSmem<D>::dkv_bytes, st)
             : launch(flash_bwd_dq_mma_kernel<D, VEC>, a, tiles, BH, threads, BwdSmem<D>::dq_bytes, st);
}

static int flash_bwd(bool dkv, const void* q, const void* k, const void* v, const void* g,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv, int dtype,
                     int B, int H, int Sq, int Sk, int D, const long long* strides,
                     const long long* lse_strides, float scale, int route, void* stream) {
  if (D != 64 && D != 512) return (int)cudaErrorInvalidValue;
  if (route == kRouteWgmma) {
    if (dtype != kBF16 || D != 64) return (int)cudaErrorInvalidValue;
    return flash_bwd_sm90(dkv, q, k, v, g, lse, delta, dq, dk, dv, B, H, Sq, Sk, strides,
                          lse_strides, scale, stream);
  }
  if (route != kRouteMma) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const auto a = make_args<float>(q, k, v, g, lse, delta, dq, dk, dv, H, Sq, Sk, strides,
                                    lse_strides, scale);
    if (D == 512) {
      const int tiles = ((dkv ? Sk : Sq) + kOwn - 1) / kOwn;
      return dkv ? launch(flash_bwd_dkv_f32_d512_kernel, a, tiles, B * H, kBwdThreads,
                          kDkv512F32Smem, st)
                 : launch(flash_bwd_dq_f32_d512_kernel, a, tiles, B * H, kBwdThreads,
                          kDq512F32Smem, st);
    }
    const int tiles = ((dkv ? Sk : Sq) + kBwdTile - 1) / kBwdTile;
    return dkv ? launch(flash_bwd_dkv_f32_kernel, a, tiles, B * H, kBwdThreads, kDkvF32Smem, st)
               : launch(flash_bwd_dq_f32_kernel, a, tiles, B * H, kBwdThreads, kDqF32Smem, st);
  }
  if (dtype == kBF16) {
    const auto a = make_args<__nv_bfloat16>(q, k, v, g, lse, delta, dq, dk, dv, H, Sq, Sk,
                                            strides, lse_strides, scale);
    // D = 64 comes here only for views TMA cannot read: element-wise staging
    if (D == 64) return launch_mma<64, false>(dkv, a, B * H, st);
    // the staged side: q and dO for dK/dV, k and v for dQ
    const bool vec = dkv ? rows_aligned16(q, strides) && rows_aligned16(g, strides + 9)
                         : rows_aligned16(k, strides + 3) && rows_aligned16(v, strides + 6);
    return vec ? launch_mma<512, true>(dkv, a, B * H, st) : launch_mma<512, false>(dkv, a, B * H, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace t2v

extern "C" {

// q, dq: (B, Sq, H, D); k, v, dk, dv: (B, Sk, H, D); g = dO: (B, Sq, H, D);
// all addressed by element strides st = [sb, ss, sh] of q, k, v, g, dq, dk,
// dv (21 values) with a contiguous last dimension; lse and delta: (B, H, Sq)
// f32 at strides lse_strides = [l_sb, l_sh] with a contiguous sequence.
// D must be 64 or 512. route: kRouteWgmma (bf16, D = 64, 16-byte aligned
// q, k, v, g with strides of multiples of 8 elements; refused otherwise) or
// kRouteMma. Writes dk and dv.
int t2v_flash_attention_bwd_dkv(const void* q, const void* k, const void* v, const void* g,
                                const float* lse, const float* delta, void* dk, void* dv,
                                int dtype, int B, int H, int Sq, int Sk, int D,
                                const long long* strides, const long long* lse_strides,
                                float scale, int route, void* stream) {
  return t2v::flash_bwd(true, q, k, v, g, lse, delta, nullptr, dk, dv, dtype, B, H, Sq, Sk, D,
                        strides, lse_strides, scale, route, stream);
}

// As t2v_flash_attention_bwd_dkv; writes dq.
int t2v_flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* g,
                               const float* lse, const float* delta, void* dq, int dtype, int B,
                               int H, int Sq, int Sk, int D, const long long* strides,
                               const long long* lse_strides, float scale, int route,
                               void* stream) {
  return t2v::flash_bwd(false, q, k, v, g, lse, delta, dq, nullptr, nullptr, dtype, B, H, Sq, Sk,
                        D, strides, lse_strides, scale, route, stream);
}

}  // extern "C"
