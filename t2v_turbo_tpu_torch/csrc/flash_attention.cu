// Flash-attention forward for Hopper: softmax(q k^T * scale) v with an online
// softmax, never materialising the (Sq, Sk) logits in device memory, and
// optionally the per-row log-sum-exp that the backward needs.
//
// Replaces the Pallas TPU kernels t2v_turbo_tpu/ops/attention.py::
// _flash_fwd_kernel (entry flash_attention, implementation
// _flash_attention_fwd_impl; "B1") and _flash_fwd_kernel_lse (the custom
// VJP's forward rule, implementation _flash_attention_fwd_lse_impl; "B2").
// One kernel template serves both: a null `lse` pointer gives B1, a non-null
// one B2, which also writes lse = m + log(l) per query row in f32. The
// (B, S, H, D) strides make it the BSHD family's forward too (B6: the TPU's
// _flash_fwd_kernel_bshd and _flash_fwd_kernel_bshd_lse).
// On the main path B1 runs the VC2 UNet's spatial self-attention at S =
// 2560, 640 and 160 and its cross-attention to 77 text tokens (heads of 64),
// and the VAE's mid-block attention (S = 2560, one head of 512); in training
// B2 runs every UNet attention of the student's gradient-carrying forward
// (the temporal and the middle block's too).
//
// What bounds it on the H100: the plain version writes and reads the f32
// logits, 2.1 GB per level-0 call; this kernel reads q, k, v once per query
// tile and writes o (and 4 bytes of lse a row) once, so device-memory traffic
// stops mattering and the arithmetic decides. Three routes do that
// arithmetic; the wrapper picks one (ops/attention.py::flash_route) and
// passes it in:
// - wgmma (bf16 at D = 64 or 512, tensors TMA can read, scale > 0: every
//   call of the UNet, ViCLIP and the VAE's mid block): flash_attention_sm90.cu,
//   wgmma products fed by TMA.
// - staged (bf16 at D = 64 on views TMA cannot read, or at a scale <= 0):
//   flash_attention_sm90.cu, the same wgmma consumers fed by a producer
//   warpgroup that realigns each row in registers.
// - mma (bf16 at D = 512 on views that TMA cannot read, or at a scale <= 0):
//   tensor cores through mma.sync.m16n8k16 in FlashAttention-2's register
//   layout (flash_mma.cuh), below.
// - f32: scalar f32 FMAs out of shared memory, exact enough to hold against
//   the plain f32 math. Each thread owns a small register tile of the logits
//   and of the output, so every shared-memory load feeds several FMAs;
//   shared-memory bandwidth is the limit it hits.
//
// Common to the mma and f32 routes (the TPU kernel's sequential K grid axis
// becomes a loop in the block):
// - one block per (batch*head, tile of queries);
// - per tile of keys: stage K and V in shared memory, compute the logits,
//   update the running max m, sum l and the f32 output accumulator
//   (registers), as the TPU kernel's (m, l, acc) scratch;
// - the probabilities are rounded to the input dtype before the P.V product
//   (bf16 on the tensor-core path), as the reference casts them to v's dtype;
// - keys past Sk get the reference's mask value, queries past Sq are computed
//   on zeros and not stored, so any S works without padding copies;
// - q, k, v and o are addressed through (batch, seq, head) strides with a
//   contiguous head dimension, so the (B, S, H, D) output of the q/k/v
//   Linears needs no transpose; lse is (B, H, Sq) f32 with (batch, head)
//   strides and a contiguous sequence.
// Scalar tilings (256 threads): D = 64 (BQ = BK = 64, 66 KB of shared memory)
// and D = 512 (BQ = BK = 32, 197 KB, one block per SM); both need dynamic
// shared memory above 48 KB, so cudaFuncSetAttribute.
#include "flash_mma.cuh"

namespace t2v {

int flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                   int Sq, int Sk, int D, const long long* strides, const long long* lse_strides,
                   float scale, void* stream);
int flash_fwd_staged_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
                          int Sq, int Sk, int D, const long long* strides, const long long* lse_strides,
                          float scale, void* stream);

constexpr int kFlashThreads = 256;

template <int D, int BQ, int BK>
struct FlashSmem {
  static constexpr int DP = D + 1;    // padded rows: conflict-free column reads
  static constexpr int BKP = BK + 1;
  static constexpr int floats = BQ * DP + BK * DP + BK * D + BQ * BKP + 3 * BQ;
  static constexpr size_t bytes = sizeof(float) * (size_t)floats;
};

// f32, scalar: SR x SC logits and OR x OC outputs per thread.
template <int D, int BQ, int BK, int SR, int SC, int OR, int OC>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 int H, int Sq, int Sk, long long q_sb, long long q_ss, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                 long long v_sh, long long o_sb, long long o_ss, long long o_sh, long long l_sb,
                 long long l_sh, float scale) {
  using Smem = FlashSmem<D, BQ, BK>;
  constexpr int DP = Smem::DP, BKP = Smem::BKP;
  constexpr int SCG = BK / SC;                 // logit column groups
  constexpr int SRG = kFlashThreads / SCG;     // logit row groups
  constexpr int OCG = D / OC;                  // output column groups
  constexpr int ORG = kFlashThreads / OCG;     // output row groups
  constexpr int TPR = kFlashThreads / BQ;      // softmax threads per row
  static_assert(SRG * SR == BQ, "logit tiling must cover BQ");
  static_assert(ORG * OR == BQ, "output tiling must cover BQ");
  static_assert(TPR * BQ == kFlashThreads && TPR <= 32 && (32 % TPR) == 0,
                "softmax row groups must sit inside a warp");

  extern __shared__ float smem[];
  float* sQ = smem;             // [BQ][DP]
  float* sK = sQ + BQ * DP;     // [BK][DP]
  float* sV = sK + BK * DP;     // [BK][D]
  float* sS = sV + BK * D;      // [BQ][BKP]  logits, then probabilities
  float* sM = sS + BQ * BKP;    // [BQ] running max
  float* sL = sM + BQ;          // [BQ] running sum
  float* sA = sL + BQ;          // [BQ] rescale factor of this K tile

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  float* ob = o + b * o_sb + h * o_sh;

  for (int i = tid; i < BQ * D; i += kFlashThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    sQ[r * DP + d] = qi < Sq ? qb[(long long)qi * q_ss + d] : 0.0f;
  }
  if (tid < BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.0f;
  }

  const int s_cg = tid % SCG, s_rg = tid / SCG;
  const int o_cg = tid % OCG, o_rg = tid / OCG;
  float acc[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.0f;

  const int n_kt = (Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's sK/sV/sS reads are done
    for (int i = tid; i < BK * D; i += kFlashThreads) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (ki < Sk) {
        kv = kb[(long long)ki * k_ss + d];
        vv = vb[(long long)ki * v_ss + d];
      }
      sK[r * DP + d] = kv;
      sV[r * D + d] = vv;
    }
    __syncthreads();

    // logits tile: rows s_rg + i*SRG, columns s_cg + j*SCG
    float s[SR][SC];
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[SR], kv[SC];
#pragma unroll
      for (int i = 0; i < SR; ++i) qv[i] = sQ[(s_rg + i * SRG) * DP + d];
#pragma unroll
      for (int j = 0; j < SC; ++j) kv[j] = sK[(s_cg + j * SCG) * DP + d];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < SR; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int col = s_cg + j * SCG;
        sS[(s_rg + i * SRG) * BKP + col] = (k0 + col < Sk) ? s[i][j] * scale : kMaskValue;
      }
    __syncthreads();

    // online softmax, TPR neighbouring lanes per row
    {
      const int row = tid / TPR, sub = tid % TPR;
      const float m_prev = sM[row];
      float mx = -INFINITY;
      for (int c = sub; c < BK; c += TPR) mx = fmaxf(mx, sS[row * BKP + c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = sub; c < BK; c += TPR) {
        const float p = expf(sS[row * BKP + c] - m_next);
        sum += p;
        sS[row * BKP + c] = p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (sub == 0) {
        const float alpha = expf(m_prev - m_next);
        sA[row] = alpha;
        sL[row] = sL[row] * alpha + sum;
        sM[row] = m_next;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V: rows o_rg + i*ORG, columns o_cg + j*OCG
#pragma unroll
    for (int i = 0; i < OR; ++i) {
      const float a = sA[o_rg + i * ORG];
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[OR], vv[OC];
#pragma unroll
      for (int i = 0; i < OR; ++i) pv[i] = sS[(o_rg + i * ORG) * BKP + c];
#pragma unroll
      for (int j = 0; j < OC; ++j) vv[j] = sV[c * D + o_cg + j * OCG];
#pragma unroll
      for (int i = 0; i < OR; ++i)
#pragma unroll
        for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int r = o_rg + i * ORG;
    const int qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = sL[r];
    float* orow = ob + (long long)qi * o_ss;
#pragma unroll
    for (int j = 0; j < OC; ++j) orow[o_cg + j * OCG] = acc[i][j] / l;
  }
  if (lse != nullptr && tid < BQ && q0 + tid < Sq)
    lse[b * l_sb + h * l_sh + q0 + tid] = sM[tid] + logf(sL[tid]);
}

// ---------------------------------------------------------------------------
// The mma route: bf16 on mma.sync.m16n8k16 (bf16 in, f32 accumulate), in
// FlashAttention-2's register layout (flash_mma.cuh). Per tile of keys, K
// and V are staged in shared memory row-major ([key][d], rows padded by 8
// elements so fragment loads and ldmatrix rows fall in distinct banks),
// element by element, since the views this route takes need not be aligned
// (an aligned one comes only with a scale <= 0). The logits accumulate
// in registers (K fragments by 32-bit loads), the softmax runs on them (each
// query row is spread over the 4 lanes of a quad), and the probabilities,
// rounded to bf16, are reused in registers as the A operand of P.V, whose B
// fragments come from V through ldmatrix.trans. Each lane keeps a partial
// row sum, reduced once at the end. No pipelining: loads and math alternate.
// Head dim 512 only (D = 64 takes the staged route): a warp's 16 x 512 f32
// accumulators would not fit its registers, so 8 warps take 32 queries: two
// groups of 16 rows, and within each, 4 warps own a 128-wide slice of the
// head dim. Each warp computes partial logits over its slice; the 4
// partials are summed through shared memory in a fixed order, so the 4 warps
// of a row group hold the same logits and softmax.
// ---------------------------------------------------------------------------

// Online-softmax update of one logits tile held in mma C-fragments: scale,
// mask keys >= Sk, new running max per row (rows g and g+8 of the warp),
// probabilities in place, partial row sums, and the output rescale.
template <int NT, int DT>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&acc)[DT][4], int k0, int t,
                                             int Sk, float scale, float& m0, float& m1, float& l0,
                                             float& l1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + 2 * t + (e & 1);
      const float val = col < Sk ? s[nt][e] * scale : kMaskValue;
      s[nt][e] = val;
      if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = expf(s[nt][0] - mn0);
    s[nt][1] = expf(s[nt][1] - mn0);
    s[nt][2] = expf(s[nt][2] - mn1);
    s[nt][3] = expf(s[nt][3] - mn1);
    rs0 += s[nt][0] + s[nt][1];
    rs1 += s[nt][2] + s[nt][3];
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    acc[dt][0] *= a0;
    acc[dt][1] *= a0;
    acc[dt][2] *= a1;
    acc[dt][3] *= a1;
  }
}

// Tile shape of the mma kernel (head dim 512) and its dynamic shared memory.
template <int D> struct MmaTiling;
template <> struct MmaTiling<512> {
  static constexpr int WARPS = 8, ROW_GROUPS = 2, D_SLICES = 4, BK = 32;
};

template <int D> struct MmaSmem {
  using Tl = MmaTiling<D>;
  static constexpr int LD = D + 8;                // K and V rows
  static constexpr int LDS = Tl::BK + 4;          // partial-logit rows
  static constexpr size_t kv_bytes = sizeof(__nv_bfloat16) * 2 * Tl::BK * LD;
  static constexpr size_t bytes = kv_bytes + sizeof(float) * Tl::WARPS * 16 * LDS;
};

template <int D>
__global__ void __launch_bounds__(32 * MmaTiling<D>::WARPS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int H, int Sq, int Sk, long long q_sb,
                     long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh, long long l_sb,
                     long long l_sh, float scale) {
  using Tl = MmaTiling<D>;
  using Sm = MmaSmem<D>;
  constexpr int NTHREADS = 32 * Tl::WARPS, BK = Tl::BK, LD = Sm::LD, LDS = Sm::LDS;
  constexpr int DW = D / Tl::D_SLICES;  // head-dim slice of one warp
  constexpr int NT = BK / 8, KC = DW / 16, DT = DW / 8;
  static_assert(Tl::ROW_GROUPS * Tl::D_SLICES == Tl::WARPS, "warps tile rows x head dim");
  static_assert(Sm::kv_bytes % 16 == 0, "smem carve alignment");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][LD]
  __nv_bfloat16* sV = sK + BK * LD;                                  // [BK][LD]
  float* sS = reinterpret_cast<float*>(smem_raw + Sm::kv_bytes);     // [slice][group][16][LDS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // quad row and lane-in-quad of the mma layout
  const int group = warp / Tl::D_SLICES, slice = warp % Tl::D_SLICES;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const int r0 = (blockIdx.x * Tl::ROW_GROUPS + group) * 16 + g;  // rows r0 and r0 + 8
  const int d0 = slice * DW;

  uint32_t qa[KC][4];
  load_a_frags<KC>(qa, qb, r0, Sq, q_ss, d0, t);
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    stage_pair<D, BK, LD, NTHREADS>(sK, sV, kb, vb, k_ss, v_ss, k0, Sk);
    __syncthreads();
    float s[NT][4];
    qk_tile<NT, KC, LD>(s, qa, sK, d0, g, t);
    // sum the slices' partial logits in a fixed order
    auto at = [&](int sl, int e, int nt) {
      return sS + ((sl * Tl::ROW_GROUPS + group) * 16 + g + (e >> 1) * 8) * LDS + nt * 8 +
             2 * t + (e & 1);
    };
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) *at(slice, e, nt) = s[nt][e];
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float tot = 0.0f;
#pragma unroll
        for (int sl = 0; sl < Tl::D_SLICES; ++sl) tot += *at(sl, e, nt);
        s[nt][e] = tot;
      }
    softmax_tile<NT, DT>(s, acc, k0, t, Sk, scale, m0, m1, l0, l1);
    pv_tile<NT, DT, LD>(acc, s, sV, d0, lane);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_acc<DT>(acc, 1.0f / l0, 1.0f / l1, o + b * o_sb + h * o_sh, o_ss, r0, Sq, d0, t);
  if (lse != nullptr && slice == 0 && t == 0) {
    float* lrow = lse + b * l_sb + h * l_sh;
    if (r0 < Sq) lrow[r0] = m0 + logf(l0);
    if (r0 + 8 < Sq) lrow[r0 + 8] = m1 + logf(l1);
  }
}

template <int D>
static cudaError_t launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                              const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B, int H,
                              int Sq, int Sk, const long long* st, const long long* lst,
                              float scale, cudaStream_t stream) {
  using Tl = MmaTiling<D>;
  const size_t smem = MmaSmem<D>::bytes;
  auto kern = flash_fwd_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int bq = 16 * Tl::ROW_GROUPS;
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, 32 * Tl::WARPS, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, st[0], st[1], st[2],
                                               st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                                               st[10], st[11], lst[0], lst[1], scale);
  return cudaGetLastError();
}

static cudaError_t launch_flash_mma(const void* q, const void* k, const void* v, void* o,
                                    float* lse, int B, int H, int Sq, int Sk, int D,
                                    const long long* st, const long long* lst, float scale,
                                    cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  // bf16 comes here only at D = 512, for views TMA cannot read (or a scale
  // <= 0), so K and V are staged element by element
  if (D == 512) return launch_mma<512>(qp, kp, vp, op, lse, B, H, Sq, Sk, st, lst, scale, stream);
  return cudaErrorInvalidValue;
}

template <int D, int BQ, int BK, int SR, int SC, int OR, int OC>
static cudaError_t launch_flash_f32(const float* q, const float* k, const float* v, float* o,
                                    float* lse, int B, int H, int Sq, int Sk, const long long* st,
                                    const long long* lst, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, BQ, BK, SR, SC, OR, OC>;
  const size_t smem = FlashSmem<D, BQ, BK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, kFlashThreads, smem, stream>>>(q, k, v, o, lse, H, Sq, Sk, st[0], st[1], st[2],
                                              st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                                              st[10], st[11], lst[0], lst[1], scale);
  return cudaGetLastError();
}

static cudaError_t launch_flash_scalar(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int H, int Sq, int Sk, int D,
                                       const long long* st, const long long* lst, float scale,
                                       cudaStream_t stream) {
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  auto* op = static_cast<float*>(o);
  if (D == 64)
    return launch_flash_f32<64, 64, 64, 4, 4, 4, 4>(qp, kp, vp, op, lse, B, H, Sq, Sk, st, lst,
                                                    scale, stream);
  if (D == 512)
    return launch_flash_f32<512, 32, 32, 2, 2, 4, 16>(qp, kp, vp, op, lse, B, H, Sq, Sk, st, lst,
                                                      scale, stream);
  return cudaErrorInvalidValue;
}

static int flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int dtype,
                     int B, int H, int Sq, int Sk, int D, const long long* strides,
                     const long long* lse_strides, float scale, int route, void* stream) {
  if (route == kRouteWgmma || route == kRouteStaged) {
    if (dtype != kBF16) return (int)cudaErrorInvalidValue;
    return (route == kRouteWgmma ? flash_fwd_sm90 : flash_fwd_staged_sm90)(q, k, v, o, lse, B, H, Sq, Sk, D,
                                                                         strides, lse_strides, scale, stream);
  }
  if (route != kRouteMma) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch_flash_scalar(q, k, v, o, lse, B, H, Sq, Sk, D, strides, lse_strides, scale, st);
  if (dtype == kBF16)
    return launch_flash_mma(q, k, v, o, lse, B, H, Sq, Sk, D, strides, lse_strides, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace t2v

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all addressed by
// element strides st = [q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
// o_sb, o_ss, o_sh] with a contiguous last dimension, then (read by the
// staged route alone) the head-dim strides of q, k, v and o. D must be 64 or
// 512. route: kRouteWgmma (bf16, scale > 0, 16-byte aligned q, k, v with
// strides of multiples of 8 elements; refused otherwise), kRouteStaged (bf16,
// D = 64, any finite scale; refused otherwise) or kRouteMma (f32; bf16 at
// D = 512).
int t2v_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                            int dtype, int B, int H, int Sq, int Sk, int D,
                            const long long* strides, float scale, int route, void* stream) {
  const long long no_lse[2] = {0, 0};
  return t2v::flash_fwd(q, k, v, o, nullptr, dtype, B, H, Sq, Sk, D, strides, no_lse, scale,
                        route, stream);
}

// As t2v_flash_attention_fwd, and lse: (B, H, Sq) f32 at element strides
// lse_strides = [l_sb, l_sh] with a contiguous sequence, = m + log(l) per row.
int t2v_flash_attention_fwd_lse(const void* q, const void* k, const void* v, void* o, float* lse,
                                int dtype, int B, int H, int Sq, int Sk, int D,
                                const long long* strides, const long long* lse_strides,
                                float scale, int route, void* stream) {
  return t2v::flash_fwd(q, k, v, o, lse, dtype, B, H, Sq, Sk, D, strides, lse_strides, scale,
                        route, stream);
}

}  // extern "C"
