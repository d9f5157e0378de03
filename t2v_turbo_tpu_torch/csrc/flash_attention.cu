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
// stops mattering and the arithmetic decides. The wrapper picks a route
// (ops/attention.py::flash_route) and passes the kernels' route code in:
// - wgmma (bf16 at D = 64 or 512, tensors TMA can read, scale > 0: every
//   call of the UNet, ViCLIP and the VAE's mid block): flash_attention_sm90.cu,
//   wgmma products fed by TMA.
// - staged (bf16 at D = 64 on views TMA cannot read, or at a scale <= 0):
//   flash_attention_sm90.cu, the same wgmma consumers fed by a producer
//   warpgroup that realigns each row in registers.
// - packed (bf16 at D = 512 on views TMA cannot read, or at a scale <= 0):
//   no code of its own here: the wrapper packs those views into contiguous
//   copies (pack_bshd.cu; Q negated or zeroed for a scale < 0 or 0) and
//   passes the wgmma code.
// - f32 (below): scalar f32 FMAs out of shared memory, exact enough to hold
//   against the plain f32 math. Each thread owns a small register tile of
//   the logits and of the output, so every shared-memory load feeds several
//   FMAs; shared-memory bandwidth is the limit it hits. The TPU kernel's
//   sequential K grid axis becomes a loop in the block:
//   - one block per (batch*head, tile of queries);
//   - per tile of keys: stage K and V in shared memory, compute the logits,
//     update the running max m, sum l and the f32 output accumulator
//     (registers), as the TPU kernel's (m, l, acc) scratch;
//   - keys past Sk get the reference's mask value, queries past Sq are
//     computed on zeros and not stored, so any S works without padding
//     copies;
//   - q, k, v and o are addressed through (batch, seq, head) strides with a
//     contiguous head dimension, so the (B, S, H, D) output of the q/k/v
//     Linears needs no transpose; lse is (B, H, Sq) f32 with (batch, head)
//     strides and a contiguous sequence.
//   Tilings (256 threads): D = 64 (BQ = BK = 64, 66 KB of shared memory)
//   and D = 512 (BQ = BK = 32, 197 KB, one block per SM); both need dynamic
//   shared memory above 48 KB, so cudaFuncSetAttribute.
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
  // the f32 code takes f32 alone: bf16 has no kernel of its own there
  if (route != kRouteF32 || dtype != kF32) return (int)cudaErrorInvalidValue;
  return launch_flash_scalar(q, k, v, o, lse, B, H, Sq, Sk, D, strides, lse_strides, scale,
                             static_cast<cudaStream_t>(stream));
}

}  // namespace t2v

extern "C" {

// q: (B, Sq, H, D), k/v: (B, Sk, H, D), o: (B, Sq, H, D), all addressed by
// element strides st = [q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
// o_sb, o_ss, o_sh] with a contiguous last dimension, then (read by the
// staged route alone) the head-dim strides of q, k, v and o. D must be 64 or
// 512. route: kRouteWgmma (bf16, scale > 0, 16-byte aligned q, k, v with
// strides of multiples of 8 elements; refused otherwise), kRouteStaged (bf16,
// D = 64, any finite scale; refused otherwise) or kRouteF32 (f32; bf16 is
// refused).
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
