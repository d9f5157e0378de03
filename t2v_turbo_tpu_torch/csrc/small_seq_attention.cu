// Short-sequence self-attention (B8) for Hopper: softmax(q k^T * scale) v
// for every (row, head) of (R, T, H, D) tensors, T <= 64 and D = 64: the
// UNet's temporal attention over 16 frames at every pixel.
//
// Replaces the Pallas TPU kernels tests_tpu/bench_small_seq_attention.py::
// _kernel_loop / _kernel_vec / _kernel_packed (entry small_seq_attention),
// three variants of one function; this is one kernel.
//
// Why not the flash kernel (flash_attention.cu): its 64-row query and key
// tiles spend 75% of their work and shared memory on padding at T = 16. Here
// one warp owns one (row, head): at T <= 16 the logits are a single
// m16n8k16 tile pair, S = Q K^T is 2 n-tiles x 4 k-steps of mma.sync and
// P V is 8 n-tiles x 1 k-step; the 16 x 16 probabilities never leave
// registers. Larger T loops over ceil(T/16) query tiles with all keys held
// at once (up to 8 n-tiles of logits); a ragged T is masked (zero K/V rows,
// masked logits, unwritten query rows).
//
// Bound: 4*T*D flops per query row against 8*D bytes per (row, head) moved
// (q, k, v read once, o written once): ~T/2 = 8 flop/byte at T = 16, far
// below the ~295 flop/byte ridge: memory bound. Each warp stages its K and V
// (16-byte loads when rows are aligned) in shared memory and reads Q straight
// into mma fragments, so every element is read once.
//
// Numerics as the plain `attention`: f32 logits and softmax, probabilities
// normalised in f32 and then rounded to bf16 for P V, f32 accumulation, the
// output rounded once. f32 inputs take scalar FMAs.
#include "flash_mma.cuh"

namespace t2v {

constexpr int kSsD = 64;
constexpr int kSsWarps = 4;   // (row, head) items a block
constexpr int kSsLD = 72;     // bf16 row stride of the staged K / V tiles (ldmatrix conflict-free)
constexpr int kSsLDf = 65;    // f32 row stride
constexpr int kSsMaxT = 64;

struct SsStrides {
  long long q[3], k[3], v[3], o[3];  // (row, seq, head) element strides
};

// Stage rows [0, 16*KT) of one (seq, D) slice of k and v as [row][d] tiles
// (zeros from row T on), by one warp.
template <int KT, bool VEC>
__device__ __forceinline__ void ss_stage(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                         const __nv_bfloat16* k, const __nv_bfloat16* v,
                                         long long k_ss, long long v_ss, int T, int lane) {
  constexpr int W = VEC ? 8 : 1;
  for (int i = lane; i < 16 * KT * (kSsD / W); i += 32) {
    const int r = i / (kSsD / W), c = (i % (kSsD / W)) * W;
    if constexpr (VEC) {
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (r < T) {
        kv = *reinterpret_cast<const uint4*>(k + r * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(v + r * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * kSsLD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * kSsLD + c) = vv;
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
      sK[r * kSsLD + c] = r < T ? k[r * k_ss + c] : zero;
      sV[r * kSsLD + c] = r < T ? v[r * v_ss + c] : zero;
    }
  }
}

template <int KT, bool VEC>
__global__ void __launch_bounds__(32 * kSsWarps)
small_seq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      long long items, int heads, int T, SsStrides st, float scale) {
  constexpr int NT = 2 * KT;  // 8-key n-tiles of logits
  extern __shared__ __align__(16) unsigned char ss_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long item = (long long)blockIdx.x * kSsWarps + warp;
  if (item >= items) return;  // the whole warp leaves; nothing below syncs the block
  const long long r = item / heads;
  const int h = (int)(item % heads);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(ss_smem) + warp * 2 * 16 * KT * kSsLD;
  __nv_bfloat16* sV = sK + 16 * KT * kSsLD;
  const __nv_bfloat16* qb = q + r * st.q[0] + h * st.q[2];
  ss_stage<KT, VEC>(sK, sV, k + r * st.k[0] + h * st.k[2], v + r * st.v[0] + h * st.v[2],
                    st.k[1], st.v[1], T, lane);
  __syncwarp();
  __nv_bfloat16* ob = o + r * st.o[0] + h * st.o[2];
  for (int qt = 0; qt < KT; ++qt) {
    uint32_t qa[kSsD / 16][4];
    load_a_frags<kSsD / 16>(qa, qb, qt * 16 + g, T, st.q[1], 0, t);
    float s[NT][4];
    qk_tile<NT, kSsD / 16, kSsLD>(s, qa, sK, 0, g, t);
    // f32 logits, masked past T; rows g (elements 0, 1) and g + 8 (2, 3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < T ? s[nt][e] * scale : -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, s[nt][e]);
        else mx1 = fmaxf(mx1, s[nt][e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - (e < 2 ? mx0 : mx1));
        if (e < 2) sum0 += s[nt][e];
        else sum1 += s[nt][e];
      }
    const float inv0 = 1.0f / quad_sum(sum0), inv1 = 1.0f / quad_sum(sum1);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      s[nt][0] *= inv0;
      s[nt][1] *= inv0;
      s[nt][2] *= inv1;
      s[nt][3] *= inv1;
    }
    float acc[kSsD / 8][4];
#pragma unroll
    for (int dt = 0; dt < kSsD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
    pv_tile<NT, kSsD / 8, kSsLD>(acc, s, sV, 0, lane);  // P rounded to bf16 here
    store_acc<kSsD / 8>(acc, 1.0f, 1.0f, ob, st.o[1], qt * 16 + g, T, 0, t);
  }
}

// f32: one warp per (row, head); lane j holds the logits of keys j and
// j + 32, and output columns lane and lane + 32.
__global__ void __launch_bounds__(32 * kSsWarps)
small_seq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, long long items,
                     int heads, int T, SsStrides st, float scale) {
  extern __shared__ float ss_smem_f[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kSsWarps + warp;
  if (item >= items) return;
  const long long r = item / heads;
  const int h = (int)(item % heads);
  float* sK = ss_smem_f + warp * 2 * kSsMaxT * kSsLDf;
  float* sV = sK + kSsMaxT * kSsLDf;
  const float* kb = k + r * st.k[0] + h * st.k[2];
  const float* vb = v + r * st.v[0] + h * st.v[2];
  for (int i = lane; i < T * kSsD; i += 32) {
    const int row = i / kSsD, d = i % kSsD;
    sK[row * kSsLDf + d] = kb[row * st.k[1] + d];
    sV[row * kSsLDf + d] = vb[row * st.v[1] + d];
  }
  __syncwarp();
  const float* qb = q + r * st.q[0] + h * st.q[2];
  float* ob = o + r * st.o[0] + h * st.o[2];
  const int j0 = lane, j1 = lane + 32;
  for (int i = 0; i < T; ++i) {
    const float q0 = qb[i * st.q[1] + lane], q1 = qb[i * st.q[1] + lane + 32];
    float l0 = 0.0f, l1 = 0.0f;
    for (int d = 0; d < kSsD; ++d) {
      const float qd = __shfl_sync(0xffffffffu, d < 32 ? q0 : q1, d & 31);
      if (j0 < T) l0 = fmaf(qd, sK[j0 * kSsLDf + d], l0);
      if (j1 < T) l1 = fmaf(qd, sK[j1 * kSsLDf + d], l1);
    }
    l0 = j0 < T ? l0 * scale : -INFINITY;
    l1 = j1 < T ? l1 * scale : -INFINITY;
    float mx = fmaxf(l0, l1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float e0 = expf(l0 - mx), e1 = expf(l1 - mx);
    const float inv = 1.0f / warp_sum(e0 + e1);
    const float p0 = e0 * inv, p1 = e1 * inv;
    float o0 = 0.0f, o1 = 0.0f;
    for (int j = 0; j < T; ++j) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0 : p1, j & 31);
      o0 = fmaf(pj, sV[j * kSsLDf + lane], o0);
      o1 = fmaf(pj, sV[j * kSsLDf + lane + 32], o1);
    }
    ob[i * st.o[1] + lane] = o0;
    ob[i * st.o[1] + lane + 32] = o1;
  }
}

template <int KT>
static cudaError_t launch_ss_bf16(const void* q, const void* k, const void* v, void* o,
                                  long long items, int heads, int T, const SsStrides& st,
                                  float scale, cudaStream_t stream) {
  const size_t smem = (size_t)kSsWarps * 2 * 16 * KT * kSsLD * sizeof(__nv_bfloat16);
  const unsigned grid = (unsigned)((items + kSsWarps - 1) / kSsWarps);
  const bool vec = rows_aligned16(k, st.k) && rows_aligned16(v, st.v);
  auto kernel = vec ? small_seq_bf16_kernel<KT, true> : small_seq_bf16_kernel<KT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, 32 * kSsWarps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), items, heads, T, st,
      scale);
  return cudaGetLastError();
}

}  // namespace t2v

extern "C" {

// q, k, v, o: (R, T, H, 64) with (row, seq, head) element strides
// st12 = q's three, k's, v's, o's; the head dim contiguous. T in [1, 64].
int t2v_small_seq_attention(const void* q, const void* k, const void* v, void* o, int dtype,
                            long long R, int T, int H, int D, const long long* st12,
                            float scale, void* stream) {
  if (D != t2v::kSsD || T < 1 || T > t2v::kSsMaxT || R < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  t2v::SsStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = st12[i];
    st.k[i] = st12[3 + i];
    st.v[i] = st12[6 + i];
    st.o[i] = st12[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = R * H;
  if (dtype == t2v::kF32) {
    const size_t smem = (size_t)t2v::kSsWarps * 2 * t2v::kSsMaxT * t2v::kSsLDf * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(t2v::small_seq_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned grid = (unsigned)((items + t2v::kSsWarps - 1) / t2v::kSsWarps);
    t2v::small_seq_f32_kernel<<<grid, 32 * t2v::kSsWarps, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), items, H, T, st, scale);
    return (int)cudaGetLastError();
  }
  if (dtype != t2v::kBF16) return (int)cudaErrorInvalidValue;
  switch ((T + 15) / 16) {
    case 1: return (int)t2v::launch_ss_bf16<1>(q, k, v, o, items, H, T, st, scale, s);
    case 2: return (int)t2v::launch_ss_bf16<2>(q, k, v, o, items, H, T, st, scale, s);
    case 3: return (int)t2v::launch_ss_bf16<3>(q, k, v, o, items, H, T, st, scale, s);
    default: return (int)t2v::launch_ss_bf16<4>(q, k, v, o, items, H, T, st, scale, s);
  }
}

}  // extern "C"
