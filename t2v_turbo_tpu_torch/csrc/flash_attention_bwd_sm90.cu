// Flash-attention backward at head dim 64 in bf16 for Hopper (sm_90a):
// wgmma products fed by a TMA ring in shared memory. The `wgmma` route of
// flash_attention_bwd.cu's entry points; misaligned views, D = 512 and f32
// take that file's kernels.
//
// Replaces the Pallas TPU kernels t2v_turbo_tpu/ops/attention.py::
// _flash_bwd_dkv_kernel and _flash_bwd_dq_kernel (implementation
// _flash_attention_bwd_impl; "B3") at head dim 64, and through its (batch,
// seq, head) strides the BSHD family's _flash_bwd_dkv_kernel_bshd and
// _flash_bwd_dq_kernel_bshd (B6). It computes what the mma route computes:
// with s = q_i . k_j * scale and delta_i = dO_i . O_i,
//   P = exp(s - lse_i);  dV = P^T dO;  dS = P (dO V^T - delta);
//   dK = scale dS^T Q;   dQ = scale dS K;   P = 0 past Sq or Sk.
//
// Bound on the H100: 7 products of 2 B H Sq Sk 64 operations (the logits
// and dP in each of the two kernels, then dV and dK, and dQ) at 989 TFLOP/s
// bf16; the bytes (q, k, v, dO read, dq, dk, dv written) are far below it.
//
// Design. Both kernels are instances of one template: a block owns rows of
// one side, loaded once, and streams the other side through a ring.
//   dK/dV: owns K, V; streams Q, dO (and lse, delta rows):
//          S^T = K Q^T, dP^T = V dO^T; dV += P^T dO, dK += dS^T Q.
//   dQ:    owns Q, dO (lse, delta in registers); streams K, V:
//          S = Q K^T, dP = dO V^T; dQ += dS K.
// - Products on wgmma m64n64k16 (bf16 in, f32 accumulate). Each consumer
//   warpgroup owns 64 rows. The logit products read both operands from
//   shared memory (own tile A, streamed tile a K-major B); P and dS are
//   rounded to bf16 in registers and become the A operand of the second
//   products, whose B is the same streamed tile read MN-major (sm90.cuh).
// - Loads by TMA: one 4-D tensor map per tensor over (D, H, S, B) with the
//   tensor's own strides and a (64, 1, 64, 1) box, 128-byte swizzled. Rows
//   past S are zero-filled by the hardware, so ragged S needs no masked
//   loads. One producer warp fills a ring of STAGES stages (the two
//   streamed tiles, 16 KB, plus for dK/dV the stage's lse and delta rows),
//   each with a full and an empty mbarrier; the consumers wait on full and
//   release empty, so the next tiles load while this one is multiplied.
// - Blocks: one consumer warpgroup (64 own rows) and one producer warp,
//   160 threads, so 2 (dK/dV, ~168 registers a thread) or 3 (dQ) blocks
//   share an SM and hide each other's waits, and short sides (the temporal
//   attention's 16 rows, the cross-attention's 77 keys) launch no block
//   that is half empty. Two consumer warpgroups a block (128 own rows, one
//   streamed tile for both, the producer a whole warpgroup whose registers
//   setmaxnreg gives to them, one block an SM) were slower at every
//   training shape measured (PERF.md).
// - Softmax: log2(e) is folded into the scale and the lse, and P = exp2 of
//   one fused multiply-add. Queries past Sq get lse = +inf (P = 0); keys
//   past Sk are masked on the last key tile of dQ.
// Deterministic: no atomics; every output row is written once, by the one
// thread that accumulated it over the streamed tiles in a fixed order.
#include "flash_mma.cuh"  // rows_aligned16
#include "sm90.cuh"

namespace t2v {

namespace {

using namespace sm90;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;      // 3 measured no faster; 4 slower for dQ (PERF.md)
constexpr int kThreads = 160;   // a consumer warpgroup, then the producer warp

struct Sm90BwdArgs {
  const float *lse, *delta;  // (B, H, Sq) f32 at (l_sb, l_sh), contiguous seq
  __nv_bfloat16 *out1, *out2;  // dK and dV, or dQ: (B, S_own, H, 64)
  long long o1[3], o2[3];      // (sb, ss, sh) of out1, out2
  long long l_sb, l_sh;
  int H, own_len, str_len;     // rows of the own side and of the streamed side
  float scale;
};

template <bool DKV, int STAGES>
struct Sm90Layout {
  static constexpr int own = 0;                                     // 2 tiles
  static constexpr int ring = own + 2 * kTileBytes;                 // [STAGES][2] tiles
  static constexpr int stats = ring + STAGES * 2 * kTileBytes;      // dK/dV: [STAGES][2][64] f32
  static constexpr int bars = stats + (DKV ? STAGES * 2 * 64 * 4 : 0);
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES);         // own, full[], empty[]
  static constexpr int alloc = bytes + 1024;                        // room to align to 1024
};

template <bool DKV, int STAGES>
__global__ void __launch_bounds__(kThreads, DKV ? 2 : 3)
flash_bwd_sm90_kernel(const __grid_constant__ CUtensorMap own1,
                      const __grid_constant__ CUtensorMap own2,
                      const __grid_constant__ CUtensorMap str1,
                      const __grid_constant__ CUtensorMap str2, const Sm90BwdArgs a) {
  using L = Sm90Layout<DKV, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* own_full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + STAGES;
  float* stats = reinterpret_cast<float*>(smem + L::stats);
  auto ring = [&](int s, int i) { return smem + L::ring + (2 * s + i) * kTileBytes; };

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int own0 = blockIdx.x * 64;
  const int n_tiles = (a.str_len + 63) / 64;
  const float* lse = a.lse + b * a.l_sb + h * a.l_sh;
  const float* delta = a.delta + b * a.l_sb + h * a.l_sh;

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes
      mbar_init(&empty[s], 128);         // every consumer thread
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      tma_prefetch(&own1);
      tma_prefetch(&own2);
      tma_prefetch(&str1);
      tma_prefetch(&str2);
      mbar_arrive_expect_tx(own_full, 2 * kTileBytes);
      tma_load_4d(smem + L::own, &own1, own_full, 0, h, own0, b);
      tma_load_4d(smem + L::own + kTileBytes, &own2, own_full, 0, h, own0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      if constexpr (DKV) {  // the stage's queries: lse * log2(e) (+inf past Sq), delta
        for (int r = lane; r < 64; r += 32) {
          const int q = j * 64 + r;
          const bool in = q < a.str_len;
          stats[(2 * s) * 64 + r] = in ? lse[q] * kLog2e : INFINITY;
          stats[(2 * s + 1) * 64 + r] = in ? delta[q] : 0.0f;
        }
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_4d(ring(s, 0), &str1, &full[s], 0, h, j * 64, b);
        tma_load_4d(ring(s, 1), &str2, &full[s], 0, h, j * 64, b);
      } else {
        mbar_arrive(&full[s]);
      }
    }
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
    const int s = j % STAGES;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const unsigned char* y1 = ring(s, 0);
    const unsigned char* y2 = ring(s, 1);
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
    mbar_arrive(&empty[s]);
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

// The 4-D map over (D = 64, H, S, B) of a (B, S, H, 64) bf16 tensor at
// element strides st = (sb, ss, sh): 64 x 64 boxes, 128-byte swizzle, rows
// past S read as zeros.
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* base, int B, int S, int H,
              const long long* st) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1}, elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool DKV>
cudaError_t launch_sm90(const CUtensorMap (&m)[4], const Sm90BwdArgs& a, int BH, cudaStream_t st) {
  constexpr int smem = Sm90Layout<DKV, kStages>::alloc;
  auto kern = flash_bwd_sm90_kernel<DKV, kStages>;
  static const cudaError_t attr =  // once per instance (the port drives one card)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kern<<<dim3((a.own_len + 63) / 64, BH), kThreads, smem, st>>>(m[0], m[1], m[2], m[3], a);
  return cudaGetLastError();
}

}  // namespace

// The wgmma route of flash_attention_bwd.cu's entry points (bf16, D = 64;
// arguments as there). Refuses tensors that break TMA's rule.
int flash_bwd_sm90(bool dkv, const void* q, const void* k, const void* v, const void* g,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                   int H, int Sq, int Sk, const long long* strides, const long long* lse_strides,
                   float scale, void* stream) {
  // TMA's rule: 16-byte aligned bases, strides of multiples of 16 bytes
  const void* in[4] = {q, k, v, g};
  for (int i = 0; i < 4; ++i)
    if (!rows_aligned16(in[i], strides + 3 * i)) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mg;
  if (!make_map(&mq, encode, q, B, Sq, H, strides) || !make_map(&mk, encode, k, B, Sk, H, strides + 3) ||
      !make_map(&mv, encode, v, B, Sk, H, strides + 6) || !make_map(&mg, encode, g, B, Sq, H, strides + 9))
    return (int)cudaErrorInvalidValue;
  Sm90BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.l_sb = lse_strides[0];
  a.l_sh = lse_strides[1];
  a.H = H;
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) {
    const CUtensorMap m[4] = {mk, mv, mq, mg};
    a.out1 = static_cast<__nv_bfloat16*>(dk);
    a.out2 = static_cast<__nv_bfloat16*>(dv);
    for (int i = 0; i < 3; ++i) {
      a.o1[i] = strides[15 + i];
      a.o2[i] = strides[18 + i];
    }
    a.own_len = Sk;
    a.str_len = Sq;
    return (int)launch_sm90<true>(m, a, B * H, st);
  }
  const CUtensorMap m[4] = {mq, mg, mk, mv};
  a.out1 = static_cast<__nv_bfloat16*>(dq);
  a.out2 = nullptr;
  for (int i = 0; i < 3; ++i) a.o1[i] = a.o2[i] = strides[12 + i];
  a.own_len = Sq;
  a.str_len = Sk;
  return (int)launch_sm90<false>(m, a, B * H, st);
}

}  // namespace t2v
