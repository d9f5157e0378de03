// Short-sequence self-attention (B8) for Hopper: softmax(q k^T * scale) v
// for every (row, head) of (R, T, H, D) tensors, T <= 64 and D = 64: the
// UNet's temporal attention over 16 frames at every pixel, and its middle
// block's spatial self-attention over 40 tokens.
//
// Replaces the Pallas TPU kernels tests_tpu/bench_small_seq_attention.py::
// _kernel_loop / _kernel_vec / _kernel_packed (entry small_seq_attention),
// three variants of one function; this is one kernel family.
//
// Bound: device-memory bytes. A (row, head) moves 8 * T * D bytes in bf16
// (q, k, v read once, o written once) for 4 * T * T * D flops: T / 2
// flop/byte (8 at T = 16) against the card's ~295 in bf16, T / 4 against
// ~20 in f32. The only gain is to keep enough bytes in flight to run at
// the memory's rate, and to spend little per byte on the way.
//
// Design (ops/attention.py::ss_plan picks the route and the heads of an
// item; the C entry derives the grid, the threads and the shared memory
// from them, or refuses the request):
// - An item is a row's group of `heads` heads: (T, heads, 64) of each of q,
//   k and v. On the path q, k and v are views of the q/k/v Linears'
//   contiguous outputs, so each of the T pieces of an item is heads * 128
//   bytes (bf16) contiguous and 16-byte aligned.
// - A block takes one item, a warp one (head, 16-query tile) unit of it:
//   at most 4 warps and 49 KB of shared memory a block, so many blocks an
//   SM keep their copies in flight while others compute. That measured
//   faster than larger items and than a persistent grid walking the items
//   through a ring of stages (PERF.md §6).
// - `bulk` route: the item is staged in shared memory by 1-D bulk copies
//   (cp.async.bulk) completing on an mbarrier: warp 0's lanes issue one
//   copy per tensor and staged row (3T copies of heads * 128 bytes), into
//   rows `pitch` elements apart. No tensor map, so no host work a call. In
//   bf16 the pitch is heads * 64 + 8: rows 16 bytes off a multiple of 128,
//   so the ldmatrix reads of 8 consecutive rows fall in 8 distinct bank
//   groups (a bulk copy cannot swizzle). A tensor's stage is sized to the
//   item: 16 * ceil(T / 16) rows in bf16 (mma's 16-row tiles; the rows past
//   T are zeroed), T rows in f32.
// - bf16 math: S = Q K^T and O = P V on mma.sync m16n8k16, Q and K
//   fragments by ldmatrix, V by ldmatrix.trans; the logits stay in
//   registers. O goes back into the unit's own Q rows and out as 16-byte
//   rows (coalesced stores).
// - f32 math: lane (i, half) holds query i's logits against all T keys,
//   summing its half of the head dim (alternate 16-byte chunks, so the two
//   halves' reads never share a bank) and exchanging halves by one
//   shuffle; K and V rows are read as float4 broadcasts, 16 keys' K chunks
//   loaded before their FMAs; FMAs in f32 (TF32 would break the 1e-5
//   parity).
// - `elementwise` route, for views the bulk copies cannot read (a base or
//   a stride off 16 bytes): the same math and staging layout, the item
//   loaded element by element by all threads.
// The numerics are the plain `attention`'s: f32 logits and softmax, P
// normalised in f32 (in bf16 then rounded to bf16 for P V), f32
// accumulation, the output rounded once. Every sum is in a fixed order, so
// two launches give equal bits.
#include "flash_mma.cuh"
#include "sm90.cuh"

namespace t2v {

constexpr int kSsD = 64;
constexpr int kSsMaxT = 64;
constexpr int kSsPadBf16 = 8;      // elements after each staged bf16 row
constexpr int kSsMaxThreads = 128;  // a warp a unit: heads * ceil(T / 16) <= 4
constexpr int kSsMaxSmem = 49152;  // the largest stage a block takes: 3 f32 tiles of 64 rows x 64 or of 16 x 4 heads

enum SsRoute : int { kSsBulk = 0, kSsElementwise = 1 };

struct SsArgs {
  const void* x[3];     // q, k, v
  void* o;
  long long st[4][3];   // (row, seq, head) element strides of q, k, v, o
  int groups, heads, T, pitch;
  float scale;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(sm90::smem_addr(p)));
}

// Warp 0: the bulk copies of item (row r, heads h0...) into `stage` (q, k,
// v tiles `tile` elements apart), completing on `bar`.
template <typename E>
__device__ __forceinline__ void ss_issue(const SsArgs& a, E* stage, int tile, uint64_t* bar, long long r, int h0,
                                         int lane) {
  const uint32_t piece = (uint32_t)(a.heads * kSsD * sizeof(E));
  if (lane == 0) sm90::mbar_arrive_expect_tx(bar, 3u * a.T * piece);
  __syncwarp();
  for (int c = lane; c < 3 * a.T; c += 32) {
    const int x = c / a.T, t = c % a.T;
    const E* src = static_cast<const E*>(a.x[x]) + r * a.st[x][0] + t * a.st[x][1] + h0 * a.st[x][2];
    sm90::bulk_load(stage + x * tile + t * a.pitch, src, piece, bar);
  }
}

// All threads: the item into `stage` element by element (the views the bulk
// copies cannot read).
template <typename E>
__device__ __forceinline__ void ss_stage_elementwise(const SsArgs& a, E* stage, int tile, long long r, int h0) {
  const int per = a.heads * kSsD, n = a.T * per;
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
    const int x = i / n, t = (i % n) / per, c = i % per;
    const E* src = static_cast<const E*>(a.x[x]);
    stage[x * tile + t * a.pitch + c] =
        src[r * a.st[x][0] + t * a.st[x][1] + (h0 + c / kSsD) * a.st[x][2] + c % kSsD];
  }
}

// bf16, one warp: queries [16 qt, 16 qt + 16) of head `hh` of the staged
// item against all its keys; o_row: the output's (row, head) base.
template <int KT>
__device__ __forceinline__ void ss_unit(const SsArgs& a, __nv_bfloat16* sq, const __nv_bfloat16* sk,
                                        const __nv_bfloat16* sv, int hh, int qt, __nv_bfloat16* o_row,
                                        int lane) {
  constexpr int NT = 2 * KT;  // 8-key n-tiles of logits
  const int g = lane >> 2, t = lane & 3, P = a.pitch, T = a.T;
  __nv_bfloat16* qtile = sq + qt * 16 * P + hh * kSsD;
  uint32_t qa[kSsD / 16][4];  // A fragments: matrices (rows 0-7 | 8-15) x (columns 0-7 | 8-15) of each k16 slice
  {
    const __nv_bfloat16* p = qtile + ((lane & 7) + ((lane >> 3) & 1) * 8) * P + (lane >> 4) * 8;
#pragma unroll
    for (int kc = 0; kc < kSsD / 16; ++kc) ldsm_x4(qa[kc], p + kc * 16);
  }
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
  // B fragments of 16 keys: matrices (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
  const __nv_bfloat16* kp = sk + hh * kSsD + ((lane & 7) + (lane >> 4) * 8) * P + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int kc = 0; kc < kSsD / 16; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, kp + j * 16 * P + kc * 16);
      mma_16816(s[2 * j], qa[kc], b[0], b[1]);
      mma_16816(s[2 * j + 1], qa[kc], b[2], b[3]);
    }
  // f32 logits, masked past T; rows g (elements 0, 1) and g + 8 (2, 3)
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + 2 * t + (e & 1);
      s[nt][e] = col < T ? s[nt][e] * a.scale : -INFINITY;
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
  const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < KT; ++j) {  // P rounded to bf16 here, as the plain path's probs.to(v.dtype)
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
    // matrices: keys j*16 + {0..7, 8..15} x d tiles {dt, dt + 1}
    const __nv_bfloat16* row = sv + hh * kSsD + (j * 16 + (mat & 1) * 8 + rr) * P + (mat >> 1) * 8;
#pragma unroll
    for (int dt = 0; dt < kSsD / 8; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + dt * 8);
      mma_16816(acc[dt], pa, b[0], b[1]);
      mma_16816(acc[dt + 1], pa, b[2], b[3]);
    }
  }
  // O into this unit's own Q rows (no other warp reads them), then out as
  // 16-byte pieces of whole 128-byte rows
  __syncwarp();
#pragma unroll
  for (int dt = 0; dt < kSsD / 8; ++dt) {
    *reinterpret_cast<uint32_t*>(qtile + g * P + dt * 8 + 2 * t) = pack_bf16(acc[dt][0], acc[dt][1]);
    *reinterpret_cast<uint32_t*>(qtile + (g + 8) * P + dt * 8 + 2 * t) = pack_bf16(acc[dt][2], acc[dt][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = lane + 32 * i, row = c >> 3, col = (c & 7) * 8, tq = qt * 16 + row;
    if (tq < T)
      *reinterpret_cast<uint4*>(o_row + tq * a.st[3][1] + col) =
          *reinterpret_cast<const uint4*>(qtile + row * P + col);
  }
}

// f32, one warp: queries [16 qt, 16 qt + 16) of head `hh`; lane (i, half):
// query 16 qt + lane % 16, head-dim chunks 2c + half (c = 0..7) of 4 floats.
template <int KT>
__device__ __forceinline__ void ss_unit(const SsArgs& a, float* sq, const float* sk, const float* sv, int hh,
                                        int qt, float* o_row, int lane) {
  constexpr int N = 16 * KT;
  const int T = a.T, P = a.pitch, half = lane >> 4, i = qt * 16 + (lane & 15);
  const int col0 = hh * kSsD + half * 4;
  const float* qrow = sq + min(i, T - 1) * P + col0;
  float4 q[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) q[c] = *reinterpret_cast<const float4*>(qrow + 8 * c);
  float s[N];
#pragma unroll
  for (int j = 0; j < N; ++j) s[j] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j0 = 0; j0 < N; j0 += 16) {  // 16 keys' loads in flight before their FMAs; keys past T
      float4 kv[16];                       // read key T - 1, their logits are masked below
#pragma unroll
      for (int jj = 0; jj < 16; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(sk + min(j0 + jj, T - 1) * P + col0 + 8 * c);
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int j = j0 + jj;
        s[j] = fmaf(q[c].w, kv[jj].w, fmaf(q[c].z, kv[jj].z, fmaf(q[c].y, kv[jj].y, fmaf(q[c].x, kv[jj].x, s[j]))));
      }
    }
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] += __shfl_xor_sync(0xffffffffu, s[j], 16);  // the other half's sum: both lanes hold equal bits
    s[j] = j < T ? s[j] * a.scale : -INFINITY;
    mx = fmaxf(mx, s[j]);
  }
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    s[j] = expf(s[j] - mx);
    sum += s[j];
  }
  const float inv = 1.0f / sum;
  float4 acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j < T) {
      const float p = s[j] * inv;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(sv + j * P + col0 + 8 * c);
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
  if (i < T) {
    float* out = o_row + i * a.st[3][1] + half * 4;
#pragma unroll
    for (int c = 0; c < 8; ++c) *reinterpret_cast<float4*>(out + 8 * c) = acc[c];
  }
}

template <typename E, int KT, bool BULK>
__global__ void __launch_bounds__(kSsMaxThreads) small_seq_kernel(const SsArgs a) {
  constexpr bool BF = sizeof(E) == 2;
  extern __shared__ __align__(128) unsigned char ss_raw[];
  __shared__ uint64_t full;
  E* sq = reinterpret_cast<E*>(ss_raw);
  const int rows = BF ? 16 * KT : a.T;  // staged rows of a tensor
  const int tile = rows * a.pitch;       // its elements
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r = blockIdx.x / a.groups;
  const int h0 = (int)(blockIdx.x % a.groups) * a.heads;

  if (BULK && threadIdx.x == 0) {
    sm90::mbar_init(&full, 1);
    sm90::mbar_fence_init();
  }
  // the rows past T of the bf16 tiles, which nothing stages: finite (V's
  // are multiplied by zero probabilities), zero
  const int tail = (rows - a.T) * a.pitch;
  for (int i = threadIdx.x; i < 3 * tail; i += blockDim.x)
    sq[(i / tail) * tile + a.T * a.pitch + i % tail] = from_f32<E>(0.0f);
  __syncthreads();
  if (BULK) {
    if (warp == 0) ss_issue(a, sq, tile, &full, r, h0, lane);
    sm90::mbar_wait(&full, 0);
  } else {
    ss_stage_elementwise(a, sq, tile, r, h0);
    __syncthreads();
  }
  const int hh = warp / KT, qt = warp % KT;
  ss_unit<KT>(a, sq, sq + tile, sq + 2 * tile, hh, qt,
              static_cast<E*>(a.o) + r * a.st[3][0] + (h0 + hh) * a.st[3][2], lane);
}

template <typename E, int KT, bool BULK>
static auto ss_kernel() {
  auto kern = small_seq_kernel<E, KT, BULK>;
  static const cudaError_t attr =  // once per instance (the port drives one card)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSsMaxSmem);
  return attr == cudaSuccess ? kern : nullptr;
}

template <typename E, bool BULK>
static auto ss_kernel_for(int kt) {
  switch (kt) {
    case 1: return ss_kernel<E, 1, BULK>();
    case 2: return ss_kernel<E, 2, BULK>();
    case 3: return ss_kernel<E, 3, BULK>();
    default: return ss_kernel<E, 4, BULK>();
  }
}

// 16-byte aligned base and (row, seq, head) strides of whole 16-byte pieces.
template <typename E>
static bool ss_aligned(const void* p, const long long* st) {
  constexpr int ve = 16 / sizeof(E);
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st[0] % ve == 0 && st[1] % ve == 0 && st[2] % ve == 0;
}

template <typename E>
static int ss_run(const void* q, const void* k, const void* v, void* o, long long R, int T, int H,
                  const long long* st12, float scale, int route, int heads, cudaStream_t stream) {
  constexpr bool BF = sizeof(E) == 2;
  SsArgs a;
  a.x[0] = q;
  a.x[1] = k;
  a.x[2] = v;
  a.o = o;
  for (int i = 0; i < 12; ++i) a.st[i / 3][i % 3] = st12[i];
  const bool bulk = route == kSsBulk;
  const int kt = (T + 15) / 16, threads = 32 * heads * kt;
  // refuse what the kernel cannot run: no route is taken in place of another
  if ((!bulk && route != kSsElementwise) || heads < 1 || H % heads || threads > kSsMaxThreads ||
      !ss_aligned<E>(o, a.st[3]))
    return (int)cudaErrorInvalidValue;
  for (int x = 0; x < 3 && bulk; ++x)
    if (!ss_aligned<E>(a.x[x], a.st[x])) return (int)cudaErrorInvalidValue;
  a.groups = H / heads;
  a.heads = heads;
  a.T = T;
  a.pitch = heads * kSsD + (BF ? kSsPadBf16 : 0);
  a.scale = scale;
  const long long grid = R * a.groups;
  const size_t smem = (size_t)3 * (BF ? 16 * kt : T) * a.pitch * sizeof(E);
  const auto kern = bulk ? ss_kernel_for<E, true>(kt) : ss_kernel_for<E, false>(kt);
  if (kern == nullptr || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace t2v

extern "C" {

// q, k, v, o: (R, T, H, 64) with (row, seq, head) element strides st12 =
// q's three, k's, v's, o's; the head dim contiguous; T in [1, 64]. route (0
// bulk, 1 elementwise) and heads an item: ops/attention.py::ss_plan.
int t2v_small_seq_attention(const void* q, const void* k, const void* v, void* o, int dtype, long long R,
                            int T, int H, int D, const long long* st12, float scale, int route, int heads,
                            void* stream) {
  if (D != t2v::kSsD || T < 1 || T > t2v::kSsMaxT || R < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == t2v::kF32) return t2v::ss_run<float>(q, k, v, o, R, T, H, st12, scale, route, heads, s);
  if (dtype == t2v::kBF16) return t2v::ss_run<__nv_bfloat16>(q, k, v, o, R, T, H, st12, scale, route, heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
