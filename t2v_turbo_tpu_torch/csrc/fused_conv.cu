// Fused GroupNorm(+FiLM)+SiLU+convolution (B7) for Hopper:
//   y[n, o] = bias[o] + sum_{c, i, j} w[o, c, i, j] * silu(x[n, c, h+i-ph, w+j-pw] * a[n, c] + b[n, c])
// with stride 1 and zero padding of the ACTIVATED input (a halo element is
// 0, not silu(b)), for the UNet's 3x3 spatial convs and its (3,1) temporal
// convs, whose "image" is (T, H*W) of a clip.
//
// Replaces the Pallas TPU kernel t2v_turbo_tpu/ops/fused_conv.py::_fused_kernel
// (entry fused_gn_silu_conv). a and b fold the GroupNorm statistics, its
// affine and the optional FiLM; they come from norms.cu's split reduction
// (t2v_group_norm_affine), as the TPU path reduced them outside its kernel.
//
// Layout: channels-first and contiguous: x (N, C, H, W), y (N, O, H, W); the
// weight comes as (O, kh, kw, C) (the wrapper permutes the module's
// (O, C, kh, kw) once a call).
//
// Bound: at the UNet's shapes the work is ~2*O*9 flops per input element
// read, far above the H100's ~295 flop/byte ridge: operations bound.
//
// bf16 design (the `wgmma` route): implicit GEMM with M = pixels, N =
// output channels, K = taps x input channels.
// - The pixel rows of a block are a tile of TR image rows x TW columns,
//   counted over all N*H rows, so a tile may span images (the 5x8 and 10x16
//   levels fill their 128 rows with several frames). Its slab holds the
//   activated rows the taps read, each image's rows with that image's own
//   zero halo: an image's H rows are "extended" by its kh - 1 halo rows, and
//   the slab is a run of extended rows, TW + kw - 1 positions each,
//   [position][64 channels] in bf16 (rows of 144 bytes: conflict-free).
// - Products on wgmma m64nBNk16 (BN = 160 output channels a block, 32 for
//   narrow outputs), f32 accumulation, two consumer warpgroups of 64 pixels.
//   A (pixels x 16 channels) is read from the slab by ldmatrix into
//   registers: a tap's shift moves the slab by any number of positions,
//   which a shared-memory descriptor's 1024-byte row groups cannot follow.
//   B is the weight tile of one tap (BN rows x 64 channels, K-major, 128-byte
//   swizzle), brought by TMA from a 3-D map over (C, taps, O) through a ring
//   of 4 full/empty mbarrier stages filled by one producer warp; TMA
//   zero-fills channels past C and rows past O. A consumer waits for each
//   tap's four products before it loads the next tap's A fragments, while
//   the other consumer warpgroup's products run: loading them under the
//   products in flight made ptxas serialise every wgmma (its warning C7513)
//   and was no faster.
// - Staging off the products' path: seven stager warps write silu(x*a+b),
//   rounded to bf16 (the TPU kernel's xp_ref point), chunk by chunk into two
//   slab buffers handed over by full/empty mbarriers, so the next chunk is
//   staged while the consumers multiply this one; each activation is staged
//   once per 160 output channels. A block is 16 warps, 128 registers a
//   thread (ptxas uses 122 at n160): the producer, 7 stagers, and the two
//   consumer warpgroups. Staging, not the products, bounded every earlier
//   build (PERF.md): three stager warps in a 384-thread block were slower
//   at every UNet shape.
// - A host-side plan (ops/fused_conv.py::conv_plan) picks TW, TR, BN and a
//   split of the 64-channel chunks where the tiles alone would fill the
//   132 SMs poorly. The splits of one tile are a thread block cluster: each
//   keeps its f32 sums in shared memory and the cluster adds them in split
//   order through distributed shared memory, so two launches give equal
//   bits, with no atomics and no workspace in device memory.
// f32 (the `f32` route, reference phases only) runs scalar FMAs (no TF32).
#include "sm90.cuh"

namespace t2v {

// ---- f32: 64 output channels x 128 pixels of one image a block --------------

constexpr int kCvBM = 64;        // output channels a block
constexpr int kCvBN = 128;       // pixels a block
constexpr int kCvTW = 16;        // their width, at most
constexpr int kCvThreads = 256;
constexpr int kCvMaxTaps = 9;    // 3x3
// (TH + 2) * (TW + 2) with TH * TW <= 128: at most 3 * 130 positions
constexpr int kCvMaxSlab = 390;
// 8 channels a stage, slab rows of 9 (conflict-free along positions).
constexpr int kCvCKf = 8;
constexpr int kCvLDf = 9;

struct ConvArgs {
  const void* x;
  const float* a;     // (N, C)
  const float* b;     // (N, C)
  const void* w;      // (O, kh, kw, C), x's dtype
  const void* bias;   // (O,), x's dtype, or null
  void* y;
  int C, H, W, O, kh, kw, TH, TW, tiles_w;
};

// The block's pixel rectangle and slab geometry.
struct ConvTile {
  int n, m0, h0, w0, SH, SW, npos, taps;
  long long HW;
  __device__ ConvTile(const ConvArgs& p) {
    n = blockIdx.z;
    m0 = blockIdx.y * kCvBM;
    h0 = (blockIdx.x / p.tiles_w) * p.TH;
    w0 = (blockIdx.x % p.tiles_w) * p.TW;
    SH = p.TH + p.kh - 1;
    SW = p.TW + p.kw - 1;
    npos = SH * SW;
    taps = p.kh * p.kw;
    HW = (long long)p.H * p.W;
  }
  // Slab position of tile pixel q at tap (0, 0); pixel q < TH*TW.
  __device__ int pos(const ConvArgs& p, int q) const { return (q / p.TW) * SW + q % p.TW; }
  // silu(x*a+b) of channel c at slab position `pos`, 0 outside the image or past C.
  template <typename T>
  __device__ float act(const ConvArgs& p, const T* x, const float* a, const float* b, int c,
                       int pos) const {
    const int hh = h0 - p.kh / 2 + pos / SW, ww = w0 - p.kw / 2 + pos % SW;
    if (c >= p.C || hh < 0 || hh >= p.H || ww < 0 || ww >= p.W) return 0.0f;
    return silu(to_f32(x[c * HW + (long long)hh * p.W + ww]) * a[c] + b[c]);
  }
  // Write one output element if it lies inside the image.
  template <typename T>
  __device__ void store(const ConvArgs& p, int o, int q, float v) const {
    if (o >= p.O || q >= p.TH * p.TW) return;
    const int hh = h0 + q / p.TW, ww = w0 + q % p.TW;
    if (hh >= p.H || ww >= p.W) return;
    if (p.bias != nullptr) v += to_f32(static_cast<const T*>(p.bias)[o]);
    static_cast<T*>(p.y)[((long long)n * p.O + o) * HW + (long long)hh * p.W + ww] = from_f32<T>(v);
  }
};

// f32: the same tiles with scalar FMAs. Thread (tm, tn) owns output channels
// m0 + 4*tm + [0, 4) at pixels tn + 16*j, j < 8.
__global__ void __launch_bounds__(kCvThreads)
gn_silu_conv_f32_kernel(ConvArgs p) {
  __shared__ float s_x[kCvMaxSlab * kCvLDf];
  __shared__ __align__(16) float s_w[kCvMaxTaps * kCvCKf * kCvBM];  // [tap][c][m]
  const ConvTile tile(p);
  const float* x = static_cast<const float*>(p.x) + (long long)tile.n * p.C * tile.HW;
  const float* w = static_cast<const float*>(p.w);
  const float* a = p.a + (long long)tile.n * p.C;
  const float* b = p.b + (long long)tile.n * p.C;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  const int valid = p.TH * p.TW;
  int pos[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = tn + 16 * j;
    pos[j] = q < valid ? tile.pos(p, q) : 0;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < p.C; c0 += kCvCKf) {
    for (int i = threadIdx.x; i < tile.npos * kCvCKf; i += kCvThreads) {
      const int ps = i % tile.npos, c = i / tile.npos;
      s_x[ps * kCvLDf + c] = tile.act(p, x, a, b, c0 + c, ps);
    }
    for (int i = threadIdx.x; i < kCvBM * kCvCKf; i += kCvThreads) {
      const int m = i / kCvCKf, c = i % kCvCKf;
      const bool in = tile.m0 + m < p.O && c0 + c < p.C;
      const float* src = w + (long long)(tile.m0 + m) * tile.taps * p.C + c0 + c;
      for (int tap = 0; tap < tile.taps; ++tap)
        s_w[(tap * kCvCKf + c) * kCvBM + m] = in ? src[(long long)tap * p.C] : 0.0f;
    }
    __syncthreads();
    for (int tap = 0; tap < tile.taps; ++tap) {
      const int shift = (tap / p.kw) * tile.SW + tap % p.kw;
#pragma unroll
      for (int c = 0; c < kCvCKf; ++c) {
        const float4 wv = *reinterpret_cast<const float4*>(s_w + (tap * kCvCKf + c) * kCvBM + 4 * tm);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xv = s_x[(pos[j] + shift) * kCvLDf + c];
          acc[0][j] = fmaf(wv.x, xv, acc[0][j]);
          acc[1][j] = fmaf(wv.y, xv, acc[1][j]);
          acc[2][j] = fmaf(wv.z, xv, acc[2][j]);
          acc[3][j] = fmaf(wv.w, xv, acc[3][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) tile.store<float>(p, tile.m0 + 4 * tm + i, tn + 16 * j, acc[i][j]);
}


// ---- bf16 on wgmma -----------------------------------------------------------

namespace {

using namespace sm90;

constexpr int kWgBM = 128;        // pixels a block: two consumer warpgroups of 64
constexpr int kWgCK = 64;         // input channels a chunk: one 128-byte weight row
constexpr int kWgLD = 72;         // slab row: 64 channels + 8 of padding (144 bytes)
constexpr int kWgMaxPos = 480;    // slab positions a buffer, at most
constexpr int kWgStagerWarps = 7;  // warps 1 .. kWgStagerWarps; warp 0: the producer
constexpr int kWgStagers = 32 * kWgStagerWarps;
constexpr int kWgC0 = 1 + kWgStagerWarps;  // the first consumer warp (of a warpgroup)
constexpr int kWgConsumers = 256;          // two warpgroups
constexpr int kWgThreads = 32 * kWgC0 + kWgConsumers;
constexpr int kBatch = 2;         // slab items a stager loads at once (general path)
constexpr int kWgStages = 4;      // weight tiles in flight
constexpr int kWgEpiLD = kWgBM + 4;  // the epilogue's f32 [channel][pixel] rows
constexpr int kWgMaxSmem = 232448;
constexpr int kWgMaxSplits = 8;   // a cluster's CTAs, at most (the portable limit)

struct WgArgs {
  const __nv_bfloat16* x;
  const float *a, *b;          // (N, C)
  const __nv_bfloat16* bias;   // (O,) or null
  __nv_bfloat16* y;
  int N, C, H, W, O, HW, rows;  // rows = N * H
  int TW, TR, tiles_w, npos_cap, chunks, chunks_per_split;
  int splits;  // chunk splits: a cluster of that many CTAs along z shares a tile's sums
  int wide;    // W % 8 == 0, TW % 8 == 0 and x 16-byte aligned: stage_wide
};

// Bytes of the region that holds the two slab buffers, then the epilogue's tile.
__host__ __device__ inline int wg_region_bytes(int bn, int npos_cap) {
  const int slabs = 2 * npos_cap * kWgLD * 2, epi = bn * kWgEpiLD * 4;
  return slabs > epi ? slabs : epi;
}

// silu for the bf16 kernel, whose result is rounded to bf16 (2^-9): the
// approximate exp and reciprocal (relative errors ~2^-21) change a rounded
// value at most rarely, by one ulp, and cost a few instructions instead of
// expf's and an IEEE division's few dozen.
__device__ __forceinline__ float silu_bf16(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// ldmatrix.x4 (not transposed): lane l gives the row address of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The 256 consumer threads only (warps kWgC0 ..).
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// a, b of image-channel index ai .. ai + 7 (32-byte aligned: C % 8 == 0).
__device__ __forceinline__ void load_ab(const WgArgs& p, int ai, float (&av)[8], float (&bv)[8]) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(p.a + ai));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(p.a + ai + 4));
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(p.b + ai));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(p.b + ai + 4));
  av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
  av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
  bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
  bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
}

// silu(x*a+b) of 8 channels, rounded to bf16 and packed: one slab row's 16 bytes.
__device__ __forceinline__ uint4 activate8(const float (&xs)[8], const float (&av)[8], const float (&bv)[8]) {
  float h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = silu_bf16(xs[e] * av[e] + bv[e]);
  return make_uint4(pack_bf16(h[0], h[1]), pack_bf16(h[2], h[3]), pack_bf16(h[4], h[5]), pack_bf16(h[6], h[7]));
}

// The stagers' wide path: a unit is 8 channels x 8 neighbouring positions
// of one slab row, read as one 16-byte load a channel (8 loads for 64
// values, against 64 two-byte loads), activated and written as 8 slab rows
// of 16 bytes; a slab row is TW / 8 such blocks. Units go channel group
// fastest, so a warp's 16-byte stores of one position fill 128 contiguous
// bytes. For kw = 3 the two halo columns of each slab row follow as 8-channel
// items of one position, so that no lane of a warp idles through a block's
// 8 positions for the one a halo block would keep.
template <int KH, int KW>
__device__ __forceinline__ void stage_wide(const WgArgs& p, __nv_bfloat16* slab, int slab_elems,
                                           uint64_t* slab_full, uint64_t* slab_empty, int st, int e0,
                                           int w0, int k0, int nk, int slab_rows) {
  const int EH = p.H + KH - 1, SW = p.TW + KW - 1;
  const int nb = p.TW / 8;
  const int units = slab_rows * nb * 8, halo = KW == 3 ? slab_rows * 2 * 8 : 0;
  for (int kk = 0; kk < nk; ++kk) {
    const int buf = kk & 1;
    mbar_wait(&slab_empty[buf], ((kk >> 1) & 1) ^ 1);
    __nv_bfloat16* dst = slab + buf * slab_elems;
    const int ck = (k0 + kk) * kWgCK;
    for (int u = st; u < units; u += kWgStagers) {
      const int cg = u % 8, jb = (u / 8) % nb, row = u / (8 * nb);
      const int ww0 = w0 + jb * 8;
      const int es = e0 - KH / 2 + row, n = es / EH, hh = es % EH - KH / 2;
      const int c = ck + cg * 8;
      const int at = (row * SW + jb * 8 + KW / 2) * kWgLD + cg * 8;
      const bool live = n < p.N && hh >= 0 && hh < p.H && ww0 < p.W && c < p.C;
      uint4 raw[8];
      float av[8], bv[8];
      if (live) {
        load_ab(p, n * p.C + c, av, bv);
        const __nv_bfloat16* src = p.x + (n * p.C + c) * p.HW + hh * p.W + ww0;
#pragma unroll
        for (int e = 0; e < 8; ++e) raw[e] = __ldg(reinterpret_cast<const uint4*>(src + e * p.HW));
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint4 o = make_uint4(0u, 0u, 0u, 0u);  // outside the image and past C: zeros
        if (live) {
          float xs[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const uint32_t word = (&raw[e].x)[q / 2];
            xs[e] = __uint_as_float(q % 2 ? word & 0xffff0000u : word << 16);
          }
          o = activate8(xs, av, bv);
        }
        *reinterpret_cast<uint4*>(dst + at + q * kWgLD) = o;
      }
    }
    for (int i = st; i < halo; i += kWgStagers) {  // kw = 3: slab columns 0 and TW + 1
      const int cg = i % 8, side = (i / 8) % 2, row = i / 16;
      const int ww = side ? w0 + p.TW : w0 - 1;
      const int es = e0 - KH / 2 + row, n = es / EH, hh = es % EH - KH / 2;
      const int c = ck + cg * 8;
      uint4 o = make_uint4(0u, 0u, 0u, 0u);
      if (n < p.N && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W && c < p.C) {
        float xs[8], av[8], bv[8];
        load_ab(p, n * p.C + c, av, bv);
        const __nv_bfloat16* src = p.x + (n * p.C + c) * p.HW + hh * p.W + ww;
#pragma unroll
        for (int e = 0; e < 8; ++e) xs[e] = __bfloat162float(src[e * p.HW]);
        o = activate8(xs, av, bv);
      }
      *reinterpret_cast<uint4*>(dst + (row * SW + side * (p.TW + 1)) * kWgLD + cg * 8) = o;
    }
    mbar_arrive(&slab_full[buf]);
  }
}

// The stagers' general path (any W, TW and alignment): an item is 8
// channels of one position, read as 8 two-byte loads; item i is channel
// group i / npos at position i % npos, so neighbouring threads read
// neighbouring pixels. A table maps each slab position to x's offset of its
// channel 0 (-1 in the halo) and its image.
template <int KH, int KW>
__device__ __forceinline__ void stage_items(const WgArgs& p, __nv_bfloat16* slab, int slab_elems,
                                            uint64_t* slab_full, uint64_t* slab_empty, int2* tab, int st,
                                            int e0, int w0, int k0, int nk, int npos) {
  const int EH = p.H + KH - 1, SW = p.TW + KW - 1;
  for (int pos = st; pos < npos; pos += kWgStagers) {
    const int es = e0 - KH / 2 + pos / SW;
    const int n = es / EH, hh = es % EH - KH / 2, ww = w0 - KW / 2 + pos % SW;
    const bool in = n < p.N && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W;
    tab[pos] = make_int2(in ? n * p.C * p.HW + hh * p.W + ww : -1, n);
  }
  asm volatile("bar.sync 2, %0;\n" ::"n"(kWgStagers) : "memory");
  const int cg0 = st / npos, pos0 = st % npos;  // this thread's items: st + 224 j, no division
  for (int kk = 0; kk < nk; ++kk) {
    const int buf = kk & 1;
    mbar_wait(&slab_empty[buf], ((kk >> 1) & 1) ^ 1);
    __nv_bfloat16* dst = slab + buf * slab_elems;
    const int ck = (k0 + kk) * kWgCK;
    int cg = cg0, pos = pos0;
    while (cg < 8) {  // kBatch items' loads in flight at once
      float xs[kBatch][8], av[kBatch][8], bv[kBatch][8];
      int soff[kBatch];
      bool live[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        soff[u] = -1;
        live[u] = false;
        if (cg < 8) {
          const int2 t = tab[pos];
          const int c = ck + cg * 8;
          soff[u] = pos * kWgLD + cg * 8;
          live[u] = t.x >= 0 && c < p.C;  // C % 8 == 0: 8 channels all in or all out
          if (live[u]) {
            load_ab(p, t.y * p.C + c, av[u], bv[u]);
            const __nv_bfloat16* src = p.x + t.x + c * p.HW;
#pragma unroll
            for (int e = 0; e < 8; ++e) xs[u][e] = __bfloat162float(src[e * p.HW]);
          }
          pos += kWgStagers;
          while (pos >= npos) {
            pos -= npos;
            ++cg;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (soff[u] < 0) continue;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);  // the halo and channels past C: zeros
        if (live[u]) v = activate8(xs[u], av[u], bv[u]);
        *reinterpret_cast<uint4*>(dst + soff[u]) = v;
      }
    }
    mbar_arrive(&slab_full[buf]);
  }
}

// Writes y from the f32 tile(s) [channel][pixel] at `epi`: each element the
// sum, in split order, of the same element of the `splits` tiles of the
// cluster (this CTA's own tile without a split), plus the bias. The
// consumer threads of CTA `part` of `parts` take every parts-th pair of
// channels; each warp stores runs of neighbouring pixels.
template <int BN>
__device__ __forceinline__ void store_tile(const WgArgs& p, const float* epi, int splits, int part,
                                           int parts, int r0, int w0, int o0) {
  const int ctid = threadIdx.x - 32 * kWgC0;
  const int m = ctid % kWgBM;
  const int R = r0 + m / p.TW, w = w0 + m % p.TW;
  if (m >= p.TR * p.TW || R >= p.rows || w >= p.W) return;
  const long long pix = (long long)(R / p.H) * p.O * p.HW + (long long)(R % p.H) * p.W + w;
  for (int oo = ctid / kWgBM + 2 * part; oo < BN && o0 + oo < p.O; oo += 2 * parts) {
    float v = epi[oo * kWgEpiLD + m];
    if (splits > 1) {
      const uint32_t at = smem_addr(epi + oo * kWgEpiLD + m);
      v = 0.0f;
      for (int r = 0; r < splits; ++r) v += ld_cluster_f32(cluster_addr(at, r));
    }
    if (p.bias != nullptr) v += __bfloat162float(p.bias[o0 + oo]);
    p.y[pix + (long long)(o0 + oo) * p.HW] = __float2bfloat16_rn(v);
  }
}

// The consumers: two warpgroups (warps 8-11, 12-15) of 64 pixels each, the
// products of every (chunk, tap), then the accumulators into shared memory
// as f32 [channel][pixel] (over the slabs, free by then) and, without a
// split, on to y.
template <int KH, int KW, int BN>
__device__ __forceinline__ void consume(const WgArgs& p, unsigned char* ring, __nv_bfloat16* slab,
                                        uint64_t* full, uint64_t* empty, uint64_t* slab_full,
                                        uint64_t* slab_empty, int r0, int w0, int o0, int nk, int e0) {
  constexpr int TAPS = KH * KW;
  constexpr int kTile = BN * 128;
  const int EH = p.H + KH - 1, SW = p.TW + KW - 1;
  const int slab_elems = p.npos_cap * kWgLD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, cw = warp - kWgC0;
  // This lane's ldmatrix row: pixel m of the tile (consumer warp cw holds
  // rows 16 cw .. 16 cw + 15), at tap (0, 0). Pixels outside the image read
  // position 0 and are not stored.
  uint32_t a_addr;
  {
    const int m = cw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int R = r0 + m / p.TW, wc = m % p.TW;
    const int ext = (R / p.H) * EH + R % p.H + KH / 2;
    const int pos = m < p.TR * p.TW && R < p.rows && w0 + wc < p.W ? (ext - e0) * SW + wc : 0;
    a_addr = smem_addr(slab) + (pos * kWgLD + (lane >> 4) * 8) * 2;
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t af[4][4];  // A fragments of one tap: four k16 slices
  int s = 0;  // weight tile (chunk, tap) in stream order
  for (int kk = 0; kk < nk; ++kk) {
    mbar_wait(&slab_full[kk & 1], (kk >> 1) & 1);
    const uint32_t cur = a_addr + (kk & 1) * slab_elems * 2;
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap, ++s) {
      const int slot = s % kWgStages;
      const uint32_t row = cur + ((tap / KW) * SW + tap % KW) * (kWgLD * 2);
#pragma unroll
      for (int q = 0; q < 4; ++q) ldsm_x4(af[q], row + q * 32);
      if (tap == TAPS - 1) mbar_arrive(&slab_empty[kk & 1]);  // this thread's reads of the slab are done
      mbar_wait(&full[slot], (s / kWgStages) & 1);
      wgmma_fence();
      const uint64_t bd = desc_sw128(ring + slot * kTile);
#pragma unroll
      for (int q = 0; q < 4; ++q) wgmma_rs_k(acc, af[q], bd + 2 * q);  // +32 bytes a k16 slice
      wgmma_commit();
      wgmma_wait<0>();  // the tile and the fragments are free again
      mbar_arrive(&empty[slot]);
    }
  }
  fence_regs(acc);

  consumer_sync();  // the stagers wrote their last chunk before it was read: the slabs are free
  float* epi = reinterpret_cast<float*>(slab);
  {
    const int g = lane / 4, t = lane % 4, row = cw * 16 + g;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) epi[(8 * i + 2 * t + (e & 1)) * kWgEpiLD + row + (e >> 1) * 8] = acc[4 * i + e];
  }
  if (p.splits == 1) {
    consumer_sync();
    store_tile<BN>(p, epi, 1, 0, 1, r0, w0, o0);
  }
}

template <int KH, int KW, int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
gn_silu_conv_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const WgArgs p) {
  constexpr int TAPS = KH * KW;
  constexpr int kTile = BN * 128;  // one tap's weights: BN rows of 64 channels
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem + kWgStages * kTile);
  const int slab_elems = p.npos_cap * kWgLD;
  int2* tab = reinterpret_cast<int2*>(smem + kWgStages * kTile + wg_region_bytes(BN, p.npos_cap));
  uint64_t* full = reinterpret_cast<uint64_t*>(tab + p.npos_cap);  // weight tiles
  uint64_t* empty = full + kWgStages;
  uint64_t* slab_full = empty + kWgStages;  // the two slab buffers
  uint64_t* slab_empty = slab_full + 2;

  // The tile: image rows r0 .. r0 + TR - 1 of all N*H (they may span
  // images), columns w0 .. w0 + TW - 1; output channels o0 .. o0 + BN - 1;
  // input-channel chunks k0 .. k0 + nk - 1 (split blockIdx.z).
  const int r0 = (blockIdx.x / p.tiles_w) * p.TR, w0 = (blockIdx.x % p.tiles_w) * p.TW;
  const int o0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * p.chunks_per_split;
  const int nk = min(p.chunks - k0, p.chunks_per_split);
  // Extended row of image row R: each image's rows with its halo rows.
  const int EH = p.H + KH - 1;
  auto ext = [&](int R) { return (R / p.H) * EH + R % p.H + KH / 2; };
  const int e0 = ext(r0);  // the slab's row 0 is extended row e0 - KH / 2
  const int SW = p.TW + KW - 1;
  const int npos = (ext(min(r0 + p.TR, p.rows) - 1) - e0 + KH) * SW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWgConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&slab_full[b], kWgStagers);
      mbar_init(&slab_empty[b], kWgConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {  // the producer: one lane streams the weight tiles
    if (lane == 0) {
      tma_prefetch(&wmap);
      for (int s = 0; s < nk * TAPS; ++s) {
        const int slot = s % kWgStages;
        mbar_wait(&empty[slot], ((s / kWgStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[slot], kTile);
        tma_load_3d(ring + slot * kTile, &wmap, &full[slot], (k0 + s / TAPS) * kWgCK, s % TAPS, o0);
      }
    }
  } else if (warp < kWgC0) {  // the stagers: silu(x*a+b) of each chunk into a slab buffer
    const int st = threadIdx.x - 32;
    if (p.wide)
      stage_wide<KH, KW>(p, slab, slab_elems, slab_full, slab_empty, st, e0, w0, k0, nk, npos / SW);
    else
      stage_items<KH, KW>(p, slab, slab_elems, slab_full, slab_empty, tab, st, e0, w0, k0, nk, npos);
  } else {
    consume<KH, KW, BN>(p, ring, slab, full, empty, slab_full, slab_empty, r0, w0, o0, nk, e0);
  }
  if (p.splits > 1) {
    // The splits of one tile are one cluster along z: once every split's
    // tile is in its shared memory, each CTA adds its share of the channels
    // across the cluster in split order (equal bits in every launch, no
    // atomics, no workspace), and none leaves while a peer may still read
    // its tile.
    cluster_sync();
    if (warp >= kWgC0)
      store_tile<BN>(p, reinterpret_cast<const float*>(slab), p.splits, (int)cluster_rank(), p.splits, r0,
                     w0, o0);
    cluster_sync();
  }
}

// The most slab positions a tile of TR rows x TW columns needs: the span of
// extended rows its image rows cover, plus the halo. The pattern repeats
// every H tiles, and the clipped last tile covers fewer rows.
int slab_positions(int N, int H, int kh, int kw, int tw, int tr) {
  const int rows = N * H, EH = H + kh - 1;
  auto ext = [&](int R) { return (R / H) * EH + R % H + kh / 2; };
  int most = 0;
  for (long long r0 = 0; r0 < rows && r0 < (long long)tr * H; r0 += tr) {
    const int last = (int)(r0 + tr < rows ? r0 + tr : rows) - 1;
    const int n = (ext(last) - ext((int)r0) + kh) * (tw + kw - 1);
    most = n > most ? n : most;
  }
  return most;
}

template <int KH, int KW, int BN>
cudaError_t launch_wgmma(const CUtensorMap& map, const WgArgs& p, dim3 grid, int smem, cudaStream_t st) {
  auto kern = gn_silu_conv_wgmma_kernel<KH, KW, BN>;
  static const cudaError_t attr =  // once per instance (the port drives one card)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgMaxSmem);
  if (attr != cudaSuccess) return attr;
  if (p.splits == 1) {
    kern<<<grid, kWgThreads, smem, st>>>(map, p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];  // the splits of a tile: one cluster along z
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = (unsigned)p.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, map, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16 route, from the plan's tile sizes (ops/fused_conv.py::conv_plan);
// refuses a plan the kernel cannot run.
int conv_bf16_wgmma(const void* x, const float* a, const float* b, const void* w, const void* bias,
                    void* y, int N, int C, int H, int W, int O, int kh, int kw, int bn, int tw,
                    int tr, int npos_cap, int chunks_per_split, cudaStream_t st) {
  if ((bn != 160 && bn != 32) || tw < 1 || tr < 1 || tw * tr > kWgBM || npos_cap > kWgMaxPos ||
      chunks_per_split < 1 || C % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (long long)N * C * H * W >= (1ll << 31) || npos_cap < slab_positions(N, H, kh, kw, tw, tr))
    return (int)cudaErrorInvalidValue;
  const int chunks = (C + kWgCK - 1) / kWgCK;
  const int splits = (chunks + chunks_per_split - 1) / chunks_per_split;
  const long long rows = (long long)N * H, tiles_w = (W + tw - 1) / tw;
  const long long tiles = (rows + tr - 1) / tr * tiles_w;
  const int o_tiles = (O + bn - 1) / bn;
  if (splits > kWgMaxSplits || tiles >= (1ll << 31) || o_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  // the weight (O, kh, kw, C) as a 3-D map over (C, taps, O): boxes of 64
  // channels of one tap for bn output channels, 128-byte swizzle, zeros
  // past C and O
  CUtensorMap map;
  const int taps = kh * kw;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)taps, (cuuint64_t)O};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)taps * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kWgCK, 1, (cuuint32_t)bn}, elem[3] = {1, 1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  WgArgs p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.a = a;
  p.b = b;
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.N = N;
  p.C = C;
  p.H = H;
  p.W = W;
  p.O = O;
  p.HW = H * W;
  p.rows = (int)rows;
  p.TW = tw;
  p.TR = tr;
  p.tiles_w = (int)tiles_w;
  p.npos_cap = npos_cap;
  p.chunks = chunks;
  p.chunks_per_split = chunks_per_split;
  p.splits = splits;
  p.wide = W % 8 == 0 && tw % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int smem = 1024 + kWgStages * bn * 128 + wg_region_bytes(bn, npos_cap) + 8 * npos_cap +
                   8 * (2 * kWgStages + 4);
  if (smem > kWgMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)o_tiles, (unsigned)splits);
  cudaError_t err;
  if (kw == 3)
    err = bn == 160 ? launch_wgmma<3, 3, 160>(map, p, grid, smem, st) : launch_wgmma<3, 3, 32>(map, p, grid, smem, st);
  else
    err = bn == 160 ? launch_wgmma<3, 1, 160>(map, p, grid, smem, st) : launch_wgmma<3, 1, 32>(map, p, grid, smem, st);
  return (int)err;
}

}  // namespace

}  // namespace t2v

extern "C" {

// x: (N, C, H, W) contiguous, dtype `dtype`; a, b: (N, C) float32 (from
// t2v_group_norm_affine); w: (O, kh, kw, C) and bias: (O,) or null, both of
// x's dtype; y: (N, O, H, W). (kh, kw) is (3, 3) or (3, 1). bf16 takes the
// plan (bn, tw, tr, npos_cap, chunks_per_split) of ops/fused_conv.py::conv_plan;
// f32 ignores it.
int t2v_gn_silu_conv_fwd(const void* x, const void* a, const void* b, const void* w,
                         const void* bias, void* y, int dtype, int N, int C, int H, int W,
                         int O, int kh, int kw, int bn, int tw, int tr, int npos_cap,
                         int chunks_per_split, void* stream) {
  if (kh != 3 || (kw != 3 && kw != 1) || N < 1 || C < 1 || H < 1 || W < 1 || O < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2v::kBF16)
    return t2v::conv_bf16_wgmma(x, static_cast<const float*>(a), static_cast<const float*>(b), w, bias, y,
                                N, C, H, W, O, kh, kw, bn, tw, tr, npos_cap, chunks_per_split, st);
  if (dtype != t2v::kF32) return (int)cudaErrorInvalidValue;
  t2v::ConvArgs p;
  p.x = x;
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.w = w;
  p.bias = bias;
  p.y = y;
  p.C = C;
  p.H = H;
  p.W = W;
  p.O = O;
  p.kh = kh;
  p.kw = kw;
  // 16-pixel-wide tiles, 8 rows high
  p.TW = W < t2v::kCvTW ? W : t2v::kCvTW;
  p.TH = t2v::kCvBN / p.TW;
  p.tiles_w = (W + p.TW - 1) / p.TW;
  const int tiles_h = (H + p.TH - 1) / p.TH;
  const dim3 grid((unsigned)(tiles_h * p.tiles_w), (unsigned)((O + t2v::kCvBM - 1) / t2v::kCvBM),
                  (unsigned)N);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  t2v::gn_silu_conv_f32_kernel<<<grid, t2v::kCvThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
