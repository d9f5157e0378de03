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
// (O, C, kh, kw) once a call), so a stage's rows are 16-byte runs. Implicit
// GEMM per image: M = output channels, N = pixels, K = C*kh*kw. A block owns
// 64 output channels x 128 pixels (a TH x TW rectangle, TW = min(W, 16),
// TH = 128 / TW) and walks K in stages of 16 input channels. Each stage:
// - the weights of all taps are copied with cp.async into one of two
//   shared-memory buffers while the block multiplies the other;
// - the raw x of the next stage's slab (the rectangle plus its halo,
//   (TH+kh-1) x (TW+kw-1) positions, channels innermost) is loaded into
//   registers during this stage's products, then written to shared memory
//   as silu(x*a+b) rounded to bf16, the TPU kernel's rounding point (its
//   xp_ref) and the port's GroupNorm+SiLU output's;
// - one k16 step of mma.sync m16n8k16 per tap reads the tap's shifted
//   slab positions through ldmatrix.
// So x is read once per 64 output channels and the normalised tensor never
// reaches device memory.
//
// Bound: at the UNet's shapes the work is ~2*O*9 flops per input element
// read, far above the H100's ~295 flop/byte ridge: operations bound. The
// kernel is far from it: mma.sync, not wgmma; the activation of a stage is
// recomputed by each of the ceil(O/64) blocks that share its pixels, and
// its staging competes with the products for issue slots. f32 runs scalar
// FMAs (no TF32), for the reference phases.
#include "flash_mma.cuh"

namespace t2v {

constexpr int kCvBM = 64;        // output channels a block
constexpr int kCvBN = 128;       // pixels a block
constexpr int kCvTW = 16;        // their width, at most
constexpr int kCvThreads = 256;  // 8 warps: 2 (M) x 4 (N), 32 x 32 outputs each
constexpr int kCvMaxTaps = 9;    // 3x3
// (TH + 2) * (TW + 2) with TH * TW <= 128: at most 3 * 130 positions
constexpr int kCvMaxSlab = 390;
// bf16: 16 channels a stage, rows of 24 (16 + 8 padding): a lane's 32-bit
// fragment loads for 8 consecutive positions / weight rows hit 32 banks.
constexpr int kCvCK = 16;
constexpr int kCvLD = 24;
// f32: 8 channels a stage, slab rows of 9 (conflict-free along positions).
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

// silu for the bf16 kernel, whose result is rounded to bf16 (2^-9): the
// approximate exp and reciprocal (relative errors ~2^-21) change a rounded
// value at most rarely, by one ulp, and cost a few instructions instead of
// expf's and an IEEE division's few dozen, in the staging whose instruction
// count bounded the first build of this kernel (PERF.md).
__device__ __forceinline__ float silu_bf16(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// ldmatrix.x4 (not transposed): lane l gives the row address of matrix l / 8, row l % 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The bf16 kernel stages its slab in two steps, so that the global loads of
// stage k + 1 are in flight while the block runs stage k's products:
// x_load reads the raw x of this thread's slab positions into registers,
// x_store writes silu(x*a+b), rounded to bf16, into shared memory. A thread
// owns the positions (tid / 2) + 128 k and the channel half tid % 2 of the
// stage; halo positions outside the image are zeros of the ACTIVATION.
constexpr int kCvItems = 4;   // ceil(kCvMaxSlab / 128) positions a thread
struct XStage {
  uint32_t xr[kCvItems][4];   // 8 raw bf16 a position
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0: zero-fill
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void x_load(XStage& st, const ConvArgs& p, const ConvTile& tile,
                                       const __nv_bfloat16* x, const int (&xoff)[kCvItems],
                                       unsigned valid, int c0) {
  const int half = threadIdx.x & 1;
  const int cb = c0 + half * 8;
  const __nv_bfloat16* xc = x + cb * tile.HW;
#pragma unroll
  for (int k = 0; k < kCvItems; ++k) {
    const __nv_bfloat16* src = xc + xoff[k];
    const bool in = (valid >> k) & 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned short lo = in && cb + 2 * e < p.C ? __bfloat16_as_ushort(src[(2 * e) * tile.HW]) : 0;
      const unsigned short hi =
          in && cb + 2 * e + 1 < p.C ? __bfloat16_as_ushort(src[(2 * e + 1) * tile.HW]) : 0;
      st.xr[k][e] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
  }
}

__device__ __forceinline__ void x_store(const XStage& st, const ConvArgs& p, const ConvTile& tile,
                                        const float* a, const float* b, unsigned valid, int c0,
                                        __nv_bfloat16* s_x) {
  const int half = threadIdx.x & 1;
  float av[8], bv[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c0 + half * 8 + e;
    av[e] = c < p.C ? a[c] : 0.0f;
    bv[e] = c < p.C ? b[c] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kCvItems; ++k) {
    const int ps = (threadIdx.x >> 1) + 128 * k;
    if (ps >= tile.npos) break;
    uint4 packed;
    uint32_t* words = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + half * 8 + 2 * e;
      const bool in = (valid >> k) & 1;
      const float x0 = __bfloat162float(__ushort_as_bfloat16((unsigned short)(st.xr[k][e] & 0xffffu)));
      const float x1 = __bfloat162float(__ushort_as_bfloat16((unsigned short)(st.xr[k][e] >> 16)));
      const float v0 = in && c < p.C ? silu_bf16(x0 * av[2 * e] + bv[2 * e]) : 0.0f;
      const float v1 = in && c + 1 < p.C ? silu_bf16(x1 * av[2 * e + 1] + bv[2 * e + 1]) : 0.0f;
      words[e] = pack_bf16(v0, v1);
    }
    *reinterpret_cast<uint4*>(s_x + ps * kCvLD + half * 8) = packed;
  }
}

// weights (O, kh, kw, C): a stage's rows [tap][m][c0, c0 + 16) are two
// 16-byte chunks each, copied asynchronously (zeros past O or C).
template <int TAPS>
__device__ __forceinline__ void w_issue(const ConvArgs& p, const ConvTile& tile,
                                        const __nv_bfloat16* w, int c0, __nv_bfloat16* s_w) {
  for (int i = threadIdx.x; i < kCvBM * TAPS * 2; i += kCvThreads) {
    const int m = i / (TAPS * 2), r = i % (TAPS * 2), tap = r >> 1, h = r & 1;
    const bool in = tile.m0 + m < p.O && c0 + h * 8 < p.C;
    const __nv_bfloat16* src =
        in ? w + ((long long)(tile.m0 + m) * TAPS + tap) * p.C + c0 + h * 8 : w;
    cp_async16(s_w + (tap * kCvBM + m) * kCvLD + h * 8, src, in);
  }
  cp_async_commit();
}

template <int KH, int KW>
__global__ void __launch_bounds__(kCvThreads, 2)
gn_silu_conv_bf16_kernel(ConvArgs p) {
  constexpr int TAPS = KH * KW;
  extern __shared__ __align__(16) unsigned char cv_smem[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(cv_smem);
  __nv_bfloat16* s_w0 = s_x + kCvMaxSlab * kCvLD;  // two stages of weights
  const ConvTile tile(p);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x) + (long long)tile.n * p.C * tile.HW;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);
  const float* a = p.a + (long long)tile.n * p.C;
  const float* b = p.b + (long long)tile.n * p.C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int valid_px = p.TH * p.TW;
  const int mat = lane >> 3, rr = lane & 7;
  int bpos[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = wn * 32 + (2 * j + (mat >> 1)) * 8 + rr;
    bpos[j] = (q < valid_px ? tile.pos(p, q) : 0) * kCvLD + (mat & 1) * 8;
  }
  const int arow = (wm * 32 + (mat & 1) * 8 + rr) * kCvLD + (mat >> 1) * 8;
  int xoff[kCvItems];
  unsigned valid = 0;
#pragma unroll
  for (int k = 0; k < kCvItems; ++k) {
    const int ps = (threadIdx.x >> 1) + 128 * k;
    const int hh = tile.h0 - KH / 2 + ps / tile.SW, ww = tile.w0 - KW / 2 + ps % tile.SW;
    xoff[k] = 0;
    if (ps < tile.npos && hh >= 0 && hh < p.H && ww >= 0 && ww < p.W) {
      xoff[k] = hh * p.W + ww;
      valid |= 1u << k;
    }
  }
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.0f;

  XStage st;
  w_issue<TAPS>(p, tile, w, 0, s_w0);
  x_load(st, p, tile, x, xoff, valid, 0);
  int buf = 0;
  for (int c0 = 0; c0 < p.C; c0 += kCvCK, buf ^= 1) {
    const __nv_bfloat16* s_w = s_w0 + buf * (TAPS * kCvBM * kCvLD);
    x_store(st, p, tile, a, b, valid, c0, s_x);
    cp_async_wait_all();  // this stage's weights (this thread's copies)
    __syncthreads();      // everyone's copies and slab writes
    if (c0 + kCvCK < p.C) {
      w_issue<TAPS>(p, tile, w, c0 + kCvCK, s_w0 + (buf ^ 1) * (TAPS * kCvBM * kCvLD));
      x_load(st, p, tile, x, xoff, valid, c0 + kCvCK);
    }
#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      const int shift = ((tap / KW) * tile.SW + tap % KW) * kCvLD;
      uint32_t af[2][4], bf[2][4];
      ldmatrix_x4(af[0], s_w + tap * kCvBM * kCvLD + arow);
      ldmatrix_x4(af[1], s_w + tap * kCvBM * kCvLD + arow + 16 * kCvLD);
      ldmatrix_x4(bf[0], s_x + bpos[0] + shift);
      ldmatrix_x4(bf[1], s_x + bpos[1] + shift);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t b0 = bf[nt >> 1][(nt & 1) * 2], b1 = bf[nt >> 1][(nt & 1) * 2 + 1];
        mma_16816(acc[0][nt], af[0], b0, b1);
        mma_16816(acc[1][nt], af[1], b0, b1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile.store<__nv_bfloat16>(p, tile.m0 + wm * 32 + mt * 16 + g + (e >> 1) * 8,
                                  wn * 32 + nt * 8 + 2 * t + (e & 1), acc[mt][nt][e]);
}

template <int KH, int KW>
static cudaError_t launch_conv_bf16(dim3 grid, cudaStream_t stream, const ConvArgs& p) {
  const size_t smem = (size_t)(kCvMaxSlab + 2 * KH * KW * kCvBM) * kCvLD * sizeof(__nv_bfloat16);
  static bool attr_set = false;  // once a template instance (the host code is single-threaded)
  if (!attr_set && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(gn_silu_conv_bf16_kernel<KH, KW>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  gn_silu_conv_bf16_kernel<KH, KW><<<grid, kCvThreads, smem, stream>>>(p);
  return cudaSuccess;
}

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

}  // namespace t2v

extern "C" {

// x: (N, C, H, W) contiguous, dtype `dtype`; a, b: (N, C) float32 (from
// t2v_group_norm_affine); w: (O, kh, kw, C) and bias: (O,) or null, both of
// x's dtype; y: (N, O, H, W). (kh, kw) is (3, 3) or (3, 1).
int t2v_gn_silu_conv_fwd(const void* x, const void* a, const void* b, const void* w,
                         const void* bias, void* y, int dtype, int N, int C, int H, int W,
                         int O, int kh, int kw, void* stream) {
  if (kh != 3 || (kw != 3 && kw != 1) || N < 1 || C < 1 || H < 1 || W < 1 || O < 1 || N > 65535)
    return (int)cudaErrorInvalidValue;
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
  // 16-pixel-wide tiles, 8 rows high: the slab's halo is then 1.4x the
  // pixels for 3x3 and 1.25x for (3,1) (a 128 x 1 tile stages 3x for (3,1))
  p.TW = W < t2v::kCvTW ? W : t2v::kCvTW;
  p.TH = t2v::kCvBN / p.TW;
  p.tiles_w = (W + p.TW - 1) / p.TW;
  const int tiles_h = (H + p.TH - 1) / p.TH;
  const dim3 grid((unsigned)(tiles_h * p.tiles_w), (unsigned)((O + t2v::kCvBM - 1) / t2v::kCvBM),
                  (unsigned)N);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == t2v::kBF16) {
    // the weights come as (O, kh, kw, C): 16-byte rows need an aligned base
    // and C a multiple of 8
    if (reinterpret_cast<uintptr_t>(w) % 16 != 0 || C % 8 != 0) return (int)cudaErrorInvalidValue;
    const cudaError_t err = kw == 3 ? t2v::launch_conv_bf16<3, 3>(grid, st, p)
                                    : t2v::launch_conv_bf16<3, 1>(grid, st, p);
    if (err != cudaSuccess) return (int)err;
  }
  else if (dtype == t2v::kF32)
    t2v::gn_silu_conv_f32_kernel<<<grid, t2v::kCvThreads, 0, st>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
