// GroupNorm(+SiLU) and LayerNorm(+SiLU) forward for Hopper.
//
// Replaces the Pallas TPU kernels t2v_turbo_tpu/ops/fused_norms.py::_gn_kernel
// (entry fused_group_norm) and ::_ln_kernel (entry fused_layer_norm).
//
// Both are bound by device-memory bytes: a handful of flops per element
// against 2-4 bytes read and written, far below the H100's ~295 flop/byte
// ridge. The math is the reference's exactly: f32 statistics, the mean first,
// then the centred variance (no E[x^2]-E[x]^2 cancellation), then normalise,
// f32 affine and optional SiLU, stored in the input dtype.
//
// GroupNorm layout: channels-first and contiguous, (N, C, *spatial). Each
// (sample, group) is then one contiguous span of L = (C/G)*S elements, so the
// kernel treats x as R = N*G rows of length L. The TPU kernel held a whole
// frame in VMEM and gated everything above 4 MB off to XLA; a Hopper block
// has at most 227 KB of shared memory, and the shapes on the main path reach
// L = 655,360 (the VAE's full-resolution GroupNorm) and L = 409,600 with only
// 32 rows (the TemporalTransformer's whole-clip GroupNorm). So every row is
// split into chunks, one block per (row, chunk), and the two-pass statistics
// are done in three launches:
//   1. gn_sum:   per-chunk sums of x                       -> part1[R, P]
//   2. gn_sqdev: per-chunk sums of (x - mean)^2, mean from part1 -> part2
//   3. gn_apply: mean and variance from part1/part2, normalise, affine, act.
// Partials are combined by one thread in a fixed order: the result is
// deterministic. The cost is three reads and one write of x where one read
// and one write would be the floor; the second and third read often hit the
// 50 MB L2 at the UNet's per-frame shapes. Rows move as 16-byte vectors
// when the pointers are aligned and the spatial size is a multiple of the
// vector width (every shape on the main path), else element by element.
// The fused GroupNorm+SiLU+conv (fused_conv.cu) reuses the first two passes
// through t2v_group_norm_affine, whose third launch folds the statistics
// into per-(sample, channel) scale and shift instead.
//
// LayerNorm: one warp per row of (R, C) (C is at most a few thousand on the
// path), lanes stride the row, warp shuffles reduce. The row's second and
// third reads come from L1.
#include "common.cuh"

namespace t2v {

constexpr int kGnThreads = 256;
constexpr int kGnChunk = 8192;  // elements per block: 32 per thread

// Sum of `n` partials in a fixed order (called by one thread).
__device__ __forceinline__ float serial_sum(const float* p, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += p[i];
  return s;
}

// N elements of T moved as one 16-byte vector (VEC) or one at a time.
template <typename T, bool VEC> struct Pack {
  static constexpr int N = VEC ? 16 / sizeof(T) : 1;
  __device__ __forceinline__ static void load(const T* p, float (&v)[N]) {
    if constexpr (VEC) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = to_f32(e[j]);
    } else {
      v[0] = to_f32(p[0]);
    }
  }
  __device__ __forceinline__ static void store(T* p, const float (&v)[N]) {
    if constexpr (VEC) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) e[j] = from_f32<T>(v[j]);
      *reinterpret_cast<uint4*>(p) = raw;
    } else {
      p[0] = from_f32<T>(v[0]);
    }
  }
};

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGnThreads)
gn_sum_kernel(const T* __restrict__ x, int L, float* __restrict__ part1) {
  using V = Pack<T, VEC>;
  __shared__ float scratch[33];
  const long long r = blockIdx.x;
  const int P = gridDim.y;
  const int start = blockIdx.y * kGnChunk;
  const int end = min(start + kGnChunk, L);
  const T* xr = x + r * (long long)L;
  float s = 0.0f;
  for (int i = start + threadIdx.x * V::N; i < end; i += kGnThreads * V::N) {
    float v[V::N];
    V::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) s += v[j];
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) part1[r * P + blockIdx.y] = s;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kGnThreads)
gn_sqdev_kernel(const T* __restrict__ x, int L, const float* __restrict__ part1,
                float* __restrict__ part2) {
  using V = Pack<T, VEC>;
  __shared__ float scratch[33];
  __shared__ float s_mean;
  const long long r = blockIdx.x;
  const int P = gridDim.y;
  if (threadIdx.x == 0) s_mean = serial_sum(part1 + r * P, P) / (float)L;
  __syncthreads();
  const float mean = s_mean;
  const int start = blockIdx.y * kGnChunk;
  const int end = min(start + kGnChunk, L);
  const T* xr = x + r * (long long)L;
  float s = 0.0f;
  for (int i = start + threadIdx.x * V::N; i < end; i += kGnThreads * V::N) {
    float v[V::N];
    V::load(xr + i, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      const float d = v[j] - mean;
      s += d * d;
    }
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) part2[r * P + blockIdx.y] = s;
}

// With VEC, S is a multiple of the vector width, so a vector never straddles
// two channels: one weight/bias lookup per vector.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kGnThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, int L, int S,
                int cg, int G, const float* __restrict__ part1,
                const float* __restrict__ part2, float eps, int act) {
  using V = Pack<T, VEC>;
  __shared__ float s_mean, s_rstd;
  const long long r = blockIdx.x;
  const int P = gridDim.y;
  if (threadIdx.x == 0) {
    const float mean = serial_sum(part1 + r * P, P) / (float)L;
    const float var = serial_sum(part2 + r * P, P) / (float)L;
    s_mean = mean;
    s_rstd = rsqrtf(var + eps);
  }
  __syncthreads();
  const float mean = s_mean, rstd = s_rstd;
  const int c0 = (int)(r % G) * cg;  // first channel of this row's group
  const int start = blockIdx.y * kGnChunk;
  const int end = min(start + kGnChunk, L);
  const long long off = r * (long long)L;
  for (int i = start + threadIdx.x * V::N; i < end; i += kGnThreads * V::N) {
    const int c = c0 + i / S;
    const float sc = rstd * w[c], sh = b[c];
    float v[V::N];
    V::load(x + off + i, v);
#pragma unroll
    for (int j = 0; j < V::N; ++j) {
      float u = (v[j] - mean) * sc + sh;
      v[j] = act ? silu(u) : u;
    }
    V::store(y + off + i, v);
  }
}

template <typename T, bool VEC>
static void launch_group_norm_passes(const T* x, const float* w, const float* b, T* y,
                                     float* part1, float* part2, long long R, int P, int L,
                                     int S, int cg, int G, float eps, int act,
                                     cudaStream_t stream) {
  const dim3 grid((unsigned)R, P);  // rows on x (up to 2^31-1), chunks on y
  gn_sum_kernel<T, VEC><<<grid, kGnThreads, 0, stream>>>(x, L, part1);
  gn_sqdev_kernel<T, VEC><<<grid, kGnThreads, 0, stream>>>(x, L, part1, part2);
  gn_apply_kernel<T, VEC><<<grid, kGnThreads, 0, stream>>>(x, w, b, y, L, S, cg, G, part1,
                                                           part2, eps, act);
}

template <typename T>
static cudaError_t launch_group_norm(const void* x, const float* w, const float* b,
                                     void* y, float* scratch, long long N, int C,
                                     int G, int S, float eps, int act,
                                     cudaStream_t stream) {
  const int cg = C / G;
  const int L = cg * S;
  const int P = (L + kGnChunk - 1) / kGnChunk;
  const long long R = N * G;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  // 16-byte vectors need aligned rows and channels of whole vectors
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(y) % 16 == 0) &&
                   (S % Pack<T, true>::N == 0);
  if (vec)
    launch_group_norm_passes<T, true>(xt, w, b, yt, scratch, scratch + R * P, R, P, L, S, cg, G,
                                      eps, act, stream);
  else
    launch_group_norm_passes<T, false>(xt, w, b, yt, scratch, scratch + R * P, R, P, L, S, cg,
                                       G, eps, act, stream);
  return cudaGetLastError();
}

// The fused GroupNorm+SiLU+conv (fused_conv.cu) takes the statistics from
// the first two passes above, folded with the affine and an optional per-
// (sample, channel) FiLM into a = rstd*w*(1+fs), b = (bias - mean*rstd*w)*(1+fs)
// + fsh: normalised = x*a + b, as the TPU path's _gn_affine_vectors.
// One thread per (sample, channel); each sums its group's partials in the
// same fixed order as gn_apply_kernel.
__global__ void gn_affine_kernel(const float* __restrict__ part1, const float* __restrict__ part2,
                                 int P, int L, int C, int cg, long long NC,
                                 const float* __restrict__ w, const float* __restrict__ b,
                                 const float* __restrict__ film_scale,
                                 const float* __restrict__ film_shift, float eps,
                                 float* __restrict__ a_out, float* __restrict__ b_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NC) return;
  const int c = (int)(i % C);
  const long long r = (i / C) * (C / cg) + c / cg;  // (sample, group) row
  const float mean = serial_sum(part1 + r * P, P) / (float)L;
  const float var = serial_sum(part2 + r * P, P) / (float)L;
  float av = rsqrtf(var + eps) * w[c];
  float bv = b[c] - mean * av;
  if (film_scale != nullptr) {
    const float s = 1.0f + film_scale[i];
    av *= s;
    bv = bv * s + film_shift[i];
  }
  a_out[i] = av;
  b_out[i] = bv;
}

template <typename T>
static cudaError_t launch_group_norm_affine(const void* x, const float* w, const float* b,
                                            const float* fs, const float* fsh, float* a_out,
                                            float* b_out, float* scratch, long long N, int C,
                                            int G, int S, float eps, cudaStream_t stream) {
  const int cg = C / G;
  const int L = cg * S;
  const int P = (L + kGnChunk - 1) / kGnChunk;
  const long long R = N * G;
  const T* xt = static_cast<const T*>(x);
  const dim3 grid((unsigned)R, P);
  float* part2 = scratch + R * P;
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && S % Pack<T, true>::N == 0) {
    gn_sum_kernel<T, true><<<grid, kGnThreads, 0, stream>>>(xt, L, scratch);
    gn_sqdev_kernel<T, true><<<grid, kGnThreads, 0, stream>>>(xt, L, scratch, part2);
  } else {
    gn_sum_kernel<T, false><<<grid, kGnThreads, 0, stream>>>(xt, L, scratch);
    gn_sqdev_kernel<T, false><<<grid, kGnThreads, 0, stream>>>(xt, L, scratch, part2);
  }
  const long long NC = N * C;
  gn_affine_kernel<<<(unsigned)((NC + 255) / 256), 256, 0, stream>>>(
      scratch, part2, P, L, C, cg, NC, w, b, fs, fsh, eps, a_out, b_out);
  return cudaGetLastError();
}

constexpr int kLnRowsPerBlock = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kLnRowsPerBlock)
ln_kernel(const T* __restrict__ x, const float* __restrict__ w,
          const float* __restrict__ b, T* __restrict__ y, long long rows, int C,
          float eps, int act) {
  const long long row = (long long)blockIdx.x * kLnRowsPerBlock + threadIdx.y;
  if (row >= rows) return;  // whole warp leaves together
  const int lane = threadIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += to_f32(xr[c]);
  const float mean = warp_sum(s) / (float)C;
  float s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f32(xr[c]) - mean;
    s2 += d * d;
  }
  const float rstd = rsqrtf(warp_sum(s2) / (float)C + eps);
  for (int c = lane; c < C; c += 32) {
    float v = (to_f32(xr[c]) - mean) * rstd * w[c] + b[c];
    if (act) v = silu(v);
    yr[c] = from_f32<T>(v);
  }
}

template <typename T>
static cudaError_t launch_layer_norm(const void* x, const float* w, const float* b,
                                     void* y, long long R, int C, float eps, int act,
                                     cudaStream_t stream) {
  const dim3 block(32, kLnRowsPerBlock);
  const unsigned grid = (unsigned)((R + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  ln_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), w, b,
                                           static_cast<T*>(y), R, C, eps, act);
  return cudaGetLastError();
}

}  // namespace t2v

extern "C" {

const char* t2v_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch the caller allocates for t2v_group_norm_fwd.
long long t2v_group_norm_scratch(long long N, int C, int G, int S) {
  const long long L = (long long)(C / G) * S;
  const long long P = (L + t2v::kGnChunk - 1) / t2v::kGnChunk;
  return 2 * N * G * P;
}

// x, y: (N, C, S) contiguous, dtype `dtype`; w, b: (C,) float32.
int t2v_group_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       void* scratch, int dtype, long long N, int C, int G, int S,
                       float eps, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float* sc = static_cast<float*>(scratch);
  if (dtype == t2v::kF32)
    return t2v::launch_group_norm<float>(x, wf, bf, y, sc, N, C, G, S, eps, act, st);
  if (dtype == t2v::kBF16)
    return t2v::launch_group_norm<__nv_bfloat16>(x, wf, bf, y, sc, N, C, G, S, eps,
                                                 act, st);
  return (int)cudaErrorInvalidValue;
}

// x: (N, C, S) contiguous, dtype `dtype`; w, b: (C,) float32; film_scale,
// film_shift: (N, C) float32 or both null; a, b out: (N, C) float32;
// scratch: t2v_group_norm_scratch(N, C, G, S) floats.
int t2v_group_norm_affine(const void* x, const void* w, const void* b, const void* film_scale,
                          const void* film_shift, void* a_out, void* b_out, void* scratch,
                          int dtype, long long N, int C, int G, int S, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  const float* fs = static_cast<const float*>(film_scale);
  const float* fsh = static_cast<const float*>(film_shift);
  float* ao = static_cast<float*>(a_out);
  float* bo = static_cast<float*>(b_out);
  float* sc = static_cast<float*>(scratch);
  if ((fs == nullptr) != (fsh == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == t2v::kF32)
    return t2v::launch_group_norm_affine<float>(x, wf, bf, fs, fsh, ao, bo, sc, N, C, G, S, eps, st);
  if (dtype == t2v::kBF16)
    return t2v::launch_group_norm_affine<__nv_bfloat16>(x, wf, bf, fs, fsh, ao, bo, sc, N, C, G,
                                                         S, eps, st);
  return (int)cudaErrorInvalidValue;
}

// x, y: (R, C) contiguous, dtype `dtype`; w, b: (C,) float32.
int t2v_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                       int dtype, long long R, int C, float eps, int act,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == t2v::kF32)
    return t2v::launch_layer_norm<float>(x, wf, bf, y, R, C, eps, act, st);
  if (dtype == t2v::kBF16)
    return t2v::launch_layer_norm<__nv_bfloat16>(x, wf, bf, y, R, C, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
