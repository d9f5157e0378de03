// GroupNorm(+SiLU) (B4), its statistics for the fused GroupNorm+SiLU+conv
// (B7), and LayerNorm(+SiLU) (B5), forward, for Hopper.
//
// Replaces the Pallas TPU kernels t2v_turbo_tpu/ops/fused_norms.py::_gn_kernel
// (entry fused_group_norm) and ::_ln_kernel (entry fused_layer_norm). The
// TPU kernel held a whole frame in VMEM, so it read x once and wrote y once.
//
// Both are bound by device-memory bytes: ~10 f32 operations per element
// against 4 bytes read and written in bf16, far below the H100's ~295
// flop/byte ridge. The floor is one read of x and one write of y. The math
// is the reference's: f32 statistics, the mean, then the centred sum of
// squares (no E[x^2]-E[x]^2 cancellation), then normalise, f32 affine and
// optional SiLU, stored in the input dtype. Every sum is taken in a fixed
// order, so two launches give equal bits.
//
// GroupNorm layout: channels-first and contiguous, (N, C, *spatial). Each
// (sample, group) is one contiguous row of L = (C/G)*S elements: x is R =
// N*G rows. On the paths L runs from 1,600 (the UNet's 5x8 level, per frame)
// to 1,310,720 (the VAE decoder's 256-channel norm at 320x512: 2.6 MB in
// bf16), with 32 rows of up to 409,600 in the whole-clip norms. A block has
// at most 227 KB of shared memory, and a block alone on an SM serialises
// its load, its reductions and its store, so the design is:
// - `cta`: a row (or several tiny rows) fits one block, held whole. Thread 0
//   stages the span in shared memory with 1-D bulk copies (cp.async.bulk,
//   one mbarrier a piece, so the sum starts on the first piece); the block
//   sums, forms the centred sum of squares from the staged copy, normalises
//   and stores: one read and one write of x.
// - `cluster`: a larger row is split over a thread-block cluster of k <= 16
//   blocks, each taking a contiguous chunk. Each block sums its chunk and
//   its squares about its own mean; one exchange through distributed shared
//   memory gives every block the k partials, added in rank order: the row's
//   mean, then its centred sum of squares as the blocks' sums plus n_r (m_r
//   - mean)^2 (exact, every term >= 0), so all blocks hold the same bits and
//   only the slowest block's load is waited for, once.
//   Where a chunk would leave fewer than four blocks an SM (the VAE's 1.3
//   and 2.6 MB rows), a block holds the first part of its chunk in shared
//   memory and re-reads the rest from L2 (ops/norms.py bounds the re-read
//   bytes of the blocks on the card to fit it): device memory still sees
//   one read.
// - `split` (rows a cluster would take but too few to fill the card: the
//   UNet's whole-clip norms, 32 rows of up to 409,600 elements, where every
//   cluster waits for its slowest block's load in one wave): two launches
//   over (row, 8 or 16 KB chunk) blocks, the first writing each chunk's f32
//   partials, the second (a programmatic dependent launch) combining them,
//   re-reading x from L2 and storing.
// - `elementwise` (misaligned pointers, S not a multiple of the 16-byte
//   vector): three launches over (row, 8192-element chunk) blocks, sum,
//   centred sum, apply, one element at a time; they read x three times. No
//   path shape takes it.
// Every 16-byte access is spelled out (ld.shared.v4, st.global.v4): the
// compiler splits a uint4 copy read back as bf16 elements into 2-byte
// shared loads with bank conflicts and 4-byte stores, at about half the
// speed. Each thread issues four loads before it uses one.
// ops/norms.py::gn_plan picks the route, cluster size, chunk, held part,
// rows a block, threads and pieces; the C entry runs that plan or refuses it.
// The statistics mode (t2v_group_norm_affine) is the same kernel and
// exchange; instead of y it writes the per-(sample, channel) scale and
// shift that fold the statistics, affine and an optional FiLM for B7. It
// reads x twice, not three times, and where the tensor fits L2 its plan
// holds nothing: the second read from L2 costs less than staging.
//
// LayerNorm (B5): rows of (R, C). Each row is read once into registers as
// 16-byte vectors, held across the sum, the centred sum and the store; a
// power-of-two group of `lanes` lanes takes a row (ops/norms.py::ln_plan:
// each lane a whole number of vectors where it can), and the reductions are
// xor shuffles inside the group. Misaligned rows or a C that is not a
// multiple of the vector width take a warp-per-row element-wise kernel.
#include "sm90.cuh"

namespace t2v {

// x * sigmoid(x) with the fast exponential and division: a few f32 ulps,
// far below the bf16 output's rounding (the f32 tests allow 1e-5).
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.0f + __expf(-x)); }

// 16-byte vector accesses spelled out: the compiler splits a uint4 copy
// whose bytes are then read as narrower elements into element accesses
// (2-byte shared-memory loads with bank conflicts, 4-byte stores).
__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(sm90::smem_addr(p)));
  return r;
}

__device__ __forceinline__ uint4 ldg128(const void* p) { return __ldg(static_cast<const uint4*>(p)); }

__device__ __forceinline__ void stg128(void* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The elements of a 16-byte vector as f32, unpacked from and packed into its
// four 32-bit words (bf16: element 2i in the low half of word i).
template <typename T> struct Words;
template <> struct Words<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[N]) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <> struct Words<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& r, float (&v)[N]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[N]) {
    return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
};

// ---- GroupNorm, staged routes (cta, cluster) --------------------------------

// Limits of the staged kernel, mirrored in ops/norms.py.
constexpr int kGnMaxThreads = 512;
constexpr int kGnMaxBars = 32;      // rows x pieces a block
constexpr int kGnMaxRows = 16;      // rows a block (cta route)
constexpr int kGnMaxCluster = 16;   // blocks a row (cluster route; > 8 is non-portable)
constexpr int kSmemBlock = 232448;  // shared memory a block may use on the H100
constexpr int kGnStaticSmem = 1024; // reserved for the kernel's own barriers and partials

struct GnArgs {
  const void* x;
  const float* w;
  const float* b;
  void* y;                  // apply mode
  const float* film_scale;  // statistics mode: (N, C) or null
  const float* film_shift;
  float* a_out;             // statistics mode: (N, C)
  float* b_out;
  long long R;              // rows: N * G
  int L, S, cg, G, C;
  float eps;
  int act;
};

// The launch plan (ops/norms.py::GnPlan). Block i of the grid takes rows
// (i / k) * rows ... of x, or for k > 1 chunk (i % k) of row i / k.
struct GnPlan {
  int k;        // blocks a row: the cluster size
  int chunk;    // elements of a row a block takes (the last block takes the rest)
  int staged;   // of which the first `staged` (maybe 0) are held in shared memory, the rest re-read (from L2)
  int rows;     // rows a block (1 unless k == 1)
  int threads;  // a multiple of 32 * rows, at most kGnMaxThreads
  int pieces;   // bulk copies (and mbarriers) a row's chunk arrives in
};

// Sum over the warps of row `row` of this block, in warp order (each warp's
// xor butterfly gives every lane the same bits); every thread gets its row's.
__device__ __forceinline__ float row_sum(float v, float* red, int row, int warps_per_row) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < warps_per_row; ++i) s += red[row * warps_per_row + i];
  __syncthreads();  // red is reused by the next sum
  return s;
}

// fn(v, vector v) for v = v0, v0 + stride, ... < v1, in that order, the
// loads of kSweep vectors issued before the first is used (one at a time,
// each pass sat out the latency of every load).
constexpr int kSweep = 4;
template <typename Load, typename Fn>
__device__ __forceinline__ void sweep(int v0, int v1, int stride, const Load& load, const Fn& fn) {
  int v = v0;
  for (; v + (kSweep - 1) * stride < v1; v += kSweep * stride) {
    uint4 r[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) r[u] = load(v + u * stride);
#pragma unroll
    for (int u = 0; u < kSweep; ++u) fn(v + u * stride, r[u]);
  }
  for (; v < v1; v += stride) fn(v, load(v));
}

template <typename T, bool STATS>
__device__ __forceinline__ void gn_staged(const GnArgs& a, const GnPlan& p) {
  using W = Words<T>;
  constexpr int VE = W::N;  // elements a 16-byte vector
  extern __shared__ __align__(16) unsigned char staged_raw[];
  T* staged = reinterpret_cast<T*>(staged_raw);
  __shared__ uint64_t bars[kGnMaxBars];
  __shared__ float red[kGnMaxThreads / 32];
  __shared__ float part[2], total[2];

  const int k = p.k;
  const uint32_t rank = k > 1 ? sm90::cluster_rank() : 0;
  const long long row0 = (long long)(blockIdx.x / k) * p.rows;
  const int nrows = (int)min((long long)p.rows, a.R - row0);
  const int begin = (int)rank * p.chunk;              // this block's first element of its row(s)
  const int nvec = min(p.chunk, a.L - begin) / VE;    // its vectors of each row ...
  const int nst = min(p.staged / VE, nvec);           // ... the first nst held in shared memory
  const int pvec = (nst + p.pieces - 1) / p.pieces;   // vectors a piece
  const int tpr = blockDim.x / p.rows;                // threads a row
  const int j = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const bool active = j < nrows;
  const long long row = row0 + j;
  const T* mine = staged + (size_t)j * p.staged;
  const T* xr = static_cast<const T*>(a.x) + row * (long long)a.L + begin;  // the rest is re-read from L2
  const auto held = [&](int v) { return lds128(mine + (size_t)v * VE); };
  const auto spilled = [&](int v) { return ldg128(xr + (size_t)v * VE); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < nrows * p.pieces; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int r = 0; r < nrows; ++r) {
      const T* src = static_cast<const T*>(a.x) + (row0 + r) * (long long)a.L + begin;
      for (int q = 0; q < p.pieces && q * pvec < nst; ++q) {
        const int v0 = q * pvec, n = min(pvec, nst - v0);
        uint64_t* bar = &bars[r * p.pieces + q];
        sm90::mbar_arrive_expect_tx(bar, (uint32_t)n * 16u);
        sm90::bulk_load(staged + (size_t)r * p.staged + (size_t)v0 * VE, src + (size_t)v0 * VE, (uint32_t)n * 16u,
                        bar);
      }
    }
  }

  // 1. the sum: the re-read part first (its loads go out while the bulk
  // copies are in flight), then the held part piece by piece as it lands
  float s = 0.0f;
  const auto add = [&](int, const uint4& r) {
    float e[VE];
    W::unpack(r, e);
#pragma unroll
    for (int i = 0; i < VE; ++i) s += e[i];
  };
  if (active) {
    sweep(nst + t, nvec, tpr, spilled, add);
    for (int q = 0; q < p.pieces && q * pvec < nst; ++q) {
      sm90::mbar_wait(&bars[j * p.pieces + q], 0);
      sweep(q * pvec + t, min((q + 1) * pvec, nst), tpr, held, add);
    }
  }
  s = row_sum(s, red, j, tpr >> 5);

  // 2. the sum of squares about this block's own mean, from the held copy
  // and the re-read part (for k = 1 that is the row's mean)
  const float local_mean = s / (float)(nvec * VE);
  float s2 = 0.0f;
  const auto add_sq = [&](int, const uint4& r) {
    float e[VE];
    W::unpack(r, e);
#pragma unroll
    for (int i = 0; i < VE; ++i) {
      const float d = e[i] - local_mean;
      s2 += d * d;
    }
  };
  if (active) {
    sweep(t, nst, tpr, held, add_sq);
    sweep(nst + t, nvec, tpr, spilled, add_sq);
  }
  s2 = row_sum(s2, red, j, tpr >> 5);

  // 3. the row's mean, then its centred sum of squares: block r's sum of
  // squares about its own mean m_r plus n_r (m_r - mean)^2, added over the
  // blocks in rank order (every term >= 0: no E[x^2] - E[x]^2 cancellation)
  float mean = s / (float)a.L;
  if (k > 1) {
    if (threadIdx.x == 0) {
      part[0] = s;
      part[1] = s2;
    }
    sm90::cluster_sync();
    if (threadIdx.x < 32) {
      const uint32_t r = threadIdx.x;
      float sr = 0.0f, qr = 0.0f;
      if (r < (uint32_t)k) {
        sr = sm90::ld_cluster_f32(sm90::cluster_addr(sm90::smem_addr(&part[0]), r));
        qr = sm90::ld_cluster_f32(sm90::cluster_addr(sm90::smem_addr(&part[1]), r));
      }
      float sum = 0.0f;
      for (int q = 0; q < k; ++q) sum += __shfl_sync(0xffffffffu, sr, q);
      const float m = sum / (float)a.L;
      const float nr = (float)min(p.chunk, a.L - (int)r * p.chunk);
      const float dr = sr / nr - m;
      const float term = qr + nr * dr * dr;
      float sq = 0.0f;
      for (int q = 0; q < k; ++q) sq += __shfl_sync(0xffffffffu, term, q);
      if (r == 0) {
        total[0] = m;
        total[1] = sq;
      }
    }
    __syncthreads();
    mean = total[0];
    s2 = total[1];
    sm90::cluster_arrive();  // the last read of a peer's shared memory is done
  }
  const float rstd = rsqrtf(s2 / (float)a.L + a.eps);

  if (active) {
    const int c0 = (int)(row % a.G) * a.cg;  // first channel of the row's group
    if constexpr (STATS) {
      // normalised = x*a + b per (sample, channel), the FiLM folded in, as
      // the TPU path's _gn_affine_vectors (and gn_affine_kernel below)
      if (rank == 0) {
        const long long base = (row / a.G) * a.C + c0;
        for (int i = t; i < a.cg; i += tpr) {
          const int c = c0 + i;
          float av = rstd * a.w[c];
          float bv = a.b[c] - mean * av;
          if (a.film_scale != nullptr) {
            const float f = 1.0f + a.film_scale[base + i];
            av *= f;
            bv = bv * f + a.film_shift[base + i];
          }
          a.a_out[base + i] = av;
          a.b_out[base + i] = bv;
        }
      }
    } else {
      // S is a multiple of VE, so a vector lies in one channel; the channel
      // of this thread's next vector advances by step / S, carried exactly
      T* y = static_cast<T*>(a.y) + row * (long long)a.L + begin;
      const int step = tpr * VE, step_c = step / a.S, step_r = step % a.S;
      const auto apply = [&](int v0, int v1, const auto& load) {
        const int first = begin + v0 * VE;
        int c = c0 + first / a.S, rem = first % a.S;
        sweep(v0, v1, tpr, load, [&](int v, const uint4& r) {
          const float sc = rstd * __ldg(&a.w[c]), sh = __ldg(&a.b[c]);
          float e[VE];
          W::unpack(r, e);
#pragma unroll
          for (int i = 0; i < VE; ++i) {
            const float u = (e[i] - mean) * sc + sh;
            e[i] = a.act ? silu_fast(u) : u;
          }
          stg128(y + (size_t)v * VE, W::pack(e));
          c += step_c;
          rem += step_r;
          if (rem >= a.S) {
            rem -= a.S;
            ++c;
          }
        });
      };
      apply(t, nst, held);
      apply(nst + t, nvec, spilled);
    }
  }
  if (k > 1) sm90::cluster_wait();  // no peer still reads this block's partials
}

// Two kernels (not one template flag) so that a profile names them apart.
template <typename T>
__global__ void __launch_bounds__(kGnMaxThreads) gn_staged_apply_kernel(const GnArgs a, const GnPlan p) {
  gn_staged<T, false>(a, p);
}

template <typename T>
__global__ void __launch_bounds__(kGnMaxThreads) gn_staged_stats_kernel(const GnArgs a, const GnPlan p) {
  gn_staged<T, true>(a, p);
}

template <typename T>
static auto staged_kernel(bool stats) {
  return stats ? gn_staged_stats_kernel<T> : gn_staged_apply_kernel<T>;
}

// Once per kernel: the dynamic shared memory above 48 KB, clusters above 8.
template <typename T>
static cudaError_t configure_staged(bool stats) {
  static bool done[2] = {false, false};
  if (done[stats]) return cudaSuccess;
  const auto kern = staged_kernel<T>(stats);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBlock - kGnStaticSmem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  done[stats] = err == cudaSuccess;
  return err;
}

template <typename T>
static cudaLaunchConfig_t staged_config(const GnPlan& p, unsigned grid, cudaStream_t stream,
                                        cudaLaunchAttribute* cluster) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = (size_t)p.rows * p.staged * sizeof(T);
  cfg.stream = stream;
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = (unsigned)p.k;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = p.k > 1 ? 1 : 0;
  return cfg;
}

// Whether the staged kernel can run plan `p` on rows of L elements: the C
// side refuses what the kernel cannot do instead of running something else.
template <typename T>
static bool staged_plan_ok(const GnPlan& p, long long R, int L, int S) {
  constexpr int VE = Words<T>::N;
  if (p.k < 1 || p.k > kGnMaxCluster || p.rows < 1 || p.rows > kGnMaxRows || (p.rows > 1 && p.k > 1)) return false;
  if (p.threads < 32 * p.rows || p.threads > kGnMaxThreads || p.threads % (32 * p.rows)) return false;
  if (p.pieces < 1 || p.rows * p.pieces > kGnMaxBars || p.chunk < VE || p.chunk % VE || S % VE) return false;
  if (p.staged < 0 || p.staged % VE || p.staged > p.chunk || (p.rows > 1 && p.staged != p.chunk)) return false;
  if ((long long)p.rows * p.staged * (long long)sizeof(T) > kSmemBlock - kGnStaticSmem) return false;
  // the k chunks tile the row: each non-empty
  if ((long long)(p.k - 1) * p.chunk >= L || (long long)p.k * p.chunk < L) return false;
  if (p.rows > 1 && p.chunk != L) return false;
  return (R + p.rows - 1) / p.rows * p.k <= 0x7fffffffLL;
}

template <typename T>
static cudaError_t launch_staged(const GnArgs& a, const GnPlan& p, bool stats, cudaStream_t stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       (stats || reinterpret_cast<uintptr_t>(a.y) % 16 == 0);
  if (!aligned || !staged_plan_ok<T>(p, a.R, a.L, a.S)) return cudaErrorInvalidValue;
  cudaError_t err = configure_staged<T>(stats);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  const unsigned grid = (unsigned)((a.R + p.rows - 1) / p.rows * p.k);
  const cudaLaunchConfig_t cfg = staged_config<T>(p, grid, stream, &cluster);
  err = cudaLaunchKernelEx(&cfg, staged_kernel<T>(stats), a, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
static int max_active_clusters(const GnPlan& p, bool stats) {
  cudaError_t err = configure_staged<T>(stats);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute cluster;
  cudaLaunchConfig_t cfg = staged_config<T>(p, (unsigned)p.k, nullptr, &cluster);
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, staged_kernel<T>(stats), &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// ---- GroupNorm, split route: two launches -----------------------------------
// For rows a cluster would take but too few to fill the card (the whole-clip
// norms: 32 rows, one wave of clusters each waiting for its slowest
// block's load). Blocks of kSplitThreads threads over (row, chunk of
// kSplitThreads * NV vectors; the last chunk of a row the rest), thread t
// holding the chunk's vectors t, t + kSplitThreads, ... in registers. The
// first launch writes each chunk's f32 (sum, sum of squares about the
// chunk's own mean); the second combines a row's partials (below), re-reads
// its chunk (from L2: the tensor fits it), normalises and stores. The second
// is a programmatic dependent launch: its blocks start, and issue their
// re-reads of x (which the first does not write), as the first's blocks
// drain, and wait for the first grid only before reading the partials.
// Device memory sees one read of x and one write of y.
constexpr int kSplitThreads = 256;
constexpr int kSplitMinVecs = 2;  // NV: 2 or 4 vectors a thread (ops/norms.py GN_SPLIT_VECS)
constexpr int kSplitMaxVecs = 4;

template <typename T, int NV>
__device__ __forceinline__ void split_load(const T* xr, int nvec, uint4 (&r)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * kSplitThreads + (int)threadIdx.x;
    r[i] = v < nvec ? ldg128(xr + (size_t)v * Words<T>::N) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int NV>
__global__ void __launch_bounds__(kSplitThreads)
gn_split_part_kernel(const T* __restrict__ x, int L, int chunk, float2* __restrict__ part) {
  using W = Words<T>;
  constexpr int VE = W::N;
  __shared__ float red[kSplitThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;");  // the apply launch may start as blocks drain
  const long long row = blockIdx.x;
  const int P = gridDim.y, begin = blockIdx.y * chunk;
  const int nvec = min(chunk, L - begin) / VE;
  uint4 r[NV];
  split_load<T, NV>(x + row * (long long)L + begin, nvec, r);
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e[VE];
    W::unpack(r[i], e);
#pragma unroll
    for (int q = 0; q < VE; ++q) s += e[q];  // masked vectors hold zeros
  }
  s = row_sum(s, red, 0, kSplitThreads / 32);
  const float local_mean = s / (float)(nvec * VE);
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * kSplitThreads + (int)threadIdx.x < nvec) {
      float e[VE];
      W::unpack(r[i], e);
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const float d = e[q] - local_mean;
        s2 += d * d;
      }
    }
  }
  s2 = row_sum(s2, red, 0, kSplitThreads / 32);
  if (threadIdx.x == 0) part[row * P + blockIdx.y] = make_float2(s, s2);
}

// (mean, rstd) of a row from its P chunk partials `pr`, by one whole warp:
// lane l adds chunks l, l + 32, ... in order, then the xor butterfly; the
// mean first, then the centred sum of squares as the chunks' sums plus n_r
// (m_r - mean)^2 (as the cluster exchange does). `counts`: each chunk's
// elements (any sizes: the chunks of several seq ranks' parts of the row,
// concatenated), or null for the chunks of one row of L elements, `chunk`
// each (the last the rest).
__device__ __forceinline__ float2 combine_partials(const float2* __restrict__ pr, int P, int chunk, int L,
                                                   const int* __restrict__ counts, float eps) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  int n = 0;
  for (int q = lane; q < P; q += 32) {
    s += pr[q].x;
    if (counts != nullptr) n += counts[q];
  }
  if (counts != nullptr) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(0xffffffffu, n, off);
  }
  const float total = counts != nullptr ? (float)n : (float)L;
  const float mean = warp_sum(s) / total;
  float t = 0.0f;
  for (int q = lane; q < P; q += 32) {
    const float2 v = pr[q];
    const float nr = (float)(counts != nullptr ? counts[q] : min(chunk, L - q * chunk));
    const float dr = v.x / nr - mean;
    const float term = v.y + nr * dr * dr;
    t += term;
  }
  t = warp_sum(t);
  return make_float2(mean, rsqrtf(t / total + eps));
}

// The second launch: warp 0 combines the row's P partials, then every
// thread normalises its vectors. P = gridDim.y and counts = null for the
// split route (this launch's own chunks); the partials entry's callers pass
// every seq rank's chunks with their counts.
template <typename T, int NV>
__global__ void __launch_bounds__(kSplitThreads)
gn_split_apply_kernel(const GnArgs a, int chunk, const float2* __restrict__ part, int P,
                      const int* __restrict__ counts) {
  using W = Words<T>;
  constexpr int VE = W::N;
  __shared__ float2 stat;
  const long long row = blockIdx.x;
  const int begin = blockIdx.y * chunk;
  const int nvec = min(chunk, a.L - begin) / VE;
  uint4 r[NV];
  split_load<T, NV>(static_cast<const T*>(a.x) + row * (long long)a.L + begin, nvec, r);
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the first launch's partials are written
  if (threadIdx.x < 32) {
    const float2 st = combine_partials(part + row * P, P, chunk, a.L, counts, a.eps);
    if (threadIdx.x == 0) stat = st;
  }
  __syncthreads();
  const float mean = stat.x, rstd = stat.y;
  const int c0 = (int)(row % a.G) * a.cg;
  T* y = static_cast<T*>(a.y) + row * (long long)a.L + begin;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = i * kSplitThreads + (int)threadIdx.x;
    if (v < nvec) {
      const int c = c0 + (begin + v * VE) / a.S;  // S is a multiple of VE: one channel a vector
      const float sc = rstd * __ldg(&a.w[c]), sh = __ldg(&a.b[c]);
      float e[VE];
      W::unpack(r[i], e);
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const float u = (e[q] - mean) * sc + sh;
        e[q] = a.act ? silu_fast(u) : u;
      }
      stg128(y + (size_t)v * VE, W::pack(e));
    }
  }
}

template <typename T, int NV>
static cudaError_t launch_split_nv(const GnArgs& a, const GnPlan& p, float2* part, cudaStream_t stream) {
  const dim3 grid((unsigned)a.R, (unsigned)p.k);  // rows on x (up to 2^31-1), chunks on y
  gn_split_part_kernel<T, NV><<<grid, kSplitThreads, 0, stream>>>(static_cast<const T*>(a.x), a.L, p.chunk, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kSplitThreads);
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gn_split_apply_kernel<T, NV>, a, p.chunk, (const float2*)part, p.k,
                           (const int*)nullptr);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Apply mode only: the statistics mode is one launch on the staged routes.
template <typename T>
static cudaError_t launch_split(const GnArgs& a, const GnPlan& p, float* scratch, bool stats, cudaStream_t stream) {
  constexpr int VE = Words<T>::N;
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  const int nv = p.chunk / (kSplitThreads * VE);
  if (stats || !aligned || scratch == nullptr || a.S % VE || p.threads != kSplitThreads ||
      p.chunk != nv * kSplitThreads * VE || p.k != (a.L + p.chunk - 1) / p.chunk || p.k > 65535)
    return cudaErrorInvalidValue;
  float2* part = reinterpret_cast<float2*>(scratch);
  if (nv == kSplitMinVecs) return launch_split_nv<T, kSplitMinVecs>(a, p, part, stream);
  return nv == kSplitMaxVecs ? launch_split_nv<T, kSplitMaxVecs>(a, p, part, stream) : cudaErrorInvalidValue;
}

// ---- GroupNorm over a clip sharded along T: the split route's halves alone ---
// A seq rank holds part of every (sample, group) row of the clip. The
// partials entry runs gn_split_part_kernel alone on the rank's part; the
// ranks' partials are gathered (parallel/collectives.py); the apply entry
// runs gn_split_apply_kernel on the rank's part with every rank's partials
// and their explicit counts (a rank's short last chunk sits mid-row once
// they are concatenated); the affine entry folds the same statistics into
// B7's per-(sample, channel) scale and shift. Both combine in the split
// route's order (combine_partials), so the norm and the fold agree.

template <typename T>
static int split_vecs(const GnArgs& a, int chunk, int k) {
  constexpr int VE = Words<T>::N;
  const int nv = chunk / (kSplitThreads * VE);
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       (a.y == nullptr || reinterpret_cast<uintptr_t>(a.y) % 16 == 0);
  if (!aligned || a.S % VE || chunk != nv * kSplitThreads * VE || (nv != kSplitMinVecs && nv != kSplitMaxVecs) ||
      k != (a.L + chunk - 1) / chunk || k > 65535)
    return 0;
  return nv;
}

template <typename T>
static cudaError_t launch_partials(const GnArgs& a, int chunk, int k, float2* part, cudaStream_t stream) {
  const int nv = split_vecs<T>(a, chunk, k);
  if (nv == 0 || part == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.R, (unsigned)k);
  if (nv == kSplitMinVecs)
    gn_split_part_kernel<T, kSplitMinVecs><<<grid, kSplitThreads, 0, stream>>>(static_cast<const T*>(a.x), a.L,
                                                                                chunk, part);
  else
    gn_split_part_kernel<T, kSplitMaxVecs><<<grid, kSplitThreads, 0, stream>>>(static_cast<const T*>(a.x), a.L,
                                                                                chunk, part);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_from_partials(const GnArgs& a, int chunk, int k, const float2* part, int P,
                                        const int* counts, cudaStream_t stream) {
  const int nv = split_vecs<T>(a, chunk, k);
  if (nv == 0 || a.y == nullptr || part == nullptr || counts == nullptr || P < 1) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.R, (unsigned)k);
  if (nv == kSplitMinVecs)
    gn_split_apply_kernel<T, kSplitMinVecs><<<grid, kSplitThreads, 0, stream>>>(a, chunk, part, P, counts);
  else
    gn_split_apply_kernel<T, kSplitMaxVecs><<<grid, kSplitThreads, 0, stream>>>(a, chunk, part, P, counts);
  return cudaGetLastError();
}

// One warp a (sample, group) row: its statistics from the partials, then
// the lanes write a, b of the group's channels (the statistics mode's fold:
// a = rstd * w, b = bias - mean * a, then the FiLM).
constexpr int kAffineRows = 8;  // warps (rows) a block
__global__ void __launch_bounds__(32 * kAffineRows)
gn_partials_affine_kernel(const float2* __restrict__ part, const int* __restrict__ counts, int P, long long R,
                          int G, int C, const float* __restrict__ w, const float* __restrict__ b,
                          const float* __restrict__ film_scale, const float* __restrict__ film_shift, float eps,
                          float* __restrict__ a_out, float* __restrict__ b_out) {
  const long long row = (long long)blockIdx.x * kAffineRows + (threadIdx.x >> 5);
  if (row >= R) return;  // the whole warp leaves together
  const float2 st = combine_partials(part + row * P, P, 0, 0, counts, eps);
  const int cg = C / G, g = (int)(row % G);
  const long long n = row / G;
  for (int j = threadIdx.x & 31; j < cg; j += 32) {
    const int c = g * cg + j;
    const long long i = n * C + c;
    float av = st.y * w[c];
    float bv = b[c] - st.x * av;
    if (film_scale != nullptr) {
      const float s = 1.0f + film_scale[i];
      av *= s;
      bv = bv * s + film_shift[i];
    }
    a_out[i] = av;
    b_out[i] = bv;
  }
}

// ---- GroupNorm, element-wise route ------------------------------------------
// Misaligned pointers or S not a multiple of the 16-byte vector: three
// launches over (row, 8192-element chunk) blocks, one element at a time: the
// sum, the centred sum of squares, the apply (or the fold), combining the
// per-chunk partials in a fixed order. They read x three times.

constexpr int kGnThreads = 256;
constexpr int kGnChunk = 8192;  // elements per block: 32 per thread

// Sum of `n` partials in a fixed order (called by one thread).
__device__ __forceinline__ float serial_sum(const float* p, int n) {
  float s = 0.0f;
  for (int i = 0; i < n; ++i) s += p[i];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_sum_kernel(const T* __restrict__ x, int L, float* __restrict__ part1) {
  __shared__ float scratch[33];
  const long long r = blockIdx.x;
  const int P = gridDim.y;
  const int start = blockIdx.y * kGnChunk;
  const int end = min(start + kGnChunk, L);
  const T* xr = x + r * (long long)L;
  float s = 0.0f;
  for (int i = start + threadIdx.x; i < end; i += kGnThreads) s += to_f32(xr[i]);
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) part1[r * P + blockIdx.y] = s;
}

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_sqdev_kernel(const T* __restrict__ x, int L, const float* __restrict__ part1,
                float* __restrict__ part2) {
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
  for (int i = start + threadIdx.x; i < end; i += kGnThreads) {
    const float d = to_f32(xr[i]) - mean;
    s += d * d;
  }
  s = block_sum(s, scratch);
  if (threadIdx.x == 0) part2[r * P + blockIdx.y] = s;
}

template <typename T>
__global__ void __launch_bounds__(kGnThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, T* __restrict__ y, int L, int S,
                int cg, int G, const float* __restrict__ part1,
                const float* __restrict__ part2, float eps, int act) {
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
  for (int i = start + threadIdx.x; i < end; i += kGnThreads) {
    const int c = c0 + i / S;
    const float sc = rstd * w[c], sh = b[c];
    const float u = (to_f32(x[off + i]) - mean) * sc + sh;
    y[off + i] = from_f32<T>(act ? silu(u) : u);
  }
}

// The statistics mode's last launch on this route: one thread per (sample,
// channel) sums its group's partials in gn_apply_kernel's order and folds
// them with the affine and the FiLM (as the staged kernel does).
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
static cudaError_t launch_elementwise(const GnArgs& a, float* scratch, bool stats, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int P = (a.L + kGnChunk - 1) / kGnChunk;
  const dim3 grid((unsigned)a.R, P);  // rows on x (up to 2^31-1), chunks on y
  const T* x = static_cast<const T*>(a.x);
  float* part2 = scratch + a.R * P;
  gn_sum_kernel<T><<<grid, kGnThreads, 0, stream>>>(x, a.L, scratch);
  gn_sqdev_kernel<T><<<grid, kGnThreads, 0, stream>>>(x, a.L, scratch, part2);
  if (stats) {
    const long long NC = a.R / a.G * a.C;
    gn_affine_kernel<<<(unsigned)((NC + 255) / 256), 256, 0, stream>>>(
        scratch, part2, P, a.L, a.C, a.cg, NC, a.w, a.b, a.film_scale, a.film_shift, a.eps, a.a_out, a.b_out);
  } else {
    gn_apply_kernel<T><<<grid, kGnThreads, 0, stream>>>(x, a.w, a.b, static_cast<T*>(a.y), a.L, a.S, a.cg, a.G,
                                                       scratch, part2, a.eps, a.act);
  }
  return cudaGetLastError();
}

// Route codes, mirrored in ops/norms.py GN_ROUTES.
enum GnRoute : int { kGnCta = 0, kGnCluster = 1, kGnSplit = 2, kGnElementwise = 3 };

template <typename T>
static cudaError_t launch_group_norm(const GnArgs& a, const GnPlan& p, int route, float* scratch, bool stats,
                                    cudaStream_t stream) {
  if ((route == kGnCta) != (p.k == 1) && route <= kGnCluster) return cudaErrorInvalidValue;
  if (route == kGnCta || route == kGnCluster) return launch_staged<T>(a, p, stats, stream);
  if (route == kGnSplit) return launch_split<T>(a, p, scratch, stats, stream);
  if (route == kGnElementwise) return launch_elementwise<T>(a, scratch, stats, stream);
  return cudaErrorInvalidValue;
}

// ---- LayerNorm --------------------------------------------------------------

constexpr int kLnVecThreads = 256;
constexpr int kLnMaxVecs = 10;  // 16-byte vectors a lane holds, at most (ops/norms.py LN_MAX_VECS)

// Lane l of a group of `lanes` (a power of two) holds the row's vectors l,
// l + lanes, ... (at most NV); neighbouring lanes read neighbouring 16 bytes.
template <typename T, int NV>
__global__ void __launch_bounds__(kLnVecThreads)
ln_vec_kernel(const T* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
              T* __restrict__ y, long long R, int C, int lanes, float eps, int act) {
  using W = Words<T>;
  constexpr int VE = W::N;
  const int lane = threadIdx.x & 31, l = lane & (lanes - 1);
  const long long row =
      ((long long)blockIdx.x * (kLnVecThreads / 32) + (threadIdx.x >> 5)) * (32 / lanes) + lane / lanes;
  const bool active = row < R;
  const int nvec = C / VE;
  const long long off = (active ? row : 0) * (long long)C;
  uint4 raw[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = l + i * lanes;
    raw[i] = active && v < nvec ? ldg128(x + off + (long long)v * VE) : make_uint4(0, 0, 0, 0);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float e[VE];
    W::unpack(raw[i], e);
#pragma unroll
    for (int q = 0; q < VE; ++q) s += e[q];  // masked vectors hold zeros
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mean = s / (float)C;
  float s2 = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (l + i * lanes < nvec) {
      float e[VE];
      W::unpack(raw[i], e);
#pragma unroll
      for (int q = 0; q < VE; ++q) {
        const float d = e[q] - mean;
        s2 += d * d;
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  const float rstd = rsqrtf(s2 / (float)C + eps);
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = l + i * lanes;
    if (v < nvec) {
      float e[VE];
      W::unpack(raw[i], e);
#pragma unroll
      for (int q = 0; q < VE; q += 4) {
        const float4 wq = __ldg(reinterpret_cast<const float4*>(w + v * VE + q));
        const float4 bq = __ldg(reinterpret_cast<const float4*>(b + v * VE + q));
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w}, bb[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float h = (e[q + u] - mean) * rstd * ww[u] + bb[u];
          e[q + u] = act ? silu_fast(h) : h;
        }
      }
      stg128(y + off + (long long)v * VE, W::pack(e));
    }
  }
}

template <typename T>
static cudaError_t launch_ln_vec(const void* x, const float* w, const float* b, void* y, long long R, int C,
                                 int lanes, int nv, float eps, int act, cudaStream_t stream) {
  constexpr int VE = 16 / (int)sizeof(T);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  if (!aligned || C % VE || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || nv < 1 || nv > kLnMaxVecs ||
      (long long)lanes * nv * VE < C)
    return cudaErrorInvalidValue;
  const long long rows_per_block = (kLnVecThreads / 32) * (32 / lanes);
  const unsigned grid = (unsigned)((R + rows_per_block - 1) / rows_per_block);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
#define T2V_LN_CASE(NV_)                                                                          \
  case NV_:                                                                                       \
    ln_vec_kernel<T, NV_><<<grid, kLnVecThreads, 0, stream>>>(xt, w, b, yt, R, C, lanes, eps, act); \
    break;
  switch (nv) {
    T2V_LN_CASE(1) T2V_LN_CASE(2) T2V_LN_CASE(3) T2V_LN_CASE(4) T2V_LN_CASE(5)
    T2V_LN_CASE(6) T2V_LN_CASE(7) T2V_LN_CASE(8) T2V_LN_CASE(9) T2V_LN_CASE(10)
  }
#undef T2V_LN_CASE
  return cudaGetLastError();
}

// The element-wise route: one warp per row, lanes striding it, three reads
// of the row (the second and third from L1).
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
static cudaError_t launch_layer_norm(const void* x, const float* w, const float* b, void* y, long long R, int C,
                                     int lanes, int nv, float eps, int act, cudaStream_t stream) {
  if (lanes > 0) return launch_ln_vec<T>(x, w, b, y, R, C, lanes, nv, eps, act, stream);
  const dim3 block(32, kLnRowsPerBlock);
  const unsigned grid = (unsigned)((R + kLnRowsPerBlock - 1) / kLnRowsPerBlock);
  ln_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(x), w, b,
                                           static_cast<T*>(y), R, C, eps, act);
  return cudaGetLastError();
}

static GnArgs gn_args(const void* x, const void* w, const void* b, long long N, int C, int G, int S, float eps) {
  GnArgs a = {};
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.R = N * G;
  a.cg = C / G;
  a.L = a.cg * S;
  a.S = S;
  a.G = G;
  a.C = C;
  a.eps = eps;
  return a;
}

}  // namespace t2v

extern "C" {

const char* t2v_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch the caller allocates for the elementwise route of
// t2v_group_norm_fwd and t2v_group_norm_affine (the split route takes 2 a
// (row, chunk); the staged routes none).
long long t2v_group_norm_scratch(long long N, int C, int G, int S) {
  const long long L = (long long)(C / G) * S;
  const long long P = (L + t2v::kGnChunk - 1) / t2v::kGnChunk;
  return 2 * N * G * P;
}

// x, y: (N, C, S) contiguous, dtype `dtype`; w, b: (C,) float32. `route`
// and the plan (k, chunk, staged, rows, threads, pieces) from
// ops/norms.py::gn_plan;
// scratch: null on the staged routes.
int t2v_group_norm_fwd(const void* x, const void* w, const void* b, void* y, void* scratch, int dtype,
                       long long N, int C, int G, int S, float eps, int act, int route, int k, int chunk,
                       int staged, int rows, int threads, int pieces, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  t2v::GnArgs a = t2v::gn_args(x, w, b, N, C, G, S, eps);
  a.y = y;
  a.act = act;
  const t2v::GnPlan p = {k, chunk, staged, rows, threads, pieces};
  float* sc = static_cast<float*>(scratch);
  if (dtype == t2v::kF32) return t2v::launch_group_norm<float>(a, p, route, sc, false, st);
  if (dtype == t2v::kBF16) return t2v::launch_group_norm<__nv_bfloat16>(a, p, route, sc, false, st);
  return (int)cudaErrorInvalidValue;
}

// The statistics mode for the fused GroupNorm+SiLU+conv: x: (N, C, S)
// contiguous; w, b: (C,) float32; film_scale, film_shift: (N, C) float32 or
// both null; a, b out: (N, C) float32 with film(group_norm(x)) = x*a + b.
// Plan and scratch as t2v_group_norm_fwd.
int t2v_group_norm_affine(const void* x, const void* w, const void* b, const void* film_scale,
                          const void* film_shift, void* a_out, void* b_out, void* scratch, int dtype, long long N,
                          int C, int G, int S, float eps, int route, int k, int chunk, int staged, int rows,
                          int threads, int pieces, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((film_scale == nullptr) != (film_shift == nullptr)) return (int)cudaErrorInvalidValue;
  t2v::GnArgs a = t2v::gn_args(x, w, b, N, C, G, S, eps);
  a.film_scale = static_cast<const float*>(film_scale);
  a.film_shift = static_cast<const float*>(film_shift);
  a.a_out = static_cast<float*>(a_out);
  a.b_out = static_cast<float*>(b_out);
  const t2v::GnPlan p = {k, chunk, staged, rows, threads, pieces};
  float* sc = static_cast<float*>(scratch);
  if (dtype == t2v::kF32) return t2v::launch_group_norm<float>(a, p, route, sc, true, st);
  if (dtype == t2v::kBF16) return t2v::launch_group_norm<__nv_bfloat16>(a, p, route, sc, true, st);
  return (int)cudaErrorInvalidValue;
}

// The split route's partials launch alone: x (N, C, S) contiguous, 16-byte
// aligned, S whole 16-byte vectors; part: (N*G, k) float2, each row's chunks
// of `chunk` elements (256 threads x 2 or 4 vectors; the last the rest;
// k = ceil(L / chunk)): (sum, sum of squares about the chunk's own mean).
int t2v_group_norm_partials(const void* x, void* part, int dtype, long long N, int C, int G, int S, int chunk, int k,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const t2v::GnArgs a = t2v::gn_args(x, nullptr, nullptr, N, C, G, S, 0.0f);
  float2* pr = static_cast<float2*>(part);
  if (dtype == t2v::kF32) return t2v::launch_partials<float>(a, chunk, k, pr, st);
  if (dtype == t2v::kBF16) return t2v::launch_partials<__nv_bfloat16>(a, chunk, k, pr, st);
  return (int)cudaErrorInvalidValue;
}

// The split route's apply launch with given statistics: x, y (N, C, S) as
// above, chunked by (chunk, k); w, b (C,) float32; part (N*G, P) float2 and
// counts (P,) int32: every chunk's partials and element count of each row
// (any number, any sizes: e.g. every seq rank's, in rank order).
int t2v_group_norm_from_partials(const void* x, const void* w, const void* b, void* y, const void* part,
                                 const void* counts, int P, int dtype, long long N, int C, int G, int S, float eps,
                                 int act, int chunk, int k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  t2v::GnArgs a = t2v::gn_args(x, w, b, N, C, G, S, eps);
  a.y = y;
  a.act = act;
  const float2* pr = static_cast<const float2*>(part);
  const int* cn = static_cast<const int*>(counts);
  if (dtype == t2v::kF32) return t2v::launch_from_partials<float>(a, chunk, k, pr, P, cn, st);
  if (dtype == t2v::kBF16) return t2v::launch_from_partials<__nv_bfloat16>(a, chunk, k, pr, P, cn, st);
  return (int)cudaErrorInvalidValue;
}

// B7's a, b out: (N, C) float32 from part (N*G, P) float2 and counts (P,)
// int32 as above; w, b (C,) float32; film_scale, film_shift (N, C) float32
// or both null.
int t2v_group_norm_affine_from_partials(const void* part, const void* counts, int P, const void* w, const void* b,
                                        const void* film_scale, const void* film_shift, void* a_out, void* b_out,
                                        long long N, int C, int G, float eps, void* stream) {
  if (part == nullptr || counts == nullptr || P < 1 || G < 1 || C % G || N < 1 ||
      (film_scale == nullptr) != (film_shift == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long R = N * G;
  const long long blocks = (R + t2v::kAffineRows - 1) / t2v::kAffineRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  t2v::gn_partials_affine_kernel<<<(unsigned)blocks, 32 * t2v::kAffineRows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(part), static_cast<const int*>(counts), P, R, G, C, static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<const float*>(film_scale), static_cast<const float*>(film_shift), eps,
      static_cast<float*>(a_out), static_cast<float*>(b_out));
  return (int)cudaGetLastError();
}

// How many clusters of the staged kernel's plan (k blocks of `threads`,
// rows * staged elements of shared memory each) the card can run at once;
// a negative CUDA error code if the query fails.
int t2v_group_norm_max_clusters(int dtype, int stats, int k, int staged, int rows, int threads) {
  const t2v::GnPlan p = {k, staged, staged, rows, threads, 1};
  if (dtype == t2v::kF32) return t2v::max_active_clusters<float>(p, stats != 0);
  if (dtype == t2v::kBF16) return t2v::max_active_clusters<__nv_bfloat16>(p, stats != 0);
  return -(int)cudaErrorInvalidValue;
}

// x, y: (R, C) contiguous, dtype `dtype`; w, b: (C,) float32. lanes > 0:
// the vector route (lanes a row, nv vectors a lane, from ops/norms.py::
// ln_plan); lanes == 0: the element-wise route.
int t2v_layer_norm_fwd(const void* x, const void* w, const void* b, void* y, int dtype, long long R, int C,
                       float eps, int act, int lanes, int nv, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (dtype == t2v::kF32) return t2v::launch_layer_norm<float>(x, wf, bf, y, R, C, lanes, nv, eps, act, st);
  if (dtype == t2v::kBF16)
    return t2v::launch_layer_norm<__nv_bfloat16>(x, wf, bf, y, R, C, lanes, nv, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
