// Shared helpers for the hand-written Hopper kernels of t2v_turbo_tpu_torch.
//
// The library is built by nvcc into one shared object with a plain C
// interface (ops/cuda_lib.py) and bound with ctypes: every entry point takes
// raw device pointers, sizes, strides and the CUDA stream, launches on that
// stream, allocates nothing and returns cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace t2v {

// dtype codes shared with the Python wrappers (ops/cuda_lib.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two floats rounded to one bf16 pair (lo in the low half): the register
// form of two neighbouring bf16 elements, as tensor-core operands take them.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// x * sigmoid(x), the activation every GN->SiLU call site fuses
__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the whole block; every thread gets the result. blockDim.x must be
// a multiple of 32 and at most 1024. `scratch` holds 33 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? scratch[lane] : 0.0f;
    w = warp_sum(w);
    if (lane == 0) scratch[32] = w;
  }
  __syncthreads();
  const float total = scratch[32];
  __syncthreads();  // scratch may be reused right after
  return total;
}

}  // namespace t2v
