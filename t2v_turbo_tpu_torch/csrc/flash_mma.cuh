// Building blocks shared by the flash-attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu) kernels: bf16 tensor-core products on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) in FlashAttention-2's register
// layout, and the tile staging they read from.
//
// Register layout of one warp's 16-row tile (lane = 4 * g + t):
// - an mma C fragment s[nt][0..3] holds rows g and g + 8, columns
//   nt * 8 + 2t and 2t + 1 (elements 0, 1 on row g; 2, 3 on row g + 8);
// - an A fragment of 16 x 16 bf16 is four 32-bit pairs: (g, 2t), (g + 8, 2t),
//   (g, 2t + 8), (g + 8, 2t + 8);
// - C fragments of two neighbouring column tiles pack into one A fragment,
//   so a product's output feeds the next product without leaving registers.
#pragma once

#include "common.cuh"

namespace t2v {

constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;  // the reference's

// route codes shared with the Python wrappers (ops/attention.py ROUTES): the
// mma.sync or f32 kernels of flash_attention.cu and flash_attention_bwd.cu,
// the sm_90a wgmma kernels of flash_attention_sm90.cu fed by TMA, or the
// same file's head-dim-64 forward fed by its staged producer
enum Route : int { kRouteMma = 0, kRouteWgmma = 1, kRouteStaged = 2 };

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices, transposed: lane l gives the row address of matrix
// l / 8, row l % 8; register i holds matrix i's (2t, 2t+1; g) pair.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two neighbouring elements of a global row as one A-fragment register
// (zeros past the last row).
__device__ __forceinline__ uint32_t global_pair(const __nv_bfloat16* base, int row, int n_rows,
                                                long long row_stride, int col) {
  if (row >= n_rows) return 0u;
  const __nv_bfloat16* p = base + (long long)row * row_stride + col;
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

// A fragments of rows [r0, r0 + 16) x head-dim columns [d0, d0 + 16 * KC) of
// a global (seq, D) slice; this lane's rows are r0 + g and r0 + g + 8.
template <int KC>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KC][4], const __nv_bfloat16* base,
                                             int row, int n_rows, long long row_stride, int d0,
                                             int t) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = d0 + kc * 16 + 2 * t;
    a[kc][0] = global_pair(base, row, n_rows, row_stride, c);
    a[kc][1] = global_pair(base, row + 8, n_rows, row_stride, c);
    a[kc][2] = global_pair(base, row, n_rows, row_stride, c + 8);
    a[kc][3] = global_pair(base, row + 8, n_rows, row_stride, c + 8);
  }
}

// Stage rows [r0, r0 + BR) of two (seq, D) slices as [row][d] tiles of
// stride LD, element by element (the mma kernels take the views TMA cannot
// read, whose rows need not be 16-byte aligned); zeros past n_rows.
template <int D, int BR, int LD, int NTHREADS>
__device__ __forceinline__ void stage_pair(__nv_bfloat16* sA, __nv_bfloat16* sB,
                                           const __nv_bfloat16* a, const __nv_bfloat16* b,
                                           long long a_ss, long long b_ss, int r0, int n_rows) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  for (int i = threadIdx.x; i < BR * D; i += NTHREADS) {
    const int r = i / D, c = i % D, row = r0 + r;
    sA[r * LD + c] = row < n_rows ? a[(long long)row * a_ss + c] : zero;
    sB[r * LD + c] = row < n_rows ? b[(long long)row * b_ss + c] : zero;
  }
}

// s = A B^T for one warp: A's 16 rows from registers (head-dim chunks
// [d0, d0 + 16 * KC)), B's NT * 8 rows from a [row][d] tile in shared memory.
template <int NT, int KC, int LD>
__device__ __forceinline__ void qk_tile(float (&s)[NT][4], const uint32_t (&qa)[KC][4],
                                        const __nv_bfloat16* sK, int d0, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
    const __nv_bfloat16* krow = sK + (nt * 8 + g) * LD + d0 + 2 * t;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      mma_16816(s[nt], qa[kc], smem_pair(krow + kc * 16), smem_pair(krow + kc * 16 + 8));
  }
}

// acc += P . V for one warp: P (16 x NT * 8) from C fragments, rounded to
// bf16; V from its [row][d] tile through ldmatrix.trans, head-dim columns
// [d0, d0 + 8 * DT).
template <int NT, int DT, int LD>
__device__ __forceinline__ void pv_tile(float (&acc)[DT][4], const float (&s)[NT][4],
                                        const __nv_bfloat16* sV, int d0, int lane) {
  static_assert(DT % 2 == 0, "ldmatrix.x4 feeds two d tiles");
  const int mat = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
    // matrices: rows j*16 + {0..7, 8..15} x d tiles {dt, dt + 1}
    const __nv_bfloat16* row = sV + (j * 16 + (mat & 1) * 8 + rr) * LD + d0 + (mat >> 1) * 8;
#pragma unroll
    for (int dt = 0; dt < DT; dt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + dt * 8);
      mma_16816(acc[dt], pa, b[0], b[1]);
      mma_16816(acc[dt + 1], pa, b[2], b[3]);
    }
  }
}

// 16-byte loads (the short-sequence kernel's staging) and TMA (the wgmma
// route) need 16-byte aligned bf16 rows at every (batch, seq, head): the base
// pointer and the three element strides st3.
inline bool rows_aligned16(const void* p, const long long* st3) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st3[0] % 8 == 0 && st3[1] % 8 == 0 &&
         st3[2] % 8 == 0;
}

// Sum of a value over the 4 lanes of a quad (one mma row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// out[row, d0 + ...] = acc * mult for this lane's rows r0 and r0 + 8.
template <int DT>
__device__ __forceinline__ void store_acc(const float (&acc)[DT][4], float mult0, float mult1,
                                          __nv_bfloat16* out, long long o_ss, int r0, int n_rows,
                                          int d0, int t) {
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = d0 + dt * 8 + 2 * t;
    if (r0 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][0] * mult0, acc[dt][1] * mult0);
    if (r0 + 8 < n_rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r0 + 8) * o_ss + col) =
          __floats2bfloat162_rn(acc[dt][2] * mult1, acc[dt][3] * mult1);
  }
}

}  // namespace t2v
