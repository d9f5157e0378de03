// Building blocks of the attention kernels: bf16 tensor-core products on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) in FlashAttention-2's register
// layout and ldmatrix (the short-sequence kernel, small_seq_attention.cu),
// the flash kernels' route codes, the reference's mask value (the f32
// forward) and the quad sum of an mma row (the wgmma kernels too).
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
// f32 kernels of flash_attention.cu and flash_attention_bwd.cu (f32 only),
// the sm_90a wgmma kernels of flash_attention_sm90.cu fed by TMA (which the
// packed route also runs, on packed copies), or the same file's
// head-dim-64 forward fed by its staged producer
enum Route : int { kRouteF32 = 0, kRouteWgmma = 1, kRouteStaged = 2 };

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

}  // namespace t2v
