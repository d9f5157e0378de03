// Hopper (sm_90a) building blocks: TMA tile loads into shared memory,
// mbarriers, and warpgroup matrix products (wgmma) on bf16 tiles of 64 rows
// x 64 columns (128 bytes a row) in the 128-byte swizzled layout that TMA's
// CU_TENSOR_MAP_SWIZZLE_128B writes and wgmma's 128-byte swizzle mode reads.
//
// Such a tile is 8 KB and starts on a 1024-byte boundary; the 16-byte chunk
// c of row r sits at chunk c ^ (r % 8) of that row. One tile serves wgmma in
// two ways:
// - K-major (the product's depth along the row, the head dim): the
//   descriptor of depth slice kk (16 columns) starts kk * 32 bytes into the
//   tile, with 1024 bytes between groups of 8 rows.
// - MN-major (the depth down the rows, the product's N along the row): the
//   descriptor of depth slice kk (16 rows) starts kk * 2048 bytes into the
//   tile, again with 1024 bytes between groups of 8 rows. A 64-wide N is one
//   swizzle atom; a wider N (the head-dim-512 forward's 256 output columns)
//   spans several tiles, whose distance is the descriptor's leading byte
//   offset.
//
// Accumulator layout of m64nNk16 (f32): warp w of the warpgroup holds rows
// 16 w + g and 16 w + g + 8 (lane = 4 g + t), columns 8 i + 2 t and 8 i + 2 t
// + 1 of each 8-column block i, in d[4 i + 0..3] = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1): mma.sync's C fragment, block by block. A
// bf16 A operand from registers uses mma.sync's m16n8k16 A fragment, so two
// neighbouring accumulator blocks pack into one k16 slice of A.
//
// A K-major B operand may have more than 64 rows (the fused conv's 160 or 32
// output channels): its 8-row groups simply continue 1024 bytes apart, as a
// TMA box of that many 128-byte rows lays them out.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace t2v {
namespace sm90 {

constexpr int kTileBytes = 64 * 64 * 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and the
// other threads; follow with a block barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0, polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    // a phase that never completes is a bug: fault (the launch reports it)
    // rather than hang the card
    if (++polls == (1u << 28)) __trap();
  } while (!done);
}

// Thread block clusters: the peer CTAs' shared memory, addressed through mapa.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address in CTA `rank` of the cluster of local shared address `addr`.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// A float of any CTA's shared memory, at a cluster address.
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// cluster_sync in two halves: arrive once this CTA is done reading its peers'
// shared memory, wait before it exits (so no peer's memory goes away while
// it is still read).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- 1-D bulk copies (no tensor map) -----------------------------------------

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory into this CTA's shared memory; completion counts them on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ---- shared-memory stores ---------------------------------------------------

// 16 bytes at a shared address (16-byte aligned), as one st.shared.v4.
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// ---- realigning 16-byte loads ---------------------------------------------
//
// A bf16 row that starts at an even byte offset o = address % 16 is read as
// the 16-byte aligned chunks that enclose it (ld.global.nc.v4), and each
// output chunk is bytes [o, o + 16) of two neighbouring aligned chunks. The
// staged flash producer (flash_attention_sm90.cu) and the pack kernel
// (pack_bshd.cu) realign this way.

// Bytes [o, o + 16) of the 32 bytes lo, hi (o even, < 16): words o / 4 ..
// o / 4 + 4 by two rounds of selects, then a funnel shift by 8 (o % 4) bits.
__device__ __forceinline__ uint4 realign16(const uint4& lo, const uint4& hi, uint32_t o) {
  const bool w2 = o & 8, w1 = o & 4;
  const uint32_t x0 = w2 ? lo.z : lo.x, x1 = w2 ? lo.w : lo.y, x2 = w2 ? hi.x : lo.z, x3 = w2 ? hi.y : lo.w,
                 x4 = w2 ? hi.z : hi.x, x5 = w2 ? hi.w : hi.y;
  const uint32_t y0 = w1 ? x1 : x0, y1 = w1 ? x2 : x1, y2 = w1 ? x3 : x2, y3 = w1 ? x4 : x3, y4 = w1 ? x5 : x4;
  const uint32_t sh = (o & 3) * 8;  // 0 or 16 bits
  return make_uint4(__funnelshift_r(y0, y1, sh), __funnelshift_r(y1, y2, sh), __funnelshift_r(y2, y3, sh),
                    __funnelshift_r(y3, y4, sh));
}

// 16 bytes by ld.global.nc.v4 where `pred`, else v unchanged (no branch).
__device__ __forceinline__ void ldg_nc128_if(uint4& v, const unsigned char* p, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w)
      : "l"(p), "r"((int)pred));
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at coordinates (c0, c1, c2, c3) of a 4-D map into shared memory;
// completion counts the box's bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The box at coordinates (c0, c1, c2) of a 3-D map into shared memory.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (the
// library links no libcuda); null if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte swizzled operand at `p`:
// start address, leading byte offset `lbo` (the distance between swizzle
// atoms along an MN-major operand's N; unused by K-major operands and by an
// N of 64, where 16 stands for "none"), stride offset 1024 bytes between
// 8-row groups, layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo = 16) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((1024ull >> 4) << 32) | (1ull << 62);
}

// Orders this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (a TMA load that overwrites what the threads wrote, or
// wgmma reading a tile the threads stored).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads') over `count` threads:
// arrive and wait, or arrive only.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// a wgmma issue or wait (the hardware updates them asynchronously).
template <int N> __device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K> __device__ __forceinline__ void fence_regs(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

#define T2V_WGMMA_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define T2V_WGMMA_D32_ARGS(d)                                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (+)= A B for a 64 x 64 x 16 slice, A and B both K-major in shared memory
// (B given as its N x K rows); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T2V_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : T2V_WGMMA_D32_ARGS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B for a 64 x 32 x 16 slice, A and B both K-major in shared memory
// (B given as its 32 x K rows).
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x 64 x 16 slice, A from registers (four bf16 pairs), B
// MN-major in shared memory (its K x N rows, N contiguous).
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " T2V_WGMMA_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : T2V_WGMMA_D32_ARGS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for a 64 x 256 x 16 slice, A from registers (four bf16 pairs), B
// MN-major in shared memory: 256 columns as four 64-wide swizzle atoms, which
// b's leading byte offset steps between.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef T2V_WGMMA_D32
#undef T2V_WGMMA_D32_ARGS

// d += A B for a 64 x N x 16 slice, A from registers (mma.sync's m16n8k16 A
// fragment, four bf16 pairs), B K-major in shared memory (its N x K rows, a
// 128-byte swizzled tile; 8-row groups 1024 bytes apart): N = 160 and 32.
__device__ __forceinline__ void wgmma_rs_k(float (&d)[80], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d = X Y^T over a 64-deep head dim: X (this warpgroup's 64 rows) and Y (64
// rows) are K-major tiles; four k16 slices, issued, not waited for.
__device__ __forceinline__ void gemm_xyt(float (&d)[32], const void* x, const void* y) {
  const uint64_t dx = desc_sw128(x), dy = desc_sw128(y);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_ss(d, dx + 2 * kk, dy + 2 * kk, kk);  // +32 bytes a slice
}

// d += A Y with A (64 x 64, four k16 slices of A fragments) from registers
// and Y the 64 x 64 tile read MN-major; issued, not waited for.
__device__ __forceinline__ void gemm_ay(float (&d)[32], const uint32_t (&a)[4][4], const void* y) {
  const uint64_t dy = desc_sw128(y);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_mn(d, a[kk], dy + 128 * kk);  // +2048 bytes a slice
}

// Pack an accumulator (64 x 16 K f32) into A fragments of bf16 for a product
// whose depth runs along its columns: slice kk is blocks 2 kk and 2 kk + 1.
template <int K> __device__ __forceinline__ void acc_to_a(uint32_t (&a)[K][4], const float (&d)[8 * K]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    a[kk][0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace sm90
}  // namespace t2v
