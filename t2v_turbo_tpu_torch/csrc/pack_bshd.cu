// Pack a bf16 (B, S, H, D) view that TMA cannot read into a contiguous copy:
// the `packed` route of the flash kernels (B6 on such views: the backward at
// head dims 64 and 512, and the forward at head dim 512). The wrapper
// (ops/attention.py) packs each input TMA cannot read, then launches the
// wgmma + TMA kernels of flash_attention_sm90.cu unchanged on the copies, so
// the route gives those kernels' bits on contiguous copies of the same
// values. It computes nothing of the attention itself.
//
// It replaces no TPU kernel on its own: the Pallas BSHD kernels
// (t2v_turbo_tpu/ops/attention.py::_flash_bwd_dkv_kernel_bshd,
// _flash_bwd_dq_kernel_bshd, _flash_fwd_kernel_bshd) read any strided view
// through their BlockSpecs, and TMA cannot: no tensor map takes a base or a
// (batch, seq, head) stride off 16 bytes, and TMA cannot shift by 2 bytes.
//
// Bound: bytes. Each element is read once and written once, 4 bytes an
// element: 0.0157 ms for one (16, 2560, 5, 64) tensor at 3.35 TB/s.
//
// Design. A slice (b, s, h) is D bf16 (128 or 1024 bytes) at an even byte
// offset o = address % 16; a unit is 128 bytes of it (D / 64 units a slice,
// all at the same o). A unit is read as the 16-byte aligned chunks that
// enclose it: 8 when o = 0, else 9, all inside the granules its bytes lie
// in (ops/attention.py::pack_slice mirrors one slice's loads;
// tests/test_torch_pack_plan.py replays them). 8 lanes take a unit: lane c
// loads aligned chunk c with ld.global.nc.v4, takes chunk c + 1 from the
// next lane by a shuffle (lane 7 loads the 9th chunk itself, only when
// o != 0), keeps bytes [o, o + 16) (`realign16`, sm90.cuh, as the staged
// flash producer does) and stores them with one st.global.v4 at chunk c of
// the unit's place in the contiguous output. A warp takes 4 units an
// instruction, kPackUnits instructions a thread: the units 4 u + k (lane
// 8 k + c) of the warp's 4 kPackUnits, consecutive in the output, so each
// store instruction writes 512 contiguous bytes; all of a thread's loads
// are issued before the first store. A unit's (b, s, h, piece) comes from
// its index by two divisions done as a multiply and a shift (`FastDiv`).
// The modes store the slice as is, negated (the sign bit of each bf16
// flipped: exact) or as zeros (nothing is read): the D = 512 forward runs a
// scale < 0 as -Q at -scale and a scale of 0 as Q = 0 at scale 1, as the
// staged producer does, since the wgmma forward takes positive scales only.
#include "sm90.cuh"

namespace t2v {

namespace {

using namespace sm90;

constexpr int kPackThreads = 256;
constexpr int kPackUnits = 4;  // unit loads a thread has in flight
enum PackMode : int { kPackAsIs = 0, kPackNegated = 1, kPackZero = 2 };

// n / d for n < 2^31 as (umulhi(n, m) + n) >> l (Granlund and Montgomery;
// umulhi(n, m) < n, so the sum fits 32 bits).
struct FastDiv {
  uint32_t d, m, l;
  __device__ __forceinline__ uint32_t div(uint32_t n) const { return (__umulhi(n, m) + n) >> l; }
};

FastDiv fast_div(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  return {d, (uint32_t)(((1ull << 32) * ((1ull << l) - d)) / d + 1), l};
}

struct PackArgs {
  const unsigned char* x;  // the view's first element
  unsigned char* out;      // contiguous (B, S, H, D), 16-byte aligned
  long long sb, ss, sh;    // the view's (batch, seq, head) strides in bytes
  FastDiv by_row;          // unit -> (row b * S + s, unit j of the row): / (H * D / 64)
  FastDiv by_seq;          // row -> (b, s): / S
  uint32_t lp;             // log2(D / 64): the units of a slice
  uint32_t units;          // B * S * H * D / 64
  int mode;
};

__device__ __forceinline__ void stg128(unsigned char* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__global__ void __launch_bounds__(kPackThreads) pack_bshd_kernel(const PackArgs a) {
  const int lane = threadIdx.x % 32, k = lane / 8, c = lane % 8;
  const uint32_t first = (blockIdx.x * kPackThreads + threadIdx.x) / 32 * (4 * kPackUnits);
  uint4 lo[kPackUnits], ex[kPackUnits];
  uint32_t o[kPackUnits];
#pragma unroll
  for (int u = 0; u < kPackUnits; ++u) {
    const uint32_t i = first + 4 * u + k;
    const uint32_t row = a.by_row.div(i), j = i - row * a.by_row.d;
    const uint32_t b = a.by_seq.div(row), s = row - b * a.by_seq.d;
    const unsigned char* p =
        a.x + b * a.sb + s * a.ss + (j >> a.lp) * a.sh + 128 * (j & ((1u << a.lp) - 1));
    o[u] = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)) & 15;
    p -= o[u];
    const bool in = i < a.units && a.mode != kPackZero;
    // both loads start from zeros, not from each other (a load whose
    // register holds another load's result waits for it)
    lo[u] = ex[u] = make_uint4(0u, 0u, 0u, 0u);
    ldg_nc128_if(lo[u], p + 16 * c, in);
    ldg_nc128_if(ex[u], p + 128, in && c == 7 && o[u]);  // inside the unit's last granule
  }
  const uint32_t x = a.mode == kPackNegated ? 0x80008000u : 0u;
#pragma unroll
  for (int u = 0; u < kPackUnits; ++u) {
    uint4 hi;  // chunk c + 1: the next lane's, lane 7's 9th
    hi.x = __shfl_down_sync(0xffffffffu, lo[u].x, 1, 8);
    hi.y = __shfl_down_sync(0xffffffffu, lo[u].y, 1, 8);
    hi.z = __shfl_down_sync(0xffffffffu, lo[u].z, 1, 8);
    hi.w = __shfl_down_sync(0xffffffffu, lo[u].w, 1, 8);
    if (c == 7) hi = ex[u];
    uint4 v = realign16(lo[u], hi, o[u]);
    v = make_uint4(v.x ^ x, v.y ^ x, v.z ^ x, v.w ^ x);
    const uint32_t i = first + 4 * u + k;
    if (i < a.units) stg128(a.out + 128ull * i + 16 * c, v);
  }
}

}  // namespace

}  // namespace t2v

extern "C" {

// x: a (B, S, H, D) bf16 view at an even byte address with element strides
// strides = [sb, ss, sh, sd]; out: (B, S, H, D) contiguous, 16-byte aligned.
// Writes out = x (mode 0), -x (mode 1: each sign bit flipped) or zeros
// (mode 2: x is not read). Refuses another dtype, D other than 64 and 512,
// sd != 1, an odd x, a misaligned out, another mode and more than 2^31 - 2^10
// units of 128 bytes.
int t2v_pack_bshd(const void* x, void* out, int dtype, int B, int S, int H, int D, const long long* strides,
                  int mode, void* stream) {
  using namespace t2v;
  if (dtype != kBF16 || (D != 64 && D != 512) || strides[3] != 1 || B < 0 || S < 0 || H < 0 ||
      reinterpret_cast<uintptr_t>(x) % 2 || reinterpret_cast<uintptr_t>(out) % 16 || mode < kPackAsIs ||
      mode > kPackZero)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)B * S * H * (D / 64);
  if (units >= (1ll << 31) - 1024) return (int)cudaErrorInvalidValue;
  if (units == 0) return (int)cudaSuccess;
  PackArgs a;
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
  a.sb = 2 * strides[0];
  a.ss = 2 * strides[1];
  a.sh = 2 * strides[2];
  a.by_row = fast_div((uint32_t)(H * (D / 64)));
  a.by_seq = fast_div((uint32_t)S);
  a.lp = D == 512 ? 3 : 0;
  a.units = (uint32_t)units;
  a.mode = mode;
  const long long per_block = 4 * kPackUnits * (kPackThreads / 32);
  pack_bshd_kernel<<<(unsigned)((units + per_block - 1) / per_block), kPackThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
