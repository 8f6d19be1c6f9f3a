// Warp-level tensor-core helpers of the attention backward (attention_bwd.cu;
// the forward's Hopper body has its own, sm90.cuh):
// ldmatrix loads, the m16n8k16 bf16 mma.sync with fp32 accumulators,
// cp.async copies, bf16 packing and the one-hot bias columns.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr int HD = 64;        // head dim (asserted by the wrappers)
constexpr int BQ = 64;        // query rows per block, 16 per warp
constexpr int BK = 64;        // keys per block
constexpr int NWARP = 4;
constexpr int KP = HD + 8;    // smem row pitch of a 64-wide tile (bf16): 144 B

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// one-hot pair for bias columns c, c+1 of an extended key row whose
// row-bucket column is hc and column-bucket column is wc
__device__ __forceinline__ uint32_t onehot_pair(int c, int hc, int wc) {
  uint32_t lo = (c == hc || c == wc) ? 0x3F80u : 0u;          // bf16 1.0
  uint32_t hi = (c + 1 == hc || c + 1 == wc) ? 0x3F80u : 0u;
  return lo | (hi << 16);
}

}  // namespace attn
