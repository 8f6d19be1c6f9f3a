// Attention forward with the SAM decomposed relative-position bias, bf16,
// token-major.
//
// Replaces the TPU kernel classpose_tpu/nn/attention.py _attn_pallas /
// _attn_kernel_blc (the pallas_call at attention.py:404):
//   out[b, i, h] = softmax_j(q_i . k_j * scale + rel[b,i,h,j/W] + rel[b,i,h,H + j%W]) @ v
// with q, k, v read straight out of the (B, L, 3*n*hd) qkv tensor and the
// bias taken in its (B, L, n, H+W) layout, as the TPU kernel's index maps
// do. No transposed copy of q, k or v is ever made: one TMA map over qkv,
// (B, L, 3*n*64) as planes of rows, serves all three, a head's q, k or v
// being the 64 columns at (which*n + h)*64. The kernel itself, its bound
// and its design are in attn_fwd.cuh, shared with the head-major kernel 8
// (attention_hm.cu); this file gives it the token-major layout and, for
// training, the row log-sum-exp and fp32 output the backward
// (attention_bwd.cu) takes.

#include "attn_fwd.cuh"

// a named namespace: the layout is a kernel template argument
namespace token_major {

using attn::fwd::HD;

struct TokenMajor {
  const __nv_bfloat16* rel;  // (B, L, n, gh+gw)
  __nv_bfloat16* out;        // (B, L, n*64)
  float* lse;                // (B, n, L) or null
  float* out32;              // (B, L, n*64) or null
  int n, L, gh, R;

  __device__ int tma_x(int which, int h) const { return (which * n + h) * HD; }
  __device__ int tma_z(int b, int) const { return b; }
  __device__ const __nv_bfloat16* rh_row(int b, int h, int r) const {
    return rel + (((int64_t)b * L + r) * n + h) * R;
  }
  __device__ const __nv_bfloat16* rw_row(int b, int h, int r) const {
    return rh_row(b, h, r) + gh;
  }
  __device__ __nv_bfloat16* orow(int b, int h, int r) const {
    return out + ((int64_t)b * L + r) * n * HD + h * HD;
  }
  // a row of rel is gh+gw contiguous elements: 16-byte copies need R % 8
  __device__ bool bias_vec16() const { return R % 8 == 0; }
};

}  // namespace token_major

// qkv (B, L, 3*n*64), rel (B, L, n, gh+gw), out (B, L, n*64), all bf16;
// lse (B, n, L) and out32 (B, L, n*64) f32, or null; L = gh * gw with
// gh + gw <= MAX_REL (256); qkv and rel 16-byte aligned.
extern "C" int attn_fwd_bf16(const void* qkv, const void* rel, void* out,
                             void* lse, void* out32, int B, int L, int n,
                             int gh, int gw, float scale, void* stream) {
  using namespace attn::fwd;
  const uint64_t row = 3ull * n * HD * 2;
  CUtensorMap map;
  if (!sm90::make_map_3d(&map, qkv, 3ull * n * HD, L, B, row, row * L, HD,
                         BQ))
    return (int)cudaErrorInvalidValue;
  const token_major::TokenMajor lay{static_cast<const __nv_bfloat16*>(rel),
                                    static_cast<__nv_bfloat16*>(out),
                                    static_cast<float*>(lse),
                                    static_cast<float*>(out32), n, L, gh,
                                    gh + gw};
  return dispatch(map, map, map, lay, B, L, n, gh, gw, scale,
                  static_cast<cudaStream_t>(stream));
}
