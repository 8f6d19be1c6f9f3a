// Attention forward with the SAM decomposed relative-position bias,
// head-major, fp32 and bf16.
//
// Replaces classpose_tpu/nn/attention.py flash_attention_relpos /
// _attn_kernel (the pallas_call at attention.py:93):
//   out[b, h, i] = softmax_j(q_i . k_j * scale + rel_h[i, j/W] + rel_w[i, j%W]) @ v
// with q, k, v, out (B, n, L, 64), rel_h (B, n, L, H), rel_w (B, n, L, W),
// L = H*W: the layout of the fp32 branch of the JAX Attention, which the
// per-image API runs at the CLI's default precision.
//
// bf16 (attn_hm_bf16): the Hopper kernel of attn_fwd.cuh (kernel 1's,
// documented there) over a head-major layout: one TMA map per q, k and v,
// (B*n, L, 64) as planes of rows, and the bias rows read from the two
// separate tensors.
//
// fp32 (attn_hm_f32): true fp32 products on the CUDA cores, no TF32 (the
// port's fp32 contract). What bounds it on an H100: operations. Each
// (batch, head) does 2*2*L^2*64 = 268 MFLOP of fp32 FMA against ~1.3 MB of
// operands; at 67 TFLOP/s fp32 that is ~4 us per (batch, head) against
// ~0.4 us of HBM time. Design: FlashAttention-style, one CTA of 256
// threads per (64-query block, head, batch) loops over 64-key blocks with
// an online softmax (running max and sum per row in fp32); the scores never
// leave the SM. Each thread owns a 4x4 register tile of the 64x64 score
// block (4 rows x 4 keys) and of the 64x64 output block (4 rows x 4 of the
// 64 features); q and k are stored transposed in shared memory so both
// products read float4 rows, and the probabilities go through shared
// memory (transposed) to the second product. A row's max and sum reduce
// over the 16 lanes that hold it by shuffles. Register tiling of 4x4 does
// 16 FMAs per 8 floats read from shared memory, so shared-memory bandwidth
// caps it near half the fp32 peak; larger tiles and double buffering are
// later work.

#include "attn_fwd.cuh"

// a named namespace: the layout is a kernel template argument
namespace head_major {

struct HeadMajor {
  const __nv_bfloat16* rh;  // (B, n, L, gh)
  const __nv_bfloat16* rw;  // (B, n, L, gw)
  __nv_bfloat16* out;       // (B, n, L, 64)
  float* lse;               // unused: no backward
  float* out32;             // unused
  int n, L, gh, gw;

  __device__ int tma_x(int, int) const { return 0; }
  __device__ int tma_z(int b, int h) const { return b * n + h; }
  __device__ const __nv_bfloat16* rh_row(int b, int h, int r) const {
    return rh + (((int64_t)b * n + h) * L + r) * gh;
  }
  __device__ const __nv_bfloat16* rw_row(int b, int h, int r) const {
    return rw + (((int64_t)b * n + h) * L + r) * gw;
  }
  __device__ __nv_bfloat16* orow(int b, int h, int r) const {
    return out + (((int64_t)b * n + h) * L + r) * attn::fwd::HD;
  }
};

constexpr int HD = 64;
constexpr int BQ = 64;       // queries per CTA
constexpr int BK = 64;       // keys per block
constexpr int THREADS = 256; // 16 x 16 threads, a 4 x 4 tile each
constexpr int P = 68;        // smem pitch (floats) of the 64-wide tiles

__global__ void __launch_bounds__(THREADS)
attn_hm_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ rh,
                   const float* __restrict__ rw, float* __restrict__ out,
                   int n, int L, int gh, int gw, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* Qt = sm;             // [HD][P]  Qt[d][i] = q[i][d]
  float* Kt = Qt + HD * P;    // [HD][P]  Kt[d][j] = k[j][d]
  float* Vs = Kt + HD * P;    // [BK][P]  Vs[j][d]
  float* Pt = Vs + BK * P;    // [BK][P]  Pt[j][i] = p[i][j]
  float* RH = Pt + BK * P;    // [BQ][gh]
  float* RW = RH + BQ * gh;   // [BQ][gw]

  const int q0 = blockIdx.x * BQ;
  const int64_t bh = (int64_t)blockIdx.z * n + blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* qb = q + (bh * L + q0) * HD;
  const float* kb = k + bh * L * HD;
  const float* vb = v + bh * L * HD;

  for (int idx = tid; idx < BQ * HD / 4; idx += THREADS) {
    const int i = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(qb + i * HD + d);
    Qt[(d + 0) * P + i] = x.x;
    Qt[(d + 1) * P + i] = x.y;
    Qt[(d + 2) * P + i] = x.z;
    Qt[(d + 3) * P + i] = x.w;
  }
  for (int idx = tid; idx < BQ * gh; idx += THREADS)
    RH[idx] = rh[(bh * L + q0) * gh + idx];
  for (int idx = tid; idx < BQ * gw; idx += THREADS)
    RW[idx] = rw[(bh * L + q0) * gw + idx];

  float o[4][4];
  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = -INFINITY;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // the previous block's Kt, Vs and Pt are consumed
    for (int idx = tid; idx < BK * HD / 4; idx += THREADS) {
      const int j = idx / (HD / 4), d = (idx % (HD / 4)) * 4;
      const float4 x =
          *reinterpret_cast<const float4*>(kb + (int64_t)(k0 + j) * HD + d);
      Kt[(d + 0) * P + j] = x.x;
      Kt[(d + 1) * P + j] = x.y;
      Kt[(d + 2) * P + j] = x.z;
      Kt[(d + 3) * P + j] = x.w;
      *reinterpret_cast<float4*>(&Vs[j * P + d]) =
          *reinterpret_cast<const float4*>(vb + (int64_t)(k0 + j) * HD + d);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[d * P + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&Kt[d * P + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }

    // logits, then the online softmax of this thread's four rows
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty * 4 + a;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = k0 + tx * 4 + c;
        s[a][c] = s[a][c] * scale + (RH[i * gh + j / gw] + RW[i * gw + j % gw]);
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[a], mx);
      const float alpha = expf(m_run[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[a][c] = expf(s[a][c] - m_new);
        sum += s[a][c];
        Pt[(tx * 4 + c) * P + i] = s[a][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_run[a] = l_run[a] * alpha + sum;
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) o[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(&Pt[j * P + ty * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * P + tx * 4]);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
      const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[a][c] = fmaf(pv[a], vf[c], o[a][c]);
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float inv = 1.f / l_run[a];
    *reinterpret_cast<float4*>(
        out + (bh * L + q0 + ty * 4 + a) * HD + tx * 4) =
        make_float4(o[a][0] * inv, o[a][1] * inv, o[a][2] * inv,
                    o[a][3] * inv);
  }
}

}  // namespace head_major

// q, k, v, out (B, n, L, 64) f32; rel_h (B, n, L, gh), rel_w (B, n, L, gw)
// f32; L = gh * gw, L % 64 == 0, gh + gw <= 128.
extern "C" int attn_hm_f32(const void* q, const void* k, const void* v,
                           const void* rh, const void* rw, void* out, int B,
                           int L, int n, int gh, int gw, float scale,
                           void* stream) {
  using namespace head_major;
  if (L % BQ != 0 || gh + gw > 128) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(2 * HD * P + 2 * BK * P + BQ * (gh + gw)) * 4;
  cudaFuncSetAttribute(attn_hm_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(L / BQ, n, B);
  attn_hm_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rh),
      static_cast<const float*>(rw), static_cast<float*>(out), n, L, gh, gw,
      scale);
  return (int)cudaGetLastError();
}

// the same operands in bf16, 16-byte aligned; L = gh * gw with gh and gw
// multiples of 8, L % 64 == 0
extern "C" int attn_hm_bf16(const void* q, const void* k, const void* v,
                            const void* rh, const void* rw, void* out, int B,
                            int L, int n, int gh, int gw, float scale,
                            void* stream) {
  using namespace attn::fwd;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!sm90::make_map_3d(&maps[i], src[i], HD, L, (uint64_t)B * n, HD * 2,
                           (uint64_t)L * HD * 2, HD, BQ))
      return (int)cudaErrorInvalidValue;
  const head_major::HeadMajor lay{
      static_cast<const __nv_bfloat16*>(rh),
      static_cast<const __nv_bfloat16*>(rw),
      static_cast<__nv_bfloat16*>(out), nullptr, nullptr, n, L, gh, gw};
  return dispatch(maps[0], maps[1], maps[2], lay, B, L, n, gh, gw, scale,
                  static_cast<cudaStream_t>(stream));
}
