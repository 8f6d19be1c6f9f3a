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
// ~0.4 us of HBM time. So the design keeps the FMA pipes fed:
//   - one CTA of 256 threads per (128-query block, head, batch) sweeps
//     128-key blocks with an online softmax in fp32 (running max and sum
//     per row); the scores never leave the SM;
//   - each thread owns 8 query rows x 8 keys of the S = q.k^T block and,
//     for P.V, the same 8 rows x 8 features over one half of the block's
//     keys (the halves' outputs are added once, at the end), so the
//     rescale of its output rows needs nothing from other threads; per 4
//     consecutive features (keys) S (P.V) takes 8 + 8 float4 reads for
//     256 FMAs, where a 4 x 4 tile took 2 for 16;
//   - q, k, v stay row-major as in device memory, no transpose: the outer
//     products run over 4 consecutive features of float4 reads; rows of q,
//     k and p are stored with their 16-byte groups XOR-swizzled by bits
//     3..5 of the row, so the two row groups and sixteen key groups of a
//     warp read distinct banks (broadcast within a group);
//   - k and v are copied by 16-byte cp.async, each into one buffer whose
//     next block loads while the other phase runs (k during the softmax
//     and P.V, v during the next S); three barriers per key block;
//   - exponentials are ex2 of logits pre-scaled by log2(e) (the bias rows
//     are scaled once as they are loaded into shared memory); with
//     W % 8 == 0 a thread's 8 keys share one rel_h value and read rel_w as
//     two float4, else each logit reads its two terms;
//   - keys past L (L % 128 != 0) read row L-1 and are masked to -inf; rows
//     past L are computed on row L-1 and not written.
// Shared memory: q, k, v 32 KB each, p 64 KB, the bias rows 128 x at most
// H+W+4 fp32 (64 KB at 64 x 64): 231,424 bytes at most, one CTA per SM.

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
  // rel_h and rel_w rows are separate: 16-byte copies need both pitches
  // to be multiples of 8 elements
  __device__ bool bias_vec16() const { return gh % 8 == 0 && gw % 8 == 0; }
};

constexpr int HD = 64;
constexpr int BQ = 128;       // queries per CTA
constexpr int BK = 128;       // keys per block
constexpr int THREADS = 256;  // 16 row groups x 16 key (feature) groups
constexpr float LOG2E = 1.4426950408889634f;

// float column of group d (a multiple of 4) in row r of a swizzled tile
__device__ __forceinline__ int swz(int r, int d) {
  return d ^ (((r >> 3) & 7) << 2);
}

// the bias rows in shared memory: rel_h at column 0, rel_w from column
// bias_rw_col, both 16-byte aligned; at most 132 floats a row for
// H + W <= 128
__host__ __device__ inline int bias_rw_col(int gh) { return (gh + 3) / 4 * 4; }
__host__ __device__ inline int bias_pitch(int gh, int gw) {
  return bias_rw_col(gh) + (gw + 3) / 4 * 4;
}

__device__ __forceinline__ void fma4(float (&acc)[8], float a,
                                     const float4 (&b)[8], int e) {
#pragma unroll
  for (int c = 0; c < 8; ++c)
    acc[c] = fmaf(a, e == 0 ? b[c].x : e == 1 ? b[c].y
                  : e == 2 ? b[c].z : b[c].w, acc[c]);
}

__global__ void __launch_bounds__(THREADS, 1)
attn_hm_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ rh,
                   const float* __restrict__ rw, float* __restrict__ out,
                   int n, int L, int gh, int gw, float scale) {
  extern __shared__ __align__(16) float sm[];
  float* sQ = sm;              // [BQ][HD], swizzled
  float* sK = sQ + BQ * HD;    // [BK][HD], swizzled
  float* sV = sK + BK * HD;    // [BK][HD]
  float* sP = sV + BK * HD;    // [BQ][BK], swizzled
  // [BQ][BP]: rel_h at 0, rel_w at GHP (16-byte aligned), times log2(e)
  float* sB = sP + BQ * BK;
  const int GHP = bias_rw_col(gh), BP = bias_pitch(gh, gw);

  const int q0 = blockIdx.x * BQ;
  const int64_t bh = (int64_t)blockIdx.z * n + blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = lane % 16;                      // keys / features
  const int ty = (tid / 32) * 2 + lane / 16;     // rows ty*8 .. ty*8+7
  const float* kb = k + bh * L * HD;
  const float* vb = v + bh * L * HD;

  // a 128-row tile of a (L, 64) matrix by 16-byte cp.async, each thread
  // copying 16 bytes of rows tid/16 + 16i; rows past L repeat row L-1
  const int lr = tid / 16, lc = (tid % 16) * 4;
  auto load_tile = [&](float* dst, const float* src, int r0, bool swizzle) {
#pragma unroll
    for (int i = 0; i < 128 / 16; ++i) {
      const int r = lr + 16 * i;
      sm90::cp_async16(dst + r * HD + (swizzle ? swz(r, lc) : lc),
                       src + (int64_t)min(r0 + r, L - 1) * HD + lc);
    }
  };
  load_tile(sQ, q + bh * L * HD, q0, true);
  load_tile(sK, kb, 0, true);
  sm90::cp_async_commit();
  load_tile(sV, vb, 0, false);
  sm90::cp_async_commit();
  for (int idx = tid; idx < BQ * gh; idx += THREADS) {
    const int r = idx / gh, c = idx - r * gh;
    sB[r * BP + c] = rh[(bh * L + min(q0 + r, L - 1)) * gh + c] * LOG2E;
  }
  for (int idx = tid; idx < BQ * gw; idx += THREADS) {
    const int r = idx / gw, c = idx - r * gw;
    sB[r * BP + GHP + c] =
        rw[(bh * L + min(q0 + r, L - 1)) * gw + c] * LOG2E;
  }
  // W % 8 == 0 (every square grid of the main paths): a thread's 8 keys
  // of a block lie in one grid row and 8 consecutive columns, so its bias
  // per row is one rel_h value and two float4 of rel_w
  const bool wide = gw % 8 == 0;

  const float sl = scale * LOG2E;
  // P . v: this thread's half of each key block (kh) and its features
  // dg*4.. and 32 + dg*4..
  const int dg = tx % 8, kh = tx / 8;
  float o[8][8], m[8], l[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o[a][e] = 0.f;
  }

  const int nblk = (L + BK - 1) / BK;
  for (int kbi = 0; kbi < nblk; ++kbi) {
    const int k0 = kbi * BK;
    sm90::cp_async_wait<1>();  // this block's k (and q)
    __syncthreads();

    // S = q . k^T, 8 rows x 8 keys per thread
    float s[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[a][c] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 kf[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        kf[c] = *reinterpret_cast<const float4*>(
            sK + (tx * 8 + c) * HD + swz(tx * 8 + c, d));
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const float4 qf = *reinterpret_cast<const float4*>(
            sQ + (ty * 8 + a) * HD + swz(ty * 8 + a, d));
        fma4(s[a], qf.x, kf, 0);
        fma4(s[a], qf.y, kf, 1);
        fma4(s[a], qf.z, kf, 2);
        fma4(s[a], qf.w, kf, 3);
      }
    }
    __syncthreads();  // every thread is done with this k block
    if (kbi + 1 < nblk) load_tile(sK, kb, k0 + BK, true);
    sm90::cp_async_commit();

    // bias offsets of this thread's 8 keys into a bias row: j/W (clamped
    // for keys past L, which are masked) and GHP + j%W
    const int j0 = k0 + tx * 8;
    const int h0 = j0 / gw, w0 = j0 - h0 * gw;
    int oh[8], ow[8];
    {
      int hj = h0, wj = w0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        oh[c] = min(hj, gh - 1);
        ow[c] = GHP + wj;
        if (++wj == gw) {
          wj = 0;
          ++hj;
        }
      }
    }
    const bool ragged = k0 + BK > L;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = ty * 8 + a;
      const float* br = sB + r * BP;
      float bias[8];
      if (wide) {
        const float rhv = br[oh[0]];
        const float4 b0 = *reinterpret_cast<const float4*>(br + ow[0]);
        const float4 b1 = *reinterpret_cast<const float4*>(br + ow[0] + 4);
        bias[0] = rhv + b0.x;
        bias[1] = rhv + b0.y;
        bias[2] = rhv + b0.z;
        bias[3] = rhv + b0.w;
        bias[4] = rhv + b1.x;
        bias[5] = rhv + b1.y;
        bias[6] = rhv + b1.z;
        bias[7] = rhv + b1.w;
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) bias[c] = br[oh[c]] + br[ow[c]];
      }
      float mx = m[a];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float t = fmaf(s[a][c], sl, bias[c]);
        if (ragged && k0 + tx * 8 + c >= L) t = -INFINITY;
        s[a][c] = t;
        mx = fmaxf(mx, t);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = attn::fwd::ex2(m[a] - mx);
      m[a] = mx;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[a][c] = attn::fwd::ex2(s[a][c] - mx);
        sum += s[a][c];
      }
      l[a] = l[a] * alpha + sum;  // this thread's keys only
#pragma unroll
      for (int e = 0; e < 8; ++e) o[a][e] *= alpha;
      float* pr = sP + r * BK;
      *reinterpret_cast<float4*>(pr + swz(r, tx * 8)) =
          make_float4(s[a][0], s[a][1], s[a][2], s[a][3]);
      *reinterpret_cast<float4*>(pr + swz(r, tx * 8 + 4)) =
          make_float4(s[a][4], s[a][5], s[a][6], s[a][7]);
    }
    sm90::cp_async_wait<1>();  // this block's v
    __syncthreads();           // and every row of p

    // O += P . v over this thread's half of the keys, 8 rows x 8
    // features; the second half starts 16 keys in, so the two halves read
    // p from other banks
#pragma unroll 2
    for (int jj = 0; jj < BK / 2; jj += 4) {
      const int j = kh * (BK / 2) + (jj + 16 * kh) % (BK / 2);
      float4 va[4], vb4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        va[c] = *reinterpret_cast<const float4*>(sV + (j + c) * HD + dg * 4);
        vb4[c] = *reinterpret_cast<const float4*>(sV + (j + c) * HD + 32 +
                                                  dg * 4);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int r = ty * 8 + a;
        const float4 pf =
            *reinterpret_cast<const float4*>(sP + r * BK + swz(r, j));
        const float pv[4] = {pf.x, pf.y, pf.z, pf.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          o[a][0] = fmaf(pv[c], va[c].x, o[a][0]);
          o[a][1] = fmaf(pv[c], va[c].y, o[a][1]);
          o[a][2] = fmaf(pv[c], va[c].z, o[a][2]);
          o[a][3] = fmaf(pv[c], va[c].w, o[a][3]);
          o[a][4] = fmaf(pv[c], vb4[c].x, o[a][4]);
          o[a][5] = fmaf(pv[c], vb4[c].y, o[a][5]);
          o[a][6] = fmaf(pv[c], vb4[c].z, o[a][6]);
          o[a][7] = fmaf(pv[c], vb4[c].w, o[a][7]);
        }
      }
    }
    __syncthreads();  // every thread is done with this v block and p
    if (kbi + 1 < nblk) load_tile(sV, vb, k0 + BK, false);
    sm90::cp_async_commit();
  }

  // the two key halves' outputs meet in shared memory (p's space, free
  // after the last barrier); the first half adds and writes
  float* sO = sP;  // [BQ][HD]
  if (kh == 1) {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float* orow = sO + (ty * 8 + a) * HD;
      *reinterpret_cast<float4*>(orow + dg * 4) =
          make_float4(o[a][0], o[a][1], o[a][2], o[a][3]);
      *reinterpret_cast<float4*>(orow + 32 + dg * 4) =
          make_float4(o[a][4], o[a][5], o[a][6], o[a][7]);
    }
  }
  float inv[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float lt = l[a];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    inv[a] = 1.f / lt;
  }
  __syncthreads();
  if (kh == 1) return;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = q0 + ty * 8 + a;
    if (row >= L) continue;
    const float* orow = sO + (ty * 8 + a) * HD;
    const float4 x0 = *reinterpret_cast<const float4*>(orow + dg * 4);
    const float4 x1 = *reinterpret_cast<const float4*>(orow + 32 + dg * 4);
    float* dst = out + (bh * L + row) * HD;
    *reinterpret_cast<float4*>(dst + dg * 4) = make_float4(
        (o[a][0] + x0.x) * inv[a], (o[a][1] + x0.y) * inv[a],
        (o[a][2] + x0.z) * inv[a], (o[a][3] + x0.w) * inv[a]);
    *reinterpret_cast<float4*>(dst + 32 + dg * 4) = make_float4(
        (o[a][4] + x1.x) * inv[a], (o[a][5] + x1.y) * inv[a],
        (o[a][6] + x1.z) * inv[a], (o[a][7] + x1.w) * inv[a]);
  }
}

}  // namespace head_major

// q, k, v, out (B, n, L, 64) f32, 16-byte aligned; rel_h (B, n, L, gh),
// rel_w (B, n, L, gw) f32; L = gh * gw, gh + gw <= 128.
extern "C" int attn_hm_f32(const void* q, const void* k, const void* v,
                           const void* rh, const void* rw, void* out, int B,
                           int L, int n, int gh, int gw, float scale,
                           void* stream) {
  using namespace head_major;
  if (gh < 1 || gw < 1 || gh * gw != L || gh + gw > 128)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)BQ * HD + 2 * (size_t)BK * HD +
                       (size_t)BQ * BK + (size_t)BQ * bias_pitch(gh, gw)) *
                      4;
  cudaError_t e = cudaFuncSetAttribute(
      attn_hm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((L + BQ - 1) / BQ, n, B);
  attn_hm_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rh),
      static_cast<const float*>(rw), static_cast<float*>(out), n, L, gh, gw,
      scale);
  return (int)cudaGetLastError();
}

// the same operands in bf16, 16-byte aligned; L = gh * gw with
// gh + gw <= 128
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
