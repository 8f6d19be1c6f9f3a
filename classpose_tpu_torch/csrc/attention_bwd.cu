// Backward of the attention with the SAM decomposed relative-position bias,
// bf16 operands, fp32 accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernel classpose_tpu/nn/attention.py _attn_bwd_pallas /
// _attn_bwd_kernel_blc (the pallas_call at attention.py:540). With the
// forward's logits (attention.cu)
//   s_ij = q_i . k_j * scale + rel_h[i, j/W] + rel_w[i, j%W],
//   p = softmax_j(s),  o = p . v,
// it returns, for the output cotangent do,
//   dv = p^T . do,  dp = do . v^T,  ds = p * (dp - rowsum(p * dp)),
//   dq = ds . k * scale,  dk = ds^T . q * scale,
//   drel_h[i, a] = sum_{j: j/W = a} ds_ij,  drel_w[i, b] = sum_{j: j%W = b} ds_ij,
// written as dqkv = [dq | dk | dv] in qkv's (B, L, 3*n*64) layout and drel
// in rel's (B, L, n, H+W) layout, both bf16. p is cast to bf16 before the
// dv product and ds before the dq and dk products, as on the TPU. The
// bias gradients are partial sums of rows of ds that sum to zero, so they
// are kept clear of rounding that is correlated along a row: they sum the
// fp32 ds (square grids of side 16 and 32) or ds split into bf16 hi + lo
// (hi = bf16(ds), lo = bf16(ds - hi), ~16 significant bits) against exact
// one-hot columns with fp32 accumulation, and delta comes from the
// forward's fp32 output, not its bf16 one.
//
// What bounds it on an H100: the five L x L x 64 products per (batch,
// head), 10*B*n*L^2*64 FLOP (~86 GFLOP per layer call at B = 8, n = 16,
// L = 1024, i.e. ~0.087 ms at 989 TFLOP/s dense bf16), against ~100 MB of
// operands: far above the card's ~295 FLOP/byte ridge, so operations;
// beside the tensor cores, the exponentials and the per-logit bias and
// softmax arithmetic on the FP32 pipes. Every L x L quantity stays on chip.
//
// Design (FlashAttention-3's backward, without its atomics). Three
// launches: attn_bwd_delta (delta_i = do_i . o_i per row, from the fp32
// output), then two passes that each recompute p, so every output element
// is written by one thread and the result is deterministic:
//   - attn_bwd_dkv: one CTA per (128-key block, head, batch) and three
//     warpgroups. Warpgroup 0 is the producer: one thread TMA-loads the
//     block's k and v once and each 64-query block's q and do into a ring
//     of three stages (128-byte swizzle, full/empty mbarriers); its other
//     three warps copy, per query block, its bias rows, lse and delta by
//     cp.async into the same stage. Warpgroups 1 and 2 own 64 keys
//     each and, per query block: S^T = k . q^T and dP^T = v . do^T by wgmma
//     m64n64k16 from shared memory; P^T = exp2(S^T * scale * log2(e) +
//     (rel_h + rel_w) * log2(e) - lse * log2(e)), the bias added per logit
//     in fp32 (no one-hot columns: its cost does not grow with H + W);
//     dS^T = P^T * (dP^T - delta); then dv += P^T . do and dk += dS^T . q
//     by wgmma with P^T and dS^T straight from the accumulators' registers
//     as the A operands and do and q read MN-major (the transpose flag).
//     The dv product is issued before dS^T is formed, and the dv and dk
//     products of a block run on while the next block's S^T and dP^T are
//     issued. ptxas then reports the pass's products serialized (C7515);
//     measured, this order is still faster than retiring every product
//     within its block (ab_attention.py, PERF.md).
//   - attn_bwd_dq: one CTA per (128-query block, head, batch) (64 queries
//     and one consumer warpgroup where two would pass the SM's shared
//     memory), the producer TMA-loading q and do once and each 64-key
//     block's k and v into the ring; its other three warps build, per key
//     block, the one-hot matrix of the bins the block touches: NH rel_h
//     bins (columns j/W from k0/W: ceil(63/W) + 1 of them, 8 or 64 in the
//     instantiation) and NW rel_w bins (column j%W itself for W <= 64,
//     else the block's key j - k0; 8 to 64). Per key block: S = q . k^T
//     and dP = do . v^T by wgmma; P and dS as above, the bias terms read
//     from the CTA's bias rows in shared memory (bf16, copied once);
//     dq += dS . k with dS from registers and k MN-major; and the bias
//     gradients as dS_hi . onehot + dS_lo . onehot by register-A wgmmas
//     (64 x NH and 64 x NW, fp32): the rel_h part added by each thread
//     into the CTA's fp32 drel rows in shared memory after every block
//     (each (row, bin) is one thread's, a row's sums one warp's, in
//     key-block order), the rel_w part kept in its accumulator for the
//     whole sweep when W <= 64 (its bins do not move) and added once. On
//     the square grids of side 16 and 32 (bsize 128 and 256 at patch 8)
//     a thread's rel_w bias terms sit in registers, its rel_h term is
//     read once per row and W keys, and the bias gradients need no
//     one-hot product: each (row, column j%W) sum of the fp32 dS is one
//     thread's for the whole sweep, each (row, j/W) sum a quad's,
//     complete in one block (W divides 64). It is kept where it measured
//     faster than the one-hot body (ab_attention.py --grids): not at
//     8 x 8, which takes the one-hot body.
// Every grid with H + W <= 256 (MAX_REL) takes the same two kernels; shared
// memory grows with H + W only through the bias rows and drel sums. Rows
// past L (TMA's zero fill) are computed and not written; keys past L are
// masked (their p and ds are 0).

#include <algorithm>

#include "sm90.cuh"

namespace {

constexpr int HD = 64;          // head dim (asserted by the wrappers)
constexpr int TB = 64;          // rows of a tile: a query or key block
constexpr uint32_t TILE_BYTES = TB * HD * 2;  // one 64 x 64 bf16 tile
constexpr int STAGES = 3;       // depth of the streamed ring
constexpr int MAX_REL = 256;    // the largest H + W (nn/attention.py)
constexpr int HELPERS = 96;     // producer threads that stage side data
constexpr float LOG2E = 1.4426950408889634f;
constexpr size_t SMEM_MAX = 232448;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the bf16 residual of a pair already packed as `hi`
__device__ __forceinline__ uint32_t pack_lo(float x, float y, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  return pack_bf16(x - h.x, y - h.y);
}

// two adjacent 8-column tiles of a 64 x N accumulator (columns 16kt..)
// as one 16-wide bf16 A fragment
template <int N>
__device__ __forceinline__ void pack_a(const float (&d)[N], int kt,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kt], d[8 * kt + 1]);
  a[1] = pack_bf16(d[8 * kt + 2], d[8 * kt + 3]);
  a[2] = pack_bf16(d[8 * kt + 4], d[8 * kt + 5]);
  a[3] = pack_bf16(d[8 * kt + 6], d[8 * kt + 7]);
}

// pitch (bf16) of a CTA's bias rows, 8 mod 64: the 8 rows a warp's lanes
// read at once start on 8 different groups of 4 banks
__host__ __device__ inline int rel_pitch(int R) { return (R + 55) / 64 * 64 + 8; }
// pitch (f32) of the drel sums, 4 mod 32 for the same reason
__host__ __device__ inline int acc_pitch(int R) { return (R + 27) / 32 * 32 + 4; }
// bytes of one stage's bias rows (dkv)
__host__ __device__ inline int rn_bytes(int R) { return TB * rel_pitch(R) * 2; }
// bins of the dq pass's one-hot matrix: rel_h columns a 64-key block
// touches (ceil(63/gw) + 1, at most gh) and rel_w columns (min(gw, 64)),
// each part rounded up to an instantiated width (8 or 64; 8 to 64)
inline int h_bins(int gh, int gw) {
  const int nh = std::min(gh, (TB - 1 + gw - 1) / gw + 1);
  return nh <= 8 ? 8 : 64;
}
inline int w_bins(int gw) {
  const int nw = std::min(gw, TB);
  return nw <= 8 ? 8 : nw <= 16 ? 16 : nw <= 32 ? 32 : 64;
}

// delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d] with o the
// forward's fp32 output; eight threads per 64-wide row, eight elements
// each
__global__ void attn_bwd_delta_kernel(const float* __restrict__ out32,
                                      const __nv_bfloat16* __restrict__ dout,
                                      float* __restrict__ delta, int B, int L,
                                      int n) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = t / 8;   // (b * L + i) * n + h
  const int part = (int)(t % 8);
  const int64_t rows = (int64_t)B * L * n;
  float acc = 0.f;
  if (row < rows) {
    const float4* pa =
        reinterpret_cast<const float4*>(out32 + row * HD + part * 8);
    const float4 a0 = pa[0], a1 = pa[1];
    uint4 rd = *reinterpret_cast<const uint4*>(dout + row * HD + part * 8);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&rd);
    const float2 d0 = __bfloat1622float2(pd[0]);
    const float2 d1 = __bfloat1622float2(pd[1]);
    const float2 d2 = __bfloat1622float2(pd[2]);
    const float2 d3 = __bfloat1622float2(pd[3]);
    acc = a0.x * d0.x + a0.y * d0.y + a0.z * d1.x + a0.w * d1.y +
          a1.x * d2.x + a1.y * d2.y + a1.z * d3.x + a1.w * d3.y;
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (row < rows && part == 0) {
    const int h = (int)(row % n);
    const int64_t bi = row / n;
    const int64_t b = bi / L, i = bi % L;
    delta[(b * n + h) * L + i] = acc;
  }
}

// rows r0.. (nrows of them, clamped to L - 1) of one (batch, head)'s bias
// into dst (pitch RP) by the threads t = 0..nt-1 of a group: 16-byte
// cp.async where rows are 16-byte aligned (R % 8 == 0), 4-byte where they
// are 4-byte aligned, else plain loads; the caller commits and waits
__device__ __forceinline__ void copy_rel_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ rel, int b, int h,
    int r0, int nrows, int L, int n, int R, int RP, int t, int nt) {
  const int64_t base = (int64_t)b * L * n + h;
  if (R % 8 == 0) {
    const int per = R / 8;
    for (int idx = t; idx < nrows * per; idx += nt) {
      const int r = idx / per, c = (idx - r * per) * 8;
      const int row = min(r0 + r, L - 1);
      sm90::cp_async16(dst + r * RP + c, rel + (base + (int64_t)row * n) * R + c);
    }
  } else if (R % 2 == 0) {
    const int per = R / 2;
    for (int idx = t; idx < nrows * per; idx += nt) {
      const int r = idx / per, c = (idx - r * per) * 2;
      const int row = min(r0 + r, L - 1);
      sm90::cp_async4(dst + r * RP + c, rel + (base + (int64_t)row * n) * R + c);
    }
  } else {
    for (int idx = t; idx < nrows * R; idx += nt) {
      const int r = idx / R, c = idx - r * R;
      const int row = min(r0 + r, L - 1);
      dst[r * RP + c] = rel[(base + (int64_t)row * n) * R + c];
    }
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// ----------------------------------------------------------------- dk, dv

// shared memory of the dkv pass: k and v (128 keys), the ring's q and do
// tiles, bias rows and lse/delta rows, the barriers
inline size_t dkv_smem(int R) {
  return 1024 + 4 * TILE_BYTES + STAGES * 2 * TILE_BYTES +
         STAGES * (size_t)rn_bytes(R) + STAGES * 2 * TB * 4 +
         8 * (1 + 2 * STAGES);
}

__global__ void __launch_bounds__(384, 1)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __nv_bfloat16* __restrict__ rel,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dqkv, int L, int n, int gh,
                    int gw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int R = gh + gw, RP = rel_pitch(R);
  const int RN = rn_bytes(R) / 2;
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 tiles
  __nv_bfloat16* sV = sK + 2 * TB * HD;                         // 2 tiles
  __nv_bfloat16* sQ = sV + 2 * TB * HD;                    // [STAGES] tiles
  __nv_bfloat16* sDO = sQ + STAGES * TB * HD;              // [STAGES] tiles
  __nv_bfloat16* sRN = sDO + STAGES * TB * HD;  // [STAGES][TB][RP]
  float* sLS = reinterpret_cast<float*>(sRN + STAGES * RN);  // [STAGES][2][TB]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sLS + STAGES * 2 * TB);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * 2 * TB, h = blockIdx.y, b = blockIdx.z;
  const int nqb = (L + TB - 1) / TB;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int64_t lrow = ((int64_t)b * n + h) * L;  // lse / delta row base

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1 + HELPERS / 32);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------------------------------------------------- producer
    sm90::regs_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        sm90::mbar_expect_tx(kv_full, 4 * TILE_BYTES);
        for (int i = 0; i < 2; ++i) {
          sm90::tma_load_3d(sK + i * TB * HD, &tm_qkv, kv_full, (n + h) * HD,
                            k0 + i * TB, b);
          sm90::tma_load_3d(sV + i * TB * HD, &tm_qkv, kv_full,
                            (2 * n + h) * HD, k0 + i * TB, b);
        }
        for (int qb = 0; qb < nqb; ++qb) {
          const int s = qb % STAGES;
          sm90::mbar_wait(&empty[s], ((qb / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], 2 * TILE_BYTES);
          sm90::tma_load_3d(sQ + s * TB * HD, &tm_qkv, &full[s], h * HD,
                            qb * TB, b);
          sm90::tma_load_3d(sDO + s * TB * HD, &tm_do, &full[s], h * HD,
                            qb * TB, b);
        }
      }
    } else {
      // the query block's bias rows, lse * log2(e) and delta, copied
      // asynchronously (rows past L: row L-1's bias, lse = +inf and
      // delta = 0, so their p and ds are 0)
      const int ht = threadIdx.x - 32;
      for (int qb = 0; qb < nqb; ++qb) {
        const int s = qb % STAGES;
        sm90::mbar_wait(&empty[s], ((qb / STAGES) & 1) ^ 1);
        copy_rel_rows(sRN + s * RN, rel, b, h, qb * TB, TB, L, n, R, RP, ht,
                      HELPERS);
        float* ls = sLS + s * 2 * TB;
        const int row = qb * TB + ht;
        if (ht < TB) {
          sm90::cp_async4(ls + ht, lse + lrow + min(row, L - 1));
          sm90::cp_async4(ls + TB + ht, delta + lrow + min(row, L - 1));
        }
        sm90::cp_async_commit();
        sm90::cp_async_wait<0>();
        if (ht < TB) {
          ls[ht] = row < L ? ls[ht] * LOG2E : INFINITY;
          if (row >= L) ls[TB + ht] = 0.f;
        }
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    sm90::regs_inc<232>();
    const int cw = warp - 4, wg = cw / 4;
    const int g8 = lane / 4, q4 = lane % 4;
    // this thread's two keys (rows g8, g8 + 8 of its warp's 16) and their
    // bias columns; keys past L take key L-1's and are not written
    int hc[2], wc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int j = min(k0 + wg * TB + (cw % 4) * 16 + g8 + 8 * i, L - 1);
      hc[i] = j / gw;
      wc[i] = gh + j - hc[i] * gw;
    }
    const float sl = scale * LOG2E;
    float dk[32], dv[32], s[32], dp[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) dk[e] = dv[e] = 0.f;
    const uint64_t dK = sm90::desc_sw128(sK + wg * TB * HD);
    const uint64_t dV = sm90::desc_sw128(sV + wg * TB * HD);
    // P^T and dS^T as A fragments (16 queries each)
    uint32_t pa[TB / 16][4], da[TB / 16][4];
    sm90::mbar_wait(kv_full, 0);
    // the dv and dk products of query block qb stay in flight while the
    // S^T and dP^T products of block qb + 1 are issued; their stage is
    // released once they are done
    for (int qb = 0; qb < nqb; ++qb) {
      const int st = qb % STAGES;
      sm90::mbar_wait(&full[st], (qb / STAGES) & 1);
      const uint64_t dQ = sm90::desc_sw128(sQ + st * TB * HD);
      const uint64_t dO = sm90::desc_sw128(sDO + st * TB * HD);
      sm90::reg_fence(s);
      sm90::reg_fence(dp);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n64(s, dK + 2 * kk, dQ + 2 * kk, kk);
      sm90::wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n64(dp, dV + 2 * kk, dO + 2 * kk, kk);
      sm90::wg_commit();
      const __nv_bfloat16* rn = sRN + st * RN;
      const float* ls = sLS + st * 2 * TB;
      sm90::wg_wait<2>();  // block qb - 1's dv and dk
      sm90::reg_fence(dk);
      sm90::reg_fence(dv);
      sm90::reg_fence(pa);
      sm90::reg_fence(da);
      if (qb > 0 && lane == 0)
        sm90::mbar_arrive(&empty[(qb + STAGES - 1) % STAGES]);
      sm90::wg_wait<1>();
      sm90::reg_fence(s);
      // P^T: keys (rows) x queries 8t + 2*q4 + {0, 1} (columns)
#pragma unroll
      for (int t = 0; t < TB / 8; ++t) {
        const int qc = 8 * t + 2 * q4;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + qc);
        const __nv_bfloat16* r0 = rn + qc * RP;
        const __nv_bfloat16* r1 = r0 + RP;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float b0 = __bfloat162float(r0[hc[i]]) +
                           __bfloat162float(r0[wc[i]]);
          const float b1 = __bfloat162float(r1[hc[i]]) +
                           __bfloat162float(r1[wc[i]]);
          s[4 * t + 2 * i] = ex2(fmaf(s[4 * t + 2 * i], sl,
                                      fmaf(b0, LOG2E, -l2.x)));
          s[4 * t + 2 * i + 1] = ex2(fmaf(s[4 * t + 2 * i + 1], sl,
                                          fmaf(b1, LOG2E, -l2.y)));
        }
      }
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt) pack_a(s, kt, pa[kt]);
      sm90::reg_fence(pa);
      sm90::wg_fence();
      // dv += P^T . do (16 queries = 2 KB a step), while dS^T is formed
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        sm90::wgmma_rs_n64_t(dv, pa[kt], dO + kt * (16 * HD * 2 >> 4));
      sm90::wg_commit();
      sm90::wg_wait<1>();
      sm90::reg_fence(dp);
      // dS^T = P^T * (dP^T - delta)
#pragma unroll
      for (int t = 0; t < TB / 8; ++t) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + TB + 8 * t + 2 * q4);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dp[4 * t + 2 * i] = s[4 * t + 2 * i] * (dp[4 * t + 2 * i] - d2.x);
          dp[4 * t + 2 * i + 1] =
              s[4 * t + 2 * i + 1] * (dp[4 * t + 2 * i + 1] - d2.y);
        }
      }
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt) pack_a(dp, kt, da[kt]);
      sm90::reg_fence(da);
      sm90::wg_fence();
      // dk += dS^T . q
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        sm90::wgmma_rs_n64_t(dk, da[kt], dQ + kt * (16 * HD * 2 >> 4));
      sm90::wg_commit();
    }
    sm90::wg_wait<0>();
    sm90::reg_fence(dk);
    sm90::reg_fence(dv);
    const int64_t C3 = 3LL * n * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + wg * TB + (cw % 4) * 16 + g8 + 8 * i;
      if (key >= L) continue;
      __nv_bfloat16* krow = dqkv + ((int64_t)b * L + key) * C3 + (n + h) * HD;
      __nv_bfloat16* vrow = krow + n * HD;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(&krow[8 * t + 2 * q4]) =
            __floats2bfloat162_rn(dk[4 * t + 2 * i] * scale,
                                  dk[4 * t + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(&vrow[8 * t + 2 * q4]) =
            __floats2bfloat162_rn(dv[4 * t + 2 * i], dv[4 * t + 2 * i + 1]);
      }
    }
  }
}

// ------------------------------------------------------------- dq, drel

// shared memory of the dq pass with NWG consumer warpgroups: q and do, the
// ring's k, v and one-hot tiles (nbin = NH + NW rows), the bias rows, the
// drel sums, barriers
inline size_t dq_smem(int nwg, int nbin, int R) {
  return 1024 + nwg * 2 * TILE_BYTES +
         STAGES * (2 * TILE_BYTES + (size_t)nbin * HD * 2) +
         (size_t)nwg * TB * rel_pitch(R) * 2 +
         (size_t)nwg * TB * acc_pitch(R) * 4 + 8 * (1 + 2 * STAGES);
}

// D (64 x N) {+}= A . onehot^T for the instantiated bin counts
template <int N>
__device__ __forceinline__ void wgmma_bins(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (N == 8) sm90::wgmma_rs_n8(d, a, db, scale_d);
  if constexpr (N == 16) sm90::wgmma_rs_n16(d, a, db, scale_d);
  if constexpr (N == 32) sm90::wgmma_rs_n32(d, a, db, scale_d);
  if constexpr (N == 64) sm90::wgmma_rs_n64(d, a, db, scale_d);
}

// the rel_h bins (NH) and rel_w bins (NW) of the one-hot matrix; WS > 0:
// a square WS x WS grid with WS in {16, 32} (bsize 128 and 256 at patch
// 8), whose rel_w terms a thread reads sit in registers and whose rel_h
// term is one per row and W keys
template <int NWG, int NH, int NW, int WS>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __nv_bfloat16* __restrict__ rel,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dqkv,
                   __nv_bfloat16* __restrict__ drel, int L, int n, int gh,
                   int gw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  constexpr int NBIN = NH + NW;
  const int R = gh + gw, RP = rel_pitch(R), AP = acc_pitch(R);
  // W <= 64: rel_w bin u is grid column u in every key block, so the
  // rel_w sums stay in registers for the whole sweep; else bin u is the
  // block's key u and they are added to the drel rows per block
  const bool wstatic = gw <= TB;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [NWG] tiles
  __nv_bfloat16* sDO = sQ + NWG * TB * HD;                      // [NWG]
  __nv_bfloat16* sK = sDO + NWG * TB * HD;                      // [STAGES]
  __nv_bfloat16* sV = sK + STAGES * TB * HD;                    // [STAGES]
  __nv_bfloat16* sOH = sV + STAGES * TB * HD;  // [STAGES][NBIN][64 keys]
  __nv_bfloat16* sRel = sOH + STAGES * NBIN * HD;  // [NWG * 64][RP]
  float* sAcc = reinterpret_cast<float*>(sRel + NWG * TB * RP);  // [..][AP]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sAcc + NWG * TB * AP);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int q0 = blockIdx.x * NWG * TB, h = blockIdx.y, b = blockIdx.z;
  const int nkb = (L + TB - 1) / TB;
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread, and the warps that build the one-hot tiles
      sm90::mbar_init(&full[s], 1 + (WS ? 0 : HELPERS / 32));
      sm90::mbar_init(&empty[s], 4 * NWG);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------------------------------------------------- producer
    if constexpr (NWG == 2) sm90::regs_dec<40>();
    if (warp == 0) {
      if (lane == 0) {
        sm90::mbar_expect_tx(q_full, 2 * NWG * TILE_BYTES);
        for (int w = 0; w < NWG; ++w) {
          sm90::tma_load_3d(sQ + w * TB * HD, &tm_qkv, q_full, h * HD,
                            q0 + w * TB, b);
          sm90::tma_load_3d(sDO + w * TB * HD, &tm_do, q_full, h * HD,
                            q0 + w * TB, b);
        }
        for (int kb = 0; kb < nkb; ++kb) {
          const int s = kb % STAGES;
          sm90::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], 2 * TILE_BYTES);
          sm90::tma_load_3d(sK + s * TB * HD, &tm_qkv, &full[s],
                            (n + h) * HD, kb * TB, b);
          sm90::tma_load_3d(sV + s * TB * HD, &tm_qkv, &full[s],
                            (2 * n + h) * HD, kb * TB, b);
        }
      }
    } else if (WS == 0) {
      // the key block's one-hot matrix, NBIN rows of 64 keys (128 bytes,
      // swizzled as TMA would write it): bin b < NH is rel_h column
      // j/W = k0/W + b, bin NH + u rel_w column u (W <= 64) or the
      // block's key u (W > 64); keys past L match nothing. 16 bytes (8
      // keys) a store.
      const int ht = threadIdx.x - 32;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % STAGES;
        const int k0 = kb * TB, hlo = k0 / gw;
        sm90::mbar_wait(&empty[s], ((kb / STAGES) & 1) ^ 1);
        unsigned char* oh = reinterpret_cast<unsigned char*>(
            sOH + s * NBIN * HD);
        for (int idx = ht; idx < NBIN * 8; idx += HELPERS) {
          const int bin = idx / 8, ch = idx % 8;
          int j = k0 + 8 * ch, hj = j / gw, wj = j - hj * gw;
          uint32_t w4[4];
#pragma unroll
          for (int e = 0; e < 8; ++e, ++j) {
            const bool hit =
                j < L && (bin < NH ? hj - hlo == bin
                                   : bin - NH == (wstatic ? wj : 8 * ch + e));
            const uint32_t v = hit ? 0x3F80u : 0u;  // bf16 1.0
            if (e % 2 == 0)
              w4[e / 2] = v;
            else
              w4[e / 2] |= v << 16;
            if (++wj == gw) {
              wj = 0;
              ++hj;
            }
          }
          *reinterpret_cast<uint4*>(oh + bin * 128 + ((ch ^ (bin & 7)) << 4)) =
              make_uint4(w4[0], w4[1], w4[2], w4[3]);
        }
        sm90::fence_proxy_async();  // read by wgmma
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&full[s]);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (NWG == 2) sm90::regs_inc<232>();
    const int cw = warp - 4, wg = cw / 4;
    const int g8 = lane / 4, q4 = lane % 4;
    const int wrow = wg * TB + (cw % 4) * 16;  // the warp's first CTA row
    // this warp's 16 bias rows (rows past L repeat row L-1) and zeroed
    // drel sums
    copy_rel_rows(sRel + wrow * RP, rel, b, h, q0 + wrow, 16, L, n, R, RP,
                  lane, 32);
    sm90::cp_async_commit();
    for (int idx = lane; idx < 16 * AP; idx += 32) sAcc[wrow * AP + idx] = 0.f;
    sm90::cp_async_wait<0>();
    __syncwarp();
    float lse2[2], dl[2];
    const __nv_bfloat16* br[2];
    float* ar[2];
    // WS > 0: the rel_w terms of this thread's key columns 8u + 2*q4 +
    // {0, 1} (mod WS), times log2(e)
    float rwr[2][WS ? WS / 8 : 1][2];
    float dwr[2][WS ? WS / 8 : 1][2] = {};  // WS > 0: this thread's drel_w
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wrow + g8 + 8 * i;
      const int64_t at = ((int64_t)b * n + h) * L + min(q0 + r, L - 1);
      lse2[i] = lse[at] * LOG2E;
      dl[i] = delta[at];
      br[i] = sRel + r * RP;
      ar[i] = sAcc + r * AP;
      if constexpr (WS > 0) {
#pragma unroll
        for (int u = 0; u < WS / 8; ++u) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(br[i] + WS + 8 * u +
                                                       2 * q4));
          rwr[i][u][0] = f.x * LOG2E;
          rwr[i][u][1] = f.y * LOG2E;
        }
      }
    }
    const float sl = scale * LOG2E;
    const int d8h = 8 / gw, d8w = 8 - d8h * gw;
    float dq[32], s[32], dp[32], dh[NH / 2], dw[NW / 2];
#pragma unroll
    for (int e = 0; e < 32; ++e) dq[e] = 0.f;
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) dw[e] = 0.f;
    const int wscale = wstatic ? 1 : 0;  // scale_d of a block's first step
    const uint64_t dQ = sm90::desc_sw128(sQ + wg * TB * HD);
    const uint64_t dO = sm90::desc_sw128(sDO + wg * TB * HD);
    // key block k0's rel_h sums (bin 8t + 2*q4 + e of rows g8, g8 + 8 is
    // column k0/W + bin, if the block reaches it) into the drel rows;
    // with W > 64 its rel_w sums too (bin u: column (k0 + u) % W)
    auto add_block_sums = [&](int k0) {
      const int hlo = k0 / gw;
      const int nh = (min(k0 + TB, L) - 1) / gw - hlo + 1;
#pragma unroll
      for (int t = 0; t < NH / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int bin = 8 * t + 2 * q4 + e;
          if (bin < nh) {
            ar[0][hlo + bin] += dh[4 * t + e];
            ar[1][hlo + bin] += dh[4 * t + 2 + e];
          }
        }
      if (!wstatic) {
        const int wofs = k0 % gw;
#pragma unroll
        for (int t = 0; t < NW / 8; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = 8 * t + 2 * q4 + e;
            const int c = gh + (wofs + u < gw ? wofs + u : wofs + u - gw);
            ar[0][c] += dw[4 * t + e];
            ar[1][c] += dw[4 * t + 2 + e];
          }
      }
      __syncwarp();
    };
    // dS's bf16 hi and lo parts as A fragments (16 keys each)
    uint32_t hi[TB / 16][4], lo[TB / 16][4];
    sm90::mbar_wait(q_full, 0);
    for (int kb = 0; kb < nkb; ++kb) {
      const int st = kb % STAGES, k0 = kb * TB;
      sm90::mbar_wait(&full[st], (kb / STAGES) & 1);
      const uint64_t dK = sm90::desc_sw128(sK + st * TB * HD);
      const uint64_t dV = sm90::desc_sw128(sV + st * TB * HD);
      const uint64_t dBh = sm90::desc_sw128(sOH + st * NBIN * HD);
      const uint64_t dBw = sm90::desc_sw128(sOH + (st * NBIN + NH) * HD);
      sm90::reg_fence(s);
      sm90::reg_fence(dp);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n64(s, dQ + 2 * kk, dK + 2 * kk, kk);
      sm90::wg_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n64(dp, dO + 2 * kk, dV + 2 * kk, kk);
      sm90::wg_commit();
      sm90::wg_wait<1>();
      sm90::reg_fence(s);
      // P: query rows x keys k0 + 8t + 2*q4 + {0, 1}; keys past L are 0
      if constexpr (WS > 0) {
        // key tile t lies in grid row k0/WS + 8t/WS, its columns are
        // 8t % WS + 2*q4 + {0, 1}; L is a multiple of 64, so no key is
        // past L
        float rh[2];
#pragma unroll
        for (int t = 0; t < TB / 8; ++t) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (t % (WS / 8) == 0)
              rh[i] = fmaf(__bfloat162float(br[i][k0 / WS + 8 * t / WS]),
                           LOG2E, -lse2[i]);
            const float* rw = rwr[i][t % (WS / 8)];
            s[4 * t + 2 * i] = ex2(fmaf(s[4 * t + 2 * i], sl, rh[i] + rw[0]));
            s[4 * t + 2 * i + 1] =
                ex2(fmaf(s[4 * t + 2 * i + 1], sl, rh[i] + rw[1]));
          }
        }
      } else {
        // the grid row and column of key k0 + 2*q4, stepped 8 keys a tile
        int ha = (k0 + 2 * q4) / gw;
        int wa = k0 + 2 * q4 - ha * gw;
#pragma unroll
        for (int t = 0; t < TB / 8; ++t) {
          const bool wrap = wa + 1 == gw;
          const int h0 = min(ha, gh - 1), w0 = gh + wa;
          const int h1 = min(ha + wrap, gh - 1), w1 = wrap ? gh : w0 + 1;
          const int j = k0 + 8 * t + 2 * q4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float b0 = __bfloat162float(br[i][h0]) +
                             __bfloat162float(br[i][w0]);
            const float b1 = __bfloat162float(br[i][h1]) +
                             __bfloat162float(br[i][w1]);
            const float p0 = ex2(fmaf(s[4 * t + 2 * i], sl,
                                      fmaf(b0, LOG2E, -lse2[i])));
            const float p1 = ex2(fmaf(s[4 * t + 2 * i + 1], sl,
                                      fmaf(b1, LOG2E, -lse2[i])));
            s[4 * t + 2 * i] = j < L ? p0 : 0.f;
            s[4 * t + 2 * i + 1] = j + 1 < L ? p1 : 0.f;
          }
          wa += d8w;
          ha += d8h;
          if (wa >= gw) {
            wa -= gw;
            ++ha;
          }
        }
      }
      sm90::wg_wait<0>();
      sm90::reg_fence(dp);
      // dS = P * (dP - delta), then its bf16 hi and lo parts
#pragma unroll
      for (int t = 0; t < TB / 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * t + e] = s[4 * t + e] * (dp[4 * t + e] - dl[e / 2]);
      if constexpr (WS > 0) {
        // the bias gradients from the fp32 dS in registers: rel_w column
        // 8u + 2*q4 + e of rows g8, g8 + 8 (u = t mod WS/8) is this
        // thread's for the whole sweep; rel_h column k0/WS + a of a row
        // is the sum over its quad's keys of WS/8 tiles, complete in
        // this block (WS divides 64)
#pragma unroll
        for (int t = 0; t < TB / 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dwr[e / 2][t % (WS / 8)][e % 2] += dp[4 * t + e];
#pragma unroll
        for (int a = 0; a < TB / WS; ++a)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float v = 0.f;
#pragma unroll
            for (int t = a * (WS / 8); t < (a + 1) * (WS / 8); ++t)
              v += dp[4 * t + 2 * i] + dp[4 * t + 2 * i + 1];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (q4 == 0) ar[i][k0 / WS + a] = v;
          }
#pragma unroll
        for (int kt = 0; kt < TB / 16; ++kt) pack_a(dp, kt, hi[kt]);
        sm90::reg_fence(hi);
        sm90::reg_fence(dq);
        sm90::wg_fence();
#pragma unroll
        for (int kt = 0; kt < TB / 16; ++kt)
          sm90::wgmma_rs_n64_t(dq, hi[kt], dK + kt * (16 * HD * 2 >> 4));
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::reg_fence(dq);
        if (lane == 0) sm90::mbar_arrive(&empty[st]);
        continue;
      }
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt) {
        pack_a(dp, kt, hi[kt]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          lo[kt][r] = pack_lo(dp[8 * kt + 2 * r], dp[8 * kt + 2 * r + 1],
                              hi[kt][r]);
      }
      sm90::reg_fence(hi);
      sm90::reg_fence(lo);
      sm90::reg_fence(dq);
      sm90::reg_fence(dh);
      sm90::reg_fence(dw);
      sm90::wg_fence();
      // dq += dS . k (k MN-major: 16 keys = 2 KB a step); the bins' sums
      // dS_hi . onehot + dS_lo . onehot (16 keys = 32 B a step): rel_h's
      // afresh, rel_w's on top of the earlier blocks' (W <= 64)
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        sm90::wgmma_rs_n64_t(dq, hi[kt], dK + kt * (16 * HD * 2 >> 4));
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        wgmma_bins<NH>(dh, hi[kt], dBh + 2 * kt, kt);
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        wgmma_bins<NH>(dh, lo[kt], dBh + 2 * kt, 1);
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        wgmma_bins<NW>(dw, hi[kt], dBw + 2 * kt, kt | wscale);
#pragma unroll
      for (int kt = 0; kt < TB / 16; ++kt)
        wgmma_bins<NW>(dw, lo[kt], dBw + 2 * kt, 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::reg_fence(dq);
      sm90::reg_fence(dh);
      sm90::reg_fence(dw);
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
      add_block_sums(k0);
    }
    if constexpr (WS > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int u = 0; u < WS / 8; ++u)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            ar[i][WS + 8 * u + 2 * q4 + e] = dwr[i][u][e];
      __syncwarp();
    } else if (wstatic) {
      // the rel_w sums of the whole sweep (bin u: column u)
#pragma unroll
      for (int t = 0; t < NW / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = 8 * t + 2 * q4 + e;
          if (u < gw) {
            ar[0][gh + u] += dw[4 * t + e];
            ar[1][gh + u] += dw[4 * t + 2 + e];
          }
        }
      __syncwarp();
    }
    const int64_t C3 = 3LL * n * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g8 + 8 * i;
      if (row >= L) continue;
      __nv_bfloat16* qrow = dqkv + ((int64_t)b * L + row) * C3 + h * HD;
#pragma unroll
      for (int t = 0; t < HD / 8; ++t)
        *reinterpret_cast<__nv_bfloat162*>(&qrow[8 * t + 2 * q4]) =
            __floats2bfloat162_rn(dq[4 * t + 2 * i] * scale,
                                  dq[4 * t + 2 * i + 1] * scale);
    }
    for (int idx = lane; idx < 16 * R; idx += 32) {
      const int r = idx / R, c = idx - r * R;
      const int row = q0 + wrow + r;
      if (row < L)
        drel[(((int64_t)b * L + row) * n + h) * R + c] =
            __float2bfloat16(sAcc[(wrow + r) * AP + c]);
    }
  }
}

template <int NWG, int NH, int NW, int WS>
int launch_dq(const CUtensorMap& tq, const CUtensorMap& td, const void* rel,
              const float* lse, const float* delta, void* dqkv, void* drel,
              int B, int L, int n, int gh, int gw, float scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem(NWG, NH + NW, gh + gw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<NWG, NH, NW, WS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((L + NWG * TB - 1) / (NWG * TB), n, B);
  attn_bwd_dq_kernel<NWG, NH, NW, WS>
      <<<grid, 128 * (NWG + 1), smem, stream>>>(
      tq, td, static_cast<const __nv_bfloat16*>(rel), lse, delta,
      static_cast<__nv_bfloat16*>(dqkv), static_cast<__nv_bfloat16*>(drel),
      L, n, gh, gw, scale);
  return (int)cudaGetLastError();
}

// two consumer warpgroups where their shared memory fits, else one
template <int NH, int NW, int WS = 0>
int dispatch_dq(const CUtensorMap& tq, const CUtensorMap& td,
                const void* rel, const float* lse, const float* delta,
                void* dqkv, void* drel, int B, int L, int n, int gh, int gw,
                float scale, cudaStream_t stream) {
  if (dq_smem(2, NH + NW, gh + gw) <= SMEM_MAX)
    return launch_dq<2, NH, NW, WS>(tq, td, rel, lse, delta, dqkv, drel, B,
                                    L, n, gh, gw, scale, stream);
  return launch_dq<1, NH, NW, WS>(tq, td, rel, lse, delta, dqkv, drel, B, L,
                                  n, gh, gw, scale, stream);
}

template <int NH>
int dispatch_dq_w(const CUtensorMap& tq, const CUtensorMap& td,
                  const void* rel, const float* lse, const float* delta,
                  void* dqkv, void* drel, int B, int L, int n, int gh,
                  int gw, float scale, cudaStream_t stream) {
  switch (w_bins(gw)) {
    case 8:
      return dispatch_dq<NH, 8>(tq, td, rel, lse, delta, dqkv, drel, B, L,
                                n, gh, gw, scale, stream);
    case 16:
      return dispatch_dq<NH, 16>(tq, td, rel, lse, delta, dqkv, drel, B, L,
                                 n, gh, gw, scale, stream);
    case 32:
      return dispatch_dq<NH, 32>(tq, td, rel, lse, delta, dqkv, drel, B, L,
                                 n, gh, gw, scale, stream);
    default:
      return dispatch_dq<NH, 64>(tq, td, rel, lse, delta, dqkv, drel, B, L,
                                 n, gh, gw, scale, stream);
  }
}

}  // namespace

// qkv (B, L, 3*n*64), rel (B, L, n, gh+gw) and dout (B, L, n*64), bf16,
// 16-byte aligned; from the forward, out32 (B, L, n*64) and lse (B, n, L),
// f32; delta (B, n, L) f32 scratch; writes dqkv (B, L, 3*n*64) and drel
// (B, L, n, gh+gw), bf16. Any grid with L = gh * gw and gh + gw <= 256.
extern "C" int attn_bwd_bf16(const void* qkv, const void* rel,
                             const void* out32, const void* dout,
                             const void* lse, void* delta, void* dqkv,
                             void* drel, int B, int L, int n, int gh, int gw,
                             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gh < 1 || gw < 1 || L != gh * gw || gh + gw > MAX_REL)
    return (int)cudaErrorInvalidValue;
  const int R = gh + gw;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);

  const int64_t threads = (int64_t)B * L * n * 8;
  attn_bwd_delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(out32),
      static_cast<const __nv_bfloat16*>(dout), dl, B, L, n);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const uint64_t row = 3ull * n * HD * 2, drow = (uint64_t)n * HD * 2;
  CUtensorMap tq, td;
  if (!sm90::make_map_3d(&tq, qkv, 3ull * n * HD, L, B, row, row * L, HD,
                         TB) ||
      !sm90::make_map_3d(&td, dout, (uint64_t)n * HD, L, B, drow, drow * L,
                         HD, TB))
    return (int)cudaErrorInvalidValue;

  if (gh == gw && (gw == 16 || gw == 32))
    err = gw == 16 ? dispatch_dq<8, 8, 16>(tq, td, rel, l, dl, dqkv, drel, B,
                                           L, n, gh, gw, scale, st)
                   : dispatch_dq<8, 8, 32>(tq, td, rel, l, dl, dqkv, drel, B,
                                           L, n, gh, gw, scale, st);
  else
    err = h_bins(gh, gw) == 8
            ? dispatch_dq_w<8>(tq, td, rel, l, dl, dqkv, drel, B, L, n, gh,
                               gw, scale, st)
            : dispatch_dq_w<64>(tq, td, rel, l, dl, dqkv, drel, B, L, n, gh,
                                gw, scale, st);
  if (err) return err;

  const size_t smem = dkv_smem(R);
  err = (int)cudaFuncSetAttribute(attn_bwd_dkv_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  attn_bwd_dkv_kernel<<<dim3((L + 2 * TB - 1) / (2 * TB), n, B), 384, smem,
                        st>>>(tq, td, static_cast<const __nv_bfloat16*>(rel),
                              l, dl, static_cast<__nv_bfloat16*>(dqkv), L, n,
                              gh, gw, scale);
  return (int)cudaGetLastError();
}
