// Backward of the attention with the SAM decomposed relative-position bias,
// bf16 operands, fp32 accumulation.
//
// Replaces the TPU kernel classpose_tpu/nn/attention.py _attn_bwd_pallas /
// _attn_bwd_kernel_blc (the pallas_call at attention.py:540). With the
// extended rows of the forward (attention.cu),
//   qx_i = [q_i*scale | rel_h[i] | rel_w[i]],  kx_j = [k_j | onehot(j/W) |
//   onehot(j%W)],  s = qx . kx^T,  p = softmax_j(s),  o = p . v,
// it returns, for the output cotangent do,
//   dv = p^T . do,  dp = do . v^T,  ds = p * (dp - rowsum(p * dp)),
//   [d(q*scale) | drel_h | drel_w] = ds . kx,  dk = ds^T . (q*scale),
// written as dqkv = [dq | dk | dv] in qkv's (B, L, 3*n*64) layout and drel
// in rel's (B, L, n, H+W) layout, both bf16. p is cast to bf16 before the
// dv product and ds before the dq and dk products, as on the TPU. The
// bias gradients are partial sums of rows of ds that sum to zero, so they
// are kept clear of rounding that is correlated along a row: they sum the
// fp32 ds (on the TPU a product of the bf16 ds with the one-hot
// columns), and delta comes from the forward's fp32 output, not its bf16
// one (see attention.cu).
//
// What bounds it on an H100: the five L x L x 64 products per (batch,
// head), 10*B*n*L^2*64 FLOP (~86 GFLOP per layer call at B = 8, n = 16,
// L = 1024, i.e. ~0.087 ms at 989 TFLOP/s dense bf16), against ~100 MB of
// operands: far above the card's ~295 FLOP/byte ridge, so it is bound by
// operations. The design therefore keeps every L x L quantity on chip and
// runs every product on the tensor cores.
//
// Design (FlashAttention-2's backward). The TPU kernel held a whole
// (L, L) tile per head pair in VMEM; an SM has 227 KB, so the work is
// split three ways and nothing of size L x L ever reaches device memory:
//   1. attn_bwd_delta: delta_i = do_i . o_i per row (equal to
//      sum_j p_ij dp_ij), from the forward's fp32 output;
//   2. attn_bwd_dkv: one block of four warps per (64-key block, head,
//      batch), each warp owning 16 keys. It loops over the 64-query
//      blocks, recomputes p^T = exp(s^T - lse) from k, the one-hot key
//      columns, the extended queries and the forward's log-sum-exp, and
//      accumulates dv and dk in fp32 registers;
//   3. attn_bwd_dq: one block per (64-query block, head, batch). It loops
//      over the 64-key blocks, recomputes p the same way, accumulates dq
//      in fp32 registers, and reduces ds into the bias gradients in
//      registers: with W | 64 a key block covers 64/W whole rows of the
//      grid, so drel_h[i, a] = sum_{j: j/W = a} ds_ij is complete within
//      one block (written at once), and drel_w[i, b] = sum_{j: j%W = b}
//      ds_ij has every (row, b) owned by one thread (W % 8 == 0).
// All products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); the
// streamed blocks are double-buffered in shared memory with cp.async.
// Every output element is written by exactly one thread and no atomics
// are used, so the result is deterministic. wgmma/TMA and fusing the two
// main passes are later work: chip_smoke.py measured 0.82 ms per layer
// call at B = 8 on an NVIDIA H100 80GB HBM3 at 700 W, 9.5x the bound.

#include "mma.cuh"

namespace {

using namespace attn;

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

// dq and drel: one block per (64-query block, head, batch); G = H = W
template <int G>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ rel,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dqkv,
                   __nv_bfloat16* __restrict__ drel, int L, int n,
                   float scale) {
  constexpr int R = 2 * G;
  constexpr int KX = HD + R;
  constexpr int QP = KX + 8;
  constexpr int NKS = KX / 16;
  constexpr int NH = BK / G;       // grid rows covered by one key block
  constexpr int NW = G / 8;        // drel_w slots per thread and row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x QP
  __nv_bfloat16* sDO = sQ + BQ * QP;                            // BQ x KP
  __nv_bfloat16* sK = sDO + BQ * KP;                            // 2 x BK x KP
  __nv_bfloat16* sV = sK + 2 * BK * KP;                         // 2 x BK x KP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int64_t C3 = 3LL * n * HD;
  const __nv_bfloat16* base = qkv + (int64_t)b * L * C3;
  const __nv_bfloat16* dbase = dout + (int64_t)b * L * n * HD;

  auto load_kv = [&](int stage, int k0) {
    for (int idx = tid; idx < BK * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const __nv_bfloat16* src = base + (int64_t)(k0 + r) * C3 + h * HD + c;
      cp_async16(saddr(&sK[(stage * BK + r) * KP + c]), src + n * HD);
      cp_async16(saddr(&sV[(stage * BK + r) * KP + c]), src + 2 * n * HD);
    }
    cp_commit();
  };

  const int nblk = L / BK;
  load_kv(0, 0);

  // extended queries [q*scale | rel] and the output cotangent rows
  for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(
        base + (int64_t)(q0 + r) * C3 + h * HD + c);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(p[e]);
      p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(&sQ[r * QP + c]) = raw;
    *reinterpret_cast<uint4*>(&sDO[r * KP + c]) =
        *reinterpret_cast<const uint4*>(dbase + (int64_t)(q0 + r) * n * HD +
                                        h * HD + c);
  }
  for (int idx = tid; idx < BQ * R / 8; idx += NWARP * 32) {
    const int r = idx / (R / 8), c = (idx % (R / 8)) * 8;
    *reinterpret_cast<uint4*>(&sQ[r * QP + HD + c]) =
        *reinterpret_cast<const uint4*>(
            rel + (((int64_t)b * L + q0 + r) * n + h) * R + c);
  }
  __syncthreads();

  uint32_t qa[NKS][4];
  uint32_t da[HD / 16][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      ldsm_x4(qa[ks], saddr(&sQ[row * QP + ks * 16 + col]));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_x4(da[ks], saddr(&sDO[row * KP + ks * 16 + col]));
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int64_t at = ((int64_t)b * n + h) * L + q0 + warp * 16 + g + 8 * r2;
    lse_r[r2] = lse[at];
    dl_r[r2] = delta[at];
  }

  float dq[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;
  float dw[2][NW][2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
    for (int w = 0; w < NW; ++w) dw[r2][w][0] = dw[r2][w][1] = 0.f;

  for (int kb = 0; kb < nblk; ++kb) {
    const int stage = kb & 1;
    if (kb + 1 < nblk) {
      load_kv(stage ^ 1, (kb + 1) * BK);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = kb * BK;
    const __nv_bfloat16* Ks = sK + stage * BK * KP;
    const __nv_bfloat16* Vs = sV + stage * BK * KP;

    // s = qx . kx^T, as the forward computes it; then p = exp(s - lse)
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, saddr(&Ks[(nt * 8 + lane % 8) * KP + kk * 32 +
                              (lane / 8) * 8]));
        mma16816(s[nt], qa[2 * kk], bk[0], bk[1]);
        mma16816(s[nt], qa[2 * kk + 1], bk[2], bk[3]);
      }
      const int key = k0 + nt * 8 + g;
      const int hc = key / G;
      const int wc = G + key % G;
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks) {
        const int c = ks * 16 + 2 * tig;
        mma16816(s[nt], qa[HD / 16 + ks], onehot_pair(c, hc, wc),
                 onehot_pair(c + 8, hc, wc));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = __expf(s[nt][e] - lse_r[e / 2]);
    }

    // dp = do . v^T, then ds = p * (dp - delta) in place, fp32 (rounded
    // to bf16 only as the dq product's operand)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t bv[4];
        ldsm_x4(bv, saddr(&Vs[(nt * 8 + lane % 8) * KP + kk * 32 +
                              (lane / 8) * 8]));
        mma16816(dp, da[2 * kk], bv[0], bv[1]);
        mma16816(dp, da[2 * kk + 1], bv[2], bv[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] *= dp[e] - dl_r[e / 2];
    }

    // dq += ds . k
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int nt2 = 0; nt2 < HD / 16; ++nt2) {
        uint32_t bk[4];
        ldsm_x4_t(bk, saddr(&Ks[(kt * 16 + lane % 8 + ((lane / 8) & 1) * 8) *
                                    KP + nt2 * 16 + (lane / 16) * 8]));
        mma16816(dq[2 * nt2], pa, bk[0], bk[1]);
        mma16816(dq[2 * nt2 + 1], pa, bk[2], bk[3]);
      }
    }

    // drel: key column k0 + nt*8 + 2*tig + e lies in grid row
    // k0/G + nt*8/G and grid column nt*8 % G + 2*tig + e
    float hs[2][NH];
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
      for (int a = 0; a < NH; ++a) hs[r2][a] = 0.f;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hs[e / 2][nt * 8 / G] += s[nt][e];
        dw[e / 2][(nt * 8 % G) / 8][e % 2] += s[nt][e];
      }
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int row = q0 + warp * 16 + g + 8 * r2;
      __nv_bfloat16* drow = drel + (((int64_t)b * L + row) * n + h) * R;
#pragma unroll
      for (int a = 0; a < NH; ++a) {
        float v = hs[r2][a];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) drow[k0 / G + a] = __float2bfloat16(v);
      }
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = q0 + warp * 16 + g + 8 * r2;
    __nv_bfloat16* qrow = dqkv + ((int64_t)b * L + row) * C3 + h * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(&qrow[nt * 8 + 2 * tig]) =
          __floats2bfloat162_rn(dq[nt][2 * r2] * scale,
                                dq[nt][2 * r2 + 1] * scale);
    __nv_bfloat16* drow = drel + (((int64_t)b * L + row) * n + h) * R + G;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      *reinterpret_cast<__nv_bfloat162*>(&drow[w * 8 + 2 * tig]) =
          __floats2bfloat162_rn(dw[r2][w][0], dw[r2][w][1]);
  }
}

// dk and dv: one block per (64-key block, head, batch); G = H = W
template <int G>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ rel,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dqkv, int L, int n,
                    float scale) {
  constexpr int R = 2 * G;
  constexpr int KX = HD + R;
  constexpr int QP = KX + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);  // BK x KP
  __nv_bfloat16* sV = sK + BK * KP;                             // BK x KP
  __nv_bfloat16* sQ = sV + BK * KP;                             // 2 x BQ x QP
  __nv_bfloat16* sDO = sQ + 2 * BQ * QP;                        // 2 x BQ x KP
  float* sL = reinterpret_cast<float*>(sDO + 2 * BQ * KP);      // 2 x BQ
  float* sD = sL + 2 * BQ;                                      // 2 x BQ

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int64_t C3 = 3LL * n * HD;
  const __nv_bfloat16* base = qkv + (int64_t)b * L * C3;
  const __nv_bfloat16* dbase = dout + (int64_t)b * L * n * HD;
  const int64_t lbase = ((int64_t)b * n + h) * L;

  // one query block: raw q, rel, do, lse and delta rows
  auto load_q = [&](int stage, int q0) {
    __nv_bfloat16* Qs = sQ + stage * BQ * QP;
    __nv_bfloat16* DOs = sDO + stage * BQ * KP;
    for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      cp_async16(saddr(&Qs[r * QP + c]),
                 base + (int64_t)(q0 + r) * C3 + h * HD + c);
      cp_async16(saddr(&DOs[r * KP + c]),
                 dbase + (int64_t)(q0 + r) * n * HD + h * HD + c);
    }
    for (int idx = tid; idx < BQ * R / 8; idx += NWARP * 32) {
      const int r = idx / (R / 8), c = (idx % (R / 8)) * 8;
      cp_async16(saddr(&Qs[r * QP + HD + c]),
                 rel + (((int64_t)b * L + q0 + r) * n + h) * R + c);
    }
    if (tid < BQ / 4) {
      cp_async16(saddr(&sL[stage * BQ + tid * 4]), lse + lbase + q0 + tid * 4);
    } else if (tid < BQ / 2) {
      const int t = tid - BQ / 4;
      cp_async16(saddr(&sD[stage * BQ + t * 4]), delta + lbase + q0 + t * 4);
    }
    cp_commit();
  };

  for (int idx = tid; idx < BK * HD / 8; idx += NWARP * 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const __nv_bfloat16* src = base + (int64_t)(k0 + r) * C3 + h * HD + c;
    cp_async16(saddr(&sK[r * KP + c]), src + n * HD);
    cp_async16(saddr(&sV[r * KP + c]), src + 2 * n * HD);
  }
  load_q(0, 0);  // one group with k and v
  cp_wait<0>();
  __syncthreads();

  // this warp's 16 keys as A operands: k, v, and the one-hot columns
  uint32_t ka[HD / 16][4], va[HD / 16][4], oa[R / 16][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_x4(ka[ks], saddr(&sK[row * KP + ks * 16 + col]));
      ldsm_x4(va[ks], saddr(&sV[row * KP + ks * 16 + col]));
    }
    const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;
    const int hc0 = j0 / G, wc0 = G + j0 % G;
    const int hc1 = j1 / G, wc1 = G + j1 % G;
#pragma unroll
    for (int ks = 0; ks < R / 16; ++ks) {
      const int c = ks * 16 + 2 * tig;
      oa[ks][0] = onehot_pair(c, hc0, wc0);
      oa[ks][1] = onehot_pair(c, hc1, wc1);
      oa[ks][2] = onehot_pair(c + 8, hc0, wc0);
      oa[ks][3] = onehot_pair(c + 8, hc1, wc1);
    }
  }

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int nblk = L / BQ;
  for (int qb = 0; qb < nblk; ++qb) {
    const int stage = qb & 1;
    if (qb + 1 < nblk) {
      load_q(stage ^ 1, (qb + 1) * BQ);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    __nv_bfloat16* Qs = sQ + stage * BQ * QP;
    const __nv_bfloat16* DOs = sDO + stage * BQ * KP;
    const float* Ls = sL + stage * BQ;
    const float* Ds = sD + stage * BQ;
    // q -> bf16(q*scale) in place, as the forward rounds it
    for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      uint4* at = reinterpret_cast<uint4*>(&Qs[r * QP + c]);
      uint4 raw = *at;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
      for (int e = 0; e < 4; ++e) {
        float2 f = __bfloat1622float2(p[e]);
        p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *at = raw;
    }
    __syncthreads();

    // s^T = kx . qx^T (16 keys x 64 queries per warp), p^T = exp(s^T - lse)
    float s[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* qrow = &Qs[(nt * 8 + lane % 8) * QP];
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t bq[4];
        ldsm_x4(bq, saddr(qrow + kk * 32 + (lane / 8) * 8));
        mma16816(s[nt], ka[2 * kk], bq[0], bq[1]);
        mma16816(s[nt], ka[2 * kk + 1], bq[2], bq[3]);
      }
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks) {
        uint32_t bq[2];
        ldsm_x2(bq, saddr(qrow + HD + ks * 16 + ((lane / 8) & 1) * 8));
        mma16816(s[nt], oa[ks], bq[0], bq[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = __expf(s[nt][e] - Ls[nt * 8 + 2 * tig + e % 2]);
    }

    // dv += p^T . do
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int nt2 = 0; nt2 < HD / 16; ++nt2) {
        uint32_t bd[4];
        ldsm_x4_t(bd, saddr(&DOs[(kt * 16 + lane % 8 + ((lane / 8) & 1) * 8) *
                                     KP + nt2 * 16 + (lane / 16) * 8]));
        mma16816(dv[2 * nt2], pa, bd[0], bd[1]);
        mma16816(dv[2 * nt2 + 1], pa, bd[2], bd[3]);
      }
    }

    // dp^T = v . do^T, then ds^T = p^T * (dp^T - delta)
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 32; ++kk) {
        uint32_t bd[4];
        ldsm_x4(bd, saddr(&DOs[(nt * 8 + lane % 8) * KP + kk * 32 +
                               (lane / 8) * 8]));
        mma16816(dp, va[2 * kk], bd[0], bd[1]);
        mma16816(dp, va[2 * kk + 1], bd[2], bd[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] *= dp[e] - Ds[nt * 8 + 2 * tig + e % 2];
    }

    // dk += ds^T . (q*scale)
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int nt2 = 0; nt2 < HD / 16; ++nt2) {
        uint32_t bq[4];
        ldsm_x4_t(bq, saddr(&Qs[(kt * 16 + lane % 8 + ((lane / 8) & 1) * 8) *
                                    QP + nt2 * 16 + (lane / 16) * 8]));
        mma16816(dk[2 * nt2], pa, bq[0], bq[1]);
        mma16816(dk[2 * nt2 + 1], pa, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int key = k0 + warp * 16 + g + 8 * r2;
    __nv_bfloat16* krow = dqkv + ((int64_t)b * L + key) * C3 + n * HD + h * HD;
    __nv_bfloat16* vrow = krow + n * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(&krow[nt * 8 + 2 * tig]) =
          __floats2bfloat162_rn(dk[nt][2 * r2], dk[nt][2 * r2 + 1]);
      *reinterpret_cast<__nv_bfloat162*>(&vrow[nt * 8 + 2 * tig]) =
          __floats2bfloat162_rn(dv[nt][2 * r2], dv[nt][2 * r2 + 1]);
    }
  }
}

template <int G>
int launch(const void* qkv, const void* rel, const void* out32,
           const void* dout, const void* lse, void* delta, void* dqkv,
           void* drel, int B, int L, int n, float scale,
           cudaStream_t stream) {
  constexpr int R = 2 * G;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* r = static_cast<const __nv_bfloat16*>(rel);
  const auto* o = static_cast<const float*>(out32);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* dq = static_cast<__nv_bfloat16*>(dqkv);
  auto* dr = static_cast<__nv_bfloat16*>(drel);

  const int64_t threads = (int64_t)B * L * n * 8;
  attn_bwd_delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                          stream>>>(o, d, dl, B, L, n);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dq = ((size_t)BQ * (HD + R + 8) + (size_t)BQ * KP +
                          4ull * BK * KP) * 2;
  cudaFuncSetAttribute(attn_bwd_dq_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_dq);
  attn_bwd_dq_kernel<G><<<dim3(L / BQ, n, B), NWARP * 32, smem_dq, stream>>>(
      q, r, d, l, dl, dq, dr, L, n, scale);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dkv = (2ull * BK * KP + 2ull * BQ * (HD + R + 8) +
                           2ull * BQ * KP) * 2 + 4ull * BQ * sizeof(float);
  cudaFuncSetAttribute(attn_bwd_dkv_kernel<G>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_dkv);
  attn_bwd_dkv_kernel<G><<<dim3(L / BK, n, B), NWARP * 32, smem_dkv,
                           stream>>>(q, r, d, l, dl, dq, L, n, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, L, 3*n*64), rel (B, L, n, 2G) and dout (B, L, n*64), bf16; from
// the forward, out32 (B, L, n*64) and lse (B, n, L), f32; delta (B, n, L)
// f32 scratch; writes dqkv (B, L, 3*n*64) and drel (B, L, n, 2G), bf16.
// A square G x G grid with G in {8, 16, 32}, L = G*G a multiple of 64.
extern "C" int attn_bwd_bf16(const void* qkv, const void* rel,
                             const void* out32, const void* dout,
                             const void* lse, void* delta, void* dqkv,
                             void* drel, int B, int L, int n, int gh, int gw,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gh != gw || L != gh * gw || L % 64) return (int)cudaErrorInvalidValue;
  switch (gw) {
    case 8: return launch<8>(qkv, rel, out32, dout, lse, delta, dqkv, drel,
                             B, L, n, scale, s);
    case 16: return launch<16>(qkv, rel, out32, dout, lse, delta, dqkv, drel,
                               B, L, n, scale, s);
    case 32: return launch<32>(qkv, rel, out32, dout, lse, delta, dqkv, drel,
                               B, L, n, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
