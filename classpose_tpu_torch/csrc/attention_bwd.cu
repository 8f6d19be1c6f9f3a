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
//      That holds for the square grids of side 8, 16, 32 and 64 (bsize
//      64 to 512 at patch 8). Every other grid with H + W <= 128 (28 x 28,
//      non-square, L % 64 != 0) takes a second instantiation: each warp
//      stages its 16 x 64 fp32 ds in shared memory, then lane r sums row
//      r's keys into drel_h and lane 16 + r into drel_w, in key order, into
//      fp32 accumulators in shared memory that only that lane touches;
//      keys past L are masked and rows past L are computed on row L-1 and
//      not written.
// The rel row is padded with zero columns to a multiple of 16 for the
// one-hot products.
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

// the rel columns [rel_h | rel_w | zeros to RP] of query rows q0.. of one
// (batch, head) into dst (pitch QP, from column HD): 16-byte cp.async
// when a row of rel is 16-byte aligned (R % 8 == 0), else plain loads;
// rows past L repeat row L-1. The zero columns are written by the caller.
template <int QP>
__device__ __forceinline__ void load_rel_rows(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ rel, int b, int h,
    int q0, int L, int n, int R, int tid) {
  if (R % 8 == 0) {
    for (int idx = tid; idx < BQ * R / 8; idx += NWARP * 32) {
      const int r = idx / (R / 8), c = (idx - r * (R / 8)) * 8;
      const int row = min(q0 + r, L - 1);
      cp_async16(saddr(&dst[r * QP + HD + c]),
                 rel + (((int64_t)b * L + row) * n + h) * R + c);
    }
  } else {
    for (int idx = tid; idx < BQ * R; idx += NWARP * 32) {
      const int r = idx / R, c = idx - r * R;
      const int row = min(q0 + r, L - 1);
      dst[r * QP + HD + c] = rel[(((int64_t)b * L + row) * n + h) * R + c];
    }
  }
}

// zero the padding columns HD + R .. HD + RP of `rows` rows (pitch QP)
template <int RP, int QP>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int rows, int R,
                                         int tid) {
  for (int idx = tid; idx < rows * (RP - R); idx += NWARP * 32) {
    const int r = idx / (RP - R), c = idx - r * (RP - R);
    dst[r * QP + HD + R + c] = __float2bfloat16(0.f);
  }
}

// dq and drel: one block per (64-query block, head, batch). The rel row is
// padded to RP (a multiple of 16) columns. WS > 0: a square WS x WS grid
// with WS | 64, whose bias gradients are reduced in registers (see the
// file's note); WS = 0: any grid, reduced through shared memory.
template <int RP, int WS>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const __nv_bfloat16* __restrict__ rel,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dqkv,
                   __nv_bfloat16* __restrict__ drel, int L, int n, int gh_,
                   int gw_, float scale) {
  constexpr int QP = HD + RP + 8;
  constexpr int NH = WS ? BK / WS : 1;  // grid rows covered by a key block
  constexpr int NW = WS ? WS / 8 : 1;   // drel_w slots per thread and row
  constexpr int DSP = BK + 1;           // pitch of the staged ds rows
  constexpr int AP = RP + 1;            // pitch of the drel accumulators
  const int gh = WS ? WS : gh_, gw = WS ? WS : gw_;
  const int R = gh + gw;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x QP
  __nv_bfloat16* sDO = sQ + BQ * QP;                            // BQ x KP
  __nv_bfloat16* sK = sDO + BQ * KP;                            // 2 x BK x KP
  __nv_bfloat16* sV = sK + 2 * BK * KP;                         // 2 x BK x KP
  float* sDS = reinterpret_cast<float*>(sV + 2 * BK * KP);      // WS = 0:
  float* sAcc = sDS + NWARP * 16 * DSP;  // 16 x DSP per warp, BQ x AP

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

  // keys past L repeat key L-1 (masked below)
  auto load_kv = [&](int stage, int k0) {
    for (int idx = tid; idx < BK * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const __nv_bfloat16* src =
          base + (int64_t)min(k0 + r, L - 1) * C3 + h * HD + c;
      cp_async16(saddr(&sK[(stage * BK + r) * KP + c]), src + n * HD);
      cp_async16(saddr(&sV[(stage * BK + r) * KP + c]), src + 2 * n * HD);
    }
    cp_commit();
  };

  const int nblk = (L + BK - 1) / BK;
  load_kv(0, 0);

  // extended queries [q*scale | rel | 0] and the output cotangent rows;
  // rows past L repeat row L-1 (not written)
  for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const int row = min(q0 + r, L - 1);
    uint4 raw = *reinterpret_cast<const uint4*>(
        base + (int64_t)row * C3 + h * HD + c);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(p[e]);
      p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(&sQ[r * QP + c]) = raw;
    *reinterpret_cast<uint4*>(&sDO[r * KP + c]) =
        *reinterpret_cast<const uint4*>(dbase + (int64_t)row * n * HD +
                                        h * HD + c);
  }
  load_rel_rows<QP>(sQ, rel, b, h, q0, L, n, R, tid);
  cp_commit();
  zero_pad<RP, QP>(sQ, BQ, R, tid);
  if constexpr (WS == 0) {
    for (int idx = tid; idx < BQ * AP; idx += NWARP * 32) sAcc[idx] = 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  // this warp's scaled q rows and output cotangent rows as A operands
  // (the rel part of the extended rows is read per key block, to keep
  // registers for the accumulators)
  uint32_t qa[HD / 16][4];
  uint32_t da[HD / 16][4];
  const int arow = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
  const int acol = (lane / 16) * 8;
  {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_x4(qa[ks], saddr(&sQ[arow * QP + ks * 16 + acol]));
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      ldsm_x4(da[ks], saddr(&sDO[arow * KP + ks * 16 + acol]));
  }
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = min(q0 + warp * 16 + g + 8 * r2, L - 1);
    const int64_t at = ((int64_t)b * n + h) * L + row;
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

    // s = qx . kx^T, as the forward computes it; then p = exp(s - lse),
    // zero for keys past L
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
    }
    // the bias columns: rel . onehot(key)^T, 16 rel columns at a time;
    // the grid row and column of key k0 + nt*8 + g (with WS = 0 divided
    // once per block)
    int hcv[WS ? 1 : BK / 8], wcv[WS ? 1 : BK / 8];
    if constexpr (WS == 0) {
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int key = min(k0 + nt * 8 + g, L - 1);
        hcv[nt] = key / gw;
        wcv[nt] = gh + key - hcv[nt] * gw;
      }
    }
#pragma unroll
    for (int ks = 0; ks < RP / 16; ++ks) {
      uint32_t ra[4];
      ldsm_x4(ra, saddr(&sQ[arow * QP + HD + ks * 16 + acol]));
      const int c = ks * 16 + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        const int hc = WS ? (k0 + nt * 8 + g) / WS : hcv[WS ? 0 : nt];
        const int wc = WS ? WS + (k0 + nt * 8 + g) % WS : wcv[WS ? 0 : nt];
        mma16816(s[nt], ra, onehot_pair(c, hc, wc),
                 onehot_pair(c + 8, hc, wc));
      }
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - lse_r[e / 2]);
        if (WS == 0 && k0 + nt * 8 + 2 * tig + (e & 1) >= L) s[nt][e] = 0.f;
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

    if constexpr (WS > 0) {
      // drel: key column k0 + nt*8 + 2*tig + e lies in grid row
      // k0/WS + nt*8/WS and grid column nt*8 % WS + 2*tig + e
      float hs[2][NH];
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2)
#pragma unroll
        for (int a = 0; a < NH; ++a) hs[r2][a] = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hs[e / 2][nt * 8 / WS] += s[nt][e];
          dw[e / 2][(nt * 8 % WS) / 8][e % 2] += s[nt][e];
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
          if (tig == 0) drow[k0 / WS + a] = __float2bfloat16(v);
        }
      }
    } else {
      // drel through shared memory: the warp's 16 x 64 fp32 ds, then lane
      // r sums row r's keys into drel_h and lane 16 + r into drel_w, in
      // key order, each (row, column) owned by one lane: deterministic
      float* dsw = sDS + warp * 16 * DSP;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsw[(g + 8 * (e / 2)) * DSP + nt * 8 + 2 * tig + (e & 1)] =
              s[nt][e];
      __syncwarp();
      const int r = lane % 16;
      const float* dr = dsw + r * DSP;
      float* acc = sAcc + (warp * 16 + r) * AP;
      const int kn = min(BK, L - k0);
      int hj = k0 / gw, wj = k0 - hj * gw;
      if (lane < 16) {
        float run = 0.f;
        for (int kk = 0; kk < kn; ++kk) {
          run += dr[kk];
          if (++wj == gw || kk == kn - 1) {
            acc[hj] += run;
            run = 0.f;
            if (wj == gw) {
              wj = 0;
              ++hj;
            }
          }
        }
      } else {
        for (int kk = 0; kk < kn; ++kk) {
          acc[gh + wj] += dr[kk];
          if (++wj == gw) wj = 0;
        }
      }
      __syncwarp();
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const int row = q0 + warp * 16 + g + 8 * r2;
    if (row >= L) continue;
    __nv_bfloat16* qrow = dqkv + ((int64_t)b * L + row) * C3 + h * HD;
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(&qrow[nt * 8 + 2 * tig]) =
          __floats2bfloat162_rn(dq[nt][2 * r2] * scale,
                                dq[nt][2 * r2 + 1] * scale);
    if constexpr (WS > 0) {
      __nv_bfloat16* drow = drel + (((int64_t)b * L + row) * n + h) * R + WS;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        *reinterpret_cast<__nv_bfloat162*>(&drow[w * 8 + 2 * tig]) =
            __floats2bfloat162_rn(dw[r2][w][0], dw[r2][w][1]);
    }
  }
  if constexpr (WS == 0) {
    for (int idx = lane; idx < 16 * R; idx += 32) {
      const int r = idx / R, c = idx - r * R;
      const int row = q0 + warp * 16 + r;
      if (row < L)
        drel[(((int64_t)b * L + row) * n + h) * R + c] =
            __float2bfloat16(sAcc[(warp * 16 + r) * AP + c]);
    }
  }
}

// dk and dv: one block per (64-key block, head, batch); the rel row padded
// to RP columns; WS > 0: a square WS x WS grid (L % 64 == 0), WS = 0 any
template <int RP, int WS>
__global__ void __launch_bounds__(NWARP * 32)
attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                    const __nv_bfloat16* __restrict__ rel,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dqkv, int L, int n, int gh_,
                    int gw_, float scale) {
  constexpr int QP = HD + RP + 8;
  const int gh = WS ? WS : gh_, gw = WS ? WS : gw_;
  const int R = gh + gw;
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

  // one query block: raw q, rel, do, lse and delta rows; rows past L
  // repeat row L-1 with lse = +inf and delta = 0, so their p and ds are 0
  auto load_q = [&](int stage, int q0) {
    __nv_bfloat16* Qs = sQ + stage * BQ * QP;
    __nv_bfloat16* DOs = sDO + stage * BQ * KP;
    for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      const int row = min(q0 + r, L - 1);
      cp_async16(saddr(&Qs[r * QP + c]),
                 base + (int64_t)row * C3 + h * HD + c);
      cp_async16(saddr(&DOs[r * KP + c]),
                 dbase + (int64_t)row * n * HD + h * HD + c);
    }
    load_rel_rows<QP>(Qs, rel, b, h, q0, L, n, R, tid);
    if (WS > 0 || (L % 4 == 0 && q0 + BQ <= L)) {
      if (tid < BQ / 4) {
        cp_async16(saddr(&sL[stage * BQ + tid * 4]),
                   lse + lbase + q0 + tid * 4);
      } else if (tid < BQ / 2) {
        const int t = tid - BQ / 4;
        cp_async16(saddr(&sD[stage * BQ + t * 4]), delta + lbase + q0 + t * 4);
      }
    } else if (tid < BQ) {
      const int row = q0 + tid;
      sL[stage * BQ + tid] = row < L ? lse[lbase + row] : INFINITY;
      sD[stage * BQ + tid] = row < L ? delta[lbase + row] : 0.f;
    }
    cp_commit();
  };

  for (int idx = tid; idx < BK * HD / 8; idx += NWARP * 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    const __nv_bfloat16* src =
        base + (int64_t)min(k0 + r, L - 1) * C3 + h * HD + c;
    cp_async16(saddr(&sK[r * KP + c]), src + n * HD);
    cp_async16(saddr(&sV[r * KP + c]), src + 2 * n * HD);
  }
  zero_pad<RP, QP>(sQ, 2 * BQ, R, tid);
  load_q(0, 0);  // one group with k and v
  cp_wait<0>();
  __syncthreads();

  // this warp's 16 keys as A operands: k, v (the one-hot columns are made
  // per product, to keep registers for the accumulators); keys past L
  // repeat key L-1, their dk and dv are not written
  uint32_t ka[HD / 16][4], va[HD / 16][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      ldsm_x4(ka[ks], saddr(&sK[row * KP + ks * 16 + col]));
      ldsm_x4(va[ks], saddr(&sV[row * KP + ks * 16 + col]));
    }
  }
  const int j0 = WS ? k0 + warp * 16 + g : min(k0 + warp * 16 + g, L - 1);
  const int j1 = WS ? j0 + 8 : min(k0 + warp * 16 + g + 8, L - 1);
  const int hc0 = j0 / gw, wc0 = gh + j0 - hc0 * gw;
  const int hc1 = j1 / gw, wc1 = gh + j1 - hc1 * gw;

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int nblk = (L + BQ - 1) / BQ;
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
    }
#pragma unroll
    for (int ks = 0; ks < RP / 16; ++ks) {
      const int c = ks * 16 + 2 * tig;
      const uint32_t oa[4] = {
          onehot_pair(c, hc0, wc0), onehot_pair(c, hc1, wc1),
          onehot_pair(c + 8, hc0, wc0), onehot_pair(c + 8, hc1, wc1)};
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt) {
        uint32_t bq[2];
        ldsm_x2(bq, saddr(&Qs[(nt * 8 + lane % 8) * QP + HD + ks * 16 +
                              ((lane / 8) & 1) * 8]));
        mma16816(s[nt], oa, bq[0], bq[1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = __expf(s[nt][e] - Ls[nt * 8 + 2 * tig + e % 2]);

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
    if (key >= L) continue;
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

template <int RP, int WS>
int launch(const void* qkv, const void* rel, const void* out32,
           const void* dout, const void* lse, void* delta, void* dqkv,
           void* drel, int B, int L, int n, int gh, int gw, float scale,
           cudaStream_t stream) {
  constexpr int QP = HD + RP + 8;
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* r = static_cast<const __nv_bfloat16*>(rel);
  const auto* o = static_cast<const float*>(out32);
  const auto* d = static_cast<const __nv_bfloat16*>(dout);
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  auto* dq = static_cast<__nv_bfloat16*>(dqkv);
  auto* dr = static_cast<__nv_bfloat16*>(drel);
  const unsigned nb = (unsigned)((L + BQ - 1) / BQ);

  const int64_t threads = (int64_t)B * L * n * 8;
  attn_bwd_delta_kernel<<<(unsigned)((threads + 255) / 256), 256, 0,
                          stream>>>(o, d, dl, B, L, n);
  int err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dq =
      ((size_t)BQ * QP + (size_t)BQ * KP + 4ull * BK * KP) * 2 +
      (WS ? 0 : (NWARP * 16ull * (BK + 1) + (size_t)BQ * (RP + 1)) * 4);
  err = (int)cudaFuncSetAttribute(attn_bwd_dq_kernel<RP, WS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dq);
  if (err) return err;
  attn_bwd_dq_kernel<RP, WS><<<dim3(nb, n, B), NWARP * 32, smem_dq, stream>>>(
      q, r, d, l, dl, dq, dr, L, n, gh, gw, scale);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t smem_dkv = (2ull * BK * KP + 2ull * BQ * QP +
                           2ull * BQ * KP) * 2 + 4ull * BQ * sizeof(float);
  err = (int)cudaFuncSetAttribute(attn_bwd_dkv_kernel<RP, WS>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dkv);
  if (err) return err;
  attn_bwd_dkv_kernel<RP, WS><<<dim3(nb, n, B), NWARP * 32, smem_dkv,
                                stream>>>(
      q, r, d, l, dl, dq, L, n, gh, gw, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// qkv (B, L, 3*n*64), rel (B, L, n, gh+gw) and dout (B, L, n*64), bf16;
// from the forward, out32 (B, L, n*64) and lse (B, n, L), f32; delta
// (B, n, L) f32 scratch; writes dqkv (B, L, 3*n*64) and drel
// (B, L, n, gh+gw), bf16. Any grid with L = gh * gw and gh + gw <= 128;
// squares of side 8, 16, 32 and 64 reduce the bias gradients in registers.
extern "C" int attn_bwd_bf16(const void* qkv, const void* rel,
                             const void* out32, const void* dout,
                             const void* lse, void* delta, void* dqkv,
                             void* drel, int B, int L, int n, int gh, int gw,
                             float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gh < 1 || gw < 1 || L != gh * gw || gh + gw > 128)
    return (int)cudaErrorInvalidValue;
#define ATTN_BWD(RP, WS)                                                    \
  return launch<RP, WS>(qkv, rel, out32, dout, lse, delta, dqkv, drel, B, L, \
                        n, gh, gw, scale, s)
#ifndef ATTN_BWD_GENERIC_ONLY  // defined only to time the generic path
  if (gh == gw) {
    switch (gw) {
      case 8: ATTN_BWD(16, 8);
      case 16: ATTN_BWD(32, 16);
      case 32: ATTN_BWD(64, 32);
      case 64: ATTN_BWD(128, 64);
      default: break;
    }
  }
#endif
  const int R = gh + gw;
  if (R <= 32) ATTN_BWD(32, 0);
  if (R <= 64) ATTN_BWD(64, 0);
  if (R <= 96) ATTN_BWD(96, 0);
  ATTN_BWD(128, 0);
#undef ATTN_BWD
}
