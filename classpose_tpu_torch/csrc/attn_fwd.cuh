// bf16 attention forward with the SAM decomposed relative-position bias,
// for Hopper (sm_90a), shared by the token-major kernel (attention.cu,
// kernel 1) and the head-major one (attention_hm.cu, kernel 8's bf16
// variant):
//   out = softmax_j(q_i . k_j * scale + rel_h[i, j/W] + rel_w[i, j%W]) @ v,
// bf16 in and out, fp32 accumulation. A layout type says where the bias
// rows and the output of a (batch, head, token) live and how the three
// TMA maps of q, k and v are addressed:
//   int tma_x(int which, int h), tma_z(int b, int h)   box coordinates
//   const __nv_bfloat16* rh_row(b, h, r), rw_row(b, h, r)
//   __nv_bfloat16* orow(b, h, r)
//   float* lse / out32                                 or null
//
// What bounds it on an H100: operations. At the main path's shapes
// (L = 1024, hd = 64) each (batch, head) does 2*2*L^2*hd = 268 MFLOP
// against ~0.5 MB of operands, far above the card's ~295 FLOP/byte ridge.
// Two units share the bound: the tensor cores (989 TFLOP/s dense bf16,
// 256 FLOP per logit at hd = 64) and the special-function units that
// take the exponentials (16 per clock per SM, about the same time per
// logit). So the products run on wgmma and the softmax of one key block
// runs while the tensor cores work on another.
//
// Design (FlashAttention-3's forward). Persistent CTAs, one per SM (or
// one per tile if there are fewer), each of three warpgroups, walk the
// (128-query block, head, batch) tiles, query block fastest so the CTAs
// working at once share their heads' k and v in L2:
//   - warpgroup 0 is the producer: it gives up its registers (setmaxnreg)
//     and one thread issues TMA loads: each tile's q block into one of two
//     buffers, then the k and v blocks of 128 keys into a ring of STAGES
//     stages that runs on across tiles, each with a "full" mbarrier
//     (bytes arrived) and an "empty" one (all consumer warps done with
//     it). TMA writes the tiles with the 128-byte swizzle that wgmma reads
//     without bank conflicts;
//   - warpgroups 1 and 2 are consumers of 64 query rows each. Per key
//     block: S = q . k^T by wgmma m64n128k16 with both operands in shared
//     memory; the logits in the exp2 domain
//       t = s * scale*log2(e) + (rel_h[i, j/W] + rel_w[i, j%W]) * log2(e)
//     with the bias added per logit in fp32 (never folded into the
//     product: that would add a third to the tensor-core work); an online
//     softmax (running max and sum in fp32); then O += P . v by wgmma
//     m64n64k16 with P straight from the S accumulator's registers
//     (its layout is the A fragment's) and v read MN-major from shared
//     memory (the transpose flag). Each warp prefetches the next tile's
//     bias rows with cp.async while it works on the current one.
//   - Overlap: block k's S product is issued before block k-1's P . v,
//     and the softmax of block k runs while P . v is still on the tensor
//     cores; on top of that the two consumer warpgroups take turns at
//     issuing their products (ping-pong on two named barriers), so one
//     warpgroup's exponentials run while the other's products do.
// The bias: a thread's accumulator covers two query rows and, in each
// 8-key tile, two keys 2*(lane%4) + {0, 1}. Every grid with H + W <= 256
// (MAX_REL) is taken (any L, any W); two instantiations:
//   - W in {8, 16, 32} with H a multiple of 8 and H + W <= 64 (every square
//     crop grid up to 32 x 32, bsize 256 at patch 8): a tile has one j/W
//     and eight consecutive j%W, the W-columns a thread ever touches
//     (W/8 * 2 per row) sit in registers for the whole sweep and rel_h is
//     read from fp32 shared memory once per W keys;
//   - any other grid (28 x 28, 64 x 64, 128 x 128, 12 x 20, 2 x 254, ...):
//     each logit reads its two terms, at j/W and H + j%W, from the bf16
//     rows the warp staged, the two offsets of a thread's keys stepped by
//     8 keys a tile from one division per key block (no per-key table, so
//     shared memory does not grow with L). A warp's 16 rows of H + W bf16
//     are staged at the start of each tile into one buffer (199,808
//     bytes of shared memory at H + W = 256): measured at 28 x 28 and
//     64 x 64, double-buffering them (the next tile's prefetched, which
//     fits up to H + W = 184) was no faster (ab_attention.py --grids).
// The register bodies double-buffer their bias rows. Bias rows are
// copied by 16-byte cp.async where their pitch allows it, else by plain
// loads. Rows past L are computed on TMA's zero fill
// (with row L-1's bias) and not written; keys past L (L % 128 != 0) are
// masked to -inf.
//
// For training the token-major kernel also writes, for the backward
// (attention_bwd.cu), each row's natural-log log-sum-exp
// (m + log2(l)) * ln(2) (f32, (B, n, L)) and the output before its bf16
// rounding (f32, (B, L, n*64)). With null pointers nothing else changes.
#pragma once

#include <algorithm>

#include "sm90.cuh"

namespace attn {
namespace fwd {

constexpr int HD = 64;        // head dim (asserted by the wrappers)
constexpr int MAX_REL = 256;  // the largest H + W (nn/attention.py MAX_REL)
constexpr int BQ = 128;       // query rows per CTA
constexpr int BK = 128;       // keys per block
constexpr int STAGES = 3;     // k/v ring depth
constexpr int THREADS = 384;  // producer warpgroup + two consumers
constexpr int CWARPS = 8;     // consumer warps
constexpr int NT = BK / 8;    // 8-key tiles of a block
constexpr uint32_t Q_BYTES = BQ * HD * 2;
constexpr uint32_t TILE_BYTES = BK * HD * 2;
constexpr int OFF_K = 2 * Q_BYTES;  // q is double-buffered
constexpr int OFF_V = OFF_K + STAGES * TILE_BYTES;
constexpr int OFF_BAR = OFF_V + STAGES * TILE_BYTES;
constexpr int OFF_BIAS = OFF_BAR + 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
static_assert(BQ == BK, "q and k/v share one TMA box");
static_assert((4 + 3 * STAGES) * 8 <= 128, "barriers fit their slot");

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// pitch (bf16) of a staged bias row: gh + gw; with WS = 0, whose logits
// read the rows in place, gh + gw rounded up to 8 mod 16, so the 8 rows a
// warp reads at once start on 8 different groups of 4 banks
__host__ __device__ inline int stage_pitch(int ws, int gh, int gw) {
  const int r8 = (gh + gw + 7) / 8 * 8;
  return ws ? gh + gw : r8 % 16 ? r8 : r8 + 8;
}

// per consumer warp: with WS > 0 its 16 bias rows in fp32 (pitches
// gh + 1, gw + 1) and two bf16 staging buffers of 16 rows (the next
// tile's rows are prefetched into the other one); with WS = 0 one staging
// buffer, whose rows the logits read in place
__host__ __device__ inline int bias_buffers(int ws) { return ws ? 2 : 1; }
__host__ __device__ inline int warp_bias_bytes(int ws, int gh, int gw) {
  return (ws ? 16 * (gh + gw + 2) * 4 : 0) +
         bias_buffers(ws) * 16 * stage_pitch(ws, gh, gw) * 2;
}

// bytes of dynamic shared memory: 1 KB of alignment slack, two q buffers,
// the k/v ring, the barriers and the consumer warps' bias rows
inline size_t smem_bytes(int ws, int gh, int gw) {
  return 1024 + OFF_BIAS + (size_t)CWARPS * warp_bias_bytes(ws, gh, gw);
}

// the largest dynamic shared memory a block may have (sm_90)
constexpr size_t SMEM_MAX = 232448;

// the logits of a 64 x BK block, in place: t = s * sl + bias * log2(e),
// keys past L masked to -inf. With WS > 0: rh is this thread's warp's 16
// fp32 bias rows of rel_h (pitch gh + 1), pre-scaled, and rwr the rel_w
// columns this thread touches. With WS = 0: stg is the warp's 16 raw bf16
// bias rows (pitch stage_pitch); d8h and d8w are 8 / gw and 8 % gw.
template <int WS>
__device__ __forceinline__ void logits(float (&s)[4 * NT], int k0, int L,
                                       float sl, const float* rh,
                                       const __nv_bfloat16* stg, int gh,
                                       int gw, int d8h, int d8w,
                                       const float (&rwr)[2][WS ? WS / 8 : 1]
                                                          [2],
                                       int g8, int q4) {
  if constexpr (WS > 0) {
    constexpr int U = WS / 8;  // 8-key tiles per grid row
    const int hb = k0 / WS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* rhi = rh + (g8 + 8 * i) * (gh + 1);
      float rhv = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (t % U == 0) rhv = rhi[min(hb + t / U, gh - 1)];
        s[4 * t + 2 * i] = fmaf(s[4 * t + 2 * i], sl, rhv + rwr[i][t % U][0]);
        s[4 * t + 2 * i + 1] =
            fmaf(s[4 * t + 2 * i + 1], sl, rhv + rwr[i][t % U][1]);
      }
    }
  } else {
    const int RS = stage_pitch(WS, gh, gw);
    // keys k0 + 8t + 2*q4 + {0, 1}: grid row and column of the first, from
    // one division here and a step of 8 keys a tile (rows past the grid,
    // keys past L, are clamped: they are masked below)
    int ha = (k0 + 2 * q4) / gw;
    int wa = k0 + 2 * q4 - ha * gw;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const bool wrap = wa + 1 == gw;
      const int h0 = min(ha, gh - 1), w0 = gh + wa;
      const int h1 = min(ha + wrap, gh - 1), w1 = wrap ? gh : w0 + 1;
      wa += d8w;
      ha += d8h;
      if (wa >= gw) {
        wa -= gw;
        ++ha;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const __nv_bfloat16* br = stg + (g8 + 8 * i) * RS;
        const float b0 = __bfloat162float(br[h0]) + __bfloat162float(br[w0]);
        const float b1 = __bfloat162float(br[h1]) + __bfloat162float(br[w1]);
        s[4 * t + 2 * i] = fmaf(s[4 * t + 2 * i], sl, b0 * LOG2E);
        s[4 * t + 2 * i + 1] = fmaf(s[4 * t + 2 * i + 1], sl, b1 * LOG2E);
      }
    }
  }
  if (k0 + BK > L) {
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * t + 2 * q4 + (e & 1) >= L) s[4 * t + e] = -INFINITY;
  }
}

template <int WS, class Layout>
__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv, const Layout lay,
                int B, int L, int gh, int gw, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + OFF_K);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + OFF_V);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // [2]
  uint64_t* q_empty = q_full + 2;                                   // [2]
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  float* bias = reinterpret_cast<float*>(smem + OFF_BIAS);

  const int n = lay.n;
  const int nqb = (L + BQ - 1) / BQ;
  const int ntiles = nqb * n * B;
  const int nblk = (L + BK - 1) / BK;
  // the warp index through a shuffle: provably uniform across the warp,
  // so ptxas sees no divergence in the role and turn branches
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int R = gh + gw;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      sm90::mbar_init(&q_full[i], 1);
      sm90::mbar_init(&q_empty[i], CWARPS);
    }
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], CWARPS);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // tiles (query block, head, batch), query block fastest: the CTAs
  // working at once share their heads' k and v in L2
  if (warp < 4) {
    // ---------------------------------------------------------- producer
    sm90::regs_dec<40>();
    if (warp == 0 && lane == 0) {
      int it = 0;  // k/v blocks issued, over all tiles: the ring position
      for (int tile = blockIdx.x, tc = 0; tile < ntiles;
           tile += gridDim.x, ++tc) {
        const int h = (tile / nqb) % n, b = tile / (nqb * n);
        const int z = lay.tma_z(b, h);
        const int qi = tc & 1;
        sm90::mbar_wait(&q_empty[qi], ((tc >> 1) & 1) ^ 1);
        sm90::mbar_expect_tx(&q_full[qi], Q_BYTES);
        sm90::tma_load_3d(sQ + qi * BQ * HD, &tmq, &q_full[qi],
                          lay.tma_x(0, h), (tile % nqb) * BQ, z);
        for (int kb = 0; kb < nblk; ++kb, ++it) {
          const int s = it % STAGES;
          sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          sm90::mbar_expect_tx(&k_full[s], TILE_BYTES);
          sm90::tma_load_3d(sK + s * BK * HD, &tmk, &k_full[s],
                            lay.tma_x(1, h), kb * BK, z);
          sm90::mbar_expect_tx(&v_full[s], TILE_BYTES);
          sm90::tma_load_3d(sV + s * BK * HD, &tmv, &v_full[s],
                            lay.tma_x(2, h), kb * BK, z);
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    sm90::regs_inc<232>();
    const int cw = warp - 4;  // consumer warp 0..7
    const int wg = cw / 4;    // consumer warpgroup 0..1: rows 64*wg..
    const int g8 = lane / 4, q4 = lane % 4;
    // this warp's 16 fp32 rows (WS > 0) and its staging buffers
    float* rh = reinterpret_cast<float*>(
        reinterpret_cast<unsigned char*>(bias) +
        cw * warp_bias_bytes(WS, gh, gw));
    float* rw = rh + 16 * (gh + 1);
    __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
        WS ? rw + 16 * (gw + 1) : rh);
    const int d8h = 8 / gw, d8w = 8 - d8h * gw;
    const int RS = stage_pitch(WS, gh, gw);
    const bool vec = lay.bias_vec16();
    // prefetch the raw bias rows of this warp for `tile` into staging
    // buffer `buf` (16-byte copies where the rows' pitch allows, else plain
    // loads; rows past L repeat row L-1)
    auto prefetch_bias = [&](int tile, int buf) {
      if (tile < ntiles) {
        const int h = (tile / nqb) % n, b = tile / (nqb * n);
        const int wrow = (tile % nqb) * BQ + wg * 64 + (cw % 4) * 16;
        __nv_bfloat16* dst = stage + buf * 16 * RS;
        if (vec) {
          for (int idx = lane; idx < 16 * (R / 8); idx += 32) {
            const int r = idx / (R / 8), c = (idx - r * (R / 8)) * 8;
            const int row = min(wrow + r, L - 1);
            sm90::cp_async16(dst + r * RS + c,
                             c < gh ? lay.rh_row(b, h, row) + c
                                    : lay.rw_row(b, h, row) + (c - gh));
          }
        } else {
          for (int idx = lane; idx < 16 * R; idx += 32) {
            const int r = idx / R, c = idx - r * R;
            const int row = min(wrow + r, L - 1);
            dst[r * RS + c] = c < gh ? lay.rh_row(b, h, row)[c]
                                     : lay.rw_row(b, h, row)[c - gh];
          }
        }
      }
      sm90::cp_async_commit();
    };
    const float sl = scale * LOG2E;
    float s[4 * NT];
    float o[HD / 2];
    uint32_t p[BK / 16][4];
    float rwr[2][WS ? WS / 8 : 1][2];
    float m[2], l[2];
#pragma unroll
    for (int e = 0; e < 4 * NT; ++e) s[e] = 0.f;

    // S = q . k^T for the block in stage st (16 columns = 32 B per step)
    auto issue_s = [&](uint64_t dq, int st) {
      const uint64_t dk = sm90::desc_sw128(sK + st * BK * HD);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss_n128(s, dq + 2 * kk, dk + 2 * kk, kk);
      sm90::wg_commit();
    };
    // O += P . v for the block in stage st (16 keys = 2 KB per step)
    auto issue_pv = [&](int st) {
      const uint64_t dv = sm90::desc_sw128(sV + st * BK * HD);
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        sm90::wgmma_rs_n64_t(o, p[kt], dv + kt * (16 * HD * 2 >> 4));
      sm90::wg_commit();
    };
    // online softmax of block kb's logits in s → p in s, returns the
    // rescale factors of the running output
    const __nv_bfloat16* stg = stage;  // this tile's raw rows (WS = 0)
    auto softmax = [&](int kb, float (&alpha)[2]) {
      logits<WS>(s, kb * BK, L, sl, rh, stg, gh, gw, d8h, d8w, rwr, g8, q4);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = m[i];
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mx = fmaxf(mx, fmaxf(s[4 * t + 2 * i], s[4 * t + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[i] = ex2(m[i] - mx);
        m[i] = mx;
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          s[4 * t + 2 * i] = ex2(s[4 * t + 2 * i] - mx);
          s[4 * t + 2 * i + 1] = ex2(s[4 * t + 2 * i + 1] - mx);
          sum += s[4 * t + 2 * i] + s[4 * t + 2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + sum;  // this thread's columns only
      }
    };
    // two 8-key tiles of S form one 16-key A fragment of P
    auto pack_p = [&]() {
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt) {
        p[kt][0] = pack_bf16(s[8 * kt], s[8 * kt + 1]);
        p[kt][1] = pack_bf16(s[8 * kt + 2], s[8 * kt + 3]);
        p[kt][2] = pack_bf16(s[8 * kt + 4], s[8 * kt + 5]);
        p[kt][3] = pack_bf16(s[8 * kt + 6], s[8 * kt + 7]);
      }
      sm90::reg_fence(p);
    };

    // the two consumer warpgroups take turns at issuing their products
    // (named barriers 1 and 2), so one's softmax runs while the other's
    // products are on the tensor cores; warpgroup 0 goes first
    auto my_turn = [&]() { sm90::bar_sync(1 + wg, 256); };
    auto pass_turn = [&]() { sm90::bar_arrive(2 - wg, 256); };
    if (wg == 1) pass_turn();

    int it = 0;  // k/v blocks consumed, over all tiles
    if constexpr (WS > 0) prefetch_bias(blockIdx.x, 0);
    for (int tile = blockIdx.x, tc = 0; tile < ntiles;
         tile += gridDim.x, ++tc) {
      const int h = (tile / nqb) % n, b = tile / (nqb * n);
      const int wrow = (tile % nqb) * BQ + wg * 64 + (cw % 4) * 16;

      // this warp's 16 bias rows, log2(e)-scaled, from the staging buffer
      // prefetched during the previous tile (WS > 0; then the next tile's)
      // or staged now, once the warp is done with the previous tile's
      if constexpr (WS == 0) {
        __syncwarp();
        prefetch_bias(tile, 0);
      }
      sm90::cp_async_wait<0>();
      __syncwarp();
      const __nv_bfloat16* src = stage + (WS > 0 ? tc & 1 : 0) * 16 * RS;
      if constexpr (WS == 0) {
        stg = src;  // read in place by the logits
        rwr[0][0][0] = rwr[0][0][1] = rwr[1][0][0] = rwr[1][0][1] = 0.f;
      } else {
        for (int idx = lane; idx < 16 * gh; idx += 32) {
          const int r = idx / gh, c = idx - r * gh;
          rh[r * (gh + 1) + c] = __bfloat162float(src[r * R + c]) * LOG2E;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int u = 0; u < WS / 8; ++u) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    src + (g8 + 8 * i) * R + gh + 8 * u + 2 * q4));
            rwr[i][u][0] = f.x * LOG2E;
            rwr[i][u][1] = f.y * LOG2E;
          }
        }
      }
      __syncwarp();
      if constexpr (WS > 0) prefetch_bias(tile + gridDim.x, (tc + 1) & 1);
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;

      const int qi = tc & 1;
      const uint64_t dq = sm90::desc_sw128(sQ + (qi * BQ + wg * 64) * HD);
      sm90::mbar_wait(&q_full[qi], (tc >> 1) & 1);

      // block 0: nothing of this tile is in flight yet
      int st = it % STAGES;
      sm90::mbar_wait(&k_full[st], (it / STAGES) & 1);
      sm90::reg_fence(s);
      my_turn();
      sm90::wg_fence();
      issue_s(dq, st);
      pass_turn();
      sm90::wg_wait<0>();
      sm90::reg_fence(s);
      {
        float alpha[2];
        softmax(0, alpha);
      }
      pack_p();

      // block kb's S runs before block kb-1's P . v; kb's softmax overlaps
      // the latter
      for (int kb = 1; kb < nblk; ++kb) {
        const int prev = st;
        const int prev_it = it++;
        st = it % STAGES;
        sm90::mbar_wait(&k_full[st], (it / STAGES) & 1);
        sm90::reg_fence(s);
        sm90::reg_fence(o);
        my_turn();
        sm90::wg_fence();
        issue_s(dq, st);
        sm90::mbar_wait(&v_full[prev], (prev_it / STAGES) & 1);
        issue_pv(prev);
        pass_turn();
        sm90::wg_wait<1>();
        sm90::reg_fence(s);
        float alpha[2];
        softmax(kb, alpha);
        sm90::wg_wait<0>();
        sm90::reg_fence(o);
        if (lane == 0) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
        for (int t = 0; t < HD / 8; ++t) {
          o[4 * t] *= alpha[0];
          o[4 * t + 1] *= alpha[0];
          o[4 * t + 2] *= alpha[1];
          o[4 * t + 3] *= alpha[1];
        }
        pack_p();
      }
      sm90::mbar_wait(&v_full[st], (it / STAGES) & 1);
      sm90::reg_fence(o);
      my_turn();
      sm90::wg_fence();
      issue_pv(st);
      pass_turn();
      sm90::wg_wait<0>();
      sm90::reg_fence(o);
      if (lane == 0) {
        sm90::mbar_arrive(&empty[st]);
        sm90::mbar_arrive(&q_empty[qi]);
      }
      ++it;

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float lt = l[i];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        const float inv = 1.f / lt;
        const int row = wrow + g8 + 8 * i;
        if (row >= L) continue;
        __nv_bfloat16* orow = lay.orow(b, h, row);
#pragma unroll
        for (int t = 0; t < HD / 8; ++t)
          *reinterpret_cast<__nv_bfloat162*>(&orow[8 * t + 2 * q4]) =
              __floats2bfloat162_rn(o[4 * t + 2 * i] * inv,
                                    o[4 * t + 2 * i + 1] * inv);
        if (lay.lse != nullptr && q4 == 0)
          lay.lse[((int64_t)b * n + h) * L + row] = (m[i] + log2f(lt)) * LN2;
        if (lay.out32 != nullptr) {
          float* frow = lay.out32 + ((int64_t)b * L + row) * n * HD + h * HD;
#pragma unroll
          for (int t = 0; t < HD / 8; ++t)
            *reinterpret_cast<float2*>(&frow[8 * t + 2 * q4]) = make_float2(
                o[4 * t + 2 * i] * inv, o[4 * t + 2 * i + 1] * inv);
        }
      }
    }
  }
}

template <int WS, class Layout>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Layout& lay, int B, int L, int n,
           int gh, int gw, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(WS, gh, gw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<WS, Layout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long tiles = (long)((L + BQ - 1) / BQ) * n * B;
  attn_fwd_kernel<WS, Layout>
      <<<(unsigned)std::min<long>(tiles, sms), THREADS, smem, stream>>>(
          tq, tk, tv, lay, B, L, gh, gw, scale);
  return (int)cudaGetLastError();
}

// one persistent CTA per SM (or per tile, if fewer) walks the
// (ceil(L/128), n, B) tiles; every grid with gh * gw = L and
// gh + gw <= MAX_REL (the wrappers' _grid_supported)
template <class Layout>
int dispatch(const CUtensorMap& tq, const CUtensorMap& tk,
             const CUtensorMap& tv, const Layout& lay, int B, int L, int n,
             int gh, int gw, float scale, cudaStream_t stream) {
  if (gh < 1 || gw < 1 || gh * gw != L || gh + gw > MAX_REL)
    return (int)cudaErrorInvalidValue;
  if (gh % 8 == 0 && gh + gw <= 64) {
    switch (gw) {
      case 8:
        return launch<8>(tq, tk, tv, lay, B, L, n, gh, gw, scale, stream);
      case 16:
        return launch<16>(tq, tk, tv, lay, B, L, n, gh, gw, scale,
                             stream);
      case 32:
        return launch<32>(tq, tk, tv, lay, B, L, n, gh, gw, scale,
                             stream);
      default:
        break;
    }
  }
  return launch<0>(tq, tk, tv, lay, B, L, n, gh, gw, scale, stream);
}

}  // namespace fwd
}  // namespace attn
