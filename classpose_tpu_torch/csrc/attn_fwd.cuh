// bf16 attention forward with the SAM decomposed relative-position bias,
// shared by the token-major kernel (attention.cu, kernel 1) and the
// head-major one (attention_hm.cu, kernel 8). A layout type says where a
// (batch, head, token) row of q, k, v, the output and the bias lives:
//   const __nv_bfloat16* row(int which, int b, int h, int r)  q/k/v: 0/1/2
//   const __nv_bfloat16* rel8(int b, int h, int r, int c)     8 bias values
//                                                             from column c
//   __nv_bfloat16* orow(int b, int h, int r)
//   float* lse / out32                                        or null
// and everything else is the same kernel:
//   out = softmax_j(q_i . k_j * scale + rel_h[i, j/W] + rel_w[i, j%W]) @ v.
//
// What bounds it on an H100: the two products. At the main path's shapes
// (L = 1024, hd = 64) each (batch, head) does 2*2*L^2*hd = 268 MFLOP
// against ~0.5 MB of operands, far above the card's ~295 FLOP/byte ridge,
// so it is compute-bound (989 TFLOP/s dense bf16).
//
// Design: one CTA of four warps per (64-query block, head, batch); each
// warp owns 16 query rows and loops over 64-key blocks with an online
// softmax (running max and sum in fp32), FlashAttention-2 style: both
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), the scores and the output accumulator stay in
// registers, and the probabilities feed the second product straight from
// the first product's accumulator layout. K/V blocks are double-buffered
// in shared memory with cp.async.
//
// The bias is folded into the first product the way the TPU kernel's
// production variant does (CLASSPOSE_ATTN_V2): the query row is extended
// to [q*scale | rel_h | rel_w] and the key row to [k | onehot(j/W) |
// onehot(j%W)], so one product of depth hd + H + W yields
// q.k*scale + rel_h[j/W] + rel_w[j%W] with no per-logit bias loads. The
// one-hot key columns are built in registers. hd = 64 makes scale = 1/8 a
// power of two, so q*scale is exact in bf16. wgmma and TMA are later work.
//
// For training the token-major kernel also writes, for the backward
// (attention_bwd.cu), each row's log-sum-exp m + log(l) (f32, (B, n, L)),
// from which it recomputes the normalized probabilities, and the output
// before its bf16 rounding (f32, (B, L, n*64)), from which it takes
// delta_i = do_i . o_i. A delta from the bf16 output would carry one
// rounding error, the same for every key of the row, into every ds_ij,
// and the bias gradients (partial sums of rows of ds that sum to zero)
// would lose most of their precision. With null pointers nothing else
// changes.
#pragma once

#include "mma.cuh"

namespace attn {

template <int R, class Layout>  // R = H + W, a multiple of 16
__global__ void __launch_bounds__(NWARP * 32)
attn_fwd_kernel(Layout lay, int L, int gh, int gw, float scale) {
  constexpr int KX = HD + R;       // extended product depth
  constexpr int QP = KX + 8;       // extended-query smem pitch (bf16)
  constexpr int NKS = KX / 16;     // k-steps of the first product
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // BQ x QP
  __nv_bfloat16* sK = sQ + BQ * QP;                             // 2 x BK x KP
  __nv_bfloat16* sV = sK + 2 * BK * KP;                         // 2 x BK x KP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;     // accumulator row group
  const int tig = lane & 3;    // thread in group

  auto load_kv = [&](int stage, int k0) {
    for (int idx = tid; idx < BK * HD / 8; idx += NWARP * 32) {
      const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
      cp_async16(saddr(&sK[(stage * BK + r) * KP + c]),
                 lay.row(1, b, h, k0 + r) + c);
      cp_async16(saddr(&sV[(stage * BK + r) * KP + c]),
                 lay.row(2, b, h, k0 + r) + c);
    }
    cp_commit();
  };

  const int nblk = L / BK;
  load_kv(0, 0);

  // extended queries [q*scale | rel] for this CTA's 64 rows
  for (int idx = tid; idx < BQ * HD / 8; idx += NWARP * 32) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8;
    uint4 raw = *reinterpret_cast<const uint4*>(lay.row(0, b, h, q0 + r) + c);
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&raw);
    for (int e = 0; e < 4; ++e) {
      float2 f = __bfloat1622float2(p[e]);
      p[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(&sQ[r * QP + c]) = raw;
  }
  for (int idx = tid; idx < BQ * R / 8; idx += NWARP * 32) {
    const int r = idx / (R / 8), c = (idx % (R / 8)) * 8;
    *reinterpret_cast<uint4*>(&sQ[r * QP + HD + c]) =
        *reinterpret_cast<const uint4*>(lay.rel8(b, h, q0 + r, c));
  }
  __syncthreads();

  uint32_t qa[NKS][4];
  {
    const int row = warp * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
    const int col = (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks)
      ldsm_x4(qa[ks], saddr(&sQ[row * QP + ks * 16 + col]));
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

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

    // S = [q*scale | rel] . [k | onehot_h | onehot_w]^T, 16 x 64 per warp
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
      const int hc = key / gw;
      const int wc = gh + key % gw;
#pragma unroll
      for (int ks = 0; ks < R / 16; ++ks) {
        const int c = ks * 16 + 2 * tig;
        mma16816(s[nt], qa[HD / 16 + ks], onehot_pair(c, hc, wc),
                 onehot_pair(c + 8, hc, wc));
      }
    }

    // online softmax: rows g (values 0, 1) and g + 8 (values 2, 3)
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
        mx = fmaxf(mx, fmaxf(s[nt][2 * r2], s[nt][2 * r2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[r2], mx);
      const float alpha = __expf(m_run[r2] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][2 * r2] = __expf(s[nt][2 * r2] - m_new);
        s[nt][2 * r2 + 1] = __expf(s[nt][2 * r2 + 1] - m_new);
        sum += s[nt][2 * r2] + s[nt][2 * r2 + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r2] = l_run[r2] * alpha + sum;
      m_run[r2] = m_new;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        o[nt][2 * r2] *= alpha;
        o[nt][2 * r2 + 1] *= alpha;
      }
    }

    // O += P V: the score accumulators of two key tiles form one A operand
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kt][0], s[2 * kt][1]),
          pack_bf16(s[2 * kt][2], s[2 * kt][3]),
          pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
          pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3])};
#pragma unroll
      for (int nt2 = 0; nt2 < HD / 16; ++nt2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, saddr(&Vs[(kt * 16 + lane % 8 + ((lane / 8) & 1) * 8) *
                                    KP + nt2 * 16 + (lane / 16) * 8]));
        mma16816(o[2 * nt2], pa, bv[0], bv[1]);
        mma16816(o[2 * nt2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled two blocks from now
  }

#pragma unroll
  for (int r2 = 0; r2 < 2; ++r2) {
    const float inv = 1.f / l_run[r2];
    const int row = q0 + warp * 16 + g + 8 * r2;
    __nv_bfloat16* orow = lay.orow(b, h, row);
#pragma unroll
    for (int nt = 0; nt < HD / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(&orow[nt * 8 + 2 * tig]) =
          __floats2bfloat162_rn(o[nt][2 * r2] * inv,
                                o[nt][2 * r2 + 1] * inv);
    if (lay.lse != nullptr && tig == 0)
      lay.lse[((int64_t)b * lay.n + h) * L + row] =
          m_run[r2] + logf(l_run[r2]);
    if (lay.out32 != nullptr) {
      float* frow = lay.out32 + ((int64_t)b * L + row) * lay.n * HD + h * HD;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<float2*>(&frow[nt * 8 + 2 * tig]) =
            make_float2(o[nt][2 * r2] * inv, o[nt][2 * r2 + 1] * inv);
    }
  }
}

// launch on a (L/64, n, B) grid; R = gh + gw in {16, 32, 64}
template <int R, class Layout>
int launch_fwd(const Layout& lay, int B, int L, int n, int gh, int gw,
               float scale, cudaStream_t stream) {
  const size_t smem = (size_t)BQ * (HD + R + 8) * 2 + 4ull * BK * KP * 2;
  cudaFuncSetAttribute(attn_fwd_kernel<R, Layout>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  dim3 grid(L / BQ, n, B);
  attn_fwd_kernel<R, Layout>
      <<<grid, NWARP * 32, smem, stream>>>(lay, L, gh, gw, scale);
  return (int)cudaGetLastError();
}

template <class Layout>
int dispatch_fwd(const Layout& lay, int B, int L, int n, int gh, int gw,
                 float scale, cudaStream_t stream) {
  switch (gh + gw) {
    case 16:
      return launch_fwd<16>(lay, B, L, n, gh, gw, scale, stream);
    case 32:
      return launch_fwd<32>(lay, B, L, n, gh, gw, scale, stream);
    case 64:
      return launch_fwd<64>(lay, B, L, n, gh, gw, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace attn
