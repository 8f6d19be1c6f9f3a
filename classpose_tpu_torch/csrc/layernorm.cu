// LayerNorm over the last axis of a bf16 tensor, fp32 statistics.
//
// Replaces classpose_tpu/nn/layernorm.py layernorm_pallas / _ln_kernel
// (pallas_call at layernorm.py:109): per row of C channels
//   mu  = sum(x) / C
//   var = max(0, sum(x^2) / C - mu^2)      (fast_var: the ViT blocks' norm1/2)
//       = sum((x - mu)^2) / C              (two-pass: the neck's LayerNorm2d)
//   y   = (x - mu) * rsqrt(var + eps) * scale + bias    in fp32, cast to bf16.
// The TPU kernel cut the rows into (R, C) VMEM blocks with R dividing the
// row count; here any row count is taken.
//
// What bounds it on an H100: memory. Per element it reads 2 B and writes
// 2 B and does ~6 fp32 operations, so at the main path's (25, 1024, 1024)
// the bound is 104.9 MB / 3.35 TB/s ~ 0.031 ms. Design: one warp per row,
// 16-byte loads (8 bf16) with neighbouring lanes on neighbouring chunks, so
// each row is read from HBM once in coalesced 512-byte sweeps; the row stays
// in registers (C <= 2048: at most 64 values a lane), so the two-pass
// variance reads nothing again; the sums are fp32 warp shuffles, with no
// shared memory and no synchronisation between warps; the affine is fp32
// and the result is packed to bf16 pairs and stored as 16-byte chunks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // rows per block of 256 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K: 16-byte chunks a lane holds (C / 8 chunks per row, 32 lanes)
template <int K, bool FAST>
__global__ void __launch_bounds__(WARPS * 32)
    layernorm_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ b,
                     __nv_bfloat16* __restrict__ y, int rows, int C,
                     float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nchunk = C >> 3;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * C);

  float v[K][8];
  float s = 0.f, ss = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunk) {
      const uint4 raw = xr[c];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        v[k][2 * i] = f.x;
        v[k][2 * i + 1] = f.y;
        s += f.x + f.y;
        if (FAST) ss += f.x * f.x + f.y * f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[k][i] = 0.f;
    }
  }
  const float mu = warp_sum(s) / (float)C;
  float var;
  if (FAST) {
    var = fmaxf(warp_sum(ss) / (float)C - mu * mu, 0.f);
  } else {
    float d2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < nchunk) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float d = v[k][i] - mu;
          d2 += d * d;
        }
      }
    }
    var = warp_sum(d2) / (float)C;
  }
  const float rs = rsqrtf(var + eps);

  const float4* w4 = reinterpret_cast<const float4*>(w);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  uint4* yr = reinterpret_cast<uint4*>(y + row * C);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = lane + 32 * k;
    if (c < nchunk) {
      const float4 wa = w4[2 * c], wb = w4[2 * c + 1];
      const float4 ba = b4[2 * c], bb = b4[2 * c + 1];
      const float ws[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float bs[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a0 = (v[k][2 * i] - mu) * rs * ws[2 * i] + bs[2 * i];
        const float a1 =
            (v[k][2 * i + 1] - mu) * rs * ws[2 * i + 1] + bs[2 * i + 1];
        o[i] = __floats2bfloat162_rn(a0, a1);
      }
      yr[c] = out;
    }
  }
}

template <int K>
void launch(const void* x, const void* w, const void* b, void* y, int rows,
            int C, float eps, bool fast_var, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + WARPS - 1) / WARPS);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* bp = static_cast<const float*>(b);
  auto* yp = static_cast<__nv_bfloat16*>(y);
  if (fast_var) {
    layernorm_kernel<K, true>
        <<<grid, WARPS * 32, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  } else {
    layernorm_kernel<K, false>
        <<<grid, WARPS * 32, 0, stream>>>(xp, wp, bp, yp, rows, C, eps);
  }
}

}  // namespace

// x, y: (rows, C) bf16, contiguous, 16-byte aligned; w, b: (C,) f32.
// Needs C % 128 == 0, C <= 2048 and rows >= 1.
extern "C" int layernorm_bf16(const void* x, const void* w, const void* b,
                              void* y, int rows, int C, float eps,
                              int fast_var, void* stream) {
  if (rows < 1 || C < 128 || C > 2048 || C % 128 != 0)
    return (int)cudaErrorInvalidValue;
  const int k = (C / 8 + 31) / 32;  // chunks a lane holds: 1 .. 8
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1) {
    launch<1>(x, w, b, y, rows, C, eps, fast_var != 0, s);
  } else if (k <= 2) {
    launch<2>(x, w, b, y, rows, C, eps, fast_var != 0, s);
  } else if (k <= 4) {
    launch<4>(x, w, b, y, rows, C, eps, fast_var != 0, s);
  } else {
    launch<8>(x, w, b, y, rows, C, eps, fast_var != 0, s);
  }
  return (int)cudaGetLastError();
}
