// Bilinear sampler and landing-position histogram for the flow dynamics.
//
// bilinear_sample_f32 replaces classpose_tpu/ops/sample_pallas.py
// shift_sample_pallas / _sample_kernel (pallas_call at sample_pallas.py:297):
// sample a (B, C, H, W) f32 field at float positions (py, px) with
// y0 = clip(floor(py), 0, H-2), x0 = clip(floor(px), 0, W-2) and the TPU
// kernel's factored two-level lerp order
//   g_r = (1-wx)*F[r, x0] + wx*F[r, x0+1]   for r in {y0, y0+1}
//   out = (1-wy)*g_y0 + wy*g_y0+1.
// The TPU kernel needed a displacement bound and measured per-stripe
// offset ranges only to size its one-hot loops over VMEM stripes; a
// direct gather has neither.
//
// landing_histogram_f32 replaces sample_pallas.py scatter_count_pallas /
// _count_kernel (pallas_call at sample_pallas.py:496):
//   out[b, fy, fx] += cell  for every source pixel.
// Counts are small integers in f32, so the atomic sum is exact in any order.
//
// What bounds them on an H100: memory. The sampler moves ~24 B per output
// pixel at C=2 (positions in, two channels out, a 2x2 footprint that the
// caches serve once for neighbouring threads); the histogram reads 12 B
// per source pixel. Design: one thread per output (resp. source) pixel
// with neighbouring threads on neighbouring addresses, so the position
// reads and output writes coalesce and the footprint gathers hit L1/L2.
//
// Built with -fmad=false and written with explicit round-to-nearest
// intrinsics, so no multiply-add is contracted and the result equals the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void bilinear_sample_kernel(const float* __restrict__ u,
                                       const float* __restrict__ py,
                                       const float* __restrict__ px,
                                       float* __restrict__ out, int B,
                                       int C, int H, int W) {
  const int64_t HW = (int64_t)H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * HW) return;
  const int64_t b = idx / HW;
  const int64_t q = idx % HW;
  const float yv = py[idx];
  const float xv = px[idx];
  const float yf = fminf(fmaxf(floorf(yv), 0.f), (float)(H - 2));
  const float xf = fminf(fmaxf(floorf(xv), 0.f), (float)(W - 2));
  const int y0 = (int)yf;
  const int x0 = (int)xf;
  const float wy = __fsub_rn(yv, (float)y0);
  const float wx = __fsub_rn(xv, (float)x0);
  const float owy = __fsub_rn(1.f, wy);
  const float owx = __fsub_rn(1.f, wx);
  const int64_t o0 = (int64_t)y0 * W + x0;
  for (int c = 0; c < C; ++c) {
    const float* f = u + (b * C + c) * HW;
    const float g0 = __fadd_rn(__fmul_rn(owx, f[o0]), __fmul_rn(wx, f[o0 + 1]));
    const float g1 =
        __fadd_rn(__fmul_rn(owx, f[o0 + W]), __fmul_rn(wx, f[o0 + W + 1]));
    out[(b * C + c) * HW + q] = __fadd_rn(__fmul_rn(owy, g0), __fmul_rn(wy, g1));
  }
}

__global__ void landing_histogram_kernel(const int* __restrict__ fy,
                                         const int* __restrict__ fx,
                                         const float* __restrict__ cell,
                                         float* __restrict__ out, int B,
                                         int H, int W) {
  const int64_t HW = (int64_t)H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * HW) return;
  const float c = cell[idx];
  if (c == 0.f) return;  // adding zero changes no bin
  const int64_t b = idx / HW;
  atomicAdd(&out[b * HW + (int64_t)fy[idx] * W + fx[idx]], c);
}

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int bilinear_sample_f32(const void* u, const void* py,
                                   const void* px, void* out, int B, int C,
                                   int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  bilinear_sample_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<float*>(out), B, C, H, W);
  return (int)cudaGetLastError();
}

extern "C" int landing_histogram_f32(const void* fy, const void* fx,
                                     const void* cell, void* out, int B,
                                     int H, int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  cudaMemsetAsync(out, 0, n * sizeof(float), (cudaStream_t)stream);
  landing_histogram_kernel<<<blocks_for(n), THREADS, 0,
                             (cudaStream_t)stream>>>(
      static_cast<const int*>(fy), static_cast<const int*>(fx),
      static_cast<const float*>(cell), static_cast<float*>(out), B, H, W);
  return (int)cudaGetLastError();
}
