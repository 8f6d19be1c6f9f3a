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
//
// What bounds them on an H100: memory. The sampler moves ~24 B per output
// pixel at C=2 (positions in, two channels out, a 2x2 footprint that the
// caches serve once for neighbouring threads); the histogram reads 12 B
// per source pixel and writes 4 B per bin. On the masks path the
// histogram's input is not uniform: after the flow steps the ~500
// foreground pixels of a cell land on one to a few bins, and one global
// atomic per pixel serializes there in L2.
//
// Sampler design: a 2-D grid (x tiles, row tiles, batch), so a block covers
// a square of 16 rows x 64 columns and the gathers of its footprint (the
// square grown by the displacement) stay in L1, which cuts the L2 traffic
// of scattered 32-byte sectors (rows of 4 x 256 columns re-fetched far
// more of them). Each thread takes 4 x-adjacent pixels: float4 reads of
// py and px and one float4 store per channel when W % 4 == 0 (a scalar
// loop covers other W and the row's tail); in-plane offsets are 32-bit
// and the 64-bit image base is formed once; the field is read through
// the read-only path (__ldg).
//
// Histogram design: the output is zeroed, then one thread takes one
// source pixel, neighbouring threads neighbouring pixels, so the reads
// coalesce and a warp's adds go to bins near one another; the grid's y
// is the image, so no thread divides to find it. Where every cell of a
// warp is 0 or 1 (the masks path's foreground), neighbouring lanes whose
// pixels land on one bin form a run (run heads from a ballot), and only
// the last lane of each run adds, the run's length, with one global
// atomic; otherwise each lane adds its cell. On the masks path a row of
// a cell's pixels lands on one bin, so a warp adds about once per cell
// it crosses where one atomic per pixel queued ~500 deep on each bin;
// where pixels scatter it adds once per pixel as before (2 to 16 pixels
// a thread merged more on the masks path but lost 3-15% where pixels
// scatter, on an H100 80GB HBM3 at 700 W). Exactness: the masks path's
// cells are 0 or 1, and a bin's total is at most the pixels of its image
// (2^20 for a 1024^2 tile), below 2^24, so every partial sum is an
// exactly representable integer in f32 and the order of the adds cannot
// change the result; the plain version sums the same integers.
//
// Built with -fmad=false and written with explicit round-to-nearest
// intrinsics, so no multiply-add is contracted and the result equals the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// where one output pixel reads: the in-plane offset of its footprint's
// top-left corner and the lerp weights
struct Tap {
  int o0;
  float wy, wx, owy, owx;
};

__device__ __forceinline__ Tap tap(float yv, float xv, int H, int W) {
  const float yf = fminf(fmaxf(floorf(yv), 0.f), (float)(H - 2));
  const float xf = fminf(fmaxf(floorf(xv), 0.f), (float)(W - 2));
  const int y0 = (int)yf;
  const int x0 = (int)xf;
  const float wy = __fsub_rn(yv, (float)y0);
  const float wx = __fsub_rn(xv, (float)x0);
  return Tap{y0 * W + x0, wy, wx, __fsub_rn(1.f, wy), __fsub_rn(1.f, wx)};
}

// one channel plane f at a tap: the TPU kernel's factored order with
// explicit round-to-nearest operations
__device__ __forceinline__ float lerp2(const float* __restrict__ f,
                                      const Tap& t, int W) {
  const float g0 = __fadd_rn(__fmul_rn(t.owx, __ldg(f + t.o0)),
                             __fmul_rn(t.wx, __ldg(f + t.o0 + 1)));
  const float g1 = __fadd_rn(__fmul_rn(t.owx, __ldg(f + t.o0 + W)),
                             __fmul_rn(t.wx, __ldg(f + t.o0 + W + 1)));
  return __fadd_rn(__fmul_rn(t.owy, g0), __fmul_rn(t.wy, g1));
}

constexpr int SX = 16;  // threads per block along x: 64 columns
constexpr int SY = 16;  // rows per block

// grid (ceil(W / 64), ceil(H / 16), B); vec: W % 4 == 0 and 16-byte
// aligned positions and output, for float4 accesses
__global__ void __launch_bounds__(SX * SY)
bilinear_sample_kernel(const float* __restrict__ u,
                       const float* __restrict__ py,
                       const float* __restrict__ px, float* __restrict__ out,
                       int C, int H, int W, bool vec) {
  const int y = blockIdx.y * SY + threadIdx.y;
  const int x = (blockIdx.x * SX + threadIdx.x) * 4;
  if (y >= H || x >= W) return;
  const int HW = H * W;
  const int q = y * W + x;
  const int64_t plane = (int64_t)blockIdx.z * HW;  // this image's (b) plane
  const float* ub = u + plane * C;
  float* ob = out + plane * C;
  if (vec) {  // x + 4 <= W
    const float4 yv = __ldg(reinterpret_cast<const float4*>(py + plane + q));
    const float4 xv = __ldg(reinterpret_cast<const float4*>(px + plane + q));
    const Tap t0 = tap(yv.x, xv.x, H, W), t1 = tap(yv.y, xv.y, H, W);
    const Tap t2 = tap(yv.z, xv.z, H, W), t3 = tap(yv.w, xv.w, H, W);
    for (int c = 0; c < C; ++c) {
      const float* f = ub + (int64_t)c * HW;
      *reinterpret_cast<float4*>(ob + (int64_t)c * HW + q) = make_float4(
          lerp2(f, t0, W), lerp2(f, t1, W), lerp2(f, t2, W), lerp2(f, t3, W));
    }
    return;
  }
  for (int i = 0; i < 4 && x + i < W; ++i) {
    const Tap t = tap(__ldg(py + plane + q + i), __ldg(px + plane + q + i), H,
                      W);
    for (int c = 0; c < C; ++c)
      ob[(int64_t)c * HW + q + i] = lerp2(ub + (int64_t)c * HW, t, W);
  }
}

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

constexpr unsigned FULL = 0xffffffffu;

// grid (ceil(H * W / THREADS), B): a block's pixels lie in one image
__global__ void __launch_bounds__(THREADS)
landing_histogram_kernel(const int* __restrict__ fy,
                         const int* __restrict__ fx,
                         const float* __restrict__ cell,
                         float* __restrict__ out, int HW, int W) {
  const int64_t q = (int64_t)blockIdx.x * THREADS + threadIdx.x;  // in image
  const int64_t plane = (int64_t)blockIdx.y * HW;
  const int lane = threadIdx.x % 32;
  int y = 0, x = 0;
  float c = 0.f;
  if (q < HW) {
    y = __ldg(fy + plane + q);
    x = __ldg(fx + plane + q);
    c = __ldg(cell + plane + q);
  }
  // the pixel's bin in its image; -1 adds nothing (cell 0)
  const int bin = c != 0.f ? y * W + x : -1;
  if (!__all_sync(FULL, c == 0.f || c == 1.f)) {  // warp-uniform
    if (bin >= 0) atomicAdd(out + plane + bin, c);
    return;
  }
  const int prev = __shfl_up_sync(FULL, bin, 1);
  const int next = __shfl_down_sync(FULL, bin, 1);
  const unsigned heads = __ballot_sync(FULL, lane == 0 || prev != bin);
  if (bin >= 0 && (lane == 31 || next != bin)) {  // a run's last lane
    const int head = 31 - __clz(heads & (FULL >> (31 - lane)));
    atomicAdd(out + plane + bin, (float)(lane - head + 1));
  }
}

}  // namespace

// u, out (B, C, H, W) and py, px (B, H, W) f32; H * W < 2^31
extern "C" int bilinear_sample_f32(const void* u, const void* py,
                                   const void* px, void* out, int B, int C,
                                   int H, int W, void* stream) {
  const bool vec = W % 4 == 0 &&
                   ((uintptr_t)py | (uintptr_t)px | (uintptr_t)out) % 16 == 0;
  const dim3 grid((W + 4 * SX - 1) / (4 * SX), (H + SY - 1) / SY, B);
  bilinear_sample_kernel<<<grid, dim3(SX, SY), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(u), static_cast<const float*>(py),
      static_cast<const float*>(px), static_cast<float*>(out), C, H, W, vec);
  return (int)cudaGetLastError();
}

// fy, fx (B, H, W) int32 in range, cell and out (B, H, W) f32;
// H * W < 2^31, B <= 65535
extern "C" int landing_histogram_f32(const void* fy, const void* fx,
                                     const void* cell, void* out, int B,
                                     int H, int W, void* stream) {
  const int HW = H * W;
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * HW * sizeof(float),
                                        (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks_for(HW), B);
  landing_histogram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(fy), static_cast<const int*>(fx),
      static_cast<const float*>(cell), static_cast<float*>(out), HW, W);
  return (int)cudaGetLastError();
}
