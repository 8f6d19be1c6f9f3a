// Masked heat diffusion from a start field, temporally blocked in shared
// memory.
//
// Replaces classpose_tpu/ops/diffusion_pallas.py diffuse_pallas /
// _make_kernel (pallas_call at diffusion_pallas.py:142-161): from T0, tile b
// runs neff[b] iterations of
//   T <- where(ids > 0, (sum over the 3x3 same-id neighbours of (T + cen)) / 9, 0)
// with cen = center * (ids > 0) and neighbours outside the image never
// matching. The wrapper rounds each tile's count up to a multiple of the
// TPU kernel's k (its active flag is read once per round of k).
//
// What bounds it on an H100: memory, then the stencil's adds. A one-launch-
// per-iteration stencil (diffusion.cu, kernel 4) moves ~14 B per pixel per
// iteration. Here one CTA loads a window of T, ids and centre with a halo of
// R = 8 around a 64x64 interior into shared memory (80x80: two f32 planes
// of T + cen to ping-pong, the masked centre, a 16-bit neighbour mask per
// pixel; ~90 KB, two CTAs per SM), runs up to R iterations there, and writes
// back the interior only: a 3x3 stencil has dependence radius 1 per step, so
// after r <= R steps the interior is exact while the halo ring degrades.
// Global traffic drops to ~(12 * 80^2 / 64^2 + 4) / R ~ 2.8 B per pixel per
// iteration. The TPU's 256^2 block with a 40-row / 128-lane halo would need
// ~1.6 MB of fast memory and is not carried over.
//
// One launch advances every tile by min(R, neff[b] - s0) iterations, s0 the
// iterations done before it; a tile whose count is done copies its interior
// through. Mask bit k (k = 0..7) of a pixel: neighbour k of the 3x3 stencil
// in _SHIFTS9 order, the centre skipped, lies in the window and has the
// same id (a neighbour outside the image has id 0 and a foreground pixel
// never matches it); bit 8: the pixel is foreground.
//
// Exactness: the window keeps U = T + cen, each pixel's term in its
// neighbours' sums, computed once per iteration by the same round-to-nearest
// add. Each new T sums U over the matching neighbours in _SHIFTS9 order from
// 0.0f (the plain path adds an exact 0.0f where a neighbour does not match)
// and multiplies by float(1/9), as kernel 4 and the XLA stencil do. Built
// with -fmad=false and written with explicit round-to-nearest intrinsics:
// bit for bit the plain PyTorch version.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BS = 64;             // interior side
constexpr int R = 8;               // halo = iterations per launch
constexpr int WIN = BS + 2 * R;    // window side
constexpr int NPIX = WIN * WIN;
constexpr int THREADS = 256;
constexpr size_t SMEM = 3 * NPIX * sizeof(float) + NPIX * sizeof(uint16_t);

__constant__ int kDY[9] = {-1, -1, -1, 0, 0, 0, 1, 1, 1};
__constant__ int kDX[9] = {-1, 0, 1, -1, 0, 1, -1, 0, 1};

__global__ void __launch_bounds__(THREADS)
blocked_kernel(const float* __restrict__ Tin, float* __restrict__ Tout,
               const int* __restrict__ ids, const float* __restrict__ cen,
               const int* __restrict__ neff, int H, int W, int s0) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ua = reinterpret_cast<float*>(smem);  // T + cen, ping
  float* Ub = Ua + NPIX;                       // pong; ids while packing
  float* Cm = Ub + NPIX;                       // cen * fg
  uint16_t* M = reinterpret_cast<uint16_t*>(Cm + NPIX);
  int* Iw = reinterpret_cast<int*>(Ub);

  const int b = blockIdx.z;
  const int wy0 = blockIdx.y * BS - R;  // image row of window row 0
  const int wx0 = blockIdx.x * BS - R;
  const int64_t base = (int64_t)b * H * W;
  const int tid = threadIdx.x;
  const int nrun = min(R, neff[b] - s0);

  if (nrun <= 0) {  // this tile is done: carry its interior through
    for (int p = tid; p < BS * BS; p += THREADS) {
      const int y = wy0 + R + p / BS, x = wx0 + R + p % BS;
      if (y < H && x < W) Tout[base + (int64_t)y * W + x] =
          Tin[base + (int64_t)y * W + x];
    }
    return;
  }

  for (int p = tid; p < NPIX; p += THREADS) {
    const int y = wy0 + p / WIN, x = wx0 + p % WIN;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const int64_t g = base + (int64_t)y * W + x;
    const int id = in ? ids[g] : 0;
    const float c = (in && id > 0) ? cen[g] : 0.f;
    Iw[p] = id;
    Cm[p] = c;
    Ua[p] = __fadd_rn(in ? Tin[g] : 0.f, c);
  }
  __syncthreads();
  for (int p = tid; p < NPIX; p += THREADS) {
    const int wy = p / WIN, wx = p % WIN;
    const int id = Iw[p];
    uint16_t m = id > 0 ? (uint16_t)(1u << 8) : (uint16_t)0;
    int k = 0;
    for (int s = 0; s < 9; ++s) {
      if (s == 4) continue;
      const int yy = wy + kDY[s], xx = wx + kDX[s];
      if (yy >= 0 && yy < WIN && xx >= 0 && xx < WIN &&
          Iw[yy * WIN + xx] == id)
        m |= (uint16_t)(1u << k);
      ++k;
    }
    M[p] = m;
  }
  __syncthreads();

  float* cur = Ua;
  float* nxt = Ub;
  for (int it = 0; it < nrun; ++it) {
    const bool last = it == nrun - 1;
    // the last step is needed on the interior only
    const int npx = last ? BS * BS : NPIX;
    for (int q = tid; q < npx; q += THREADS) {
      const int p = last ? (R + q / BS) * WIN + R + q % BS : q;
      const uint16_t m = M[p];
      float t = 0.f;
      if (m & (1u << 8)) {
        float acc = 0.f;
        int k = 0;
        for (int s = 0; s < 9; ++s) {
          if (s == 4) {
            acc = __fadd_rn(acc, cur[p]);
            continue;
          }
          if (m & (1u << k)) acc = __fadd_rn(acc, cur[p + kDY[s] * WIN + kDX[s]]);
          ++k;
        }
        t = __fmul_rn(acc, 1.f / 9.f);
      }
      if (last) {
        const int y = wy0 + p / WIN, x = wx0 + p % WIN;
        if (y < H && x < W) Tout[base + (int64_t)y * W + x] = t;
      } else {
        nxt[p] = __fadd_rn(t, Cm[p]);
      }
    }
    if (!last) {
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

}  // namespace

// Tin, Tout, cen (B, H, W) f32; ids (B, H, W) int32; neff (B,) int32 on the
// device. Advances every tile by min(8, neff[b] - s0) iterations (0: copy).
extern "C" int diffusion_blocked_round(const void* Tin, void* Tout,
                                       const void* ids, const void* cen,
                                       const void* neff, int B, int H, int W,
                                       int s0, void* stream) {
  cudaFuncSetAttribute(blocked_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM);
  dim3 grid((W + BS - 1) / BS, (H + BS - 1) / BS, B);
  blocked_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(Tin), static_cast<float*>(Tout),
      static_cast<const int*>(ids), static_cast<const float*>(cen),
      static_cast<const int*>(neff), H, W, s0);
  return (int)cudaGetLastError();
}

// the kernel's iterations per launch, for the wrapper
extern "C" int diffusion_blocked_depth() { return R; }
