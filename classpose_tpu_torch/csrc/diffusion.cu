// Masked heat diffusion for the flow-error QC.
//
// Replaces classpose_tpu/ops/diffusion_pallas.py diffuse_resident_pallas /
// _resident_kernel (pallas_call at diffusion_pallas.py:289): niter[b]
// iterations per tile of
//   T <- where(ids > 0, (sum over the 3x3 same-id neighbours of (T + cen)) / 9, 0)
// where neighbours outside the image never match.
//
// What bounds it on an H100: memory. The TPU kernel kept ~15 f32 planes of
// a whole 1024^2 tile resident in 128 MB of VMEM; that does not fit in an
// SM's 227 KB of shared memory, so it is not carried over. Instead a
// prologue packs, once per call, the loop-invariant neighbour matches into
// one 16-bit word per pixel (bit k: neighbour k of _SHIFTS9, the centre
// skipped, has the same id and lies in the image; bit 8: the pixel is
// foreground) and the masked source cen * fg. Then one stencil launch per
// iteration ping-pongs two T buffers: ~14 B per pixel per iteration (T and
// cen read, the mask read, T written; the 3x3 re-reads hit L1/L2). A tile
// past its own niter[b] copies T through. Temporal blocking in shared
// memory is later work.
//
// Exactness: each new T sums T(q) + cen(q) over _SHIFTS9 in that order,
// starting from 0.0f and adding nothing where the bit is clear (the plain
// path adds an exact 0.0f there), then multiplies by float(1/9): the
// arithmetic of classpose_tpu/dynamics/flows.py _diffuse_dyn bit for bit,
// as XLA compiles it (XLA turns the division by the constant 9 into a
// multiply by its rounded reciprocal). Built with -fmad=false.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__constant__ int kDY[9] = {-1, -1, -1, 0, 0, 0, 1, 1, 1};
__constant__ int kDX[9] = {-1, 0, 1, -1, 0, 1, -1, 0, 1};

__global__ void pack_kernel(const int* __restrict__ ids,
                            const float* __restrict__ cen,
                            float* __restrict__ cenm,
                            uint16_t* __restrict__ mask, int B, int H, int W) {
  const int64_t HW = (int64_t)H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * HW) return;
  const int64_t b = idx / HW;
  const int q = (int)(idx % HW);
  const int y = q / W, x = q % W;
  const int id = ids[idx];
  const int* tile = ids + b * HW;
  uint16_t m = 0;
  int k = 0;
  for (int s = 0; s < 9; ++s) {
    if (s == 4) continue;
    const int yy = y + kDY[s], xx = x + kDX[s];
    if (yy >= 0 && yy < H && xx >= 0 && xx < W && tile[yy * W + xx] == id)
      m |= (uint16_t)(1u << k);
    ++k;
  }
  if (id > 0) m |= (uint16_t)(1u << 8);
  mask[idx] = m;
  cenm[idx] = id > 0 ? cen[idx] : 0.f;
}

__global__ void step_kernel(const float* __restrict__ Tin,
                            float* __restrict__ Tout,
                            const float* __restrict__ cenm,
                            const uint16_t* __restrict__ mask,
                            const int* __restrict__ niter, int B, int H,
                            int W, int it) {
  const int64_t HW = (int64_t)H * W;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (int64_t)B * HW) return;
  const int64_t b = idx / HW;
  if (it >= niter[b]) {  // this tile is done: carry T through
    Tout[idx] = Tin[idx];
    return;
  }
  const uint16_t m = mask[idx];
  if (!(m & (1u << 8))) {
    Tout[idx] = 0.f;
    return;
  }
  float acc = 0.f;
  int k = 0;
  for (int s = 0; s < 9; ++s) {
    if (s == 4) {
      acc = __fadd_rn(acc, __fadd_rn(Tin[idx], cenm[idx]));
      continue;
    }
    if (m & (1u << k)) {
      const int64_t o = idx + (int64_t)kDY[s] * W + kDX[s];
      acc = __fadd_rn(acc, __fadd_rn(Tin[o], cenm[o]));
    }
    ++k;
  }
  Tout[idx] = __fmul_rn(acc, 1.f / 9.f);
}

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" int diffusion_pack_nbr(const void* ids, const void* cen,
                                  void* cenm, void* mask, int B, int H,
                                  int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  pack_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(ids), static_cast<const float*>(cen),
      static_cast<float*>(cenm), static_cast<uint16_t*>(mask), B, H, W);
  return (int)cudaGetLastError();
}

extern "C" int diffusion_step(const void* Tin, void* Tout, const void* cenm,
                              const void* mask, const void* niter, int B,
                              int H, int W, int it, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  step_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(Tin), static_cast<float*>(Tout),
      static_cast<const float*>(cenm), static_cast<const uint16_t*>(mask),
      static_cast<const int*>(niter), B, H, W, it);
  return (int)cudaGetLastError();
}
