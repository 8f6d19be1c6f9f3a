// Masked heat diffusion for the flow-error QC, from zero, with a count of
// iterations per tile.
//
// Replaces classpose_tpu/ops/diffusion_pallas.py diffuse_resident_pallas /
// _resident_kernel (pallas_call at diffusion_pallas.py:289): niter[b]
// iterations per tile of
//   T <- where(ids > 0, (sum over the 3x3 same-id neighbours of (T + cen)) / 9, 0)
// where neighbours outside the image never match.
//
// What bounds it on an H100: the stencil's instructions, once the state
// stays on chip. The TPU kernel kept ~15 f32 planes of a whole 1024^2 tile
// resident in 128 MB of VMEM; an SM has 227 KB, and one launch per
// iteration would move ~14 B per pixel per iteration through L2/HBM. So
// the kernel blocks in time:
//   - a prologue (pack_kernel) packs, once per call, the loop-invariant
//     neighbour matches into one 16-bit word per pixel (bit k: neighbour k
//     of _SHIFTS9, the centre skipped, has the same id and lies in the
//     image; bit 8: the pixel is foreground) and the masked source
//     cen * fg;
//   - each launch (resident_kernel) advances every tile by up to R = 16
//     iterations: one CTA of 512 threads holds a 128 x 128 window (a
//     96 x 96 interior and a 16-pixel halo) of U = T + cen in shared
//     memory, ping-ponging two planes (128 KB), runs the iterations there
//     and writes back the interior only. A 3x3 stencil has dependence
//     radius 1 per step, so after r <= R steps the interior is exact while
//     the halo ring degrades (window-edge pixels see no neighbour beyond
//     the window: their bits are cleared);
//   - each thread owns a 4-column x 8-row strip of the window for the
//     whole launch: its masked centres and neighbour masks sit in
//     registers, and it walks its strip row by row with the three rows of
//     U it needs (6 values each: its 4 columns and one on either side) in
//     registers, so a pixel-iteration reads ~1.5 words of shared memory
//     (kernel 7 reads 9 per pixel, plus its mask and centre) and writes
//     one;
//   - per iteration only the warps whose rows can still reach the
//     interior compute (the halo's cone shrinks by a row per step);
//   - a tile past its own count copies its interior through, so each tile
//     runs exactly niter[b] iterations; counts need not be multiples of
//     R, and a count of 0 leaves T at zero.
// Global traffic drops to ~(12 * 128^2 / 96^2 + 4) / 16 ~ 1.6 B per pixel
// per iteration, with ceil(max niter / 16) launches per call.
//
// Exactness: each new T sums U = T + cen over the matching neighbours in
// _SHIFTS9 order from 0.0f, adding nothing where the bit is clear (the
// plain path adds an exact 0.0f there, which cannot change a sum that
// started at +0.0f), then multiplies by float(1/9): the arithmetic of
// classpose_tpu/dynamics/flows.py _diffuse_dyn bit for bit, as XLA
// compiles it (XLA turns the division by the constant 9 into a multiply
// by its rounded reciprocal). U is formed once per pixel and iteration by
// the same round-to-nearest add. Built with -fmad=false and written with
// explicit round-to-nearest intrinsics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__constant__ int kDY[9] = {-1, -1, -1, 0, 0, 0, 1, 1, 1};
__constant__ int kDX[9] = {-1, 0, 1, -1, 0, 1, -1, 0, 1};

constexpr int WX = 128;          // window width: one warp, 4 columns a lane
constexpr int WY = 128;          // window height: 16 warps of 8 rows
constexpr int R = 16;            // halo = iterations per launch
constexpr int IX = WX - 2 * R;   // interior 96 x 96
constexpr int IY = WY - 2 * R;
constexpr int CPT = 4;           // columns per thread
constexpr int RPT = 8;           // rows per thread
constexpr int THREADS = (WX / CPT) * (WY / RPT);
constexpr size_t SMEM = 2 * WX * WY * sizeof(float);
static_assert(WX / CPT == 32, "a warp spans the window's width");

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

// the 6 values of window row r a thread's 4 columns need (its columns and
// one on either side; outside the window 0, never used: the bits that
// would read them are cleared)
__device__ __forceinline__ void load_row(const float* __restrict__ cur,
                                         int r, int c0, float (&v)[6]) {
  if (r < 0 || r >= WY) {
#pragma unroll
    for (int j = 0; j < 6; ++j) v[j] = 0.f;
    return;
  }
  const float* row = cur + r * WX;
  const float4 m = *reinterpret_cast<const float4*>(row + c0);
  v[0] = c0 > 0 ? row[c0 - 1] : 0.f;
  v[1] = m.x;
  v[2] = m.y;
  v[3] = m.z;
  v[4] = m.w;
  v[5] = c0 + CPT < WX ? row[c0 + CPT] : 0.f;
}

__global__ void __launch_bounds__(THREADS, 1)
resident_kernel(const float* __restrict__ Tin, float* __restrict__ Tout,
                const float* __restrict__ cenm,
                const uint16_t* __restrict__ mask,
                const int* __restrict__ niter, int H, int W, int s0) {
  extern __shared__ __align__(16) float U[];  // [2][WY][WX]
  const int b = blockIdx.z;
  const int wy0 = blockIdx.y * IY - R;  // image row of window row 0
  const int wx0 = blockIdx.x * IX - R;
  const int64_t base = (int64_t)b * H * W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = lane * CPT, r0 = warp * RPT;
  const int nrun = min(R, niter[b] - s0);

  if (nrun <= 0) {  // this tile is done: carry its interior through
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i, y = wy0 + r;
      if (r < R || r >= WY - R || y >= H) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + j, x = wx0 + c;
        if (c >= R && c < WX - R && x < W)
          Tout[base + (int64_t)y * W + x] = Tin[base + (int64_t)y * W + x];
      }
    }
    return;
  }

  // this thread's masked centres and neighbour masks, for the launch;
  // U = T + cen into plane 0. Pixels outside the image are background
  // (mask 0, centre 0, T 0).
  float cen[RPT][CPT];
  uint32_t mk[RPT][CPT / 2];  // two 16-bit masks a word
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i, y = wy0 + r;
    float u[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = c0 + j, x = wx0 + c;
      const bool in = y >= 0 && y < H && x >= 0 && x < W;
      const int64_t g = base + (int64_t)y * W + x;
      uint32_t m = in ? mask[g] : 0u;
      // bits of neighbours outside the window (k = 0..2 above, 5..7
      // below, 0, 3, 5 left, 2, 4, 7 right)
      if (r == 0) m &= ~0x07u;
      if (r == WY - 1) m &= ~0xE0u;
      if (c == 0) m &= ~0x29u;
      if (c == WX - 1) m &= ~0x94u;
      cen[i][j] = in ? cenm[g] : 0.f;
      u[j] = __fadd_rn(in ? Tin[g] : 0.f, cen[i][j]);
      if (j % 2 == 0)
        mk[i][j / 2] = m;
      else
        mk[i][j / 2] |= m << 16;
    }
    *reinterpret_cast<float4*>(U + r * WX + c0) =
        make_float4(u[0], u[1], u[2], u[3]);
  }
  __syncthreads();

  // the warp's rows' least distance to the interior rows [R, WY - R)
  const int dmin = max(max(R - (r0 + RPT - 1), r0 - (WY - R - 1)), 0);
  for (int it = 0; it < nrun; ++it) {
    const float* cur = U + (it & 1) * WX * WY;
    float* nxt = U + ((it + 1) & 1) * WX * WY;
    const bool last = it == nrun - 1;
    // rows that cannot reach the interior in the steps left are skipped
    // (warp-uniform); their stale values are read only by rows that are
    // skipped too
    if (dmin <= nrun - 1 - it) {
      float up[6], mid[6], dn[6];
      load_row(cur, r0 - 1, c0, up);
      load_row(cur, r0, c0, mid);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        load_row(cur, r0 + i + 1, c0, dn);
        float t[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const uint32_t m = mk[i][j / 2] >> (16 * (j % 2));
          t[j] = 0.f;
          if (m & 0x100u) {
            // _SHIFTS9 order: row above, own row (centre always), below
            float acc = 0.f;
            if (m & 0x01u) acc = __fadd_rn(acc, up[j]);
            if (m & 0x02u) acc = __fadd_rn(acc, up[j + 1]);
            if (m & 0x04u) acc = __fadd_rn(acc, up[j + 2]);
            if (m & 0x08u) acc = __fadd_rn(acc, mid[j]);
            acc = __fadd_rn(acc, mid[j + 1]);
            if (m & 0x10u) acc = __fadd_rn(acc, mid[j + 2]);
            if (m & 0x20u) acc = __fadd_rn(acc, dn[j]);
            if (m & 0x40u) acc = __fadd_rn(acc, dn[j + 1]);
            if (m & 0x80u) acc = __fadd_rn(acc, dn[j + 2]);
            t[j] = __fmul_rn(acc, 1.f / 9.f);
          }
        }
        const int r = r0 + i;
        if (last) {
          const int y = wy0 + r;
          if (r >= R && r < WY - R && y < H) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) {
              const int c = c0 + j, x = wx0 + c;
              if (c >= R && c < WX - R && x < W)
                Tout[base + (int64_t)y * W + x] = t[j];
            }
          }
        } else {
          *reinterpret_cast<float4*>(nxt + r * WX + c0) = make_float4(
              __fadd_rn(t[0], cen[i][0]), __fadd_rn(t[1], cen[i][1]),
              __fadd_rn(t[2], cen[i][2]), __fadd_rn(t[3], cen[i][3]));
        }
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          up[j] = mid[j];
          mid[j] = dn[j];
        }
      }
    }
    if (!last) __syncthreads();
  }
}

constexpr int PACK_THREADS = 256;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + PACK_THREADS - 1) / PACK_THREADS);
}

}  // namespace

// ids (B, H, W) int32, cen (B, H, W) f32 -> cenm = cen * (ids > 0) f32 and
// the neighbour mask (B, H, W) uint16, once per call
extern "C" int diffusion_pack_nbr(const void* ids, const void* cen,
                                  void* cenm, void* mask, int B, int H,
                                  int W, void* stream) {
  const int64_t n = (int64_t)B * H * W;
  pack_kernel<<<blocks_for(n), PACK_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(ids), static_cast<const float*>(cen),
      static_cast<float*>(cenm), static_cast<uint16_t*>(mask), B, H, W);
  return (int)cudaGetLastError();
}

// Tin, Tout (B, H, W) f32, cenm and mask from diffusion_pack_nbr, niter
// (B,) int32 on the device: advances every tile by min(R, niter[b] - s0)
// iterations (none: a copy); s0 is the iterations done before this launch
extern "C" int diffusion_resident_round(const void* Tin, void* Tout,
                                        const void* cenm, const void* mask,
                                        const void* niter, int B, int H,
                                        int W, int s0, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + IX - 1) / IX, (H + IY - 1) / IY, B);
  resident_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(Tin), static_cast<float*>(Tout),
      static_cast<const float*>(cenm), static_cast<const uint16_t*>(mask),
      static_cast<const int*>(niter), H, W, s0);
  return (int)cudaGetLastError();
}

// the kernel's iterations per launch, for the wrapper
extern "C" int diffusion_resident_depth() { return R; }
