// Masked heat diffusion with a count of iterations per tile: the flow-error
// QC and the flow targets, from zero or from a start field.
//
// Replaces both classpose_tpu/ops/diffusion_pallas.py kernels, which run
// the same stencil:
//   - diffuse_resident_pallas / _resident_kernel (pallas_call at
//     diffusion_pallas.py:289, kernel 4): niter[b] iterations per tile
//     from T = 0;
//   - diffuse_pallas / _make_kernel (pallas_call at diffusion_pallas.py:
//     143, kernel 7): from a start field T0, each tile's count rounded up
//     to a multiple of the TPU kernel's k by the wrapper.
// One iteration is
//   T <- where(ids > 0, (sum over the 3x3 same-id neighbours of (T + cen)) / 9, 0)
// where neighbours outside the image never match (ids may be raw labels:
// they are compared, never indexed).
//
// What bounds it on an H100: the stencil's instructions, once the state
// stays on chip. The TPU kernels kept whole tiles resident in VMEM; an SM
// has 227 KB, and one launch per iteration would move ~14 B per pixel per
// iteration through L2/HBM. So the kernel blocks in time:
//   - a prologue (pack_kernel) packs, once per call, the loop-invariant
//     neighbour matches into one 16-bit word per pixel (bit k: neighbour k
//     of _SHIFTS9, the centre skipped, has the same id and lies in the
//     image; bit 8: the pixel is foreground) and the masked source
//     cen * fg;
//   - each launch (round_kernel) advances every tile by up to R
//     iterations: one CTA of 512 threads holds a 128-wide window of
//     U = T + cen in shared memory, ping-ponging two planes, runs the
//     iterations there and writes back the interior only (the window less
//     an R-pixel halo). A 3x3 stencil has dependence radius 1 per step, so
//     after r <= R steps the interior is exact while the halo ring
//     degrades (window-edge pixels see no neighbour beyond the window:
//     their bits are cleared);
//   - each thread owns a 4-column strip of the window's rows for the whole
//     launch (a warp spans the 128 columns): its masked centres and
//     neighbour masks sit in registers, and it walks its strip row by row
//     with the three rows of U it needs (6 values each: its 4 columns and
//     one on either side) in registers, so a pixel-iteration reads 1.5 to
//     3 words of shared memory and writes one;
//   - per iteration only the warps whose rows can still reach the
//     interior compute (the halo's cone shrinks by a row per step);
//   - a tile past its own count copies its interior through, so each tile
//     runs exactly niter[b] iterations; counts need not be multiples of
//     R, and a tile with none keeps its start field.
// Two windows, chosen per call by the wrapper (ops/diffusion.py
// diffusion_plan, which holds the same table):
//   window 0: 128 x 128, R = 16 (96 x 96 interior, 8 rows a thread): the
//     least halo work, for calls whose tiles give the card enough CTAs;
//   window 1: 32 rows x 128, R = 8 (16 x 112 interior, 2 rows a thread):
//     4.4x more CTAs per pixel, for small calls such as the evaluate QC
//     of one 448^2 image (25 CTAs of window 0 on 132 SMs, 112 of window 1).
// The rounds of a call are launched from here, back to back. Where the
// grid has more CTAs than the card has SMs, each round after the first
// is launched with programmatic dependent launch: its CTAs start, and
// load their masks and centres, while the round before it ends, and wait
// for that round (griddepcontrol.wait) before they touch T. A smaller
// grid launches its rounds plainly: there the next round's CTAs would
// pile onto the SMs its predecessor left idle, two to an SM, and run
// slower than spread one to an SM.
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
constexpr int CPT = 4;           // columns per thread
constexpr int THREADS = 512;     // 16 warps, each a band of the rows
constexpr int WARPS = THREADS / 32;
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
template <int WY>
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

// One round on a WY x 128 window with an R-pixel halo. Tin == nullptr
// starts from T = 0.
template <int WY, int R>
__global__ void __launch_bounds__(THREADS, 1)
round_kernel(const float* __restrict__ Tin, float* __restrict__ Tout,
             const float* __restrict__ cenm,
             const uint16_t* __restrict__ mask,
             const int* __restrict__ niter, int H, int W, int s0) {
  constexpr int RPT = WY / WARPS;  // rows per thread
  constexpr int IX = WX - 2 * R, IY = WY - 2 * R;
  static_assert(RPT * WARPS == WY && IY > 0, "window");
  extern __shared__ __align__(16) float U[];  // [2][WY][WX]
  const int b = blockIdx.z;
  const int wy0 = blockIdx.y * IY - R;  // image row of window row 0
  const int wx0 = blockIdx.x * IX - R;
  const int64_t base = (int64_t)b * H * W;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int c0 = lane * CPT, r0 = warp * RPT;
  const int nrun = min(R, niter[b] - s0);
  // programmatic dependent launch: the next round may start its CTAs and
  // their prologue (masks and centres, which no round writes) now; T is
  // touched only after the previous round has finished
  asm volatile("griddepcontrol.launch_dependents;");

  if (nrun <= 0) {  // this tile is done: carry its interior through
    asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i, y = wy0 + r;
      if (r < R || r >= WY - R || y >= H) continue;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = c0 + j, x = wx0 + c;
        if (c >= R && c < WX - R && x < W) {
          const int64_t g = base + (int64_t)y * W + x;
          Tout[g] = Tin ? Tin[g] : 0.f;
        }
      }
    }
    return;
  }

  // this thread's masked centres and neighbour masks, for the launch.
  // Pixels outside the image are background (mask 0, centre 0, T 0).
  float cen[RPT][CPT];
  uint32_t mk[RPT][CPT / 2];  // two 16-bit masks a word
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i, y = wy0 + r;
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
      if (j % 2 == 0)
        mk[i][j / 2] = m;
      else
        mk[i][j / 2] |= m << 16;
    }
  }
  // U = T + cen into plane 0, once the previous round's T is complete
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + i, y = wy0 + r;
    float u[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int x = wx0 + c0 + j;
      const bool in = Tin && y >= 0 && y < H && x >= 0 && x < W;
      u[j] = __fadd_rn(in ? Tin[base + (int64_t)y * W + x] : 0.f,
                       cen[i][j]);
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
      load_row<WY>(cur, r0 - 1, c0, up);
      load_row<WY>(cur, r0, c0, mid);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        load_row<WY>(cur, r0 + i + 1, c0, dn);
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

// every round of one call on window WY x 128 with halo R: ceil(nmax / R)
// launches, the last one writing `out`; rounds alternate between `out`
// and `scratch` and the first reads T0 (nullptr: zero), which is never
// written. With `overlap`, each round after the first is launched with
// programmatic dependent launch.
template <int WY, int R>
cudaError_t run_rounds(const float* T0, float* out, float* scratch,
                       const float* cenm, const uint16_t* mask,
                       const int* niter, int B, int H, int W, int nmax,
                       bool overlap, cudaStream_t stream, int* launched) {
  constexpr size_t smem = 2 * WX * WY * sizeof(float);
  constexpr int IX = WX - 2 * R, IY = WY - 2 * R;
  cudaError_t e = cudaFuncSetAttribute(
      round_kernel<WY, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((W + IX - 1) / IX, (H + IY - 1) / IY, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  const int rounds = (nmax + R - 1) / R;
  const float* src = T0;
  for (int r = 0; r < rounds; ++r) {
    float* dst = (rounds - 1 - r) % 2 == 0 ? out : scratch;
    // the first round waits for the pack in full
    cfg.attrs = overlap && r > 0 ? &pdl : nullptr;
    cfg.numAttrs = overlap && r > 0 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, round_kernel<WY, R>, src, dst, cenm, mask,
                           niter, H, W, r * R);
    if (e != cudaSuccess) return e;
    ++*launched;
    src = dst;
  }
  return cudaSuccess;
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

// T0 (B, H, W) f32 or nullptr (zero), out and scratch (B, H, W) f32, cenm
// and mask from diffusion_pack_nbr, niter (B,) int32 on the device with
// max(niter) <= nmax: tile b runs niter[b] iterations from T0 and the
// result lands in out. `window` picks the window (see the head of this
// file), `overlap` whether rounds overlap (programmatic dependent
// launch); *launched counts the kernels launched
extern "C" int diffusion_rounds(const void* T0, void* out, void* scratch,
                                const void* cenm, const void* mask,
                                const void* niter, int B, int H, int W,
                                int nmax, int window, int overlap,
                                void* stream, void* launched) {
  const auto t0 = static_cast<const float*>(T0);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<float*>(scratch);
  const auto c = static_cast<const float*>(cenm);
  const auto m = static_cast<const uint16_t*>(mask);
  const auto n = static_cast<const int*>(niter);
  const auto st = (cudaStream_t)stream;
  const auto l = static_cast<int*>(launched);
  switch (window) {
    case 0:
      return (int)run_rounds<128, 16>(t0, o, s, c, m, n, B, H, W, nmax,
                                       overlap, st, l);
    case 1:
      return (int)run_rounds<32, 8>(t0, o, s, c, m, n, B, H, W, nmax,
                                     overlap, st, l);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
