// Hand-written Hopper (sm_90a) kernel for the streamed 2D stencil.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/stencil_stream.py:
//   stream2d_kernel <- nine_point_streamed_2d (:1067; _stream2d_kernel :902,
//                      _substep2d :839, _substep2d_gstrip :882)
//
// What it computes: `k` 5- or 9-point substeps of every rank's (H, W) core
// in one launch, over the stacked ranks (blockIdx.z). The TPU kernel
// streams the core through VMEM in row bands, splices the (k, W) ghost-row
// slabs in at the grid ends, and either wraps x in-kernel (wrap mode) or
// ages a [gr | gl] ghost-column strip beside each band (ghost mode), whose
// seam garbage never reaches the core (stencil_stream.py:814-835). All of
// that computes, for every core cell, the k-substep pyramid over the
// extended grid
//   rows [-k, H + k): top slab | core | bottom slab,
//   cols [-k, W + k): wrap mode: column c mod W; ghost mode: gl | . | gr,
// with the corner blocks at the ends of gl/gr. Here a block owns a T x T
// output tile, loads its (T + 2k)^2 window of that extended grid once into
// shared memory and runs the shrinking pyramid there (stencil_taps.cuh).
// Open ends (per-rank flags [top, bottom, left, right]) keep the rings
// that are still ghosts at zero after each substep, the rule of
// stencil_stream.py:966-1002: y ends in both modes, x ends in ghost mode.
//
// Terms: the TPU kernel's weight grid in row-major order (nw, n, ne, w, c,
// e, sw, s, se), zero weights skipped; the host passes them as Taps.
//
// Bound: bytes. One launch must read the core and the slabs and write the
// core, about 8*H*W bytes a rank per k substeps; the f32 operations, 2 per
// tap per cell per substep, stay below that at these depths. The price of
// the trapezoid is redundant work on the window's ring: at T = 64, k = 16
// about (96^2 + ... + 64^2) / (16 * 64^2) = 1.6x the core's substeps.

#include <cuda_runtime.h>

#include "stencil_taps.cuh"

constexpr int ST_THREADS = 512;

__global__ void __launch_bounds__(ST_THREADS)
stream2d_kernel(const float* __restrict__ core, const float* __restrict__ top,
                const float* __restrict__ bot, const float* __restrict__ gl,
                const float* __restrict__ gr, const int* __restrict__ flags,
                float* __restrict__ out, int H, int W, int k, int ghost, int T,
                Taps taps) {
  extern __shared__ float smem[];
  const int R = T + 2 * k;
  const size_t rank = blockIdx.z;
  const float* c = core + rank * H * W;
  const float* tp = top + rank * k * W;
  const float* bt = bot + rank * k * W;
  const float* gL = gl + rank * (H + 2 * k) * k;
  const float* gR = gr + rank * (H + 2 * k) * k;
  const int* f = flags + rank * 4;
  const bool open_t = f[0], open_b = f[1];
  const bool open_l = ghost && f[2], open_r = ghost && f[3];
  const int y0 = blockIdx.y * T - k, x0 = blockIdx.x * T - k;  // >= -k

  // the window, in extended-grid coordinates; cells past the extended grid
  // feed only outputs past the core, which are not stored, and load as 0
  for (int q = threadIdx.x; q < R * R; q += blockDim.x) {
    const int y = y0 + q / R, x = x0 + q % R;
    float v = 0.f;
    if (y < H + k) {
      int xc = x;  // the core column that x reads, or -1 for a ghost slab
      if (!ghost) {
        xc = ((x % W) + W) % W;
      } else if (x < 0) {
        xc = -1;
        v = gL[(y + k) * k + (x + k)];
      } else if (x >= W) {
        xc = -1;
        if (x < W + k) v = gR[(y + k) * k + (x - W)];
      }
      if (xc >= 0)
        v = y < 0 ? tp[(y + k) * W + xc] : y >= H ? bt[(y - H) * W + xc] : c[y * W + xc];
    }
    smem[q] = v;
  }
  __syncthreads();

  auto fix = [&](int ly, int lx, float v) {
    const int y = y0 + ly, x = x0 + lx;
    const bool ghost_cell = (open_t && y < 0) || (open_b && y >= H) ||
                            (open_l && x < 0) || (open_r && x >= W);
    return ghost_cell ? 0.f : v;
  };
  const float* res = trapezoid(smem, smem + R * R, R, k, taps, fix);

  float* o = out + rank * H * W;
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) {
    const int y = q / T, x = q % T;
    const int oi = y0 + k + y, oj = x0 + k + x;
    if (oi < H && oj < W) o[oi * W + oj] = res[(k + y) * R + k + x];
  }
}

extern "C" int ts_stream2d(const float* core, const float* top, const float* bot,
                           const float* gl, const float* gr, const int* flags,
                           float* out, int nb, int H, int W, int k, int ghost,
                           int tile, int ntaps, const float* c, const int* dy,
                           const int* dx, void* stream) {
  Taps taps;
  if (nb < 1 || nb > 65535 || H < 1 || W < 1 || k < 1 || tile < 1 ||
      (ghost && (gl == nullptr || gr == nullptr)) ||
      !make_taps(&taps, ntaps, c, dy, dx))
    return (int)cudaErrorInvalidValue;
  const int R = tile + 2 * k;
  const size_t smem = 2ull * R * R * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      stream2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, nb);
  // wrap mode reads no ghost columns: any valid pointer stands in
  stream2d_kernel<<<grid, ST_THREADS, smem, (cudaStream_t)stream>>>(
      core, top, bot, ghost ? gl : core, ghost ? gr : core, flags, out, H, W, k,
      ghost, tile, taps);
  return (int)cudaGetLastError();
}
