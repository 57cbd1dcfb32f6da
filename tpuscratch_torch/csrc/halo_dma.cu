// Hand-written Hopper (sm_90a) kernels for the DMA-halo 2D stencil.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/halo_dma.py:
//   dma_ring_kernel     <- run_stencil_dma, depth 1, 5-point (:1099;
//                          _make_kernel :164)
//   dma_deep_kernel     <- _run_stencil_dma_deep (:534; _make_kernel_deep :321)
//   dma_hbm_step_kernel <- run_stencil_dma_hbm (:951; _make_kernel_hbm :612)
//
// On the TPU every rank keeps its core on its own chip and the ghost
// strips travel between chips by remote DMA, double-buffered under the
// interior compute. Here all ranks of the mesh are slices of one stacked
// (R, C, H, W) tensor in one card's memory, and every topology these
// kernels take is periodic, so the ranks' cores tile one torus of
// (R*H, C*W) cells. A "DMA channel" becomes a read of the neighbouring
// rank's core in the same device memory (periodic wrap over (R, C)); there
// is no separate exchange and nothing to overlap it with.
//
// Terms come as Taps (stencil_taps.cuh) in each TPU kernel's order:
//   ring:  n, s, w, e, c (halo_dma.py:114-161), zero coefficients included
//   deep:  n, s, w, e, nw, ne, sw, se, c, zero coefficients skipped (:83-111)
//   hbm:   n, s, w, e, c, then nw, ne, sw, se when any diagonal is nonzero
//          (:830-840)
//
// No kernel writes the buffer it reads: every step or round goes out of
// place into the other of two ping-pong buffers.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>

#include "stencil_taps.cuh"

namespace cg = cooperative_groups;

struct Torus {
  int R, C, H, W;  // mesh dims, core dims
};

// Flat index of the cell (i, j) of rank (r, c), for i in [-1, H] and j in
// [-1, W]: one step past a core's edge lands in the neighbouring rank.
__device__ __forceinline__ size_t torus_at(const Torus& g, int r, int c, int i,
                                           int j) {
  if (i < 0) {
    i += g.H;
    r = r == 0 ? g.R - 1 : r - 1;
  } else if (i >= g.H) {
    i -= g.H;
    r = r == g.R - 1 ? 0 : r + 1;
  }
  if (j < 0) {
    j += g.W;
    c = c == 0 ? g.C - 1 : c - 1;
  } else if (j >= g.W) {
    j -= g.W;
    c = c == g.C - 1 ? 0 : c + 1;
  }
  return ((size_t)(r * g.C + c) * g.H + i) * g.W + j;
}

// One step of cell (i, j) of rank (r, c), read from `src`.
__device__ __forceinline__ float torus_step(const Torus& g, const Taps& t,
                                            const float* src, int r, int c,
                                            int i, int j) {
  float v = __fmul_rn(t.c[0], src[torus_at(g, r, c, i + t.dy[0], j + t.dx[0])]);
#pragma unroll
  for (int u = 1; u < 9; ++u)
    if (u < t.n)
      v = __fadd_rn(v, __fmul_rn(t.c[u], src[torus_at(g, r, c, i + t.dy[u], j + t.dx[u])]));
  return v;
}

static bool torus_ok(int R, int C, int H, int W) {
  return R >= 1 && C >= 1 && H >= 1 && W >= 1 &&
         (long long)R * C * H * W <= (long long)INT_MAX;
}

// ---------------------------------------------------------------------------
// dma_ring: `steps` 5-point steps of the whole torus in ONE cooperative
// launch. A persistent grid (as many blocks as can be resident at once:
// occupancy x SMs) walks every rank's cells with a grid-stride loop,
// reading the previous state (edge cells read the neighbour rank's core)
// and writing the next into the other ping-pong buffer, with grid.sync()
// between steps. Step 0 reads `in`; the state after step s (1-based) is in
// buf[(s - 1) % 2].
// Bound: bytes per step. A step must read the torus and write it,
// 8 bytes a cell (at 8192^2 f32, 0.537 GB: 0.160 ms at 3.35 TB/s); grids
// that fit the 50 MB L2 twice pay L2 traffic instead, plus one barrier.
constexpr int RING_THREADS = 512;

__global__ void __launch_bounds__(RING_THREADS)
dma_ring_kernel(const float* __restrict__ in, float* buf0, float* buf1, Torus g,
                int steps, Taps taps) {
  cg::grid_group grid = cg::this_grid();
  const int n = g.R * g.C * g.H * g.W;  // <= INT_MAX (the launcher checks)
  const int stride = gridDim.x * blockDim.x;
  const float* src = in;
  for (int st = 0; st < steps; ++st) {
    float* dst = (st & 1) ? buf1 : buf0;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n; q += stride) {
      const int row = q / g.W, j = q - row * g.W;  // row of the stacked cores
      const int b = row / g.H, i = row - b * g.H;
      const int r = b / g.C, c = b - r * g.C;
      dst[q] = torus_step(g, taps, src, r, c, i, j);
    }
    grid.sync();  // every block's writes of step st are visible to step st+1
    src = dst;
  }
}

extern "C" int ts_dma_ring(const float* in, float* buf0, float* buf1, int R,
                           int C, int H, int W, int steps, int ntaps,
                           const float* c, const int* dy, const int* dx,
                           void* stream) {
  Taps taps;
  if (!torus_ok(R, C, H, W) || steps < 1 || !make_taps(&taps, ntaps, c, dy, dx))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dma_ring_kernel,
                                                      RING_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long need = ((long long)R * C * H * W + RING_THREADS - 1) / RING_THREADS;
  const long long cap = (long long)per_sm * sms;
  const int blocks = (int)(need < cap ? need : cap);
  Torus g{R, C, H, W};
  void* args[] = {(void*)&in, (void*)&buf0, (void*)&buf1, (void*)&g,
                  (void*)&steps, (void*)&taps};
  e = cudaLaunchCooperativeKernel((void*)dma_ring_kernel, dim3(blocks),
                                  dim3(RING_THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dma_deep: one round of `k` substeps (one "k-deep exchange") of every
// rank. A block owns a T x T tile of one rank's core and loads its
// (T + 2k)^2 window straight from the torus: the k-deep ghost zone,
// corner blocks included, is the neighbour ranks' cores. The k substeps
// run as a shrinking trapezoid in shared memory (stencil_taps.cuh) and the
// tile is written once. The wrapper launches one round per k substeps,
// the last one shallower when steps % k != 0 (halo_dma.py:341-342).
// Bound: bytes. A round must read the torus and write it once, 8 bytes a
// cell per k substeps; the price is the window ring's redundant substeps
// (1.3x at T = 64, k = 8) and the 9-point taps at 2 operations each.
constexpr int DEEP_THREADS = 512;

__global__ void __launch_bounds__(DEEP_THREADS)
dma_deep_kernel(const float* __restrict__ src, float* __restrict__ dst, Torus g,
                int k, int T, Taps taps) {
  extern __shared__ float smem[];
  const int R = T + 2 * k;
  const int b = blockIdx.z, r = b / g.C, c = b % g.C;
  const int TH = g.R * g.H, TW = g.C * g.W;  // the torus
  const int y0 = r * g.H + blockIdx.y * T - k, x0 = c * g.W + blockIdx.x * T - k;
  for (int q = threadIdx.x; q < R * R; q += blockDim.x) {
    const int y = ((y0 + q / R) % TH + TH) % TH, x = ((x0 + q % R) % TW + TW) % TW;
    const int rr = y / g.H, cc = x / g.W;
    smem[q] = src[((size_t)(rr * g.C + cc) * g.H + (y - rr * g.H)) * g.W + (x - cc * g.W)];
  }
  __syncthreads();
  const float* res = trapezoid(smem, smem + R * R, R, k, taps,
                               [](int, int, float v) { return v; });
  float* o = dst + (size_t)b * g.H * g.W;
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) {
    const int y = q / T, x = q % T;
    const int oi = blockIdx.y * T + y, oj = blockIdx.x * T + x;
    if (oi < g.H && oj < g.W) o[(size_t)oi * g.W + oj] = res[(k + y) * R + k + x];
  }
}

extern "C" int ts_dma_deep(const float* src, float* dst, int R, int C, int H,
                           int W, int k, int tile, int ntaps, const float* c,
                           const int* dy, const int* dx, void* stream) {
  Taps taps;
  if (!torus_ok(R, C, H, W) || R * C > 65535 || k < 1 || tile < 1 ||
      !make_taps(&taps, ntaps, c, dy, dx))
    return (int)cudaErrorInvalidValue;
  const int Rw = tile + 2 * k;
  const size_t smem = 2ull * Rw * Rw * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      dma_deep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + tile - 1) / tile, (H + tile - 1) / tile, R * C);
  dma_deep_kernel<<<grid, DEEP_THREADS, smem, (cudaStream_t)stream>>>(
      src, dst, Torus{R, C, H, W}, k, tile, taps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dma_hbm_step: ONE step of the torus per launch, out of place; one thread
// a cell, edges read straight from the neighbour ranks' cores. The TPU
// kernel's carried column stages and band windows exist to avoid strided
// HBM access and are not part of the function, so nothing is carried.
// Bound: bytes. A step must read the torus and write it, 8 bytes a cell
// (at 8192^2 f32, 0.160 ms at 3.35 TB/s); neighbouring threads read
// neighbouring addresses, and the row above and below come from L1/L2.
constexpr int HBM_BX = 32;
constexpr int HBM_BY = 8;

__global__ void __launch_bounds__(HBM_BX * HBM_BY)
dma_hbm_step_kernel(const float* __restrict__ src, float* __restrict__ dst,
                    Torus g, Taps taps) {
  const int b = blockIdx.z, r = b / g.C, c = b - r * g.C;
  const int i = blockIdx.y * HBM_BY + threadIdx.y, j = blockIdx.x * HBM_BX + threadIdx.x;
  if (i < g.H && j < g.W)
    dst[((size_t)b * g.H + i) * g.W + j] = torus_step(g, taps, src, r, c, i, j);
}

extern "C" int ts_dma_hbm_step(const float* src, float* dst, int R, int C,
                               int H, int W, int ntaps, const float* c,
                               const int* dy, const int* dx, void* stream) {
  Taps taps;
  if (!torus_ok(R, C, H, W) || R * C > 65535 || !make_taps(&taps, ntaps, c, dy, dx))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((W + HBM_BX - 1) / HBM_BX, (H + HBM_BY - 1) / HBM_BY, R * C);
  dma_hbm_step_kernel<<<grid, dim3(HBM_BX, HBM_BY), 0, (cudaStream_t)stream>>>(
      src, dst, Torus{R, C, H, W}, taps);
  return (int)cudaGetLastError();
}
