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
// Terms, in each TPU kernel's order:
//   ring:  n, s, w, e, c (halo_dma.py:114-161), zero coefficients included;
//          the launcher checks the tap list (n, c, dy, dx) and takes the
//          coefficients
//   deep:  n, s, w, e, nw, ne, sw, se, c, zero coefficients skipped
//          (:83-111); the launcher takes the coefficients by tap position
//          and the set of nonzero ones as a template mask (stencil_taps.cuh)
//   hbm:   n, s, w, e, c, then nw, ne, sw, se when any diagonal is nonzero
//          (:830-840); the hbm kernel checks that order and takes only the
//          coefficients, with the tap count (5 or 9) a template parameter
//
// No kernel writes the buffer it reads: every step or round goes out of
// place into the other of two ping-pong buffers.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "stencil_taps.cuh"

static bool torus_ok(int R, int C, int H, int W) {
  return R >= 1 && C >= 1 && H >= 1 && W >= 1 &&
         (long long)R * C * H * W <= (long long)INT_MAX;
}

// ---------------------------------------------------------------------------
// dma_ring: `steps` 5-point steps of the whole torus in ONE cooperative
// launch, folded: `fold` steps between two grid barriers.
// Bound: operations. A step is 9 separately rounded operations a cell
// (33.5 T/s on this card: a product and a sum one f32 instruction each);
// the bytes are 8 a cell a round of `fold` steps, from device memory where
// the torus passes the 50 MB L2 (at 8192^2 f32, 0.160 ms a round at
// 3.35 TB/s) and from L2 below it.
// Design: the folded ring of stencil_taps.cuh (namespace ring), a warp
// marching a 120-column strip's rows with its levels in registers, with
// the DMA ring's sum (ring::NSWEC). Every round reads and writes the whole
// torus: a torus small enough to keep in shared memory between rounds also
// stays in the 50 MB L2, and at 1024^2 a regime that kept each warp's cells
// in shared memory read within 1% of this one (PERF.md), so it was taken
// out. The host rule (ops.common.ring_plan) picks the fold and the grid.
// Terms: n, s, w, e, c in that order, zero coefficients included, every
// product and sum rounded on its own (the plain version's order).

// Three blocks an SM (168 registers a thread) with 16-byte rows; two with
// scalar loads, whose four column offsets spilled at 168. chip_smoke.py's
// build phase holds <1> to no spill and <4> to at most 16 bytes: the
// variants of <4> measured without that spill were slower (PERF.md).
template <int VEC>
__global__ void __launch_bounds__(ring::THREADS, VEC == 4 ? 3 : 2)
dma_ring_kernel(const ring::Args a) {
  ring::rounds<VEC, ring::NSWEC>(a);
}

// The blocks of the ring kernel an SM holds at once.
extern "C" int ts_dma_ring_occupancy(int vec, int* per_sm) {
  const void* k = vec == 4 ? (const void*)dma_ring_kernel<4> : (const void*)dma_ring_kernel<1>;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, ring::THREADS, 0);
}

// taps: ring_taps order (n, s, w, e, c); vec: 4 (16-byte rows: W % 4 == 0
// and the three buffers 16-byte aligned) or 1; fold 1..ring::F steps a
// round; blocks from ops.common.ring_plan, at most one cooperative wave.
extern "C" int ts_dma_ring(const float* in, float* buf0, float* buf1, int R,
                           int C, int H, int W, int steps, int ntaps,
                           const float* c, const int* dy, const int* dx, int vec,
                           int fold, int blocks, void* stream) {
  static const int kdy[5] = {-1, 1, 0, 0, 0};
  static const int kdx[5] = {0, 0, -1, 1, 0};
  if (!torus_ok(R, C, H, W) || ntaps != 5) return (int)cudaErrorInvalidValue;
  for (int u = 0; u < 5; ++u)
    if (dy[u] != kdy[u] || dx[u] != kdx[u]) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  int e = ts_dma_ring_occupancy(vec, &per_sm);
  if (e != cudaSuccess) return e;
  const ring::Args a{in, buf0, buf1, Torus{R, C, H, W}, steps, fold, c[0], c[1], c[2], c[3], c[4]};
  e = ring::check_launch(a, vec, blocks, per_sm);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)&a};
  const void* k = vec == 4 ? (const void*)dma_ring_kernel<4> : (const void*)dma_ring_kernel<1>;
  e = (int)cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(ring::THREADS), args, 0,
                                       (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dma_deep: one round of `k` substeps (one "k-deep exchange") of every
// rank. The k-deep ghost zone of a rank, corner blocks included, is its
// neighbour ranks' cores, so a round is k substeps of the torus the cores
// tile, and the kernel runs them over the torus as one grid. The wrapper
// launches one round per k substeps, the last one shallower when
// steps % k != 0 (halo_dma.py:341-342), and a round deeper than a launch
// holds (8 L substeps, 32) as launches of at most 32: on a torus the
// trapezoid's values are the per-step values, so the bits are the same.
// Bound: bytes at k = 8 (a round reads the torus and writes it once, 8
// bytes a cell: 0.1603 ms at 8192^2; the 7 separately rounded operations
// a cell a substep of Jacobi at 33.5 T/s take 0.1122), operations from
// k = 12 on.
// Design: the row march of stencil_taps.cuh, which keeps the redundant
// work of the substeps on one axis and every tap in registers. A block
// owns a strip of the torus's columns (the 256-column window less its
// apron) and a chunk of its rows, across rank edges; the levels are cut
// into stages of 4 levels a warp in registers (1 at depth 1), one barrier
// a row, one I/O warp doing every copy; the redundant work lies on the
// window's x apron (256 / 240 at k = 8) and the chunk's k rows at each
// end. Taps are a template mask (the paths' Jacobi and 8 points; any
// other set a runtime mask). The wrap is resolved once a lane for its
// columns (their ranks and offsets) and once a row (an incremental rank
// and row, RowAt): no tap, cell or loaded row divides. 16-byte groups where W % 4 == 0 and
// the buffers are 16-byte aligned; otherwise 4-byte columns whose offsets
// a table in shared memory holds. The host rule (ops.common.march_plan)
// picks L, the strip and the chunk.

struct Deep {
  const float* src;
  float* dst;
  Torus g;
  int j;             // substeps of the launch
  int rows;          // torus rows a chunk
  int width, apron;  // torus columns a strip; the window's apron (j rounded up to 4)
  int vec;           // 16-byte groups
  unsigned rmask;    // the taps of a runtime-mask launch
  float c[9];        // coefficient of tap position p = 3 (dy + 1) + dx + 1
};

template <int L, int MASK>
__global__ void __launch_bounds__((march::MAX_WARPS + 1) * 32)
dma_deep_kernel(const Deep p) {
  using namespace march;
  const int lane = threadIdx.x & 31;
  const Torus& g = p.g;
  const int TH = g.R * g.H, TW = g.C * g.W;
  const int oy0 = blockIdx.y * p.rows;  // the chunk's first row
  const int T = min(p.rows, TH - oy0) + 2 * p.j;
  const int xs = blockIdx.x * p.width, xe = min(xs + p.width, TW);  // the strip
  const int xw0 = xs - p.apron;         // window column 0
  // the lane's 8 columns: their offsets from a row's rank-column-0 start
  // (16-byte groups: the offsets of the two groups; 4-byte columns: all 8,
  // in the column table); which of them are the strip's
  int cb0 = 0, cb4 = 0;
  unsigned ocols = 0;
#pragma unroll
  for (int i = 0; i < CX; ++i) {
    const int w = lane * CX + i;
    int x = (xw0 + w) % TW;
    if (x < 0) x += TW;
    const int c = x / g.W;
    const int cb = c * g.H * g.W + (x - c * g.W);
    if (i == 0) cb0 = cb;
    if (i == 4) cb4 = cb;
    if (!p.vec) col_table()[w] = cb;
    if (w >= p.apron && xw0 + w < xe) ocols |= 1u << i;
  }
  __syncthreads();  // the column table
  RowAt in_row, out_row;
  in_row.at(g, oy0 - p.j);
  out_row.at(g, oy0);
  auto load = [&](int, float* slot) {  // rows come in order: in_row is row r
    if (p.vec) {
      cp16(group(slot, 0, lane), p.src + in_row.base + cb0);
      cp16(group(slot, 1, lane), p.src + in_row.base + cb4);
    } else {
      int cols[CX];
      take_cols(cols, lane);
#pragma unroll
      for (int i = 0; i < CX; ++i)
        cp4(group(slot, i / 4, lane) + i % 4, p.src + in_row.base + cols[i], true);
    }
    in_row.next(g);
  };
  auto zero = [](int, float(&)[CX]) {};
  auto store = [&](int, const float(&o)[CX]) {  // rows go out in order: out_row
    float* row = p.dst + out_row.base;
    if (p.vec) {
      if (ocols & 15)
        *reinterpret_cast<float4*>(row + cb0) = make_float4(o[0], o[1], o[2], o[3]);
      if (ocols >> 4 & 15)
        *reinterpret_cast<float4*>(row + cb4) = make_float4(o[4], o[5], o[6], o[7]);
    } else {
      int cols[CX];
      take_cols(cols, lane);
#pragma unroll
      for (int i = 0; i < CX; ++i)
        if (ocols >> i & 1) row[cols[i]] = o[i];
    }
    out_row.next(g);
  };
  run<L, ORDER_NSWE, MASK, false>(load, zero, store, p.c, p.rmask, T, p.j, 0, p.j);
}

template <int L, int MASK>
static int launch_deep(const Deep& p, dim3 grid, int warps, cudaStream_t s) {
  dma_deep_kernel<L, MASK>
      <<<grid, march::block_threads(warps), march::smem_bytes(warps), s>>>(p);
  return (int)cudaGetLastError();
}

template <int L, int MASK>
static int occupancy_deep(int warps, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, dma_deep_kernel<L, MASK>, march::block_threads(warps),
      march::smem_bytes(warps));
}

// The blocks of a launch of L levels a stage (1 or 4), tap mask `mask`
// (march::MASK_* or 0) and `warps` stages an SM holds at once.
extern "C" int ts_dma_deep_occupancy(int L, int mask, int warps, int* per_sm) {
  if (warps < 1 || warps > march::MAX_WARPS) return (int)cudaErrorInvalidValue;
  MARCH_DISPATCH(L, mask, occupancy_deep, warps, per_sm);
}

// One launch of j substeps of the torus, src -> dst (not in place).
// c9: the coefficients by tap position; L, mask, rows, width: the plan of
// ops.common.march_plan; vec: 16-byte groups (W % 4 == 0 and both bases
// 16-byte aligned) or 4-byte columns.
extern "C" int ts_dma_deep(const float* src, float* dst, int R, int C, int H, int W, int j,
                           int L, int mask, int rows, int width, int vec, const float* c9,
                           void* stream) {
  if (!torus_ok(R, C, H, W) || j < 1 || L < 1 || (j + L - 1) / L > march::MAX_WARPS ||
      rows < 1 || width < 4 || width % 4 != 0 || src == nullptr || dst == nullptr)
    return (int)cudaErrorInvalidValue;
  Deep p{};
  p.src = src; p.dst = dst; p.g = Torus{R, C, H, W};
  p.j = j; p.rows = rows; p.width = width; p.apron = (j + 3) / 4 * 4; p.vec = vec;
  for (int i = 0; i < 9; ++i) p.c[i] = c9[i];
  p.rmask = march::tap_mask(p.c);
  if (width + 2 * p.apron > march::WIN || (mask != 0 && (unsigned)mask != p.rmask))
    return (int)cudaErrorInvalidValue;
  if (vec && (W % 4 != 0 || (uintptr_t)src % 16 != 0 || (uintptr_t)dst % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long TH = (long long)R * H, TW = (long long)C * W;
  const long long strips = (TW + width - 1) / width, chunks = (TH + rows - 1) / rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  const int warps = (j + L - 1) / L;
  MARCH_DISPATCH(L, mask, launch_deep, p, dim3((unsigned)strips, (unsigned)chunks), warps,
                 (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// dma_hbm_step: ONE step of the torus per launch, out of place. The TPU
// kernel's carried column stages and band windows exist to avoid strided
// HBM access and are not part of the function, so nothing is carried.
// Bound: bytes. A step must read the torus and write it, 8 bytes a cell
// (at 8192^2 f32, 0.160 ms at 3.35 TB/s). Design, so that each input is
// read from device memory about once and no tap pays for the wrap:
//  - a block of HBM_WARPS warps owns a tile of 32 * VEC columns and
//    HBM_WARPS * HBM_RY rows of one rank's core; a lane owns VEC adjacent
//    columns (VEC = 4: one 16-byte load and store a row, where W % 4 == 0
//    and the base is 16-byte aligned; VEC = 1 otherwise) and HBM_RY rows
//    down them, held with the rows above and below as a register window of
//    HBM_RY + 2 rows, each loaded once;
//  - a row's left and right neighbours come from the adjacent lanes by
//    shuffles; only the warp's edge lanes load one more cell a row;
//  - the torus wrap is resolved once a loaded row (its rank and row) and
//    once an edge cell (the left or right rank), never a tap; a tile whose
//    one-cell halo lies inside the core (block-uniform test) takes a path
//    with no wrap test at all;
//  - NT (5 or 9) taps in hbm_taps order, n, s, w, e, c, then nw, ne, sw,
//    se, are a template parameter: the tap sum is straight-line code with
//    compile-time offsets, every product and sum rounded on its own.
constexpr int HBM_WARPS = 4;
constexpr int HBM_RY = 4;

struct HbmCoeffs {
  float c[9];
};

// The value at (row pointer rp of rank column c, column j), j in [-1, W]:
// one step past the core's side edge lands in rank column c -/+ 1 (lstep /
// rstep: the element distance from a row to the same row of that rank).
template <bool WRAP>
__device__ __forceinline__ float hbm_side(const float* rp, int j, int W, long long lstep,
                                          long long rstep) {
  if (WRAP) {
    if (j < 0) return rp[lstep + W - 1];
    if (j >= W) return rp[rstep];
  }
  return rp[j];
}

// Row i (in [-1, H]) of the window: VEC values from column x0, the left
// neighbour in w[0] and the right one in w[VEC + 1].
template <int VEC, bool WRAP>
__device__ __forceinline__ void hbm_load_row(float (&w)[VEC + 2], const float* __restrict__ src,
                                             const Torus& g, int r, int c, int i, int x0,
                                             int lane, long long lstep, long long rstep) {
  const float* rp;
  if (WRAP) {
    int rr = r;
    if (i < 0) {
      i += g.H;
      rr = r == 0 ? g.R - 1 : r - 1;
    } else if (i >= g.H) {
      i -= g.H;
      rr = r == g.R - 1 ? 0 : r + 1;
    }
    rp = src + ((size_t)(rr * g.C + c) * g.H + i) * g.W;
  } else {
    rp = src + ((size_t)(r * g.C + c) * g.H + i) * g.W;
  }
  const bool in = !WRAP || x0 < g.W;
  if (VEC == 4) {
    float4 v = in ? *reinterpret_cast<const float4*>(rp + x0) : make_float4(0.f, 0.f, 0.f, 0.f);
    w[1] = v.x;
    w[2] = v.y;
    w[3] = v.z;
    w[4] = v.w;
  } else {
    w[1] = in ? rp[x0] : 0.0f;
  }
  const float left = __shfl_up_sync(0xffffffffu, w[VEC], 1);
  const float right = __shfl_down_sync(0xffffffffu, w[1], 1);
  w[0] = lane > 0 ? left : (in ? hbm_side<WRAP>(rp, x0 - 1, g.W, lstep, rstep) : 0.0f);
  w[VEC + 1] = lane < 31 && (!WRAP || x0 + VEC < g.W)
                   ? right
                   : (in ? hbm_side<WRAP>(rp, x0 + VEC, g.W, lstep, rstep) : 0.0f);
}

template <int NT>
__device__ __forceinline__ float hbm_cell(const float* a, const float* m, const float* b,
                                          const HbmCoeffs& k) {
  // a, m, b: the rows above, at and below, each from the cell's left neighbour
  float v = __fmul_rn(k.c[0], a[1]);
  v = __fadd_rn(v, __fmul_rn(k.c[1], b[1]));
  v = __fadd_rn(v, __fmul_rn(k.c[2], m[0]));
  v = __fadd_rn(v, __fmul_rn(k.c[3], m[2]));
  v = __fadd_rn(v, __fmul_rn(k.c[4], m[1]));
  if (NT == 9) {
    v = __fadd_rn(v, __fmul_rn(k.c[5], a[0]));
    v = __fadd_rn(v, __fmul_rn(k.c[6], a[2]));
    v = __fadd_rn(v, __fmul_rn(k.c[7], b[0]));
    v = __fadd_rn(v, __fmul_rn(k.c[8], b[2]));
  }
  return v;
}

template <int NT, int VEC, bool WRAP>
__device__ __forceinline__ void hbm_tile(const float* __restrict__ src, float* __restrict__ dst,
                                         const Torus& g, const HbmCoeffs& k, int r, int c,
                                         int y0, int ye, int x0, int lane) {
  const long long core = (long long)g.H * g.W;
  const long long lstep = (c == 0 ? g.C - 1 : -1) * core;
  const long long rstep = (c == g.C - 1 ? -(g.C - 1) : 1) * core;
  float w[HBM_RY + 2][VEC + 2];
#pragma unroll
  for (int u = 0; u < HBM_RY + 2; ++u)
    if (y0 - 1 + u <= ye) hbm_load_row<VEC, WRAP>(w[u], src, g, r, c, y0 - 1 + u, x0, lane,
                                                  lstep, rstep);
  if (WRAP && x0 >= g.W) return;
  float* out = dst + ((size_t)(r * g.C + c) * g.H + y0) * g.W + x0;
#pragma unroll
  for (int u = 0; u < HBM_RY; ++u) {
    if (y0 + u >= ye) break;
    float o[VEC];
#pragma unroll
    for (int x = 0; x < VEC; ++x) o[x] = hbm_cell<NT>(w[u] + x, w[u + 1] + x, w[u + 2] + x, k);
    if (VEC == 4)
      *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
    else
      out[0] = o[0];
    out += g.W;
  }
}

// (a min-blocks bound of 8, 64 registers a thread: ptxas, left to the thread
// count alone, spilled the 9-point 16-byte instantiation's window)
template <int NT, int VEC>
__global__ void __launch_bounds__(32 * HBM_WARPS, 8)
dma_hbm_step_kernel(const float* __restrict__ src, float* __restrict__ dst, Torus g,
                    HbmCoeffs k) {
  const int b = blockIdx.z, r = b / g.C, c = b - r * g.C;
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tx0 = blockIdx.x * 32 * VEC, ty0 = blockIdx.y * HBM_WARPS * HBM_RY;
  const int x0 = tx0 + VEC * lane, y0 = ty0 + warp * HBM_RY;
  if (y0 >= g.H) return;  // a whole warp: no shuffle partner is lost
  const int ye = y0 + HBM_RY < g.H ? y0 + HBM_RY : g.H;
  // the block's one-cell halo inside the core: no wrap test anywhere
  const bool interior = ty0 >= 1 && ty0 + HBM_WARPS * HBM_RY < g.H && tx0 >= 1 &&
                        tx0 + 32 * VEC < g.W;
  if (interior)
    hbm_tile<NT, VEC, false>(src, dst, g, k, r, c, y0, ye, x0, lane);
  else
    hbm_tile<NT, VEC, true>(src, dst, g, k, r, c, y0, ye, x0, lane);
}

template <int NT>
static int launch_hbm(const float* src, float* dst, Torus g, const HbmCoeffs& k, int vec,
                      cudaStream_t s) {
  const dim3 block(32, HBM_WARPS);
  const unsigned gy = (g.H + HBM_WARPS * HBM_RY - 1) / (HBM_WARPS * HBM_RY);
  if (vec == 4) {
    dma_hbm_step_kernel<NT, 4><<<dim3((g.W + 127) / 128, gy, g.R * g.C), block, 0, s>>>(
        src, dst, g, k);
  } else {
    dma_hbm_step_kernel<NT, 1><<<dim3((g.W + 31) / 32, gy, g.R * g.C), block, 0, s>>>(
        src, dst, g, k);
  }
  return (int)cudaGetLastError();
}

// taps: hbm_taps order (5: n, s, w, e, c; 9: then nw, ne, sw, se); vec: 4
// (16-byte rows: W % 4 == 0 and both bases 16-byte aligned) or 1.
extern "C" int ts_dma_hbm_step(const float* src, float* dst, int R, int C,
                               int H, int W, int ntaps, const float* c,
                               const int* dy, const int* dx, int vec, void* stream) {
  static const int kdy[9] = {-1, 1, 0, 0, 0, -1, -1, 1, 1};
  static const int kdx[9] = {0, 0, -1, 1, 0, -1, 1, -1, 1};
  if (!torus_ok(R, C, H, W) || R * C > 65535 || (ntaps != 5 && ntaps != 9))
    return (int)cudaErrorInvalidValue;
  HbmCoeffs k{};
  for (int u = 0; u < ntaps; ++u) {
    if (dy[u] != kdy[u] || dx[u] != kdx[u]) return (int)cudaErrorInvalidValue;
    k.c[u] = c[u];
  }
  if (vec != 1 && vec != 4) return (int)cudaErrorInvalidValue;
  if (vec == 4 && (W % 4 != 0 || (uintptr_t)src % 16 != 0 || (uintptr_t)dst % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const Torus g{R, C, H, W};
  const cudaStream_t s = (cudaStream_t)stream;
  return ntaps == 5 ? launch_hbm<5>(src, dst, g, k, vec, s) : launch_hbm<9>(src, dst, g, k, vec, s);
}
