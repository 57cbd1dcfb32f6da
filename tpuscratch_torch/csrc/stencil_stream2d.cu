// Hand-written Hopper (sm_90a) kernel for the streamed 2D stencil.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/stencil_stream.py:
//   stream2d_kernel <- nine_point_streamed_2d (:1067; _stream2d_kernel :902,
//                      _substep2d :839, _substep2d_gstrip :882)
//
// What it computes: `K` 5- or 9-point substeps of every rank's (H, W) core
// in one pass, over the stacked ranks (blockIdx.z). The TPU kernel
// streams the core through VMEM in row bands, splices the (K, W) ghost-row
// slabs in at the grid ends, and either wraps x in-kernel (wrap mode) or
// ages a [gr | gl] ghost-column strip beside each band (ghost mode), whose
// seam garbage never reaches the core (stencil_stream.py:814-835). All of
// that computes, for every core cell, the K-substep pyramid over the
// extended grid
//   rows [-K, H + K): top slab | core | bottom slab,
//   cols [-K, W + K): wrap mode: column c mod W; ghost mode: gl | . | gr,
// with the corner blocks at the ends of gl/gr. Open ends (per-rank flags
// [top, bottom, left, right]) keep the rings that are still ghosts at zero
// after each substep but the pass's last, the rule of
// stencil_stream.py:966-1002: y ends in both modes, x ends in ghost mode.
//
// Terms: the TPU kernel's weight grid in row-major order (nw, n, ne, w, c,
// e, sw, s, se), zero weights skipped, every product and sum rounded on
// its own (bit-equal to the plain version).
//
// Bound: operations. A substep is 2 * taps - 1 separately rounded f32
// operations a cell (7 for Jacobi), at 33.5 T/s on this card (a product
// and a sum are one instruction each: half the FMA rate); at K = 16 that
// exceeds the bytes (read the core and slabs once, write the core once):
// 0.2244 ms at 8192^2 on 4x4 against 0.1628 ms of bytes.
//
// Design: the row march of stencil_taps.cuh, which keeps the pyramid's
// redundant work on one axis and every tap in registers. A block owns a
// strip of output columns (the 256-column window less its apron) and a
// chunk of output rows of one rank and marches down the chunk's window
// rows; its substep levels are cut into stages of 4 levels a warp, each
// stage's levels in registers, the stages handing rows over through shared
// memory, one barrier a row, and one I/O warp doing every copy from and to
// device memory. The redundant work of the pyramid lies on the window's x
// apron (256 / (256 - 2K), at K = 16: 1.14) and on the chunk's K rows at
// each end. Taps are a template mask (the paths' Jacobi and 8 points;
// any other set a runtime mask). A block whose window lies inside the
// rows' main source loads each row as two 16-byte groups a lane (W % 4 ==
// 0 and aligned bases); any other block resolves once where each window column
// comes from (the core, a slab, gl, gr, a wrapped column, or nowhere) into
// a table in shared memory and loads 4 bytes a column; a row's source is
// resolved once a row, and no division runs in the march. Open ends are a
// test a level row (y ends) and a lane mask (x ends), in a variant of the
// kernel the host runs only where a rank may have one (ops.stencil_stream
// .may_open): one kernel with both ran with ~60 registers a thread more.
//
// A pass deeper than 8 L substeps (32) is chained: a launch of j substeps
// writes the dense grid [-go, H + go) x [-go, W + go), go the rings still
// to be consumed, and the next launch reads it (gi >= 0) instead of the
// core, the slabs and the ghost columns.
// The host rule (ops.common.march_plan) picks L, the strip and the chunk.

#include <cuda_runtime.h>
#include <cstdint>

#include "stencil_taps.cuh"

struct Stream2 {
  const float* core;  // slab mode: (nb, H, W) cores; dense mode: (nb, H + 2gi, W + 2gi)
  const float* top;   // (nb, K, W): rows [-K, 0)
  const float* bot;   // (nb, K, W): rows [H, H + K)
  const float* gl;    // (nb, H + 2K, K): columns [-K, 0) of rows [-K, H + K), ghost mode
  const float* gr;    // (nb, H + 2K, K): columns [W, W + K)
  const int* flags;   // (nb, 4): open [top, bottom, left, right]
  float* out;         // (nb, H + 2go, W + 2go)
  int H, W;
  int K;              // substeps of the pass: the slabs' depth
  int done, j;        // substeps before this launch, and in it
  int ghost;          // ghost-column mode (x ends may be open)
  int gi, go;         // dense input apron (-1: slabs), output apron
  int rows;           // output rows a chunk
  int width, apron;   // output columns a strip; the window's apron (j rounded up to 4)
  int vin, vout;      // 16-byte loads / stores allowed (row strides and bases)
  unsigned rmask;     // the taps of a runtime-mask launch
  float c[9];         // coefficient of tap position p = 3 (dy + 1) + dx + 1
};

template <int L, int MASK, bool ZERO>
__global__ void __launch_bounds__((march::MAX_WARPS + 1) * 32)
stream2d_kernel(const Stream2 p) {
  using namespace march;
  const int lane = threadIdx.x & 31;
  const size_t rank = blockIdx.z;
  const int H = p.H, W = p.W, K = p.K, gi = p.gi, go = p.go;
  const bool dense = gi >= 0;
  const int DY = H + 2 * gi, DX = W + 2 * gi;  // the dense input grid
  const int OY = H + 2 * go, OX = W + 2 * go;  // the output grid
  const int cy0 = blockIdx.y * p.rows;         // the chunk's first output row, from -go
  const int T = min(p.rows, OY - cy0) + 2 * p.j;
  const int ywin0 = cy0 - go - p.j;            // window row 0, in core coordinates
  const int xw0 = blockIdx.x * p.width - go - p.apron;  // window column 0
  const int* f = p.flags + rank * 4;
  const bool open_t = f[0], open_b = f[1];
  const bool open_l = p.ghost && f[2], open_r = p.ghost && f[3];
  const bool gx = !dense && p.ghost;
  // (rows are addressed from the launch's base pointers each time, which
  // keeps no 64-bit pointer of the block live through the march)

  // Columns: in a block whose whole window is 16-byte groups of the rows'
  // main source (the interior strips), lane l's columns start at xf + 8 l;
  // any other block resolves each window column once into the column
  // table: its kind (0 none, 1 the row's main source, 2 gl, 3 gr) in bits
  // 29-30 and its offset in that row below them.
  const int xf = xw0 + (dense ? gi : 0);
  const bool fast = p.vin && xf >= 0 && xf + WIN <= (dense ? DX : W);
  unsigned zcols = 0, ocols = 0;
#pragma unroll
  for (int i = 0; i < CX; ++i) {
    const int w = lane * CX + i, x = xw0 + w;
    if (!fast) {
      int k = 1, o;
      if (dense) {
        o = x + gi;
        if (o < 0 || o >= DX) k = 0;
      } else if (!p.ghost) {
        o = x % W;
        if (o < 0) o += W;
      } else if (x >= 0 && x < W) {
        o = x;
      } else if (x >= -K && x < 0) {
        k = 2;
        o = x + K;
      } else if (x >= W && x < W + K) {
        k = 3;
        o = x - W;
      } else {
        k = 0;
        o = 0;
      }
      col_table()[w] = k << 29 | o;
    }
    if ((open_l && x < 0) || (open_r && x >= W)) zcols |= 1u << i;
    if (w >= p.apron && w < p.apron + p.width && x + go < OX) ocols |= 1u << i;
  }
  __syncthreads();  // the column table

  auto load = [&](int r, float* slot) {
    const int y = ywin0 + r;
    const float *m = nullptr, *ml = nullptr, *mr = nullptr;
    if (dense) {
      if (y + gi >= 0 && y + gi < DY) m = p.core + ((size_t)rank * DY + y + gi) * DX;
    } else if (y >= -K && y < H + K) {
      m = y < 0 ? p.top + ((size_t)rank * K + y + K) * W
          : y < H ? p.core + ((size_t)rank * H + y) * W : p.bot + ((size_t)rank * K + y - H) * W;
      if (gx) {
        ml = p.gl + ((size_t)rank * (H + 2 * K) + y + K) * K;
        mr = p.gr + ((size_t)rank * (H + 2 * K) + y + K) * K;
      }
    }
    if (fast && m) {
      cp16(group(slot, 0, lane), m + xf + lane * CX);
      cp16(group(slot, 1, lane), m + xf + lane * CX + 4);
      return;
    }
    int cols[CX];
    take_cols(cols, lane);
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int k = cols[i] >> 29;
      const float* src = k == 1 ? m : k == 2 ? ml : k == 3 ? mr : nullptr;
      cp4(group(slot, i / 4, lane) + i % 4,
          src ? src + (cols[i] & 0x1fffffff) : reinterpret_cast<const float*>(p.flags),
          src != nullptr);
    }
  };
  auto zero = [&](int q, float(&o)[CX]) {
    const int y = ywin0 + q;
    if ((open_t && y < 0) || (open_b && y >= H)) {
#pragma unroll
      for (int x = 0; x < CX; ++x) o[x] = 0.0f;
    } else if (zcols) {
#pragma unroll
      for (int x = 0; x < CX; ++x)
        if (zcols >> x & 1) o[x] = 0.0f;
    }
  };
  auto store = [&](int q, const float(&o)[CX]) {
    float* row = p.out + ((size_t)rank * OY + ywin0 + q + go) * OX + (xw0 + go + lane * CX);
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (p.vout && (ocols >> 4 * g & 15) == 15) {
        *reinterpret_cast<float4*>(row + 4 * g) =
            make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ocols >> (4 * g + e) & 1) row[4 * g + e] = o[4 * g + e];
      }
    }
  };
  run<L, ORDER_GRID, MASK, ZERO>(load, zero, store, p.c, p.rmask, T, p.j, p.done, K);
}

template <int L, int MASK, bool ZERO>
static int launch2(const Stream2& p, dim3 grid, int warps, cudaStream_t s) {
  stream2d_kernel<L, MASK, ZERO>
      <<<grid, march::block_threads(warps), march::smem_bytes(warps), s>>>(p);
  return (int)cudaGetLastError();
}

template <int L, int MASK, bool ZERO>
static int occupancy2(int warps, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stream2d_kernel<L, MASK, ZERO>, march::block_threads(warps),
      march::smem_bytes(warps));
}

// The two variants of the kernel: with the open ends' zeroing, for a pass
// whose ranks may have one, and without it (a register window of the size
// of dma_deep_kernel's, where both in one kernel took some 60 registers
// more a thread)
template <int L, int MASK>
static int launch2_open(const Stream2& p, dim3 grid, int warps, cudaStream_t s) {
  return launch2<L, MASK, true>(p, grid, warps, s);
}
template <int L, int MASK>
static int launch2_closed(const Stream2& p, dim3 grid, int warps, cudaStream_t s) {
  return launch2<L, MASK, false>(p, grid, warps, s);
}
template <int L, int MASK>
static int occupancy2_open(int warps, int* per_sm) {
  return occupancy2<L, MASK, true>(warps, per_sm);
}
template <int L, int MASK>
static int occupancy2_closed(int warps, int* per_sm) {
  return occupancy2<L, MASK, false>(warps, per_sm);
}

// The blocks of a launch of L levels a stage (1 or 4), tap mask `mask`
// (march::MASK_* or 0), `warps` stages and open ends (`open`) or none an
// SM holds at once.
extern "C" int ts_stream2d_occupancy(int L, int mask, int warps, int open, int* per_sm) {
  if (warps < 1 || warps > march::MAX_WARPS) return (int)cudaErrorInvalidValue;
  if (open) MARCH_DISPATCH(L, mask, occupancy2_open, warps, per_sm);
  MARCH_DISPATCH(L, mask, occupancy2_closed, warps, per_sm);
}

// One launch of j substeps. `ints` = {H, W, K, done, j, ghost, gi, L,
// mask, rows, width, vin, vout, open} (ops.stencil_stream._launch, the
// plan of ops.common.march_plan; open: any rank may have an open end, so
// the variant that zeroes them runs); c9: the coefficients by tap
// position. gi >= 0
// reads the dense (H + 2gi, W + 2gi) grids in `core` (top, bot, gl, gr
// unused); the output is the dense (H + 2go, W + 2go) grid, go = K - done
// - j (the core itself at the pass's last launch).
extern "C" int ts_stream2d(const float* core, const float* top, const float* bot,
                           const float* gl, const float* gr, const int* flags, float* out,
                           int nb, const int* ints, const float* c9, void* stream) {
  Stream2 p{};
  p.core = core; p.top = top; p.bot = bot; p.gl = gl; p.gr = gr;
  p.flags = flags; p.out = out;
  p.H = ints[0]; p.W = ints[1]; p.K = ints[2]; p.done = ints[3]; p.j = ints[4];
  p.ghost = ints[5]; p.gi = ints[6];
  const int L = ints[7], mask = ints[8];
  p.rows = ints[9]; p.width = ints[10]; p.vin = ints[11]; p.vout = ints[12];
  const int open = ints[13];
  p.go = p.K - p.done - p.j;
  p.apron = (p.j + 3) / 4 * 4;
  for (int i = 0; i < 9; ++i) p.c[i] = c9[i];
  p.rmask = march::tap_mask(p.c);
  const int warps = (p.j + L - 1) / (L > 0 ? L : 1);
  if (nb < 1 || nb > 65535 || p.H < 1 || p.W < 1 || p.K < 1 || p.j < 1 || p.done < 0 ||
      p.go < 0 || L < 1 || warps > march::MAX_WARPS || p.rows < 1 || p.width < 4 ||
      p.width % 4 != 0 || p.width + 2 * p.apron > march::WIN ||
      (mask != 0 && (unsigned)mask != p.rmask) || core == nullptr || flags == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool dense = p.gi >= 0;
  if (dense ? p.gi != p.go + p.j
            : (p.done != 0 || top == nullptr || bot == nullptr ||
               (p.ghost && (gl == nullptr || gr == nullptr))))
    return (int)cudaErrorInvalidValue;
  // 16-byte rows: strides of whole groups and 16-byte aligned bases
  const int IX = dense ? p.W + 2 * p.gi : p.W, OX = p.W + 2 * p.go;
  if (p.vin && (IX % 4 != 0 || (uintptr_t)core % 16 != 0 ||
                (!dense && ((uintptr_t)top % 16 != 0 || (uintptr_t)bot % 16 != 0))))
    return (int)cudaErrorMisalignedAddress;
  if (p.vout && (OX % 4 != 0 || (uintptr_t)out % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long OY = p.H + 2LL * p.go;
  const long long strips = (OX + p.width - 1) / p.width, chunks = (OY + p.rows - 1) / p.rows;
  if (strips > INT32_MAX || chunks > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)strips, (unsigned)chunks, (unsigned)nb);
  if (open) MARCH_DISPATCH(L, mask, launch2_open, p, grid, warps, (cudaStream_t)stream);
  MARCH_DISPATCH(L, mask, launch2_closed, p, grid, warps, (cudaStream_t)stream);
}
