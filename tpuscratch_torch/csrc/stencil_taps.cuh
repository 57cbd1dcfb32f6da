// Shared pieces of the 2D and 3D stencil kernels: the C entry points every
// library of them exports, the row march of the streamed, DMA-halo and
// deep-trapezoid 2D kernels (stencil_stream2d.cu, halo_dma.cu,
// stencil2d.cu), and the folded ring of the DMA ring and resident kernels
// (halo_dma.cu, stencil2d.cu).
//
// A 3x3 stencil is a list of taps in the order its reference sums them:
//   v = c[p0]*a(p0) + c[p1]*a(p1) + ...
// left to right, every product and sum rounded on its own (__fmul_rn /
// __fadd_rn are never contracted into FMAs), so a kernel agrees bit for
// bit with its plain torch version. The taps a kernel sums are the
// nonzero coefficients (the TPU kernels skip zero coefficients
// statically); the set is a compile-time mask for the sets the paths use
// and a runtime mask for any other.

#pragma once

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cstdint>

// The C entry points every library of these kernels exports.
extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

extern "C" int ts_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// ---------------------------------------------------------------------------
// The row march: j substeps of a 3x3 stencil over a block's window of
// march::WIN columns and T rows, marching down the rows.
//
//  - A lane owns march::CX = 8 adjacent window columns; a warp's row is
//    the whole window. West and east neighbours of a lane's end columns
//    come from the lanes beside it by one shuffle each; the window's two
//    edge columns read garbage, so a level is valid one column further in
//    on each side than the level below it, and the output strip is the
//    window less an apron of j columns a side (rounded up to 4, so that a
//    lane's columns stay 16-byte groups).
//  - The substep levels are cut into stages of L levels (4; 1 for a single
//    substep), one warp a stage. A warp takes the rows of its input level
//    from shared memory and keeps the last three rows of each of its
//    levels but the last in registers, indexed by the march step that
//    made them (t % 3, the step loop unrolled by 3, so rows rotate by
//    name): at step t its local level l computes row rho - l from level
//    l - 1's rows made at steps t - 2, t - 1 and t, where rho = t - D is
//    the newest row of its input level. North and south taps are
//    registers, west and east the lane's own columns or the shuffled
//    neighbours.
//  - One I/O warp beside the stages copies the window's rows into a
//    shared-memory ring by cp.async, march::AHEAD - 1 rows ahead, and
//    waits for the rows the next step reads before the step's barrier; it
//    also writes the output rows, one step after the last stage puts them
//    in shared memory. The stages never touch device memory, and no
//    stage waits on a copy. Stage g hands its last level's rows to stage
//    g + 1 through a four-row ring in shared memory; stage g + 1 takes a
//    row one step after it is made, so D grows by L + 1 a stage, and one
//    __syncthreads a step orders every hand-over.
//  - The last stage's level j is the output row. A level skips the rows
//    outside its valid range [s, T - s) (a test a warp a step); no cell
//    tests anything, and no division runs in the march. Open ends are
//    zeroed only in the kernels of passes that may have one (a template
//    parameter of the march).
// Shared rows are stored as two 16-byte groups a lane, group-major (the
// lane's group q at (q * 32 + lane) * 4), so a warp's 16-byte reads and
// writes are free of bank conflicts. Before the rows, a table of WIN ints
// holds each window column's source for the blocks that load column by
// column.
namespace march {

constexpr int CX = 8;           // adjacent columns a lane
constexpr int WIN = 32 * CX;    // window columns a strip
constexpr int MAX_WARPS = 8;    // stages a block at most: 8 * L substeps a launch
constexpr int AHEAD = 6;        // input rows in flight, the one being read included
constexpr int RING = 8;         // the input ring's rows: AHEAD and the two rows before
constexpr int HAND = 4;         // a hand-over ring's rows
constexpr unsigned FULL = 0xffffffffu;

extern __shared__ __align__(16) float march_smem[];

// Tap positions p = 3 * (dy + 1) + (dx + 1): 0 nw, 1 n, 2 ne, 3 w, 4 c,
// 5 e, 6 sw, 7 s, 8 se. Orders in which a reference sums them:
enum { ORDER_GRID = 0,   // the weight grid row by row (stencil_stream2d.cu)
       ORDER_NSWE = 1 }; // n, s, w, e, nw, ne, sw, se, c (halo_dma.cu)

// Tap sets with an instantiation of their own: the paths' Jacobi and
// 9-point sets; 0: any other set, summed under a runtime mask. (An
// instantiation of n, w, c, e, s spilled 8 bytes in the streamed kernel
// of 4 levels a stage, so that set takes the runtime mask.)
constexpr int MASK_JACOBI = 0x0AA;  // n, w, e, s
constexpr int MASK_EIGHT = 0x1EF;   // all but the centre
constexpr int MASK_DIAG = 0x145;    // nw, ne, sw, se

template <int ORD>
__host__ __device__ constexpr int tap_pos(int i) {
  return ORD == ORDER_GRID ? i
         : i == 0 ? 1 : i == 1 ? 7 : i == 2 ? 3 : i == 3 ? 5
         : i == 4 ? 0 : i == 5 ? 2 : i == 6 ? 6 : i == 7 ? 8 : 4;
}

// The 9-bit mask of the nonzero coefficients c[p].
inline unsigned tap_mask(const float* c) {
  unsigned m = 0;
  for (int p = 0; p < 9; ++p)
    if (c[p] != 0.0f) m |= 1u << p;
  return m;
}

// Shared memory of a block of `warps` stages: the column table, the input
// ring, a hand-over ring a stage boundary and the two output rows.
inline size_t smem_bytes(int warps) {
  return (size_t)(WIN + (RING + HAND * (warps - 1) + 2) * WIN) * sizeof(float);
}

// Threads of a block of `warps` stages: a warp a stage and the I/O warp.
inline int block_threads(int warps) { return (warps + 1) * 32; }

// The column table: one int a window column (the kernel's encoding).
__device__ __forceinline__ int* col_table() { return reinterpret_cast<int*>(march_smem); }

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// 16 bytes, or zeros where `fill` is false (src need only be a global address)
__device__ __forceinline__ void cp16(float* dst, const float* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 16 : 0));
}

// 4 bytes, or a zero where `fill` is false (src need only be a global address)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The lane's slot of group q (0 or 1) in a shared row
__device__ __forceinline__ float* group(float* row, int q, int lane) {
  return row + (q * 32 + lane) * 4;
}

// The lane's 8 columns of a shared row
__device__ __forceinline__ void take_row(float (&r)[CX], float* row, int lane) {
  const float4 a = *reinterpret_cast<const float4*>(group(row, 0, lane));
  const float4 b = *reinterpret_cast<const float4*>(group(row, 1, lane));
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// The lane's 8 columns of a window column table
__device__ __forceinline__ void take_cols(int (&r)[CX], int lane) {
  const int4 a = *reinterpret_cast<const int4*>(col_table() + lane * CX);
  const int4 b = *reinterpret_cast<const int4*>(col_table() + lane * CX + 4);
  r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
}

// The 8 sums of a level row from the rows N, C, S of the level below, in
// the order ORD, over the taps of MASK (or of `rmask` where MASK is 0);
// the neighbours beside the lane's columns by shuffles.
template <int ORD, int MASK>
__device__ __forceinline__ void tap_row(float (&o)[CX], const float (&N)[CX],
                                        const float (&C)[CX], const float (&S)[CX],
                                        const float (&c)[9], unsigned rmask) {
  constexpr bool DIAG = MASK == 0 || (MASK & MASK_DIAG) != 0;
  float side[3][2];  // [row][west, east]
  side[1][0] = __shfl_up_sync(FULL, C[CX - 1], 1);
  side[1][1] = __shfl_down_sync(FULL, C[0], 1);
  if (DIAG) {
    side[0][0] = __shfl_up_sync(FULL, N[CX - 1], 1);
    side[0][1] = __shfl_down_sync(FULL, N[0], 1);
    side[2][0] = __shfl_up_sync(FULL, S[CX - 1], 1);
    side[2][1] = __shfl_down_sync(FULL, S[0], 1);
  }
#pragma unroll
  for (int x = 0; x < CX; ++x) {
    float v = 0.0f;
    bool first = true;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const int p = tap_pos<ORD>(i);
      if (MASK != 0 ? !((MASK >> p) & 1) : !((rmask >> p) & 1)) continue;
      const int r = p / 3, xx = x + p % 3 - 1, xi = xx < 0 ? 0 : xx >= CX ? CX - 1 : xx;
      const float a = xx < 0 ? side[r][0] : xx >= CX ? side[r][1]
                      : r == 0 ? N[xi] : r == 1 ? C[xi] : S[xi];
      const float term = __fmul_rn(c[p], a);
      v = first ? term : __fadd_rn(v, term);
      first = false;
    }
    o[x] = v;
  }
}

// The march of one block: its compute warps (the stages) and, after them,
// one I/O warp. `load(r, slot)` copies window row r (in order, r = 0, 1,
// ...) into the lane's groups of the shared row `slot` by cp.async;
// `store(q, o)` writes level j's row q (in order, q = j, j + 1, ...);
// both run in the I/O warp only. `zero(q, o)` applies the open ends to
// level row q of a substep that is not the pass's last (ZERO: the pass
// may have open ends). `done` and `K`: substeps of the pass before this
// launch and in all.
template <int L, int ORD, int MASK, bool ZERO, class Load, class Zero, class Store>
__device__ __forceinline__ void run(Load&& load, Zero&& zero, Store&& store, const float (&c)[9],
                                    unsigned rmask, int T, int j, int done, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NS = (blockDim.x >> 5) - 1;       // compute warps; warp NS is the I/O warp
  float* const ring = march_smem + WIN;       // RING input rows, row r in slot r % RING
  float* const hand = ring + RING * WIN;      // HAND rows a stage boundary, by step
  float* const outr = hand + HAND * (NS - 1) * WIN;  // 2 output rows, by step
  const int steps = T + NS - 1;
  // the last stage: its level j's row at step t is t - qlag
  const int qlag = (NS - 1) * (L + 1) + (j - (NS - 1) * L);
  if (warp == NS) {
    // The I/O warp: row t + AHEAD - 1 goes in flight at step t, and rows up
    // to t + 1 have landed before the step's barrier (so a compute warp
    // reads only rows that are in); the row level j made at step t - 1
    // goes out at step t, after the barrier that made it visible.
    auto put = [&](int t) {
      const int q = t - qlag;
      if (q >= j && q < T - j) {
        float o[CX];
        take_row(o, outr + (t & 1) * WIN, lane);
        store(q, o);
      }
    };
#pragma unroll
    for (int r = 0; r < AHEAD - 1; ++r) {
      if (r < T) load(r, ring + r * WIN);
      cp_commit();
    }
    cp_wait<AHEAD - 2>();
    __syncthreads();
#pragma unroll 1
    for (int t = 0; t < steps; ++t) {
      if (t + AHEAD - 1 < T) load(t + AHEAD - 1, ring + ((t + AHEAD - 1) & (RING - 1)) * WIN);
      cp_commit();
      cp_wait<AHEAD - 2>();
      if (t >= 1) put(t - 1);
      __syncthreads();
    }
    __syncthreads();
    put(steps - 1);
    cp_wait<0>();
    return;
  }
  const int s0 = warp * L;                    // the warp's input level
  const int D = warp * (L + 1);               // its newest row at step t is t - D
  const int lj = min(L, j - s0);              // the warp's levels
  // the input level's rows: the input ring (row r in slot r % RING) or the
  // hand-over ring of the stage before (the row made at step u in slot u % HAND)
  float* const in = warp == 0 ? ring : hand + (warp - 1) * HAND * WIN;
  const int wrap = warp == 0 ? RING - 1 : HAND - 1;
  const int back = warp == 0 ? 2 : 3;         // the slot of row rho - 2 at step t: t - back
  // rows[l - 1]: local level l, for l < L (level L goes out)
  float rows[L > 1 ? L - 1 : 1][3][CX];
  __syncthreads();
#pragma unroll 1
  for (int t0 = 0; t0 < steps; t0 += 3) {
#pragma unroll
    for (int ph = 0; ph < 3; ++ph) {
      const int t = t0 + ph;
      if (t >= steps) break;
      const int rho = t - D;
      // local level l computes row rho - l, in range while l <= lmax
      const int lmax = rho < T - s0 ? min(lj, (rho - s0) >> 1) : 0;
#pragma unroll
      for (int l = 1; l <= L; ++l) {
        if (l > lmax) break;  // so are the levels above it this step
        const int s = s0 + l, q = rho - l;
        float o[CX];
        if (l == 1) {
          float N[CX], C[CX], S[CX];
          take_row(N, in + ((t - back) & wrap) * WIN, lane);
          take_row(C, in + ((t - back + 1) & wrap) * WIN, lane);
          take_row(S, in + ((t - back + 2) & wrap) * WIN, lane);
          tap_row<ORD, MASK>(o, N, C, S, c, rmask);
        } else {
          const int lp = l >= 2 ? l - 2 : 0;
          tap_row<ORD, MASK>(o, rows[lp][(ph + 1) % 3], rows[lp][(ph + 2) % 3], rows[lp][ph],
                             c, rmask);
        }
        if (ZERO && done + s < K) zero(q, o);
        if (s < j && l < L) {
#pragma unroll
          for (int x = 0; x < CX; ++x) rows[l - 1][ph][x] = o[x];
        } else {  // to the next stage, or level j's row to the I/O warp
          float* h = s == j ? outr + (t & 1) * WIN : hand + (warp * HAND + (t & (HAND - 1))) * WIN;
          *reinterpret_cast<float4*>(group(h, 0, lane)) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float4*>(group(h, 1, lane)) = make_float4(o[4], o[5], o[6], o[7]);
        }
      }
      __syncthreads();
    }
  }
  __syncthreads();
}

// Dispatch on (levels a stage: 1 or 4, tap mask) to FN<L, MASK>(args...).
#define MARCH_DISPATCH(L, MASK, FN, ...)                                        \
  do {                                                                          \
    const int l_ = (L), m_ = (MASK);                                            \
    if (l_ != 1 && l_ != 4) return (int)cudaErrorInvalidValue;                  \
    switch (m_) {                                                               \
      case march::MASK_JACOBI:                                                  \
        return l_ == 1 ? FN<1, march::MASK_JACOBI>(__VA_ARGS__)                 \
                       : FN<4, march::MASK_JACOBI>(__VA_ARGS__);                \
      case march::MASK_EIGHT:                                                   \
        return l_ == 1 ? FN<1, march::MASK_EIGHT>(__VA_ARGS__)                  \
                       : FN<4, march::MASK_EIGHT>(__VA_ARGS__);                 \
      case 0:                                                                   \
        return l_ == 1 ? FN<1, 0>(__VA_ARGS__) : FN<4, 0>(__VA_ARGS__);         \
    }                                                                           \
    return (int)cudaErrorInvalidValue;                                          \
  } while (0)

}  // namespace march

// ---------------------------------------------------------------------------
// A torus of R x C ranks' (H, W) cores, stacked rank by rank: the grid of
// (R*H, C*W) cells they tile (one rank for a single grid).
struct Torus {
  int R, C, H, W;  // mesh dims, core dims
};

// An incremental torus row: its row `i` in its rank, and the element
// offset of its first cell in rank column 0.
struct RowAt {
  int i, base;
  __device__ __forceinline__ void at(const Torus& g, int y) {
    const int TH = g.R * g.H;
    y %= TH;
    if (y < 0) y += TH;
    const int r = y / g.H;
    i = y - r * g.H;
    base = (r * g.C * g.H + i) * g.W;
  }
  __device__ __forceinline__ void next(const Torus& g) {
    base += g.W;
    if (++i == g.H) {  // the next rank row's first row, or the torus's
      i = 0;
      base += (g.C - 1) * g.H * g.W;
      if (base == g.R * g.C * g.H * g.W) base = 0;
    }
  }
};

// ---------------------------------------------------------------------------
// The folded ring: `steps` 5-point steps of a whole torus in ONE
// cooperative launch, `fold` steps between two grid barriers
// (dma_ring_kernel, resident_periodic_kernel).
//  - The torus is cut into strips of ring::OUT columns; a warp's window is
//    ring::WIN = OUT + 2 * F columns of one strip, 4 adjacent columns a lane
//    (one 16-byte load or store a row where W % 4 == 0). The strips' rows,
//    strip after strip, are split evenly over the warps of the persistent
//    grid; a warp marches its rows, each with a `fold`-row apron above and
//    below, the same rows every round.
//  - Substep level s keeps the last three rows it computed in registers
//    and computes row t - s from level s - 1's rows at march step t, so
//    all `fold` levels advance one row a step with no barrier and no
//    shared memory: the north and south taps are registers, west and east
//    the lane's own columns or one shuffle each from the lanes beside it.
//    The step loop is unrolled by 3 so the rows rotate by name.
//  - Level `fold` is the round's result. A round reads the other buffer,
//    a trapezoid of `fold` steps (on a torus its values are the per-step
//    values), so the steps cost ceil(steps / fold) grid barriers and the
//    torus crosses memory once a round instead of once a step.
//  - The wrap is resolved once a loaded row (an incremental rank and row)
//    and once a warp for its columns; a row is loaded ring::AHEAD steps
//    before its use, into a ring of registers; no division runs in the
//    march loop.
//  - Folds of at most F = 4: the register window of 6- and 8-step folds
//    spilled, at 168 registers (3 blocks an SM) and at 255 alike, which
//    made them slower than 4-step folds (PERF.md).
// A cell's sum is a template parameter, each the order of a reference:
//   NSWEC: n, s, w, e, c, zero coefficients included (the DMA ring);
//   NSWE:  n, s, w, e (the resident kernel without a centre term);
//   SYM:   cn * ((n + s) + (w + e)) (the resident kernel's symmetric Jacobi);
// every product and sum rounded on its own. The host rule
// (ops.common.ring_plan) picks the fold and the grid.
namespace ring {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int F = 4;                  // a window's side apron: the deepest fold
constexpr int WIN = 128;              // window columns, 4 a lane
constexpr int OUT = WIN - 2 * F;      // output columns a strip
constexpr int AHEAD = 3;              // rows in flight into registers

enum { NSWEC = 0, NSWE = 1, SYM = 2 };

struct Args {
  const float* in;
  float* buf0;
  float* buf1;
  Torus g;
  int steps, fold;
  float cn, cs, cw, ce, cc;
};

template <int COMB>
__device__ __forceinline__ float combine(const Args& a, float n, float s, float w, float e,
                                         float c) {
  if (COMB == SYM) return __fmul_rn(a.cn, __fadd_rn(__fadd_rn(n, s), __fadd_rn(w, e)));
  float v = __fmul_rn(a.cn, n);
  v = __fadd_rn(v, __fmul_rn(a.cs, s));
  v = __fadd_rn(v, __fmul_rn(a.cw, w));
  v = __fadd_rn(v, __fmul_rn(a.ce, e));
  return COMB == NSWE ? v : __fadd_rn(v, __fmul_rn(a.cc, c));
}

template <int FOLD, int VEC, int COMB>
__device__ __forceinline__ void march(const Args& a, const float* __restrict__ src,
                                      float* __restrict__ dst, int strip, int ys, int n) {
  const Torus& g = a.g;
  const int lane = threadIdx.x & 31;
  const int TW = g.C * g.W;
  // the lane's 4 window columns: torus column x = xw + j, source offset cb[j]
  const int xw = strip * OUT - F + 4 * lane;
  int cb[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int x = (xw + j) % TW;
    if (x < 0) x += TW;
    const int c = x / g.W;
    cb[j] = c * g.H * g.W + (x - c * g.W);
  }
  // output lanes: window columns [F, WIN - F) inside the torus
  const int xe = min(strip * OUT + OUT, TW);  // the strip's end
  bool ok[4];
  bool own = lane >= F / 4 && lane < (WIN - F) / 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) ok[j] = own && xw + j < xe;
  own = own && xw < xe;  // VEC == 4: the lane's columns are in or out together

  const int T = n + 2 * FOLD;
  // window row y is loaded into pf[y % 3] AHEAD steps before level 0 takes it
  RowAt in_row, out_row;
  in_row.at(g, ys - FOLD);
  out_row.at(g, ys);
  float pf[AHEAD][4];
  auto fetch = [&](float* v, int y) {
    if (y < T) {
      if (VEC == 4) {
        const float4 u = __ldcg(reinterpret_cast<const float4*>(src + in_row.base + cb[0]));
        v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = __ldcg(src + in_row.base + cb[j]);
      }
    }
    in_row.next(g);
  };
#pragma unroll
  for (int y = 0; y < AHEAD; ++y) fetch(pf[y], y);
  float lv[FOLD][3][4];  // lv[l][y % 3]: level l's row y (window rows)
#pragma unroll 1
  for (int t0 = 0; t0 < T; t0 += 3) {
#pragma unroll
    for (int ph = 0; ph < 3; ++ph) {
      const int t = t0 + ph;
      if (t >= T) break;
      // level 0: window row t
      float* l0 = lv[0][ph];
#pragma unroll
      for (int j = 0; j < 4; ++j) l0[j] = pf[ph][j];
      fetch(pf[ph], t + AHEAD);
      // levels 1..FOLD: level s computes window row t - s
#pragma unroll
      for (int s = 1; s <= FOLD; ++s) {
        if (t < 2 * s) break;  // level s starts at row s
        const float* N = lv[s - 1][((ph - s - 1) % 3 + 6) % 3];
        const float* C = lv[s - 1][((ph - s) % 3 + 6) % 3];
        const float* S = lv[s - 1][((ph - s + 1) % 3 + 6) % 3];
        const float west = __shfl_up_sync(0xffffffffu, C[3], 1);
        const float east = __shfl_down_sync(0xffffffffu, C[0], 1);
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          o[j] = combine<COMB>(a, N[j], S[j], j == 0 ? west : C[j - 1], j == 3 ? east : C[j + 1],
                               C[j]);
        if (s < FOLD) {
          float* d = lv[s][((ph - s) % 3 + 6) % 3];
#pragma unroll
          for (int j = 0; j < 4; ++j) d[j] = o[j];
          continue;
        }
        // level FOLD: the round's value of the warp's next output row
        if (VEC == 4) {
          if (own)
            *reinterpret_cast<float4*>(dst + out_row.base + cb[0]) =
                make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ok[j]) dst[out_row.base + cb[j]] = o[j];
        }
        out_row.next(g);
      }
    }
  }
}

// The body of a ring kernel: every round of `fold` steps (the last one
// shallower where `fold` does not divide `steps`), each a march of the
// warp's strip rows, then a grid barrier. Round rd reads `in` (rd = 0) or
// the buffer round rd - 1 wrote and writes buf[rd % 2].
template <int VEC, int COMB>
__device__ __forceinline__ void rounds(const Args& a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int warp = threadIdx.x >> 5;
  const Torus& g = a.g;
  const int TH = g.R * g.H, TW = g.C * g.W;
  const long long L = (long long)((TW + OUT - 1) / OUT) * TH;  // strip rows
  const long long nw = (long long)gridDim.x * WARPS;
  const long long gw = (long long)blockIdx.x * WARPS + warp;
  const long long lo = gw * L / nw, hi = (gw + 1) * L / nw;
  const int nr = (a.steps + a.fold - 1) / a.fold;
  for (int rd = 0; rd < nr; ++rd) {
    const int f = min(a.fold, a.steps - rd * a.fold);
    const float* src = rd == 0 ? a.in : ((rd - 1) & 1 ? a.buf1 : a.buf0);
    float* dst = rd & 1 ? a.buf1 : a.buf0;
    for (long long pos = lo; pos < hi;) {
      const int strip = (int)(pos / TH), ys = (int)(pos - (long long)strip * TH);
      const int n = (int)min(hi - pos, (long long)(TH - ys));
      switch (f) {
        case 1: march<1, VEC, COMB>(a, src, dst, strip, ys, n); break;
        case 2: march<2, VEC, COMB>(a, src, dst, strip, ys, n); break;
        case 3: march<3, VEC, COMB>(a, src, dst, strip, ys, n); break;
        default: march<4, VEC, COMB>(a, src, dst, strip, ys, n); break;
      }
      pos += n;
    }
    grid.sync();  // every warp's round rd is in dst before round rd + 1
  }
}

// The checks every ring launcher makes: one of the two load widths (vec 4:
// W % 4 == 0 and the three buffers 16-byte aligned), a fold of 1 to F
// steps, strip rows that index as int, and a grid of at most one
// cooperative wave of `per_sm` blocks an SM.
inline int check_launch(const Args& a, int vec, int blocks, int per_sm) {
  const Torus& g = a.g;
  if (a.steps < 1 || a.fold < 1 || a.fold > F || blocks < 1 || (vec != 1 && vec != 4))
    return (int)cudaErrorInvalidValue;
  if (vec == 4 && (g.W % 4 != 0 || (uintptr_t)a.in % 16 != 0 || (uintptr_t)a.buf0 % 16 != 0 ||
                   (uintptr_t)a.buf1 % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (((long long)g.C * g.W + OUT - 1) / OUT * g.R * g.H > INT32_MAX)
    return (int)cudaErrorInvalidValue;  // the strip rows index as int
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop || (long long)per_sm * sms < blocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  return (int)cudaSuccess;
}

}  // namespace ring
