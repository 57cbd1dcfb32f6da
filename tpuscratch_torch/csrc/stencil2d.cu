// Hand-written Hopper (sm_90a) kernels for the 2D 5-point halo stencil.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/stencil_kernel.py:
//   five_point_kernel        <- five_point_pallas (:65, _tile_kernel :50) and
//                               five_point_blocked (:658, _band_kernel :642)
//   deep_trapezoid_kernel    <- deep_trapezoid_pallas (:136, _trapezoid_kernel :87)
//   resident_periodic_kernel <- resident_periodic_pallas (:236, _resident_kernel :217)
//
// Plain C interface (ctypes): every launcher takes raw pointers and the
// CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() (or the error of the call that failed) as an int.
//
// Arithmetic: every product and sum is rounded on its own, in the
// reference's left-to-right order (__fmul_rn / __fadd_rn are never
// contracted into FMAs), so a kernel agrees bit for bit with its plain
// torch version, which rounds each operation as well. five_point and
// deep_trapezoid add all five terms, n, s, w, e, c, a zero coefficient's
// product included, as the reference's _tile_kernel and shrink_step do.
//
// No kernel writes the buffer it reads: five_point writes a fresh padded
// tile (the new core inside the input's halo ring), deep_trapezoid a
// fresh grid, and resident_periodic ping-pongs between two scratch
// buffers a round and never writes its input.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "stencil_taps.cuh"

struct Coeffs {
  float n, s, w, e, c;
};

__device__ __forceinline__ float five(const Coeffs& k, float vn, float vs,
                                      float vw, float ve, float vc) {
  float v = __fmul_rn(k.n, vn);
  v = __fadd_rn(v, __fmul_rn(k.s, vs));
  v = __fadd_rn(v, __fmul_rn(k.w, vw));
  v = __fadd_rn(v, __fmul_rn(k.e, ve));
  return __fadd_rn(v, __fmul_rn(k.c, vc));
}

// ---------------------------------------------------------------------------
// five_point: one 5-point step of nb padded tiles (nb, ph, pw) into a fresh
// (nb, ph, pw): the core's new values inside the input's halo ring, which
// is copied. That is the whole of what five_point_pallas returns, so the
// wrapper runs no rebuild after the launch.
// Bound: bytes. The step reads the padded tile and writes one, 8 bytes a
// padded cell: at the headline's 1026^2 tile 8.4 MB, 2.5 us at 3.35 TB/s,
// at 8194^2 0.1603 ms; the 9 operations a core cell are far below the f32
// rate.
// Design (dma_hbm_step's register tiles over the padded tile):
//  - a block of FP_WARPS warps owns 32 * VEC columns and FP_WARPS * FP_RY
//    rows of one tile; a lane owns VEC adjacent columns and FP_RY rows down
//    them, held with the row above and the row below as a register window
//    of FP_RY + 2 rows, each row loaded once, VEC columns as one 16-byte
//    (VEC 4) or 8-byte (VEC 2) load where every row of the tile starts
//    aligned to it (the host rule five_plan: pw % VEC == 0 and both bases
//    aligned; the headline's pw = 1026 takes 8-byte groups);
//  - west and east neighbours come from the adjacent lanes by shuffles;
//    only a warp's edge lanes load one more cell a row;
//  - a window row outside the tile is zeros and feeds only halo cells; a
//    cell of the halo ring stores its input value, a core cell the sum;
//  - no division anywhere, 32-bit indices where the batch's elements fit
//    them (I = int).
// 2 rows a lane and 4 warps a block were the best of the H100's sweep over
// 2, 4, 8 rows and 1 to 8 warps at 1026^2 and 8194^2 (PERF.md, row 1).
constexpr int FP_RY = 2;
constexpr int FP_WARPS = 4;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(float* d, const float* s) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(s));
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* d, const float* s) {
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(float* d, const float* s) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(s));
    d[0] = v.x; d[1] = v.y;
  }
  static __device__ __forceinline__ void store(float* d, const float* s) {
    *reinterpret_cast<float2*>(d) = make_float2(s[0], s[1]);
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(float* d, const float* s) { d[0] = __ldg(s); }
  static __device__ __forceinline__ void store(float* d, const float* s) { d[0] = s[0]; }
};

template <int VEC, typename I>
__global__ void __launch_bounds__(32 * FP_WARPS)
five_point_kernel(const float* __restrict__ in, float* __restrict__ out, int ph, int pw,
                  int hy, int hx, int h, int w, Coeffs k) {
  const int lane = threadIdx.x;
  const int x0 = (blockIdx.x * 32 + lane) * VEC;
  const int y0 = (blockIdx.y * FP_WARPS + threadIdx.y) * FP_RY;
  if (y0 >= ph) return;  // a whole warp: no shuffle partner is lost
  const I base = (I)blockIdx.z * ph * pw + x0;  // the lane's first column of row 0
  const bool in_tile = x0 < pw;                 // pw % VEC == 0: a group is all in or out
  float win[FP_RY + 2][VEC + 2];
#pragma unroll
  for (int u = 0; u < FP_RY + 2; ++u) {
    const int y = y0 - 1 + u;
    if (y < 0 || y >= ph) {  // warp-uniform
#pragma unroll
      for (int x = 0; x < VEC + 2; ++x) win[u][x] = 0.0f;
      continue;
    }
    const float* rp = in + (base + (I)y * pw);
    if (in_tile) {
      Vec<VEC>::load(win[u] + 1, rp);
    } else {
#pragma unroll
      for (int x = 1; x <= VEC; ++x) win[u][x] = 0.0f;
    }
    const float west = __shfl_up_sync(0xffffffffu, win[u][VEC], 1);
    const float east = __shfl_down_sync(0xffffffffu, win[u][1], 1);
    win[u][0] = lane > 0 ? west : (in_tile && x0 > 0 ? rp[-1] : 0.0f);
    win[u][VEC + 1] = lane < 31 ? east : (x0 + VEC < pw ? rp[VEC] : 0.0f);
  }
  if (!in_tile) return;
#pragma unroll
  for (int u = 0; u < FP_RY; ++u) {
    const int y = y0 + u;
    if (y >= ph) break;
    float o[VEC];
    const bool core_row = y >= hy && y < hy + h;
#pragma unroll
    for (int x = 0; x < VEC; ++x) {
      const int col = x0 + x;
      o[x] = core_row && col >= hx && col < hx + w
                 ? five(k, win[u][x + 1], win[u + 2][x + 1], win[u + 1][x], win[u + 1][x + 2],
                        win[u + 1][x + 1])
                 : win[u + 1][x + 1];
    }
    Vec<VEC>::store(out + (base + (I)y * pw), o);
  }
}

template <int VEC, typename I>
static int launch_five(const float* in, float* out, int nb, int ph, int pw, int hy, int hx,
                       int h, int w, const Coeffs& k, cudaStream_t s) {
  const dim3 block(32, FP_WARPS);
  constexpr int rows = FP_WARPS * FP_RY;
  const dim3 grid((pw + 32 * VEC - 1) / (32 * VEC), (ph + rows - 1) / rows, nb);
  five_point_kernel<VEC, I><<<grid, block, 0, s>>>(in, out, ph, pw, hy, hx, h, w, k);
  return (int)cudaGetLastError();
}

template <typename I>
static int launch_five_vec(int vec, const float* in, float* out, int nb, int ph, int pw, int hy,
                           int hx, int h, int w, const Coeffs& k, cudaStream_t s) {
  switch (vec) {
    case 4: return launch_five<4, I>(in, out, nb, ph, pw, hy, hx, h, w, k, s);
    case 2: return launch_five<2, I>(in, out, nb, ph, pw, hy, hx, h, w, k, s);
    case 1: return launch_five<1, I>(in, out, nb, ph, pw, hy, hx, h, w, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

// One step of nb padded tiles (nb, ph, pw) of core (h, w) and halo (hy,
// hx) into the fresh (nb, ph, pw) at `out`; vec (4, 2 or 1 columns a
// load): ops.stencil_kernel.five_plan's. The coefficients in n, s, w, e, c
// order.
extern "C" int ts_five_point(const float* in, float* out, int nb, int ph, int pw, int h, int w,
                             int hy, int hx, float cn, float cs, float cw, float ce, float cc,
                             int vec, void* stream) {
  if (nb < 1 || nb > 65535 || hy < 1 || hx < 1 || h < 1 || w < 1 ||
      (long long)h + 2ll * hy != ph || (long long)w + 2ll * hx != pw || in == nullptr ||
      out == nullptr || in == out)
    return (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec != 2 && vec != 4) || pw % vec != 0) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)in % (4 * vec) != 0 || (uintptr_t)out % (4 * vec) != 0)
    return (int)cudaErrorMisalignedAddress;
  if ((ph + (long long)FP_WARPS * FP_RY - 1) / (FP_WARPS * FP_RY) > 65535)
    return (int)cudaErrorInvalidValue;
  const Coeffs k{cn, cs, cw, ce, cc};
  const cudaStream_t s = (cudaStream_t)stream;
  // 32-bit indices while every element of the batch, and one group past
  // its end, has one
  if ((long long)nb * ph * pw + 32ll * vec < INT_MAX)
    return launch_five_vec<int>(vec, in, out, nb, ph, pw, hy, hx, h, w, k, s);
  return launch_five_vec<long long>(vec, in, out, nb, ph, pw, hy, hx, h, w, k, s);
}


// ---------------------------------------------------------------------------
// deep_trapezoid: `j` valid-region 5-point steps (the shrink_step pyramid)
// of nb dense inputs (nb, ih, iw); output (i, x) is the pyramid's value at
// input (i + off, x + off), for an (oh, ow) output, off >= j.
// Bound: operations. A substep is 9 separately rounded f32 operations a
// cell of the pyramid (5 products, 4 sums), at 33.5 T/s on this card (a
// product and a sum are one instruction each: half the FMA rate); the
// bytes (the input read once, the output written once) are less: at
// 1024^2 with k = 16, 0.00464 ms of operations against 0.00258 of bytes.
// Design: the row march of stencil_taps.cuh, which keeps the pyramid's
// redundant work on one axis and every tap in registers. A block owns a
// strip of output columns (the 256-column window less its apron of j
// columns rounded up to 4) and a chunk of output rows of one input, and
// marches down the chunk's window rows; its substep levels are cut into
// stages of 4 levels a warp (1 at depth 1), each stage's levels in
// registers, the stages handing rows over through shared memory, one
// barrier a row, and one I/O warp doing every copy from and to device
// memory. The redundant work lies on the window's x apron (256 / 224 at
// k = 16) and on the chunk's j rows at each end. Input rows are always
// inside the input (off >= j and oh + off + j <= ih); window columns past
// either side of it are loaded as zeros and feed only outputs that are
// not stored. Rows go as two 16-byte groups a lane where iw % 4 == 0,
// off % 4 == 0 and the base is 16-byte aligned (a group is then wholly in
// or out of the input), else as 4-byte columns; no division runs in the
// march. The taps are TRAP_TAPS's five for every coefficient set, as a
// template mask (the same set as a runtime mask read 4 to 6 times slower on
// the H100, PERF.md). A pass deeper than one launch holds (8 stages of 4 levels,
// 32 substeps) is chained by the wrapper: each launch writes the dense
// grid of the rings still to go, and the next one reads it. The host rule
// (ops.common.march_plan) picks the levels, the strip and the chunk.
// Terms: n, s, w, e, c in shrink_step's order (march::ORDER_NSWE), all
// five whatever the coefficients (TRAP_TAPS): the reference adds 0.0 * a
// for a zero coefficient, which makes the sign of a zero sum and turns an
// infinite input into NaN, and the kernel does the same.

// The trapezoid's tap set: n, w, c, e, s
constexpr int TRAP_TAPS = 0x0BA;

struct Trap {
  const float* in;   // (nb, ih, iw)
  float* out;        // (nb, oh, ow)
  int ih, iw, oh, ow;
  int off;           // output (i, x) is the pyramid at input (i + off, x + off)
  int j;             // substeps of the launch
  int rows;          // output rows a chunk
  int width, apron;  // output columns a strip; the window's apron (j rounded up to 4)
  int vin, vout;     // 16-byte loads / stores
  float c[9];        // coefficient of tap position p = 3 (dy + 1) + dx + 1
};

template <int L>
__global__ void __launch_bounds__((march::MAX_WARPS + 1) * 32)
deep_trapezoid_kernel(const Trap p) {
  using namespace march;
  const int lane = threadIdx.x & 31;
  const long long b = blockIdx.z;
  const int cy0 = blockIdx.y * p.rows;        // the chunk's first output row
  const int T = min(p.rows, p.oh - cy0) + 2 * p.j;
  const int xs = blockIdx.x * p.width;        // the strip's first output column
  const int yw0 = cy0 + p.off - p.j;          // the input row of window row 0 (>= 0)
  const int x0 = xs + p.off - p.apron + lane * CX;  // the input column of the lane's first
  // which of the lane's 8 columns lie in the input, and which are outputs
  // of the strip (rows are addressed from the launch's base pointers each
  // time, which keeps no 64-bit pointer of the block live through the march)
  unsigned icols = 0, ocols = 0;
#pragma unroll
  for (int i = 0; i < CX; ++i) {
    const int w = lane * CX + i;
    if (x0 + i >= 0 && x0 + i < p.iw) icols |= 1u << i;
    if (w >= p.apron && w < p.apron + p.width && xs + w - p.apron < p.ow) ocols |= 1u << i;
  }
  auto load = [&](int r, float* slot) {
    const long long rb = (b * p.ih + yw0 + r) * p.iw + x0;
    if (p.vin) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool in = icols >> (4 * q) & 1;
        cp16(group(slot, q, lane), in ? p.in + (rb + 4 * q) : p.in, in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < CX; ++i) {
        const bool in = icols >> i & 1;
        cp4(group(slot, i / 4, lane) + i % 4, in ? p.in + (rb + i) : p.in, in);
      }
    }
  };
  auto zero = [](int, float(&)[CX]) {};
  auto store = [&](int q, const float(&o)[CX]) {
    const long long rb = (b * p.oh + cy0 + q - p.j) * p.ow + xs - p.apron + lane * CX;
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      if (p.vout && (ocols >> 4 * g & 15) == 15) {
        *reinterpret_cast<float4*>(p.out + (rb + 4 * g)) =
            make_float4(o[4 * g], o[4 * g + 1], o[4 * g + 2], o[4 * g + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ocols >> (4 * g + e) & 1) p.out[rb + 4 * g + e] = o[4 * g + e];
      }
    }
  };
  run<L, ORDER_NSWE, TRAP_TAPS, false>(load, zero, store, p.c, 0u, T, p.j, 0, p.j);
}

template <int L>
static int launch_trap(const Trap& p, dim3 grid, int warps, cudaStream_t s) {
  deep_trapezoid_kernel<L>
      <<<grid, march::block_threads(warps), march::smem_bytes(warps), s>>>(p);
  return (int)cudaGetLastError();
}

template <int L>
static int occupancy_trap(int warps, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, deep_trapezoid_kernel<L>, march::block_threads(warps),
      march::smem_bytes(warps));
}

// Dispatch on the levels a stage (1 or 4) to FN<L>(args...).
#define TRAP_DISPATCH(L, FN, ...)                                  \
  do {                                                             \
    const int l_ = (L);                                            \
    if (l_ != 1 && l_ != 4) return (int)cudaErrorInvalidValue;     \
    return l_ == 1 ? FN<1>(__VA_ARGS__) : FN<4>(__VA_ARGS__);      \
  } while (0)

// The blocks of a launch of L levels a stage (1 or 4) and `warps` stages
// an SM holds at once.
extern "C" int ts_deep_trapezoid_occupancy(int L, int warps, int* per_sm) {
  if (warps < 1 || warps > march::MAX_WARPS) return (int)cudaErrorInvalidValue;
  TRAP_DISPATCH(L, occupancy_trap, warps, per_sm);
}

// One launch of j substeps, (nb, ih, iw) -> (nb, oh, ow) at offset off.
// L, rows, width: the plan of ops.common.march_plan; vin: 16-byte
// loads (iw % 4 == 0, off % 4 == 0, a 16-byte aligned base); vout: 16-byte
// stores (ow % 4 == 0, an aligned base); the coefficients in n, s, w, e, c
// order.
extern "C" int ts_deep_trapezoid(const float* in, float* out, int nb, int ih, int iw, int oh,
                                 int ow, int off, int j, int L, int rows, int width,
                                 int vin, int vout, float cn, float cs, float cw, float ce,
                                 float cc, void* stream) {
  Trap p{};
  p.in = in; p.out = out; p.ih = ih; p.iw = iw; p.oh = oh; p.ow = ow;
  p.off = off; p.j = j; p.rows = rows; p.width = width; p.apron = (j + 3) / 4 * 4;
  p.vin = vin; p.vout = vout;
  p.c[1] = cn; p.c[7] = cs; p.c[3] = cw; p.c[5] = ce; p.c[4] = cc;
  const int warps = (j + L - 1) / (L > 0 ? L : 1);
  if (nb < 1 || nb > 65535 || j < 1 || L < 1 || warps > march::MAX_WARPS || off < j ||
      oh < 1 || ow < 1 || (long long)oh + off + j > ih || (long long)ow + off + j > iw ||
      rows < 1 || width < 4 || width % 4 != 0 || width + 2 * p.apron > march::WIN ||
      in == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (vin && (iw % 4 != 0 || off % 4 != 0 || (uintptr_t)in % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (vout && (ow % 4 != 0 || (uintptr_t)out % 16 != 0)) return (int)cudaErrorMisalignedAddress;
  const long long strips = (ow + width - 1) / width, chunks = (oh + rows - 1) / rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  TRAP_DISPATCH(L, launch_trap, p, dim3((unsigned)strips, (unsigned)chunks, (unsigned)nb),
                warps, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// resident_periodic: `steps` periodic 5-point steps of an (H, W) grid in ONE
// cooperative launch.
// Bound: operations. A step is 4 separately rounded operations a cell in
// the symmetric form (0.1252 ms for 1000 steps at 1024^2 at 33.5 T/s); the
// bytes, the grid read once and written once, are far less, as the steps
// in between stay in the 50 MB L2 while both buffers fit there, which is
// the rule the wrapper's refusal enforces.
// Design: the folded ring of stencil_taps.cuh (namespace ring) over the
// one-rank torus (R = C = 1): a warp marches a 120-column strip's rows with
// its levels in registers, north and south taps from registers, west and
// east from one shuffle each, the wrap resolved once a row and once a
// warp, 16-byte rows where W % 4 == 0; `fold` steps (at most 4) between
// grid barriers, so a run costs ceil(steps / fold) barriers, and round rd
// writes buf[rd % 2]. On a torus a round's values are the per-step values,
// so folding moves no bit. The host rule (ops.common.ring_plan, as for the
// DMA ring) picks the fold and the grid.
// Terms, the reference's: symmetric Jacobi (n = s = w = e, c = 0) as
// cn*((N + S) + (W + E)) (ring::SYM); otherwise n, s, w, e (ring::NSWE),
// then c where it is not 0 (ring::NSWEC); every product and sum rounded on
// its own.
// Three blocks an SM (168 registers a thread) with 16-byte rows, two with
// scalar loads, as the DMA ring; the 16-byte-row sum with a centre term,
// which is the DMA ring's <4> and spilled 16 bytes at 168 as it does, runs
// at two (no path runs it: the headline's Jacobi takes ring::SYM).
template <int VEC, int COMB>
__global__ void __launch_bounds__(ring::THREADS, VEC == 4 && COMB != ring::NSWEC ? 3 : 2)
resident_periodic_kernel(const ring::Args a) {
  ring::rounds<VEC, COMB>(a);
}

// The instantiation of load width `vec` (4 or 1) and sum `comb` (ring::*).
static const void* resident_kernel(int vec, int comb) {
  switch (comb) {
    case ring::SYM:
      return vec == 4 ? (const void*)resident_periodic_kernel<4, ring::SYM>
                      : (const void*)resident_periodic_kernel<1, ring::SYM>;
    case ring::NSWE:
      return vec == 4 ? (const void*)resident_periodic_kernel<4, ring::NSWE>
                      : (const void*)resident_periodic_kernel<1, ring::NSWE>;
    case ring::NSWEC:
      return vec == 4 ? (const void*)resident_periodic_kernel<4, ring::NSWEC>
                      : (const void*)resident_periodic_kernel<1, ring::NSWEC>;
  }
  return nullptr;
}

// The blocks of the resident kernel of load width `vec` and sum `comb` an
// SM holds at once.
extern "C" int ts_resident_occupancy(int vec, int comb, int* per_sm) {
  const void* k = resident_kernel(vec, comb);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, ring::THREADS, 0);
}

// comb: ring::SYM, NSWE or NSWEC; vec: 4 (16-byte rows: W % 4 == 0 and the
// three buffers 16-byte aligned) or 1; fold 1..ring::F steps a round;
// blocks from ops.common.ring_plan, at most one cooperative wave. The
// state after the last round is in buf[(rounds - 1) % 2].
extern "C" int ts_resident_periodic(const float* in, float* buf0, float* buf1, int H, int W,
                                    int steps, int comb, float cn, float cs, float cw, float ce,
                                    float cc, int vec, int fold, int blocks, void* stream) {
  const void* k = resident_kernel(vec, comb);
  if (H < 1 || W < 1 || (long long)H * W > INT_MAX || k == nullptr)
    return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  int e = ts_resident_occupancy(vec, comb, &per_sm);
  if (e != cudaSuccess) return e;
  const ring::Args a{in, buf0, buf1, Torus{1, 1, H, W}, steps, fold, cn, cs, cw, ce, cc};
  e = ring::check_launch(a, vec, blocks, per_sm);
  if (e != cudaSuccess) return e;
  void* args[] = {(void*)&a};
  e = (int)cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(ring::THREADS), args, 0,
                                       (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return (int)cudaGetLastError();
}
