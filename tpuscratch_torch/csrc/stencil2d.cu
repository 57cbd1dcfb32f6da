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
// torch version, which rounds each operation as well (deep_trapezoid skips
// zero coefficients: see there).
//
// No kernel writes the buffer it reads: five_point and deep_trapezoid
// write a fresh grid, resident_periodic ping-pongs between two scratch
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
// five_point: one 5-point step of nb padded tiles (nb, ph, pw) -> new cores
// (nb, h, w). One thread per core cell; a block stages its (BY+2) x (BX+2)
// input window (the 1-cell apron included) in shared memory, so each input
// cell is read from device memory about once.
// Bound: bytes. One step must read the padded tile and write the core,
// (ph*pw + h*w)*4 bytes; at the headline 1024^2 core that is 8.4 MB, 2.5 us
// at 3.35 TB/s. The 5 flops per cell are far below the f32 rate.
constexpr int FP_BX = 32;
constexpr int FP_BY = 8;

__global__ void __launch_bounds__(FP_BX * FP_BY)
five_point_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int ph, int pw, int h, int w, int hy, int hx, Coeffs k) {
  __shared__ float s[FP_BY + 2][FP_BX + 2];
  const size_t b = blockIdx.z;
  const float* t = in + b * (size_t)ph * pw;
  float* o = out + b * (size_t)h * w;
  const int i0 = blockIdx.y * FP_BY, j0 = blockIdx.x * FP_BX;
  const int tid = threadIdx.y * FP_BX + threadIdx.x;
  for (int q = tid; q < (FP_BY + 2) * (FP_BX + 2); q += FP_BX * FP_BY) {
    const int ly = q / (FP_BX + 2), lx = q - ly * (FP_BX + 2);
    const int gy = i0 + hy - 1 + ly, gx = j0 + hx - 1 + lx;  // >= 0: halo >= 1
    s[ly][lx] = (gy < ph && gx < pw) ? t[(size_t)gy * pw + gx] : 0.f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i < h && j < w) {
    const int ly = threadIdx.y + 1, lx = threadIdx.x + 1;
    o[(size_t)i * w + j] = five(k, s[ly - 1][lx], s[ly + 1][lx], s[ly][lx - 1],
                                s[ly][lx + 1], s[ly][lx]);
  }
}

extern "C" int ts_five_point(const float* in, float* out, int nb, int ph,
                             int pw, int h, int w, int hy, int hx, float cn,
                             float cs, float cw, float ce, float cc,
                             void* stream) {
  if (nb < 1 || nb > 65535 || hy < 1 || hx < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(FP_BX, FP_BY);
  const dim3 grid((w + FP_BX - 1) / FP_BX, (h + FP_BY - 1) / FP_BY, nb);
  five_point_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      in, out, ph, pw, h, w, hy, hx, Coeffs{cn, cs, cw, ce, cc});
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// deep_trapezoid: `j` valid-region 5-point steps (the shrink_step pyramid)
// of nb dense inputs (nb, ih, iw); output (i, x) is the pyramid's value at
// input (i + off, x + off), for an (oh, ow) output, off >= j.
// Bound: operations. A substep is 2 * taps - 1 separately rounded f32
// operations a cell of the pyramid (7 for Jacobi), at 33.5 T/s on this
// card (a product and a sum are one instruction each: half the FMA rate);
// the bytes (the input read once, the output written once) are less: at
// 1024^2 with k = 16, 0.00361 ms of operations against 0.00258 of bytes.
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
// march. Taps are a template mask for Jacobi and a runtime mask for any
// other set. A pass deeper than one launch holds (8 stages of 4 levels,
// 32 substeps) is chained by the wrapper: each launch writes the dense
// grid of the rings still to go, and the next one reads it. The host rule
// (ops.common.march_plan) picks the levels, the strip and the chunk.
// Terms: n, s, w, e, c (shrink_step's order, march::ORDER_NSWE), zero
// coefficients skipped. Against the plain version, which adds 0.0 * a for
// a zero coefficient, that can change only the sign of a zero result (a
// sum of -0 and +0 is +0) and the NaN that an infinite input would spread
// through a zero coefficient; torch.equal counts -0 and +0 equal.

struct Trap {
  const float* in;   // (nb, ih, iw)
  float* out;        // (nb, oh, ow)
  int ih, iw, oh, ow;
  int off;           // output (i, x) is the pyramid at input (i + off, x + off)
  int j;             // substeps of the launch
  int rows;          // output rows a chunk
  int width, apron;  // output columns a strip; the window's apron (j rounded up to 4)
  int vin, vout;     // 16-byte loads / stores
  unsigned rmask;    // the taps of a runtime-mask launch
  float c[9];        // coefficient of tap position p = 3 (dy + 1) + dx + 1
};

template <int L, int MASK>
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
  run<L, ORDER_NSWE, MASK, false>(load, zero, store, p.c, p.rmask, T, p.j, 0, p.j);
}

template <int L, int MASK>
static int launch_trap(const Trap& p, dim3 grid, int warps, cudaStream_t s) {
  deep_trapezoid_kernel<L, MASK>
      <<<grid, march::block_threads(warps), march::smem_bytes(warps), s>>>(p);
  return (int)cudaGetLastError();
}

template <int L, int MASK>
static int occupancy_trap(int warps, int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, deep_trapezoid_kernel<L, MASK>, march::block_threads(warps),
      march::smem_bytes(warps));
}

// Dispatch on (levels a stage: 1 or 4, tap mask: Jacobi's or 0, a runtime
// mask) to FN<L, MASK>(args...): a 5-point set has no other instantiation.
#define TRAP_DISPATCH(L, MASK, FN, ...)                                           \
  do {                                                                            \
    const int l_ = (L), m_ = (MASK);                                              \
    if ((l_ != 1 && l_ != 4) || (m_ != march::MASK_JACOBI && m_ != 0))            \
      return (int)cudaErrorInvalidValue;                                          \
    if (m_ == march::MASK_JACOBI)                                                 \
      return l_ == 1 ? FN<1, march::MASK_JACOBI>(__VA_ARGS__)                     \
                     : FN<4, march::MASK_JACOBI>(__VA_ARGS__);                    \
    return l_ == 1 ? FN<1, 0>(__VA_ARGS__) : FN<4, 0>(__VA_ARGS__);               \
  } while (0)

// The blocks of a launch of L levels a stage (1 or 4), tap mask `mask`
// (march::MASK_JACOBI or 0) and `warps` stages an SM holds at once.
extern "C" int ts_deep_trapezoid_occupancy(int L, int mask, int warps, int* per_sm) {
  if (warps < 1 || warps > march::MAX_WARPS) return (int)cudaErrorInvalidValue;
  TRAP_DISPATCH(L, mask, occupancy_trap, warps, per_sm);
}

// One launch of j substeps, (nb, ih, iw) -> (nb, oh, ow) at offset off.
// L, mask, rows, width: the plan of ops.common.march_plan; vin: 16-byte
// loads (iw % 4 == 0, off % 4 == 0, a 16-byte aligned base); vout: 16-byte
// stores (ow % 4 == 0, an aligned base); the coefficients in n, s, w, e, c
// order.
extern "C" int ts_deep_trapezoid(const float* in, float* out, int nb, int ih, int iw, int oh,
                                 int ow, int off, int j, int L, int mask, int rows, int width,
                                 int vin, int vout, float cn, float cs, float cw, float ce,
                                 float cc, void* stream) {
  Trap p{};
  p.in = in; p.out = out; p.ih = ih; p.iw = iw; p.oh = oh; p.ow = ow;
  p.off = off; p.j = j; p.rows = rows; p.width = width; p.apron = (j + 3) / 4 * 4;
  p.vin = vin; p.vout = vout;
  p.c[1] = cn; p.c[7] = cs; p.c[3] = cw; p.c[5] = ce; p.c[4] = cc;
  p.rmask = march::tap_mask(p.c);
  const int warps = (j + L - 1) / (L > 0 ? L : 1);
  if (nb < 1 || nb > 65535 || j < 1 || L < 1 || warps > march::MAX_WARPS || off < j ||
      oh < 1 || ow < 1 || (long long)oh + off + j > ih || (long long)ow + off + j > iw ||
      rows < 1 || width < 4 || width % 4 != 0 || width + 2 * p.apron > march::WIN ||
      (mask != 0 && (unsigned)mask != p.rmask) || in == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (vin && (iw % 4 != 0 || off % 4 != 0 || (uintptr_t)in % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (vout && (ow % 4 != 0 || (uintptr_t)out % 16 != 0)) return (int)cudaErrorMisalignedAddress;
  const long long strips = (ow + width - 1) / width, chunks = (oh + rows - 1) / rows;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  TRAP_DISPATCH(L, mask, launch_trap, p, dim3((unsigned)strips, (unsigned)chunks, (unsigned)nb),
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
