// Hand-written Hopper (sm_90a) kernel for the deep-z streamed 3D stencil.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/stencil_stream.py:
//   stream3d_kernel <- seven_point_streamed_pallas (:566; _stream_kernel :250,
//                      _substep27 :78, _sub7_interior :171, _age3d_strips :184)
//
// What it computes: `K` 7- or 27-point substeps of every rank's
// (cz, cy, cx) core in one pass. The TPU kernel streams z bands of whole
// planes through VMEM by manual DMA and ages [plus | minus] ghost strips
// beside each band, whose seam garbage never reaches the core. Cell for
// cell that is the K-substep pyramid over the extended volume
//   planes  [-K, cz + K): a_mz | core | a_pz,
//   rows    [-K, cy + K): row y mod cy (y self-wraps), or the strip gy,
//           whose rows [0, K) are global rows [cy, cy + K) and rows
//           [K, 2K) global rows [-K, 0),
//   columns [-K, cx + K): likewise with gx; gc holds the four xy corners,
// and that is what this kernel runs.
//
// Open ends: per-rank flags [z-, z+, y-, y+, x-, x+]. After every substep
// but the pass's last, each cell outside the core on a flagged side is
// set to zero (stencil_stream.py:406-485); the y and x flags count only on
// a ghosted axis, as a self-wrapping axis has no end.
//
// rhs: each substep adds rhs_coeff * rhs at the cell's own coordinates,
// rhs pre-ghosted to planes [-K, cz + K); y and x self-wrap in this mode.
//
// A pass deeper than S3_MAX_J substeps is chained: a launch of j < K
// substeps writes the dense volume [-go, c + go)^3 with go the ghost rings
// still to be consumed, and the next launch reads that volume (gi >= 0)
// instead of the slabs and strips.
//
// Terms. 7 points: w0*up + w1*down + w2*north + w3*south + w4*west +
// w5*east + w6*centre, left to right, all seven always (_asm3d_compute),
// then the rhs term. 27 points: the weight cube in (dz, dy, dx) order,
// none skipped, for every cell (the TPU kernel sums its border columns in
// (dz, dx, dy) order). Every product and sum is rounded on its own, so
// the kernel agrees bit for bit with its plain torch version.
//
// Bound: bytes for shallow passes (read the core, slabs and strips once,
// write the core once: about 8 bytes a cell per K substeps); from K = 4 on
// the 13 separately rounded operations a cell a substep (53 at 27 points)
// come close, so the design spends as little as it can beside them.
//
// Design: a 2.5D z-march. A block owns a (ty, tx) column tile of one rank
// and a chunk of zc output planes, and marches down z through a window of
// RY x RX = (ty + 2j) x (tx + 2j) cells a plane:
//  - input planes arrive by cp.async into a ring of S3_AHEAD + R - 1
//    planes, S3_AHEAD - 1 planes ahead of the compute; each cell's source
//    (the core, an mz / pz slab, a gy / gx / gc strip, a wrap or past the
//    end) and its offset there are resolved once a kernel, against plane
//    bases that are the same for the whole block a step;
//  - substep level s keeps a ring of R planes (3 at 7 points, 4 at 27) in
//    shared memory; at march step t level s computes plane t - 2s from
//    the planes level s - 1 finished in earlier steps, so every level of a
//    step is independent of the others and one barrier a step suffices;
//    level j goes straight to device memory;
//  - a thread owns fixed window cells, CY = 3 consecutive rows and CX
//    adjacent columns: at 7 points it keeps its own cells' last three
//    planes of every level in registers, so the z taps, the centre and the
//    north / south taps inside its rows are registers, west / east one
//    shuffle from the lane beside it, and only the rows at the ends of a
//    thread's strip pass through shared memory (a third of the reads and
//    two thirds of the writes of a plane ring); the step loop is unrolled
//    by 3 so the register planes rotate by name, not by moves;
//  - a level computes all of the thread's cells, in and out of its range,
//    as one straight run of independent sums (cells past a level's range
//    hold values no cell in range reads; the planes are padded so that
//    their edges read in bounds): no branch a cell, and the only
//    redundant work is the y/x apron of each level and the z apron of a
//    chunk; the host rule (ops.stencil_stream.stream3d_plan) picks the
//    chunk so that the blocks fill whole waves of the SMs;
//  - no integer division runs in the march loop.

#include <cuda_runtime.h>
#include <cstdint>

#include "stencil_taps.cuh"

constexpr int S3_WARPS = 8;
constexpr int S3_THREADS = 32 * S3_WARPS;
constexpr int S3_MAX_J = 8;   // substeps a launch: deeper passes are chained
constexpr int S3_AHEAD = 2;   // input planes in flight, the one being read included

// The window of a launch of J substeps: CY consecutive rows (warp * CY + r)
// and CX adjacent columns (lane * CX + c) a thread.
template <int J>
struct S3Win {
  static constexpr int CY = 3;
  static constexpr int CX = J <= 4 ? 2 : 1;
  static constexpr int RY = S3_WARPS * CY;
  static constexpr int RX = 32 * CX;
  static constexpr int NP = CY * CX;
  // a row and a cell of padding before and after the planes, so that a
  // cell of a window's edge reads its missing neighbours in bounds (two
  // cells: a thread's column pair stays 8-byte aligned)
  static constexpr int PAD = RX + 2;
};

template <int NT, int J>
constexpr int s3_planes() {
  // the input ring, then R planes for each level 1..J-1
  return (S3_AHEAD + (NT == 7 ? 3 : 4) - 1) + (NT == 7 ? 3 : 4) * (J - 1);
}

template <int NT, int J>
constexpr size_t s3_smem() {
  return ((size_t)s3_planes<NT, J>() * S3Win<J>::RY * S3Win<J>::RX + 2 * S3Win<J>::PAD) *
         sizeof(float);
}

struct Stream3 {
  const float* core;   // slab mode: the cores; dense mode: the (c + 2gi)^3 volumes
  const float* mz;     // (K, cy, cx) planes [-K, 0)
  const float* pz;     // (K, cy, cx) planes [cz, cz + K)
  const float* gy;     // (cz + 2K, 2K, cx) or null: y self-wraps
  const float* gx;     // (cz + 2K, cy, 2K) or null: x self-wraps
  const float* gc;     // (cz + 2K, 2K, 2K), with both gy and gx
  const float* rhs;    // (cz + 2K, cy, cx) or null
  const int* flags;    // (6,) a rank
  float* out;          // (cz + 2go, cy + 2go, cx + 2go) a rank
  int cz, cy, cx;
  int K;               // depth of the whole pass: slab, strip and rhs apron
  int done;            // substeps of the pass already run by earlier launches
  int gi;              // dense input apron, or -1: read the slabs and strips
  int go;              // output apron, K - done - j
  int ghost_y, ghost_x;
  float rhs_coeff;
  int zc;              // output planes a block
  int nzc, nty, ntx;   // z chunks, y tiles and x tiles a rank
  float w[27];
};

__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0) v += n;
  else if (v >= n) v -= n;
  if (v < 0 || v >= n) {  // a window wider than the axis
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool fill) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's CX adjacent cells of a shared-memory row: one 8-byte read for
// a column pair.
template <int CX>
__device__ __forceinline__ void s3_row(float* v, const float* row) {
  if constexpr (CX == 2) {
    const float2 u = *reinterpret_cast<const float2*>(row);
    v[0] = u.x;
    v[1] = u.y;
  } else {
#pragma unroll
    for (int c = 0; c < CX; ++c) v[c] = row[c];
  }
}

// Two blocks an SM (128 registers a thread), but one for the 7-point
// kernels of 7 and 8 substeps, whose register planes of 7 or 8 levels
// spilled at 128. chip_smoke.py's build phase holds every instantiation
// to no spill but <7, 4>, which may spill 8 bytes: every variant of it
// measured without that spill, or with less, was slower (PERF.md).
template <int NT, int J>
__global__ void __launch_bounds__(S3_THREADS, NT == 7 && J >= 7 ? 1 : 2)
stream3d_kernel(const Stream3 p) {
  using Wn = S3Win<J>;
  constexpr int CY = Wn::CY, CX = Wn::CX, RY = Wn::RY, RX = Wn::RX, NP = Wn::NP;
  constexpr int PL = RY * RX;
  constexpr int R = NT == 7 ? 3 : 4;       // a level's ring of planes
  constexpr int NB0 = S3_AHEAD + R - 1;    // the input ring
  extern __shared__ float smem[];
  float* const L0 = smem + Wn::PAD;
  float* const LS = L0 + NB0 * PL;          // level s >= 1 at LS + (s - 1) * R * PL

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int b = blockIdx.x;
  const int bx = b % p.ntx;
  b /= p.ntx;
  const int by = b % p.nty;
  b /= p.nty;
  const int bz = b % p.nzc;
  const size_t rank = b / p.nzc;
  constexpr int ty = RY - 2 * J, tx = RX - 2 * J;
  const int cz = p.cz, cy = p.cy, cx = p.cx, K = p.K;
  const int OZ = cz + 2 * p.go, OY = cy + 2 * p.go, OX = cx + 2 * p.go;
  const int oz0 = bz * p.zc;
  const int Zw = min(p.zc, OZ - oz0) + 2 * J;  // window planes
  // the window's origin, in core coordinates
  const int z0 = oz0 - p.go - J, y0 = by * ty - p.go - J, x0 = bx * tx - p.go - J;
  const bool dense = p.gi >= 0;
  const int gi = dense ? p.gi : 0;
  const int DZ = cz + 2 * gi, DY = cy + 2 * gi, DX = cx + 2 * gi;  // the dense input volume

  const int* f = p.flags + rank * 6;
  const bool open_zm = f[0], open_zp = f[1];
  const bool open_ym = p.ghost_y && f[2], open_yp = p.ghost_y && f[3];
  const bool open_xm = p.ghost_x && f[4], open_xp = p.ghost_x && f[5];
  const float* rhs = p.rhs ? p.rhs + rank * (size_t)(cz + 2 * K) * cy * cx : nullptr;
  float* const out = p.out + rank * (size_t)OZ * OY * OX;
  const int K2 = 2 * K;

  // The thread's cells, resolved once: where each is read from (the plane
  // of the core / slabs / dense volume, of gx, gy or gc, or nowhere: a
  // zero) and at what offset in that plane; where it is written at level
  // j; whether an open end zeroes it; where its rhs term is.
  // (from: 3 bits a cell; czero and oin a bit a cell; the cell's output
  // offset is obase + r * OX + c, its rhs offset rrow[r] + rcol[c])
  enum { FROM_NONE, FROM_P, FROM_GX, FROM_GY, FROM_GC };
  int off[NP], rrow[CY], rcol[CX];
  unsigned from = 0, czero = 0, oin = 0;
  const int obase = (by * ty + warp * CY - J) * OX + bx * tx + lane * CX - J;
#pragma unroll
  for (int r = 0; r < CY; ++r) {
    const int ly = warp * CY + r, y = y0 + ly;
    const int oy = by * ty + ly - J;
    const int yw = wrap(y, cy);
    const bool yz = (open_ym && y < 0) || (open_yp && y >= cy);
    // the row: 0 none, 1 a core row (or the dense volume's), 2 a gy row
    int rk, ri;
    if (dense) {
      rk = y + gi >= 0 && y + gi < DY ? 1 : 0;
      ri = y + gi;
    } else if (p.ghost_y && (y < 0 || y >= cy)) {
      rk = y < -K || y >= cy + K ? 0 : 2;
      ri = y >= cy ? y - cy : y + K2;
    } else {
      rk = 1;
      ri = yw;
    }
#pragma unroll
    for (int c = 0; c < CX; ++c) {
      const int i = r * CX + c;
      const int lx = lane * CX + c, x = x0 + lx;
      const int ox = bx * tx + lx - J;
      const int xw = wrap(x, cx);
      // the column: 0 none, 1 a core column, 2 a gx / gc column
      int ck, ci;
      if (dense) {
        ck = x + gi >= 0 && x + gi < DX ? 1 : 0;
        ci = x + gi;
      } else if (x >= 0 && x < cx) {
        ck = 1;
        ci = x;
      } else if (!p.ghost_x) {
        ck = 1;
        ci = xw;
      } else if (x < -K || x >= cx + K) {
        ck = 0;
        ci = 0;
      } else {
        ck = 2;
        ci = x >= cx ? x - cx : x + K2;
      }
      from |= (unsigned)(rk == 0 || ck == 0 ? FROM_NONE
                         : rk == 1       ? (ck == 1 ? FROM_P : FROM_GX)
                                         : (ck == 1 ? FROM_GY : FROM_GC)) << 3 * i;
      off[i] = (ck == 1 ? ri * (dense ? DX : cx) : ri * K2) + ci;
      if (ly >= J && ly < RY - J && oy < OY && lx >= J && lx < RX - J && ox < OX)
        oin |= 1u << i;
      rrow[r] = yw * cx;
      rcol[c] = xw;
      if (yz || (open_xm && x < 0) || (open_xp && x >= cx)) czero |= 1u << i;
    }
  }
  const bool simple = dense || (!p.ghost_y && !p.ghost_x);  // every cell FROM_P or none
  const int base = warp * CY * RX + lane * CX;  // the window index of the thread's cell (0, 0)

  // window plane w into input slot `slot`: each thread its own cells, from
  // plane bases that are the same for the whole block
  auto load_plane = [&](int w, int slot) {
    const int z = z0 + w;
    const float *Pb = nullptr, *gxb = nullptr, *gyb = nullptr, *gcb = nullptr;
    if (dense) {
      if (z + gi >= 0 && z + gi < DZ) Pb = p.core + (rank * DZ + (z + gi)) * DY * DX;
    } else if (z >= -K && z < cz + K) {
      const size_t zi = rank * (cz + K2) + (z + K);
      Pb = z < 0 ? p.mz + (rank * K + (z + K)) * cy * cx
           : z >= cz ? p.pz + (rank * K + (z - cz)) * cy * cx
                     : p.core + (rank * cz + z) * cy * cx;
      if (p.ghost_x) gxb = p.gx + zi * cy * K2;
      if (p.ghost_y) gyb = p.gy + zi * K2 * cx;
      if (p.ghost_y && p.ghost_x) gcb = p.gc + zi * K2 * K2;
    }
    float* dst = L0 + slot * PL + base;
#pragma unroll
    for (int r = 0; r < CY; ++r)
#pragma unroll
      for (int c = 0; c < CX; ++c) {
        const int i = r * CX + c;
        const unsigned fi = from >> 3 * i & 7;
        const float* src = fi == FROM_NONE ? nullptr
                           : simple || fi == FROM_P ? Pb
                           : fi == FROM_GX ? gxb
                           : fi == FROM_GY ? gyb : gcb;
        const bool fill = src != nullptr;
        // a zero cell reads nothing: the address only has to be a global one
        cp_async4(dst + r * RX + c,
                  fill ? src + off[i] : reinterpret_cast<const float*>(p.flags), fill);
      }
  };

#pragma unroll
  for (int w = 0; w < S3_AHEAD - 1; ++w) {
    if (w < Zw) load_plane(w, w);
    cp_async_commit();
  }
  const int T = Zw + J;  // march steps: level j finishes window plane T - 1 - j
  int ld_slot = S3_AHEAD - 1;  // the input slot of plane t + S3_AHEAD - 1
  int rd_slot = NB0 - 2;       // the input slot of plane t - 2 (t - 1 once step t advances it)
  // level s's sums `v` at plane z: the rhs term, the open ends, and the
  // result into level s's ring or, at level j, the output
  auto finish = [&](float (&v)[NP], int s, int z, float* Ps, float* oz) {
    if (rhs && z >= -K && z < cz + K) {
      const float* rz = rhs + (size_t)(z + K) * cy * cx;
#pragma unroll
      for (int i = 0; i < NP; ++i)
        v[i] = __fadd_rn(v[i], __fmul_rn(p.rhs_coeff, rz[rrow[i / CX] + rcol[i % CX]]));
    }
    if (p.done + s < K) {  // ghosts are still in play after this substep
      if ((open_zm && z < 0) || (open_zp && z >= cz)) {
#pragma unroll
        for (int i = 0; i < NP; ++i) v[i] = 0.f;
      } else if (czero) {
#pragma unroll
        for (int i = 0; i < NP; ++i)
          if (czero >> i & 1) v[i] = 0.f;
      }
    }
    if (s == J) {
#pragma unroll
      for (int r = 0; r < CY; ++r)
#pragma unroll
        for (int c = 0; c < CX; ++c)  // level j: the tile's cells
          if (oin >> (r * CX + c) & 1) oz[obase + r * OX + c] = v[r * CX + c];
      return;
    }
    // what other threads read of level s: every cell at 27 points, the
    // rows at the ends of the thread's strip at 7
#pragma unroll
    for (int r = 0; r < CY; ++r) {
      if (NT == 7 && r != 0 && r != CY - 1) continue;
      if constexpr (CX == 2)
        *reinterpret_cast<float2*>(Ps + r * RX) = make_float2(v[r * CX], v[r * CX + 1]);
      else
        for (int c = 0; c < CX; ++c) Ps[r * RX + c] = v[r * CX + c];
    }
  };

  if constexpr (NT == 7) {
    // col[l][p % 3][i]: level l's value at the thread's cell i in plane p
    float col[J][3][NP];
#pragma unroll 1
    for (int t0 = 0; t0 < T; t0 += 3) {
#pragma unroll
      for (int ph = 0; ph < 3; ++ph) {
        const int t = t0 + ph;
        if (t >= T) break;
        cp_async_wait<S3_AHEAD - 1>();
        __syncthreads();  // plane t - 1 is in; every level's step t - 1 is done
        if (t + S3_AHEAD - 1 < Zw) load_plane(t + S3_AHEAD - 1, ld_slot);
        cp_async_commit();
        ld_slot = ld_slot + 1 == NB0 ? 0 : ld_slot + 1;
        rd_slot = rd_slot + 1 == NB0 ? 0 : rd_slot + 1;
        // level 0: the thread's cells of plane t - 1 (slot (t - 1) % 3 = (ph + 2) % 3)
        if (t >= 1 && t - 1 < Zw) {
          const float* P0 = L0 + rd_slot * PL + base;
#pragma unroll
          for (int r = 0; r < CY; ++r) s3_row<CX>(&col[0][(ph + 2) % 3][r * CX], P0 + r * RX);
        }
        const int prev = rd_slot == 0 ? NB0 - 1 : rd_slot - 1;  // plane t - 2
#pragma unroll
        for (int s = J; s >= 1; --s) {
          const int q = t - 2 * s;  // the plane level s computes
          if (q < s || q >= Zw - s) continue;
          // plane q of level s - 1: the input ring, or slot q % 3 of level s - 1
          const int qs = ((ph - 2 * s) % 3 + 3) % 3;  // q % 3, from t0 % 3 == 0
          const float* Pm = s == 1 ? L0 + prev * PL + base : LS + ((s - 2) * R + qs) * PL + base;
          float* Ps = s < J ? LS + ((s - 1) * R + qs) * PL + base : nullptr;
          const int z = z0 + q;
          float* oz = out + (size_t)(oz0 + q - J) * OY * OX;
          const int im = (qs + 2) % 3, ip = (qs + 1) % 3;  // planes q - 1 and q + 1
          // level s - 1 at plane q: the thread's own cells in registers,
          // the rows beside its strip from shared memory, the columns
          // beside its own from the lanes beside it
          const float(&m)[NP] = col[s - 1][qs];
          float west[CY], east[CY], above[CX], below[CX];
#pragma unroll
          for (int r = 0; r < CY; ++r) {
            west[r] = __shfl_up_sync(0xffffffffu, m[r * CX + CX - 1], 1);
            east[r] = __shfl_down_sync(0xffffffffu, m[r * CX], 1);
          }
          s3_row<CX>(above, Pm - RX);
          s3_row<CX>(below, Pm + CY * RX);
          float v[NP];
#pragma unroll
          for (int r = 0; r < CY; ++r)
#pragma unroll
            for (int c = 0; c < CX; ++c) {
              const int i = r * CX + c;
              const float n = r > 0 ? m[i - CX] : above[c];
              const float so = r < CY - 1 ? m[i + CX] : below[c];
              const float w = c > 0 ? m[i - 1] : west[r];
              const float e = c < CX - 1 ? m[i + 1] : east[r];
              float u = __fmul_rn(p.w[0], col[s - 1][im][i]);
              u = __fadd_rn(u, __fmul_rn(p.w[1], col[s - 1][ip][i]));
              u = __fadd_rn(u, __fmul_rn(p.w[2], n));
              u = __fadd_rn(u, __fmul_rn(p.w[3], so));
              u = __fadd_rn(u, __fmul_rn(p.w[4], w));
              u = __fadd_rn(u, __fmul_rn(p.w[5], e));
              v[i] = __fadd_rn(u, __fmul_rn(p.w[6], m[i]));
            }
          finish(v, s, z, Ps, oz);
          if (s < J) {
#pragma unroll
            for (int i = 0; i < NP; ++i) col[s][qs][i] = v[i];
          }
        }
      }
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < T; ++t) {
      cp_async_wait<S3_AHEAD - 1>();
      __syncthreads();
      if (t + S3_AHEAD - 1 < Zw) load_plane(t + S3_AHEAD - 1, ld_slot);
      cp_async_commit();
      ld_slot = ld_slot + 1 == NB0 ? 0 : ld_slot + 1;
      rd_slot = rd_slot + 1 == NB0 ? 0 : rd_slot + 1;
      const int r2 = rd_slot == 0 ? NB0 - 1 : rd_slot - 1;  // planes t - 2 and t - 3
      const int r3 = r2 == 0 ? NB0 - 1 : r2 - 1;
#pragma unroll
      for (int s = J; s >= 1; --s) {
        const int q = t - 2 * s;
        if (q < s || q >= Zw - s) continue;
        // planes q - 1, q, q + 1 of level s - 1
        const float* Pq[3];
        if (s == 1) {
          Pq[0] = L0 + r3 * PL + base;
          Pq[1] = L0 + r2 * PL + base;
          Pq[2] = L0 + rd_slot * PL + base;
        } else {
#pragma unroll
          for (int d = 0; d < 3; ++d) Pq[d] = LS + ((s - 2) * R + ((q - 1 + d) & 3)) * PL + base;
        }
        float* Ps = s < J ? LS + ((s - 1) * R + (q & 3)) * PL + base : nullptr;
        float* oz = out + (size_t)(oz0 + q - J) * OY * OX;
        float v[NP];
#pragma unroll
        for (int r = 0; r < CY; ++r)
#pragma unroll
          for (int c = 0; c < CX; ++c) {
            const int o = r * RX + c;
            float u = 0.f;
#pragma unroll
            for (int n = 0; n < 27; ++n) {
              const int dz = n / 9, dy = n / 3 % 3 - 1, dx = n % 3 - 1;
              const float term = __fmul_rn(p.w[n], Pq[dz][o + dy * RX + dx]);
              u = n == 0 ? term : __fadd_rn(u, term);
            }
            v[r * CX + c] = u;
          }
        finish(v, s, z0 + q, Ps, oz);
      }
    }
  }
  cp_async_wait<0>();
}

template <int NT, int J>
static int launch3(const Stream3& p, int blocks, cudaStream_t s) {
  const size_t smem = s3_smem<NT, J>();
  cudaError_t e = cudaFuncSetAttribute(stream3d_kernel<NT, J>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  stream3d_kernel<NT, J><<<blocks, S3_THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int NT, int J>
static int occupancy3(int* per_sm, int* smem, int* rows, int* cols) {
  *smem = (int)s3_smem<NT, J>();
  *rows = S3Win<J>::RY;
  *cols = S3Win<J>::RX;
  cudaError_t e = cudaFuncSetAttribute(stream3d_kernel<NT, J>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, stream3d_kernel<NT, J>,
                                                      S3_THREADS, *smem);
  return (int)e;
}

#define S3_DISPATCH(NT, j, FN, ...)           \
  switch (j) {                                \
    case 1: return FN<NT, 1>(__VA_ARGS__);    \
    case 2: return FN<NT, 2>(__VA_ARGS__);    \
    case 3: return FN<NT, 3>(__VA_ARGS__);    \
    case 4: return FN<NT, 4>(__VA_ARGS__);    \
    case 5: return FN<NT, 5>(__VA_ARGS__);    \
    case 6: return FN<NT, 6>(__VA_ARGS__);    \
    case 7: return FN<NT, 7>(__VA_ARGS__);    \
    case 8: return FN<NT, 8>(__VA_ARGS__);    \
  }

// The window of a launch of j substeps (rows, columns), its shared memory
// and the blocks of it an SM holds at once; nt = 7 or 27.
extern "C" int ts_stream3d_occupancy(int nt, int j, int* per_sm, int* smem, int* rows,
                                     int* cols) {
  if (nt == 7) {
    S3_DISPATCH(7, j, occupancy3, per_sm, smem, rows, cols)
  } else if (nt == 27) {
    S3_DISPATCH(27, j, occupancy3, per_sm, smem, rows, cols)
  }
  return (int)cudaErrorInvalidValue;
}

// One launch of j substeps. `ints` = {cz, cy, cx, K, done, j, gi, ghost_y,
// ghost_x, ty, tx, zc}: (ty, tx) must be the window of j less its apron,
// zc the output planes a block (ops.stencil_stream.stream3d_plan); `w`
// holds nt = 7 or 27 weights.
extern "C" int ts_stream3d(const float* core, const float* mz, const float* pz,
                           const float* gy, const float* gx, const float* gc,
                           const float* rhs, const int* flags, float* out, int nb,
                           const int* ints, float rhs_coeff, int nt, const float* w,
                           void* stream) {
  Stream3 p{};
  p.core = core; p.mz = mz; p.pz = pz; p.gy = gy; p.gx = gx; p.gc = gc;
  p.rhs = rhs; p.flags = flags; p.out = out;
  p.cz = ints[0]; p.cy = ints[1]; p.cx = ints[2];
  p.K = ints[3]; p.done = ints[4];
  const int j = ints[5];
  p.gi = ints[6];
  p.ghost_y = ints[7]; p.ghost_x = ints[8];
  const int ty = ints[9], tx = ints[10];
  p.zc = ints[11];
  p.go = p.K - p.done - j;
  p.rhs_coeff = rhs_coeff;
  if (nb < 1 || p.cz < 1 || p.cy < 1 || p.cx < 1 || p.K < 1 || j < 1 || j > S3_MAX_J ||
      p.done < 0 || p.go < 0 || p.zc < 1 || (nt != 7 && nt != 27) || core == nullptr ||
      flags == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (p.gi < 0 && (mz == nullptr || pz == nullptr || (p.ghost_y && gy == nullptr) ||
                   (p.ghost_x && gx == nullptr) || (p.ghost_y && p.ghost_x && gc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (p.gi >= 0 && p.gi != p.go + j) return (int)cudaErrorInvalidValue;
  // the tile must be the kernel's window less its apron
  const int wrows = S3_WARPS * 3, wcols = j <= 4 ? 64 : 32;
  if (ty != wrows - 2 * j || tx != wcols - 2 * j) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nt; ++i) p.w[i] = w[i];
  const long long OZ = p.cz + 2 * p.go, OY = p.cy + 2 * p.go, OX = p.cx + 2 * p.go;
  p.nzc = (int)((OZ + p.zc - 1) / p.zc);
  p.nty = (int)((OY + ty - 1) / ty);
  p.ntx = (int)((OX + tx - 1) / tx);
  const long long blocks = (long long)nb * p.nzc * p.nty * p.ntx;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nt == 7) {
    S3_DISPATCH(7, j, launch3, p, (int)blocks, s)
  } else {
    S3_DISPATCH(27, j, launch3, p, (int)blocks, s)
  }
  return (int)cudaErrorInvalidValue;
}
