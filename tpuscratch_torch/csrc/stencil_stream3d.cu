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
// and that is what this kernel runs: a block owns a (tz, ty, tx) output
// tile, loads its window with a j-cell apron once into shared memory and
// runs j shrinking substeps there, ping-ponging two buffers.
//
// Open ends: per-rank flags [z-, z+, y-, y+, x-, x+]. After every substep
// but the pass's last, each cell outside the core on a flagged side is
// set to zero (stencil_stream.py:406-485); the y and x flags count only on
// a ghosted axis, as a self-wrapping axis has no end.
//
// rhs: each substep adds rhs_coeff * rhs at the cell's own coordinates,
// rhs pre-ghosted to planes [-K, cz + K); y and x self-wrap in this mode.
//
// A pass deeper than one block's shared memory seats is chained: a launch
// of j < K substeps writes the dense volume [-go, c + go)^3 with go the
// ghost rings still to be consumed, and the next launch reads that volume
// (gi >= 0) instead of the slabs and strips.
//
// Terms. 7 points: w0*up + w1*down + w2*north + w3*south + w4*west +
// w5*east + w6*centre, left to right, all seven always (_asm3d_compute),
// then the rhs term. 27 points: the weight cube in (dz, dy, dx) order,
// none skipped, for every cell (the TPU kernel sums its border columns in
// (dz, dx, dy) order). Every product and sum is rounded on its own, so
// the kernel agrees bit for bit with its plain torch version. In the
// 7-point substep a thread marches a (y, x) column of the window along z
// with the z neighbours in registers: 5 shared-memory reads a cell.
//
// Bound: bytes for shallow passes (read the core, slabs and strips once,
// write the core once: about 8 bytes a cell per K substeps), operations
// from K = 4 on (13 a cell a substep, 53 at 27 points). The price of the
// window is redundant work in its apron: an 8x16x32 tile at K = 4 loads a
// 16x24x40 window, 3.75 cells per output cell.

#include <cuda_runtime.h>

#include "stencil_taps.cuh"

constexpr int S3S_MAX_THREADS = 1024;

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
  int j;               // substeps of this launch
  int gi;              // dense input apron, or -1: read the slabs and strips
  int go;              // output apron, K - done - j
  int ghost_y, ghost_x;
  float rhs_coeff;
  int tz, ty, tx;      // output tile
  int ntz;             // z tiles a rank
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

// One (z, y) row of the extended volume: `mid` holds its cx core columns
// (or, in dense mode, all cx + 2gi columns) and `side` the 2K ghost columns
// [plus | minus] beside them; null `side` means x self-wraps, null `mid`
// a row past the volume's end, which reads as 0 (such cells feed only
// outputs that are not stored).
struct Row {
  const float* mid;
  const float* side;
};

__device__ Row row_of(const Stream3& p, size_t rank, int z, int y) {
  const int cz = p.cz, cy = p.cy, cx = p.cx, K = p.K;
  Row r{nullptr, nullptr};
  if (p.gi >= 0) {
    const int g = p.gi, Z = cz + 2 * g, Y = cy + 2 * g, X = cx + 2 * g;
    const int zi = z + g, yi = y + g;
    if (zi >= 0 && zi < Z && yi >= 0 && yi < Y) r.mid = p.core + ((rank * Z + zi) * Y + yi) * X;
    return r;
  }
  if (z < -K || z >= cz + K) return r;
  const size_t zi = rank * (cz + 2 * K) + (z + K);
  if (p.ghost_y && (y < 0 || y >= cy)) {
    if (y < -K || y >= cy + K) return r;
    const int ry = y >= cy ? y - cy : y + 2 * K;
    r.mid = p.gy + (zi * 2 * K + ry) * cx;
    if (p.ghost_x) r.side = p.gc + (zi * 2 * K + ry) * 2 * K;
    return r;
  }
  y = wrap(y, cy);
  r.mid = z < 0    ? p.mz + ((rank * K + (z + K)) * cy + y) * cx
          : z >= cz ? p.pz + ((rank * K + (z - cz)) * cy + y) * cx
                    : p.core + ((rank * cz + z) * cy + y) * cx;
  if (p.ghost_x) r.side = p.gx + (zi * cy + y) * 2 * K;
  return r;
}

__device__ __forceinline__ float row_at(const Stream3& p, const Row& r, int x) {
  if (r.mid == nullptr) return 0.f;
  if (p.gi >= 0) {
    const int xi = x + p.gi;
    return xi >= 0 && xi < p.cx + 2 * p.gi ? r.mid[xi] : 0.f;
  }
  if (x >= 0 && x < p.cx) return r.mid[x];
  if (r.side == nullptr) return r.mid[wrap(x, p.cx)];
  if (x < -p.K || x >= p.cx + p.K) return 0.f;
  return r.side[x >= p.cx ? x - p.cx : x + 2 * p.K];
}

template <int NT>
__global__ void __launch_bounds__(S3S_MAX_THREADS)
stream3d_kernel(Stream3 p) {
  extern __shared__ float smem[];
  const int j = p.j;
  const int RZ = p.tz + 2 * j, RY = p.ty + 2 * j, RX = p.tx + 2 * j;
  const int plane = RY * RX, vol = RZ * plane;
  float* a = smem;
  float* b = smem + vol;
  const size_t rank = blockIdx.z / p.ntz;
  const int zt = blockIdx.z % p.ntz;
  // the window's origin, in core coordinates
  const int z0 = zt * p.tz - p.go - j;
  const int y0 = blockIdx.y * p.ty - p.go - j;
  const int x0 = blockIdx.x * p.tx - p.go - j;

  // the window, a (z, y) row a warp: the row's source is resolved once
  for (int row = threadIdx.x >> 5; row < RZ * RY; row += blockDim.x >> 5) {
    const Row src = row_of(p, rank, z0 + row / RY, y0 + row % RY);
    for (int lx = threadIdx.x & 31; lx < RX; lx += 32)
      a[row * RX + lx] = row_at(p, src, x0 + lx);
  }
  __syncthreads();

  const int* f = p.flags + rank * 6;
  const bool open_zm = f[0], open_zp = f[1];
  const bool open_ym = p.ghost_y && f[2], open_yp = p.ghost_y && f[3];
  const bool open_xm = p.ghost_x && f[4], open_xp = p.ghost_x && f[5];
  const float* rhs = p.rhs ? p.rhs + rank * (p.cz + 2 * p.K) * p.cy * p.cx : nullptr;

  for (int st = 1; st <= j; ++st) {
    const bool pin = p.done + st < p.K;  // ghosts are still in play after this substep
    const int ny = RY - 2 * st, nx = RX - 2 * st;
    for (int col = threadIdx.x; col < ny * nx; col += blockDim.x) {
      const int ly = col / nx + st, lx = col % nx + st;
      const int y = y0 + ly, x = x0 + lx;
      const bool zero_col = pin && ((open_ym && y < 0) || (open_yp && y >= p.cy) ||
                                    (open_xm && x < 0) || (open_xp && x >= p.cx));
      const size_t rhs_col = rhs ? (size_t)wrap(y, p.cy) * p.cx + wrap(x, p.cx) : 0;
      int pc = ((st - 1) * RY + ly) * RX + lx;
      float zm = 0.f, c = 0.f;
      if (NT == 7) {
        zm = a[pc];
        c = a[pc + plane];
      }
      for (int lz = st; lz < RZ - st; ++lz) {
        pc += plane;  // the index of (lz, ly, lx)
        float v;
        if (NT == 7) {
          const float zp = a[pc + plane];
          v = __fmul_rn(p.w[0], zm);
          v = __fadd_rn(v, __fmul_rn(p.w[1], zp));
          v = __fadd_rn(v, __fmul_rn(p.w[2], a[pc - RX]));
          v = __fadd_rn(v, __fmul_rn(p.w[3], a[pc + RX]));
          v = __fadd_rn(v, __fmul_rn(p.w[4], a[pc - 1]));
          v = __fadd_rn(v, __fmul_rn(p.w[5], a[pc + 1]));
          v = __fadd_rn(v, __fmul_rn(p.w[6], c));
          zm = c;
          c = zp;
        } else {
          v = 0.f;
#pragma unroll
          for (int t = 0; t < 27; ++t) {
            const int dz = t / 9 - 1, dy = t / 3 % 3 - 1, dx = t % 3 - 1;
            const float term = __fmul_rn(p.w[t], a[pc + dz * plane + dy * RX + dx]);
            v = t == 0 ? term : __fadd_rn(v, term);
          }
        }
        const int z = z0 + lz;
        if (rhs && z >= -p.K && z < p.cz + p.K)
          v = __fadd_rn(v, __fmul_rn(p.rhs_coeff, rhs[(size_t)(z + p.K) * p.cy * p.cx + rhs_col]));
        if (zero_col || (pin && ((open_zm && z < 0) || (open_zp && z >= p.cz)))) v = 0.f;
        b[pc] = v;
      }
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }

  const int OZ = p.cz + 2 * p.go, OY = p.cy + 2 * p.go, OX = p.cx + 2 * p.go;
  const int tvol = p.tz * p.ty * p.tx;
  for (int q = threadIdx.x; q < tvol; q += blockDim.x) {
    const int lz = q / (p.ty * p.tx), r = q % (p.ty * p.tx);
    const int ly = r / p.tx, lx = r % p.tx;
    const int oz = zt * p.tz + lz, oy = blockIdx.y * p.ty + ly, ox = blockIdx.x * p.tx + lx;
    if (oz < OZ && oy < OY && ox < OX)
      p.out[((rank * OZ + oz) * OY + oy) * OX + ox] = a[((j + lz) * RY + j + ly) * RX + j + lx];
  }
}

// One launch of j substeps. `ints` = {cz, cy, cx, K, done, j, gi, ghost_y,
// ghost_x, tz, ty, tx, threads}; `w` holds nt = 7 or 27 weights.
extern "C" int ts_stream3d(const float* core, const float* mz, const float* pz,
                           const float* gy, const float* gx, const float* gc,
                           const float* rhs, const int* flags, float* out, int nb,
                           const int* ints, float rhs_coeff, int nt, const float* w,
                           void* stream) {
  Stream3 p{};
  p.core = core; p.mz = mz; p.pz = pz; p.gy = gy; p.gx = gx; p.gc = gc;
  p.rhs = rhs; p.flags = flags; p.out = out;
  p.cz = ints[0]; p.cy = ints[1]; p.cx = ints[2];
  p.K = ints[3]; p.done = ints[4]; p.j = ints[5]; p.gi = ints[6];
  p.ghost_y = ints[7]; p.ghost_x = ints[8];
  p.tz = ints[9]; p.ty = ints[10]; p.tx = ints[11];
  const int threads = ints[12];
  p.go = p.K - p.done - p.j;
  p.rhs_coeff = rhs_coeff;
  if (nb < 1 || p.cz < 1 || p.cy < 1 || p.cx < 1 || p.K < 1 || p.j < 1 || p.done < 0 ||
      p.go < 0 || p.tz < 1 || p.ty < 1 || p.tx < 1 || threads < 32 ||
      threads > S3S_MAX_THREADS || (nt != 7 && nt != 27) || core == nullptr ||
      flags == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if (p.gi < 0 && (mz == nullptr || pz == nullptr || (p.ghost_y && gy == nullptr) ||
                   (p.ghost_x && gx == nullptr) || (p.ghost_y && p.ghost_x && gc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (p.gi >= 0 && p.gi != p.go + p.j) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nt; ++i) p.w[i] = w[i];
  p.ntz = (p.cz + 2 * p.go + p.tz - 1) / p.tz;
  if ((long long)nb * p.ntz > 65535) return (int)cudaErrorInvalidValue;
  const size_t vol = (size_t)(p.tz + 2 * p.j) * (p.ty + 2 * p.j) * (p.tx + 2 * p.j);
  const size_t smem = 2 * vol * sizeof(float);
  auto kernel = nt == 7 ? stream3d_kernel<7> : stream3d_kernel<27>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.cx + 2 * p.go + p.tx - 1) / p.tx,
                  (p.cy + 2 * p.go + p.ty - 1) / p.ty, nb * p.ntz);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
