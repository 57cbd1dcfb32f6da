// Hand-written Hopper (sm_90a) kernel for the one-step 3D 7-point stencils.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/stencil_kernel.py:
//   seven_point3d_kernel<PADDED> <- seven_point_banded_pallas    (:313, _band3d_kernel :286)
//   seven_point3d_kernel<STRIPS> <- seven_point_strips_pallas    (:377, _strips3d_kernel :359)
//   seven_point3d_kernel<ASM>    <- seven_point_assembled_pallas (:538, _asm3d_kernel :484,
//                                                                 _asm3d_compute :428)
//
// What they compute: one 7-point update of every rank's (cz, cy, cx) core,
// out of place. The three functions differ only in where a ghost value
// lives (Src3 below) and in where the centre term stands in the sum, so
// one kernel serves all three:
//   PADDED  the (cz+2, cy+2, cx+2) padded tile holds all six ghost faces;
//   STRIPS  a z-padded (cz+2, cy, cx) array holds the z faces, the y faces
//           are (cz, 1, cx) strips and the x faces (cz, cy, 1) strips;
//   ASM     the bare core, with (1, cy, cx) z planes and the same y/x
//           strips; an absent strip pair means that axis self-wraps, and
//           the ghost line is the core's own far line.
// ASM also takes the optional pointwise term of _asm3d_compute: each
// output cell gets fc * fterm at its own coordinates, added last.
//
// The TPU kernels pipeline z bands of whole planes through VMEM; their
// band rules (a divisor band within a VMEM budget, at least two bands)
// have no counterpart here. A block owns a 64 x 8 column of a 32-plane z
// chunk and a thread marches one (y, x) line of it plane by plane: the z
// neighbours ride in registers, fetched two planes ahead, and the four y/x
// neighbours are read through the L1, where the rows that the block's
// other threads have just fetched still sit. Where a neighbour lies (the
// same array one row or column over, a strip, or the core's own far line)
// is settled once per thread before the march, as a pointer and a stride a
// plane, so the loop has no branch and no index arithmetic beyond a few
// pointer steps. There is no shared-memory stage and no block barrier: a
// first version with one (a plane's tile and apron in shared memory, two
// barriers a plane) took two to three times as long on an H100 (PERF.md).
// Two blocks an SM: at most 64 registers a thread.
//
// Terms: all three functions sum the six faces in FACES order (-z, +z, -y,
// +y, -x, +x); they differ in the centre term, which comes first (PADDED,
// when it is not 0), last (STRIPS when it is not 0, ASM always) or not at
// all. Products and sums are rounded one by one (__fmul_rn / __fadd_rn,
// never contracted), so the kernel agrees bit for bit with its plain
// torch version.
//
// Bound: bytes. One step must read the input once and write the core
// once, 8 bytes a cell; its 13 float operations a cell are far below the
// card's rate for that traffic.

#include <cuda_runtime.h>

#include "stencil_taps.cuh"

constexpr int S3_TX = 64;
constexpr int S3_TY = 8;
constexpr int S3_ZCHUNK = 32;

enum { S3_PADDED = 0, S3_STRIPS = 1, S3_ASM = 2 };
enum { S3_NO_CENTRE = 0, S3_CENTRE_FIRST = 1, S3_CENTRE_LAST = 2 };

struct Src3 {
  const float* a;    // padded tile | z-padded core | core
  const float* mz;   // ASM: the -z and +z arrival planes
  const float* pz;
  const float* my;   // STRIPS, ASM: the y strips (null in ASM: y self-wraps)
  const float* py;
  const float* mx;   // STRIPS, ASM: the x strips (null in ASM: x self-wraps)
  const float* px;
};

// A thread's view of one neighbour along its z march: plane z at p + z * step.
struct Line {
  const float* p;
  size_t step;
};

template <int MODE, int CENTRE>
__global__ void __launch_bounds__(S3_TX* S3_TY, 2)
seven_point3d_kernel(Src3 s, const float* __restrict__ fterm, float fc,
                     float* __restrict__ out, int cz, int cy, int cx, int nzc,
                     const float w0, const float w1, const float w2, const float w3,
                     const float w4, const float w5, const float w6) {
  const int x = blockIdx.x * S3_TX + threadIdx.x, y = blockIdx.y * S3_TY + threadIdx.y;
  if (x >= cx || y >= cy) return;
  const size_t rank = blockIdx.z / nzc;
  const int z0 = (blockIdx.z % nzc) * S3_ZCHUNK;
  const int z1 = min(z0 + S3_ZCHUNK, cz);
  const size_t plane = (size_t)cy * cx, cells = plane * cz;

  // the array's own geometry: row and plane strides, and the core's origin
  const size_t row = MODE == S3_PADDED ? cx + 2 : cx;
  const size_t slab = MODE == S3_PADDED ? (size_t)(cy + 2) * (cx + 2) : plane;
  const float* a = s.a + rank * slab * (MODE == S3_ASM ? cz : cz + 2) +
                   (MODE == S3_PADDED ? slab + row + 1 : MODE == S3_STRIPS ? slab : 0);
  const float* c = a + y * row + x;  // this thread's line: c[z * slab], z in [-1, cz]
  Line n{c - row, slab}, so{c + row, slab}, we{c - 1, slab}, ea{c + 1, slab};
  if (MODE != S3_PADDED) {
    const float* my = s.my ? s.my + rank * cz * cx : nullptr;
    const float* py = s.py ? s.py + rank * cz * cx : nullptr;
    const float* mx = s.mx ? s.mx + rank * cz * cy : nullptr;
    const float* px = s.px ? s.px + rank * cz * cy : nullptr;
    // a null strip (ASM only): the axis self-wraps onto the core's far line
    if (y == 0) n = my ? Line{my + x, (size_t)cx} : Line{c + (size_t)(cy - 1) * row, slab};
    if (y == cy - 1) so = py ? Line{py + x, (size_t)cx} : Line{c - (size_t)(cy - 1) * row, slab};
    if (x == 0) we = mx ? Line{mx + y, (size_t)cy} : Line{c + (cx - 1), slab};
    if (x == cx - 1) ea = px ? Line{px + y, (size_t)cy} : Line{c - (cx - 1), slab};
  }
  // ASM keeps planes -1 and cz apart from the core
  auto centre = [&](int z) -> float {
    if (MODE == S3_ASM) {
      if (z < 0) return s.mz[rank * plane + (size_t)y * cx + x];
      if (z >= cz) return s.pz[rank * plane + (size_t)y * cx + x];
    }
    return c[(ptrdiff_t)z * (ptrdiff_t)slab];
  };
  // every pointer below steps one plane an iteration
  n.p += z0 * n.step;
  so.p += z0 * so.step;
  we.p += z0 * we.step;
  ea.p += z0 * ea.step;
  const size_t first = (size_t)z0 * plane + (size_t)y * cx + x;
  const float* f = fterm ? fterm + rank * cells + first : nullptr;
  float* o = out + rank * cells + first;

  float prev = centre(z0 - 1), cur = centre(z0), next = centre(z0 + 1);
  auto step = [&](float ahead) {
    float v = __fmul_rn(w0, prev);
    if (CENTRE == S3_CENTRE_FIRST) v = __fadd_rn(__fmul_rn(w6, cur), v);
    v = __fadd_rn(v, __fmul_rn(w1, next));
    v = __fadd_rn(v, __fmul_rn(w2, *n.p));
    v = __fadd_rn(v, __fmul_rn(w3, *so.p));
    v = __fadd_rn(v, __fmul_rn(w4, *we.p));
    v = __fadd_rn(v, __fmul_rn(w5, *ea.p));
    if (CENTRE == S3_CENTRE_LAST) v = __fadd_rn(v, __fmul_rn(w6, cur));
    if (f) {
      v = __fadd_rn(v, __fmul_rn(fc, *f));
      f += plane;
    }
    *o = v;
    o += plane;
    n.p += n.step;
    so.p += so.step;
    we.p += we.step;
    ea.p += ea.step;
    prev = cur;
    cur = next;
    next = ahead;
  };
  // ASM: planes z + 2 < cz come from the core itself with no test in the
  // loop, and the last two planes (the +z arrival plane ahead, then none)
  // are peeled off. On an H100 that is about a tenth faster for this form;
  // the other two forms, whose test is a plain bound, are slower peeled.
  int z = z0;
  if (MODE == S3_ASM) {
    const float* pa = c + (size_t)(z0 + 2) * slab;
    for (const int zbody = min(z1 - 1, cz - 2); z < zbody; ++z, pa += slab) step(*pa);
  }
  for (; z < z1; ++z) step(z + 1 < z1 ? centre(z + 2) : 0.f);
}

template <int MODE>
static void launch3d(int centre, dim3 grid, dim3 block, cudaStream_t st, const Src3& src,
                     const float* fterm, float fc, float* out, int cz, int cy, int cx,
                     int nzc, const float* w) {
#define S3_LAUNCH(C)                                                               \
  seven_point3d_kernel<MODE, C><<<grid, block, 0, st>>>(src, fterm, fc, out, cz, cy, cx, \
                                                        nzc, w[0], w[1], w[2], w[3], w[4], \
                                                        w[5], w[6])
  if (centre == S3_CENTRE_FIRST) S3_LAUNCH(S3_CENTRE_FIRST);
  else if (centre == S3_CENTRE_LAST) S3_LAUNCH(S3_CENTRE_LAST);
  else S3_LAUNCH(S3_NO_CENTRE);
#undef S3_LAUNCH
}

// `w` = the six face weights in FACES order and the centre's; `centre`
// says where the centre term goes (S3_NO_CENTRE, _FIRST or _LAST).
extern "C" int ts_seven_point3d(int mode, const float* a, const float* mz,
                                const float* pz, const float* my, const float* py,
                                const float* mx, const float* px, const float* fterm,
                                float fc, float* out, int nb, int cz, int cy, int cx,
                                int centre, const float* w, void* stream) {
  if (nb < 1 || cz < 1 || cy < 1 || cx < 1 || a == nullptr || out == nullptr || w == nullptr ||
      centre < S3_NO_CENTRE || centre > S3_CENTRE_LAST)
    return (int)cudaErrorInvalidValue;
  if ((my == nullptr) != (py == nullptr) || (mx == nullptr) != (px == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == S3_STRIPS && (my == nullptr || mx == nullptr)) return (int)cudaErrorInvalidValue;
  if (mode == S3_ASM && (mz == nullptr || pz == nullptr)) return (int)cudaErrorInvalidValue;
  if (mode != S3_ASM && fterm != nullptr) return (int)cudaErrorInvalidValue;
  const int nzc = (cz + S3_ZCHUNK - 1) / S3_ZCHUNK;
  if ((long long)nb * nzc > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((cx + S3_TX - 1) / S3_TX, (cy + S3_TY - 1) / S3_TY, nb * nzc);
  const dim3 block(S3_TX, S3_TY);
  const Src3 src{a, mz, pz, my, py, mx, px};
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == S3_PADDED)
    launch3d<S3_PADDED>(centre, grid, block, st, src, fterm, fc, out, cz, cy, cx, nzc, w);
  else if (mode == S3_STRIPS)
    launch3d<S3_STRIPS>(centre, grid, block, st, src, fterm, fc, out, cz, cy, cx, nzc, w);
  else if (mode == S3_ASM)
    launch3d<S3_ASM>(centre, grid, block, st, src, fterm, fc, out, cz, cy, cx, nzc, w);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
