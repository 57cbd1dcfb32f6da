// Shared pieces of the streamed and DMA-halo 2D stencil kernels
// (stencil_stream2d.cu, halo_dma.cu).
//
// A 3x3 stencil is a list of taps in the order its reference sums them:
//   v = c[0]*a(dy[0], dx[0]) + c[1]*a(dy[1], dx[1]) + ...
// left to right, every product and sum rounded on its own (__fmul_rn /
// __fadd_rn are never contracted into FMAs), so a kernel agrees bit for
// bit with its plain torch version. The host leaves out the taps its
// reference skips (the TPU kernels skip zero coefficients statically), so
// one kernel serves every term order of the family.

#pragma once

#include <cuda_runtime.h>

struct Taps {
  int n;        // 1..9 taps in use
  float c[9];   // coefficient of tap i
  int dy[9];    // row offset of tap i, in -1..1
  int dx[9];    // column offset of tap i, in -1..1
};

// The tap sum at p of a row-major buffer with row stride `stride`.
__device__ __forceinline__ float tap_sum(const Taps& t, const float* a, int p,
                                         int stride) {
  float v = __fmul_rn(t.c[0], a[p + t.dy[0] * stride + t.dx[0]]);
#pragma unroll
  for (int i = 1; i < 9; ++i)
    if (i < t.n)
      v = __fadd_rn(v, __fmul_rn(t.c[i], a[p + t.dy[i] * stride + t.dx[i]]));
  return v;
}

// The shared-memory trapezoid (temporal blocking, as deep_trapezoid_kernel
// of stencil2d.cu): a block's R x R input window is in `a`; `k` substeps
// each shrink the valid region by one cell a side, ping-ponging `a` and
// `b` between __syncthreads. After every substep but the last,
// fix(y, x, v) may replace the value at window cell (y, x) (open-boundary
// zeroing). Returns the buffer whose [k, R - k)^2 holds the final values.
template <class Fix>
__device__ float* trapezoid(float* a, float* b, int R, int k, const Taps& taps,
                            Fix fix) {
  for (int st = 1; st <= k; ++st) {
    const int n = R - 2 * st;  // substep st is valid on [st, R - st)^2
    for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
      const int y = q / n + st, x = q % n + st;
      const float v = tap_sum(taps, a, y * R + x, R);
      b[y * R + x] = st < k ? fix(y, x, v) : v;
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Taps from the launcher's host arrays; false if they are not a 3x3 list.
inline bool make_taps(Taps* t, int n, const float* c, const int* dy,
                      const int* dx) {
  if (n < 1 || n > 9) return false;
  *t = Taps{};
  t->n = n;
  for (int i = 0; i < n; ++i) {
    if (dy[i] < -1 || dy[i] > 1 || dx[i] < -1 || dx[i] > 1) return false;
    t->c[i] = c[i];
    t->dy[i] = dy[i];
    t->dx[i] = dx[i];
  }
  return true;
}

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
