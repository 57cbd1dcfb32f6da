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
// torch version, which rounds each operation as well.
//
// No kernel writes the buffer it reads within one step: five_point and
// deep_trapezoid write a fresh core, resident_periodic ping-pongs between
// two scratch buffers and never writes its input.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <climits>

namespace cg = cooperative_groups;

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
// deep_trapezoid: `steps` valid-region 5-point steps (the shrink_step
// pyramid) of nb inputs (nb, ih, iw); output (i, j) is the pyramid's value
// at input (i + off, j + off), for an (oh, ow) output, off >= steps.
// Temporal blocking in shared memory: a block owns a T x T output tile,
// loads its (T + 2*steps)^2 input window once, runs the `steps` shrinking
// substeps ping-ponging two shared buffers between __syncthreads, and
// writes its output tile once. Cells of a ragged window that lie past the
// input are loaded as 0; they only feed outputs that are not stored.
// Bound: bytes. Per `steps` substeps it must read the input and write the
// output once, (ih*iw + oh*ow)*4 bytes: at 1024^2 with k=16, 8.7 MB, 2.6 us
// at 3.35 TB/s (instead of ~k passes for the torch pyramid). The price is
// redundant work on the window's ring: sum_j (T+2*steps-2j)^2 cell updates
// per T^2 outputs, about 2.25x at T=64, k=32. Shared memory holds
// 2*(T+2*steps)^2 floats: 128 KB at T=64, k=32, above the 48 KB static
// limit, so the launcher raises the kernel's dynamic shared-memory cap.
constexpr int DT_THREADS = 512;

__global__ void __launch_bounds__(DT_THREADS)
deep_trapezoid_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int ih, int iw, int oh, int ow, int off, int steps,
                      int T, Coeffs k) {
  extern __shared__ float smem[];
  const int R = T + 2 * steps;
  float* a = smem;
  float* nxt = smem + R * R;
  const size_t b = blockIdx.z;
  const float* t = in + b * (size_t)ih * iw;
  float* o = out + b * (size_t)oh * ow;
  const int i0 = blockIdx.y * T, j0 = blockIdx.x * T;
  const int gy0 = i0 + off - steps, gx0 = j0 + off - steps;  // >= 0
  for (int q = threadIdx.x; q < R * R; q += blockDim.x) {
    const int ly = q / R, lx = q - ly * R;
    const int gy = gy0 + ly, gx = gx0 + lx;
    a[q] = (gy < ih && gx < iw) ? t[(size_t)gy * iw + gx] : 0.f;
  }
  __syncthreads();
  for (int st = 1; st <= steps; ++st) {
    const int n = R - 2 * st;  // substep st is valid on [st, R - st)^2
    for (int q = threadIdx.x; q < n * n; q += blockDim.x) {
      const int y = q / n, x = q - y * n;
      const int p = (st + y) * R + st + x;
      nxt[p] = five(k, a[p - R], a[p + R], a[p - 1], a[p + 1], a[p]);
    }
    __syncthreads();
    float* tmp = a;
    a = nxt;
    nxt = tmp;
  }
  for (int q = threadIdx.x; q < T * T; q += blockDim.x) {
    const int y = q / T, x = q - y * T;
    const int oi = i0 + y, oj = j0 + x;
    if (oi < oh && oj < ow) o[(size_t)oi * ow + oj] = a[(steps + y) * R + steps + x];
  }
}

extern "C" int ts_deep_trapezoid(const float* in, float* out, int nb, int ih,
                                 int iw, int oh, int ow, int off, int steps,
                                 int tile, float cn, float cs, float cw,
                                 float ce, float cc, void* stream) {
  if (nb < 1 || nb > 65535 || tile < 1 || steps < 1 || off < steps ||
      oh + off + steps > ih || ow + off + steps > iw)
    return (int)cudaErrorInvalidValue;
  const int R = tile + 2 * steps;
  const size_t smem = 2ull * R * R * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      deep_trapezoid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((ow + tile - 1) / tile, (oh + tile - 1) / tile, nb);
  deep_trapezoid_kernel<<<grid, DT_THREADS, smem, (cudaStream_t)stream>>>(
      in, out, ih, iw, oh, ow, off, steps, tile, Coeffs{cn, cs, cw, ce, cc});
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// resident_periodic: `steps` periodic 5-point steps of an (H, W) grid in ONE
// cooperative launch. A persistent grid (as many blocks as can be resident
// at once) walks the grid with a grid-stride loop, reading the previous
// state with modular (torus) indexing and writing the next into the other
// of two ping-pong buffers, with grid.sync() between steps. Step 0 reads
// `in`; the state after step s (1-based) is in buf[(s - 1) % 2].
// Symmetric Jacobi (n = s = w = e, c = 0) uses the reference's
// cn*((N + S) + (W + E)) form and order.
// Bound: bytes. The run must read the grid once and write it once; the
// steps in between stay in the 50 MB L2 while both buffers fit there
// (1024^2 f32: 8 MB), which is the rule the wrapper's refusal enforces.
// Per step the kernel pays L2 traffic plus one grid-wide barrier.
constexpr int RP_THREADS = 512;

__global__ void __launch_bounds__(RP_THREADS)
resident_periodic_kernel(const float* __restrict__ in, float* buf0,
                         float* buf1, int H, int W, int steps, int sym,
                         Coeffs k) {
  cg::grid_group grid = cg::this_grid();
  const int n = H * W;
  const int stride = gridDim.x * blockDim.x;
  const float* src = in;
  for (int st = 0; st < steps; ++st) {
    float* dst = (st & 1) ? buf1 : buf0;
    for (int q = blockIdx.x * blockDim.x + threadIdx.x; q < n; q += stride) {
      const int i = q / W, j = q - i * W;
      const int up = (i == 0 ? H - 1 : i - 1), dn = (i == H - 1 ? 0 : i + 1);
      const int lf = (j == 0 ? W - 1 : j - 1), rt = (j == W - 1 ? 0 : j + 1);
      const float vn = src[up * W + j], vs = src[dn * W + j];
      const float vw = src[i * W + lf], ve = src[i * W + rt];
      float v;
      if (sym) {
        v = __fmul_rn(k.n, __fadd_rn(__fadd_rn(vn, vs), __fadd_rn(vw, ve)));
      } else {
        v = __fmul_rn(k.n, vn);
        v = __fadd_rn(v, __fmul_rn(k.s, vs));
        v = __fadd_rn(v, __fmul_rn(k.w, vw));
        v = __fadd_rn(v, __fmul_rn(k.e, ve));
        if (k.c != 0.f) v = __fadd_rn(v, __fmul_rn(k.c, src[q]));
      }
      dst[q] = v;
    }
    grid.sync();  // every block's writes of step st are visible to step st+1
    src = dst;
  }
}

extern "C" int ts_resident_periodic(const float* in, float* buf0, float* buf1,
                                    int H, int W, int steps, int sym,
                                    float cn, float cs, float cw, float ce,
                                    float cc, void* stream) {
  if (H < 1 || W < 1 || steps < 1 || (long long)H * W > INT_MAX)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, resident_periodic_kernel, RP_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long need = ((long long)H * W + RP_THREADS - 1) / RP_THREADS;
  const long long cap = (long long)per_sm * sms;
  const int blocks = (int)(need < cap ? need : cap);
  Coeffs k{cn, cs, cw, ce, cc};
  void* args[] = {(void*)&in, (void*)&buf0, (void*)&buf1, (void*)&H,
                  (void*)&W,  (void*)&steps, (void*)&sym,  (void*)&k};
  e = cudaLaunchCooperativeKernel((void*)resident_periodic_kernel,
                                  dim3(blocks), dim3(RP_THREADS), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
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
