// Hand-written Hopper (sm_90a) kernels for device-side initialisation.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/fill.py:
//   fill_kernel   <- fill   (:27, _fill_kernel :22)
//   iota2d_kernel <- iota2d (:46, _iota2d_kernel :37)
// They are the reference's init_vector (ref_parallel-dot-product-atomics.cu
// :45-51) and InitKernel (mpi-2d-stencil-subarray-cuda.cu:17-28), which
// wrote one element per thread (InitKernel as w*h blocks of one thread).
//
// Plain C interface (ctypes): every launcher takes raw pointers and the
// CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.
//
// Bound: bytes. Both only write their output once (no input), so the
// least time is out_bytes / 3.35 TB/s: 0.119 ms for 1e8 f32. A grid sized
// by the SM count strides over the output so every SM streams stores; fill
// writes 16 bytes a store, iota2d one element (coalesced across the warp).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <cstring>

static int grid_for(long long work, int threads) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (work + threads - 1) / threads;
  long long cap = (long long)sms * 8;
  if (want < 1) want = 1;
  return (int)(want < cap ? want : cap);
}

// ---------------------------------------------------------------------------
// fill: write the value's bit pattern into every element. The wrapper casts
// the value on the host (as jnp.asarray([value], dtype) does) and passes its
// bytes, so one kernel serves every dtype by element size (1, 2, 4, 8).
// The body is written as 16-byte stores of the pattern repeated; the tail
// (fewer than 16 bytes) byte by byte.
constexpr int FILL_THREADS = 256;

__global__ void __launch_bounds__(FILL_THREADS)
fill_kernel(unsigned char* __restrict__ out, long long nbytes, uint4 pattern,
            unsigned long long bits, int esize) {
  const long long n16 = nbytes / 16;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4* o = reinterpret_cast<uint4*>(out);
  for (long long q = tid; q < n16; q += stride) o[q] = pattern;
  for (long long b = n16 * 16 + tid; b < nbytes; b += stride)
    out[b] = (unsigned char)(bits >> (8 * (b % esize)));
}

extern "C" int ts_fill(void* out, long long nbytes, unsigned long long bits,
                       int esize, void* stream) {
  if (nbytes < 0 || (esize != 1 && esize != 2 && esize != 4 && esize != 8) ||
      nbytes % esize || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  unsigned char rep[16];
  for (int i = 0; i < 16; ++i) rep[i] = (unsigned char)(bits >> (8 * (i % esize)));
  uint4 pattern;
  memcpy(&pattern, rep, 16);
  fill_kernel<<<grid_for(nbytes / 16 + 1, FILL_THREADS), FILL_THREADS, 0,
                (cudaStream_t)stream>>>((unsigned char*)out, nbytes, pattern,
                                        bits, esize);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// iota2d: out[r, c] = r * w + c computed IN THE DTYPE, as the TPU kernel's
// broadcasted_iota(dtype) * w + broadcasted_iota(dtype) does: r, c and w
// are each converted to the dtype, then one rounded product and one rounded
// sum. In float32 that rounds twice, so above 2^24 it can differ from
// (float)(r * w + c); __fmul_rn / __fadd_rn are never contracted into an
// FMA, so the result is bit-equal to the TPU kernel's and to the plain
// torch version's (two rounded torch ops). bf16 and f16 round each op to
// the dtype (the product and sum of two such values are exact in f32 before
// that rounding); integers wrap as the dtype does.
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ float cvt(long long v) { return __ll2float_rn(v); }
  static __device__ float op(float r, float w, float c) {
    return __fadd_rn(__fmul_rn(r, w), c);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  static __device__ __nv_bfloat16 cvt(long long v) {
    return __float2bfloat16_rn(__ll2float_rn(v));
  }
  static __device__ __nv_bfloat16 op(__nv_bfloat16 r, __nv_bfloat16 w,
                                     __nv_bfloat16 c) {
    __nv_bfloat16 p = __float2bfloat16_rn(
        __fmul_rn(__bfloat162float(r), __bfloat162float(w)));
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(p), __bfloat162float(c)));
  }
};

template <>
struct Arith<__half> {
  static __device__ __half cvt(long long v) {
    return __float2half_rn(__ll2float_rn(v));
  }
  static __device__ __half op(__half r, __half w, __half c) {
    __half p = __float2half_rn(__fmul_rn(__half2float(r), __half2float(w)));
    return __float2half_rn(__fadd_rn(__half2float(p), __half2float(c)));
  }
};

template <>
struct Arith<int32_t> {
  static __device__ int32_t cvt(long long v) { return (int32_t)v; }
  static __device__ int32_t op(int32_t r, int32_t w, int32_t c) {
    return (int32_t)((uint32_t)r * (uint32_t)w + (uint32_t)c);  // wraps
  }
};

template <>
struct Arith<int64_t> {
  static __device__ int64_t cvt(long long v) { return (int64_t)v; }
  static __device__ int64_t op(int64_t r, int64_t w, int64_t c) {
    return (int64_t)((uint64_t)r * (uint64_t)w + (uint64_t)c);
  }
};

constexpr int IOTA_THREADS = 256;

// A 2D grid: rows stride over blockIdx.y, columns over the x threads, so no
// thread divides to find its cell.
template <typename T>
__global__ void __launch_bounds__(IOTA_THREADS)
iota2d_kernel(T* __restrict__ out, long long h, long long w) {
  const T tw = Arith<T>::cvt(w);
  const long long cstride = (long long)gridDim.x * blockDim.x;
  for (long long r = blockIdx.y; r < h; r += gridDim.y) {
    const T tr = Arith<T>::cvt(r);
    T* row = out + r * w;
    for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x; c < w;
         c += cstride)
      row[c] = Arith<T>::op(tr, tw, Arith<T>::cvt(c));
  }
}

// dtype codes: 0 f32, 1 bf16, 2 f16, 3 int32, 4 int64
extern "C" int ts_iota2d(void* out, long long h, long long w, int dtype,
                         void* stream) {
  if (h < 0 || w < 0) return (int)cudaErrorInvalidValue;
  if (h * w == 0) return 0;
  const int gx = grid_for(w, IOTA_THREADS) < 64 ? grid_for(w, IOTA_THREADS) : 64;
  long long gy = grid_for(h * w, IOTA_THREADS) / gx;
  if (gy < 1) gy = 1;
  if (gy > h) gy = h;
  if (gy > 65535) gy = 65535;
  const dim3 g(gx, (unsigned)gy);
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: iota2d_kernel<float><<<g, IOTA_THREADS, 0, s>>>((float*)out, h, w); break;
    case 1: iota2d_kernel<__nv_bfloat16><<<g, IOTA_THREADS, 0, s>>>((__nv_bfloat16*)out, h, w); break;
    case 2: iota2d_kernel<__half><<<g, IOTA_THREADS, 0, s>>>((__half*)out, h, w); break;
    case 3: iota2d_kernel<int32_t><<<g, IOTA_THREADS, 0, s>>>((int32_t*)out, h, w); break;
    case 4: iota2d_kernel<int64_t><<<g, IOTA_THREADS, 0, s>>>((int64_t*)out, h, w); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
