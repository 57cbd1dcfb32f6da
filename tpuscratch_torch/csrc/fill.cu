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
// least time is out_bytes / 3.35 TB/s: 0.119 ms for 1e8 f32. Both take one
// grid, a host rule (ops/fill.py: fill_blocks): a block a 256 16-byte
// units, one streaming store (st.global.cs: the lines are not kept for
// reuse) a thread, 32-bit indices where the 16-byte count fits them, the
// tail under 16 bytes written by block 0's first threads. On the H100 that
// grid wrote 1e8 f32 ~4% faster than one resident wave striding over the
// output (with 1 or 4 stores a thread an iteration, streaming or not) and
// than bulk asynchronous copies of a shared-memory tile of the pattern
// (PERF.md). iota2d's thread finds its unit's first row and column with
// one division and walks across a row end inside the unit (ops/fill.py:
// iota_writes models which elements each thread writes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>
#include <cstring>

// ---------------------------------------------------------------------------
// fill: write the value's bit pattern into every element. The wrapper casts
// the value on the host (as jnp.asarray([value], dtype) does) and passes its
// bytes, so one kernel serves every dtype by element size (1, 2, 4, 8).
// The body is written as 16-byte stores of the pattern repeated, unit q by
// thread q % (blocks * FILL_THREADS); the tail (fewer than 16 bytes) byte
// by byte, by the first threads of block 0.
constexpr int FILL_THREADS = 256;

template <typename I>
__global__ void __launch_bounds__(FILL_THREADS)
fill_kernel(uint4* __restrict__ out, I n16, uint4 pattern, int ntail,
            unsigned long long bits, int esize) {
  const I stride = (I)gridDim.x * FILL_THREADS;
  for (I q = (I)blockIdx.x * FILL_THREADS + threadIdx.x; q < n16; q += stride)
    __stcs(out + q, pattern);
  // the tail starts at a multiple of 16, so b % esize is the byte's place
  // in its element
  unsigned char* tail = reinterpret_cast<unsigned char*>(out + n16);
  if (blockIdx.x == 0 && (int)threadIdx.x < ntail)
    tail[threadIdx.x] = (unsigned char)(bits >> (8 * (threadIdx.x % esize)));
}

// `blocks` comes from the host's rule.
extern "C" int ts_fill(void* out, long long nbytes, unsigned long long bits, int esize,
                       int blocks, void* stream) {
  if (nbytes < 0 || (esize != 1 && esize != 2 && esize != 4 && esize != 8) ||
      nbytes % esize || ((uintptr_t)out & 15) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  unsigned char rep[16];
  for (int i = 0; i < 16; ++i) rep[i] = (unsigned char)(bits >> (8 * (i % esize)));
  uint4 pattern;
  memcpy(&pattern, rep, 16);
  const long long n16 = nbytes / 16;
  const int ntail = (int)(nbytes - 16 * n16);
  cudaStream_t s = (cudaStream_t)stream;
  uint4* o = (uint4*)out;
  if (n16 + 2ll * blocks * FILL_THREADS < (1ll << 32))
    fill_kernel<unsigned><<<blocks, FILL_THREADS, 0, s>>>(o, (unsigned)n16, pattern, ntail, bits,
                                                         esize);
  else
    fill_kernel<unsigned long long><<<blocks, FILL_THREADS, 0, s>>>(o, n16, pattern, ntail, bits,
                                                                   esize);
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
  static __device__ float cvt(unsigned v) { return __uint2float_rn(v); }
  static __device__ float cvt(long long v) { return __ll2float_rn(v); }
  static __device__ float op(float r, float w, float c) {
    return __fadd_rn(__fmul_rn(r, w), c);
  }
};

template <>
struct Arith<__nv_bfloat16> {
  template <typename V>
  static __device__ __nv_bfloat16 cvt(V v) {
    return __float2bfloat16_rn(Arith<float>::cvt(v));
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
  template <typename V>
  static __device__ __half cvt(V v) {
    return __float2half_rn(Arith<float>::cvt(v));
  }
  static __device__ __half op(__half r, __half w, __half c) {
    __half p = __float2half_rn(__fmul_rn(__half2float(r), __half2float(w)));
    return __float2half_rn(__fadd_rn(__half2float(p), __half2float(c)));
  }
};

template <>
struct Arith<int32_t> {
  template <typename V>
  static __device__ int32_t cvt(V v) { return (int32_t)v; }
  static __device__ int32_t op(int32_t r, int32_t w, int32_t c) {
    return (int32_t)((uint32_t)r * (uint32_t)w + (uint32_t)c);  // wraps
  }
};

template <>
struct Arith<int64_t> {
  template <typename V>
  static __device__ int64_t cvt(V v) { return (int64_t)v; }
  static __device__ int64_t op(int64_t r, int64_t w, int64_t c) {
    return (int64_t)((uint64_t)r * (uint64_t)w + (uint64_t)c);
  }
};

// int8, uint8 and int16 wrap as the dtype does: r * w + c in 32 bits,
// whose low bits are those of the TPU kernel's product and sum in the
// dtype (arithmetic modulo 2^8 or 2^16 keeps only the low bits).
template <typename T>
struct WrapInt {
  template <typename V>
  static __device__ T cvt(V v) { return (T)v; }
  static __device__ T op(T r, T w, T c) {
    return (T)((uint32_t)r * (uint32_t)w + (uint32_t)c);
  }
};

template <>
struct Arith<int8_t> : WrapInt<int8_t> {};
template <>
struct Arith<uint8_t> : WrapInt<uint8_t> {};
template <>
struct Arith<int16_t> : WrapInt<int16_t> {};

// iota2d: unit q (16 bytes: E = 16 / sizeof(T) elements from element
// q * E) by thread q % (blocks * IOTA_THREADS), as fill's body; the tail
// (fewer than E elements) element by element, by the first threads of
// block 0. An integer I (unsigned or long long) converts to T through
// Arith<float>::cvt, which rounds it to nearest whatever its type, so
// both index widths give the same bits.
constexpr int IOTA_THREADS = 256;

template <typename T, typename I>
__global__ void __launch_bounds__(IOTA_THREADS)
iota2d_kernel(uint4* __restrict__ out, I n16, I w, int ntail) {
  constexpr int E = 16 / sizeof(T);
  const T tw = Arith<T>::cvt(w);
  const I stride = (I)gridDim.x * IOTA_THREADS;
  for (I q = (I)blockIdx.x * IOTA_THREADS + threadIdx.x; q < n16; q += stride) {
    I r = q * E / w;  // the one division: the unit's first row and column
    I c = q * E - r * w;
    T tr = Arith<T>::cvt(r);
    alignas(16) T e[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      e[k] = Arith<T>::op(tr, tw, Arith<T>::cvt(c));
      if (++c == w) {  // across a row end
        c = 0;
        tr = Arith<T>::cvt(++r);
      }
    }
    __stcs(out + q, *reinterpret_cast<const uint4*>(e));
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < ntail) {
    const I i = n16 * E + threadIdx.x, r = i / w;
    reinterpret_cast<T*>(out + n16)[threadIdx.x] =
        Arith<T>::op(Arith<T>::cvt(r), tw, Arith<T>::cvt(i - r * w));
  }
}

template <typename T>
static int launch_iota(void* out, long long h, long long w, int blocks, cudaStream_t s) {
  constexpr long long E = 16 / sizeof(T);
  const long long n = h * w, n16 = n / E;
  const int ntail = (int)(n - n16 * E);
  uint4* o = (uint4*)out;
  // 32-bit indices while every element, and the stride past the last unit, has one
  if (n + 2ll * blocks * IOTA_THREADS * E < (1ll << 32))
    iota2d_kernel<T, unsigned><<<blocks, IOTA_THREADS, 0, s>>>(o, (unsigned)n16, (unsigned)w,
                                                                ntail);
  else
    iota2d_kernel<T, long long><<<blocks, IOTA_THREADS, 0, s>>>(o, n16, w, ntail);
  return (int)cudaGetLastError();
}

// dtype codes: 0 f32, 1 bf16, 2 f16, 3 int32, 4 int64, 5 int8, 6 uint8,
// 7 int16; `blocks` comes from
// the host's rule (fill_blocks of the output's bytes); `out` 16-byte aligned.
extern "C" int ts_iota2d(void* out, long long h, long long w, int dtype, int blocks,
                         void* stream) {
  if (h < 0 || w < 0 || blocks < 1 || ((uintptr_t)out & 15)) return (int)cudaErrorInvalidValue;
  if (h * w == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_iota<float>(out, h, w, blocks, s);
    case 1: return launch_iota<__nv_bfloat16>(out, h, w, blocks, s);
    case 2: return launch_iota<__half>(out, h, w, blocks, s);
    case 3: return launch_iota<int32_t>(out, h, w, blocks, s);
    case 4: return launch_iota<int64_t>(out, h, w, blocks, s);
    case 5: return launch_iota<int8_t>(out, h, w, blocks, s);
    case 6: return launch_iota<uint8_t>(out, h, w, blocks, s);
    case 7: return launch_iota<int16_t>(out, h, w, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
