// Hand-written Hopper (sm_90a) kernels for the dot-product reduction.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/reduction.py:
//   dot_partials_kernel <- dot_partials_prepped (:132, _partials_kernel :39)
//   dot_full_kernel     <- dot_full_prepped     (:163, _full_kernel :49)
// Both compute sum((x + offset) * y) with float32 accumulation, x and y
// float32 or bfloat16, over a batch of vectors (the stacked ranks of a
// mesh): x, y are (batch, n) contiguous, and offset is read through a
// device pointer (null: 0), one value for all (stride 0) or one per batch
// entry (stride 1), so a loop-carried offset never syncs the host.
//
// The TPU kernels lean on a sequential grid: a running sum in the revisited
// output block. Blocks run in parallel here, so:
// - dot_partials: one block per chunk of the vector (the TPU kernel's grid
//   step) writes its partial; the caller sums the partials (as the JAX
//   package sums them outside its kernel).
// - dot_full: the reference's own single-kernel design (mpicuda4.cu:157-185):
//   a grid sized by the SM count walks the vector with a grid-stride loop,
//   each block writes its partial to a scratch buffer, __threadfence(), and
//   takes an atomicInc ticket; the block that draws the last ticket sums
//   the partials in index order and the ticket wraps back to 0 for the next
//   launch. No float atomicAdd: the result is the same on every run.
//
// Inside a block: per-thread fmaf accumulation, then a warp-shuffle tree
// and the warp sums through shared memory, in a fixed order.
//
// Bound: bytes. The work reads both vectors once, 2 * n * sizeof(T) bytes,
// against 3 flops an element: for 1e8 float32, 8e8 B = 0.239 ms at
// 3.35 TB/s against 4.5 us of f32 operations. Loads are 16 bytes a thread
// (two float4 / one uint4 of bf16 per 8 elements), two such steps in
// flight per thread, where the pointers are 16-byte aligned and the
// lengths multiples of 8; otherwise one element at a time.
//
// Plain C interface (ctypes): every launcher takes raw pointers and the
// CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

constexpr int THREADS = 256;
constexpr int UNROLL = 2;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int V>
struct Load;

template <>
struct Load<1> {
  template <typename T>
  static __device__ __forceinline__ void run(const T* p, float* v) { v[0] = to_f(p[0]); }
};

template <>
struct Load<8> {
  static __device__ __forceinline__ void run(const float* p, float* v) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

// Sum of (x + o) * y over the groups g, g + stride, ... < gend of V
// elements each.
template <int V, typename TX, typename TY>
__device__ __forceinline__ float accumulate(const TX* __restrict__ x,
                                            const TY* __restrict__ y,
                                            long long g, long long gend,
                                            long long stride, float o) {
  float acc = 0.f;
  for (; g + (UNROLL - 1) * stride < gend; g += UNROLL * stride) {
    float xv[UNROLL][V], yv[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      Load<V>::run(x + (g + u * stride) * V, xv[u]);
      Load<V>::run(y + (g + u * stride) * V, yv[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) acc = fmaf(__fadd_rn(xv[u][k], o), yv[u][k], acc);
  }
  for (; g < gend; g += stride) {
    float xv[V], yv[V];
    Load<V>::run(x + g * V, xv);
    Load<V>::run(y + g * V, yv);
#pragma unroll
    for (int k = 0; k < V; ++k) acc = fmaf(__fadd_rn(xv[k], o), yv[k], acc);
  }
  return acc;
}

// The block's sum, valid in thread 0; a fixed order, so deterministic.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float offset_of(const float* off, int stride, long long b) {
  return off ? off[b * stride] : 0.f;
}

// ---------------------------------------------------------------------------
// dot_partials: grid (nchunks, batch); block c of batch b writes
// partials[b, c] = the sum over elements [c*chunk, min(n, (c+1)*chunk)).
template <int V, typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
dot_partials_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                    const float* __restrict__ off, int off_stride, long long n,
                    long long chunk, float* __restrict__ partials) {
  const long long b = blockIdx.y, c = blockIdx.x;
  const long long begin = c * chunk;
  const long long end = begin + chunk < n ? begin + chunk : n;
  const float acc = accumulate<V>(x + b * n, y + b * n, begin / V + threadIdx.x,
                                  end / V, THREADS, offset_of(off, off_stride, b));
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[b * gridDim.x + c] = s;
}

// ---------------------------------------------------------------------------
// dot_full: grid (G, batch); the G blocks of batch b walk its n elements
// with a grid-stride loop; scratch is (batch, G), tickets (batch,) starts
// (and ends) at 0.
template <int V, typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
dot_full_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                const float* __restrict__ off, int off_stride, long long n,
                float* __restrict__ scratch, unsigned int* __restrict__ tickets,
                float* __restrict__ out) {
  const long long b = blockIdx.y;
  const unsigned int G = gridDim.x;
  const float acc = accumulate<V>(x + b * n, y + b * n,
                                  (long long)blockIdx.x * THREADS + threadIdx.x,
                                  n / V, (long long)G * THREADS,
                                  offset_of(off, off_stride, b));
  const float s = block_sum(acc);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    scratch[b * G + blockIdx.x] = s;
    __threadfence();  // the partial is visible device-wide before the ticket
    last = atomicInc(&tickets[b], G - 1) == G - 1;  // G-th ticket wraps to 0
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();  // every other block's partial is read after its ticket
    const float* p = scratch + b * G;
    float total = 0.f;
#pragma unroll 8
    for (unsigned int i = 0; i < G; ++i) total += __ldcg(p + i);  // index order, past L1
    out[b] = total;
  }
}

// ---------------------------------------------------------------------------
// Launchers: dtype codes 0 float32, 1 bfloat16; vec 8 or 1 (see above).
struct Args {
  const void *x, *y;
  const float* off;
  int off_stride;
  long long n, chunk, nchunks, batch;
  int blocks;
  float *partials, *scratch, *out;
  unsigned int* tickets;
  cudaStream_t stream;
};

template <int V, typename TX, typename TY>
struct Partials {
  static void run(const Args& a) {
    dot_partials_kernel<V, TX, TY><<<dim3((unsigned)a.nchunks, (unsigned)a.batch),
                                     THREADS, 0, a.stream>>>(
        (const TX*)a.x, (const TY*)a.y, a.off, a.off_stride, a.n, a.chunk, a.partials);
  }
};

template <int V, typename TX, typename TY>
struct Full {
  static void run(const Args& a) {
    dot_full_kernel<V, TX, TY><<<dim3((unsigned)a.blocks, (unsigned)a.batch),
                                 THREADS, 0, a.stream>>>(
        (const TX*)a.x, (const TY*)a.y, a.off, a.off_stride, a.n, a.scratch,
        a.tickets, a.out);
  }
  static int per_sm() {
    int k = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, dot_full_kernel<V, TX, TY>, THREADS, 0);
    return k;
  }
};

template <template <int, typename, typename> class L, int V>
static bool pick(int dx, int dy, const Args& a) {
  using bf = __nv_bfloat16;
  if (dx == 0 && dy == 0) L<V, float, float>::run(a);
  else if (dx == 0 && dy == 1) L<V, float, bf>::run(a);
  else if (dx == 1 && dy == 0) L<V, bf, float>::run(a);
  else if (dx == 1 && dy == 1) L<V, bf, bf>::run(a);
  else return false;
  return true;
}

template <template <int, typename, typename> class L>
static int dispatch(int dx, int dy, int vec, const Args& a) {
  const bool ok = vec == 8 ? pick<L, 8>(dx, dy, a) : vec == 1 ? pick<L, 1>(dx, dy, a) : false;
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

static bool valid(long long n, long long batch, int vec) {
  return n >= 0 && batch >= 1 && batch <= 65535 && (vec == 1 || (vec == 8 && n % 8 == 0));
}

extern "C" int ts_dot_partials(const void* x, const void* y, int dx, int dy, int vec,
                               const float* off, int off_stride, long long n,
                               long long chunk, long long batch, float* partials,
                               void* stream) {
  if (!valid(n, batch, vec) || chunk < 1 || (vec == 8 && chunk % 8)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.y = y; a.off = off; a.off_stride = off_stride; a.n = n; a.chunk = chunk;
  a.nchunks = (n + chunk - 1) / chunk; a.batch = batch; a.partials = partials;
  a.stream = (cudaStream_t)stream;
  if (a.nchunks == 0) return 0;
  if (a.nchunks > INT32_MAX) return (int)cudaErrorInvalidValue;
  return dispatch<Partials>(dx, dy, vec, a);
}

// Blocks per batch entry of dot_full: the card's resident capacity
// (SMs x blocks per SM at full occupancy) shared out over the batch, and
// no more than the work fills (UNROLL groups of vec elements a thread).
extern "C" int ts_dot_full_blocks(long long n, long long batch, int dx, int dy, int vec,
                                  int* blocks) {
  if (!valid(n, batch, vec) || dx < 0 || dx > 1 || dy < 0 || dy > 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  using bf = __nv_bfloat16;
  int per_sm = 0;
  const int code = dx * 2 + dy;
  if (vec == 8) {
    per_sm = code == 0 ? Full<8, float, float>::per_sm() : code == 1 ? Full<8, float, bf>::per_sm()
           : code == 2 ? Full<8, bf, float>::per_sm() : Full<8, bf, bf>::per_sm();
  } else {
    per_sm = code == 0 ? Full<1, float, float>::per_sm() : code == 1 ? Full<1, float, bf>::per_sm()
           : code == 2 ? Full<1, bf, float>::per_sm() : Full<1, bf, bf>::per_sm();
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) per_sm = 1;
  long long cap = (long long)sms * per_sm / batch;
  const long long per_block = (long long)THREADS * vec * UNROLL;
  const long long need = (n + per_block - 1) / per_block;
  if (cap > need) cap = need;
  *blocks = (int)(cap < 1 ? 1 : cap);
  return 0;
}

extern "C" int ts_dot_full(const void* x, const void* y, int dx, int dy, int vec,
                           const float* off, int off_stride, long long n, long long batch,
                           int blocks, float* scratch, unsigned int* tickets, float* out,
                           void* stream) {
  if (!valid(n, batch, vec) || blocks < 1) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.y = y; a.off = off; a.off_stride = off_stride; a.n = n; a.batch = batch;
  a.blocks = blocks; a.scratch = scratch; a.tickets = tickets; a.out = out;
  a.stream = (cudaStream_t)stream;
  return dispatch<Full>(dx, dy, vec, a);
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
