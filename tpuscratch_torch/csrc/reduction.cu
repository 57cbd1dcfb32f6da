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
// output block. Blocks run in parallel here, so both kernels end the same
// way, after the reference's single-kernel design (mpicuda4.cu:157-185):
// each block writes its partials to global memory, fences them at device
// scope and takes an atomicInc ticket of its batch entry; the block that draws the
// last ticket sums that entry's partials with all of its threads (each a
// fixed strided subset in index order, then block_sum's fixed tree) and the
// ticket wraps back to 0 for the next launch. No float atomics: the result
// is the same bits on every run. A one-block grid writes its sum straight
// out, without a ticket.
// - dot_partials: the partials are one a chunk of the vector (the TPU
//   kernel's grid step, block x 128 elements), kept in a (batch, nchunks)
//   buffer, the TPU kernel's own output. A block sums a chunk (a grid of G
//   < nchunks blocks walks the chunks c = blockIdx.x + k*G, for the A/B),
//   each chunk's partial in a fixed order, so the partials, and the total,
//   do not depend on the grid. The block is 512 threads where a chunk
//   fills them (ops/reduction.py: dot_partials_threads), else 256. On the
//   H100 at 1e8 f32 (1526 chunks of 65536), 256-thread blocks a chunk ran
//   6-8 to an SM and lost 15% to torch.dot; 512-thread blocks, 2 to an SM,
//   beat it, and so, by less, did 2-3 blocks of 256 an SM walking the
//   chunks (PERF.md).
// - dot_full: G blocks walk the vector with a grid-stride loop and write
//   one partial each to a scratch buffer. The host plans G
//   (ops/reduction.py: dot_full_plan): one resident wave at most.
//
// Inside a block: per-thread fmaf accumulation, then a warp-shuffle tree
// and the warp sums through shared memory, in a fixed order.
//
// Bound: bytes. The work reads both vectors once, 2 * n * sizeof(T) bytes,
// against 3 flops an element: for 1e8 float32, 8e8 B = 0.239 ms at
// 3.35 TB/s against 4.5 us of f32 operations. Loads are 16 bytes a thread
// (two float4 / one uint4 of bf16 per 8 elements), two such steps in
// flight per thread, where the pointers are 16-byte aligned and the
// lengths multiples of 8; otherwise one element at a time. Past the stream,
// the time is the tail: one thread summing the partials cost ~G dependent
// L2 loads (~20 us for dot_full at 1e8) while every other block had
// already exited, hence all of the last block's threads. dot_partials used
// to leave the sum of its partials to a second launch (torch.sum), a few
// us at every size. On the H100, fewer dot_full blocks (2-4 an SM) or four
// steps in flight a thread measured no faster (PERF.md).
//
// Plain C interface (ctypes): every launcher takes raw pointers and the
// CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

constexpr int THREADS = 256;
constexpr int PARTIALS_WIDE = 512;  // dot_partials' block for chunks that fill it
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

// The block's sum over NT threads, valid in thread 0; a fixed order, so
// deterministic.
template <int NT = THREADS>
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[NT / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  if (wid == 0) {
    v = lane < NT / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float offset_of(const float* off, int stride, long long b) {
  return off ? off[b * stride] : 0.f;
}

// Release and acquire at device scope: a partial is visible to the block
// that draws the last ticket (__threadfence's fence.sc measured the same).
__device__ __forceinline__ void fence_acq_rel_gpu() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// The tail of both kernels: the G blocks of batch entry b have written
// their partials p[0..np) (every partial of the entry, once); the block
// that draws the last ticket sums them into out[b]. A one-block grid sums
// its own partials without a ticket.
template <int NT = THREADS>
__device__ __forceinline__ void sum_partials(const float* __restrict__ p, unsigned int np,
                                             unsigned int G, unsigned int* __restrict__ ticket,
                                             float* __restrict__ out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if (G > 1) {
      fence_acq_rel_gpu();  // the partials are visible device-wide before the ticket
      last = atomicInc(ticket, G - 1) == G - 1;  // G-th ticket wraps to 0
    } else {
      last = true;
    }
  }
  __syncthreads();  // also orders block_sum's shared memory for its reuse below
  if (!last) return;
  fence_acq_rel_gpu();  // every other block's partials are read after its ticket
  // thread t sums partials t, t + NT, ... in index order (eight loads in
  // flight, past L1), then the block's fixed tree: the same order on every
  // run and every grid
  float t = 0.f;
  for (unsigned int i = threadIdx.x; i < np; i += 8 * NT) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = i + k * NT < np ? __ldcg(p + i + k * NT) : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) t += v[k];
  }
  const float total = block_sum<NT>(t);
  if (threadIdx.x == 0) *out = total;
}

// ---------------------------------------------------------------------------
// dot_partials: grid (G, batch); block g of batch b writes partials[b, c]
// = the sum over elements [c*chunk, min(n, (c+1)*chunk)) for c = g, g + G,
// ... < nchunks, then the tail writes out[b], the sum of the entry's
// partials; tickets (batch,) starts (and ends) at 0.
template <int V, int NT, typename TX, typename TY>
__global__ void __launch_bounds__(NT)
dot_partials_kernel(const TX* __restrict__ x, const TY* __restrict__ y,
                    const float* __restrict__ off, int off_stride, long long n,
                    long long chunk, long long nchunks, float* __restrict__ partials,
                    unsigned int* __restrict__ tickets, float* __restrict__ out) {
  const long long b = blockIdx.y;
  const unsigned int G = gridDim.x;
  const float o = offset_of(off, off_stride, b);
  float* p = partials + b * nchunks;
  float s = 0.f;
  for (long long c = blockIdx.x; c < nchunks; c += G) {
    const long long begin = c * chunk;
    const long long end = begin + chunk < n ? begin + chunk : n;
    s = block_sum<NT>(accumulate<V>(x + b * n, y + b * n, begin / V + threadIdx.x, end / V,
                                    NT, o));
    if (threadIdx.x == 0) p[c] = s;
    __syncthreads();  // block_sum's shared memory is reused by the next chunk
  }
  if (nchunks == 1) {  // the chunk's partial is the total: no ticket
    if (threadIdx.x == 0) out[b] = s;
    return;
  }
  sum_partials<NT>(p, (unsigned int)nchunks, G, tickets + b, out + b);
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
  if (G == 1) {  // the block's sum is the total: no scratch, no ticket
    if (threadIdx.x == 0) out[b] = s;
    return;
  }
  if (threadIdx.x == 0) scratch[b * G + blockIdx.x] = s;
  sum_partials(scratch + b * G, G, G, tickets + b, out + b);
}

// ---------------------------------------------------------------------------
// Launchers: dtype codes 0 float32, 1 bfloat16; vec 8 or 1 (see above).
struct Args {
  const void *x, *y;
  const float* off;
  int off_stride;
  long long n, chunk, nchunks, batch;
  int blocks, threads;
  float *partials, *scratch, *out;
  unsigned int* tickets;
  int* per_sm;
  cudaStream_t stream;
};

template <int V, typename TX, typename TY>
struct Partials {
  template <int NT>
  static void launch(const Args& a) {
    dot_partials_kernel<V, NT, TX, TY><<<dim3((unsigned)a.blocks, (unsigned)a.batch), NT, 0,
                                         a.stream>>>(
        (const TX*)a.x, (const TY*)a.y, a.off, a.off_stride, a.n, a.chunk, a.nchunks,
        a.partials, a.tickets, a.out);
  }
  static void run(const Args& a) {
    if (a.threads == PARTIALS_WIDE) launch<PARTIALS_WIDE>(a);
    else launch<THREADS>(a);
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
};

// the blocks of dot_full / dot_partials an SM holds at full occupancy,
// into *a.per_sm
template <int V, typename TX, typename TY>
struct FullOccupancy {
  static void run(const Args& a) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm, dot_full_kernel<V, TX, TY>, THREADS, 0);
  }
};

template <int V, typename TX, typename TY>
struct PartialsOccupancy {
  static void run(const Args& a) {
    if (a.threads == PARTIALS_WIDE)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          a.per_sm, dot_partials_kernel<V, PARTIALS_WIDE, TX, TY>, PARTIALS_WIDE, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(a.per_sm,
                                                    dot_partials_kernel<V, THREADS, TX, TY>,
                                                    THREADS, 0);
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

// blocks: G, at most the chunks (the rule: a block a chunk); threads: 256
// or PARTIALS_WIDE; partials is (batch, nchunks), tickets (batch,) zero,
// out (batch,).
extern "C" int ts_dot_partials(const void* x, const void* y, int dx, int dy, int vec,
                               const float* off, int off_stride, long long n,
                               long long chunk, long long batch, int blocks, float* partials,
                               unsigned int* tickets, float* out, int threads, void* stream) {
  if (!valid(n, batch, vec) || chunk < 1 || (vec == 8 && chunk % 8)) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x; a.y = y; a.off = off; a.off_stride = off_stride; a.n = n; a.chunk = chunk;
  a.nchunks = (n + chunk - 1) / chunk; a.batch = batch; a.partials = partials;
  a.tickets = tickets; a.out = out; a.threads = threads; a.stream = (cudaStream_t)stream;
  if (a.nchunks == 0) return 0;
  if (a.nchunks > INT32_MAX || blocks < 1 || blocks > a.nchunks ||
      (threads != THREADS && threads != PARTIALS_WIDE))
    return (int)cudaErrorInvalidValue;
  a.blocks = blocks;
  return dispatch<Partials>(dx, dy, vec, a);
}

static int occupancy(bool partials, int dx, int dy, int vec, int* sms, int* per_sm,
                     int threads = THREADS) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Args a{};
  a.per_sm = per_sm;
  a.threads = threads;
  return partials ? dispatch<PartialsOccupancy>(dx, dy, vec, a)
                  : dispatch<FullOccupancy>(dx, dy, vec, a);
}

// The card's SM count and the blocks of dot_full (of dot_partials, of
// `threads` threads) an SM holds at full occupancy: for dot_full's plan
// (ops/reduction.py: dot_full_plan) and the grids kernel_ab.py --sweep
// times.
extern "C" int ts_dot_full_occupancy(int dx, int dy, int vec, int* sms, int* per_sm) {
  return occupancy(false, dx, dy, vec, sms, per_sm);
}

extern "C" int ts_dot_partials_occupancy(int dx, int dy, int vec, int* sms, int* per_sm,
                                         int threads) {
  return occupancy(true, dx, dy, vec, sms, per_sm, threads);
}

// `blocks` (G) comes from the host's plan.
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
