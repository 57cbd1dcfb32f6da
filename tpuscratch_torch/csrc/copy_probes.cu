// Hand-written Hopper (sm_90a) copy-rate probes.
//
// Replaces the Pallas TPU kernels of tpuscratch/bench/dma_bound.py:
//   probe_kernel<COPY|TOUCH, nbuf>, 1 lane  <- manual_stream (:38)
//   probe_kernel<DIRECT, nbuf>              <- hbm2hbm (:106); on K streams,
//                                              one launch a slab, kway_hbm2hbm (:184)
//   probe_kernel<TOUCH, nbuf>, L lanes      <- lanes_stream (:216)
// The TPU probes stream a 256x512x512 f32 array (256 MiB) through VMEM with
// DMAs and semaphores, to find the chip's copy rate. Here each block runs L
// independent lanes; a lane is a ring of nbuf shared-memory stages filled by
// bulk asynchronous copies (cp.async.bulk global -> shared, completing on an
// mbarrier with an expected byte count) and drained by bulk copies back
// (shared -> global, one bulk group a chunk). In COPY mode the lane's
// threads move each chunk from the read stage to a write stage through
// registers (the TPU's VMEM-to-VMEM copy), in TOUCH mode they multiply it by
// c on the way (__fmul_rn: bit-equal to x * c); DIRECT stores the read
// stage itself, so no thread touches the data (the TPU's HBM-to-HBM DMA has
// no Hopper counterpart that skips shared memory).
//
// Ring discipline (one elected thread a lane issues every copy):
//   COPY/TOUCH: wait the load of chunk i; wait until at most nbuf-1 stores
//   are still reading shared memory (so the store of chunk i-nbuf has left
//   write stage s); lane barrier; threads fill write stage s; proxy fence;
//   lane barrier; store chunk i; load chunk i+nbuf into read stage s.
//   DIRECT: wait the load of chunk i; store it from the same stage; once
//   the store of chunk i-1 has read its stage, load chunk i-1+nbuf there.
// The TPU bands are 1 MiB z-planes, past the 227 KB a block may hold, so a
// chunk is a byte count (a multiple of 16, the bulk copies' quantum) and
// the probe list is the card's own (bench/dma_bound.py).
//
// Bound: bytes. A probe reads and writes every byte once: 2 x 256 MiB =
// 0.160 ms at 3.35 TB/s.
//
// Plain C interface (ctypes): the launcher takes raw pointers and the CUDA
// stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cstdint>

enum Mode { DIRECT = 0, COPY = 1, TOUCH = 2 };

constexpr int MAX_LANES = 15;     // named barriers 1..15 (0 is __syncthreads)
constexpr int BAR_BYTES = 1024;   // mbarriers, ahead of the stages
constexpr int DIRECT_THREADS = 32;
constexpr int TOUCH_THREADS = 128;

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  }
}

// expect `bytes` on the barrier, then bulk-load them into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(saddr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(saddr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wait_stores_done() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void lane_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

template <int MODE, int NBUF>
__global__ void probe_kernel(const char* __restrict__ src, char* __restrict__ dst,
                             long long nbytes, int chunk, int lanes, const float* __restrict__ cp) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  const int lane_threads = MODE == DIRECT ? DIRECT_THREADS : TOUCH_THREADS;
  const int lane = threadIdx.x / lane_threads;
  const int tid = threadIdx.x % lane_threads;
  if (threadIdx.x < lanes * NBUF) mbar_init(&bars[threadIdx.x], 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  const long long stage_bytes = (long long)(MODE == DIRECT ? 1 : 2) * NBUF * chunk;
  char* rbuf = reinterpret_cast<char*>(smem) + BAR_BYTES + lane * stage_bytes;
  char* wbuf = rbuf + (long long)NBUF * chunk;
  uint64_t* full = bars + lane * NBUF;
  const long long nchunks = (nbytes + chunk - 1) / chunk;
  const long long g = (long long)blockIdx.x * lanes + lane;
  const long long total = (long long)gridDim.x * lanes;
  const long long lo = nchunks * g / total, n = nchunks * (g + 1) / total - lo;
  const bool leader = tid == 0;
  const float c = MODE == TOUCH ? *cp : 1.0f;

  auto bytes_of = [&](long long i) -> uint32_t {
    const long long b0 = (lo + i) * chunk;
    const long long e = b0 + chunk < nbytes ? b0 + chunk : nbytes;
    return (uint32_t)(e - b0);
  };
  auto load = [&](int s, long long i) {
    bulk_load(rbuf + (long long)s * chunk, src + (lo + i) * chunk, bytes_of(i), &full[s]);
  };

  if (leader)
    for (int s = 0; s < NBUF && s < n; ++s) load(s, s);
  for (long long i = 0; i < n; ++i) {
    const int s = (int)(i % NBUF);
    const uint32_t parity = (uint32_t)((i / NBUF) & 1);
    const uint32_t b = bytes_of(i);
    char* out = dst + (lo + i) * chunk;
    if (MODE == DIRECT) {
      if (!leader) continue;
      mbar_wait(&full[s], parity);
      bulk_store(out, rbuf + (long long)s * chunk, b);
      if (i >= 1) {
        wait_stores_read<1>();  // the store of chunk i-1 has read its stage
        if (i - 1 + NBUF < n) load((int)((i - 1) % NBUF), i - 1 + NBUF);
      }
      continue;
    }
    mbar_wait(&full[s], parity);
    if (leader) wait_stores_read<NBUF - 1>();  // the store of chunk i-NBUF left stage s
    lane_sync(lane + 1, lane_threads);
    const float4* r = reinterpret_cast<const float4*>(rbuf + (long long)s * chunk);
    float4* w = reinterpret_cast<float4*>(wbuf + (long long)s * chunk);
    for (uint32_t j = tid; j < b / 16; j += lane_threads) {
      float4 q = r[j];
      if (MODE == TOUCH) {
        q.x = __fmul_rn(q.x, c);
        q.y = __fmul_rn(q.y, c);
        q.z = __fmul_rn(q.z, c);
        q.w = __fmul_rn(q.w, c);
      }
      w[j] = q;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    lane_sync(lane + 1, lane_threads);
    if (leader) {
      bulk_store(out, wbuf + (long long)s * chunk, b);
      if (i + NBUF < n) load(s, i + NBUF);
    }
  }
  if (leader) wait_stores_done();
}

static size_t smem_bytes(int mode, int nbuf, int chunk, int lanes) {
  return BAR_BYTES + (size_t)lanes * (mode == DIRECT ? 1 : 2) * nbuf * chunk;
}

template <int MODE, int NBUF>
static int launch(const void* src, void* dst, long long nbytes, int chunk, int lanes, const float* c,
                  cudaStream_t s) {
  auto kernel = probe_kernel<MODE, NBUF>;
  const size_t smem = smem_bytes(MODE, NBUF, chunk, lanes);
  const int threads = lanes * (MODE == DIRECT ? DIRECT_THREADS : TOUCH_THREADS);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long nchunks = (nbytes + chunk - 1) / chunk;
  long long grid = (nchunks + lanes - 1) / lanes;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  kernel<<<(unsigned)grid, threads, smem, s>>>((const char*)src, (char*)dst, nbytes, chunk,
                                               lanes, c);
  return (int)cudaGetLastError();
}

template <int MODE>
static int by_nbuf(int nbuf, const void* src, void* dst, long long nbytes, int chunk,
                   int lanes, const float* c, cudaStream_t s) {
  switch (nbuf) {
    case 2: return launch<MODE, 2>(src, dst, nbytes, chunk, lanes, c, s);
    case 3: return launch<MODE, 3>(src, dst, nbytes, chunk, lanes, c, s);
    case 4: return launch<MODE, 4>(src, dst, nbytes, chunk, lanes, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mode: 0 direct, 1 copy, 2 touch (x *c, c a device pointer); nbuf 2..4;
// lanes 1..15.
extern "C" int ts_copy_probe(const void* src, void* dst, long long nbytes, int chunk, int nbuf,
                             int lanes, int mode, const void* cptr, void* stream) {
  const float* c = (const float*)cptr;
  if ((mode == TOUCH && c == nullptr) || nbytes < 0 || nbytes % 16 || chunk <= 0 || chunk % 16 || lanes < 1 ||
      lanes > MAX_LANES || ((uintptr_t)src & 15) || ((uintptr_t)dst & 15))
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case DIRECT: return by_nbuf<DIRECT>(nbuf, src, dst, nbytes, chunk, lanes, c, s);
    case COPY: return by_nbuf<COPY>(nbuf, src, dst, nbytes, chunk, lanes, c, s);
    case TOUCH: return by_nbuf<TOUCH>(nbuf, src, dst, nbytes, chunk, lanes, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the shared memory a probe's block asks for, to check against the opt-in
extern "C" long long ts_copy_probe_smem(int mode, int nbuf, int chunk, int lanes) {
  return (long long)smem_bytes(mode, nbuf, chunk, lanes);
}

extern "C" int ts_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
