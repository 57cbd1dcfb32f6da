// Hand-written Hopper (sm_90a) copy-rate probes.
//
// Replaces the Pallas TPU kernels of tpuscratch/bench/dma_bound.py:
//   probe_kernel<COPY|TOUCH, nbuf>, 1 lane  <- manual_stream (:38)
//   probe_kernel<DIRECT, nbuf>              <- hbm2hbm (:106); on K streams,
//                                              one launch a slab, kway_hbm2hbm (:184)
//   probe_kernel<TOUCH, nbuf>, L lanes      <- lanes_stream (:216)
// The TPU probes stream a 256x512x512 f32 array (256 MiB) through VMEM with
// DMAs and semaphores, to find the chip's copy rate. Here each block runs L
// independent lanes (rings); a ring is nbuf shared-memory stages filled by
// bulk asynchronous copies (cp.async.bulk global -> shared, completing on an
// mbarrier with an expected byte count) and drained by bulk copies back
// (shared -> global, one bulk group a chunk). In COPY mode the ring's
// compute threads move each chunk from its read stage to a write stage
// through registers (the TPU's VMEM-to-VMEM copy), in TOUCH mode they
// multiply it by c on the way (__fmul_rn: bit-equal to x * c); DIRECT
// stores the read stage itself, so no thread touches the data (the TPU's
// HBM-to-HBM DMA has no Hopper counterpart that skips shared memory).
//
// Roles. Warp 0 issues the loads (its thread l for ring l) and warp 1 the
// stores (thread l for ring l); in COPY/TOUCH mode each ring also has 128
// compute threads (64 past 7 rings, so 15 rings fit 1024 threads). Every
// stage has a "full" mbarrier (its load landed) and an "empty" one (its
// data has been read); COPY/TOUCH rings add the write stage's pair:
//   loader:  wait empty[s] (first round passes), pick chunk k, note its
//            index in the stage (-1: the ring's end), load it into s;
//   DIRECT storer: wait full[s], store the chunk from s, and once the
//            store before it has read shared memory
//            (cp.async.bulk.wait_group.read 1), arrive on that one's empty;
//   compute: wait full[s] and wempty[s], copy / multiply into write stage
//            s, fence the async proxy, arrive on empty[s] and wfull[s];
//   COPY/TOUCH storer: as DIRECT's, on wfull / wempty.
// So a load waits only for its own stage, never for the store of another.
// Which chunk: flag DYNAMIC draws the next chunks of the array from a
// counter in global memory, DRAW_BYTES' worth at a time (atomicInc: every
// ring draws until it fails once, and the last draw wraps the counter back
// to 0), so the rings walk the array together, as the block scheduler
// walks a grid sized to the work, and end within a draw of each other;
// without it ring g of R takes chunks g, g + R, ... Flag EVICT_FIRST puts an L2 evict_first
// policy on every bulk copy: the array passes L2 once. The grid is the
// host's (bench/dma_bound.py: probe_blocks): one resident wave, or its
// K-th for each of kway_hbm2hbm's K slab launches, so that they run side
// by side. On the H100 the static rings stayed ~5% behind copy_ whatever
// their stages, chunk and store lag; the counter closed the gap (PERF.md).
// The TPU bands are 1 MiB z-planes, past the 227 KB a block may hold, so a
// chunk is a byte count (a multiple of 16, the bulk copies' quantum) and
// the probe list is the card's own (bench/dma_bound.py).
//
// Bound: bytes. A probe reads and writes every byte once: 2 x 256 MiB =
// 0.160 ms at 3.35 TB/s.
//
// Plain C interface (ctypes): the launcher takes raw pointers and the CUDA
// stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int. ts_copy_probe_occupancy sets a kernel's
// shared-memory limit on the current device; the host calls it (once a
// configuration and device) before the first launch.

#include <cuda_runtime.h>
#include <cstdint>

#include "hopper.cuh"

using hop::bar_arrive;
using hop::bar_wait;  // traps after 10 s: a lost arrival does not hang the card
using hop::smem_u32;

enum Mode { DIRECT = 0, COPY = 1, TOUCH = 2 };
enum Flags { DYNAMIC = 1, EVICT_FIRST = 2, PDL = 4 };

constexpr int MAX_LANES = 15;     // one loader and one storer thread a ring in warps 0, 1
constexpr int BAR_BYTES = 3072;   // the header (below): 15 x 4 x (4 + 2) x 8 B at most
constexpr int ROLE_THREADS = 64;  // warp 0 loads, warp 1 stores
constexpr int DRAW_BYTES = 32768; // a DYNAMIC draw takes this many bytes of chunks, at least one

__host__ __device__ constexpr int compute_threads(int lanes) { return lanes <= 7 ? 128 : 64; }

static int block_threads(int mode, int lanes) {
  return ROLE_THREADS + (mode == DIRECT ? 0 : lanes * compute_threads(lanes));
}

static size_t smem_bytes(int mode, int nbuf, int chunk, int lanes) {
  return BAR_BYTES + (size_t)lanes * (mode == DIRECT ? 1 : 2) * nbuf * chunk;
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// expect `bytes` on the barrier, then bulk-load them into shared memory
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, bool hint, uint64_t policy) {
  hop::bar_arrive_tx(bar, bytes);
  if (hint)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
        "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes, bool hint,
                                           uint64_t policy) {
  if (hint)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
                 ::"l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy)
                 : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(smem_u32(src)), "r"(bytes)
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

// The header of the block's shared memory, ahead of the stages: a ring's
// barriers, NBUF each, [full][empty] (DIRECT) or [full][empty][wfull]
// [wempty] (COPY/TOUCH: read stage, then write stage), then the chunk index
// each stage holds (-1: the ring's end), NBUF for the read stages and NBUF
// for the write stages.
template <int MODE, int NBUF>
__global__ void __launch_bounds__(1024)
probe_kernel(const char* __restrict__ src, char* __restrict__ dst, long long nbytes, int chunk,
             int lanes, int flags, const float* __restrict__ cp,
             unsigned int* __restrict__ counter) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int KINDS = MODE == DIRECT ? 2 : 4;
  const int ct = compute_threads(lanes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  for (int i = threadIdx.x; i < lanes * KINDS * NBUF; i += blockDim.x) {
    const int kind = i / NBUF % KINDS;  // 0 full, 1 empty, 2 wfull, 3 wempty
    // full and wempty: one arrival (the loader's, the storer's); empty and
    // wfull of COPY/TOUCH: one a compute warp
    hop::bar_init(&bars[i], MODE == DIRECT || kind == 0 || kind == 3 ? 1 : ct / 32);
  }
  hop::bar_init_fence();
  __syncthreads();
  // launched with PDL (programmatic dependent launch), the next launch on
  // the stream may start its set-up now, and this one waits here for the
  // launch before it to finish and flush; otherwise both are no-ops
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // role 0 loader, 1 storer (thread l of warp 0 / 1 drives ring l), 2 compute
  const int role = threadIdx.x < ROLE_THREADS ? threadIdx.x / 32 : 2;
  const int lane = role < 2 ? threadIdx.x % 32 : (threadIdx.x - ROLE_THREADS) / ct;
  if (lane >= lanes) return;  // idle threads of warps 0 and 1; no block barrier follows

  const long long stage_bytes = (long long)(MODE == DIRECT ? 1 : 2) * NBUF * chunk;
  char* rbuf = reinterpret_cast<char*>(smem) + BAR_BYTES + lane * stage_bytes;
  char* wbuf = rbuf + (long long)NBUF * chunk;
  uint64_t* full = bars + lane * KINDS * NBUF;
  uint64_t* empty = full + NBUF;
  uint64_t* wfull = full + 2 * NBUF;   // COPY/TOUCH only
  uint64_t* wempty = full + 3 * NBUF;  // COPY/TOUCH only
  long long* ridx = reinterpret_cast<long long*>(bars + lanes * KINDS * NBUF) + lane * 2 * NBUF;
  long long* widx = ridx + NBUF;       // COPY/TOUCH only

  const long long nchunks = (nbytes + chunk - 1) / chunk;
  auto bytes_of = [&](long long c) -> uint32_t {
    return (uint32_t)((c + 1) * chunk <= nbytes ? chunk : nbytes - c * chunk);
  };
  const bool hint = flags & EVICT_FIRST;

  if (role == 0) {  // loader: picks every chunk of the ring, in order
    const long long rings = (long long)gridDim.x * lanes;
    const long long g = (long long)blockIdx.x * lanes + lane;
    const long long per = DRAW_BYTES > chunk ? DRAW_BYTES / chunk : 1;  // chunks a draw
    const long long draws = (nchunks + per - 1) / per;
    long long next = 0, last = 0;  // the chunks of this ring's draw not yet loaded
    const uint64_t policy = hint ? evict_first_policy() : 0;
    for (long long k = 0;; ++k) {
      const int s = (int)(k % NBUF);
      bar_wait(&empty[s], (uint32_t)(((k / NBUF) & 1) ^ 1));
      long long c;
      if (flags & DYNAMIC) {  // the next draw of the array: every ring draws
        // until it fails once, and the last draw wraps the counter to 0
        if (next == last) {
          const long long d = atomicInc(counter, (unsigned int)(draws + rings - 1));
          next = d < draws ? d * per : nchunks;
          last = next + per < nchunks ? next + per : nchunks;
        }
        c = next < last ? next++ : -1;
      } else {  // chunk g + k * rings
        c = g + k * rings < nchunks ? g + k * rings : -1;
      }
      ridx[s] = c;
      if (c < 0) {
        bar_arrive(&full[s]);  // the end, seen by the storer or the compute threads
        return;
      }
      bulk_load(rbuf + (long long)s * chunk, src + c * chunk, bytes_of(c), &full[s], hint,
                policy);
    }
  }
  if (role == 1) {  // storer
    const uint64_t policy = hint ? evict_first_policy() : 0;
    uint64_t* ready = MODE == DIRECT ? full : wfull;
    uint64_t* freed = MODE == DIRECT ? empty : wempty;
    const long long* idx = MODE == DIRECT ? ridx : widx;
    char* from = MODE == DIRECT ? rbuf : wbuf;
    for (long long k = 0;; ++k) {
      const int s = (int)(k % NBUF);
      bar_wait(&ready[s], (uint32_t)((k / NBUF) & 1));
      const long long c = idx[s];
      if (c < 0) break;
      bulk_store(dst + c * chunk, from + (long long)s * chunk, bytes_of(c), hint, policy);
      if (k >= 1) {
        wait_stores_read<1>();  // the store before it has read its stage
        bar_arrive(&freed[(int)((k - 1) % NBUF)]);
      }
    }
    wait_stores_done();
    return;
  }
  // compute threads of COPY/TOUCH (DIRECT has none)
  if (MODE == DIRECT) return;
  const int tid = (threadIdx.x - ROLE_THREADS) % ct;
  const float cv = MODE == TOUCH ? *cp : 1.0f;
  for (long long k = 0;; ++k) {
    const int s = (int)(k % NBUF);
    const uint32_t parity = (uint32_t)((k / NBUF) & 1);
    bar_wait(&full[s], parity);
    bar_wait(&wempty[s], parity ^ 1);  // the store of write stage s's last chunk has read it
    const long long c = ridx[s];
    if (c >= 0) {
      const uint32_t b = bytes_of(c);
      const float4* r = reinterpret_cast<const float4*>(rbuf + (long long)s * chunk);
      float4* w = reinterpret_cast<float4*>(wbuf + (long long)s * chunk);
      for (uint32_t j = tid; j < b / 16; j += ct) {
        float4 q = r[j];
        if (MODE == TOUCH) {
          q.x = __fmul_rn(q.x, cv);
          q.y = __fmul_rn(q.y, cv);
          q.z = __fmul_rn(q.z, cv);
          q.w = __fmul_rn(q.w, cv);
        }
        w[j] = q;
      }
      hop::fence_async_smem();  // the writes are seen by the bulk store
    }
    if (tid == 0) widx[s] = c;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      bar_arrive(&empty[s]);
      bar_arrive(&wfull[s]);
    }
    if (c < 0) return;
  }
}

using Kernel = void (*)(const char*, char*, long long, int, int, int, const float*,
                        unsigned int*);

template <int MODE>
static Kernel by_nbuf(int nbuf) {
  switch (nbuf) {
    case 2: return probe_kernel<MODE, 2>;
    case 3: return probe_kernel<MODE, 3>;
    case 4: return probe_kernel<MODE, 4>;
    default: return nullptr;
  }
}

static Kernel kernel_of(int mode, int nbuf) {
  switch (mode) {
    case DIRECT: return by_nbuf<DIRECT>(nbuf);
    case COPY: return by_nbuf<COPY>(nbuf);
    case TOUCH: return by_nbuf<TOUCH>(nbuf);
    default: return nullptr;
  }
}

// mode: 0 direct, 1 copy, 2 touch (x * c, c a device pointer); nbuf 2..4;
// lanes 1..15; blocks from the host's plan; flags DYNAMIC | EVICT_FIRST |
// PDL;
// counter: one zero word, with DYNAMIC (the launch leaves it zero), else
// unused.
extern "C" int ts_copy_probe(const void* src, void* dst, long long nbytes, int chunk, int nbuf,
                             int lanes, int mode, const void* cptr, int blocks, int flags,
                             void* counter, void* stream) {
  const float* c = (const float*)cptr;
  const Kernel kernel = kernel_of(mode, nbuf);
  if (kernel == nullptr || (mode == TOUCH && c == nullptr) || nbytes < 0 || nbytes % 16 ||
      chunk <= 0 || chunk % 16 || lanes < 1 || lanes > MAX_LANES || blocks < 1 ||
      ((uintptr_t)src & 15) || ((uintptr_t)dst & 15) || (flags & ~7) ||
      ((flags & DYNAMIC) && (counter == nullptr ||
                             nbytes / chunk + 1 + (long long)blocks * lanes > 0xffffffffll)))
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(block_threads(mode, lanes));
  cfg.dynamicSmemBytes = smem_bytes(mode, nbuf, chunk, lanes);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = flags & PDL ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, (const char*)src, (char*)dst, nbytes, chunk,
                                     lanes, flags, c, (unsigned int*)counter);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The card's SM count and the blocks of a probe an SM holds, after setting
// the kernel's shared-memory limit to the card's opt-in on the current
// device (the launcher relies on it).
extern "C" int ts_copy_probe_occupancy(int mode, int nbuf, int chunk, int lanes, int* sms,
                                       int* per_sm) {
  const Kernel kernel = kernel_of(mode, nbuf);
  if (kernel == nullptr || chunk <= 0 || lanes < 1 || lanes > MAX_LANES)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, block_threads(mode, lanes),
                                                      smem_bytes(mode, nbuf, chunk, lanes));
  return (int)e;
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
