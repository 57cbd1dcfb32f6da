// Hand-written Hopper (sm_90a) kernel for decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/attention.py:
//   paged_attention_kernel <- paged_attention (:1413, _paged_kernel :1297)
// which serves decode (K = 1 query per sequence), speculative verify and
// chunked context prefill (K queued queries) in one sweep of the pool.
//
// What it computes, per sequence b and head h: the K queries q[b, kq, h, :]
// attend cache positions t < seq_len[b] + kq, position t living at offset
// t % page of pool page table[b, t / page] (clipped to [0, P)); int8 and
// fp8-e4m3 pools are dequantized with their per-page per-head scale. The
// softmax is online (running max and sum per query, the NEG_INF sentinel, a
// l > 0 guard on the final divide) with the 1/sqrt(D) scale, in f32 for an
// f32 or a bf16 q; the output has q's type. An idle slot (seq_len == 0)
// writes zeros.
//
// Plain C interface (ctypes): the launcher takes raw pointers, strides and
// the CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.
//
// Bound: bytes. Decode reads every cached K and V element once and does
// 4 flops per element and query, far below the card's rate; the least time
// is (pages read + q + out) / 3.35 TB/s. Design, simple first: one block
// per (head, sequence, group of at most 64 queries, tile of at most 128
// output columns) walks the sequence's positions in chunks of 32 tokens, so
// neither K nor d_head has a limit. A chunk's K rows (dequantized) go to
// shared memory 128 columns at a time and one thread per (query, position)
// adds that slice of its dot product to the score (K rows padded to an odd
// stride, so the threads of a warp hit distinct banks); one warp per query
// updates the running max and sum; the chunk's V rows of the block's output
// tile follow, and one thread per (query, d) element accumulates P.V into a
// shared-memory accumulator. A head wider than 128 columns recomputes the
// scores once per output tile. The tile is in tokens, not pages, so any
// page size works and pages past the group's frontier (seq_len + its last
// query) are never read. TMA page loads, 16-byte vector loads and a split
// over pages for small batches are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cstdint>

constexpr int PA_THREADS = 128;
constexpr int PA_TT = 32;   // tokens per chunk: one warp's lanes in the softmax
constexpr int PA_KG = 64;   // queries a block
constexpr int PA_DC = 128;  // d_head columns a score slice and an output tile
constexpr float PA_NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<int8_t>(int8_t v) { return (float)v; }
template <>
__device__ __forceinline__ float to_float<__nv_fp8_e4m3>(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Q>
__device__ __forceinline__ void store_out(Q* p, float x);
template <>
__device__ __forceinline__ void store_out<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct PoolStrides {
  long long k_page, k_tok, k_head, v_page, v_tok, v_head;
  long long ks_page, ks_head, vs_page, vs_head;
};

__host__ __device__ inline int odd(int n) { return n | 1; }

// Shared memory, in order: K and V row offsets (TT long longs each), then
// floats: q slice (kg*dc), acc (kg*dt), K rows (TT*odd(dc)), V rows (TT*dt),
// scores or probabilities (kg*TT), m, l, corr (kg each), the K and V scales
// (TT each).
static size_t smem_bytes(int kg, int dc, int dt) {
  return 2 * PA_TT * sizeof(long long) +
         sizeof(float) * ((size_t)kg * dc + (size_t)kg * dt + (size_t)PA_TT * odd(dc) +
                          (size_t)PA_TT * dt + (size_t)kg * PA_TT + 3 * (size_t)kg + 2 * PA_TT);
}

// the q slice of columns [c0, c0 + w) of the block's kg queries into qs (row stride dc)
template <typename Q>
__device__ __forceinline__ void load_q_slice(float* qs, const Q* q, long long row0, int kq0,
                                             int kg, int H, int D, int c0, int w, int dc) {
  for (int e = threadIdx.x; e < kg * w; e += PA_THREADS) {
    const int i = e / w, d = e - i * w;
    qs[i * dc + d] = to_float<Q>(q[row0 + (long long)(kq0 + i) * H * D + c0 + d]);
  }
}

// grid (H, B, groups * dtiles): block z = group * dtiles + output tile.
// ONE: d_head fits one slice (D <= PA_DC), so one output tile and one score
// slice, known at compile time: the slice loop and its tests fold away.
template <typename Q, typename T, bool ONE>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const Q* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ table,
                       const int* __restrict__ lens, Q* __restrict__ out, int K, int H,
                       int D, int page, int n_pages, int max_pages, PoolStrides st,
                       float scale, int kg_max, int dc, int dt) {
  static_assert(PA_TT == 32, "the softmax gives one lane to each token of a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldk = odd(dc);
  long long* kbase = reinterpret_cast<long long*>(smem_raw);
  long long* vbase = kbase + PA_TT;
  float* qs = reinterpret_cast<float*>(vbase + PA_TT);
  float* acc = qs + kg_max * dc;
  float* kt = acc + kg_max * dt;
  float* vt = kt + PA_TT * ldk;
  float* sc = vt + PA_TT * dt;
  float* m = sc + kg_max * PA_TT;
  float* l = m + kg_max;
  float* corr = l + kg_max;
  float* kscl = corr + kg_max;
  float* vscl = kscl + PA_TT;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int n_dt = ONE ? 1 : (D + dt - 1) / dt;
  const int kq0 = (blockIdx.z / n_dt) * kg_max;
  const int d0 = (blockIdx.z % n_dt) * dt;
  const int kg = K - kq0 < kg_max ? K - kq0 : kg_max;
  const int dtw = D - d0 < dt ? D - d0 : dt;  // this block's output columns
  const int n_dc = ONE ? 1 : (D + dc - 1) / dc;
  const int lane = tid & 31, warp = tid >> 5;
  const int seq = lens[b];
  const bool quantized = ks != nullptr;
  // out[b, kq, h, d] and q[b, kq, h, d]: rows kq of this (b, h) are H*D apart
  const long long row0 = ((long long)b * K * H + h) * D;
  if (seq <= 0) {
    for (int e = tid; e < kg * dtw; e += PA_THREADS) {
      const int kq = kq0 + e / dtw;
      store_out<Q>(out + row0 + (long long)kq * H * D + d0 + e % dtw, 0.0f);
    }
    return;
  }
  if (n_dc == 1) load_q_slice<Q>(qs, q, row0, kq0, kg, H, D, 0, D, dc);
  for (int e = tid; e < kg * dtw; e += PA_THREADS) acc[(e / dtw) * dt + e % dtw] = 0.0f;
  for (int i = tid; i < kg; i += PA_THREADS) {
    m[i] = PA_NEG_INF;
    l[i] = 0.0f;
  }
  // positions the group needs: its last query attends t < seq + kq0 + kg - 1;
  // the table covers max_pages * page of them
  long long tmax = (long long)seq + kq0 + kg - 1;
  if (tmax > (long long)max_pages * page) tmax = (long long)max_pages * page;
  const int* row = table + (long long)b * max_pages;
  __syncthreads();

  for (long long t0 = 0; t0 < tmax; t0 += PA_TT) {
    const int n = (int)(tmax - t0 < PA_TT ? tmax - t0 : PA_TT);
    if (tid < n) {
      const long long t = t0 + tid;
      int pg = row[t / page];
      pg = pg < 0 ? 0 : (pg >= n_pages ? n_pages - 1 : pg);
      const long long off = t % page;
      kbase[tid] = pg * st.k_page + off * st.k_tok + h * st.k_head;
      vbase[tid] = pg * st.v_page + off * st.v_tok + h * st.v_head;
      if (quantized) {
        kscl[tid] = ks[pg * st.ks_page + h * st.ks_head];
        vscl[tid] = vs[pg * st.vs_page + h * st.vs_head];
      }
    }
    __syncthreads();
    // scores, one slice of dc columns at a time; the chunk's V rows of the
    // output tile load with the first slice, and the last slice masks and
    // scales (one slice, the common case, is one load phase and one pass)
    for (int sl = 0; sl < n_dc; ++sl) {
      const int c0 = sl * dc;
      const int w = D - c0 < dc ? D - c0 : dc;
      // the slice test stays outside the load loops and they are unrolled, so
      // each thread keeps several loads in flight: the test inside one loop
      // made K = 1 decode 1.5x slower
      if (n_dc == 1) {  // one slice: the output tile is the whole head, load V beside K
#pragma unroll 4
        for (int e = tid; e < n * w; e += PA_THREADS) {
          const int i = e / w, d = e - i * w;
          float kv = to_float<T>(kp[kbase[i] + d]);
          float vv = to_float<T>(vp[vbase[i] + d]);
          if (quantized) {
            kv *= kscl[i];
            vv *= vscl[i];
          }
          kt[i * ldk + d] = kv;
          vt[i * dt + d] = vv;
        }
      } else {
        load_q_slice<Q>(qs, q, row0, kq0, kg, H, D, c0, w, dc);
#pragma unroll 4
        for (int e = tid; e < n * w; e += PA_THREADS) {
          const int i = e / w, d = e - i * w;
          float kv = to_float<T>(kp[kbase[i] + c0 + d]);
          if (quantized) kv *= kscl[i];
          kt[i * ldk + d] = kv;
        }
      }
      if (c0 == 0 && n_dc > 1) {
        for (int e = tid; e < n * dtw; e += PA_THREADS) {
          const int i = e / dtw, d = e - i * dtw;
          float vv = to_float<T>(vp[vbase[i] + d0 + d]);
          if (quantized) vv *= vscl[i];
          vt[i * dt + d] = vv;
        }
      }
      __syncthreads();
      for (int e = tid; e < kg * PA_TT; e += PA_THREADS) {
        const int kq = e / PA_TT, i = e - kq * PA_TT;
        // a masked position's partial dot is never read: the last slice
        // writes the sentinel
        const bool valid = i < n && t0 + i < (long long)seq + kq0 + kq;
        float dot = c0 == 0 ? 0.0f : sc[e];
        if (valid) {
          const float* qr = qs + kq * dc;
          const float* kr = kt + i * ldk;
          for (int d = 0; d < w; ++d) dot = fmaf(qr[d], kr[d], dot);
        }
        if (sl == n_dc - 1) dot = valid ? dot * scale : PA_NEG_INF;
        sc[e] = dot;
      }
      __syncthreads();
    }
    for (int kq = warp; kq < kg; kq += PA_THREADS / 32) {
      const float s = sc[kq * PA_TT + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m[kq];
      const float m_new = fmaxf(m_old, mx);
      const float p = s > 0.5f * PA_NEG_INF ? expf(s - m_new) : 0.0f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sc[kq * PA_TT + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[kq] = c;
        l[kq] = l[kq] * c + sum;
        m[kq] = m_new;
      }
    }
    __syncthreads();
    for (int e = tid; e < kg * dtw; e += PA_THREADS) {
      const int kq = e / dtw, d = e - kq * dtw;
      const float* pr = sc + kq * PA_TT;
      float a = acc[kq * dt + d] * corr[kq];
      for (int i = 0; i < n; ++i) a = fmaf(pr[i], vt[i * dt + d], a);
      acc[kq * dt + d] = a;
    }
    __syncthreads();
  }
  for (int e = tid; e < kg * dtw; e += PA_THREADS) {
    const int kq = e / dtw, d = e - kq * dtw;
    const float lf = l[kq];
    store_out<Q>(out + row0 + (long long)(kq0 + kq) * H * D + d0 + d,
                 acc[kq * dt + d] / (lf > 0.0f ? lf : 1.0f));
  }
}

template <typename Q, typename T, bool ONE>
static int launch_one(const void* q, const void* kp, const void* vp, const float* ks,
                      const float* vs, const int* table, const int* lens, void* out, int B,
                      int K, int H, int D, int page, int n_pages, int max_pages,
                      PoolStrides st, cudaStream_t stream) {
  const int kg = K < PA_KG ? K : PA_KG;
  const int dc = D < PA_DC ? D : PA_DC;
  const size_t smem = smem_bytes(kg, dc, dc);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<Q, T, ONE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long z = (long long)((K + kg - 1) / kg) * ((D + dc - 1) / dc);
  if (z > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, (unsigned)z);
  paged_attention_kernel<Q, T, ONE><<<grid, PA_THREADS, smem, stream>>>(
      (const Q*)q, (const T*)kp, (const T*)vp, ks, vs, table, lens, (Q*)out, K, H, D, page,
      n_pages, max_pages, st, (float)(1.0 / sqrt((double)D)), kg, dc, dc);
  return (int)cudaGetLastError();
}

template <typename Q, typename T>
static int launch(const void* q, const void* kp, const void* vp, const float* ks,
                  const float* vs, const int* table, const int* lens, void* out, int B,
                  int K, int H, int D, int page, int n_pages, int max_pages, PoolStrides st,
                  cudaStream_t s) {
  if (D <= PA_DC)
    return launch_one<Q, T, true>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                  n_pages, max_pages, st, s);
  return launch_one<Q, T, false>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                 n_pages, max_pages, st, s);
}

template <typename Q>
static int launch_pool(int dtype, const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* table, const int* lens,
                       void* out, int B, int K, int H, int D, int page, int n_pages,
                       int max_pages, PoolStrides st, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch<Q, float>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                    n_pages, max_pages, st, s);
    case 1: return launch<Q, int8_t>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                     n_pages, max_pages, st, s);
    case 2: return launch<Q, __nv_fp8_e4m3>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D,
                                            page, n_pages, max_pages, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// pool dtype codes: 0 f32, 1 int8, 2 fp8 e4m3 (ks/vs null for f32 pools);
// q and out are f32 (q_bf16 == 0) or bf16.
extern "C" int ts_paged_attention(const void* q, const void* kp, const void* vp,
                                  const float* ks, const float* vs, const int* table,
                                  const int* lens, void* out, int B, int K, int H, int D,
                                  int page, int n_pages, int max_pages, int dtype, int q_bf16,
                                  long long k_page, long long k_tok, long long k_head,
                                  long long v_page, long long v_tok, long long v_head,
                                  long long ks_page, long long ks_head, long long vs_page,
                                  long long vs_head, void* stream) {
  if (B < 0 || K < 1 || H < 1 || H > 65535 || D < 1 || page < 1 || n_pages < 1 ||
      max_pages < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((dtype != 0) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const PoolStrides st{k_page, k_tok, k_head, v_page, v_tok, v_head,
                       ks_page, ks_head, vs_page, vs_head};
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return launch_pool<__nv_bfloat16>(dtype, q, kp, vp, ks, vs, table, lens, out, B, K, H, D,
                                      page, n_pages, max_pages, st, s);
  return launch_pool<float>(dtype, q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                            n_pages, max_pages, st, s);
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
