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
// l > 0 guard on the final divide) with the 1/sqrt(D) scale; an idle slot
// (seq_len == 0) writes zeros.
//
// Plain C interface (ctypes): the launcher takes raw pointers, strides and
// the CUDA stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.
//
// Bound: bytes. Decode reads every cached K and V element once and does
// 4 flops per element and query, far below the card's rate; the least time
// is (pages read + q + out) / 3.35 TB/s. Design, simple first: one block
// per (head, sequence) walks the sequence's positions in chunks of 32
// tokens. A chunk's K and V rows (dequantized) go to shared memory, one
// thread per (query, position) forms a score (K rows padded to D + 1
// floats, so the threads of a warp hit distinct banks), one warp per query
// updates the running max and sum, and one thread per (query, d) element
// accumulates P.V into a shared-memory accumulator. The tile is in tokens,
// not pages, so any page size works and pages past the frontier
// (seq_len + K - 1) are never read. TMA page loads, 16-byte vector loads and
// a split over pages for small batches are later work.

#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <cstdint>

constexpr int PA_THREADS = 128;
constexpr int PA_TT = 32;  // tokens per chunk: one warp's lanes in the softmax
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

struct PoolStrides {
  long long k_page, k_tok, k_head, v_page, v_tok, v_head;
  long long ks_page, ks_head, vs_page, vs_head;
};

// Shared memory, in order: K and V row offsets (TT long longs each), then
// floats: q (K*D), acc (K*D), K rows (TT*(D+1)), V rows (TT*D), scores or
// probabilities (K*TT), m, l, corr (K each), the K and V scales (TT each).
static size_t smem_bytes(int K, int D) {
  return 2 * PA_TT * sizeof(long long) +
         sizeof(float) * ((size_t)2 * K * D + (size_t)PA_TT * (D + 1) + (size_t)PA_TT * D +
                          (size_t)K * PA_TT + 3 * (size_t)K + 2 * PA_TT);
}

template <typename T>
__global__ void __launch_bounds__(PA_THREADS)
paged_attention_kernel(const float* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs, const int* __restrict__ table,
                       const int* __restrict__ lens, float* __restrict__ out, int K, int H,
                       int D, int page, int n_pages, int max_pages, PoolStrides st,
                       float scale) {
  static_assert(PA_TT == 32, "the softmax gives one lane to each token of a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* kbase = reinterpret_cast<long long*>(smem_raw);
  long long* vbase = kbase + PA_TT;
  float* qs = reinterpret_cast<float*>(vbase + PA_TT);
  float* acc = qs + K * D;
  float* kt = acc + K * D;
  float* vt = kt + PA_TT * (D + 1);
  float* sc = vt + PA_TT * D;
  float* m = sc + K * PA_TT;
  float* l = m + K;
  float* corr = l + K;
  float* kscl = corr + K;
  float* vscl = kscl + PA_TT;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int seq = lens[b];
  const bool quantized = ks != nullptr;
  // out[b, kq, h, d] and q[b, kq, h, d]: rows kq of this (b, h) are H*D apart
  const long long row0 = ((long long)b * K * H + h) * D;
  if (seq <= 0) {
    for (int e = tid; e < K * D; e += PA_THREADS)
      out[row0 + (long long)(e / D) * H * D + e % D] = 0.0f;
    return;
  }
  for (int e = tid; e < K * D; e += PA_THREADS) {
    qs[e] = q[row0 + (long long)(e / D) * H * D + e % D];
    acc[e] = 0.0f;
  }
  for (int kq = tid; kq < K; kq += PA_THREADS) {
    m[kq] = PA_NEG_INF;
    l[kq] = 0.0f;
  }
  // positions the sweep needs: query K-1 attends t < seq + K - 1; the
  // table covers max_pages * page of them
  long long tmax = (long long)seq + K - 1;
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
    for (int e = tid; e < n * D; e += PA_THREADS) {
      const int i = e / D, d = e - i * D;
      float kv = to_float<T>(kp[kbase[i] + d]);
      float vv = to_float<T>(vp[vbase[i] + d]);
      if (quantized) {
        kv *= kscl[i];
        vv *= vscl[i];
      }
      kt[i * (D + 1) + d] = kv;
      vt[i * D + d] = vv;
    }
    __syncthreads();
    for (int e = tid; e < K * PA_TT; e += PA_THREADS) {
      const int kq = e / PA_TT, i = e - kq * PA_TT;
      float s = PA_NEG_INF;
      if (i < n && t0 + i < (long long)seq + kq) {
        const float* qr = qs + kq * D;
        const float* kr = kt + i * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * scale;
      }
      sc[e] = s;
    }
    __syncthreads();
    for (int kq = warp; kq < K; kq += PA_THREADS / 32) {
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
    for (int e = tid; e < K * D; e += PA_THREADS) {
      const int kq = e / D, d = e - kq * D;
      const float* pr = sc + kq * PA_TT;
      float a = acc[e] * corr[kq];
      for (int i = 0; i < n; ++i) a = fmaf(pr[i], vt[i * D + d], a);
      acc[e] = a;
    }
    __syncthreads();
  }
  for (int e = tid; e < K * D; e += PA_THREADS) {
    const float lf = l[e / D];
    out[row0 + (long long)(e / D) * H * D + e % D] = acc[e] / (lf > 0.0f ? lf : 1.0f);
  }
}

template <typename T>
static int launch(const float* q, const void* kp, const void* vp, const float* ks,
                  const float* vs, const int* table, const int* lens, float* out, int B,
                  int K, int H, int D, int page, int n_pages, int max_pages, PoolStrides st,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(K, D);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(H, B);
  paged_attention_kernel<T><<<grid, PA_THREADS, smem, stream>>>(
      q, (const T*)kp, (const T*)vp, ks, vs, table, lens, out, K, H, D, page, n_pages,
      max_pages, st, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

// dtype codes: 0 f32, 1 int8, 2 fp8 e4m3. ks/vs are null for f32 pools.
extern "C" int ts_paged_attention(const float* q, const void* kp, const void* vp,
                                  const float* ks, const float* vs, const int* table,
                                  const int* lens, float* out, int B, int K, int H, int D,
                                  int page, int n_pages, int max_pages, int dtype,
                                  long long k_page, long long k_tok, long long k_head,
                                  long long v_page, long long v_tok, long long v_head,
                                  long long ks_page, long long ks_head, long long vs_page,
                                  long long vs_head, void* stream) {
  if (B < 0 || K < 1 || K > 64 || H < 1 || D < 1 || D > 256 || page < 1 || n_pages < 1 ||
      max_pages < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((dtype != 0) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const PoolStrides st{k_page, k_tok, k_head, v_page, v_tok, v_head,
                       ks_page, ks_head, vs_page, vs_head};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                 n_pages, max_pages, st, s);
    case 1: return launch<int8_t>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D, page,
                                  n_pages, max_pages, st, s);
    case 2: return launch<__nv_fp8_e4m3>(q, kp, vp, ks, vs, table, lens, out, B, K, H, D,
                                         page, n_pages, max_pages, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
