// Hand-written Hopper (sm_90a) kernels for decode attention over a paged KV pool.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/attention.py:
//   paged_attention_kernel + paged_combine_kernel
//       <- paged_attention (:1413, _paged_kernel :1297)
// which serves decode (K = 1 query per sequence), speculative verify and
// chunked context prefill (K queued queries) in one sweep of the pool.
//
// What it computes, per sequence b and head h: the K queries q[b, kq, h, :]
// attend cache positions t < seq_len[b] + kq, position t living at offset
// t % page of pool page table[b, t / page] (clipped to [0, P)); int8 and
// fp8-e4m3 pools are dequantized with their per-page per-head scale. The
// softmax is online (running max and sum per query, the NEG_INF sentinel, a
// l > 0 guard on the final divide) with the 1/sqrt(D) scale, in f32 for an
// f32 or a bf16 q; the output has q's type. An idle slot (seq_len <= 0)
// writes zeros.
//
// Plain C interface (ctypes): the launcher takes raw pointers, strides, the
// host's plan (ops/attention.py: paged_plan) and the CUDA stream, launches on
// that stream, allocates nothing and returns cudaGetLastError() as an int.
//
// Bound: bytes. Decode reads every cached K and V element once and does 4
// flops per element and query, far below the card's rate; the least time is
// (pages read + q + out) / 3.35 TB/s. What the design does about it:
//  - a block of 8 warps owns (head, sequence, group of <= 8 queries, output
//    tile of <= 512 columns, split of the positions) and streams its
//    positions through a ring of `stages` chunks of `tt` tokens in shared
//    memory, filled by cp.async (16 bytes a lane where the rows and strides
//    allow, else 8, 4 or 1: the `vb` route) so that the next chunks load
//    while this one computes; the host sizes a stage at up to 32 KB of K and
//    V rows, with as many stages as keep all of a launch's blocks resident;
//  - a head wider than one tile (D > 512: paged_wide_kernel) streams each
//    chunk through the ring as 512-column units, its K rows slice by slice
//    (partial scores summed in shared memory, q read a slice at a time),
//    then the V rows of the block's tile, so that no row and no q has to
//    fit shared memory whole and every head width runs;
//  - no thread waits on the page table or divides when it issues copies: its
//    token's table index and page offset step from chunk to chunk, and the
//    table entry loads a chunk ahead of its copies;
//  - int8 and fp8 rows travel as stored (a quarter of f32's bytes) and are
//    dequantized in registers with the page-head scale (int8 by a byte
//    permute into a float's mantissa, fp8 two elements at a time);
//  - scores are formed by whole warps: a lane holds 4 columns of q a
//    32-lane group (registers; shared memory past 512 columns), each warp
//    takes PA_G tokens at once, branch-free, and reduces their dot products
//    with xor shuffles; the warps of a block split a chunk's tokens and its
//    queries between them (8 x 1 at K = 1 ... 1 x 8), each with its own
//    running (m, l, acc), merged in warp order at the end;
//  - flash-decoding: where the (head, sequence, group) blocks would leave
//    the SMs under-filled, the host splits the positions; each split writes
//    its partial (m, l, acc) to scratch and paged_combine_kernel merges them
//    in split order, so two calls give the same bits (no atomics);
//  - positions past a group's frontier (seq_len + its last query) are never
//    read, and neither are the pages that hold them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <climits>
#include <cstdint>
#include <type_traits>

constexpr int PA_THREADS = 256;
constexpr int PA_WARPS = PA_THREADS / 32;
// blocks an SM holds: registers stay under 128 a thread (ptxas, left to
// itself, spilled a few bytes of long-lived indices at 64-72 registers),
// so that two blocks fit an SM where shared memory allows
constexpr int PA_MIN_BLOCKS = 2;
constexpr int PA_G = 4;             // tokens a warp scores at once
constexpr int PA_MAX_SPLITS = 64;
constexpr float PA_NEG_INF = -1e30f;

struct PoolStrides {
  long long k_page, k_tok, k_head, v_page, v_tok, v_head;
  long long ks_page, ks_head, vs_page, vs_head;
};

// One launch's operands and plan; the layout fields (d4 .. sc_bytes) are
// derived by the launcher.
struct PagedParams {
  const void* q;
  const unsigned char* kp;
  const unsigned char* vp;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lens;
  void* out;
  float* part_m;    // (n_split, B, K, H) when n_split > 1
  float* part_l;
  float* part_acc;  // (n_split, B, K, H, D)
  PoolStrides st;
  int B, K, H, D, page, n_pages, max_pages;
  int q_bf16, vb, tt, stages, n_split, split_len, wq, n_dt;
  int tt_pages, tt_off;  // a chunk's tokens as whole pages and a remainder
  int d4;           // 4-column groups of a row
  int rs;           // ring row stride, bytes (a multiple of 16): a row, or a wide head's slice
  int stage_bytes;  // K rows, V rows, K scales, V scales (wide: one unit's rows, both scales)
  int sc_bytes;     // a wide head's scores of a chunk, (wq, tt) f32, ahead of the ring
  float scale;
};

// ---- small helpers -----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)), "l"(g));
}
__device__ __forceinline__ void cp_async8(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_addr(s)), "l"(g));
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)), "l"(g));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }
// at most `n` of this thread's most recent groups still in flight (n = stages - 2)
__device__ __forceinline__ void cp_async_wait(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::);
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 2;\n" ::);
}

// 4 elements of a ring row (4-column group c4) as f32, undequantized
template <typename T>
__device__ __forceinline__ float4 load4(const unsigned char* row, int c4);
template <>
__device__ __forceinline__ float4 load4<float>(const unsigned char* row, int c4) {
  return *reinterpret_cast<const float4*>(row + 16 * c4);
}
// int8: each byte, biased to unsigned (^ 0x80), becomes the low mantissa
// byte of 2^23 by a byte permute, and 2^23 + 128 comes off exactly: two
// full-rate instructions an element instead of a quarter-rate I2F
__device__ __forceinline__ float s8_at(uint32_t biased, unsigned sel) {
  return __int_as_float((int)__byte_perm(biased, 0x4B000000u, sel)) - 8388736.0f;
}
template <>
__device__ __forceinline__ float4 load4<int8_t>(const unsigned char* row, int c4) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * c4) ^ 0x80808080u;
  return make_float4(s8_at(w, 0x7440u), s8_at(w, 0x7441u), s8_at(w, 0x7442u),
                     s8_at(w, 0x7443u));
}
// fp8 e4m3: two elements at a time to f16 (exact), then to f32 (exact)
template <>
__device__ __forceinline__ float4 load4<__nv_fp8_e4m3>(const unsigned char* row, int c4) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * c4);
  const float2 a = __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3)));
  const float2 b = __half22float2(
      __half2(__nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3)));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}
__device__ __forceinline__ void axpy4(float a, float4 x, float4& y) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float load_q(const void* q, long long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(q)[i])
              : reinterpret_cast<const float*>(q)[i];
}
__device__ __forceinline__ void store_out(void* out, long long i, float x, int bf16) {
  if (bf16)
    reinterpret_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
  else
    reinterpret_cast<float*>(out)[i] = x;
}

// ---- the ring's producer side ---------------------------------------------------

// Chunk loads: token i (of n) of a chunk of head h into one ring stage, `pg`
// its table entry (unclipped) and `off` its offset in the page, both carried
// by the caller from chunk to chunk without a division. Each token has tpt =
// PA_THREADS / tt threads (sub the thread's rank among them), which split
// its K and V rows into vb-byte pieces (V16: 16-byte cp.async; else the vb
// route: 8- or 4-byte cp.async, or plain byte loads); the quantized scales
// ride along as 4-byte copies.
template <typename T, bool V16>
__device__ __forceinline__ void load_chunk(const PagedParams& p, unsigned char* stage, int i,
                                           int sub, int tpt, int pg, int off, int n, int h) {
  constexpr bool QUANT = !std::is_same<T, float>::value;
  if (i >= n) return;
  pg = pg < 0 ? 0 : (pg >= p.n_pages ? p.n_pages - 1 : pg);
  const long long esize = sizeof(T);
  const unsigned char* kg =
      p.kp + (pg * p.st.k_page + (long long)off * p.st.k_tok + h * p.st.k_head) * esize;
  const unsigned char* vg =
      p.vp + (pg * p.st.v_page + (long long)off * p.st.v_tok + h * p.st.v_head) * esize;
  unsigned char* kd = stage + i * p.rs;
  unsigned char* vd = kd + p.tt * p.rs;
  const int rb = p.D * (int)sizeof(T);
  if (V16) {
    for (int o = 16 * sub; o < rb; o += 16 * tpt) {
      cp_async16(kd + o, kg + o);
      cp_async16(vd + o, vg + o);
    }
  } else if (p.vb == 8) {
#pragma unroll 1
    for (int o = 8 * sub; o < rb; o += 8 * tpt) {
      cp_async8(kd + o, kg + o);
      cp_async8(vd + o, vg + o);
    }
  } else if (p.vb == 4) {
#pragma unroll 1
    for (int o = 4 * sub; o < rb; o += 4 * tpt) {
      cp_async4(kd + o, kg + o);
      cp_async4(vd + o, vg + o);
    }
  } else {  // 1-byte elements at no 4-byte alignment: plain loads
#pragma unroll 1
    for (int o = sub; o < rb; o += tpt) {
      kd[o] = kg[o];
      vd[o] = vg[o];
    }
  }
  if (QUANT && sub == 0) {
    float* kss = reinterpret_cast<float*>(stage + 2 * p.tt * p.rs);
    cp_async4(kss + i, p.ks + pg * p.st.ks_page + h * p.st.ks_head);
    cp_async4(kss + p.tt + i, p.vs + pg * p.st.vs_page + h * p.st.vs_head);
  }
}

// ---- the warps' merge ---------------------------------------------------------------

// The end of a split block: the token warps of each query merged in warp
// order, through shared memory that aliases the ring (every copy landed,
// every read done), then the block's tile of the output (or, split, its
// partial m, l and acc). wt, wt_n and wq: the warp's token slot, the token
// slots and its query in the group.
template <int NJ>
__device__ __forceinline__ void merge_warps(const PagedParams& p, unsigned char* ring, float m,
                                            float l, const float4 (&acc)[NJ], int wt, int wt_n,
                                            int wq) {
  const int tid = threadIdx.x, lane = tid & 31;
  cp_async_wait_all();
  __syncthreads();
  constexpr int SLOT = 4 + 4 * 32 * NJ;  // floats: m, l, 2 pad, the tile's acc
  float* mg = reinterpret_cast<float*>(ring);
  {
    float* sp = mg + (wt * p.wq + wq) * SLOT;
    if (lane == 0) {
      sp[0] = m;
      sp[1] = l;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) reinterpret_cast<float4*>(sp + 4)[lane + 32 * j] = acc[j];
  }
  __syncthreads();
  // the block's coordinates again (re-read, not kept live through the loop)
  int ze;
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(ze));
  const int split_e = ze % p.n_split, dt_e = (ze / p.n_split) % p.n_dt;
  const int kq0_e = ze / p.n_split / p.n_dt * p.wq;
  const int kg_e = p.K - kq0_e < p.wq ? p.K - kq0_e : p.wq;
  const int d_lo = 4 * 32 * NJ * dt_e;
  const int dtw = p.D - d_lo < 4 * 32 * NJ ? p.D - d_lo : 4 * 32 * NJ;
  const long long rows = (long long)p.B * p.K * p.H;
  for (int e = tid; e < kg_e * dtw; e += PA_THREADS) {
    const int i = e / dtw, d = e - i * dtw;
    float M = PA_NEG_INF;
    for (int v = 0; v < wt_n; ++v) M = fmaxf(M, mg[(v * p.wq + i) * SLOT]);
    float L = 0.0f, O = 0.0f;
    for (int v = 0; v < wt_n; ++v) {
      const float* sp = mg + (v * p.wq + i) * SLOT;
      const float f = expf(sp[0] - M);
      L += sp[1] * f;
      O += sp[4 + d] * f;
    }
    const long long r = ((long long)blockIdx.y * p.K + kq0_e + i) * p.H + blockIdx.x;
    if (p.n_split == 1) {
      store_out(p.out, r * p.D + d_lo + d, L > 0.0f ? O / L : 0.0f, p.q_bf16);
    } else {
      const long long pr = (long long)split_e * rows + r;
      if (dt_e == 0 && d == 0) {
        p.part_m[pr] = M;
        p.part_l[pr] = L;
      }
      p.part_acc[pr * p.D + d_lo + d] = O;
    }
  }
}

// ---- the split kernel -------------------------------------------------------------

// grid (H, B, groups * n_split) for heads up to one tile (D <= 512). NJ:
// 4-column groups a lane owns of the block's output tile (tile = 128 * NJ
// columns).
template <typename T, bool V16, int NJ>
__global__ void __launch_bounds__(PA_THREADS, PA_MIN_BLOCKS)
paged_attention_kernel(const PagedParams p) {
  constexpr bool QUANT = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  int z = blockIdx.z;
  const int split = z % p.n_split;
  z /= p.n_split;
  const int dt = z % p.n_dt, grp = z / p.n_dt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wt_n = PA_WARPS / p.wq;          // warps that split a chunk's tokens
  const int wq = warp % p.wq, wt = warp / p.wq;
  const int kq0 = grp * p.wq, kq = kq0 + wq;
  const int kg = p.K - kq0 < p.wq ? p.K - kq0 : p.wq;
  const bool active = kq < p.K;
  const int seq = p.lens[b];
  // the group's frontier: its last query attends t < seq + kq0 + kg - 1; the
  // table covers max_pages * page positions (< 2^31, the launcher checks);
  // an idle slot reads nothing
  const int tcap = p.max_pages * p.page;
  const int tmax = seq <= 0 ? 0 : (seq > tcap - kq0 - kg + 1 ? tcap : seq + kq0 + kg - 1);
  const int t_lo = split * p.split_len;
  const int t_hi = t_lo + p.split_len < tmax ? t_lo + p.split_len : tmax;
  const int nch = t_hi > t_lo ? (t_hi - t_lo + p.tt - 1) / p.tt : 0;
  const int dt0 = dt * 32 * NJ;              // the tile's first 4-column group
  const int* row = p.table + (long long)b * p.max_pages;

  unsigned char* ring = smem;

  // columns [D, 4 * d4) of every ring row are read as zeros
  const int rb = p.D * (int)sizeof(T), rpad = 4 * p.d4 * (int)sizeof(T);
  if (rpad > rb)
    for (int e = tid; e < p.stages * 2 * p.tt; e += PA_THREADS) {
      unsigned char* r = ring + (e / (2 * p.tt)) * p.stage_bytes + (e % (2 * p.tt)) * p.rs;
      for (int o = rb; o < rpad; ++o) r[o] = 0;
    }
  float4 qv[NJ];
  {
    const long long q0 = (((long long)b * p.K + kq) * p.H + h) * p.D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int d = 4 * (lane + 32 * j) + u;
        e[u] = active && d < p.D ? load_q(p.q, q0 + d, p.q_bf16) : 0.0f;
      }
      qv[j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  }
  // this lane's 4-column groups of the score (kcol) and of the output tile (vcol)
  bool kcol[NJ], vcol[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    kcol[j] = lane + 32 * j < p.d4;
    vcol[j] = dt0 + lane + 32 * j < p.d4;
  }
  float m = PA_NEG_INF, l = 0.0f;
  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the ring: stages - 1 chunks in flight ahead of the one computed. The
  // loads of a thread serve token li of every chunk (tpt threads a token,
  // tt a power of two); its position is carried as a page-table index and a
  // page offset, and its table entry loads a chunk ahead of its copies, so
  // no thread waits on the table or divides when it issues them.
  const int tpt = PA_THREADS / p.tt, li = tid >> (__ffs(tpt) - 1), lsub = tid & (tpt - 1);
  // (the first table entries load before the length is known: they bound
  // only the table, never a page)
  const int t_end = t_lo + p.split_len < tcap ? t_lo + p.split_len : tcap;
  int cur_t = t_lo + li;
  int cur_idx = cur_t / p.page, cur_off = cur_t - cur_idx * p.page;
  int pgs[4], offs[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    pgs[u] = cur_t < t_end && u < p.stages ? row[cur_idx] : 0;
    offs[u] = cur_off;
    cur_t += p.tt;
    cur_idx += p.tt_pages;
    cur_off += p.tt_off;
    if (cur_off >= p.page) {
      cur_off -= p.page;
      ++cur_idx;
    }
  }
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    if (u >= p.stages - 1) break;
    if (u < nch) {
      const int t0 = t_lo + u * p.tt;
      load_chunk<T, V16>(p, ring + u * p.stage_bytes, li, lsub, tpt, pgs[u], offs[u],
                         t_hi - t0 < p.tt ? t_hi - t0 : p.tt, h);
    }
    cp_async_commit();
  }
  // chunk stages - 1: the first the loop issues; the cursor is past chunk 3
  int pg_next = p.stages == 2 ? pgs[1] : (p.stages == 3 ? pgs[2] : pgs[3]);
  int off_next = p.stages == 2 ? offs[1] : (p.stages == 3 ? offs[2] : offs[3]);
  if (p.stages < 4) {  // step the cursor back to chunk stages
    cur_t -= (4 - p.stages) * p.tt;
    cur_idx = cur_t / p.page;
    cur_off = cur_t - cur_idx * p.page;
  }
  int st_in = p.stages - 1, st_c = 0;  // ring stages of the next issue and of chunk c
  for (int c = 0; c < nch; ++c) {
    cp_async_wait(p.stages - 2);
    __syncthreads();  // chunk c landed for every thread; chunk c-1's stage is free
    {
      const int cn = c + p.stages - 1;
      if (cn < nch) {
        const int t0 = t_lo + cn * p.tt;
        load_chunk<T, V16>(p, ring + st_in * p.stage_bytes, li, lsub, tpt, pg_next, off_next,
                           t_hi - t0 < p.tt ? t_hi - t0 : p.tt, h);
      }
      cp_async_commit();
      st_in = st_in + 1 == p.stages ? 0 : st_in + 1;
      pg_next = cur_t < t_hi ? row[cur_idx] : 0;
      off_next = cur_off;
      cur_t += p.tt;
      cur_idx += p.tt_pages;
      cur_off += p.tt_off;
      if (cur_off >= p.page) {
        cur_off -= p.page;
        ++cur_idx;
      }
    }
    const unsigned char* kst = ring + st_c * p.stage_bytes;
    st_c = st_c + 1 == p.stages ? 0 : st_c + 1;
    if (!active) continue;
    const unsigned char* vst = kst + p.tt * p.rs;
    const float* kss = reinterpret_cast<const float*>(vst + p.tt * p.rs);
    const int t0 = t_lo + c * p.tt;
    const int n = t_hi - t0 < p.tt ? t_hi - t0 : p.tt;
    // PA_G tokens a step, branch-free so that their chains interleave: a
    // token past the chunk's end reads the chunk's last row (loaded, finite)
    // and a masked one weighs 0
    for (int i0 = wt; i0 < n; i0 += wt_n * PA_G) {
      float dot[PA_G];
      int ir[PA_G];
      bool ok[PA_G];
#pragma unroll
      for (int g = 0; g < PA_G; ++g) {
        const int i = i0 + g * wt_n;
        ok[g] = i < n && t0 + i - kq < seq;
        ir[g] = i < n ? i : n - 1;
        const unsigned char* kr = kst + ir[g] * p.rs;
        dot[g] = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (kcol[j]) dot[g] = dot4(qv[j], load4<T>(kr, lane + 32 * j), dot[g]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int g = 0; g < PA_G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
      float s[PA_G];
      float mx = m;
#pragma unroll
      for (int g = 0; g < PA_G; ++g) {
        const float sc = QUANT ? p.scale * kss[ir[g]] : p.scale;
        s[g] = ok[g] ? dot[g] * sc : PA_NEG_INF;
        mx = fmaxf(mx, s[g]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[j].x *= corr;
        acc[j].y *= corr;
        acc[j].z *= corr;
        acc[j].w *= corr;
      }
#pragma unroll
      for (int g = 0; g < PA_G; ++g) {
        const float e = expf(s[g] - mx);
        const float pg = ok[g] ? e : 0.0f;
        l += pg;
        const float pv = QUANT ? pg * kss[p.tt + ir[g]] : pg;
        const unsigned char* vr = vst + ir[g] * p.rs;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (vcol[j]) axpy4(pv, load4<T>(vr, dt0 + lane + 32 * j), acc[j]);
      }
      m = mx;
    }
  }

  merge_warps<NJ>(p, ring, m, l, acc, wt, wt_n, wq);
}

// ---- the wide kernel ---------------------------------------------------------------

constexpr int PA_TILE = 512;  // columns of a wide head's unit: 128 4-column groups, NJ 4

// Unit loads of the wide kernel: 512 columns from col0 of token i's K row
// (or V row: is_v, with both quantized scales) into its row of one ring
// stage, as load_chunk splits a token's bytes. Columns [D, 4 * d4) of a
// slice that ends there are written as zeros.
template <typename T, bool V16>
__device__ __forceinline__ void load_slice(const PagedParams& p, unsigned char* stage, int i,
                                           int sub, int tpt, int pg, int off, int n, int h,
                                           int col0, bool is_v) {
  constexpr bool QUANT = !std::is_same<T, float>::value;
  if (i >= n) return;
  pg = pg < 0 ? 0 : (pg >= p.n_pages ? p.n_pages - 1 : pg);
  const long long esize = sizeof(T);
  const unsigned char* src =
      is_v ? p.vp + (pg * p.st.v_page + (long long)off * p.st.v_tok + h * p.st.v_head + col0) * esize
           : p.kp + (pg * p.st.k_page + (long long)off * p.st.k_tok + h * p.st.k_head + col0) * esize;
  unsigned char* dst = stage + i * p.rs;
  const int cols = p.D - col0 < PA_TILE ? p.D - col0 : PA_TILE;
  const int rb = cols * (int)sizeof(T);
  if (V16) {
    for (int o = 16 * sub; o < rb; o += 16 * tpt) cp_async16(dst + o, src + o);
  } else if (p.vb == 8) {
#pragma unroll 1
    for (int o = 8 * sub; o < rb; o += 8 * tpt) cp_async8(dst + o, src + o);
  } else if (p.vb == 4) {
#pragma unroll 1
    for (int o = 4 * sub; o < rb; o += 4 * tpt) cp_async4(dst + o, src + o);
  } else {  // 1-byte elements at no 4-byte alignment: plain loads
#pragma unroll 1
    for (int o = sub; o < rb; o += tpt) dst[o] = src[o];
  }
  if (sub == 0) {
    const int rpad = 4 * ((cols + 3) / 4) * (int)sizeof(T);
    for (int o = rb; o < rpad; ++o) dst[o] = 0;
    if (QUANT && is_v) {
      float* ss = reinterpret_cast<float*>(stage + p.tt * p.rs);
      cp_async4(ss + i, p.ks + pg * p.st.ks_page + h * p.st.ks_head);
      cp_async4(ss + p.tt + i, p.vs + pg * p.st.vs_page + h * p.st.vs_head);
    }
  }
}

// grid (H, B, groups * n_dt * n_split) for heads wider than one tile (D >
// 512): the block accumulates its tile's 512 columns of the output, and its
// scores run over all of D. A chunk of tt tokens passes through the ring as
// n_dt + 1 units: its K rows in n_dt slices of 512 columns, each dotted
// with the same columns of q (read from global memory a slice at a time)
// and summed into the chunk's scores in shared memory (a warp owns its
// tokens' scores in every slice), then the V rows of the block's tile,
// where the softmax step and P.V run as in paged_attention_kernel. Neither
// the ring nor the scores grow with D or K, so every width runs.
template <typename T, bool V16>
__global__ void __launch_bounds__(PA_THREADS, PA_MIN_BLOCKS)
paged_wide_kernel(const PagedParams p) {
  constexpr bool QUANT = !std::is_same<T, float>::value;
  constexpr int NJ = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  int z = blockIdx.z;
  const int split = z % p.n_split;
  z /= p.n_split;
  const int dt = z % p.n_dt, grp = z / p.n_dt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wt_n = PA_WARPS / p.wq;          // warps that split a chunk's tokens
  const int wq = warp % p.wq, wt = warp / p.wq;
  const int kq0 = grp * p.wq, kq = kq0 + wq;
  const int kg = p.K - kq0 < p.wq ? p.K - kq0 : p.wq;
  const bool active = kq < p.K;
  const int seq = p.lens[b];
  const int tcap = p.max_pages * p.page;
  const int tmax = seq <= 0 ? 0 : (seq > tcap - kq0 - kg + 1 ? tcap : seq + kq0 + kg - 1);
  const int t_lo = split * p.split_len;
  const int t_hi = t_lo + p.split_len < tmax ? t_lo + p.split_len : tmax;
  const int nch = t_hi > t_lo ? (t_hi - t_lo + p.tt - 1) / p.tt : 0;
  const int dt0 = dt * 32 * NJ;              // the tile's first 4-column group
  const int* row = p.table + (long long)b * p.max_pages;
  float* scw = reinterpret_cast<float*>(smem) + wq * p.tt;  // this query's scores of a chunk
  unsigned char* ring = smem + p.sc_bytes;
  const long long q0 = (((long long)b * p.K + kq) * p.H + h) * p.D;

  bool vcol[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) vcol[j] = dt0 + lane + 32 * j < p.d4;
  float m = PA_NEG_INF, l = 0.0f;
  float4 acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the producer: units of chunk in_c, part in_s (n_dt K slices, then V),
  // token li's table entry loaded when its chunk's first unit is fetched
  const int nu = p.n_dt + 1, nunits = nch * nu;
  const int tpt = PA_THREADS / p.tt, li = tid >> (__ffs(tpt) - 1), lsub = tid & (tpt - 1);
  int in_c = 0, in_s = 0;
  int cur_t = t_lo + li;
  int cur_idx = cur_t / p.page, cur_off = cur_t - cur_idx * p.page;
  int pg = cur_t < t_hi ? row[cur_idx] : 0;
  auto fetch = [&](int st) {
    if (in_c < nch) {
      const int t0 = t_lo + in_c * p.tt;
      const bool is_v = in_s == p.n_dt;
      load_slice<T, V16>(p, ring + st * p.stage_bytes, li, lsub, tpt, pg, cur_off,
                         t_hi - t0 < p.tt ? t_hi - t0 : p.tt, h,
                         (is_v ? dt : in_s) * PA_TILE, is_v);
      if (++in_s == nu) {
        in_s = 0;
        ++in_c;
        cur_t += p.tt;
        cur_idx += p.tt_pages;
        cur_off += p.tt_off;
        if (cur_off >= p.page) {
          cur_off -= p.page;
          ++cur_idx;
        }
        pg = cur_t < t_hi ? row[cur_idx] : 0;
      }
    }
    cp_async_commit();
  };
  for (int u = 0; u < p.stages - 1; ++u) fetch(u);
  int st_in = p.stages - 1, st_c = 0;  // ring stages of the next fetch and of unit u
  int c = 0, part = 0;                 // unit u's chunk and part
  for (int u = 0; u < nunits; ++u) {
    cp_async_wait(p.stages - 2);
    __syncthreads();  // unit u landed for every thread; unit u-1's stage is free
    fetch(st_in);
    st_in = st_in + 1 == p.stages ? 0 : st_in + 1;
    const unsigned char* st = ring + st_c * p.stage_bytes;
    st_c = st_c + 1 == p.stages ? 0 : st_c + 1;
    const int cu = c, pu = part;
    if (++part == nu) {
      part = 0;
      ++c;
    }
    if (!active) continue;
    const int t0 = t_lo + cu * p.tt;
    const int n = t_hi - t0 < p.tt ? t_hi - t0 : p.tt;
    if (pu < p.n_dt) {
      // slice pu: this lane's 4-column groups pu * 128 + lane + 32 j of q
      float4 qv[NJ];
      bool kcol[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c4 = 32 * NJ * pu + lane + 32 * j;
        kcol[j] = c4 < p.d4;
        float e[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int d = 4 * c4 + v;
          e[v] = d < p.D ? load_q(p.q, q0 + d, p.q_bf16) : 0.0f;
        }
        qv[j] = make_float4(e[0], e[1], e[2], e[3]);
      }
      for (int i0 = wt; i0 < n; i0 += wt_n * PA_G) {
        float dot[PA_G];
#pragma unroll
        for (int g = 0; g < PA_G; ++g) {
          const int i = i0 + g * wt_n;
          const unsigned char* kr = st + (i < n ? i : n - 1) * p.rs;
          dot[g] = 0.0f;
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            if (kcol[j]) dot[g] = dot4(qv[j], load4<T>(kr, lane + 32 * j), dot[g]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int g = 0; g < PA_G; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        if (lane == 0)
#pragma unroll
          for (int g = 0; g < PA_G; ++g) {
            const int i = i0 + g * wt_n;
            if (i < n) scw[i] = pu == 0 ? dot[g] : scw[i] + dot[g];
          }
      }
      continue;
    }
    // the V tile: the softmax step and P.V over this chunk's summed scores
    __syncwarp();  // lane 0's score sums, visible to the warp
    const float* kss = reinterpret_cast<const float*>(st + p.tt * p.rs);
    for (int i0 = wt; i0 < n; i0 += wt_n * PA_G) {
      float s[PA_G];
      int ir[PA_G];
      bool ok[PA_G];
      float mx = m;
#pragma unroll
      for (int g = 0; g < PA_G; ++g) {
        const int i = i0 + g * wt_n;
        ok[g] = i < n && t0 + i - kq < seq;
        ir[g] = i < n ? i : n - 1;
        const float sc = QUANT ? p.scale * kss[ir[g]] : p.scale;
        s[g] = ok[g] ? scw[ir[g]] * sc : PA_NEG_INF;
        mx = fmaxf(mx, s[g]);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[j].x *= corr;
        acc[j].y *= corr;
        acc[j].z *= corr;
        acc[j].w *= corr;
      }
#pragma unroll
      for (int g = 0; g < PA_G; ++g) {
        const float e = expf(s[g] - mx);
        const float pg_ = ok[g] ? e : 0.0f;
        l += pg_;
        const float pv = QUANT ? pg_ * kss[p.tt + ir[g]] : pg_;
        const unsigned char* vr = st + ir[g] * p.rs;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          if (vcol[j]) axpy4(pv, load4<T>(vr, lane + 32 * j), acc[j]);
      }
      m = mx;
    }
  }
  merge_warps<NJ>(p, ring, m, l, acc, wt, wt_n, wq);
}

// ---- the combine kernel -----------------------------------------------------------

// One block a (b, kq, h) row: the splits' partials merged in split order,
// out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s
// (0 where nothing was attended).
__global__ void __launch_bounds__(PA_THREADS)
paged_combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
                     const float* __restrict__ pacc, void* out, long long rows, int D,
                     int n_split, int q_bf16) {
  __shared__ float f[PA_MAX_SPLITS];
  __shared__ float total;
  const long long r = blockIdx.x;
  if (threadIdx.x == 0) {
    float M = PA_NEG_INF;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, pm[s * rows + r]);
    float L = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      f[s] = expf(pm[s * rows + r] - M);
      L += pl[s * rows + r] * f[s];
    }
    total = L;
  }
  __syncthreads();
  const float L = total;
  for (int d = threadIdx.x; d < D; d += PA_THREADS) {
    float O = 0.0f;
    for (int s = 0; s < n_split; ++s) O += pacc[(s * rows + r) * D + d] * f[s];
    store_out(out, r * D + d, L > 0.0f ? O / L : 0.0f, q_bf16);
  }
}

// ---- launchers --------------------------------------------------------------------

// shared memory of a launch: a wide head's scores, then the ring (which
// the warp merge reuses)
static size_t smem_bytes(const PagedParams& p, int nj) {
  const size_t ring = (size_t)p.stages * p.stage_bytes;
  const size_t merge = (size_t)PA_WARPS * (4 + 4 * 32 * nj) * sizeof(float);
  return (size_t)p.sc_bytes + (ring > merge ? ring : merge);
}

template <int NJ>
static int launch_split(void (*kern)(const PagedParams), const PagedParams& p,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes(p, NJ);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (p.K + p.wq - 1) / p.wq;
  const long long z = groups * p.n_dt * p.n_split;
  if (z > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3(p.H, p.B, (unsigned)z), PA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool V16>
static int launch_width(const PagedParams& p, int nj, int wide, cudaStream_t s) {
  if (wide) return launch_split<4>(paged_wide_kernel<T, V16>, p, s);
  switch (nj) {
    case 1: return launch_split<1>(paged_attention_kernel<T, V16, 1>, p, s);
    case 2: return launch_split<2>(paged_attention_kernel<T, V16, 2>, p, s);
    case 4: return launch_split<4>(paged_attention_kernel<T, V16, 4>, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
static int launch_pool(const PagedParams& p, int nj, int wide, cudaStream_t s) {
  return p.vb == 16 ? launch_width<T, true>(p, nj, wide, s)
                    : launch_width<T, false>(p, nj, wide, s);
}

static bool aligned(long long x, int w) { return x % w == 0; }

// pool dtype codes: 0 f32, 1 int8, 2 fp8 e4m3 (ks/vs null for f32 pools);
// q and out are f32 (q_bf16 == 0) or bf16. The plan (vb, tt, stages,
// n_split, split_len, wq, nj, wide, n_dt) comes from ops/attention.py's
// paged_plan; the part_* scratch is (n_split, B, K, H[, D]) f32 and unused
// (may be null) when n_split == 1.
extern "C" int ts_paged_attention(
    const void* q, const void* kp, const void* vp, const float* ks, const float* vs,
    const int* table, const int* lens, void* out, float* part_m, float* part_l,
    float* part_acc, int B, int K, int H, int D, int page, int n_pages, int max_pages,
    int dtype, int q_bf16, int vb, int tt, int stages, int n_split, int split_len, int wq,
    int nj, int wide, int n_dt, long long k_page, long long k_tok, long long k_head,
    long long v_page, long long v_tok, long long v_head, long long ks_page, long long ks_head,
    long long vs_page, long long vs_head, void* stream) {
  if (B < 0 || K < 1 || H < 1 || D < 1 || page < 1 || n_pages < 1 || max_pages < 1 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype < 0 || dtype > 2 || (dtype != 0) != (ks != nullptr) ||
      (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (tt < 1 || tt > PA_THREADS || (tt & (tt - 1)) != 0 || stages < 2 || stages > 4 ||
      n_split < 1 || n_split > PA_MAX_SPLITS || split_len < 1 ||
      (long long)split_len * n_split < (long long)max_pages * page ||
      (long long)split_len * n_split > INT_MAX / 2 ||
      (n_split > 1 && (!part_m || !part_l || !part_acc)) ||
      !(wq == 1 || wq == 2 || wq == 4 || wq == 8) || n_dt < 1)
    return (int)cudaErrorInvalidValue;
  const int d4 = (D + 3) / 4;
  if (wide ? (nj != 4 || n_dt != (d4 + 127) / 128 || d4 <= 128)
           : (n_dt != 1 || !(nj == 1 || nj == 2 || nj == 4) || d4 > 32 * nj))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 1;
  // the load route must divide the rows, every stride and both bases
  if (!(vb == 16 || vb == 8 || vb == 4 || (vb == 1 && esize == 1)) ||
      !aligned((long long)D * esize, vb) || !aligned((long long)(uintptr_t)kp, vb) ||
      !aligned((long long)(uintptr_t)vp, vb))
    return (int)cudaErrorMisalignedAddress;
  const long long strides[6] = {k_page, k_tok, k_head, v_page, v_tok, v_head};
  for (long long s : strides)
    if (!aligned(s * esize, vb)) return (int)cudaErrorMisalignedAddress;
  if (B == 0) return 0;
  PagedParams p{};
  p.q = q;
  p.kp = (const unsigned char*)kp;
  p.vp = (const unsigned char*)vp;
  p.ks = ks;
  p.vs = vs;
  p.table = table;
  p.lens = lens;
  p.out = out;
  p.part_m = part_m;
  p.part_l = part_l;
  p.part_acc = part_acc;
  p.st = PoolStrides{k_page, k_tok, k_head, v_page, v_tok, v_head,
                     ks_page, ks_head, vs_page, vs_head};
  p.B = B; p.K = K; p.H = H; p.D = D; p.page = page; p.n_pages = n_pages;
  p.max_pages = max_pages;
  p.q_bf16 = q_bf16; p.vb = vb; p.tt = tt; p.stages = stages; p.n_split = n_split;
  p.split_len = split_len; p.wq = wq; p.n_dt = n_dt;
  p.tt_pages = tt / page; p.tt_off = tt % page;
  p.d4 = d4;
  if (wide) {  // a stage holds one unit: 512 columns of the chunk's K or V rows
    p.rs = PA_TILE * esize;
    p.stage_bytes = (tt * p.rs + 2 * tt * 4 + 15) / 16 * 16;
    p.sc_bytes = (wq * tt * 4 + 15) / 16 * 16;
  } else {
    p.rs = (4 * d4 * esize + 15) / 16 * 16;
    p.stage_bytes = (2 * tt * p.rs + 2 * tt * 4 + 15) / 16 * 16;
    p.sc_bytes = 0;
  }
  p.scale = (float)(1.0 / sqrt((double)D));
  cudaStream_t s = (cudaStream_t)stream;
  int err;
  switch (dtype) {
    case 0: err = launch_pool<float>(p, nj, wide, s); break;
    case 1: err = launch_pool<int8_t>(p, nj, wide, s); break;
    default: err = launch_pool<__nv_fp8_e4m3>(p, nj, wide, s); break;
  }
  if (err != 0 || n_split == 1) return err;
  const long long rows = (long long)B * K * H;
  paged_combine_kernel<<<(unsigned)rows, PA_THREADS, 0, s>>>(part_m, part_l, part_acc, out,
                                                             rows, D, n_split, q_bf16);
  return (int)cudaGetLastError();
}

// the card's SM count and opt-in shared memory a block, for the host's plan
extern "C" int ts_paged_device(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
