// Hand-written Hopper (sm_90a) kernels for flash attention, forward and backward.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/attention.py:
//   flash_fwd_kernel     <- _flash_kernel (:205), _flash_kernel_state (:247),
//                           _flash_kernel_compact (:306); calls _flash_fwd_call (:865),
//                           _flash_fwd_compact (:356)
//   flash_bwd_dq_kernel  <- _dq_kernel (:431), _dq_kernel_compact (:539)
//   flash_bwd_dkv_kernel <- _dkv_kernel (:472), _dkv_kernel_compact (:603);
//                           both called by _flash_bwd_call (:800), _flash_bwd_compact (:675)
//
// What they compute, per entry b (the flattened leading dims), head h:
//   s = (q * scale) k^T, scale = 1/sqrt(D), masked on global positions
//   (query row qoff[b] + i keeps key column koff[b] + j iff i' >= j' when causal)
//   and on the ragged edges; the masked score is NEG_INF = -1e30 and its p is 0.
//   forward: online softmax (running max m, sum l, f32 accumulator); either the
//     normalized o = acc / l (l == 0 -> 0) in q's dtype, or the raw state
//     (acc f32, m, l) for a caller's softmax merge.
//   backward, from lse = m + log(max(l, 1e-30)) and delta = sum(do * o) (f32):
//     p = exp(s - lse), ds = p * (do v^T - delta),
//     dq = ds (k * scale), dk = ds^T (q * scale), dv = p^T do.
// bf16 operands follow the JAX package's _mm_dtype rule: q * scale, k * scale,
// p and ds are rounded to bf16 before their products, and every product sum
// accumulates in f32. Here each bf16 operand is rounded and then multiplied
// in f32 FMAs (a bf16 x bf16 product is exact in f32): the same values as a
// bf16 tensor-core product with f32 accumulation, summed in another order.
//
// Bound: operations. At the training shapes (S = T = 2048, D = 128) the
// kernels do ~4 S T D flops a (b, h) forward and ~10 S T D backward (half
// each when causal) against 4 (S + T) D elements moved: ~500 flops a byte,
// above the card's f32 ridge (67 TFLOP/s / 3.35 TB/s = 20) and its bf16 one.
// The least time is the flops over 67 TFLOP/s (f32 FMA) or 989 TFLOP/s (bf16
// tensor cores).
//
// Design, simple and right first: one block of 256 threads (16 x 16) per
// (entry, head, tile of R = 16 * RT rows). The TPU's sequential grid axis
// becomes a loop inside the block over the other side's tiles, which stops
// at the causal limit computed from that entry's offsets: the dense grid's
// block skip and the compact grid are the same loop with another bound, and
// one launch serves every entry (ring rank, batch row) with its own offsets.
// Tiles live in dynamic shared memory as f32 rows padded to an odd stride
// (no bank conflicts); each thread holds an RT x RT micro-tile of the score
// block and an RT x NC micro-tile of the output or gradient accumulators in
// registers, and every product is an FMA on the CUDA cores. The row count
// shrinks (RT = 4, 2, 1) until the tiles fit the card's shared memory, and a
// head wider than 16 * NC is split over blocks by output columns (each
// recomputes the scores). No atomics: dq, dk and dv are deterministic.
// wgmma / TMA / tensor-core paths are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

constexpr int FA_THREADS = 256;
constexpr float FA_NEG_INF = -1e30f;

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// round an f32 value to T's precision (the product operand type)
template <typename T>
__device__ __forceinline__ float rnd(float x);
template <>
__device__ __forceinline__ float rnd<float>(float x) { return x; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ void st(T* p, float x);
template <>
__device__ __forceinline__ void st<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void st<__nv_bfloat16>(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct FlashShape {
  int B, S, T, H, D;
  int causal;
  int ld;      // shared-memory row stride of a (rows, D) tile: D rounded up to odd
  int nq, nk;  // tiles of R rows over S and T
  int nd;      // column chunks of 16 * NC over D
  const int* qoff;  // per-entry global offsets, or null: qo0 / ko0 for every entry
  const int* koff;
  int qo0, ko0;
  float scale;  // 1/sqrt(D), already rounded to the operand type
};

__device__ __forceinline__ void entry_offsets(const FlashShape& f, int b, int& qo, int& ko) {
  qo = f.qoff ? f.qoff[b] : f.qo0;
  ko = f.koff ? f.koff[b] : f.ko0;
}

// Number of key tiles a query tile [i0, i0 + rows) needs: all of them, or,
// when causal, those with a column at or left of its last row's diagonal.
__device__ __forceinline__ int kv_tiles_needed(const FlashShape& f, int R, int i0, int qo,
                                               int ko) {
  if (!f.causal) return f.nk;
  const int last = min(i0 + R, f.S) - 1;
  const long long lim = (long long)qo - ko + last;  // last key column the tile sees
  if (lim < 0) return 0;
  const long long n = lim / R + 1;
  return n < f.nk ? (int)n : f.nk;
}

// First query tile that sees key column c0 (the kv tile's first), when causal.
__device__ __forceinline__ int first_q_tile(const FlashShape& f, int R, int c0, int qo, int ko) {
  if (!f.causal) return 0;
  const long long first = (long long)ko + c0 - qo;  // first local row that sees c0
  if (first <= 0) return 0;
  const long long t = first / R;
  return t < f.nq ? (int)t : f.nq;
}

__device__ __forceinline__ bool keep_score(const FlashShape& f, int row, int col, int qo,
                                           int ko) {
  return row < f.S && col < f.T && (!f.causal || (long long)qo + row >= (long long)ko + col);
}

// (rows, D) tile of x[b, r0 + r, h, :] into shared memory, times mul and
// rounded to T (mul == 1: the values as they are); rows past n are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* x, const FlashShape& f, int n,
                                          int b, int h, int r0, int rows, float mul) {
  const int D = f.D;
  for (int e = threadIdx.x; e < rows * D; e += FA_THREADS) {
    const int r = e / D, d = e - r * D;
    float val = 0.0f;
    if (r0 + r < n) {
      const float raw = ld<T>(x + (((long long)b * n + r0 + r) * f.H + h) * D + d);
      val = mul == 1.0f ? raw : rnd<T>(raw * mul);
    }
    dst[r * f.ld + d] = val;
  }
}

// Block index -> (entry b, column chunk dz, tile t) over grid.x = B * nd * ntiles;
// `reverse` hands out the highest tiles first (the longest causal rows).
__device__ __forceinline__ void block_coords(const FlashShape& f, int ntiles, bool reverse,
                                             int& b, int& dz, int& t) {
  const long long bx = blockIdx.x;
  t = (int)(bx % ntiles);
  if (reverse) t = ntiles - 1 - t;
  const long long rest = bx / ntiles;
  dz = (int)(rest % f.nd);
  b = (int)(rest / f.nd);
}

// ---- forward -----------------------------------------------------------------------
// shared memory: Q tile (R x ld, scaled), K-then-V tile (R x ld), P tile (R x (R + 1))
template <typename T, int RT, int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 void* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 FlashShape f, int state) {
  constexpr int R = 16 * RT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kv = qs + R * f.ld;
  float* ps = kv + R * f.ld;
  int b, dz, it;
  block_coords(f, f.nq, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int d0 = dz * 16 * NC;
  int qo, ko;
  entry_offsets(f, b, qo, ko);

  load_tile<T>(qs, q, f, f.S, b, h, i0, R, f.scale);
  float m[RT], l[RT], o[RT][NC];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    m[a] = FA_NEG_INF;
    l[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[a][c] = 0.0f;
  }
  const int nkv = kv_tiles_needed(f, R, i0, qo, ko);
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * R;
    __syncthreads();  // the previous tile's P.V is done with kv and ps
    load_tile<T>(kv, k, f, f.T, b, h, c0, R, 1.0f);
    __syncthreads();
    float s[RT][RT];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int c = 0; c < RT; ++c) s[a][c] = 0.0f;
    for (int d = 0; d < f.D; ++d) {
      float qa[RT], kb[RT];
#pragma unroll
      for (int a = 0; a < RT; ++a) qa[a] = qs[(ty + 16 * a) * f.ld + d];
#pragma unroll
      for (int c = 0; c < RT; ++c) kb[c] = kv[(tx + 16 * c) * f.ld + d];
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < RT; ++c) s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const int row = i0 + ty + 16 * a;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        if (!keep_score(f, row, c0 + tx + 16 * c, qo, ko)) s[a][c] = FA_NEG_INF;
        mx = fmaxf(mx, s[a][c]);
      }
      // the 16 threads of a row are lanes tx of one half-warp
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        // the guard: a masked score's p is 0 even when the whole row is masked
        const float p = s[a][c] > 0.5f * FA_NEG_INF ? expf(s[a][c] - m_new) : 0.0f;
        sum += p;
        ps[(ty + 16 * a) * (R + 1) + tx + 16 * c] = rnd<T>(p);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float corr = expf(m[a] - m_new);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[a][c] *= corr;
    }
    __syncthreads();  // every thread is done with K and has written its P
    load_tile<T>(kv, v, f, f.T, b, h, c0, R, 1.0f);
    __syncthreads();
    for (int jr = 0; jr < R; ++jr) {
      float pa[RT], vb[NC];
#pragma unroll
      for (int a = 0; a < RT; ++a) pa[a] = ps[(ty + 16 * a) * (R + 1) + jr];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        vb[c] = d < f.D ? kv[jr * f.ld + d] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) o[a][c] = fmaf(pa[a], vb[c], o[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= f.S) continue;
    const long long base = (((long long)b * f.S + row) * f.H + h) * f.D;
    if (state) {
      float* acc = reinterpret_cast<float*>(out);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        if (d < f.D) acc[base + d] = o[a][c];
      }
      if (dz == 0 && tx == 0) {
        const long long r = ((long long)b * f.H + h) * f.S + row;
        m_out[r] = m[a];
        l_out[r] = l[a];
      }
    } else {
      const float inv = 1.0f / (l[a] > 0.0f ? l[a] : 1.0f);
      T* o_out = reinterpret_cast<T*>(out);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        if (d < f.D) st<T>(o_out + base + d, o[a][c] * inv);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_grad(void* dst, bool out_f32, long long i, float x) {
  if (out_f32)
    reinterpret_cast<float*>(dst)[i] = x;
  else
    st<T>(reinterpret_cast<T*>(dst) + i, x);
}

// ---- backward: dq ------------------------------------------------------------------
// shared memory: Q (scaled), dO, K (then k * scale), V tiles (R x ld each), dS (R x (R + 1))
template <typename T, int RT, int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dq, FlashShape f,
                    int out_f32) {
  constexpr int R = 16 * RT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + R * f.ld;
  float* ks = dos + R * f.ld;
  float* vs = ks + R * f.ld;
  float* ps = vs + R * f.ld;
  int b, dz, it;
  block_coords(f, f.nq, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int d0 = dz * 16 * NC;
  int qo, ko;
  entry_offsets(f, b, qo, ko);

  load_tile<T>(qs, q, f, f.S, b, h, i0, R, f.scale);
  load_tile<T>(dos, dout, f, f.S, b, h, i0, R, 1.0f);
  float lse_r[RT], delta_r[RT], acc[RT][NC];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int row = i0 + ty + 16 * a;
    const long long r = ((long long)b * f.H + h) * f.S + row;
    lse_r[a] = row < f.S ? lse[r] : 0.0f;
    delta_r[a] = row < f.S ? delta[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.0f;
  }
  const int nkv = kv_tiles_needed(f, R, i0, qo, ko);
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * R;
    __syncthreads();
    load_tile<T>(ks, k, f, f.T, b, h, c0, R, 1.0f);
    load_tile<T>(vs, v, f, f.T, b, h, c0, R, 1.0f);
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int c = 0; c < RT; ++c) s[a][c] = dp[a][c] = 0.0f;
    for (int d = 0; d < f.D; ++d) {
      float qa[RT], oa[RT], kb[RT], vb[RT];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        qa[a] = qs[(ty + 16 * a) * f.ld + d];
        oa[a] = dos[(ty + 16 * a) * f.ld + d];
      }
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        kb[c] = ks[(tx + 16 * c) * f.ld + d];
        vb[c] = vs[(tx + 16 * c) * f.ld + d];
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          s[a][c] = fmaf(qa[a], kb[c], s[a][c]);
          dp[a][c] = fmaf(oa[a], vb[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const int row = i0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const bool keep = keep_score(f, row, c0 + tx + 16 * c, qo, ko);
        const float p = keep ? expf(s[a][c] - lse_r[a]) : 0.0f;
        ps[(ty + 16 * a) * (R + 1) + tx + 16 * c] = rnd<T>(p * (dp[a][c] - delta_r[a]));
      }
    }
    __syncthreads();  // dS written; every thread is done with the raw K
    for (int e = threadIdx.x; e < R * f.D; e += FA_THREADS) {
      const int r = e / f.D, d = e - r * f.D;
      ks[r * f.ld + d] = rnd<T>(ks[r * f.ld + d] * f.scale);
    }
    __syncthreads();
    for (int jr = 0; jr < R; ++jr) {
      float da[RT], kb[NC];
#pragma unroll
      for (int a = 0; a < RT; ++a) da[a] = ps[(ty + 16 * a) * (R + 1) + jr];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        kb[c] = d < f.D ? ks[jr * f.ld + d] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = fmaf(da[a], kb[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int row = i0 + ty + 16 * a;
    if (row >= f.S) continue;
    const long long base = (((long long)b * f.S + row) * f.H + h) * f.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < f.D) store_grad<T>(dq, out_f32 != 0, base + d, acc[a][c]);
    }
  }
}

// ---- backward: dk, dv ----------------------------------------------------------------
// One block per key tile; thread (ty, tx) holds key rows ty + 16a against query
// columns tx + 16c of the transposed score block. Shared memory: K, V (the
// block's own), Q (scaled), dO tiles (R x ld each), P-then-dS (R x (R + 1)),
// and the query tile's lse and delta (R each).
template <typename T, int RT, int NC>
__global__ void __launch_bounds__(FA_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, void* __restrict__ dk,
                     void* __restrict__ dv, FlashShape f, int out_f32) {
  constexpr int R = 16 * RT;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + R * f.ld;
  float* qs = vs + R * f.ld;
  float* dos = qs + R * f.ld;
  float* ps = dos + R * f.ld;
  float* lse_s = ps + R * (R + 1);
  float* delta_s = lse_s + R;
  int b, dz, jt;
  block_coords(f, f.nk, false, b, dz, jt);
  const int h = blockIdx.y, c0 = jt * R;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int d0 = dz * 16 * NC;
  int qo, ko;
  entry_offsets(f, b, qo, ko);

  load_tile<T>(ks, k, f, f.T, b, h, c0, R, 1.0f);
  load_tile<T>(vs, v, f, f.T, b, h, c0, R, 1.0f);
  float gk[RT][NC], gv[RT][NC];
#pragma unroll
  for (int a = 0; a < RT; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) gk[a][c] = gv[a][c] = 0.0f;
  for (int i = first_q_tile(f, R, c0, qo, ko); i < f.nq; ++i) {
    const int r0 = i * R;
    __syncthreads();
    load_tile<T>(qs, q, f, f.S, b, h, r0, R, f.scale);
    load_tile<T>(dos, dout, f, f.S, b, h, r0, R, 1.0f);
    for (int r = threadIdx.x; r < R; r += FA_THREADS) {
      const long long ri = ((long long)b * f.H + h) * f.S + r0 + r;
      lse_s[r] = r0 + r < f.S ? lse[ri] : 0.0f;
      delta_s[r] = r0 + r < f.S ? delta[ri] : 0.0f;
    }
    __syncthreads();
    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int c = 0; c < RT; ++c) s[a][c] = dp[a][c] = 0.0f;
    for (int d = 0; d < f.D; ++d) {
      float ka[RT], va[RT], qb[RT], ob[RT];
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        ka[a] = ks[(ty + 16 * a) * f.ld + d];
        va[a] = vs[(ty + 16 * a) * f.ld + d];
      }
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        qb[c] = qs[(tx + 16 * c) * f.ld + d];
        ob[c] = dos[(tx + 16 * c) * f.ld + d];
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < RT; ++c) {
          s[a][c] = fmaf(qb[c], ka[a], s[a][c]);
          dp[a][c] = fmaf(ob[c], va[a], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      const int col = c0 + ty + 16 * a;
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const int rl = tx + 16 * c;
        const bool keep = keep_score(f, r0 + rl, col, qo, ko);
        const float p = keep ? expf(s[a][c] - lse_s[rl]) : 0.0f;
        ps[(ty + 16 * a) * (R + 1) + rl] = rnd<T>(p);
        dp[a][c] = p * (dp[a][c] - delta_s[rl]);  // dS, kept until P.dO is done
      }
    }
    __syncthreads();
    for (int ir = 0; ir < R; ++ir) {
      float pa[RT], ob[NC];
#pragma unroll
      for (int a = 0; a < RT; ++a) pa[a] = ps[(ty + 16 * a) * (R + 1) + ir];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        ob[c] = d < f.D ? dos[ir * f.ld + d] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) gv[a][c] = fmaf(pa[a], ob[c], gv[a][c]);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int c = 0; c < RT; ++c) ps[(ty + 16 * a) * (R + 1) + tx + 16 * c] = rnd<T>(dp[a][c]);
    __syncthreads();
    for (int ir = 0; ir < R; ++ir) {
      float da[RT], qb[NC];
#pragma unroll
      for (int a = 0; a < RT; ++a) da[a] = ps[(ty + 16 * a) * (R + 1) + ir];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = d0 + tx + 16 * c;
        qb[c] = d < f.D ? qs[ir * f.ld + d] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) gk[a][c] = fmaf(da[a], qb[c], gk[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const int col = c0 + ty + 16 * a;
    if (col >= f.T) continue;
    const long long base = (((long long)b * f.T + col) * f.H + h) * f.D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = d0 + tx + 16 * c;
      if (d < f.D) {
        store_grad<T>(dk, out_f32 != 0, base + d, gk[a][c]);
        store_grad<T>(dv, out_f32 != 0, base + d, gv[a][c]);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------------------

// shared-memory floats of each kernel at R rows
static size_t fwd_smem(int R, int ld) { return sizeof(float) * (2 * (size_t)R * ld + (size_t)R * (R + 1)); }
static size_t dq_smem(int R, int ld) { return sizeof(float) * (4 * (size_t)R * ld + (size_t)R * (R + 1)); }
static size_t dkv_smem(int R, int ld) {
  return sizeof(float) * (4 * (size_t)R * ld + (size_t)R * (R + 1) + 2 * (size_t)R);
}

static int smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)e;
}

// The tile (RT, NC) of a launch: NC covers min(D, 256) output columns a
// block; RT is the largest of 4, 2, 1 whose tiles fit `optin` bytes.
// Instantiated: (4, 4), (4, 8), (4, 16), (2, 16), (1, 16).
static int pick_tile(int D, size_t (*smem)(int, int), int optin, int* rt, int* nc) {
  const int dc = D < 256 ? D : 256;
  *nc = dc <= 64 ? 4 : (dc <= 128 ? 8 : 16);
  const int ld = D | 1;
  for (int r = 4; r >= 1; r >>= 1) {
    if (r < 4 && *nc != 16) *nc = 16;
    if (smem(16 * r, ld) <= (size_t)optin) {
      *rt = r;
      return 0;
    }
  }
  return (int)cudaErrorInvalidValue;  // one row of 16 does not fit: D too large
}

static FlashShape make_shape(int B, int S, int T, int H, int D, int causal, int rt, int nc,
                             const int* qoff, const int* koff, int qo0, int ko0, float scale) {
  const int R = 16 * rt, dch = 16 * nc;
  return FlashShape{B, S, T, H, D, causal, D | 1, (S + R - 1) / R, (T + R - 1) / R,
                    (D + dch - 1) / dch, qoff, koff, qo0, ko0, scale};
}

template <typename K>
static int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static bool grid_ok(const FlashShape& f, int ntiles) {
  return (long long)f.B * f.nd * ntiles <= 0x7fffffffLL && f.H <= 65535;
}

template <typename T, int RT, int NC>
static int fwd_launch(const void* q, const void* k, const void* v, void* out, float* m,
                      float* l, const FlashShape& f, int state, cudaStream_t stream) {
  const size_t smem = fwd_smem(16 * RT, f.ld);
  int e = set_smem(flash_fwd_kernel<T, RT, NC>, smem);
  if (e) return e;
  if (!grid_ok(f, f.nq)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((long long)f.B * f.nd * f.nq), f.H);
  flash_fwd_kernel<T, RT, NC><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, out, m, l, f, state);
  return (int)cudaGetLastError();
}

template <typename T, int RT, int NC>
static int bwd_launch(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      const FlashShape& f, int out_f32, cudaStream_t stream) {
  const size_t s1 = dq_smem(16 * RT, f.ld), s2 = dkv_smem(16 * RT, f.ld);
  int e = set_smem(flash_bwd_dq_kernel<T, RT, NC>, s1);
  if (!e) e = set_smem(flash_bwd_dkv_kernel<T, RT, NC>, s2);
  if (e) return e;
  if (!grid_ok(f, f.nq) || !grid_ok(f, f.nk)) return (int)cudaErrorInvalidValue;
  const dim3 g1((unsigned)((long long)f.B * f.nd * f.nq), f.H);
  flash_bwd_dq_kernel<T, RT, NC><<<g1, FA_THREADS, s1, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dq, f, out_f32);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 g2((unsigned)((long long)f.B * f.nd * f.nk), f.H);
  flash_bwd_dkv_kernel<T, RT, NC><<<g2, FA_THREADS, s2, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk, dv, f, out_f32);
  return (int)cudaGetLastError();
}

#define FA_DISPATCH(RT, NC, CALL)                       \
  if (RT == 4 && NC == 4) return CALL(4, 4);            \
  if (RT == 4 && NC == 8) return CALL(4, 8);            \
  if (RT == 4 && NC == 16) return CALL(4, 16);          \
  if (RT == 2 && NC == 16) return CALL(2, 16);          \
  if (RT == 1 && NC == 16) return CALL(1, 16);          \
  return (int)cudaErrorInvalidValue;

static bool bad_shape(int B, int S, int T, int H, int D) {
  return B < 1 || S < 1 || T < 1 || H < 1 || D < 1;
}

// q (B, S, H, D), k/v (B, T, H, D) in f32 (bf16 == 0) or bf16; qoff/koff (B,)
// int32 or null (then qo0/ko0 for every entry). state == 0: out (B, S, H, D)
// in q's type, m/l unused; state == 1: out the raw f32 accumulator, m and l
// (B, H, S) f32.
extern "C" int ts_flash_fwd(const void* q, const void* k, const void* v, const int* qoff,
                            const int* koff, void* out, float* m, float* l, int B, int S, int T,
                            int H, int D, int causal, int bf16, int state, int qo0, int ko0,
                            float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  int optin = 0, rt = 0, nc = 0;
  int e = smem_optin(&optin);
  if (!e) e = pick_tile(D, fwd_smem, optin, &rt, &nc);
  if (e) return e;
  const FlashShape f = make_shape(B, S, T, H, D, causal, rt, nc, qoff, koff, qo0, ko0, scale);
  cudaStream_t s = (cudaStream_t)stream;
#define FA_FWD_F32(A, C) fwd_launch<float, A, C>(q, k, v, out, m, l, f, state, s)
#define FA_FWD_BF16(A, C) fwd_launch<__nv_bfloat16, A, C>(q, k, v, out, m, l, f, state, s)
  if (bf16) {
    FA_DISPATCH(rt, nc, FA_FWD_BF16)
  }
  FA_DISPATCH(rt, nc, FA_FWD_F32)
}

// The backward pair: dq (B, S, H, D) by flash_bwd_dq_kernel, dk and dv
// (B, T, H, D) by flash_bwd_dkv_kernel, in f32 (out_f32) or q's type; dout
// in q's type, lse and delta (B, H, S) f32.
extern "C" int ts_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* qoff,
                            const int* koff, void* dq, void* dk, void* dv, int B, int S, int T,
                            int H, int D, int causal, int bf16, int out_f32, int qo0, int ko0,
                            float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  int optin = 0, rt = 0, nc = 0;
  int e = smem_optin(&optin);
  if (!e) e = pick_tile(D, dkv_smem, optin, &rt, &nc);  // the larger of the pair's needs
  if (e) return e;
  const FlashShape f = make_shape(B, S, T, H, D, causal, rt, nc, qoff, koff, qo0, ko0, scale);
  cudaStream_t s = (cudaStream_t)stream;
#define FA_BWD_F32(A, C) \
  bwd_launch<float, A, C>(q, k, v, dout, lse, delta, dq, dk, dv, f, out_f32, s)
#define FA_BWD_BF16(A, C) \
  bwd_launch<__nv_bfloat16, A, C>(q, k, v, dout, lse, delta, dq, dk, dv, f, out_f32, s)
  if (bf16) {
    FA_DISPATCH(rt, nc, FA_BWD_BF16)
  }
  FA_DISPATCH(rt, nc, FA_BWD_F32)
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
