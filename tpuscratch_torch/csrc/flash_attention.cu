// Hand-written Hopper (sm_90a) kernels for flash attention, forward and backward.
//
// Replaces the Pallas TPU kernels of tpuscratch/ops/attention.py:
//   forward  <- _flash_kernel (:205), _flash_kernel_state (:247),
//               _flash_kernel_compact (:306); calls _flash_fwd_call (:865),
//               _flash_fwd_compact (:356)
//   dq       <- _dq_kernel (:431), _dq_kernel_compact (:539)
//   dk, dv   <- _dkv_kernel (:472), _dkv_kernel_compact (:603);
//               both called by _flash_bwd_call (:800), _flash_bwd_compact (:675)
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
// p and ds are rounded to bf16 before their products, every product sums in
// f32, and the forward rounds p against the running max of its key tile.
//
// Bound: operations. At the training shapes (S = T = 2048, D = 128) the
// kernels do 4 S T D flops a (b, h) forward and 10 S T D backward (half
// each when causal) against 4 (S + T) D elements moved: hundreds of flops a
// byte, above the card's ridge. The least time is the flops over 989
// TFLOP/s (bf16 on the tensor cores), 495 / 3 = 165 TFLOP/s (f32 as split
// TF32 on the tensor cores) or 67 TFLOP/s (f32 FMAs, the wide heads).
//
// bf16: the tensor-core kernels (flash_fwd_wgmma, flash_bwd_dq_wgmma,
// flash_bwd_dkv_wgmma; hopper.cuh has the building blocks). Their bound on
// this card is the bf16 rate above.
//   - A CTA owns one (entry, output column chunk, head, tile of nwg * 64
//     rows): nwg (2, or 1 where the tiles need the room) consumer
//     warpgroups of 64 rows each, and a producer warpgroup. Its first warp
//     loads; in the backward its other three ("helpers") prepare each
//     landed tile; setmaxnreg gives the consumers 224 registers a thread
//     and the producer warpgroup 56.
//   - The loading warp walks the other side's tiles of 64 rows into a ring
//     of up to 3 stages in shared memory, each stage behind a full, an
//     empty and (backward) a ready mbarrier; the CTA's own tile arrives once
//     behind its own. Tiles are 64-column blocks in the 128-byte swizzle
//     that TMA writes and the wgmma descriptors name. TMA takes rows whose
//     base and stride are 16-byte aligned; other rows (D = 20, say) are
//     staged by the loading warp's own loads into the same layout (the
//     template flag TMA). D is zero-padded to a multiple of 64 either way.
//   - The scores are wgmma.m64n64k16 (m64n32k16 in dk/dv, half a tile at a
//     time, so that dK and dV stay in registers) with both operands in
//     shared memory; the softmax (or p and ds) runs on the accumulator
//     fragment in registers, row max and sum by quad shuffles; p and ds
//     become the A operand of the next products (bf16, in registers, no
//     shared-memory round trip), against a B operand read MN-major (V,
//     k * scale, dO, q * scale). The forward's and dq's consumers round
//     their rows of q * scale to bf16 in place once; the helpers round each
//     stage's k * scale into a side tile (dq, whose scores need k raw) and
//     q * scale in place (dk/dv).
//   - p and ds are rounded to bf16 as the plain version rounds them even
//     where the tensor cores' sum order leaves them an ulp from a rounding
//     midpoint: such values are recomputed in the plain version's order
//     (FIX_C below).
//   - Only tiles that cross the causal diagonal or a ragged edge are masked;
//     tiles that a warpgroup's rows cannot see are skipped; the causal loops
//     stop at the diagonal, and the forward and dq hand out the longest
//     query tiles first.
//   - Output columns: the whole head up to 256 (forward) or 128 (backward,
//     which holds dK and dV; 64 where TMA cannot address the rows) a CTA;
//     wider heads split over CTAs by column chunk, each recomputing the
//     scores. The warpgroup count and the ring depth shrink until the tiles
//     fit the card's shared memory; a head too wide for one warpgroup and
//     one stage (D > 448) takes the FMA kernels.
//   - The backward stays two kernels, each forming S and dP: dq walks the
//     key tiles of its query tile, dk/dv the query tiles of its key tile. A
//     single kernel would have to sum dq across CTAs with atomics, whose
//     order changes from run to run; ZeRO's 1x1 step is held bit for bit to
//     the replicated one, and both run this backward, so it must give the
//     same bits on every call.
//
// f32 heads up to TF_MAX_D = 128 columns: the split-TF32 tensor-core
// kernels (flash_fwd_tf32, flash_bwd_dq_tf32, flash_bwd_dkv_tf32; their
// section below has the design): three TF32 products a product, so their
// bound on this card is 495 / 3 = 165 TFLOP/s of f32-accurate products
// (2.5x the 67 TFLOP/s of f32 FMAs). tests/test_torch_flash_split.py holds
// their arithmetic, accumulation included, to the f32 limit on the CPU.
//
// Wider heads (f32 D > 128, bf16 D > 448): the FMA kernels
// (flash_fwd_kernel, flash_bwd_dq_kernel, flash_bwd_dkv_kernel), the first
// design, bound by the f32 rate above. ts_flash_fwd and ts_flash_bwd choose
// by shape alone, before any launch; ts_flash_last_route reports the choice.
// One block of 256 threads (16 x 16) per (entry, head, tile of R = 16 * RT
// rows) loops over the other side's tiles in f32 shared memory (rows at an
// odd stride); each thread holds an RT x RT micro-tile of scores and an
// RT x NC one of the accumulators, and every product is an FMA on the CUDA
// cores. RT shrinks (4, 2, 1) until the tiles fit; a head wider than
// 16 * NC splits over blocks by column. They keep their own helpers
// (entry_offsets .. block_coords) apart from the tensor-core kernels' wg_*
// ones: compiled with shared ones, the f32 backward ran slower.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "hopper.cuh"

// ==== wide heads: FMA kernels on the CUDA cores ===========================================

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


// ==== bf16 on the tensor cores: wgmma, TMA, mbarriers ==================================

using bf16_t = __nv_bfloat16;

constexpr int WG_BN = 64;        // inner-loop tile: keys (forward, dq) or queries (dk/dv)
constexpr int WG_MAX_STAGES = 3;
constexpr int WG_THREADS = 384;  // two consumer warpgroups and a producer warpgroup, at most
constexpr int WG_HELPERS = 96;   // the producer warpgroup's threads past its loading warp
// Registers a thread after setmaxnreg: the producer warpgroup's and the
// consumers'. The CTA enters with 168 a thread (384 threads), and the split
// must fit that pool: 128 p + 256 c <= 64,512.
constexpr int REG_PROD = 56, REG_CONS = 224;

// A consumer warp's values to recompute (redo_warp), in shared memory.
constexpr int REDO_CAP = 64;  // entries a round
struct RedoList {
  uint16_t code[REDO_CAP];    // owner lane * 32 + index
  float r0[REDO_CAP], r1[REDO_CAP];
};

struct WgShape {
  int B, S, T, H, D;
  int DP;         // D rounded up to 64: the contracted width of S and dP
  int causal;
  int nq, nk;     // query and key tiles of this launch
  int nd;         // output column chunks of DC
  int nwg;        // consumer warpgroups, 64 rows each (1 or 2)
  int stages;     // tiles in the ring, 1..WG_MAX_STAGES
  const int* qoff;
  const int* koff;
  int qo0, ko0;
  float scale;    // 1/sqrt(D) rounded to bf16
};

// Shared-memory layout of each kernel, in bytes from a 1024-aligned base:
// every tile starts on a 1024-byte boundary (a multiple of 64 columns).
struct WgLayout {
  uint32_t a, b, ring0, ring1, extra, bars, total;
  uint32_t ring0_bytes, ring1_bytes;
};

// forward: a = Q (nwg*64 x DP); ring0 = K (BN x DP), ring1 = V (BN x DC)
__host__ __device__ inline WgLayout fwd_layout(int nwg, int st, int DP, int DC) {
  WgLayout L{};
  L.a = 0;
  L.b = L.a + nwg * 64 * DP * 2;
  L.ring0 = L.b;
  L.ring0_bytes = WG_BN * DP * 2;
  L.ring1 = L.ring0 + st * L.ring0_bytes;
  L.ring1_bytes = WG_BN * DC * 2;
  L.extra = L.ring1 + st * L.ring1_bytes;
  L.bars = L.extra;
  L.total = L.bars + 8 * (3 * WG_MAX_STAGES + 1) + 1024;
  return L;
}

// dq: a = Q, b = dO (nwg*64 x DP each); ring0 = K, ring1 = V (BN x DP);
// extra = each stage's K * scale of the output chunk (BN x DC), then each
// stage's K and V row norms (BN f32 each), the tile's lse and delta
// (nwg*64 f32 each) and a RedoList a consumer warp
__host__ __device__ inline WgLayout dq_layout(int nwg, int st, int DP, int DC) {
  WgLayout L{};
  L.a = 0;
  L.b = L.a + nwg * 64 * DP * 2;
  L.ring0 = L.b + nwg * 64 * DP * 2;
  L.ring0_bytes = WG_BN * DP * 2;
  L.ring1 = L.ring0 + st * L.ring0_bytes;
  L.ring1_bytes = L.ring0_bytes;
  L.extra = L.ring1 + st * L.ring1_bytes;
  L.bars = L.extra + st * (WG_BN * DC * 2 + 2 * WG_BN * 4) + 2 * nwg * 64 * 4 +
           4 * nwg * (uint32_t)sizeof(RedoList);
  L.total = L.bars + 8 * (3 * WG_MAX_STAGES + 1) + 1024;
  return L;
}

// dk/dv: a = K, b = V (nwg*64 x DP each); ring0 = Q, ring1 = dO (BN x DA,
// DA = DP rounded up to DC, so that every output chunk reads inside its
// tile); extra = lse, delta and the norms of the q * scale and dO rows of
// each stage's query tile (BN f32 each)
__host__ __device__ inline WgLayout dkv_layout(int nwg, int st, int DP, int DC) {
  WgLayout L{};
  const int DA = (DP + DC - 1) / DC * DC;
  L.a = 0;
  L.b = L.a + nwg * 64 * DP * 2;
  L.ring0 = L.b + nwg * 64 * DP * 2;
  L.ring0_bytes = WG_BN * DA * 2;
  L.ring1 = L.ring0 + st * L.ring0_bytes;
  L.ring1_bytes = L.ring0_bytes;
  L.extra = L.ring1 + st * L.ring1_bytes;
  L.bars = L.extra + st * 4 * WG_BN * 4;
  L.total = L.bars + 8 * (3 * WG_MAX_STAGES + 1) + 1024;
  return L;
}

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  const uint32_t a = hop::smem_u32(wg_smem);
  return wg_smem + (((a + 1023u) & ~1023u) - a);
}

__device__ __forceinline__ void wg_offsets(const WgShape& f, int b, int& qo, int& ko) {
  qo = f.qoff ? f.qoff[b] : f.qo0;
  ko = f.koff ? f.koff[b] : f.ko0;
}

// Block index -> (entry b, column chunk dz, tile t) over grid.x = B * nd * ntiles;
// `reverse` hands out the highest tiles first (the longest causal rows).
// (32-bit division: a 64-bit one is a subroutine call, around which
// registers spill.)
__device__ __forceinline__ void wg_coords(int ntiles, int nd, bool reverse, int& b, int& dz,
                                          int& t) {
  const unsigned bx = blockIdx.x, nt = (unsigned)ntiles, rest = bx / nt;
  t = (int)(bx - rest * nt);
  if (reverse) t = ntiles - 1 - t;
  dz = (int)(rest % (unsigned)nd);
  b = (int)(rest / (unsigned)nd);
}

// Key tiles of WG_BN a query tile [i0, i0 + rows) needs: all, or when causal
// those with a column at or left of its last row's diagonal.
__device__ __forceinline__ int wg_kv_tiles(const WgShape& f, int rows, int i0, int qo, int ko) {
  if (!f.causal) return f.nk;
  const long long lim = (long long)qo - ko + min(i0 + rows, f.S) - 1;
  if (lim < 0) return 0;
  const long long n = lim / WG_BN + 1;
  return n < f.nk ? (int)n : f.nk;
}

// First query tile of WG_BN rows that sees key column c0, when causal.
__device__ __forceinline__ int wg_first_q(const WgShape& f, int c0, int qo, int ko) {
  if (!f.causal) return 0;
  const long long first = (long long)ko + c0 - qo;
  if (first <= 0) return 0;
  const long long t = first / WG_BN;
  return t < f.nq ? (int)t : f.nq;
}

__device__ __forceinline__ bool wg_keep(const WgShape& f, int row, int col, int qo, int ko) {
  return row < f.S && col < f.T && (!f.causal || (long long)qo + row >= (long long)ko + col);
}

// One tile a producer brings in: rows x (64 * nblk) values of x[b, row0 + r,
// h, col0 + c] (zeros past n rows or D columns) into the swizzled layout.
struct TileReq {
  uint8_t* dst;
  const CUtensorMap* map;
  const bf16_t* src;
  int rows, nblk, row0, col0, n;
};

// The producer warp fills `bar`'s phase with `nt` tiles: by TMA (lane 0
// arms the barrier with the bytes and starts one box a 64-column block; TMA
// zero-fills out-of-bounds rows and columns), or, where TMA cannot address
// the rows (a row stride or base not 16-byte aligned), by the 32 lanes'
// own loads into the same swizzled layout. Every lane arrives once.
template <bool TMA, int NT>
__device__ __forceinline__ void produce(uint64_t* bar, const TileReq (&t)[NT], const WgShape& f,
                                        int b, int h, int lane) {
  if (TMA) {
    if (lane == 0) {
      uint32_t bytes = 0;
#pragma unroll
      for (int i = 0; i < NT; ++i) bytes += t[i].rows * t[i].nblk * 128;
      hop::bar_arrive_tx(bar, bytes);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        for (int k = 0; k < t[i].nblk; ++k)
          hop::tma_load_4d(t[i].dst + k * t[i].rows * 128, t[i].map, bar, t[i].col0 + 64 * k, h,
                           t[i].row0, b);
    } else {
      hop::bar_arrive(bar);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const TileReq& q = t[i];
      for (int r = 0; r < q.rows; ++r) {
        const int gr = q.row0 + r;
        const bf16_t* row = q.src + (((long long)b * q.n + gr) * f.H + h) * f.D;
        for (int c = lane; c < 64 * q.nblk; c += 32) {
          const int gc = q.col0 + c;
          const bf16_t val = (gr < q.n && gc < f.D) ? row[gc] : __float2bfloat16(0.0f);
          *reinterpret_cast<bf16_t*>(q.dst + hop::swz(q.rows, r, c)) = val;
        }
      }
    }
    hop::fence_async_smem();
    hop::bar_arrive(bar);
  }
}

// dst[i] = bf16(src[i] * scale) over n 16-byte chunks (8 values each), the
// chunks shared out over nth threads; dst == src scales in place. The
// swizzle permutes whole chunks, so this is layout-blind.
__device__ __forceinline__ void scale_chunks(uint8_t* dst, const uint8_t* src, int n, float scale,
                                             int tid, int nth) {
  for (int i = tid; i < n; i += nth) {
    uint4 v = reinterpret_cast<const uint4*>(src)[i];
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = hop::pack_bf16(x.x * scale, x.y * scale);
    }
    reinterpret_cast<uint4*>(dst)[i] = v;
  }
}

// Where the tensor cores and the plain version may round differently.
// The kernels sum a dot product of bf16 values in the tensor cores' order;
// the plain version (cuBLAS at the main path's shapes) sums it in f32 FMAs
// over d = 0, 1, ..., D - 1. The two differ by an ulp or so, and where p or
// ds lies that close to a bf16 rounding midpoint they round it to
// neighbouring values: one such flip of a large p or ds moves an output by
// 2^-8 of a term, over the limits that hold the kernels to the plain
// version. So a p or ds within the possible disagreement of a midpoint is
// recomputed from shared memory in the plain version's order (dot2_seq),
// and every bf16 p and ds comes out as the plain version rounds it. The
// disagreement of a dot product a.b is taken as at most FIX_C 2^-24 |a| |b|
// (the rounding errors of either order are a random walk of about
// 2^-25 |a| |b|); in f32 ulps of p that is FIX_C |a| |b|, and ds = p (dp -
// delta) adds that of dp over |dp - delta|. A few values in a thousand are
// recomputed.
constexpr float FIX_C = 4.0f;

// The distance of x from the nearest bf16 rounding midpoint, in f32 ulps.
__device__ __forceinline__ float mid_dist(float x) {
  return (float)abs((int)(__float_as_uint(x) & 0xFFFFu) - 0x8000);
}

// acc + x . y over 8 bf16 pairs, in f32 FMAs in order
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = __bfloat1622float2(xv[j]), w = __bfloat1622float2(yv[j]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

// Two dot products in f32 FMAs over d = 0 .. DP - 1 in order (the zero
// padding past D adds nothing): s = a[r, :] . b[c, :] and t = a2[r, :] .
// b2[c, :], a and a2 swizzled bf16 tiles of arows rows, b and b2 of brows.
__device__ __forceinline__ void dot2_seq(const uint8_t* a, const uint8_t* a2, int arows, int r,
                                         const uint8_t* b, const uint8_t* b2, int brows, int c,
                                         int DP, float& s, float& t) {
  s = t = 0.0f;
  for (int ch = 0; ch < DP / 8; ++ch) {
    const int blk = ch >> 3, cc = ch & 7;
    const int oa = blk * arows * 128 + r * 128 + ((cc ^ (r & 7)) << 4);
    const int ob = blk * brows * 128 + c * 128 + ((cc ^ (c & 7)) << 4);
    s = dot8(*reinterpret_cast<const uint4*>(a + oa), *reinterpret_cast<const uint4*>(b + ob), s);
    t = dot8(*reinterpret_cast<const uint4*>(a2 + oa), *reinterpret_cast<const uint4*>(b2 + ob), t);
  }
}

// A warp's values to recompute, shared out over its 32 lanes: each lane
// lists its flagged accumulator indices (bit i of `redo`), lane j
// recomputes entries j, j + 32, ... with fix(owner lane, index, p, ds), and
// each owner takes its results back into s[i] and d[i]. One lane's several
// values would otherwise cost the whole warp a sequential chain each.
template <int NV, typename Fix>
__device__ __forceinline__ void redo_warp(uint32_t redo, float (&s)[NV], float (&d)[NV],
                                          RedoList* list, int lane, Fix fix) {
  const int cnt = __popc(redo);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31), base = incl - cnt;
  for (int start = 0; start < total; start += REDO_CAP) {
    const int n = min(REDO_CAP, total - start);
    uint32_t m = redo;
    for (int k = 0; m; ++k, m &= m - 1) {
      const int e = base + k - start;
      if (e >= 0 && e < n) list->code[e] = (uint16_t)(lane * 32 + __ffs(m) - 1);
    }
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const int c = list->code[e];
      fix(c >> 5, c & 31, list->r0[e], list->r1[e]);
    }
    __syncwarp();
    m = redo;
    for (int k = 0; m; ++k, m &= m - 1) {
      const int e = base + k - start;
      if (e >= 0 && e < n) {
        const int i = __ffs(m) - 1;
        const float p = list->r0[e], ds = list->r1[e];
#pragma unroll
        for (int k2 = 0; k2 < NV; ++k2)
          if (k2 == i) {
            s[k2] = p;
            d[k2] = ds;
          }
      }
    }
    __syncwarp();
  }
}

// |row r| of a swizzled bf16 tile of `rows` rows over its first DP columns;
// with scale != 1 the row is first rounded to bf16(x * scale) in place, and
// the norm is the scaled row's.
__device__ __forceinline__ float row_norm(uint8_t* t, int rows, int r, int DP, float scale) {
  float ss = 0.0f;
  for (int c = 0; c < DP / 8; ++c) {
    const int blk = c >> 3, cc = c & 7;
    uint4* q = reinterpret_cast<uint4*>(t + blk * rows * 128 + r * 128 + ((cc ^ (r & 7)) << 4));
    uint4 x = *q;
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 u = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      if (scale != 1.0f) {
        w[j] = hop::pack_bf16(u.x * scale, u.y * scale);
        u = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      }
      ss = fmaf(u.x, u.x, fmaf(u.y, u.y, ss));
    }
    if (scale != 1.0f) *q = x;
  }
  // a threshold's scale: rsqrt's approximation is ample, and IEEE sqrt's
  // slow path is a subroutine call
  return ss > 0.0f ? ss * rsqrtf(ss) : 0.0f;
}

// O (64 x DC) += A B with A in registers and B MN-major in shared memory
template <int DC>
__device__ __forceinline__ void wgmma_rs(float (&d)[DC / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DC == 64)
    hop::wgmma_rs_n64(d, a, db);
  else if constexpr (DC == 128)
    hop::wgmma_rs_n128(d, a, db);
  else
    hop::wgmma_rs_n256(d, a, db);
}

// S (64 x N) = A B^T over DP columns: A the warpgroup's 64 rows of an
// (arows x DP) tile at `a`, B N rows of a (BN x DP) tile from `b` on, both
// K-major.
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint32_t a, int arows, uint32_t b,
                                             int DP) {
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int blk = kk >> 2;                 // 64-column block
    const uint32_t k32 = (kk & 3) * 32;      // 32 bytes a k16 step inside it
    const uint64_t da = hop::desc(a + blk * arows * 128 + k32, 16, 1024);
    const uint64_t db = hop::desc(b + blk * WG_BN * 128 + k32, 16, 1024);
    if constexpr (N == 64)
      hop::wgmma_ss_n64(s, da, db, kk > 0);
    else
      hop::wgmma_ss_n32(s, da, db, kk > 0);
  }
}

// The MN-major descriptor of k16 step kk of a (BN x ...) tile's output chunk
// starting at 64-column block blk: 16 rows (2048 B) a step.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int blk, int kk) {
  return hop::desc(tile + blk * WG_BN * 128 + kk * 2048, WG_BN * 128, 1024);
}

// Accumulator value i of a thread: row offset (0 or 8) and column in its 64 x N tile.
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i, int t4) { return 8 * (i >> 2) + 2 * t4 + (i & 1); }

// ---- forward ---------------------------------------------------------------------------
// One CTA per (entry, column chunk, head, query tile of nwg * 64 rows).
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv, const bf16_t* __restrict__ q,
                const bf16_t* __restrict__ k, const bf16_t* __restrict__ v, void* __restrict__ out,
                float* __restrict__ m_out, float* __restrict__ l_out, WgShape f, int state) {
  uint8_t* sm = smem_base();
  const WgLayout L = fwd_layout(f.nwg, f.stages, f.DP, DC);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + WG_MAX_STAGES;
  uint64_t* qbar = empty + WG_MAX_STAGES;
  const int BM = 64 * f.nwg;
  int b, dz, it;
  wg_coords(f.nq, f.nd, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * BM, d0 = dz * DC;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int nkv = wg_kv_tiles(f, BM, i0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 4 * f.nwg);
    }
    hop::bar_init(qbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * f.nwg) {  // producer warpgroup: one warp starts the loads
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp != 4 * f.nwg) return;
    const int vblk = min(DC, f.DP - d0) / 64;
    const TileReq tq[1] = {{sm + L.a, &mq, q, BM, f.DP / 64, i0, 0, f.S}};
    produce<TMA>(qbar, tq, f, b, h, lane);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nkv; ++j) {
      hop::bar_wait(empty + stage, phase ^ 1);
      const TileReq t[2] = {
          {sm + L.ring0 + stage * L.ring0_bytes, &mk, k, WG_BN, f.DP / 64, j * WG_BN, 0, f.T},
          {sm + L.ring1 + stage * L.ring1_bytes, &mv, v, WG_BN, vblk, j * WG_BN, d0, f.T}};
      produce<TMA>(full + stage, t, f, b, h, lane);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile
  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 64 * wg + 16 * (wl / 32) + lane / 4;  // tile row of values with frag_row 0
  const int rmin = i0 + 64 * wg;
  const uint32_t qa = hop::smem_u32(sm + L.a) + 64 * wg * 128;
  hop::bar_wait(qbar, 0);
  // q * scale rounded to bf16, in place, once: this warpgroup's rows
  for (int blk = 0; blk < f.DP / 64; ++blk) {
    uint8_t* p = sm + L.a + blk * BM * 128 + 64 * wg * 128;
    scale_chunks(p, p, 512, f.scale, wl, 128);
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);

  float o[DC / 2], s[WG_BN / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) s[i] = 0.0f;
  float mrow[2] = {FA_NEG_INF, FA_NEG_INF}, lrow[2] = {0.0f, 0.0f};
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * WG_BN;
    hop::bar_wait(full + stage, phase);
    const bool skip = rmin >= f.S || (f.causal && (long long)qo + rmin + 63 < (long long)ko + c0);
    if (!skip) {
      hop::wgmma_fence();
      wgmma_scores<WG_BN>(s, qa, BM, hop::smem_u32(sm + L.ring0 + stage * L.ring0_bytes), f.DP);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(s);
      // mask only tiles that cross the diagonal or a ragged edge
      if (rmin + 64 > f.S || c0 + WG_BN > f.T ||
          (f.causal && (long long)qo + rmin < (long long)ko + c0 + WG_BN - 1)) {
#pragma unroll
        for (int i = 0; i < WG_BN / 2; ++i)
          if (!wg_keep(f, i0 + rlo + frag_row(i), c0 + frag_col(i, t4), qo, ko))
            s[i] = FA_NEG_INF;
      }
      float mx[2] = {FA_NEG_INF, FA_NEG_INF}, sum[2] = {0.0f, 0.0f}, corr[2];
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four threads of a quad hold a row's 64 values
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(mrow[r], mx[r]);
      }
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        // the guard: a masked score's p is 0 even when the whole row is masked
        s[i] = s[i] > 0.5f * FA_NEG_INF ? expf(s[i] - mx[r]) : 0.0f;
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        corr[r] = expf(mrow[r] - mx[r]);
        lrow[r] = lrow[r] * corr[r] + sum[r];
        mrow[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < DC / 2; ++i) o[i] *= corr[(i >> 1) & 1];
      // O += P V: p rounded to bf16 in registers as the A operand, V MN-major
      const uint32_t va = hop::smem_u32(sm + L.ring1 + stage * L.ring1_bytes);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BN / 16; ++kk) {
        uint32_t a[4];
        hop::a_frag(s, kk, a);
        wgmma_rs<DC>(o, a, desc_mn(va, 0, kk));
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + rlo + 8 * r;
    if (row >= f.S) continue;
    const long long base = (((long long)b * f.S + row) * f.H + h) * f.D;
    const float inv = __fdividef(1.0f, lrow[r] > 0.0f ? lrow[r] : 1.0f);
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      if (((i >> 1) & 1) != r) continue;
      const int col = d0 + frag_col(i, t4);
      if (col >= f.D) continue;
      if (state)
        reinterpret_cast<float*>(out)[base + col] = o[i];
      else
        reinterpret_cast<bf16_t*>(out)[base + col] = __float2bfloat16_rn(o[i] * inv);
    }
    if (state && dz == 0 && t4 == 0) {
      const long long ri = ((long long)b * f.H + h) * f.S + row;
      m_out[ri] = mrow[r];
      l_out[ri] = lrow[r];
    }
  }
}


// ---- backward: dq ----------------------------------------------------------------------
// One CTA per (entry, column chunk, head, query tile of nwg * 64 rows),
// walking the key tiles: S = (q * scale) K^T and dP = dO V^T on wgmma,
// p = exp(S - lse), dS = p (dP - delta) rounded to bf16 in registers,
// dQ += dS (k * scale). The producer warpgroup's other three warps round
// k * scale to bf16 into a side tile of each stage and take the K and V row
// norms (for the rounding check) while the consumers work on earlier tiles.
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                   const bf16_t* __restrict__ q, const bf16_t* __restrict__ k,
                   const bf16_t* __restrict__ v, const bf16_t* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   void* __restrict__ dq, WgShape f, int out_f32) {
  uint8_t* sm = smem_base();
  const WgLayout L = dq_layout(f.nwg, f.stages, f.DP, DC);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + WG_MAX_STAGES;
  uint64_t* ready = empty + WG_MAX_STAGES;
  uint64_t* qbar = ready + WG_MAX_STAGES;
  const uint32_t ks_bytes = WG_BN * DC * 2;
  float* norms = reinterpret_cast<float*>(sm + L.extra + f.stages * ks_bytes);  // [stage][K, V][BN]
  const int BM = 64 * f.nwg;
  int b, dz, it;
  wg_coords(f.nq, f.nd, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * BM, d0 = dz * DC;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int nkv = wg_kv_tiles(f, BM, i0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 4 * f.nwg);
      hop::bar_init(ready + s, WG_HELPERS);
    }
    hop::bar_init(qbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * f.nwg) {
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp == 4 * f.nwg) {  // loads
      const TileReq tq[2] = {{sm + L.a, &mq, q, BM, f.DP / 64, i0, 0, f.S},
                       {sm + L.b, &mdo, dout, BM, f.DP / 64, i0, 0, f.S}};
      produce<TMA>(qbar, tq, f, b, h, lane);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < nkv; ++j) {
        hop::bar_wait(empty + stage, phase ^ 1);
        const TileReq t[2] = {
            {sm + L.ring0 + stage * L.ring0_bytes, &mk, k, WG_BN, f.DP / 64, j * WG_BN, 0, f.T},
            {sm + L.ring1 + stage * L.ring1_bytes, &mv, v, WG_BN, f.DP / 64, j * WG_BN, 0, f.T}};
        produce<TMA>(full + stage, t, f, b, h, lane);
        if (++stage == f.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // helpers: k * scale of the output chunk, and the K and V row norms
    const int ht = threadIdx.x - 128 * f.nwg - 32;
    const int kblk = min(DC, f.DP - d0) / 64;  // 64-column blocks of k * scale in use
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nkv; ++j) {
      uint8_t* kt = sm + L.ring0 + stage * L.ring0_bytes;
      uint8_t* vt = sm + L.ring1 + stage * L.ring1_bytes;
      hop::bar_wait(full + stage, phase);
      scale_chunks(sm + L.extra + stage * ks_bytes, kt + (d0 / 64) * WG_BN * 128,
                   kblk * WG_BN * 8, f.scale, ht, WG_HELPERS);
      for (int task = ht; task < 2 * WG_BN; task += WG_HELPERS)
        norms[stage * 2 * WG_BN + task] =
            row_norm(task < WG_BN ? kt : vt, WG_BN, task % WG_BN, f.DP, 1.0f);
      hop::fence_async_smem();
      hop::bar_arrive(ready + stage);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 64 * wg + 16 * (wl / 32) + lane / 4;
  const int rmin = i0 + 64 * wg;
  const uint32_t qa = hop::smem_u32(sm + L.a) + 64 * wg * 128;
  const uint32_t oa = hop::smem_u32(sm + L.b) + 64 * wg * 128;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + rlo + 8 * r;
    const long long ri = ((long long)b * f.H + h) * f.S + row;
    lse_r[r] = row < f.S ? lse[ri] : 0.0f;
    delta_r[r] = row < f.S ? delta[ri] : 0.0f;
  }
  // the rows' lse and delta, and this warp's RedoList, in shared memory
  float* rowstat = norms + f.stages * 2 * WG_BN;
  RedoList* redo_list = reinterpret_cast<RedoList*>(rowstat + 2 * BM) + warp;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rowstat[rlo + 8 * r] = lse_r[r];
    rowstat[BM + rlo + 8 * r] = delta_r[r];
  }
  hop::bar_wait(qbar, 0);
  for (int blk = 0; blk < f.DP / 64; ++blk) {
    uint8_t* p = sm + L.a + blk * BM * 128 + 64 * wg * 128;
    scale_chunks(p, p, 512, f.scale, wl, 128);
  }
  hop::fence_async_smem();
  hop::named_sync(1 + wg, 128);
  float nq[2], no[2];  // the norms of this thread's q * scale and dO rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    nq[r] = row_norm(sm + L.a, BM, rlo + 8 * r, f.DP, 1.0f);
    no[r] = row_norm(sm + L.b, BM, rlo + 8 * r, f.DP, 1.0f);
  }

  float acc[DC / 2], s[WG_BN / 2], dp[WG_BN / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < WG_BN / 2; ++i) s[i] = dp[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * WG_BN;
    const uint8_t* kt = sm + L.ring0 + stage * L.ring0_bytes;
    const uint8_t* vt = sm + L.ring1 + stage * L.ring1_bytes;
    const float* kn = norms + stage * 2 * WG_BN;  // K's, then V's
    hop::bar_wait(full + stage, phase);
    hop::bar_wait(ready + stage, phase);
    const bool skip = rmin >= f.S || (f.causal && (long long)qo + rmin + 63 < (long long)ko + c0);
    if (!skip) {
      hop::wgmma_fence();
      wgmma_scores<WG_BN>(s, qa, BM, hop::smem_u32(kt), f.DP);
      wgmma_scores<WG_BN>(dp, oa, BM, hop::smem_u32(vt), f.DP);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(s);
      hop::fence_regs(dp);
      const bool need = rmin + 64 > f.S || c0 + WG_BN > f.T ||
                        (f.causal && (long long)qo + rmin < (long long)ko + c0 + WG_BN - 1);
      uint32_t redo = 0;
#pragma unroll
      for (int i = 0; i < WG_BN / 2; ++i) {
        const int r = (i >> 1) & 1, jc = frag_col(i, t4);
        const bool keep = !need || wg_keep(f, i0 + rlo + 8 * r, c0 + jc, qo, ko);
        const float p = keep ? expf(s[i] - lse_r[r]) : 0.0f;
        const float g = dp[i] - delta_r[r];
        dp[i] = p * g;  // dS, rounded to bf16 as the A operand
        // |dS - midpoint| <= FIX_C (|q||k| + |dO||v| / |g|) ulps, times |g|
        if (keep && mid_dist(dp[i]) * fabsf(g) <=
                        FIX_C * (nq[r] * kn[jc] * fabsf(g) + no[r] * kn[WG_BN + jc]))
          redo |= 1u << i;
      }
      // dS in the plain version's order where it may round otherwise (s takes p)
      redo_warp(redo, s, dp, redo_list, lane, [&](int owner, int i, float& p, float& ds) {
        const int row = rlo - lane / 4 + owner / 4 + 8 * ((i >> 1) & 1);
        const int jc = 8 * (i >> 2) + 2 * (owner % 4) + (i & 1);
        float sq, pq;
        dot2_seq(sm + L.a, sm + L.b, BM, row, kt, vt, WG_BN, jc, f.DP, sq, pq);
        p = expf(sq - rowstat[row]);
        ds = p * (pq - rowstat[BM + row]);
      });
      const uint32_t ksa = hop::smem_u32(sm + L.extra + stage * ks_bytes);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BN / 16; ++kk) {
        uint32_t a[4];
        hop::a_frag(dp, kk, a);
        wgmma_rs<DC>(acc, a, desc_mn(ksa, 0, kk));
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + rlo + 8 * r;
    if (row >= f.S) continue;
    const long long base = (((long long)b * f.S + row) * f.H + h) * f.D;
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      const int col = d0 + frag_col(i, t4);
      if (((i >> 1) & 1) == r && col < f.D) store_grad<bf16_t>(dq, out_f32 != 0, base + col, acc[i]);
    }
  }
}

// ---- backward: dk, dv ------------------------------------------------------------------
// One CTA per (entry, column chunk, head, key tile of nwg * 64 keys),
// walking the query tiles from the first that sees the tile:
// S^T = K (q * scale)^T and dP^T = V dO^T on wgmma, then dV += P^T dO and
// dK += dS^T (q * scale) with P^T and dS^T rounded to bf16 in registers.
// The producer warpgroup's other three warps round each landed query tile
// to q * scale in place and stage its lse, delta and row norms.
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mdo, const bf16_t* __restrict__ q,
                    const bf16_t* __restrict__ k, const bf16_t* __restrict__ v,
                    const bf16_t* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, void* __restrict__ dk,
                    void* __restrict__ dv, WgShape f, int out_f32) {
  uint8_t* sm = smem_base();
  const WgLayout L = dkv_layout(f.nwg, f.stages, f.DP, DC);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + WG_MAX_STAGES;
  uint64_t* ready = empty + WG_MAX_STAGES;
  uint64_t* kvbar = ready + WG_MAX_STAGES;
  // [stage][lse, delta, |q * scale| row, |dO| row][BN]
  float* side = reinterpret_cast<float*>(sm + L.extra);
  const int BK = 64 * f.nwg;
  int b, dz, jt;
  wg_coords(f.nk, f.nd, false, b, dz, jt);
  const int h = blockIdx.y, c0 = jt * BK, d0 = dz * DC;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int iq0 = wg_first_q(f, c0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 4 * f.nwg);
      hop::bar_init(ready + s, WG_HELPERS);
    }
    hop::bar_init(kvbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * f.nwg) {
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp == 4 * f.nwg) {  // loads
      const TileReq tk[2] = {{sm + L.a, &mk, k, BK, f.DP / 64, c0, 0, f.T},
                       {sm + L.b, &mv, v, BK, f.DP / 64, c0, 0, f.T}};
      produce<TMA>(kvbar, tk, f, b, h, lane);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = iq0; i < f.nq; ++i) {
        hop::bar_wait(empty + stage, phase ^ 1);
        const TileReq t[2] = {
            {sm + L.ring0 + stage * L.ring0_bytes, &mq, q, WG_BN, f.DP / 64, i * WG_BN, 0, f.S},
            {sm + L.ring1 + stage * L.ring1_bytes, &mdo, dout, WG_BN, f.DP / 64, i * WG_BN, 0,
             f.S}};
        produce<TMA>(full + stage, t, f, b, h, lane);
        if (++stage == f.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // helpers: q * scale in place, the q * scale and dO row norms, lse and delta
    const int ht = threadIdx.x - 128 * f.nwg - 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = iq0; i < f.nq; ++i) {
      const int r0 = i * WG_BN;
      uint8_t* qt = sm + L.ring0 + stage * L.ring0_bytes;
      uint8_t* ot = sm + L.ring1 + stage * L.ring1_bytes;
      float* sd = side + stage * 4 * WG_BN;
      hop::bar_wait(full + stage, phase);
      for (int task = ht; task < 2 * WG_BN; task += WG_HELPERS)
        sd[2 * WG_BN + task] = row_norm(task < WG_BN ? qt : ot, WG_BN, task % WG_BN, f.DP,
                                        task < WG_BN ? f.scale : 1.0f);
      for (int r = ht; r < WG_BN; r += WG_HELPERS) {
        const long long ri = ((long long)b * f.H + h) * f.S + r0 + r;
        sd[r] = r0 + r < f.S ? lse[ri] : 0.0f;
        sd[WG_BN + r] = r0 + r < f.S ? delta[ri] : 0.0f;
      }
      hop::fence_async_smem();
      hop::bar_arrive(ready + stage);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 64 * wg + 16 * (wl / 32) + lane / 4;  // key row within the tile
  const int kmin = c0 + 64 * wg;
  const uint32_t ka = hop::smem_u32(sm + L.a) + 64 * wg * 128;
  const uint32_t va = hop::smem_u32(sm + L.b) + 64 * wg * 128;
  hop::bar_wait(kvbar, 0);
  float nk[2], nv[2];  // the norms of this thread's K and V rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    nk[r] = row_norm(sm + L.a, BK, rlo + 8 * r, f.DP, 1.0f);
    nv[r] = row_norm(sm + L.b, BK, rlo + 8 * r, f.DP, 1.0f);
  }

  // S^T and dP^T a half tile (32 queries) at a time: with dK and dV held
  // across the loop, a whole tile's would not fit the registers
  constexpr int HQ = WG_BN / 2;
  float gk[DC / 2], gv[DC / 2], s[HQ / 2], dp[HQ / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) gk[i] = gv[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < HQ / 2; ++i) s[i] = dp[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = iq0; it < f.nq; ++it) {
    const int r0 = it * WG_BN;
    const uint8_t* qt = sm + L.ring0 + stage * L.ring0_bytes;
    const uint8_t* ot = sm + L.ring1 + stage * L.ring1_bytes;
    const uint32_t qta = hop::smem_u32(qt);
    const uint32_t ota = hop::smem_u32(ot);
    const float* sd = side + stage * 4 * WG_BN;
    hop::bar_wait(full + stage, phase);
    hop::bar_wait(ready + stage, phase);
#pragma unroll 1
    for (int q0 = 0; q0 < WG_BN; q0 += HQ) {
      const int qmin = r0 + q0;  // the half's first query
      if (kmin >= f.T || qmin >= f.S ||
          (f.causal && (long long)qo + qmin + HQ - 1 < (long long)ko + kmin))
        continue;
      hop::wgmma_fence();
      wgmma_scores<HQ>(s, ka, BK, qta + q0 * 128, f.DP);
      wgmma_scores<HQ>(dp, va, BK, ota + q0 * 128, f.DP);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(s);
      hop::fence_regs(dp);
      const bool need = kmin + 64 > f.T || qmin + HQ > f.S ||
                        (f.causal && (long long)qo + qmin < (long long)ko + kmin + 63);
      uint32_t redo = 0;
#pragma unroll
      for (int i = 0; i < HQ / 2; ++i) {
        const int qc = q0 + frag_col(i, t4), r = (i >> 1) & 1;
        const bool keep = !need || wg_keep(f, r0 + qc, c0 + rlo + 8 * r, qo, ko);
        const float p = keep ? expf(s[i] - sd[qc]) : 0.0f;
        const float g = dp[i] - sd[WG_BN + qc];
        s[i] = p;
        dp[i] = p * g;
        const float e = FIX_C * sd[2 * WG_BN + qc] * nk[r];
        if (keep && (mid_dist(p) <= e ||
                     mid_dist(dp[i]) * fabsf(g) <= e * fabsf(g) + FIX_C * sd[3 * WG_BN + qc] * nv[r]))
          redo |= 1u << i;
      }
      // p and dS in the plain version's order where they may round otherwise
      // (each lane its own: the warp-wide share-out of redo_warp leaves dK,
      // dV and the half tile too few registers here)
      while (redo) {
        const int i = __ffs(redo) - 1;
        redo &= redo - 1;
        const int r = (i >> 1) & 1, qc = q0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        float sq, pq;
        dot2_seq(sm + L.a, sm + L.b, BK, rlo + 8 * r, qt, ot, WG_BN, qc, f.DP, sq, pq);
        const float p = expf(sq - sd[qc]), ds = p * (pq - sd[WG_BN + qc]);
#pragma unroll
        for (int k2 = 0; k2 < HQ / 2; ++k2)
          if (k2 == i) {
            s[k2] = p;
            dp[k2] = ds;
          }
      }
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        hop::a_frag(s, kk, ap);
        hop::a_frag(dp, kk, ad);
        wgmma_rs<DC>(gv, ap, desc_mn(ota, d0 / 64, q0 / 16 + kk));
        wgmma_rs<DC>(gk, ad, desc_mn(qta, d0 / 64, q0 / 16 + kk));
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(gv);
      hop::fence_regs(gk);
    }
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = c0 + rlo + 8 * r;  // the key
    if (col >= f.T) continue;
    const long long base = (((long long)b * f.T + col) * f.H + h) * f.D;
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      const int d = d0 + frag_col(i, t4);
      if (((i >> 1) & 1) == r && d < f.D) {
        store_grad<bf16_t>(dk, out_f32 != 0, base + d, gk[i]);
        store_grad<bf16_t>(dv, out_f32 != 0, base + d, gv[i]);
      }
    }
  }
}

// ==== f32 on the tensor cores: split TF32 ===============================================
//
// Every f32 product runs as three TF32 wgmma passes with f32 accumulation:
// x = hi + lo, hi = tf32(x) (cvt.rna: to nearest, ties away from zero),
// lo = tf32(x - hi), and a b ~ hi_a lo_b + lo_a hi_b + hi_a hi_b, added into
// the accumulator in that order a k8 step (the lo lo term and lo's own
// rounding are below 2^-21 of the product). TF32 wgmma reads its B operand
// K-major from shared memory only, and its A operand from shared memory or
// from registers (4 values a thread a k8 step), so:
//   - the score products take the other side's tiles as TMA lands them (K
//     and V rows, or q and dO rows: K-major for S = (q * scale) K^T, dP =
//     dO V^T, S^T = K (q * scale)^T, dP^T = V dO^T), split into hi (in
//     place) and lo (a side tile) by the producer warpgroup's three helper
//     warps; the CTA's own tile is the A operand, gathered from shared
//     memory into registers and split there;
//   - a product whose B would be MN-major is computed transposed, so that
//     the operand that would need a transposed tile is the A side, gathered:
//     dq: dQ^T = K^T dS^T (B = dS, [queries x keys], written hi and lo by
//     the consumers from their accumulator fragments); dk/dv: dV^T = dO^T P
//     and dK^T = (q * scale)^T dS (B = P^T and dS^T, [keys x queries], the
//     layout of the S^T accumulator itself). dq takes k unscaled and
//     multiplies dQ by scale once at the end (a 2^-24 difference a term from
//     the plain version's k * scale, below the split's own 2^-22);
//   - the forward computes O = P V: P, its score accumulator, is the A
//     operand in registers with the keys of each k8 step permuted (position
//     p holds key 2p, position p + 4 key 2p + 1: the accumulator's pairs),
//     and the helpers write V^T hi and lo tiles in that key order.
// The tensor cores add each k8 step into the accumulator with truncation:
// over the 2048-4096 keys (or queries) of the training shapes that bias
// alone would cost up to 9e-5 of an output (tests/test_torch_flash_split.py
// models it), so every key (or query) tile of TF_BN sums into a fresh
// accumulator, which is added into an f32 register total with
// round-to-nearest adds (promotion a tile). The scores' 128-term sums over
// D are not promoted.
//
// Roles (as in the bf16 kernels: a producer warpgroup whose first warp loads
// and whose other three warps prepare each landed tile, setmaxnreg 56 / 224):
//   - forward: 1-2 consumer warpgroups of 64 query rows, each computing S,
//     the online softmax and O for its rows.
//   - dq: one tile of 64 queries, two consumer warpgroups: the first forms S
//     and p, the second dP and dS = p (dP - delta) (p handed over in shared
//     memory); each then computes half of dQ^T: one 64-column half of the
//     head (D over 64) or, at D 64 or less, half of the tile's queries.
//   - dk/dv: one tile of 64 keys: the first consumer warpgroup forms S^T and
//     P^T, then dV^T; the second dP^T and dS^T (p read back as hi + lo, to
//     2^-22), then dK^T. Two kernels and no atomics: every call gives the
//     same bits.
// Shared memory (fwd_tf_layout, dq_tf_layout, dkv_tf_layout) at D 128 and
// TF_BN = 32: forward Q 64 KB (two warpgroups) + 2 stages of K, K lo, V,
// V^T hi, V^T lo (80 KB each) = 224 KB; dq Q and dO 64 KB + 2 stages of K,
// K lo, V, V lo (64 KB) + dS hi, lo and p (24 KB) = 216 KB; dk/dv K and V
// 64 KB + 2 stages of q * scale, its lo, dO, dO lo (64 KB) + P^T and dS^T
// hi and lo (32 KB) = 224 KB, of the card's 227 KB.
// Heads up to TF_MAX_D = 128 columns take these kernels: each output column
// chunk of 64 keeps a total and a tile accumulator in registers and the
// contracted width is whole in shared memory, so a wider head overflows
// both at two stages; wider f32 heads take the FMA kernels above.

constexpr int TF_BN = 32;         // inner tile: keys (forward, dq) or queries (dk/dv)
constexpr int TF_MAX_STAGES = 3;
constexpr int TF_MAX_D = 128;

__host__ __device__ inline uint32_t tf_tile(int rows, int DC) { return (uint32_t)rows * DC * 4; }

// Shared-memory layout in bytes from a 1024-aligned base: the CTA's own
// tiles at 0, the ring of stages from `ring`, per-kernel extras from `side`.
struct TfLayout {
  uint32_t ring, stage, side, bars, total;
};

// forward: Q (nwg * 64 x DC); a stage = K (hi in place), K lo, V, V^T hi,
// V^T lo (TF_BN x DC each)
__host__ __device__ inline TfLayout fwd_tf_layout(int nwg, int st, int DC) {
  TfLayout L{};
  L.ring = tf_tile(64 * nwg, DC);
  L.stage = 5 * tf_tile(TF_BN, DC);
  L.side = L.ring + st * L.stage;
  L.bars = L.side;
  L.total = L.bars + 8 * (3 * TF_MAX_STAGES + 1) + 1024;
  return L;
}

// dq: Q (scaled in place), dO (64 x DC each); a stage = K (hi in place), K
// lo, V (hi in place), V lo; side = dS hi, dS lo (64 x TF_BN each), p (64 x
// TF_BN f32 in fragment order)
__host__ __device__ inline TfLayout dq_tf_layout(int st, int DC) {
  TfLayout L{};
  L.ring = 2 * tf_tile(64, DC);
  L.stage = 4 * tf_tile(TF_BN, DC);
  L.side = L.ring + st * L.stage;
  L.bars = L.side + 3 * tf_tile(64, TF_BN);
  L.total = L.bars + 8 * (3 * TF_MAX_STAGES + 1) + 1024;
  return L;
}

// dk/dv: K, V (64 x DC each); a stage = q * scale (hi in place), its lo, dO
// (hi in place), dO lo; side = P^T hi, lo, dS^T hi, lo (64 x TF_BN each),
// then each stage's lse and delta (TF_BN f32 each)
__host__ __device__ inline TfLayout dkv_tf_layout(int st, int DC) {
  TfLayout L{};
  L.ring = 2 * tf_tile(64, DC);
  L.stage = 4 * tf_tile(TF_BN, DC);
  L.side = L.ring + st * L.stage;
  L.bars = L.side + 4 * tf_tile(64, TF_BN) + st * 2 * TF_BN * 4;
  L.total = L.bars + 8 * (3 * TF_MAX_STAGES + 1) + 1024;
  return L;
}

// Key tiles of TF_BN a query tile [i0, i0 + rows) needs (all, or when
// causal those at or left of its last row's diagonal), and the first query
// tile of TF_BN that sees key column c0.
__device__ __forceinline__ int tf_kv_tiles(const WgShape& f, int rows, int i0, int qo, int ko) {
  if (!f.causal) return f.nk;
  const long long lim = (long long)qo - ko + min(i0 + rows, f.S) - 1;
  if (lim < 0) return 0;
  const long long n = lim / TF_BN + 1;
  return n < f.nk ? (int)n : f.nk;
}

__device__ __forceinline__ int tf_first_q(const WgShape& f, int c0, int qo, int ko) {
  if (!f.causal) return 0;
  const long long first = (long long)ko + c0 - qo;
  if (first <= 0) return 0;
  const long long t = first / TF_BN;
  return t < f.nq ? (int)t : f.nq;
}

// One f32 tile a producer brings in: rows x DC values of x[b, row0 + r, h, c]
// (zeros past n rows or D columns) into the swizzled f32 layout.
struct TfReq {
  uint8_t* dst;
  const CUtensorMap* map;
  const float* src;
  int rows, row0, n;
};

// As produce() for f32 tiles of nblk 32-column blocks: by TMA, or where TMA
// cannot address the rows by the 32 lanes' own loads. Every lane arrives once.
template <bool TMA, int NT>
__device__ __forceinline__ void produce_tf(uint64_t* bar, const TfReq (&t)[NT], int nblk,
                                           const WgShape& f, int b, int h, int lane) {
  if (TMA) {
    if (lane == 0) {
      uint32_t bytes = 0;
#pragma unroll
      for (int i = 0; i < NT; ++i) bytes += t[i].rows * nblk * 128;
      hop::bar_arrive_tx(bar, bytes);
#pragma unroll
      for (int i = 0; i < NT; ++i)
        for (int k = 0; k < nblk; ++k)
          hop::tma_load_4d(t[i].dst + k * t[i].rows * 128, t[i].map, bar, 32 * k, h, t[i].row0, b);
    } else {
      hop::bar_arrive(bar);
    }
  } else {
    for (int i = 0; i < NT; ++i) {
      const TfReq& q = t[i];
      for (int e = lane; e < q.rows * 32 * nblk; e += 32) {
        const int r = e / (32 * nblk), c = e - r * 32 * nblk, gr = q.row0 + r;
        *reinterpret_cast<float*>(q.dst + hop::swz32(q.rows, r, c)) =
            (gr < q.n && c < f.D) ? q.src[(((long long)b * q.n + gr) * f.H + h) * f.D + c] : 0.0f;
      }
    }
    hop::fence_async_smem();
    hop::bar_arrive(bar);
  }
}

// n 16-byte chunks of f32 values, shared out over nth threads: each value
// (times mul first, an f32 product, when mul != 1) is replaced by its TF32
// hi, and its lo goes to the same place in `lo`. The swizzle permutes whole
// chunks, so this is layout-blind.
__device__ __forceinline__ void split_chunks(uint8_t* t, uint8_t* lo, int n, float mul, int tid,
                                             int nth) {
  for (int i = tid; i < n; i += nth) {
    float4 x = reinterpret_cast<const float4*>(t)[i];
    if (mul != 1.0f) {
      x.x = __fmul_rn(x.x, mul);
      x.y = __fmul_rn(x.y, mul);
      x.z = __fmul_rn(x.z, mul);
      x.w = __fmul_rn(x.w, mul);
    }
    uint4 h, l;
    hop::split_tf32(x.x, h.x, l.x);
    hop::split_tf32(x.y, h.y, l.y);
    hop::split_tf32(x.z, h.z, l.z);
    hop::split_tf32(x.w, h.w, l.w);
    reinterpret_cast<uint4*>(t)[i] = h;
    reinterpret_cast<uint4*>(lo)[i] = l;
  }
}

__device__ __forceinline__ float lds32(const uint8_t* t, int rows, int r, int c) {
  return *reinterpret_cast<const float*>(t + hop::swz32(rows, r, c));
}

// The A fragment of one k8 step (rows r, r + 8 and columns c, c + 4 of the
// thread's quad position) from a tile of `rows` rows: A[m][k] = t[m][k]
// (rows) or t[k][m] (cols, the transposed gather).
__device__ __forceinline__ void frag_rows(const uint8_t* t, int rows, int r, int c, float (&x)[4]) {
  x[0] = lds32(t, rows, r, c);
  x[1] = lds32(t, rows, r + 8, c);
  x[2] = lds32(t, rows, r, c + 4);
  x[3] = lds32(t, rows, r + 8, c + 4);
}
__device__ __forceinline__ void frag_cols(const uint8_t* t, int rows, int r, int c, uint32_t (&x)[4]) {
  x[0] = __float_as_uint(lds32(t, rows, c, r));
  x[1] = __float_as_uint(lds32(t, rows, c, r + 8));
  x[2] = __float_as_uint(lds32(t, rows, c + 4, r));
  x[3] = __float_as_uint(lds32(t, rows, c + 4, r + 8));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) hop::split_tf32(x[i], hi[i], lo[i]);
}

// A K-major TF32 descriptor of k8 step kk of a tile of `rows` rows.
__device__ __forceinline__ uint64_t desc_tf(uint32_t tile, int rows, int kk) {
  return hop::desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, 1024);
}

// S (64 x 32) = A B^T over DC columns in split TF32: A gathered from rows
// (r, r + 8) of an (arows x DC) tile and split, B the hi and lo tiles of
// TF_BN rows. A wgmma's register operands stay live until it completes, so
// each 32-column block is a group of its own, finished before the next
// block's gathers: 32 A registers live, not 128 (with one group the
// forward spilled and the backward ran slower; a second group in flight
// gained nothing). Returns with every wgmma done.
template <int DC>
__device__ __forceinline__ void tf_scores(float (&s)[16], const uint8_t* a, int arows, int r,
                                          int t4, uint32_t bh, uint32_t bl) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.0f;  // no stale value kept live across the tile
#pragma unroll
  for (int blk = 0; blk < DC / 32; ++blk) {
    hop::wgmma_fence();
#pragma unroll
    for (int k4 = 0; k4 < 4; ++k4) {
      const int kk = 4 * blk + k4;
      float x[4];
      uint32_t ah[4], al[4];
      frag_rows(a, arows, r, 8 * kk + t4, x);
      split4(x, ah, al);
      hop::wgmma_tf32_n32(s, ah, desc_tf(bl, TF_BN, kk), 1);
      hop::wgmma_tf32_n32(s, al, desc_tf(bh, TF_BN, kk), 1);
      hop::wgmma_tf32_n32(s, ah, desc_tf(bh, TF_BN, kk), 1);
    }
    hop::wgmma_commit();
    hop::wgmma_wait_all();
  }
  hop::fence_regs(s);
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  if constexpr (N == 32)
    hop::wgmma_tf32_n32(d, a, db, acc);
  else
    hop::wgmma_tf32_n64(d, a, db, acc);
}

// D (64 x N) = A B^T over TF_BN in split TF32, the transposed products:
// A[m][k] = t[k][m0 + m] gathered from the hi and lo tiles of an operand
// ([TF_BN rows x DC], already split), B the hi and lo tiles (N x TF_BN, N
// 32 or 64). Returns with every wgmma done.
template <int N>
__device__ __forceinline__ void tf_outer(float (&d)[N / 2], const uint8_t* th, const uint8_t* tl,
                                         int r, int t4, uint32_t bh, uint32_t bl) {
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TF_BN / 8; ++kk) {
    uint32_t ah[4], al[4];
    frag_cols(th, TF_BN, r, 8 * kk + t4, ah);
    frag_cols(tl, TF_BN, r, 8 * kk + t4, al);
    wgmma_tf32<N>(d, ah, desc_tf(bl, 64, kk), kk > 0);
    wgmma_tf32<N>(d, al, desc_tf(bh, 64, kk), 1);
    wgmma_tf32<N>(d, ah, desc_tf(bh, 64, kk), 1);
  }
  hop::wgmma_commit();
  hop::wgmma_wait_all();
  hop::fence_regs(d);
}

// Values (i, i + 1) of an m64n32 accumulator, split, into the hi and lo
// tiles (64 x TF_BN) at its rows and columns.
__device__ __forceinline__ void store_split(uint8_t* th, uint8_t* tl, int row, int col, float x0,
                                            float x1) {
  uint2 h, l;
  hop::split_tf32(x0, h.x, l.x);
  hop::split_tf32(x1, h.y, l.y);
  const uint32_t o = hop::swz32(64, row, col);
  *reinterpret_cast<uint2*>(th + o) = h;
  *reinterpret_cast<uint2*>(tl + o) = l;
}

// ---- forward (TF32) ----------------------------------------------------------------------
// One CTA per (entry, head, query tile of nwg * 64 rows), walking the key tiles.
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_tf32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
               const __grid_constant__ CUtensorMap mv, const float* __restrict__ q,
               const float* __restrict__ k, const float* __restrict__ v, void* __restrict__ out,
               float* __restrict__ m_out, float* __restrict__ l_out, WgShape f, int state) {
  uint8_t* sm = smem_base();
  const TfLayout L = fwd_tf_layout(f.nwg, f.stages, DC);
  const uint32_t TILE = tf_tile(TF_BN, DC);  // K, K lo, V, V^T hi, V^T lo of a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + TF_MAX_STAGES;
  uint64_t* ready = empty + TF_MAX_STAGES;
  uint64_t* qbar = ready + TF_MAX_STAGES;
  const int BM = 64 * f.nwg;
  int b, dz, it;
  wg_coords(f.nq, 1, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * BM;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int nkv = tf_kv_tiles(f, BM, i0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 4 * f.nwg);
      hop::bar_init(ready + s, WG_HELPERS);
    }
    hop::bar_init(qbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * f.nwg) {
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp == 4 * f.nwg) {  // loads
      const TfReq tq[1] = {{sm, &mq, q, BM, i0, f.S}};
      produce_tf<TMA>(qbar, tq, DC / 32, f, b, h, lane);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < nkv; ++j) {
        hop::bar_wait(empty + stage, phase ^ 1);
        uint8_t* st = sm + L.ring + stage * L.stage;
        const TfReq t[2] = {{st, &mk, k, TF_BN, j * TF_BN, f.T},
                            {st + 2 * TILE, &mv, v, TF_BN, j * TF_BN, f.T}};
        produce_tf<TMA>(full + stage, t, DC / 32, f, b, h, lane);
        if (++stage == f.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // helpers: K split in place (hi) and beside (lo); V into V^T hi and lo,
    // one key a lane, its keys permuted as the A fragments of P hold them
    const int ht = threadIdx.x - 128 * f.nwg - 32, hw = ht / 32;
    const int pos = (lane & ~7) | ((lane & 7) >> 1) | ((lane & 1) << 2);
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nkv; ++j) {
      uint8_t* st = sm + L.ring + stage * L.stage;
      hop::bar_wait(full + stage, phase);
      split_chunks(st, st + TILE, TILE / 16, 1.0f, ht, WG_HELPERS);
      for (int dc = hw; dc < DC / 4; dc += WG_HELPERS / 32) {
        const float4 x = *reinterpret_cast<const float4*>(st + 2 * TILE + hop::swz32(TF_BN, lane, 4 * dc));
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t hi, lo;
          hop::split_tf32(xs[c], hi, lo);
          const uint32_t o = hop::swz32(DC, 4 * dc + c, pos);
          *reinterpret_cast<uint32_t*>(st + 3 * TILE + o) = hi;
          *reinterpret_cast<uint32_t*>(st + 4 * TILE + o) = lo;
        }
      }
      hop::fence_async_smem();
      hop::bar_arrive(ready + stage);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumer warpgroup wg: query rows [64 wg, 64 wg + 64) of the tile
  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 64 * wg + 16 * (wl / 32) + lane / 4;  // tile row of values with frag_row 0
  const int rmin = i0 + 64 * wg;
  hop::bar_wait(qbar, 0);
  // q * scale in f32, in place: this warpgroup's rows
  for (int blk = 0; blk < DC / 32; ++blk) {
    float4* p = reinterpret_cast<float4*>(sm + blk * BM * 128 + 64 * wg * 128);
    for (int i = wl; i < 512; i += 128) {
      float4 x = p[i];
      x.x = __fmul_rn(x.x, f.scale);
      x.y = __fmul_rn(x.y, f.scale);
      x.z = __fmul_rn(x.z, f.scale);
      x.w = __fmul_rn(x.w, f.scale);
      p[i] = x;
    }
  }
  hop::named_sync(1 + wg, 128);

  float o[DC / 2], ot[32], s[16];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) ot[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.0f;
  float mrow[2] = {FA_NEG_INF, FA_NEG_INF}, lrow[2] = {0.0f, 0.0f};
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * TF_BN;
    hop::bar_wait(full + stage, phase);
    hop::bar_wait(ready + stage, phase);
    const bool skip = rmin >= f.S || (f.causal && (long long)qo + rmin + 63 < (long long)ko + c0);
    if (!skip) {
      const uint32_t kt = hop::smem_u32(sm + L.ring + stage * L.stage);
      tf_scores<DC>(s, sm, BM, rlo, t4, kt, kt + TILE);
      if (rmin + 64 > f.S || c0 + TF_BN > f.T ||
          (f.causal && (long long)qo + rmin < (long long)ko + c0 + TF_BN - 1)) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (!wg_keep(f, i0 + rlo + frag_row(i), c0 + frag_col(i, t4), qo, ko)) s[i] = FA_NEG_INF;
      }
      float mx[2] = {FA_NEG_INF, FA_NEG_INF}, sum[2] = {0.0f, 0.0f}, corr[2];
#pragma unroll
      for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(mrow[r], mx[r]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = s[i] > 0.5f * FA_NEG_INF ? expf(s[i] - mx[r]) : 0.0f;
        sum[r] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        corr[r] = expf(mrow[r] - mx[r]);
        lrow[r] = lrow[r] * corr[r] + sum[r];
        mrow[r] = mx[r];
      }
      // this key tile's P V into a fresh accumulator, a 64-column half of O
      // at a time: P the A operand in registers (positions t4, t4 + 4 of a
      // k8 step hold keys 2 t4, 2 t4 + 1), V^T's rows 64 hf .. 64 hf + 63
#pragma unroll
      for (int hf = 0; hf < DC / 64; ++hf) {
        const uint32_t vh = kt + 3 * TILE + hf * 64 * 128, vl = vh + TILE;
#pragma unroll
        for (int i = 0; i < 32; ++i) ot[i] = 0.0f;
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < TF_BN / 8; ++kk) {
          const float x[4] = {s[4 * kk], s[4 * kk + 2], s[4 * kk + 1], s[4 * kk + 3]};
          uint32_t ah[4], al[4];
          split4(x, ah, al);
          hop::wgmma_tf32_n64(ot, ah, desc_tf(vl, 64, kk), 1);
          hop::wgmma_tf32_n64(ot, al, desc_tf(vh, 64, kk), 1);
          hop::wgmma_tf32_n64(ot, ah, desc_tf(vh, 64, kk), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait_all();
        hop::fence_regs(ot);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[32 * hf + i] = fmaf(o[32 * hf + i], corr[(i >> 1) & 1], ot[i]);
      }
    }
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + rlo + 8 * r;
    if (row >= f.S) continue;
    const long long base = (((long long)b * f.S + row) * f.H + h) * f.D;
    const float inv = 1.0f / (lrow[r] > 0.0f ? lrow[r] : 1.0f);
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) {
      if (((i >> 1) & 1) != r) continue;
      const int col = frag_col(i, t4);
      if (col >= f.D) continue;
      reinterpret_cast<float*>(out)[base + col] = state ? o[i] : o[i] * inv;
    }
    if (state && t4 == 0) {
      const long long ri = ((long long)b * f.H + h) * f.S + row;
      m_out[ri] = mrow[r];
      l_out[ri] = lrow[r];
    }
  }
}

// ---- backward: dq (TF32) -----------------------------------------------------------------
// One CTA per (entry, head, query tile of 64), walking the key tiles:
// warpgroup 0 forms S = (q * scale) K^T and p = exp(S - lse), warpgroup 1
// dP = dO V^T and dS = p (dP - delta) into hi and lo tiles; then each
// warpgroup adds its block of dQ^T += K^T dS^T: at DC 128 the head columns
// [64 w, 64 w + 64) for all 64 queries, at DC 64 the 64 head columns for
// the queries [32 w, 32 w + 32). The helpers split each landed K and V tile.
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dq_tf32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dq, WgShape f) {
  uint8_t* sm = smem_base();
  const TfLayout L = dq_tf_layout(f.stages, DC);
  const uint32_t TILE = tf_tile(TF_BN, DC), OWN = tf_tile(64, DC), SIDE = tf_tile(64, TF_BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + TF_MAX_STAGES;
  uint64_t* ready = empty + TF_MAX_STAGES;
  uint64_t* qbar = ready + TF_MAX_STAGES;
  int b, dz, it;
  wg_coords(f.nq, 1, f.causal != 0, b, dz, it);
  const int h = blockIdx.y, i0 = it * 64;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int nkv = tf_kv_tiles(f, 64, i0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 8);
      hop::bar_init(ready + s, WG_HELPERS);
    }
    hop::bar_init(qbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp == 8) {  // loads
      const TfReq tq[2] = {{sm, &mq, q, 64, i0, f.S}, {sm + OWN, &mdo, dout, 64, i0, f.S}};
      produce_tf<TMA>(qbar, tq, DC / 32, f, b, h, lane);
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < nkv; ++j) {
        hop::bar_wait(empty + stage, phase ^ 1);
        uint8_t* st = sm + L.ring + stage * L.stage;
        const TfReq t[2] = {{st, &mk, k, TF_BN, j * TF_BN, f.T},
                            {st + 2 * TILE, &mv, v, TF_BN, j * TF_BN, f.T}};
        produce_tf<TMA>(full + stage, t, DC / 32, f, b, h, lane);
        if (++stage == f.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // helpers: K and V split, hi in place and lo beside
    const int ht = threadIdx.x - 256 - 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < nkv; ++j) {
      uint8_t* st = sm + L.ring + stage * L.stage;
      hop::bar_wait(full + stage, phase);
      split_chunks(st, st + TILE, TILE / 16, 1.0f, ht, WG_HELPERS);
      split_chunks(st + 2 * TILE, st + 3 * TILE, TILE / 16, 1.0f, ht, WG_HELPERS);
      hop::fence_async_smem();
      hop::bar_arrive(ready + stage);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 16 * (wl / 32) + lane / 4;  // tile row (query) of values with frag_row 0
  uint8_t* dsh = sm + L.side;
  uint8_t* dsl = dsh + SIDE;
  float* pbuf = reinterpret_cast<float*>(dsl + SIDE);  // [value][thread]
  float stat[2];  // lse (warpgroup 0) or delta (warpgroup 1) of the thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = i0 + rlo + 8 * r;
    const long long ri = ((long long)b * f.H + h) * f.S + row;
    stat[r] = row < f.S ? (wg == 0 ? lse[ri] : delta[ri]) : 0.0f;
  }
  hop::bar_wait(qbar, 0);
  {  // q * scale in f32, in place, by both warpgroups
    float4* p = reinterpret_cast<float4*>(sm);
    for (int i = threadIdx.x; i < (int)(OWN / 16); i += 256) {
      float4 x = p[i];
      x.x = __fmul_rn(x.x, f.scale);
      x.y = __fmul_rn(x.y, f.scale);
      x.z = __fmul_rn(x.z, f.scale);
      x.w = __fmul_rn(x.w, f.scale);
      p[i] = x;
    }
    hop::named_sync(1, 256);
  }
  // this warpgroup's block of dQ^T: head columns from 64 mb, queries from
  // 32 qb, QN of them
  constexpr int QN = DC == 128 ? 64 : 32;
  const int mb = DC == 128 ? wg : 0, qb = DC == 128 ? 0 : wg;
  float tot[QN / 2], acc[QN / 2], s[16];
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) tot[i] = acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < nkv; ++j) {
    const int c0 = j * TF_BN;
    const uint8_t* st = sm + L.ring + stage * L.stage;
    const uint32_t sta = hop::smem_u32(st);
    hop::bar_wait(full + stage, phase);
    hop::bar_wait(ready + stage, phase);
    // S = (q scale) K^T (warpgroup 0) or dP = dO V^T (1)
    tf_scores<DC>(s, sm + wg * OWN, 64, rlo, t4, sta + 2 * wg * TILE, sta + (2 * wg + 1) * TILE);
    // Warpgroup 0's values are p, warpgroup 1's dS; each computes both and
    // stores its own (no register of a wgmma is touched on a divergent path,
    // which would serialize the wgmmas)
    const bool need = i0 + 64 > f.S || c0 + TF_BN > f.T ||
                      (f.causal && (long long)qo + i0 < (long long)ko + c0 + TF_BN - 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i >> 1) & 1;
      const bool keep = !need || wg_keep(f, i0 + rlo + 8 * r, c0 + frag_col(i, t4), qo, ko);
      const float p = keep ? expf(s[i] - stat[r]) : 0.0f;
      if (wg == 0) pbuf[i * 128 + wl] = p;
    }
    hop::named_sync(3, 256);  // p handed over
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int r = (i >> 1) & 1;
      const float d0 = pbuf[i * 128 + wl] * (s[i] - stat[r]);
      const float d1 = pbuf[(i + 1) * 128 + wl] * (s[i + 1] - stat[r]);
      if (wg == 1) store_split(dsh, dsl, rlo + 8 * r, frag_col(i, t4), d0, d1);
    }
    hop::fence_async_smem();
    hop::named_sync(4, 256);  // dS written
    // rows 32 qb on of the dS tiles: whole 8-row swizzle atoms
    tf_outer<QN>(acc, st, st + TILE, 64 * mb + rlo, t4, hop::smem_u32(dsh) + qb * 32 * 128,
                 hop::smem_u32(dsl) + qb * 32 * 128);
#pragma unroll
    for (int i = 0; i < QN / 2; ++i) tot[i] += acc[i];
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // dQ^T: value i is column (query) 32 qb + frag_col(i) and row (head
  // column) 64 mb + rlo + frag_row(i)
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) {
    const int row = i0 + 32 * qb + frag_col(i, t4), d = 64 * mb + rlo + frag_row(i);
    if (row < f.S && d < f.D)
      dq[(((long long)b * f.S + row) * f.H + h) * f.D + d] = __fmul_rn(tot[i], f.scale);
  }
}

// ---- backward: dk, dv (TF32) ---------------------------------------------------------------
// One CTA per (entry, head, key tile of 64), walking the query tiles from
// the first that sees the tile: warpgroup 0 forms S^T = K (q * scale)^T,
// P^T into hi and lo tiles and dV^T += dO^T P^T; warpgroup 1 dP^T = V dO^T,
// dS^T = p (dP^T - delta) into hi and lo tiles and dK^T += (q * scale)^T
// dS^T. The helpers scale each landed query tile (f32) and split it and the
// dO tile, and stage the tile's lse and delta.
template <bool TMA, int DC>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_bwd_dkv_tf32(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dk, float* __restrict__ dv, WgShape f) {
  uint8_t* sm = smem_base();
  const TfLayout L = dkv_tf_layout(f.stages, DC);
  const uint32_t TILE = tf_tile(TF_BN, DC), OWN = tf_tile(64, DC), SIDE = tf_tile(64, TF_BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + L.bars);
  uint64_t* empty = full + TF_MAX_STAGES;
  uint64_t* ready = empty + TF_MAX_STAGES;
  uint64_t* kvbar = ready + TF_MAX_STAGES;
  uint8_t* pth = sm + L.side;  // P^T hi, lo, dS^T hi, lo
  float* stats = reinterpret_cast<float*>(pth + 4 * SIDE);  // [stage][lse, delta][TF_BN]
  int b, dz, jt;
  wg_coords(f.nk, 1, false, b, dz, jt);
  const int h = blockIdx.y, c0 = jt * 64;
  int qo, ko;
  wg_offsets(f, b, qo, ko);
  const int iq0 = tf_first_q(f, c0, qo, ko);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_MAX_STAGES; ++s) {
      hop::bar_init(full + s, 32);
      hop::bar_init(empty + s, 8);
      hop::bar_init(ready + s, WG_HELPERS);
    }
    hop::bar_init(kvbar, 32);
    hop::bar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {
    hop::setmaxnreg_dec<REG_PROD>();
    if (warp == 8) {  // loads
      const TfReq tk[2] = {{sm, &mk, k, 64, c0, f.T}, {sm + OWN, &mv, v, 64, c0, f.T}};
      produce_tf<TMA>(kvbar, tk, DC / 32, f, b, h, lane);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = iq0; i < f.nq; ++i) {
        hop::bar_wait(empty + stage, phase ^ 1);
        uint8_t* st = sm + L.ring + stage * L.stage;
        const TfReq t[2] = {{st, &mq, q, TF_BN, i * TF_BN, f.S},
                            {st + 2 * TILE, &mdo, dout, TF_BN, i * TF_BN, f.S}};
        produce_tf<TMA>(full + stage, t, DC / 32, f, b, h, lane);
        if (++stage == f.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      return;
    }
    // helpers: q * scale (f32) and dO split, hi in place and lo beside; lse, delta
    const int ht = threadIdx.x - 256 - 32;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = iq0; i < f.nq; ++i) {
      const int r0 = i * TF_BN;
      uint8_t* st = sm + L.ring + stage * L.stage;
      float* sd = stats + stage * 2 * TF_BN;
      hop::bar_wait(full + stage, phase);
      split_chunks(st, st + TILE, TILE / 16, f.scale, ht, WG_HELPERS);
      split_chunks(st + 2 * TILE, st + 3 * TILE, TILE / 16, 1.0f, ht, WG_HELPERS);
      for (int r = ht; r < TF_BN; r += WG_HELPERS) {
        const long long ri = ((long long)b * f.H + h) * f.S + r0 + r;
        sd[r] = r0 + r < f.S ? lse[ri] : 0.0f;
        sd[TF_BN + r] = r0 + r < f.S ? delta[ri] : 0.0f;
      }
      hop::fence_async_smem();
      hop::bar_arrive(ready + stage);
      if (++stage == f.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  hop::setmaxnreg_inc<REG_CONS>();
  const int wg = warp / 4, wl = threadIdx.x % 128, t4 = lane % 4;
  const int rlo = 16 * (wl / 32) + lane / 4;  // key row of values with frag_row 0
  uint8_t* ph = pth;
  uint8_t* pl = pth + SIDE;
  uint8_t* dh = pth + 2 * SIDE;
  uint8_t* dl = pth + 3 * SIDE;
  hop::bar_wait(kvbar, 0);
  const int nmb = DC / 64;  // 64-column blocks of dK^T / dV^T
  float tot[DC / 2], acc[32], s[16];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) tot[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = iq0; it < f.nq; ++it) {
    const int r0 = it * TF_BN;
    const uint8_t* st = sm + L.ring + stage * L.stage;
    const uint32_t sta = hop::smem_u32(st);
    const float* sd = stats + stage * 2 * TF_BN;
    hop::bar_wait(full + stage, phase);
    hop::bar_wait(ready + stage, phase);
    const bool skip = f.causal && (long long)qo + r0 + TF_BN - 1 < (long long)ko + c0;
    if (!skip) {
      // S^T = K (q scale)^T (warpgroup 0) or dP^T = V dO^T (1)
      tf_scores<DC>(s, sm + wg * OWN, 64, rlo, t4, sta + 2 * wg * TILE,
                    sta + (2 * wg + 1) * TILE);
      // Warpgroup 0's values are P^T, warpgroup 1's dS^T; each computes
      // both and stores its own (no register of a wgmma is touched on a
      // divergent path, which would serialize the wgmmas)
      const bool need = c0 + 64 > f.T || r0 + TF_BN > f.S ||
                        (f.causal && (long long)qo + r0 < (long long)ko + c0 + 63);
      float p[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qc = frag_col(i, t4), r = (i >> 1) & 1;
        const bool keep = !need || wg_keep(f, r0 + qc, c0 + rlo + 8 * r, qo, ko);
        p[i] = keep ? expf(s[i] - sd[qc]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2)
        if (wg == 0) store_split(ph, pl, rlo + frag_row(i), frag_col(i, t4), p[i], p[i + 1]);
      hop::fence_async_smem();
      hop::named_sync(3, 256);  // P^T written
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int row = rlo + frag_row(i), col = frag_col(i, t4);
        p[i] = lds32(ph, 64, row, col) + lds32(pl, 64, row, col);
      }
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int qc = frag_col(i, t4);
        const float d0 = p[i] * (s[i] - sd[TF_BN + qc]);
        const float d1 = p[i + 1] * (s[i + 1] - sd[TF_BN + qc + 1]);
        if (wg == 1) store_split(dh, dl, rlo + frag_row(i), qc, d0, d1);
      }
      hop::fence_async_smem();
      hop::named_sync(2, 256);  // dS^T written, P^T read (warpgroup 0 may overwrite it next tile)
      // warpgroup 0: dV^T += dO^T P^T; warpgroup 1: dK^T += (q scale)^T dS^T,
      // a 64-column block at a time, each tile into a fresh accumulator
      const uint8_t* oh = wg == 0 ? st + 2 * TILE : st;
      const uint32_t bh = hop::smem_u32(wg == 0 ? ph : dh), bl = hop::smem_u32(wg == 0 ? pl : dl);
#pragma unroll
      for (int mb = 0; mb < nmb; ++mb) {
        tf_outer<64>(acc, oh, oh + TILE, 64 * mb + rlo, t4, bh, bl);
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[32 * mb + i] += acc[i];
      }
    }
    __syncwarp();
    if (lane == 0) hop::bar_arrive(empty + stage);
    if (++stage == f.stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // dV^T (warpgroup 0) or dK^T (1): value 32 mb + i is column (key)
  // frag_col(i) and row (head column) 64 mb + rlo + frag_row(i)
  float* g = wg == 0 ? dv : dk;
#pragma unroll
  for (int mb = 0; mb < nmb; ++mb)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int key = c0 + frag_col(i, t4), d = 64 * mb + rlo + frag_row(i);
      if (key < f.T && d < f.D) g[(((long long)b * f.T + key) * f.H + h) * f.D + d] = tot[32 * mb + i];
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

template <class Shape>
static bool grid_ok(const Shape& f, int ntiles) {
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

// ---- tensor-core launchers (bf16) -------------------------------------------------------

// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query,
// so that the build needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return (EncodeTiledFn) nullptr;
    return (EncodeTiledFn)p;
  }();
  return fn;
}

// TMA addresses rows whose base and strides are multiples of 16 bytes.
static bool tma_ok(int D, std::initializer_list<const void*> ptrs) {
  if ((D * 2) % 16 != 0 || encode_tiled() == nullptr) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The 4-D map of x (B, n, H, D) bf16, innermost first, with boxes of 64
// columns x box_rows rows of one (entry, head), 128-byte swizzled.
static int make_map(CUtensorMap* m, const void* x, int B, int n, int H, int D, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)n * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x),
                                    dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Output column chunk of each kernel: the whole head up to 256 columns in
// the forward (the O accumulator is DC / 2 registers a thread), 128 in the
// backward (dK and dV are both held).
static int fwd_chunk(int D) { return D <= 64 ? 64 : (D <= 128 ? 128 : 256); }
static int bwd_chunk(int D) { return D <= 64 ? 64 : 128; }

// The largest (warpgroups, stages) whose tiles fit `optin` bytes: two
// consumer warpgroups first, then the deepest ring. False when even one
// warpgroup and one stage do not fit (a very wide head).
static bool pick_wg(WgLayout (*layout)(int, int, int, int), int DP, int DC, int optin, int* nwg,
                    int* st) {
  for (int w = 2; w >= 1; --w)
    for (int s = WG_MAX_STAGES; s >= 1; --s)
      if (layout(w, s, DP, DC).total <= (uint32_t)optin) {
        *nwg = w;
        *st = s;
        return true;
      }
  return false;
}

static WgShape wg_shape(int B, int S, int T, int H, int D, int causal, int nwg, int st, int DC,
                        int rows_q, int rows_k, const int* qoff, const int* koff, int qo0,
                        int ko0, float scale) {
  return WgShape{B, S, T, H, D, (D + 63) / 64 * 64, causal, (S + rows_q - 1) / rows_q,
                 (T + rows_k - 1) / rows_k, (D + DC - 1) / DC, nwg, st, qoff, koff, qo0, ko0,
                 scale};
}

template <bool TMA, int DC>
static int fwd_wg_launch(const CUtensorMap* maps, const void* q, const void* k, const void* v,
                         void* out, float* m, float* l, const WgShape& f, int state,
                         cudaStream_t stream) {
  const uint32_t smem = fwd_layout(f.nwg, f.stages, f.DP, DC).total;
  int e = (int)cudaFuncSetAttribute(flash_fwd_wgmma<TMA, DC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  const dim3 grid((unsigned)((long long)f.B * f.nd * f.nq), f.H);
  flash_fwd_wgmma<TMA, DC><<<grid, 128 * (f.nwg + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], (const bf16_t*)q, (const bf16_t*)k, (const bf16_t*)v, out, m, l, f,
      state);
  return (int)cudaGetLastError();
}

template <bool TMA, int DC>
static int bwd_wg_launch(const CUtensorMap* maps, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, const WgShape& f1, const WgShape& f2, int out_f32,
                         cudaStream_t stream) {
  const uint32_t s1 = dq_layout(f1.nwg, f1.stages, f1.DP, DC).total;
  const uint32_t s2 = dkv_layout(f2.nwg, f2.stages, f2.DP, DC).total;
  int e = (int)cudaFuncSetAttribute(flash_bwd_dq_wgmma<TMA, DC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (!e)
    e = (int)cudaFuncSetAttribute(flash_bwd_dkv_wgmma<TMA, DC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e) return e;
  const dim3 g1((unsigned)((long long)f1.B * f1.nd * f1.nq), f1.H);
  flash_bwd_dq_wgmma<TMA, DC><<<g1, 128 * (f1.nwg + 1), s1, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const bf16_t*)q, (const bf16_t*)k, (const bf16_t*)v,
      (const bf16_t*)dout, lse, delta, dq, f1, out_f32);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 g2((unsigned)((long long)f2.B * f2.nd * f2.nk), f2.H);
  flash_bwd_dkv_wgmma<TMA, DC><<<g2, 128 * (f2.nwg + 1), s2, stream>>>(
      maps[4], maps[5], maps[6], maps[7], (const bf16_t*)q, (const bf16_t*)k, (const bf16_t*)v,
      (const bf16_t*)dout, lse, delta, dk, dv, f2, out_f32);
  return (int)cudaGetLastError();
}

constexpr int WG_NOT_TAKEN = -1;  // the shape's tiles overflow shared memory: the FMA kernels

// Which kernels a call took: the FMA kernels, the split-TF32 kernels (f32)
// or the bf16 tensor-core kernels.
constexpr int ROUTE_FMA = 0, ROUTE_TF32 = 1, ROUTE_BF16 = 2;
static int g_last_route = -1;

static int fwd_wgmma(const void* q, const void* k, const void* v, const int* qoff,
                     const int* koff, void* out, float* m, float* l, int B, int S, int T, int H,
                     int D, int causal, int state, int qo0, int ko0, float scale, int optin,
                     cudaStream_t s) {
  const int DC = fwd_chunk(D), DP = (D + 63) / 64 * 64;
  int nwg = 0, st = 0;
  if (!pick_wg(fwd_layout, DP, DC, optin, &nwg, &st)) return WG_NOT_TAKEN;
  const WgShape f = wg_shape(B, S, T, H, D, causal, nwg, st, DC, 64 * nwg, WG_BN, qoff, koff,
                             qo0, ko0, scale);
  if (!grid_ok(f, f.nq)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = tma_ok(D, {q, k, v});
  if (tma) {
    int e = make_map(&maps[0], q, B, S, H, D, 64 * nwg);
    if (!e) e = make_map(&maps[1], k, B, T, H, D, WG_BN);
    if (!e) e = make_map(&maps[2], v, B, T, H, D, WG_BN);
    if (e) return e;
  }
#define FA_WG_FWD(TMA, C) fwd_wg_launch<TMA, C>(maps, q, k, v, out, m, l, f, state, s)
  if (tma) return DC == 64 ? FA_WG_FWD(true, 64) : DC == 128 ? FA_WG_FWD(true, 128) : FA_WG_FWD(true, 256);
  return DC == 64 ? FA_WG_FWD(false, 64) : DC == 128 ? FA_WG_FWD(false, 128) : FA_WG_FWD(false, 256);
#undef FA_WG_FWD
}

static int bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* qoff, const int* koff,
                     void* dq, void* dk, void* dv, int B, int S, int T, int H, int D, int causal,
                     int out_f32, int qo0, int ko0, float scale, int optin, cudaStream_t s) {
  // rows that TMA cannot address take 64-column chunks: the producer's own
  // loads leave the dk/dv consumers too few registers for 128
  const bool tma = tma_ok(D, {q, k, v, dout});
  const int DC = tma ? bwd_chunk(D) : 64, DP = (D + 63) / 64 * 64;
  int w1 = 0, st1 = 0, w2 = 0, st2 = 0;
  if (!pick_wg(dq_layout, DP, DC, optin, &w1, &st1) ||
      !pick_wg(dkv_layout, DP, DC, optin, &w2, &st2))
    return WG_NOT_TAKEN;
  // dq: query tiles of 64 * w1 rows over key tiles of BN; dk/dv: key tiles of
  // 64 * w2 rows over query tiles of BN
  const WgShape f1 = wg_shape(B, S, T, H, D, causal, w1, st1, DC, 64 * w1, WG_BN, qoff, koff,
                              qo0, ko0, scale);
  const WgShape f2 = wg_shape(B, S, T, H, D, causal, w2, st2, DC, WG_BN, 64 * w2, qoff, koff,
                              qo0, ko0, scale);
  if (!grid_ok(f1, f1.nq) || !grid_ok(f2, f2.nk)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  memset(maps, 0, sizeof(maps));
  if (tma) {
    int e = make_map(&maps[0], q, B, S, H, D, 64 * w1);
    if (!e) e = make_map(&maps[1], k, B, T, H, D, WG_BN);
    if (!e) e = make_map(&maps[2], v, B, T, H, D, WG_BN);
    if (!e) e = make_map(&maps[3], dout, B, S, H, D, 64 * w1);
    if (!e) e = make_map(&maps[4], q, B, S, H, D, WG_BN);
    if (!e) e = make_map(&maps[5], k, B, T, H, D, 64 * w2);
    if (!e) e = make_map(&maps[6], v, B, T, H, D, 64 * w2);
    if (!e) e = make_map(&maps[7], dout, B, S, H, D, WG_BN);
    if (e) return e;
  }
#define FA_WG_BWD(TMA, C) \
  bwd_wg_launch<TMA, C>(maps, q, k, v, dout, lse, delta, dq, dk, dv, f1, f2, out_f32, s)
  if (tma) return DC == 64 ? FA_WG_BWD(true, 64) : FA_WG_BWD(true, 128);
  return FA_WG_BWD(false, 64);
#undef FA_WG_BWD
}

// ---- tensor-core launchers (f32: split TF32) --------------------------------------------

// TMA addresses f32 rows whose base and strides are multiples of 16 bytes.
static bool tma_ok32(int D, std::initializer_list<const void*> ptrs) {
  if ((D * 4) % 16 != 0 || encode_tiled() == nullptr) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// The 4-D map of x (B, n, H, D) f32, innermost first, with boxes of 32
// columns x box_rows rows of one (entry, head), 128-byte swizzled.
static int make_map32(CUtensorMap* m, const void* x, int B, int n, int H, int D, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)n, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                 (cuuint64_t)n * H * D * 4};
  const cuuint32_t box[4] = {32, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x),
                                    dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The deepest ring of a backward TF32 kernel that fits `optin` bytes.
static bool pick_tf_stages(TfLayout (*layout)(int, int), int DC, int optin, int* st) {
  for (int s = TF_MAX_STAGES; s >= 1; --s)
    if (layout(s, DC).total <= (uint32_t)optin) {
      *st = s;
      return true;
    }
  return false;
}

template <bool TMA, int DC>
static int fwd_tf_launch(const CUtensorMap* maps, const void* q, const void* k, const void* v,
                         void* out, float* m, float* l, const WgShape& f, int state,
                         cudaStream_t stream) {
  const uint32_t smem = fwd_tf_layout(f.nwg, f.stages, DC).total;
  int e = (int)cudaFuncSetAttribute(flash_fwd_tf32<TMA, DC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e) return e;
  const dim3 grid((unsigned)((long long)f.B * f.nq), f.H);
  flash_fwd_tf32<TMA, DC><<<grid, 128 * (f.nwg + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], (const float*)q, (const float*)k, (const float*)v, out, m, l, f,
      state);
  return (int)cudaGetLastError();
}

template <bool TMA, int DC>
static int bwd_tf_launch(const CUtensorMap* maps, const void* q, const void* k, const void* v,
                         const void* dout, const float* lse, const float* delta, void* dq,
                         void* dk, void* dv, const WgShape& f1, const WgShape& f2,
                         cudaStream_t stream) {
  const uint32_t s1 = dq_tf_layout(f1.stages, DC).total;
  const uint32_t s2 = dkv_tf_layout(f2.stages, DC).total;
  int e = (int)cudaFuncSetAttribute(flash_bwd_dq_tf32<TMA, DC>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (!e)
    e = (int)cudaFuncSetAttribute(flash_bwd_dkv_tf32<TMA, DC>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e) return e;
  const dim3 g1((unsigned)((long long)f1.B * f1.nq), f1.H);
  flash_bwd_dq_tf32<TMA, DC><<<g1, WG_THREADS, s1, stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, lse, delta, (float*)dq, f1);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 g2((unsigned)((long long)f2.B * f2.nk), f2.H);
  flash_bwd_dkv_tf32<TMA, DC><<<g2, WG_THREADS, s2, stream>>>(
      maps[4], maps[5], maps[6], maps[7], (const float*)q, (const float*)k, (const float*)v,
      (const float*)dout, lse, delta, (float*)dk, (float*)dv, f2);
  return (int)cudaGetLastError();
}

// f32 heads of D <= TF_MAX_D take the split-TF32 kernels; WG_NOT_TAKEN
// sends wider ones to the FMA kernels. A shape rule, decided before any launch.
static int fwd_tf32(const void* q, const void* k, const void* v, const int* qoff,
                    const int* koff, void* out, float* m, float* l, int B, int S, int T, int H,
                    int D, int causal, int state, int qo0, int ko0, float scale, int optin,
                    cudaStream_t s) {
  if (D > TF_MAX_D) return WG_NOT_TAKEN;
  const int DC = D <= 64 ? 64 : 128;
  int nwg = 0, st = 0;
  for (int w = 2; w >= 1 && !nwg; --w)
    for (int x = TF_MAX_STAGES; x >= 1; --x)
      if (fwd_tf_layout(w, x, DC).total <= (uint32_t)optin) {
        nwg = w;
        st = x;
        break;
      }
  if (!nwg) return WG_NOT_TAKEN;
  const WgShape f = wg_shape(B, S, T, H, D, causal, nwg, st, DC, 64 * nwg, TF_BN, qoff, koff,
                             qo0, ko0, scale);
  if (!grid_ok(f, f.nq)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  const bool tma = tma_ok32(D, {q, k, v});
  if (tma) {
    int e = make_map32(&maps[0], q, B, S, H, D, 64 * nwg);
    if (!e) e = make_map32(&maps[1], k, B, T, H, D, TF_BN);
    if (!e) e = make_map32(&maps[2], v, B, T, H, D, TF_BN);
    if (e) return e;
  }
#define FA_TF_FWD(TMA, C) fwd_tf_launch<TMA, C>(maps, q, k, v, out, m, l, f, state, s)
  if (tma) return DC == 64 ? FA_TF_FWD(true, 64) : FA_TF_FWD(true, 128);
  return DC == 64 ? FA_TF_FWD(false, 64) : FA_TF_FWD(false, 128);
#undef FA_TF_FWD
}

static int bwd_tf32(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, const int* qoff, const int* koff,
                    void* dq, void* dk, void* dv, int B, int S, int T, int H, int D, int causal,
                    int qo0, int ko0, float scale, int optin, cudaStream_t s) {
  if (D > TF_MAX_D) return WG_NOT_TAKEN;
  const int DC = D <= 64 ? 64 : 128;
  int st1 = 0, st2 = 0;
  if (!pick_tf_stages(dq_tf_layout, DC, optin, &st1) ||
      !pick_tf_stages(dkv_tf_layout, DC, optin, &st2))
    return WG_NOT_TAKEN;
  // dq: query tiles of 64 over key tiles of TF_BN; dk/dv: key tiles of 64
  // over query tiles of TF_BN
  const WgShape f1 = wg_shape(B, S, T, H, D, causal, 2, st1, DC, 64, TF_BN, qoff, koff, qo0,
                              ko0, scale);
  const WgShape f2 = wg_shape(B, S, T, H, D, causal, 2, st2, DC, TF_BN, 64, qoff, koff, qo0,
                              ko0, scale);
  if (!grid_ok(f1, f1.nq) || !grid_ok(f2, f2.nk)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[8];
  memset(maps, 0, sizeof(maps));
  const bool tma = tma_ok32(D, {q, k, v, dout});
  if (tma) {
    int e = make_map32(&maps[0], q, B, S, H, D, 64);
    if (!e) e = make_map32(&maps[1], k, B, T, H, D, TF_BN);
    if (!e) e = make_map32(&maps[2], v, B, T, H, D, TF_BN);
    if (!e) e = make_map32(&maps[3], dout, B, S, H, D, 64);
    if (!e) e = make_map32(&maps[4], q, B, S, H, D, TF_BN);
    if (!e) e = make_map32(&maps[5], k, B, T, H, D, 64);
    if (!e) e = make_map32(&maps[6], v, B, T, H, D, 64);
    if (!e) e = make_map32(&maps[7], dout, B, S, H, D, TF_BN);
    if (e) return e;
  }
#define FA_TF_BWD(TMA, C) \
  bwd_tf_launch<TMA, C>(maps, q, k, v, dout, lse, delta, dq, dk, dv, f1, f2, s)
  if (tma) return DC == 64 ? FA_TF_BWD(true, 64) : FA_TF_BWD(true, 128);
  return DC == 64 ? FA_TF_BWD(false, 64) : FA_TF_BWD(false, 128);
#undef FA_TF_BWD
}

// Tiles of the FMA kernels for a bf16 head too wide for the tensor-core
// kernels (D > 448: NC = 16 there).
#define FA_DISPATCH_WIDE(RT, NC, CALL)                  \
  if (RT == 4 && NC == 16) return CALL(4, 16);          \
  if (RT == 2 && NC == 16) return CALL(2, 16);          \
  if (RT == 1 && NC == 16) return CALL(1, 16);          \
  return (int)cudaErrorInvalidValue;

// q (B, S, H, D), k/v (B, T, H, D) in f32 (bf16 == 0) or bf16; qoff/koff (B,)
// int32 or null (then qo0/ko0 for every entry). state == 0: out (B, S, H, D)
// in q's type, m/l unused; state == 1: out the raw f32 accumulator, m and l
// (B, H, S) f32. bf16 runs on the bf16 tensor-core kernels, f32 heads up to
// TF_MAX_D on the split-TF32 ones, wider heads of either on the FMA kernels.
extern "C" int ts_flash_fwd(const void* q, const void* k, const void* v, const int* qoff,
                            const int* koff, void* out, float* m, float* l, int B, int S, int T,
                            int H, int D, int causal, int bf16, int state, int qo0, int ko0,
                            float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  int optin = 0, rt = 0, nc = 0;
  int e = smem_optin(&optin);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? fwd_wgmma(q, k, v, qoff, koff, out, m, l, B, S, T, H, D, causal, state, qo0, ko0,
                       scale, optin, s)
           : fwd_tf32(q, k, v, qoff, koff, out, m, l, B, S, T, H, D, causal, state, qo0, ko0,
                      scale, optin, s);
  if (e != WG_NOT_TAKEN) {
    g_last_route = bf16 ? ROUTE_BF16 : ROUTE_TF32;
    return e;
  }
  g_last_route = ROUTE_FMA;
  e = pick_tile(D, fwd_smem, optin, &rt, &nc);
  if (e) return e;
  const FlashShape f = make_shape(B, S, T, H, D, causal, rt, nc, qoff, koff, qo0, ko0, scale);
#define FA_FWD_F32(A, C) fwd_launch<float, A, C>(q, k, v, out, m, l, f, state, s)
#define FA_FWD_BF16(A, C) fwd_launch<__nv_bfloat16, A, C>(q, k, v, out, m, l, f, state, s)
  if (bf16) {
    FA_DISPATCH_WIDE(rt, nc, FA_FWD_BF16)
  }
  FA_DISPATCH(rt, nc, FA_FWD_F32)
}

// The backward pair: dq (B, S, H, D) by the dq kernel, dk and dv (B, T, H, D)
// by the dk/dv kernel, in f32 (out_f32) or q's type; dout in q's type, lse
// and delta (B, H, S) f32. Never atomics: the same bits on every call.
extern "C" int ts_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, const int* qoff,
                            const int* koff, void* dq, void* dk, void* dv, int B, int S, int T,
                            int H, int D, int causal, int bf16, int out_f32, int qo0, int ko0,
                            float scale, void* stream) {
  if (bad_shape(B, S, T, H, D)) return (int)cudaErrorInvalidValue;
  int optin = 0, rt = 0, nc = 0;
  int e = smem_optin(&optin);
  if (e) return e;
  cudaStream_t s = (cudaStream_t)stream;
  e = bf16 ? bwd_wgmma(q, k, v, dout, lse, delta, qoff, koff, dq, dk, dv, B, S, T, H, D, causal,
                       out_f32, qo0, ko0, scale, optin, s)
           : bwd_tf32(q, k, v, dout, lse, delta, qoff, koff, dq, dk, dv, B, S, T, H, D, causal,
                      qo0, ko0, scale, optin, s);
  if (e != WG_NOT_TAKEN) {
    g_last_route = bf16 ? ROUTE_BF16 : ROUTE_TF32;
    return e;
  }
  g_last_route = ROUTE_FMA;
  e = pick_tile(D, dkv_smem, optin, &rt, &nc);  // the larger of the pair's needs
  if (e) return e;
  const FlashShape f = make_shape(B, S, T, H, D, causal, rt, nc, qoff, koff, qo0, ko0, scale);
#define FA_BWD_F32(A, C) \
  bwd_launch<float, A, C>(q, k, v, dout, lse, delta, dq, dk, dv, f, out_f32, s)
#define FA_BWD_BF16(A, C) \
  bwd_launch<__nv_bfloat16, A, C>(q, k, v, dout, lse, delta, dq, dk, dv, f, out_f32, s)
  if (bf16) {
    FA_DISPATCH_WIDE(rt, nc, FA_BWD_BF16)
  }
  FA_DISPATCH(rt, nc, FA_BWD_F32)
}

// The kernels the last ts_flash_fwd or ts_flash_bwd call took (ROUTE_*),
// -1 before any; a record of the shape rule, read by the wrappers.
extern "C" int ts_flash_last_route() { return g_last_route; }

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
