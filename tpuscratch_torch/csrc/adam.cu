// Hand-written Hopper (sm_90a) kernel for the fused Adam update.
//
// Replaces the Pallas TPU kernel of tpuscratch/ops/adam.py:
//   adam_kernel <- fused_adam_flat (:87) / fused_adam_tree (:130) through
//                  _fused_adam_flat_call (:48), kernel _adam_kernel (:37)
// One pass reads (w, g, m, v) and writes (w', m', v'):
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + ((1 - b2) g) g
//   w' = w - (alpha m') / (sqrt(v') + eps)
// w and g are float32; m and v float32 or bfloat16, always summed in
// float32. w' comes from the unrounded float32 m' and v' (as in the TPU
// kernel); only the stored moments round to bfloat16, to nearest even as
// .to(torch.bfloat16) does. v' multiplies (1 - b2) g by g, the association
// of the tree-mapped update (models/transformer.py _adam_apply), so this
// kernel, its plain version and the unfused Adam step are equal bit for bit
// (the TPU kernel forms (1 - b2) (g g): an ulp of v' apart at times). Every
// product, sum, quotient and root is an explicitly rounded intrinsic, never
// contracted into an FMA; (1 - b1) and (1 - b2) come from the host, computed
// in double and rounded to float once, as torch rounds a Python float.
//
// Layout: the operands are A rows of L elements, each row contiguous, rows
// `stride` elements apart (a tensor's leading dims collapsed), one alpha
// per row read from device memory (the stacked ranks of a mesh each carry
// their own bias-corrected step size; nothing is read back to the host).
// The TPU kernel's (rows, 1024) layout and padding are not needed: any L.
// The outputs may be the inputs (the donated, in-place update): each
// element is read and written by one thread.
//
// Bound: bytes. 28 B an element with float32 moments (w, g, m, v read; w,
// m, v written), 20 with bfloat16, against ~12 flops: at 3.35 TB/s,
// 253,921,280 elements take 2.12 ms (f32 moments) or 1.52 ms (bf16).
// A grid sized by the SM count strides over each row; 16-byte loads and
// stores (4 elements a thread) where every row start is aligned and L is a
// multiple of 4, else one element at a time.
//
// Plain C interface (ctypes): the launcher takes raw pointers and the CUDA
// stream, launches on that stream, allocates nothing and returns
// cudaGetLastError() as an int.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

constexpr int THREADS = 256;

template <typename MT>
struct AdamArgs {
  float* w;
  const float* g;
  MT* m;
  MT* v;
  float* nw;
  MT* nm;
  MT* nv;
  const float* alpha;
  long long rows, len;
  long long sw, sg, sm, sv, snw, snm, snv;  // row strides, in elements
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename MT>
__device__ __forceinline__ void adam_one(const AdamArgs<MT>& a, float alpha, float w,
                                         float g, float m, float v, float* nw, float* nm,
                                         float* nv) {
  const float m2 = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  const float v2 = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(__fmul_rn(a.omb2, g), g));
  *nw = __fsub_rn(w, __fdiv_rn(__fmul_rn(alpha, m2), __fadd_rn(__fsqrt_rn(v2), a.eps)));
  *nm = m2;
  *nv = v2;
}

// Four moments at once: float4 for float32, 8 bytes (four bf16) for bf16.
__device__ __forceinline__ void ld4(const float* p, float* x) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void st4(float* p, const float* x) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* x) {
  // each half rounded to nearest even on its own, as the scalar store
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(x[0]); lo.y = __float2bfloat16_rn(x[1]);
  hi.x = __float2bfloat16_rn(x[2]); hi.y = __float2bfloat16_rn(x[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename MT, bool VEC>
__global__ void __launch_bounds__(THREADS) adam_kernel(AdamArgs<MT> a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long r = blockIdx.y; r < a.rows; r += gridDim.y) {
    const float alpha = a.alpha[r];
    float* w = a.w + r * a.sw;
    const float* g = a.g + r * a.sg;
    MT* m = a.m + r * a.sm;
    MT* v = a.v + r * a.sv;
    float* nw = a.nw + r * a.snw;
    MT* nm = a.nm + r * a.snm;
    MT* nv = a.nv + r * a.snv;
    if (VEC) {
      for (long long q = tid; q < a.len / 4; q += stride) {
        const long long i = 4 * q;
        float xw[4], xg[4], xm[4], xv[4], ow[4], om[4], ov[4];
        ld4(w + i, xw);
        ld4(g + i, xg);
        ld4(m + i, xm);
        ld4(v + i, xv);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          adam_one(a, alpha, xw[j], xg[j], xm[j], xv[j], &ow[j], &om[j], &ov[j]);
        st4(nw + i, ow);
        st4(nm + i, om);
        st4(nv + i, ov);
      }
    } else {
      for (long long i = tid; i < a.len; i += stride) {
        float ow, om, ov;
        adam_one(a, alpha, w[i], g[i], ld(m + i), ld(v + i), &ow, &om, &ov);
        nw[i] = ow;
        st(nm + i, om);
        st(nv + i, ov);
      }
    }
  }
}

static int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

static bool aligned(const void* p, long long stride, int esize, int bytes) {
  return ((uintptr_t)p % bytes) == 0 && (stride * esize) % bytes == 0;
}

template <typename MT>
static int launch(AdamArgs<MT> a, cudaStream_t s) {
  const int mb = (int)sizeof(MT) * 4;  // bytes of four moments
  const bool vec = a.len % 4 == 0 && aligned(a.w, a.sw, 4, 16) && aligned(a.g, a.sg, 4, 16) &&
                   aligned(a.nw, a.snw, 4, 16) && aligned(a.m, a.sm, sizeof(MT), mb) &&
                   aligned(a.v, a.sv, sizeof(MT), mb) && aligned(a.nm, a.snm, sizeof(MT), mb) &&
                   aligned(a.nv, a.snv, sizeof(MT), mb);
  const long long units = vec ? a.len / 4 : a.len;
  const long long gy = a.rows < 65535 ? a.rows : 65535;
  long long gx = (units + THREADS - 1) / THREADS;
  const long long cap = ((long long)sm_count() * 8 + gy - 1) / gy;
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  if (vec)
    adam_kernel<MT, true><<<grid, THREADS, 0, s>>>(a);
  else
    adam_kernel<MT, false><<<grid, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// strides: {w, g, m, v, nw, nm, nv}; moment_bf16: m, v, nm, nv are bf16.
extern "C" int ts_fused_adam(void* w, const void* g, void* m, void* v, void* nw, void* nm,
                             void* nv, const void* alpha, long long rows, long long len,
                             const long long* strides, int moment_bf16, float b1, float omb1,
                             float b2, float omb2, float eps, void* stream) {
  if (rows < 0 || len < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || len == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (moment_bf16) {
    AdamArgs<__nv_bfloat16> a{(float*)w, (const float*)g, (__nv_bfloat16*)m,
                              (__nv_bfloat16*)v, (float*)nw, (__nv_bfloat16*)nm,
                              (__nv_bfloat16*)nv, (const float*)alpha, rows, len,
                              strides[0], strides[1], strides[2], strides[3], strides[4],
                              strides[5], strides[6], b1, omb1, b2, omb2, eps};
    return launch(a, s);
  }
  AdamArgs<float> a{(float*)w, (const float*)g, (float*)m, (float*)v, (float*)nw, (float*)nm,
                    (float*)nv, (const float*)alpha, rows, len, strides[0], strides[1],
                    strides[2], strides[3], strides[4], strides[5], strides[6],
                    b1, omb1, b2, omb2, eps};
  return launch(a, s);
}

extern "C" const char* ts_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
