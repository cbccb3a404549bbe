// One-pass Adam update, in place, for Hopper (sm_90a).
//
// Replaces the TPU kernel decagon_tpu/ops/optim.py::_adam_kernel (via
// _adam_leaf / fused_adam_apply), and its probe
// scripts/probe_adam_onepass.py::adam_kernel.  Per element, in f32:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   p' = p + (-lr) (s1 m') / (sqrt(s2 v') + eps)
//
// m, v and p are overwritten (the TPU kernel aliases them to its outputs).
// Two instantiations: g, m, v f32 (the kernel of fused_adam_apply) and
// g, m, v bf16 with f32 arithmetic (the probe's case); p is f32 in both.
//
// Bound on this card: bytes.  Each element reads g, m, v, p once and
// writes m, v, p once (28 bytes in f32, 18 with bf16 g/m/v) for about a
// dozen f32 operations.
//
// Design.  The TPU kernel tiles each leaf in its natural [d0, d1, h] shape
// because a reshape there is a relayout; a contiguous tensor here is flat
// for free.  Each thread of a grid-stride loop moves 16 bytes of g, m and
// v (4 f32 or 8 bf16 elements) and the matching f32 p with vector loads
// and stores; the elements after the last whole vector, and every element
// when the wrapper finds a pointer that is not 16-byte aligned
// (n_vec == 0), go through a scalar grid-stride loop.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the order of the plain PyTorch chain, so nothing
// contracts into an FMA and the result equals the chain's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Consts {
  float b1, omb1, b2, omb2, s1, s2, neg_lr, eps;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) { *out = __float2bfloat16_rn(x); }

// One element: returns p', writes m', v' (f32) through the references.
__device__ __forceinline__ float adam_elem(float g, float& m, float& v, float p, const Consts& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(c.neg_lr, __fmul_rn(c.s1, m));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(c.s2, v)), c.eps);
  return __fadd_rn(p, __fdiv_rn(num, den));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adam_kernel(const T* __restrict__ g, T* __restrict__ m, T* __restrict__ v,
            float* __restrict__ p, long long n, long long n_vec, Consts c) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector of g, m, v
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < n_vec; i += stride) {
    const long long e0 = i * E;
    alignas(16) T gl[E], ml[E], vl[E];
    *reinterpret_cast<uint4*>(gl) = *reinterpret_cast<const uint4*>(g + e0);
    *reinterpret_cast<uint4*>(ml) = *reinterpret_cast<const uint4*>(m + e0);
    *reinterpret_cast<uint4*>(vl) = *reinterpret_cast<const uint4*>(v + e0);
    float pf[E];
#pragma unroll
    for (int q = 0; q < E; q += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(p + e0 + q);
      pf[q] = p4.x; pf[q + 1] = p4.y; pf[q + 2] = p4.z; pf[q + 3] = p4.w;
    }
#pragma unroll
    for (int q = 0; q < E; ++q) {
      float mf = to_f32(ml[q]), vf = to_f32(vl[q]);
      pf[q] = adam_elem(to_f32(gl[q]), mf, vf, pf[q], c);
      from_f32(mf, &ml[q]);
      from_f32(vf, &vl[q]);
    }
    *reinterpret_cast<uint4*>(m + e0) = *reinterpret_cast<const uint4*>(ml);
    *reinterpret_cast<uint4*>(v + e0) = *reinterpret_cast<const uint4*>(vl);
#pragma unroll
    for (int q = 0; q < E; q += 4) {
      *reinterpret_cast<float4*>(p + e0 + q) = make_float4(pf[q], pf[q + 1], pf[q + 2], pf[q + 3]);
    }
  }
  for (long long e = n_vec * E + tid; e < n; e += stride) {
    float mf = to_f32(m[e]), vf = to_f32(v[e]);
    p[e] = adam_elem(to_f32(g[e]), mf, vf, p[e], c);
    from_f32(mf, &m[e]);
    from_f32(vf, &v[e]);
  }
}

template <typename T>
int launch(const void* g, void* m, void* v, void* p, long long n, int vectorized,
           int block_threads, const Consts& c, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const long long n_vec = vectorized ? n / E : 0;
  const long long work = n_vec > 0 ? n_vec : n;
  long long blocks = (work + block_threads - 1) / block_threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  adam_kernel<T><<<static_cast<unsigned>(blocks), block_threads, 0, s>>>(
      static_cast<const T*>(g), static_cast<T*>(m), static_cast<T*>(v),
      static_cast<float*>(p), n, n_vec, c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// g, m, v: n elements of f32 (bf16 == 0) or bf16 (bf16 == 1); p: n f32.
// m, v, p are updated in place.  vectorized: all four pointers are 16-byte
// aligned (the wrapper checks).  block_threads: 32..THREADS, a multiple
// of 32.  The scalars arrive as f32, rounded on the host as PyTorch rounds
// a Python scalar for an f32 operation.
int dt_adam(const void* g, void* m, void* v, void* p, long long n, int bf16,
            int vectorized, int block_threads, float b1, float omb1, float b2,
            float omb2, float s1, float s2, float neg_lr, float eps, void* stream) {
  if (n < 0 || block_threads < 32 || block_threads > THREADS || block_threads % 32 != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Consts c{b1, omb1, b2, omb2, s1, s2, neg_lr, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(g, m, v, p, n, vectorized, block_threads, c, s);
  return launch<float>(g, m, v, p, n, vectorized, block_threads, c, s);
}

}  // extern "C"
