// Multi-tensor one-pass Adam for Hopper (sm_90a): one launch updates every
// leaf of an optimizer step.
//
// Replaces the TPU kernel decagon_tpu/ops/optim.py::_adam_kernel (via
// _adam_leaf / fused_adam_apply), and its probe
// scripts/probe_adam_onepass.py::adam_kernel.  Per element, in f32:
//
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g^2
//   p' = p + (-lr) (s1 m') / (sqrt(s2 v') + eps)
//
// A launch takes a table of up to MAX_LEAVES leaves as one by-value kernel
// parameter (no host-to-device copy).  Each leaf has its own dtypes:
// g f32, bf16, or f32 rounded to bf16 as it is read (the gradient cast of
// train/step.py::cast_grads, fused); m and v both f32 or both bf16; p f32.
// Each leaf has its own outputs for m, v and p: equal to the inputs for an
// update in place, other tensors for one out of place.
//
// Bound on this card: bytes.  Each element reads g, m, v, p once and
// writes m, v, p once (18 bytes with bf16 g, m, v; 28 with f32) for about
// a dozen f32 operations.
//
// Design.  The TPU kernel tiles each leaf in its natural [d0, d1, h] shape
// because a reshape there is a relayout; a contiguous tensor here is flat
// for free, whatever its rank.  The host gives each leaf a run of blocks
// (as many as its 8-element vectors need, at most MAX_LEAF_BLOCKS); a
// block finds its leaf by a binary search over the runs' first blocks
// (uniform over the block, read from the constant bank through
// __grid_constant__) and walks its leaf's vectors with a stride of the
// run's threads.  A thread moves 8 elements a step: 16 bytes of each bf16
// tensor, two 16-byte vectors of each f32 one.  Every leaf whose seven
// pointers are 16-byte aligned takes the vector loop; its last n % 8
// elements, and every element of a leaf that is not aligned, go through a
// scalar loop.  The dtype switch is uniform over a block.
//
// Every operation is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn) in the order of the plain PyTorch chain (ops/optim.py::
// _chain), so nothing contracts into an FMA and the result equals the
// chain's bit for bit; the bf16 roundings are round-to-nearest-even, as
// PyTorch's casts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements a thread moves per vector step
// 48 leaves of 72 bytes and the scalars keep the kernel's parameters
// under the long-standing 4 KB limit on kernel parameters.
constexpr int MAX_LEAVES = 48;
constexpr int MAX_LEAF_BLOCKS = 132 * 32;

// Leaf codes: bits 0-1 the gradient (G_*), bit 2 bf16 moments, bit 3 the
// vector loop.
constexpr int G_F32 = 0, G_BF16 = 1, G_ROUND = 2;
constexpr int M_BF16 = 4, VECTORIZED = 8;

struct Leaf {
  const void* g;
  const void* m;
  const void* v;
  const float* p;
  void* m_out;
  void* v_out;
  float* p_out;
  long long n;
  int block0;  // first block of this leaf's run
  int code;
};

struct Consts {
  float b1, omb1, b2, omb2, s1, s2, neg_lr, eps;
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  Consts c;
  int count;
  int blocks;
};

// One element: returns p', writes m', v' (f32) through the references.
__device__ __forceinline__ float adam_elem(float g, float& m, float& v, float p, const Consts& c) {
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, g));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(c.omb2, __fmul_rn(g, g)));
  const float num = __fmul_rn(c.neg_lr, __fmul_rn(c.s1, m));
  const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(c.s2, v)), c.eps);
  return __fadd_rn(p, __fdiv_rn(num, den));
}

__device__ __forceinline__ float load1(const float* x, long long i) { return x[i]; }
__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}
__device__ __forceinline__ void store1(float* x, long long i, float f) { x[i] = f; }
__device__ __forceinline__ void store1(__nv_bfloat16* x, long long i, float f) {
  x[i] = __float2bfloat16_rn(f);
}

__device__ __forceinline__ void load8(const float* x, float* out) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* x, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(x);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    out[2 * q] = f.x;
    out[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void store8(float* x, const float* in) {
  reinterpret_cast<float4*>(x)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(in[4], in[5], in[6], in[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* x, const float* in) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(in[2 * q], in[2 * q + 1]);
  *reinterpret_cast<uint4*>(x) = u;
}

// The gradient as the chain reads it: f32, after the bf16 cast for G_ROUND.
template <int GK>
__device__ __forceinline__ float grad(float x) {
  return GK == G_ROUND ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// Blocks j of nb of one leaf: the vector loop (vectorized leaves), then
// the scalar loop over what is left.  GT: g's storage, MT: m's and v's.
template <int GK, typename MT>
__device__ __forceinline__ void leaf_pass(const Leaf& L, long long j, long long nb,
                                          const Consts& c) {
  using GT = typename std::conditional<GK == G_BF16, __nv_bfloat16, float>::type;
  const GT* g = static_cast<const GT*>(L.g);
  const MT* m = static_cast<const MT*>(L.m);
  const MT* v = static_cast<const MT*>(L.v);
  MT* m_out = static_cast<MT*>(L.m_out);
  MT* v_out = static_cast<MT*>(L.v_out);
  const long long n = L.n;
  const long long n_vec = (L.code & VECTORIZED) ? n / VEC : 0;
  const long long tid = j * blockDim.x + threadIdx.x;
  const long long stride = nb * blockDim.x;
  for (long long i = tid; i < n_vec; i += stride) {
    const long long e0 = i * VEC;
    float gf[VEC], mf[VEC], vf[VEC], pf[VEC];
    load8(g + e0, gf);
    load8(m + e0, mf);
    load8(v + e0, vf);
    load8(L.p + e0, pf);
#pragma unroll
    for (int q = 0; q < VEC; ++q) pf[q] = adam_elem(grad<GK>(gf[q]), mf[q], vf[q], pf[q], c);
    store8(m_out + e0, mf);
    store8(v_out + e0, vf);
    store8(L.p_out + e0, pf);
  }
  for (long long e = n_vec * VEC + tid; e < n; e += stride) {
    float mf = load1(m, e), vf = load1(v, e);
    const float pf = adam_elem(grad<GK>(load1(g, e)), mf, vf, L.p[e], c);
    store1(m_out, e, mf);
    store1(v_out, e, vf);
    L.p_out[e] = pf;
  }
}

template <typename MT>
__device__ __forceinline__ void dispatch_g(const Leaf& L, long long j, long long nb,
                                           const Consts& c) {
  switch (L.code & 3) {
    case G_F32: leaf_pass<G_F32, MT>(L, j, nb, c); break;
    case G_BF16: leaf_pass<G_BF16, MT>(L, j, nb, c); break;
    default: leaf_pass<G_ROUND, MT>(L, j, nb, c); break;
  }
}

__global__ void __launch_bounds__(THREADS) adam_multi_kernel(const __grid_constant__ Table t) {
  // The last leaf whose run starts at or before this block.
  const int b = static_cast<int>(blockIdx.x);
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].block0 <= b) lo = mid;
    else hi = mid - 1;
  }
  const Leaf& L = t.leaf[lo];
  const int end = lo + 1 < t.count ? t.leaf[lo + 1].block0 : t.blocks;
  const long long j = b - L.block0, nb = end - L.block0;
  if (L.code & M_BF16) dispatch_g<__nv_bfloat16>(L, j, nb, t.c);
  else dispatch_g<float>(L, j, nb, t.c);
}

}  // namespace

extern "C" {

// One launch over ``count`` (1..MAX_LEAVES) leaves.  ptrs: 7 pointers a
// leaf, in the order g, m, v, p, m_out, v_out, p_out; ns: each leaf's
// element count (> 0); codes: each leaf's G_* | M_BF16 | VECTORIZED (the
// wrapper sets VECTORIZED only where all seven pointers are 16-byte
// aligned).  block_threads: 32..THREADS, a multiple of 32.  The scalars
// arrive as f32, rounded on the host as PyTorch rounds a Python scalar for
// an f32 operation.
int dt_adam_multi(int count, void* const* ptrs, const long long* ns, const int* codes,
                  int block_threads, float b1, float omb1, float b2, float omb2, float s1,
                  float s2, float neg_lr, float eps, void* stream) {
  if (count < 1 || count > MAX_LEAVES || block_threads < 32 || block_threads > THREADS ||
      block_threads % 32 != 0)
    return cudaErrorInvalidValue;
  Table t;
  t.c = Consts{b1, omb1, b2, omb2, s1, s2, neg_lr, eps};
  t.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long n = ns[i];
    const int code = codes[i];
    if (n <= 0 || (code & 3) == 3 || (code & ~15) != 0) return cudaErrorInvalidValue;
    const long long n_vec = (code & VECTORIZED) ? n / VEC : 0;
    const long long work = n_vec > 0 ? n_vec : n;
    long long nb = (work + block_threads - 1) / block_threads;
    if (nb > MAX_LEAF_BLOCKS) nb = MAX_LEAF_BLOCKS;
    Leaf& L = t.leaf[i];
    L.g = ptrs[7 * i];
    L.m = ptrs[7 * i + 1];
    L.v = ptrs[7 * i + 2];
    L.p = static_cast<const float*>(ptrs[7 * i + 3]);
    L.m_out = ptrs[7 * i + 4];
    L.v_out = ptrs[7 * i + 5];
    L.p_out = static_cast<float*>(ptrs[7 * i + 6]);
    L.n = n;
    L.block0 = static_cast<int>(blocks);
    L.code = code;
    blocks += nb;
  }
  t.blocks = static_cast<int>(blocks);
  adam_multi_kernel<<<static_cast<unsigned>(blocks), block_threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(t);
  return cudaGetLastError();
}

}  // extern "C"
