// Sampled decoder scoring (SDDMM) for Hopper (sm_90a).
//
// Replaces the TPU kernel decagon_tpu/ops/sddmm_pallas.py::_sddmm_kernel.
// For B edges, each with its own relation index ks[e], it computes the
// logit of one of four decoders over node tables zr [n_r, d], zc [n_c, d]:
//
//   innerproduct  sum_a zr[a] zc[a]
//   distmult      sum_a (zr[a] rel[k,a]) zc[a]                 rel [n_k, d]
//   dedicom       sum_b (sum_a zr[a] rel[k,a] G[a,b]) (zc[b] rel[k,b])
//                                                  rel [n_k, d], G [d, d]
//   bilinear      sum_b (sum_a zr[a] R[k,a,b]) zc[b]           R [n_k, d, d]
//
// in one of the reference's two precisions:
//   "highest" (K5): every table f32;
//   "default" (K5-bf16): every table bf16 (the wrapper casts them, as the
//   TPU kernel casts its tables to its compute dtype), read exactly into
//   f32, f32 sums; DEDICOM rounds zr * rel[k] to bf16 before the product
//   with G, as the reference does.  A product of two bf16 values is exact
//   in f32, so the gathers and the bilinear and distmult products lose
//   nothing beyond the tables' rounding.
// The TPU kernel gathers rows through one-hot matrix products because its
// vector unit cannot gather; here each warp reads its edge's rows directly.
//
// Bound on this card: operations.  Each edge moves 16 bytes of indices
// and score, while dedicom and bilinear spend 2*d^2 flops on the d x d
// product; the tables (a few hundred KB) stay in L2.
//
// Design.  One warp per edge (grid-stride over edges); lane l holds
// elements l, l+32, ... of the row vectors (d <= 128).  The d x d product
// broadcasts each left element with a warp shuffle and reads the matrix
// row, which adjacent lanes read contiguously; a shuffle reduction gives
// the score.  An edge with an index outside its table scores NaN instead
// of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Mode { INNERPRODUCT = 0, DISTMULT = 1, DEDICOM = 2, BILINEAR = 3 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

// Element i of a table of f32 (BF16 false) or bf16 stored as uint16, as f32.
template <bool BF16>
__device__ __forceinline__ float ld(const void* __restrict__ t, size_t i) {
  if (BF16) return __uint_as_float(static_cast<uint32_t>(static_cast<const uint16_t*>(t)[i]) << 16);
  return static_cast<const float*>(t)[i];
}

template <int NQ, int MODE, bool BF16>
__global__ void __launch_bounds__(THREADS)
sddmm_kernel(const void* __restrict__ zr, const void* __restrict__ zc,
             const void* __restrict__ rel, const void* __restrict__ glb,
             const int32_t* __restrict__ ks, const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols, float* __restrict__ out,
             long long num_edges, int d, int n_r, int n_c, int n_k) {
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;
  const long long stride = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long e = first; e < num_edges; e += stride) {
    const int r = rows[e], c = cols[e];
    const int k = MODE == INNERPRODUCT ? 0 : ks[e];
    const bool in_range = r >= 0 && r < n_r && c >= 0 && c < n_c &&
                          (MODE == INNERPRODUCT || (k >= 0 && k < n_k));
    if (!in_range) {  // uniform across the warp
      if (lane == 0) out[e] = NAN;
      continue;
    }
    float left[NQ], right[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int a = lane + 32 * q;
      left[q] = a < d ? ld<BF16>(zr, static_cast<size_t>(r) * d + a) : 0.f;
      right[q] = a < d ? ld<BF16>(zc, static_cast<size_t>(c) * d + a) : 0.f;
    }
    if (MODE == DISTMULT || MODE == DEDICOM) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int a = lane + 32 * q;
        const float g = a < d ? ld<BF16>(rel, static_cast<size_t>(k) * d + a) : 0.f;
        left[q] *= g;
        if (MODE == DEDICOM) right[q] *= g;
        if (MODE == DEDICOM && BF16) left[q] = __bfloat162float(__float2bfloat16_rn(left[q]));
      }
    }
    if (MODE == DEDICOM || MODE == BILINEAR) {
      const void* m = MODE == DEDICOM ? glb : rel;
      const size_t m0 = MODE == DEDICOM ? 0 : static_cast<size_t>(k) * d * d;
      float prod[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) prod[q] = 0.f;
#pragma unroll
      for (int qa = 0; qa < NQ; ++qa) {
        for (int src = 0; src < 32; ++src) {
          const int a = src + 32 * qa;
          if (a >= d) break;  // uniform across the warp
          const float va = __shfl_sync(FULL, left[qa], src);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            const int b = lane + 32 * q;
            if (b < d) prod[q] += va * ld<BF16>(m, m0 + static_cast<size_t>(a) * d + b);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < NQ; ++q) left[q] = prod[q];
    }
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc += left[q] * right[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
    if (lane == 0) out[e] = acc;
  }
}

template <int NQ, bool BF16>
bool launch_mode(int mode, dim3 grid, cudaStream_t s, const void* zr,
                 const void* zc, const void* rel, const void* glb,
                 const int32_t* ks, const int32_t* rows, const int32_t* cols,
                 float* out, long long b, int d, int n_r, int n_c, int n_k) {
#define DT_LAUNCH(M)                                                      \
  sddmm_kernel<NQ, M, BF16><<<grid, THREADS, 0, s>>>(zr, zc, rel, glb, ks, rows, \
                                               cols, out, b, d, n_r, n_c, n_k)
  switch (mode) {
    case INNERPRODUCT: DT_LAUNCH(INNERPRODUCT); return true;
    case DISTMULT: DT_LAUNCH(DISTMULT); return true;
    case DEDICOM: DT_LAUNCH(DEDICOM); return true;
    case BILINEAR: DT_LAUNCH(BILINEAR); return true;
    default: return false;
  }
#undef DT_LAUNCH
}

}  // namespace

extern "C" {

// mode: 0 innerproduct, 1 distmult, 2 dedicom, 3 bilinear.  zr [n_r, d],
// zc [n_c, d], rel [n_k, d] (distmult, dedicom) or [n_k, d, d] (bilinear),
// glb [d, d] (dedicom), all f32 (bf16 = 0) or all bf16 (bf16 = 1);
// ks/rows/cols int32 [B]; out f32 [B].  Pointers a mode does not read may
// be null.
int dt_sddmm(int mode, int bf16, const void* zr, const void* zc, const void* rel,
             const void* glb, const void* ks, const void* rows,
             const void* cols, void* out, long long num_edges, int d, int n_r,
             int n_c, int n_k, void* stream) {
  if (d < 1 || d > 128 || num_edges < 0) return cudaErrorInvalidValue;
  if (num_edges == 0) return cudaSuccess;
  const long long warps_per_block = THREADS / 32;
  long long blocks = (num_edges + warps_per_block - 1) / warps_per_block;
  if (blocks > 132 * 64) blocks = 132 * 64;
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* iks = static_cast<const int32_t*>(ks);
  const auto* irows = static_cast<const int32_t*>(rows);
  const auto* icols = static_cast<const int32_t*>(cols);
  auto* fout = static_cast<float*>(out);
  bool ok = false;
#define DT_MODE(NQ)                                                              \
  ok = bf16 ? launch_mode<NQ, true>(mode, grid, s, zr, zc, rel, glb, iks, irows, \
                                    icols, fout, num_edges, d, n_r, n_c, n_k)    \
            : launch_mode<NQ, false>(mode, grid, s, zr, zc, rel, glb, iks, irows,\
                                     icols, fout, num_edges, d, n_r, n_c, n_k)
  switch ((d + 31) / 32) {
    case 1: DT_MODE(1); break;
    case 2: DT_MODE(2); break;
    case 3: DT_MODE(3); break;
    case 4: DT_MODE(4); break;
  }
#undef DT_MODE
  if (!ok) return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
