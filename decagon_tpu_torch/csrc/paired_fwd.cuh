// The paired forward's sweep kernel (K1/K2, K1/K2-ds): its operand pass,
// its epilogue, which applies a_e / a_o per node in registers at each
// relation's end, and the block's end, where the two halves' totals meet
// in shared memory and the block writes its partial.  ``paired_fwd.cu``
// instantiates it for the main path and the epilogue and the block's end
// for the probe P1 (node-major operands, bf16 row scales);
// ``probe_paired.cu`` (P2, P3) and ``probe_paired_sweep.cu`` the kernel on
// other parts policies and row scales.  ``paired_fwd.cu``'s header
// comment gives the contracts.

#pragma once

#include "paired_core.cuh"

namespace {

using namespace paired;

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// q[t][k][h][j] = bf16((p4[t,k,h,j] * ds[k,t,j]) * scales[k,2+t,j]) for
// h < H and j < N, else 0 (``UNIT``: no column scales, bf16(p4 * ds) or,
// for a bf16 p4 without ds, p4 itself).  Grid: x walks the 2 K Hq rows, y
// the row's 16-byte groups of eight columns.
template <typename P, bool UNIT = false>
__global__ void fwd_operands_kernel(const P* __restrict__ p4, const float* __restrict__ scales,
                                    const float* __restrict__ ds,
                                    __nv_bfloat16* __restrict__ q, int K, int N, int H, int Hq,
                                    int Npad) {
  const int row = blockIdx.x;  // (t * K + k) * Hq + h
  const int h = row % Hq, tk = row / Hq, k = tk % K, t = tk / K;
  const int j0 = 8 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (j0 >= Npad) return;
  const P* src = p4 + (static_cast<size_t>(tk) * H + h) * N;
  const float* b = UNIT ? nullptr : scales + (static_cast<size_t>(k) * 4 + 2 + t) * N;
  const float* d = ds == nullptr ? nullptr : ds + (static_cast<size_t>(k) * 2 + t) * N;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = j0 + e;
    float f = 0.f;
    if (h < H && j < N) {
      f = as_f32(src[j]);
      if (d != nullptr) f *= d[j];
      if constexpr (!UNIT) f *= b[j];
    }
    v[e] = __float2bfloat16_rn(f);
  }
  *reinterpret_cast<uint4*>(q + static_cast<size_t>(row) * Npad + j0) =
      *reinterpret_cast<const uint4*>(v);
}

// Launch the operand pass on p4 [2, K, H, N] (f32, or bf16 when p_is_bf16).
template <bool UNIT = false>
inline void operand_pass(const void* p4, int p_is_bf16, const float* scales, const float* ds,
                         __nv_bfloat16* q, int K, int N, int H, int Hq, int Npad,
                         cudaStream_t st) {
  const dim3 pass(static_cast<unsigned>(2LL * K * Hq), (Npad / 8 + 127) / 128);
  if (p_is_bf16)
    fwd_operands_kernel<__nv_bfloat16, UNIT><<<pass, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(p4), scales, ds, q, K, N, H, Hq, Npad);
  else
    fwd_operands_kernel<float, UNIT><<<pass, 128, 0, st>>>(static_cast<const float*>(p4),
                                                           scales, ds, q, K, N, H, Hq, Npad);
}

// K1/K2's row scales: a_e (half 0) or a_o (half 1) of node n in relation
// k, the f32 rows 0 and 1 of scales [K, 4, N].
struct ScaleRows {
  const float* scales;
  int N;
  __device__ __forceinline__ float operator()(int k, int half, int n) const {
    return scales[(static_cast<size_t>(k) * 4 + half) * N + n];
  }
};

template <class Scales>
struct FwdEpilogue {
  Scales scale;
  int N, n0;
  float total[8][4];

  __device__ __forceinline__ void relation(int k, int half, int rg, int lane,
                                           const float (&acc)[8][4]) {
    const int n = n0 + 16 * rg + (lane >> 2);
    const float lo = n < N ? scale(k, half, n) : 0.f;
    const float hi = n + 8 < N ? scale(k, half, n + 8) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      total[j][0] += lo * acc[j][0];
      total[j][1] += lo * acc[j][1];
      total[j][2] += hi * acc[j][2];
      total[j][3] += hi * acc[j][3];
    }
  }
};

// The block's end: the transposed half's totals meet the direct half's in
// shared memory (free once the sweep has returned), and the direct half
// writes the block's piece of its partial dst [N, H].
template <class Epi>
__device__ __forceinline__ void store_partial(const Epi& epi, const Sweep& s, float* dst,
                                              int N, int H, unsigned char* smem) {
  constexpr int LDR = HS + 4;
  float* red = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp >> 2, rg = warp & 3;
  const int r = 16 * rg + (lane >> 2), c = 2 * (lane & 3);
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(red + r * LDR + 8 * j + c) =
          make_float2(epi.total[j][0], epi.total[j][1]);
      *reinterpret_cast<float2*>(red + (r + 8) * LDR + 8 * j + c) =
          make_float2(epi.total[j][2], epi.total[j][3]);
    }
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + (e >> 1) * 8, cc = 8 * j + c + (e & 1);
      const int n = s.n0 + rr, h = s.h0 + cc;
      if (n < N && h < H)
        dst[static_cast<size_t>(n) * H + h] = epi.total[j][e] + red[rr * LDR + cc];
    }
  }
}

// The forward's sweep kernel on the parts policy ``P`` with the row scales
// ``Scales``: K1/K2 is ``paired_fwd_kernel<>``.  Under ``P::SINK`` the
// sweep's folded words are stored only where ``scales`` is given, which no
// caller of a sinking policy does.
template <class P = Parts, class Scales = ScaleRows>
__global__ void __launch_bounds__(THREADS, 2)
paired_fwd_kernel(const int8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ partial, int K, int N,
                  int H, int Hq, int rel_splits, int con_splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t half_q = static_cast<size_t>(K) * Hq * ((N + TK - 1) / TK * TK);
  const Sweep s = block_sweep(reinterpret_cast<const typename P::Mask*>(mask), K, N, Hq, q,
                              q + half_q, rel_splits, con_splits);
  FwdEpilogue<Scales> epi{{scales, N}, N, s.n0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi.total[j][e] = 0.f;
  const uint32_t sink = sweep<Operands::PLANES, P>(s, epi, smem);
  store_partial(epi, s, partial + static_cast<size_t>(blockIdx.y) * N * H, N, H, smem);
  if constexpr (P::SINK) {
    if (scales != nullptr) partial[threadIdx.x] = __uint_as_float(sink);
  }
}

// Launch the sweep kernel ``kernel`` (an instantiation of
// paired_fwd_kernel on the policy ``P``) on the grid of (rel_splits,
// con_splits).
template <class P = Parts>
inline cudaError_t sweep_launch(void (*kernel)(const int8_t*, const __nv_bfloat16*,
                                               const float*, float*, int, int, int, int, int,
                                               int),
                                const void* mask, const __nv_bfloat16* q, const float* scales,
                                float* partial, int K, int N, int H, int rel_splits,
                                int con_splits, cudaStream_t stream) {
  constexpr int smem = Layout<P>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TM - 1) / TM, rel_splits * con_splits, (H + HS - 1) / HS);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const int8_t*>(mask), q, scales, partial,
                                          K, N, H, (H + 15) / 16 * 16, rel_splits, con_splits);
  return cudaGetLastError();
}

}  // namespace
