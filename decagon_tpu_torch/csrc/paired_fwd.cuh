// The paired forward's sweep kernel (K1/K2, K1/K2-ds): its epilogue,
// which applies a_e / a_o per node in registers at each relation's end,
// and the block's end, where the two halves' totals meet in shared memory
// and the block writes its partial.  ``paired_fwd.cu`` instantiates it on
// the whole sweep (``WholeSweep``), and the epilogue and the block's end
// for the probe P1 (node-major operands, bf16 row scales);
// ``probe_paired_sweep.cu`` the kernel on the sweep's parts.
// ``paired_fwd.cu``'s header comment gives the contracts.

#pragma once

#include "paired_core.cuh"

namespace {

using namespace paired;

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

template <class Sweeper>
__global__ void __launch_bounds__(THREADS, 2)
paired_fwd_kernel(const int8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ partial, int K, int N,
                  int H, int Hq, int rel_splits, int con_splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t half_q = static_cast<size_t>(K) * Hq * ((N + TK - 1) / TK * TK);
  const Sweep s = block_sweep(mask, K, N, Hq, q, q + half_q, rel_splits, con_splits);
  FwdEpilogue<ScaleRows> epi{{scales, N}, N, s.n0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi.total[j][e] = 0.f;
  Sweeper::run(s, epi, smem);
  store_partial(epi, s, partial + static_cast<size_t>(blockIdx.y) * N * H, N, H, smem);
}

// The sweep of the main path.
struct WholeSweep {
  template <class Epi>
  __device__ __forceinline__ static void run(const Sweep& s, Epi& epi, unsigned char* smem) {
    sweep(s, epi, smem);
  }
};

// Launch the sweep kernel ``kernel`` (an instantiation of
// paired_fwd_kernel) on the grid of (rel_splits, con_splits).
inline cudaError_t sweep_launch(void (*kernel)(const int8_t*, const __nv_bfloat16*,
                                               const float*, float*, int, int, int, int, int,
                                               int),
                                const void* mask, const __nv_bfloat16* q, const float* scales,
                                float* partial, int K, int N, int H, int rel_splits,
                                int con_splits, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TM - 1) / TM, rel_splits * con_splits, (H + HS - 1) / HS);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(static_cast<const int8_t*>(mask), q, scales,
                                                partial, K, N, H, (H + 15) / 16 * 16,
                                                rel_splits, con_splits);
  return cudaGetLastError();
}

}  // namespace
