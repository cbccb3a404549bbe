// Sparse multi-relational aggregation (K6) for Hopper (sm_90a).
//
// Replaces the TPU kernel decagon_tpu/ops/spmm_pallas.py::_spmm_kernel
// (spmm_tiled).  For a destination-sorted CSR (decagon_tpu_torch/ops/
// tiling.py) it computes
//
//   out[d, :] = sum_{e in row d, ascending source} val[e] * P[col[e], :]
//
// over the flattened source table P [n_src, H], with f32 sums.  The
// backward of the aggregation is this kernel over the transposed layout.
//
// Precision, as the JAX package computes it on the CPU:
//   "highest": P and val f32;
//   "default": P is bf16 (the wrapper casts it once per call, halving the
//   gather bytes) and val is rounded to bf16 here; each product of two
//   bf16 values is exact in f32, and the sums are f32.  On a TPU the
//   kernel's second MXU product at DEFAULT precision would also round each
//   message to bf16; the CPU reference does not, and neither does this.
// Each message is rounded on its own (__fmul_rn) and added in edge order
// (__fadd_rn), as the plain version's gather and index_add_ do, so nvcc
// contracts nothing into an FMA.
//
// The TPU kernel turns the gather into one-hot MXU products over packed
// tiles with dynamic source windows; here a warp reads the rows directly.
//
// Bound on this card: memory.  The least traffic is the layout (8 bytes an
// edge), each distinct source row once, and the output; the gathers that
// miss the 50 MB L2 read a source row again per edge.
//
// Design.  The paper graph's rows are very uneven (645 rows of ~13,000
// edges in the drug-drug forward, 1.24M rows of ~7 in its backward), so
// rows are cut on the host into segments of at most 256 edges.  Pass 1:
// one warp per (segment, column slice); the lanes load 32 (col, val) pairs
// at a time, coalesced, and broadcast them with shuffles; each lane holds
// VEC adjacent columns and gathers them as one 4-, 8- or 16-byte load, 8
// edges' loads in flight before their adds.  A row's only segment writes
// the output row; otherwise the segment writes a partial.  Pass 2: one
// warp per multi-segment row adds its partials in segment order.  No
// atomics: two calls give equal bits.  An edge whose source lies outside
// [0, n_src) makes its row NaN instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 8;
constexpr unsigned FULL = 0xffffffffu;

// VEC adjacent elements of p from element `offset`, as f32.
template <bool BF16, int VEC>
__device__ __forceinline__ void load_row(const void* p, size_t offset, float* x) {
  if (BF16) {
    const uint16_t* q = static_cast<const uint16_t*>(p) + offset;
    if (VEC == 1) {
      x[0] = __uint_as_float(static_cast<uint32_t>(__ldg(q)) << 16);
    } else if (VEC == 2) {
      const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(q));
      x[0] = __uint_as_float(w << 16);
      x[1] = __uint_as_float(w & 0xffff0000u);
    } else {
      const uint2 w = __ldg(reinterpret_cast<const uint2*>(q));
      x[0] = __uint_as_float(w.x << 16);
      x[1] = __uint_as_float(w.x & 0xffff0000u);
      x[2] = __uint_as_float(w.y << 16);
      x[3] = __uint_as_float(w.y & 0xffff0000u);
    }
  } else {
    const float* q = static_cast<const float*>(p) + offset;
    if (VEC == 1) {
      x[0] = __ldg(q);
    } else if (VEC == 2) {
      const float2 w = __ldg(reinterpret_cast<const float2*>(q));
      x[0] = w.x;
      x[1] = w.y;
    } else {
      const float4 w = __ldg(reinterpret_cast<const float4*>(q));
      x[0] = w.x;
      x[1] = w.y;
      x[2] = w.z;
      x[3] = w.w;
    }
  }
}

template <bool BF16, int VEC>
__global__ void __launch_bounds__(THREADS)
spmm_segments(const void* __restrict__ p, const int32_t* __restrict__ col,
              const float* __restrict__ val, const int32_t* __restrict__ seg_ptr,
              const int32_t* __restrict__ seg_row, const int32_t* __restrict__ seg_slot,
              float* __restrict__ partial, float* __restrict__ out,
              int num_segments, int n_src, int h) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= num_segments) return;  // uniform across the warp
  const int c0 = (blockIdx.y * 32 + lane) * VEC;
  const bool active = c0 < h;  // h % VEC == 0 when VEC > 1
  const int lo = seg_ptr[s], hi = seg_ptr[s + 1];
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  bool bad = false;
  for (int base = lo; base < hi; base += 32) {
    const int n = min(32, hi - base);
    int my_c = 0;
    float my_v = 0.f;
    if (lane < n) {
      my_c = col[base + lane];
      my_v = val[base + lane];
      if (BF16) my_v = __bfloat162float(__float2bfloat16_rn(my_v));
    }
    int j = 0;
    for (; j + UNROLL <= n; j += UNROLL) {
      float x[UNROLL][VEC], v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int c = __shfl_sync(FULL, my_c, j + u);
        v[u] = __shfl_sync(FULL, my_v, j + u);
        const bool ok = static_cast<unsigned>(c) < static_cast<unsigned>(n_src);
        bad |= !ok;
        if (active && ok) {
          load_row<BF16, VEC>(p, static_cast<size_t>(c) * h + c0, x[u]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) x[u][q] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(v[u], x[u][q]));
      }
    }
    for (; j < n; ++j) {
      const int c = __shfl_sync(FULL, my_c, j);
      const float vj = __shfl_sync(FULL, my_v, j);
      const bool ok = static_cast<unsigned>(c) < static_cast<unsigned>(n_src);
      bad |= !ok;
      if (active && ok) {
        float x[VEC];
        load_row<BF16, VEC>(p, static_cast<size_t>(c) * h + c0, x);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], __fmul_rn(vj, x[q]));
      }
    }
  }
  if (!active) return;
  const int slot = seg_slot[s];
  float* dst = slot < 0 ? out + static_cast<size_t>(seg_row[s]) * h
                        : partial + static_cast<size_t>(slot) * h;
#pragma unroll
  for (int q = 0; q < VEC; ++q) dst[c0 + q] = bad ? NAN : acc[q];
}

__global__ void __launch_bounds__(THREADS)
spmm_reduce(const float* __restrict__ partial, const int32_t* __restrict__ multi_row,
            const int32_t* __restrict__ multi_ptr, float* __restrict__ out,
            int num_multi, int h) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (m >= num_multi) return;
  const int first = multi_ptr[m], last = multi_ptr[m + 1];
  float* row = out + static_cast<size_t>(multi_row[m]) * h;
  for (int c = lane; c < h; c += 32) {
    float acc = 0.f;
    for (int t = first; t < last; ++t) acc = __fadd_rn(acc, partial[static_cast<size_t>(t) * h + c]);
    row[c] = acc;
  }
}

template <bool BF16>
void launch_segments(int vec, dim3 grid, cudaStream_t stream, const void* p,
                     const int32_t* col, const float* val, const int32_t* seg_ptr,
                     const int32_t* seg_row, const int32_t* seg_slot, float* partial,
                     float* out, int num_segments, int n_src, int h) {
  if (vec == 4) {
    spmm_segments<BF16, 4><<<grid, THREADS, 0, stream>>>(
        p, col, val, seg_ptr, seg_row, seg_slot, partial, out, num_segments, n_src, h);
  } else if (vec == 2) {
    spmm_segments<BF16, 2><<<grid, THREADS, 0, stream>>>(
        p, col, val, seg_ptr, seg_row, seg_slot, partial, out, num_segments, n_src, h);
  } else {
    spmm_segments<BF16, 1><<<grid, THREADS, 0, stream>>>(
        p, col, val, seg_ptr, seg_row, seg_slot, partial, out, num_segments, n_src, h);
  }
}

}  // namespace

extern "C" {

// p [n_src, h] f32 (bf16 = 0) or bf16 (bf16 = 1, stored as uint16);
// col int32 / val f32 [E]; seg_ptr [S + 1], seg_row [S], seg_slot [S],
// multi_row [M], multi_ptr [M + 1] int32 (ops/tiling.py); partial f32
// [slots, h] (unused when M == 0); out f32 [n_dst, h].  vec (1, 2 or 4)
// elements per lane: h % vec == 0 and p aligned to vec elements.
int dt_spmm_tiled(const void* p, int bf16, const void* col, const void* val,
                  const void* seg_ptr, const void* seg_row, const void* seg_slot,
                  const void* multi_row, const void* multi_ptr, void* partial,
                  void* out, int num_segments, int num_multi, int n_src, int h,
                  int vec, void* stream) {
  if (h < 1 || num_segments < 0 || num_multi < 0 || n_src < 0) return cudaErrorInvalidValue;
  if (!(vec == 1 || vec == 2 || vec == 4) || h % vec != 0) return cudaErrorInvalidValue;
  if (num_segments == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* icol = static_cast<const int32_t*>(col);
  const auto* fval = static_cast<const float*>(val);
  const auto* iseg = static_cast<const int32_t*>(seg_ptr);
  const auto* irow = static_cast<const int32_t*>(seg_row);
  const auto* islot = static_cast<const int32_t*>(seg_slot);
  auto* fpart = static_cast<float*>(partial);
  auto* fout = static_cast<float*>(out);
  const int slices = (h + 32 * vec - 1) / (32 * vec);
  const dim3 grid((num_segments + WARPS - 1) / WARPS, slices);
  if (bf16) {
    launch_segments<true>(vec, grid, s, p, icol, fval, iseg, irow, islot, fpart, fout,
                          num_segments, n_src, h);
  } else {
    launch_segments<false>(vec, grid, s, p, icol, fval, iseg, irow, islot, fpart, fout,
                           num_segments, n_src, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_multi == 0) return err;
  spmm_reduce<<<(num_multi + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      fpart, static_cast<const int32_t*>(multi_row), static_cast<const int32_t*>(multi_ptr),
      fout, num_multi, h);
  return cudaGetLastError();
}

}  // extern "C"
