// Column sums of a mask stack: the raw read rate of the int8 masks, for
// Hopper (sm_90a).
//
// Replaces the TPU probe scripts/probe_int8_bw.py::pallas_sum (its kernel,
// called through pl.pallas_call).  For x [K, n1, n2] and kb relations per
// block it computes
//
//   out[0, c] = sum_{k < kb * floor(K / kb)} sum_i f32(x[k, i, c])
//
// with x int8, int8 rounded through bf16 first ("conv"), or bf16.  The
// relations past the last whole group of kb are not read, as in the TPU
// probe's grid of K // kb steps.
//
// Bound on this card: bytes.  Each element is read once (400 MB for the
// paper's [964, 645, 645] int8 stack) for one addition.
//
// Design.  A block owns kb whole relations, one contiguous range of
// memory, and reads it as 16-byte vectors from the first 16-byte boundary
// on.  The range is cut into tiles of n2 vectors (16 rows of int8, 8 of
// bf16): vector t of every tile covers the same 16 (or 8) columns, so a
// thread keeps the column sums of its vectors in registers, with the loads
// of four tiles in flight at a time.  int8 bytes are biased by 128 and
// added as two 16-bit lanes of a 32-bit register (a few integer
// instructions a word, no conversions), flushed to shared memory every 256
// tiles before a lane can overflow; bf16 widens by a shift.  The elements
// before the first boundary and after the last whole tile (up to a tile,
// 10 KB at the paper's rows) are read one by one.  The column sums are small
// integers, exact in f32 while every partial stays below 2^24, so the
// order of the shared atomics does not change a bit; a second pass adds
// the blocks' partial rows in block order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 3;                   // vectors of a tile per thread
constexpr int MAX_N2 = THREADS * SLOTS;    // 768: the padded stack's rows
constexpr int FLUSH = 256;                 // int8 tiles between flushes
constexpr int UNROLL = 4;                  // tiles whose loads are in flight together

enum Kind { INT8 = 0, INT8_CONV = 1, BF16 = 2 };

template <int KIND>
__device__ __forceinline__ float scalar_value(const unsigned char* x, long long e) {
  if (KIND == BF16) {
    const unsigned short bits = reinterpret_cast<const unsigned short*>(x)[e];
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
  const float v = static_cast<float>(reinterpret_cast<const int8_t*>(x)[e]);
  if (KIND == INT8_CONV) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// The column of element j of a vector whose first element is in column cb.
__device__ __forceinline__ int column(int cb, int j, int n2) { return (cb + j) % n2; }

// Adds one 16-byte vector to a thread's sums of one slot.  int8: lo[w]
// holds bytes 4w and 4w+2 as the 16-bit lanes of a register, hi[w] bytes
// 4w+1 and 4w+3, each byte biased by 128 (so 256 vectors fit a lane);
// conv and bf16: acc[j] is element j's f32 sum.
template <int KIND, int V>
__device__ __forceinline__ void add_vector(const uint4& v, unsigned* lo, unsigned* hi,
                                           float* acc) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    if (KIND == INT8) {
      const unsigned b = words[w] ^ 0x80808080u;
      lo[w] += b & 0x00FF00FFu;
      hi[w] += (b >> 8) & 0x00FF00FFu;
    } else if (KIND == BF16) {
      acc[2 * w] += __uint_as_float(words[w] << 16);
      acc[2 * w + 1] += __uint_as_float(words[w] & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float f = static_cast<float>(static_cast<int8_t>(words[w] >> (8 * q)));
        acc[4 * w + q] += __bfloat162float(__float2bfloat16_rn(f));
      }
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 2)
column_sum_kernel(const unsigned char* __restrict__ x, float* __restrict__ partial,
                  long long plane, int n2, int kb) {
  constexpr int ES = KIND == BF16 ? 2 : 1;  // bytes an element
  constexpr int V = 16 / ES;                // elements a vector
  __shared__ float colsum[MAX_N2];
  const int tid = threadIdx.x;
  for (int c = tid; c < n2; c += THREADS) colsum[c] = 0.f;
  __syncthreads();

  const long long s = static_cast<long long>(blockIdx.x) * kb * plane;  // first element
  const long long count = static_cast<long long>(kb) * plane;
  const uintptr_t start = reinterpret_cast<uintptr_t>(x) + static_cast<uintptr_t>(s) * ES;
  const int delta = static_cast<int>(((16 - (start & 15)) & 15) / ES);
  const long long body = count - delta;
  const long long ntiles = body > 0 ? body / n2 / V : 0;
  const long long done = delta + ntiles * n2 * V;  // elements the vectors cover, with the head

  // Head and tail, element by element.  s is a multiple of n2, so the
  // column of element s + e is e % n2.
  const long long head = delta < count ? delta : count;
  for (long long e = tid; e < head; e += THREADS)
    atomicAdd(&colsum[e % n2], scalar_value<KIND>(x, s + e));
  for (long long e = done + tid; e < count; e += THREADS)
    atomicAdd(&colsum[e % n2], scalar_value<KIND>(x, s + e));

  int cb[SLOTS];
  bool live[SLOTS];
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
    const int t = tid + sl * THREADS;
    live[sl] = t < n2;
    cb[sl] = live[sl] ? (delta + t * V) % n2 : 0;
  }
  const uint4* vec = reinterpret_cast<const uint4*>(x + (s + delta) * ES);

  unsigned lo[SLOTS][4], hi[SLOTS][4];  // int8: see add_vector
  float acc[SLOTS][V];                  // conv, bf16
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
#pragma unroll
    for (int w = 0; w < 4; ++w) lo[sl][w] = hi[sl][w] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[sl][j] = 0.f;
  }
  for (long long g0 = 0; g0 < ntiles; g0 += FLUSH) {
    const long long g1 = g0 + FLUSH < ntiles ? g0 + FLUSH : ntiles;
    for (long long g = g0; g < g1; g += UNROLL) {
      const int nu = g1 - g < UNROLL ? static_cast<int>(g1 - g) : UNROLL;
      uint4 v[UNROLL][SLOTS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl)
          if (live[sl] && u < nu) v[u][sl] = __ldg(vec + (g + u) * n2 + tid + sl * THREADS);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int sl = 0; sl < SLOTS; ++sl)
          if (live[sl] && u < nu) add_vector<KIND, V>(v[u][sl], lo[sl], hi[sl], acc[sl]);
    }
    if (KIND == INT8) {
      const int bias = 128 * static_cast<int>(g1 - g0);
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        if (!live[sl]) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int b0 = static_cast<int>(lo[sl][w] & 0xFFFFu) - bias;
          const int b2 = static_cast<int>(lo[sl][w] >> 16) - bias;
          const int b1 = static_cast<int>(hi[sl][w] & 0xFFFFu) - bias;
          const int b3 = static_cast<int>(hi[sl][w] >> 16) - bias;
          atomicAdd(&colsum[column(cb[sl], 4 * w, n2)], static_cast<float>(b0));
          atomicAdd(&colsum[column(cb[sl], 4 * w + 1, n2)], static_cast<float>(b1));
          atomicAdd(&colsum[column(cb[sl], 4 * w + 2, n2)], static_cast<float>(b2));
          atomicAdd(&colsum[column(cb[sl], 4 * w + 3, n2)], static_cast<float>(b3));
          lo[sl][w] = hi[sl][w] = 0u;
        }
      }
    }
  }
  if (KIND != INT8) {
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      if (!live[sl]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) atomicAdd(&colsum[column(cb[sl], j, n2)], acc[sl][j]);
    }
  }
  __syncthreads();
  float* dst = partial + static_cast<size_t>(blockIdx.x) * n2;
  for (int c = tid; c < n2; c += THREADS) dst[c] = colsum[c];
}

// out[c] = sum over blocks of partial[b, c], in block order.
__global__ void sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                int rows, int n2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n2) return;
  float acc = 0.f;
  for (int b = 0; b < rows; ++b) acc += partial[static_cast<size_t>(b) * n2 + c];
  out[c] = acc;
}

}  // namespace

extern "C" {

// x [K, n1, n2] (16-byte aligned): int8 (kind 0), int8 through bf16
// (kind 1) or bf16 (kind 2); plane = n1 * n2; groups = K / kb blocks of kb
// relations; partial f32 [groups, n2] scratch; out f32 [1, n2].
int dt_probe_column_sum(const void* x, int kind, long long plane, int n2, int groups,
                        int kb, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n2 < 1 || n2 > MAX_N2 || plane < n2 || plane % n2 != 0 || groups < 1 || kb < 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || kind < 0 || kind > 2)
    return cudaErrorInvalidValue;
  const unsigned char* xb = static_cast<const unsigned char*>(x);
  float* part = static_cast<float*>(partial);
  if (kind == INT8)
    column_sum_kernel<INT8><<<groups, THREADS, 0, s>>>(xb, part, plane, n2, kb);
  else if (kind == INT8_CONV)
    column_sum_kernel<INT8_CONV><<<groups, THREADS, 0, s>>>(xb, part, plane, n2, kb);
  else
    column_sum_kernel<BF16><<<groups, THREADS, 0, s>>>(xb, part, plane, n2, kb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_rows_kernel<<<(n2 + 255) / 256, 256, 0, s>>>(part, static_cast<float*>(out), groups, n2);
  return cudaGetLastError();
}

}  // extern "C"
