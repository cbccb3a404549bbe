// Column sums of a mask stack: the raw read rate of the int8 masks, for
// Hopper (sm_90a).
//
// Replaces the TPU probe scripts/probe_int8_bw.py::pallas_sum (its kernel,
// called through pl.pallas_call).  For x [K, n1, n2] and kb relations per
// TPU block it computes
//
//   out[0, c] = sum_{k < kb * floor(K / kb)} sum_i f32(x[k, i, c])
//
// with x int8, int8 through bf16 ("conv"), or bf16.  The relations past
// the last whole group of kb are not read, as in the TPU probe's grid of
// K // kb steps.  On this card kb decides only how many relations are read.
//
// Bound on this card: bytes.  Each element is read once (400 MB for the
// paper's [964, 645, 645] int8 stack) for one addition.
//
// Design: a streaming reduction sized to the card.
//
// - The stream.  The used relations are one run of used * n1 * n2
//   elements, 16-byte aligned at its start.  It is cut into tiles of n2
//   16-byte vectors (16 rows of int8, 8 of bf16); element e lies in column
//   e % n2, so vector t of every tile covers the same 16 (or 8) columns,
//   and a thread keeps its vectors' sums in registers from tile to tile,
//   whichever tiles it reads.  Only the last tile may be partial: its
//   vectors past the end read as zeros, the one vector that straddles the
//   end byte by byte.
// - The grid.  SMs x resident blocks a SM (the wrapper reads both from the
//   card once): every block streams at once and none waits for a second
//   wave.  Block b reads tiles b, b + gridDim.x, ... (counts equal within
//   one), so the blocks' loads at any moment fall in one window of the
//   stream a few MB wide, as a grid-stride read's do (one contiguous run a
//   block was no faster).  A thread owns up to three vectors of a tile
//   (rows of up to 768 elements).
// - Bytes in flight.  The loads are software-pipelined: a thread issues
//   its vectors of the tile AHEAD steps on before it adds the current one's,
//   from a register ring, with no L1 allocation and 256-byte L2 fetches.
//   int8 and conv run 2 blocks of 256 threads an SM, bf16 3 (its sums need
//   fewer registers): ~41-62 KB in flight an SM.  Three tiles ahead, or a
//   ring of cp.async.bulk stages in shared memory fed by one producer
//   thread, were not faster on the int8 stream.  Such a ring must fence
//   the async proxy (fence.proxy.async.shared::cta) before a stage that
//   threads read is released to the next bulk copy.
// - The additions.  int8 bytes are biased by 128 and added as two 16-bit
//   lanes of a 32-bit register (no conversion), flushed to the block's
//   integer sums every 256 tiles, before a lane can overflow.  conv runs
//   the paired sweep's own int8 -> bf16 conversion (paired_core.cuh's
//   s8x4_to_bf16, exact) and widens the bf16 words by shift and mask, as
//   bf16 does, into f32 sums.
// - One launch.  A block folds its sums at the tile's n2 * V positions into
//   columns in a fixed order and writes its partial row.  The blocks are
//   combined in groups of group = ceil(sqrt(gridDim.x)): the last block of
//   each group to finish (an acquire-release counter) adds the group's rows
//   in block order into a group row, and the last group to finish adds the
//   group rows in group order into out, each with one batch of loads.  Each
//   resets its counter, so the counters are zero again on exit (the
//   wrapper zeroes fresh ones for every call all the same).  The column
//   sums are small integers, exact in f32 while every partial stays below
//   2^24, and the order is fixed besides: two calls give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paired_core.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SLOTS = 3;                 // vectors of a tile per thread
constexpr int MAX_N2 = THREADS * SLOTS;  // 768: the padded stack's rows
constexpr int FLUSH = 256;               // int8 tiles a 16-bit lane holds: 256 * 255 < 2^16
constexpr int AHEAD = 2;                 // tiles in flight while a thread adds one
constexpr int BATCH = 20;                // partial rows whose loads a combine issues at once

enum Kind { INT8 = 0, INT8_CONV = 1, BF16 = 2 };

// f32 of the two bf16 of a word, added to acc[0] (low half) and acc[1].
__device__ __forceinline__ void add_bf16x2(unsigned h, float* acc) {
  acc[0] += __uint_as_float(h << 16);
  acc[1] += __uint_as_float(h & 0xFFFF0000u);
}

// Adds one 16-byte vector to a thread's sums of one slot.  int8: lo[w]
// holds bytes 4w and 4w+2 as the 16-bit lanes of a register, hi[w] bytes
// 4w+1 and 4w+3, each byte biased by 128; conv and bf16: acc[j] is
// element j's f32 sum.
template <int KIND>
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
      add_bf16x2(words[w], acc + 2 * w);
    } else {
      const uint2 h = paired::s8x4_to_bf16(words[w]);
      add_bf16x2(h.x, acc + 4 * w);
      add_bf16x2(h.y, acc + 4 * w + 2);
    }
  }
}

// A 16-byte vector of the stream: read once, so not kept in L1; L2 fetches
// 256-byte blocks around it.
__device__ __forceinline__ uint4 load(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The first nbytes (< 16) bytes at p as a vector, the rest zero.
__device__ __forceinline__ uint4 load_head(const unsigned char* p, int nbytes) {
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (i < nbytes) w[i >> 2] |= static_cast<unsigned>(p[i]) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Whether this block is the last of ``members`` to arrive at *counter.
// After the barrier, thread 0's acquire-release add orders the block's
// writes before its arrival and the others' writes before what the last
// block reads (a release is cumulative); the last one resets the counter.
__device__ __forceinline__ bool arrive_last(unsigned* counter, unsigned members) {
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    unsigned before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before) : "l"(counter) : "memory");
    last = before == members - 1;
    if (last) *counter = 0u;
  }
  return __syncthreads_or(last) != 0;
}

// dst[c] = sum over r < rows of src[r, c], in row order.  A thread's loads
// of BATCH rows of its columns are in flight together.
__device__ __forceinline__ void add_rows(const float* src, int rows, int n2, float* dst) {
  float s[SLOTS] = {0.f, 0.f, 0.f};
  for (int r0 = 0; r0 < rows; r0 += BATCH) {
    float v[BATCH][SLOTS];
#pragma unroll
    for (int r = 0; r < BATCH; ++r)
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int c = threadIdx.x + k * THREADS;
        v[r][k] = r0 + r < rows && c < n2
                      ? __ldcg(src + static_cast<size_t>(r0 + r) * n2 + c) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < BATCH; ++r)
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
        if (r0 + r < rows) s[k] += v[r][k];
  }
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int c = threadIdx.x + k * THREADS;
    if (c < n2) dst[c] = s[k];
  }
}

// total: the elements of the used relations; group: blocks a first-level
// combine adds; partial: f32 [gridDim.x + groups, n2] scratch (the
// blocks' rows, then the groups'); count: groups + 1 counters, zero on
// entry and on exit.
template <int KIND>
__global__ void __launch_bounds__(THREADS, KIND == BF16 ? 3 : 2)
column_sum_kernel(const unsigned char* __restrict__ x, long long total, int n2, int group,
                  float* __restrict__ partial, unsigned* __restrict__ count,
                  float* __restrict__ out) {
  constexpr int ES = KIND == BF16 ? 2 : 1;  // bytes an element
  constexpr int V = 16 / ES;                // elements a vector
  // The block's sums at each of a tile's n2 * V positions (int8: ints).
  __shared__ __align__(16) float sums[MAX_N2 * V];
  int* isums = reinterpret_cast<int*>(sums);
  const int tid = threadIdx.x;

  // The block's tiles: blockIdx.x, then every gridDim.x-th after it.
  const long long tile = static_cast<long long>(n2) * V;
  const long long whole = total / tile;
  const int ragged = static_cast<int>(total - whole * tile);  // the last tile's elements
  const long long step = gridDim.x;

  bool live[SLOTS];
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) live[sl] = tid + sl * THREADS < n2;
  const uint4* vec = reinterpret_cast<const uint4*>(x) + tid;

  unsigned lo[SLOTS][4], hi[SLOTS][4];  // int8: see add_vector
  float acc[SLOTS][V];                  // conv, bf16
#pragma unroll
  for (int sl = 0; sl < SLOTS; ++sl) {
#pragma unroll
    for (int w = 0; w < 4; ++w) lo[sl][w] = hi[sl][w] = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j) acc[sl][j] = 0.f;
    if (KIND == INT8 && live[sl])
#pragma unroll
      for (int j = 0; j < V; ++j) isums[(tid + sl * THREADS) * V + j] = 0;
  }
  int pending = 0;  // int8 tiles in the lanes since the last flush
  auto flush = [&]() {
    const int bias = 128 * pending;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      if (!live[sl]) continue;
      int* dst = isums + (tid + sl * THREADS) * V;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        dst[4 * w] += static_cast<int>(lo[sl][w] & 0xFFFFu) - bias;
        dst[4 * w + 1] += static_cast<int>(hi[sl][w] & 0xFFFFu) - bias;
        dst[4 * w + 2] += static_cast<int>(lo[sl][w] >> 16) - bias;
        dst[4 * w + 3] += static_cast<int>(hi[sl][w] >> 16) - bias;
        lo[sl][w] = hi[sl][w] = 0u;
      }
    }
    pending = 0;
  };

  uint4 ring[AHEAD][SLOTS];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u) {
    const long long g = blockIdx.x + u * step;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      ring[u][sl] = make_uint4(0u, 0u, 0u, 0u);
      if (live[sl] && g < whole) ring[u][sl] = load(vec + g * n2 + sl * THREADS);
    }
  }
  for (long long g0 = blockIdx.x; g0 < whole; g0 += AHEAD * step) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const long long g = g0 + u * step;
      if (g >= whole) break;
      uint4 cur[SLOTS];
      const long long next = g + AHEAD * step;
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) {
        cur[sl] = ring[u][sl];
        if (live[sl] && next < whole) ring[u][sl] = load(vec + next * n2 + sl * THREADS);
      }
#pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl)
        if (live[sl]) add_vector<KIND>(cur[sl], lo[sl], hi[sl], acc[sl]);
      if (KIND == INT8 && ++pending == FLUSH) flush();
    }
  }
  if (ragged > 0 && whole % step == blockIdx.x) {  // the stream's partial last tile
    const int full = ragged / V;
    const unsigned char* end = x + (whole * tile + static_cast<long long>(full) * V) * ES;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      if (!live[sl]) continue;
      const int t = tid + sl * THREADS;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < full)
        v = load(vec + whole * n2 + sl * THREADS);
      else if (t == full)
        v = load_head(end, (ragged - full * V) * ES);
      add_vector<KIND>(v, lo[sl], hi[sl], acc[sl]);
    }
    if (KIND == INT8) ++pending;
  }
  if (KIND == INT8) {
    if (pending > 0) flush();
  } else {
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
      if (!live[sl]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) sums[(tid + sl * THREADS) * V + j] = acc[sl][j];
    }
  }
  __syncthreads();
  // Column c's positions are c + r * n2, r < V: fold them in order.
  float* row = partial + static_cast<size_t>(blockIdx.x) * n2;
  for (int c = tid; c < n2; c += THREADS) {
    if (KIND == INT8) {
      int s = 0;
#pragma unroll
      for (int r = 0; r < V; ++r) s += isums[c + r * n2];
      row[c] = static_cast<float>(s);
    } else {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < V; ++r) s += sums[c + r * n2];
      row[c] = s;
    }
  }

  const unsigned groups = (gridDim.x + group - 1) / group;
  const unsigned grp = blockIdx.x / group;
  const unsigned first = grp * group;
  const unsigned members = gridDim.x - first < group ? gridDim.x - first : group;
  if (!arrive_last(count + grp, members)) return;
  add_rows(partial + static_cast<size_t>(first) * n2, members, n2,
           partial + (static_cast<size_t>(gridDim.x) + grp) * n2);
  if (!arrive_last(count + groups, groups)) return;
  add_rows(partial + static_cast<size_t>(gridDim.x) * n2, groups, n2, out);
}

using Kernel = void (*)(const unsigned char*, long long, int, int, float*, unsigned*, float*);

Kernel pick(int kind) {
  if (kind == INT8) return column_sum_kernel<INT8>;
  if (kind == INT8_CONV) return column_sum_kernel<INT8_CONV>;
  if (kind == BF16) return column_sum_kernel<BF16>;
  return nullptr;
}

}  // namespace

extern "C" {

// x [K, n1, n2] (16-byte aligned): int8 (kind 0), int8 through bf16
// (kind 1) or bf16 (kind 2); plane = n1 * n2; the first groups * kb
// relations are summed.  blocks: the grid (SMs x resident blocks a SM,
// dt_probe_column_sum_info), combined in groups of group = ceil(sqrt(
// blocks)), so that neither level adds more rows than it has groups;
// partial f32 [blocks + ceil(blocks / group), n2] scratch; counters:
// ceil(blocks / group) + 1 unsigned ints, zero (the kernel leaves them
// zero); out f32 [1, n2].
int dt_probe_column_sum(const void* x, int kind, long long plane, int n2, int groups, int kb,
                        int blocks, void* partial, void* counters, void* out, void* stream) {
  const Kernel k = pick(kind);
  if (k == nullptr || n2 < 1 || n2 > MAX_N2 || plane < n2 || plane % n2 != 0 || groups < 1 ||
      kb < 1 || blocks < 1 || (reinterpret_cast<uintptr_t>(x) & 15) != 0)
    return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(groups) * kb * plane;
  int group = 1;
  while (group * group < blocks) ++group;
  k<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(x), total, n2, group, static_cast<float*>(partial),
      static_cast<unsigned*>(counters), static_cast<float*>(out));
  return cudaGetLastError();
}

// The kind's instantiation on the current device: registers a thread,
// resident blocks an SM, the SMs, local (spilled) bytes a thread and
// static shared bytes a block.
int dt_probe_column_sum_info(int kind, int* info) {
  const Kernel k = pick(kind);
  if (k == nullptr) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&info[2], cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], k, THREADS, 0);
  info[0] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

}  // extern "C"
