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
//   "highest": P and val read as they are (P f32, or bf16 read exactly);
//   "default": P and val rounded to bf16 here (an f32 P as it is read,
//   or as it is copied into shared memory; a bf16 P is exact already);
//   each product of two bf16 values is exact in f32, and the sums are
//   f32.  On a TPU the kernel's second MXU product at DEFAULT precision
//   would also round each message to bf16; the CPU reference does not,
//   and neither does this.
// Each message is rounded on its own (__fmul_rn) and added in edge order
// (__fadd_rn), so nvcc contracts nothing into an FMA.
//
// The TPU kernel turns the gather into one-hot MXU products over packed
// tiles with dynamic source windows; here lanes read the rows directly.
//
// Bound on this card: memory.  The least traffic is the layout (8 bytes an
// edge), each distinct source row once, and the output.  The drug-drug
// backward (1.24M rows of ~7 edges from a 165 KB cotangent) is its
// 318 MB output; the forward (645 rows of ~14,700 edges from a 318 MB
// table) gathers ~2.4 GB through the L2.
//
// Design.  A row group of G lanes (a power of two) holds one row, each
// lane VEC adjacent columns read as one load of up to 16 bytes (4 f32 or
// 8 bf16 from device memory, 4 of either from shared memory; narrower
// where H or the table's alignment demands), so a warp holds 32 / G rows.  Columns past
// 32 * VEC go to further slices (blockIdx.y).  Every lane reads its edge's
// (col, val) itself (the group's lanes read one address), so no shuffles
// tie the groups of a warp together.
//   Pass 1, short rows (at most 32 edges, empty rows included): a block
//   walks chunks of consecutive short rows (ops/tiling.py row_chunks, at
//   most CHUNK_ROWS rows and CHUNK_EDGES edges).  It copies the next
//   chunk's row pointers and (col, val) pairs into shared memory with
//   cp.async while its groups sum the current one from shared memory, so
//   a row waits on no load from device memory but its gathers.  A table
//   that fits beside the buffers (the drug-drug backward's 165 KB
//   cotangent, 82 KB rounded to bf16 at "default") is first copied into
//   shared memory too, so the gathers (~2.4 GB there) never leave the SM;
//   one block an SM then.
//   Pass 2, the other rows' segments (ops/tiling.py: cut at source windows
//   and every 256 edges): one group a segment, in the schedule's launch
//   order (window by window, so the segments in flight share a window of
//   the table in the L2); the next UNROLL (col, val) pairs load while the
//   current UNROLL gathers land.  A row's only segment writes the row; a
//   long row's segments write slots of a partial buffer.
//   Pass 3: one thread a (long row, column) adds the row's slots in slot
//   order.
// No atomics: two calls give equal bits.  An edge whose source lies
// outside [0, n_src) makes its row NaN instead of reading out of bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;      // passes 2 and 3
constexpr int ROW_THREADS = 512;  // pass 1
constexpr int UNROLL = 8;
// Pass 1's chunk of short rows: at most this many rows and edges
// (ops/tiling.py CHUNK_ROWS, CHUNK_EDGES).
constexpr int CHUNK_ROWS = 512;
constexpr int CHUNK_EDGES = 2048;
constexpr int ROW_BLOCKS_PER_SM = 4;  // pass 1's grid without a staged table

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// VEC adjacent elements of the table as one load: f32 (B16 false) or bf16
// stored as uint16 (B16 true).  `get(w, q)` is element
// q as f32; `ldg` reads device memory through the read-only path.
__device__ __forceinline__ float lo16(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi16(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float f4(const float4& w, int q) {
  return q == 0 ? w.x : q == 1 ? w.y : q == 2 ? w.z : w.w;
}
template <bool B16, int VEC> struct Vec;
template <> struct Vec<false, 1> {
  using T = float;
  __device__ static float get(const T& w, int) { return w; }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<false, 2> {
  using T = float2;
  __device__ static float get(const T& w, int q) { return q == 0 ? w.x : w.y; }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<false, 4> {
  using T = float4;
  __device__ static float get(const T& w, int q) { return f4(w, q); }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<true, 1> {
  using T = unsigned short;
  __device__ static float get(const T& w, int) { return lo16(w); }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<true, 2> {
  using T = unsigned int;
  __device__ static float get(const T& w, int q) { return q == 0 ? lo16(w) : hi16(w); }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<true, 4> {
  using T = uint2;
  __device__ static float get(const T& w, int q) {
    const uint32_t x = q < 2 ? w.x : w.y;
    return (q & 1) ? hi16(x) : lo16(x);
  }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};
template <> struct Vec<true, 8> {
  using T = uint4;
  __device__ static float get(const T& w, int q) {
    const uint32_t x = q < 2 ? w.x : q < 4 ? w.y : q < 6 ? w.z : w.w;
    return (q & 1) ? hi16(x) : lo16(x);
  }
  __device__ static T ldg(const T* p) { return __ldg(p); }
};

// acc[q] += v * x[q] for one edge, each product and sum rounded once; RND
// rounds an f32 x to bf16 first.
template <class V, bool RND, int VEC>
__device__ __forceinline__ void add_message(float (&acc)[VEC], float v, const typename V::T& x) {
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    const float xq = RND ? bf16_round(V::get(x, q)) : V::get(x, q);
    acc[q] = __fadd_rn(acc[q], __fmul_rn(v, xq));
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* __restrict__ dst, const float (&acc)[VEC], bool bad) {
  float y[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) y[q] = bad ? NAN : acc[q];
  if (VEC == 1) {
    dst[0] = y[0];
  } else if (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(y[0], y[1]);
  } else {
#pragma unroll
    for (int q = 0; q < VEC; q += 4)
      *reinterpret_cast<float4*>(dst + q) = make_float4(y[q], y[q + 1], y[q + 2], y[q + 3]);
  }
}

// Pass 1's staging buffers: a chunk of short rows' row pointers and their
// (col, val bits) pairs.
struct Chunk {
  int32_t rowp[CHUNK_ROWS + 4];  // CHUNK_ROWS + 1 used; the rest keeps 16-byte sizes
  int2 edge[CHUNK_EDGES + UNROLL];  // a row's last UNROLL step reads past its end
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Starts copying chunk d = (first row, end row, first edge, end edge) into b.
__device__ __forceinline__ void load_chunk(Chunk& b, int4 d, const int32_t* __restrict__ row_ptr,
                                           const int32_t* __restrict__ col,
                                           const float* __restrict__ val) {
  const int rows = d.y - d.x + 1, edges = d.w - d.z;
  for (int i = threadIdx.x; i < rows; i += ROW_THREADS) cp_async4(b.rowp + i, row_ptr + d.x + i);
  for (int i = threadIdx.x; i < edges; i += ROW_THREADS) {
    cp_async4(&b.edge[i].x, col + d.z + i);
    cp_async4(&b.edge[i].y, val + d.z + i);
  }
}

// Copies the table (`bytes`, a multiple of 4) into shared memory, 16-byte
// words where the source allows, else 4-byte ones; TO16 rounds f32 to bf16
// on the way.
template <bool TO16>
__device__ void stage_table(void* dst, const void* __restrict__ src, long long bytes) {
  const bool wide = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0;
  const int per = wide ? 4 : 1;  // 4-byte words a load
  for (long long i = threadIdx.x; i < bytes / 4 / per; i += ROW_THREADS) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (wide) {
      const uint4 x = __ldg(static_cast<const uint4*>(src) + i);
      w[0] = x.x;
      w[1] = x.y;
      w[2] = x.z;
      w[3] = x.w;
    } else {
      w[0] = __ldg(static_cast<const unsigned int*>(src) + i);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < per) {
        if constexpr (TO16) {
          static_cast<__nv_bfloat16*>(dst)[i * per + q] = __float2bfloat16_rn(__uint_as_float(w[q]));
        } else {
          static_cast<uint32_t*>(dst)[i * per + q] = w[q];
        }
      }
    }
  }
}

// Pass 1: the short rows, chunk by chunk (grid stride), each chunk staged
// in shared memory while the previous one is summed; a group of 2^g_log2
// lanes a row.  STAGED: the whole table sits in shared memory too, as
// bf16 when B16 or RND.
template <bool B16, bool RND, int VEC, bool STAGED>
__global__ void __launch_bounds__(ROW_THREADS)
spmm_rows(const void* __restrict__ p, const int32_t* __restrict__ row_ptr,
          const int32_t* __restrict__ col, const float* __restrict__ val,
          const int4* __restrict__ chunks, int num_chunks, float* __restrict__ out, int n_src,
          int h, int g_log2) {
  constexpr bool T16 = B16 || (STAGED && RND);  // the table as read below
  using V = Vec<T16, VEC>;
  constexpr int U = UNROLL;
  extern __shared__ float4 smem4[];
  Chunk* buf = reinterpret_cast<Chunk*>(smem4);
  const typename V::T* table = static_cast<const typename V::T*>(p);
  if constexpr (STAGED) {
    void* t = reinterpret_cast<char*>(smem4) + 2 * sizeof(Chunk);
    stage_table<T16 && !B16>(t, p, static_cast<long long>(n_src) * h * (B16 ? 2 : 4));
    table = static_cast<const typename V::T*>(t);
  }
  const int g = 1 << g_log2;
  const int c0 = (blockIdx.y * g + (threadIdx.x & (g - 1))) * VEC;
  const bool active = c0 < h;
  const int col0 = active ? c0 : 0;  // every lane loads, in bounds
  const int groups = ROW_THREADS >> g_log2;
  const int grp = threadIdx.x >> g_log2;
  int i = blockIdx.x;
  const int stride = gridDim.x;
  int4 cur = i < num_chunks ? __ldg(chunks + i) : make_int4(0, 0, 0, 0);
  if (i < num_chunks) load_chunk(buf[0], cur, row_ptr, col, val);
  cp_async_commit();
  int4 nxt = i + stride < num_chunks ? __ldg(chunks + i + stride) : make_int4(0, 0, 0, 0);
  for (int b = 0; i < num_chunks; i += stride, b ^= 1) {
    if (i + stride < num_chunks) load_chunk(buf[b ^ 1], nxt, row_ptr, col, val);
    cp_async_commit();
    const int4 later =
        i + 2 * stride < num_chunks ? __ldg(chunks + i + 2 * stride) : make_int4(0, 0, 0, 0);
    cp_async_wait_one();
    __syncthreads();
    const Chunk& c = buf[b];
    for (int r = grp; r < cur.y - cur.x; r += groups) {
      const int lo = c.rowp[r] - cur.z, hi = c.rowp[r + 1] - cur.z;
      float acc[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
      bool bad = false;
      for (int e = lo; e < hi; e += U) {
        float v[U];
        typename V::T x[U];
        // Loads without branches, so all U are in flight at once: a lane
        // past its row, past h or at a bad source reads row 0 and drops it
        // (a table of no rows has no edges to read).
        size_t at[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const bool live = e + u < hi;
          const int2 cv = c.edge[e + u];
          v[u] = RND ? bf16_round(__int_as_float(cv.y)) : __int_as_float(cv.y);
          const bool ok = static_cast<unsigned>(cv.x) < static_cast<unsigned>(n_src);
          bad |= live && !ok;
          at[u] = (static_cast<size_t>(live && ok ? cv.x : 0) * h + col0) / VEC;
        }
        if (n_src > 0) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if constexpr (STAGED) x[u] = table[at[u]];
            else x[u] = V::ldg(table + at[u]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < U; ++u) x[u] = typename V::T{};
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (e + u < hi) add_message<V, RND && !T16, VEC>(acc, v[u], x[u]);
        }
      }
      if (active) store<VEC>(out + static_cast<size_t>(cur.x + r) * h + c0, acc, bad);
    }
    __syncthreads();  // buf[b] is refilled next time round
    cur = nxt;
    nxt = later;
  }
}

// UNROLL (col, val) pairs from edge e on, those at or past `hi` zeroed.
template <bool RND>
__device__ __forceinline__ void load_edges(const int32_t* __restrict__ col,
                                           const float* __restrict__ val, int e, int hi,
                                           int (&c)[UNROLL], float (&v)[UNROLL]) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bool live = e + u < hi;
    c[u] = live ? __ldg(col + e + u) : 0;
    const float x = live ? __ldg(val + e + u) : 0.f;
    v[u] = RND ? bf16_round(x) : x;
  }
}

// Pass 2: the segments, a group a segment, in launch order; a row's only
// segment writes out, a long row's a slot of the partial buffer.
template <bool B16, bool RND, int VEC>
__global__ void __launch_bounds__(THREADS)
spmm_segments(const void* __restrict__ p, const int32_t* __restrict__ col,
              const float* __restrict__ val, const int32_t* __restrict__ seg_order,
              const int2* __restrict__ seg_edges, const int32_t* __restrict__ seg_dst,
              float* __restrict__ partial, float* __restrict__ out, int num_segments,
              int n_src, int h, int g_log2) {
  using V = Vec<B16, VEC>;
  const auto* table = static_cast<const typename V::T*>(p);
  const int g = 1 << g_log2;
  const int i = (blockIdx.x * THREADS + threadIdx.x) >> g_log2;
  if (i >= num_segments) return;  // uniform across the group
  const int c0 = (blockIdx.y * g + (threadIdx.x & (g - 1))) * VEC;
  const bool active = c0 < h;
  const int col0 = active ? c0 : 0;  // every lane loads, in bounds
  const int s = __ldg(seg_order + i);
  const int2 span = __ldg(seg_edges + s);
  const int dst = __ldg(seg_dst + s);
  int c[UNROLL];
  float v[UNROLL];
  load_edges<RND>(col, val, span.x, span.y, c, v);
  float acc[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc[q] = 0.f;
  bool bad = false;
  for (int e = span.x; e < span.y; e += UNROLL) {
    typename V::T x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {  // without branches, as in pass 1
      const bool live = e + u < span.y;
      const bool ok = static_cast<unsigned>(c[u]) < static_cast<unsigned>(n_src);
      bad |= live && !ok;
      x[u] = V::ldg(table + (static_cast<size_t>(live && ok ? c[u] : 0) * h + col0) / VEC);
    }  // a segment has edges, so n_src > 0 here
    float vv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) vv[u] = v[u];
    const int steps = min(UNROLL, span.y - e);
    if (e + UNROLL < span.y) load_edges<RND>(col, val, e + UNROLL, span.y, c, v);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (u < steps) add_message<V, RND && !B16, VEC>(acc, vv[u], x[u]);
    }
  }
  if (!active) return;
  float* row = dst >= 0 ? out + static_cast<size_t>(dst) * h : partial + static_cast<size_t>(~dst) * h;
  store<VEC>(row + c0, acc, bad);
}

// Pass 3: out[multi_row[m], j] = sum of the row's slots, in slot order.
__global__ void __launch_bounds__(THREADS)
spmm_reduce(const float* __restrict__ partial, const int32_t* __restrict__ multi_row,
            const int32_t* __restrict__ multi_ptr, float* __restrict__ out, int num_multi,
            int h) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS) + threadIdx.x;
  if (t >= static_cast<long long>(num_multi) * h) return;
  const int m = static_cast<int>(t / h), j = static_cast<int>(t % h);
  const int first = __ldg(multi_ptr + m), last = __ldg(multi_ptr + m + 1);
  float acc = 0.f;
  int s = first;
  for (; s + UNROLL <= last; s += UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) x[u] = __ldg(partial + static_cast<size_t>(s + u) * h + j);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = __fadd_rn(acc, x[u]);
  }
  for (; s < last; ++s) acc = __fadd_rn(acc, __ldg(partial + static_cast<size_t>(s) * h + j));
  out[static_cast<size_t>(__ldg(multi_row + m)) * h + j] = acc;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        sms < 1)
      sms = 132;
  }
  return sms;
}

struct Args {
  const void* p;
  const int32_t *row_ptr, *col, *seg_order, *seg_dst, *multi_row, *multi_ptr;
  const float* val;
  const int4* row_chunks;
  const int2* seg_edges;
  float *partial, *out;
  int num_chunks, num_segments, num_multi, n_src, h;
  cudaStream_t stream;
};

// Lanes a row: the next power of two of h / vec, at most a warp; and the
// column slices that cover h.
void geometry(int h, int vec, int* g_log2, int* slices) {
  const int lanes = (h + vec - 1) / vec;
  int g = 0;
  while ((1 << g) < lanes && g < 5) ++g;
  *g_log2 = g;
  *slices = (h + (vec << g) - 1) / (vec << g);
}

template <bool B16, bool RND, int VEC, bool STAGED>
cudaError_t launch_rows(const Args& a) {
  int g_log2, slices;
  geometry(a.h, VEC, &g_log2, &slices);
  const size_t table =
      STAGED ? (static_cast<size_t>(a.n_src) * a.h * (B16 || RND ? 2 : 4) + 15) / 16 * 16 : 0;
  const size_t smem = 2 * sizeof(Chunk) + table;
  auto* kernel = spmm_rows<B16, RND, VEC, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long most = static_cast<long long>(sm_count()) * (STAGED ? 1 : ROW_BLOCKS_PER_SM);
  const dim3 grid(static_cast<unsigned>(a.num_chunks < most ? a.num_chunks : most), slices);
  kernel<<<grid, ROW_THREADS, smem, a.stream>>>(a.p, a.row_ptr, a.col, a.val, a.row_chunks,
                                                a.num_chunks, a.out, a.n_src, a.h, g_log2);
  return cudaGetLastError();
}

template <bool B16, bool RND, int VEC>
cudaError_t launch_segments(const Args& a) {
  int g_log2, slices;
  geometry(a.h, VEC, &g_log2, &slices);
  const long long per_block = THREADS >> g_log2;
  const dim3 grid(static_cast<unsigned>((a.num_segments + per_block - 1) / per_block), slices);
  spmm_segments<B16, RND, VEC><<<grid, THREADS, 0, a.stream>>>(
      a.p, a.col, a.val, a.seg_order, a.seg_edges, a.seg_dst, a.partial, a.out, a.num_segments,
      a.n_src, a.h, g_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.num_multi == 0) return err;
  const long long cells = static_cast<long long>(a.num_multi) * a.h;
  spmm_reduce<<<static_cast<unsigned>((cells + THREADS - 1) / THREADS), THREADS, 0,
                a.stream>>>(a.partial, a.multi_row, a.multi_ptr, a.out, a.num_multi, a.h);
  return cudaGetLastError();
}

// Pass 1 at `vec` elements a load (8 only for bf16 in device memory).
template <bool B16, bool RND, bool STAGED>
cudaError_t rows_at(int vec, const Args& a) {
  switch (vec) {
    case 1: return launch_rows<B16, RND, 1, STAGED>(a);
    case 2: return launch_rows<B16, RND, 2, STAGED>(a);
    case 4: return launch_rows<B16, RND, 4, STAGED>(a);
    case 8:
      if constexpr (B16 && !STAGED) return launch_rows<B16, RND, 8, STAGED>(a);
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <bool B16, bool RND>
cudaError_t launch_all(int vec, int rows_vec, bool staged, const Args& a) {
  if (a.num_chunks > 0) {
    const cudaError_t err = staged ? rows_at<B16, RND, true>(rows_vec, a)
                                   : rows_at<B16, RND, false>(rows_vec, a);
    if (err != cudaSuccess) return err;
  }
  if (a.num_segments == 0) return cudaSuccess;
  switch (vec) {
    case 1: return launch_segments<B16, RND, 1>(a);
    case 2: return launch_segments<B16, RND, 2>(a);
    case 4: return launch_segments<B16, RND, 4>(a);
    case 8:
      if constexpr (B16) return launch_segments<true, RND, 8>(a);
      else return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// p [n_src, h]: f32 (p_bf16 = 0) or bf16 stored as uint16 (p_bf16 = 1);
// round = 1 rounds p and val to bf16 ("default").  row_ptr [n_dst + 1], col / val [E]; the short rows' row_chunks
// [C, 4]; the other rows' seg_edges [S, 2], seg_dst [S], seg_order [S],
// multi_row [M], multi_ptr [M + 1] (ops/tiling.py), all int32 but val
// (f32); partial f32 [slots, h] (unused when M == 0); out f32 [n_dst, h].
// vec: elements a lane loads at once from p (1, 2, 4, or 8 for bf16),
// h % vec == 0 and p aligned to vec elements.  staged = 1 copies p into
// shared memory for pass 1 (as bf16 when p_bf16 or round), whose loads
// are then rows_vec (1, 2 or 4) elements wide.  chunk_rows / chunk_edges:
// the layout's chunk limits, which must be this file's.
int dt_spmm_tiled(const void* p, int p_bf16, int round, const void* row_ptr, const void* col,
                  const void* val, const void* row_chunks, const void* seg_edges,
                  const void* seg_dst, const void* seg_order, const void* multi_row,
                  const void* multi_ptr, void* partial, void* out, int num_chunks,
                  int num_segments, int num_multi, int n_src, int h, int vec, int rows_vec,
                  int staged, int chunk_rows, int chunk_edges, void* stream) {
  if (h < 1 || num_chunks < 0 || num_segments < 0 || num_multi < 0 || n_src < 0 || vec < 1 ||
      rows_vec < 1)
    return cudaErrorInvalidValue;
  if (chunk_rows != CHUNK_ROWS || chunk_edges != CHUNK_EDGES) return cudaErrorInvalidValue;
  if (h % vec != 0 || h % rows_vec != 0) return cudaErrorInvalidValue;
  const size_t in_bytes = static_cast<size_t>(n_src) * h * (p_bf16 ? 2 : 4);
  const size_t staged_bytes = static_cast<size_t>(n_src) * h * (p_bf16 || round ? 2 : 4);
  if (staged && (2 * sizeof(Chunk) + staged_bytes > (227u << 10) || in_bytes % 4 != 0 ||
                 rows_vec > 4))
    return cudaErrorInvalidValue;
  Args a;
  a.p = p;
  a.row_ptr = static_cast<const int32_t*>(row_ptr);
  a.col = static_cast<const int32_t*>(col);
  a.val = static_cast<const float*>(val);
  a.row_chunks = static_cast<const int4*>(row_chunks);
  a.seg_edges = static_cast<const int2*>(seg_edges);
  a.seg_dst = static_cast<const int32_t*>(seg_dst);
  a.seg_order = static_cast<const int32_t*>(seg_order);
  a.multi_row = static_cast<const int32_t*>(multi_row);
  a.multi_ptr = static_cast<const int32_t*>(multi_ptr);
  a.partial = static_cast<float*>(partial);
  a.out = static_cast<float*>(out);
  a.num_chunks = num_chunks;
  a.num_segments = num_segments;
  a.num_multi = num_multi;
  a.n_src = n_src;
  a.h = h;
  a.stream = static_cast<cudaStream_t>(stream);
  const bool st = staged != 0;
  if (p_bf16) return round ? launch_all<true, true>(vec, rows_vec, st, a)
                           : launch_all<true, false>(vec, rows_vec, st, a);
  return round ? launch_all<false, true>(vec, rows_vec, st, a)
               : launch_all<false, false>(vec, rows_vec, st, a);
}

}  // extern "C"
