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
//   "default" (K5-bf16): every table bf16 (the caller casts them once;
//   ops/sddmm_pallas.py), f32 sums; DEDICOM rounds zr * rel[k] to bf16
//   before the product with G, as the reference does.  A product of two
//   bf16 values is exact in f32, so the gathers and the bilinear and
//   distmult products lose nothing beyond the tables' rounding.
// The TPU kernel gathers rows through one-hot matrix products because its
// vector unit cannot gather; here each edge's lanes read its rows directly.
//
// Bound on this card: operations.  Each edge moves 16 bytes of indices
// and score, while dedicom and bilinear spend 2*d^2 flops on the d x d
// product; the tables (a few hundred KB) stay in cache.
//
// Design.  An edge gets L lanes (1 for d <= 32, 2 for <= 64, 4 for <=
// 128), each owning C*nbc <= 32 adjacent output columns, so a warp scores
// 32 / L edges at once.  A lane reads its rows C elements at a time: one
// 16-byte load of 4 f32 or 8 bf16 where d % C == 0 and the tables are
// aligned (the rows of a warp's edges are scattered, so every load touches
// 32 cache lines: bf16 rows halve the loads), else element by element.
// For dedicom and bilinear a lane keeps its columns of t = left @ M in
// registers and walks the d rows of M C at a time, the left elements
// loaded eight ahead of their products, M's row chunk from shared memory,
// where the edges of a warp read the same L addresses (a broadcast).  M is
// staged once a block, as f32: G for dedicom; for bilinear the matrices
// R[kmin..kmax] of the relations that the block's edges name, when they
// fit the shared-memory budget (an evaluation sweep arrives relation by
// relation, so a block sees one or two; random pairs over two relations
// need both).  A block whose edges span more relations reads R from
// device memory instead, a row at a time: right, and slow.  Each lane's
// row chunk is padded by 4 floats so the L lanes of an edge read different
// banks.  The score is the lanes' sums of t[b] * right[b], added across
// the L lanes with shuffles.  An edge with an index outside its table
// scores NaN instead of reading out of bounds.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Mode { INNERPRODUCT = 0, DISTMULT = 1, DEDICOM = 2, BILINEAR = 3 };

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int MAX_COLS = 32;  // a lane's columns
constexpr int SMEM_BUDGET = 48 * 1024;     // bilinear's matrices a block
constexpr int SMEM_MAX = 227 * 1024;
constexpr int BLOCKS_PER_SM = 3;  // a register cap (85) that keeps 24 warps an SM

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Element i of a table as f32: f32, or bf16 stored as uint16.
__device__ __forceinline__ float elem(const float* __restrict__ t, int i) { return __ldg(t + i); }
__device__ __forceinline__ float elem(const uint16_t* __restrict__ t, int i) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(t + i)) << 16);
}

// C adjacent elements of row `t` from column b (zeros at and past d), as
// f32: one 16-byte load when VL == C (4 f32 or 8 bf16; d % VL == 0, aligned
// rows), else C loads.
template <int C, int VL, class T>
__device__ __forceinline__ void loadc(const T* __restrict__ t, int b, int d, float (&x)[C]) {
  if constexpr (VL == 8) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (b < d) w = __ldg(reinterpret_cast<const uint4*>(t + b));
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[2 * q] = __uint_as_float(ws[q] << 16);
      x[2 * q + 1] = __uint_as_float(ws[q] & 0xffff0000u);
    }
  } else if constexpr (VL == 4) {
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b < d) w = __ldg(reinterpret_cast<const float4*>(t + b));
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
#pragma unroll
    for (int q = 0; q < C; ++q) x[q] = b + q < d ? elem(t, b + q) : 0.f;
  }
}

// C left-factor elements from column a (zeros at and past d): the row's
// own, or for DEDICOM zr * rel[k], rounded to bf16 when B16 as the
// reference rounds it.
template <int MODE, int C, int VL, bool B16, class T>
__device__ __forceinline__ void left(const T* __restrict__ zr_row, const T* __restrict__ dk,
                                     int a, int d, float (&x)[C]) {
  loadc<C, VL>(zr_row, a, d, x);
  if (MODE == DEDICOM) {
    float g[C];
    loadc<C, VL>(dk, a, d, g);
#pragma unroll
    for (int q = 0; q < C; ++q) x[q] = B16 ? bf16_round(x[q] * g[q]) : x[q] * g[q];
  }
}

// Copies n matrices [d, d] from src into shared memory as f32, row a of
// matrix i at dst + i * ms + a * ld (ms = d * ld + 4: matrices 4 banks
// apart), lane l's columns [l * cpl, (l + 1) * cpl) at offset l * (cpl +
// 4); columns at or past d are zero.
template <class T>
__device__ void stage(float* dst, const T* __restrict__ src, int n, int d, int ld, int cpl,
                      int lanes) {
  const int ms = d * ld + 4;
  const int per_row = lanes * cpl;
  const int total = n * d * per_row;
#pragma unroll 4
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int j = i % per_row, row = i / per_row;  // row = matrix * d + a
    const int l = j / cpl, b = j;                  // b: column, l: its lane
    const float v = b < d ? elem(src, row * d + b) : 0.f;
    dst[(row / d) * ms + (row % d) * ld + l * (cpl + 4) + (j - l * cpl)] = v;
  }
}

// t += left @ M, C rows of M a step from shared memory (m, rows ld
// apart); the left factor's elements for the step 8 / C ahead load while a
// step's products run.  WIDE: the lane owns all MAX_COLS columns, so the
// loop tests no column (the common widths, d = 32 and 64).
template <bool WIDE, int MODE, int C, int VL, bool B16, class T>
__device__ __forceinline__ void product(float (&t)[MAX_COLS], const T* __restrict__ zr_row,
                                        const T* __restrict__ dk, const float* m, int d, int ld,
                                        int cpl) {
  constexpr int D = 8 / C;
  float xs[D + 1][C];
#pragma unroll
  for (int p = 0; p < D; ++p) left<MODE, C, VL, B16>(zr_row, dk, p * C, d, xs[p]);
  for (int a = 0; a < d; a += C) {
    left<MODE, C, VL, B16>(zr_row, dk, a + D * C, d, xs[D]);
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (a + i < d) {
#pragma unroll
        for (int j = 0; j < MAX_COLS / 4; ++j) {
          if (WIDE || 4 * j < cpl) {
            const float4 g = *reinterpret_cast<const float4*>(m + (a + i) * ld + 4 * j);
            t[4 * j] = fmaf(xs[0][i], g.x, t[4 * j]);
            t[4 * j + 1] = fmaf(xs[0][i], g.y, t[4 * j + 1]);
            t[4 * j + 2] = fmaf(xs[0][i], g.z, t[4 * j + 2]);
            t[4 * j + 3] = fmaf(xs[0][i], g.w, t[4 * j + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
#pragma unroll
      for (int q = 0; q < C; ++q) xs[p][q] = xs[p + 1][q];
    }
  }
}

// B16: bf16 tables ("default"), else f32 ("highest").  VL: 1, or the
// elements of a 16-byte load (4 f32, 8 bf16).
template <int MODE, bool B16, int VL>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
sddmm_kernel(const void* __restrict__ zr_, const void* __restrict__ zc_,
             const void* __restrict__ rel_, const void* __restrict__ glb_,
             const int32_t* __restrict__ ks, const int32_t* __restrict__ rows,
             const int32_t* __restrict__ cols, float* __restrict__ out, long long num_edges,
             int d, int n_r, int n_c, int n_k, int l_log2, int nbc, int slots) {
  using T = typename std::conditional<B16, uint16_t, float>::type;
  constexpr int C = VL == 8 ? 8 : 4;  // elements a step
  constexpr int MAXC = MAX_COLS / C;  // steps a lane's columns take at most
  const T* zr = static_cast<const T*>(zr_);
  const T* zc = static_cast<const T*>(zc_);
  const T* rel = static_cast<const T*>(rel_);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  __shared__ int s_kmin, s_kmax;
  const int lanes = 1 << l_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int cpl = C * nbc;
  const int ld = lanes * (cpl + 4);
  const int b0 = sub * cpl;
  const long long e =
      blockIdx.x * static_cast<long long>(THREADS >> l_log2) + (threadIdx.x >> l_log2);
  const bool live = e < num_edges;
  int r = 0, c = 0, k = 0;
  if (live) {
    r = rows[e];
    c = cols[e];
    if (MODE != INNERPRODUCT) k = ks[e];
  }
  const bool ok = live && r >= 0 && r < n_r && c >= 0 && c < n_c &&
                  (MODE == INNERPRODUCT || (k >= 0 && k < n_k));
  const T* zr_row = zr + static_cast<size_t>(r) * d;
  const T* zc_row = zc + static_cast<size_t>(c) * d;
  const T* dk = rel + static_cast<size_t>(k) * d;  // distmult, dedicom

  bool staged = MODE == DEDICOM;
  int kmin = 0;
  if (MODE == DEDICOM) stage(sm, static_cast<const T*>(glb_), 1, d, ld, cpl, lanes);
  if (MODE == BILINEAR) {
    if (threadIdx.x == 0) {
      s_kmin = INT_MAX;
      s_kmax = INT_MIN;
    }
    __syncthreads();
    const int wmin = __reduce_min_sync(FULL, ok ? k : INT_MAX);
    const int wmax = __reduce_max_sync(FULL, ok ? k : INT_MIN);
    if ((threadIdx.x & 31) == 0) {
      atomicMin(&s_kmin, wmin);
      atomicMax(&s_kmax, wmax);
    }
    __syncthreads();
    kmin = s_kmin;
    const int kmax = s_kmax;
    staged = kmin <= kmax && kmax - kmin < slots;
    if (staged) stage(sm, rel + static_cast<size_t>(kmin) * d * d, kmax - kmin + 1, d, ld, cpl,
                      lanes);
  }
  if (MODE == DEDICOM || MODE == BILINEAR) __syncthreads();

  float acc = 0.f;
  if (!ok) {
    // reads nothing; the score is NaN
  } else if (MODE == INNERPRODUCT || MODE == DISTMULT) {
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < nbc) {
        const int b = b0 + C * j;
        float x[C], y[C];
        loadc<C, VL>(zr_row, b, d, x);
        loadc<C, VL>(zc_row, b, d, y);
        if (MODE == DISTMULT) {
          float g[C];
          loadc<C, VL>(dk, b, d, g);
#pragma unroll
          for (int q = 0; q < C; ++q) x[q] *= g[q];
        }
        float s = x[0] * y[0];
#pragma unroll
        for (int q = 1; q < C; ++q) s += x[q] * y[q];
        acc += s;
      }
    }
  } else {
    float t[MAX_COLS];
#pragma unroll
    for (int q = 0; q < MAX_COLS; ++q) t[q] = 0.f;
    if (staged) {
      const float* m = sm + (MODE == BILINEAR ? k - kmin : 0) * (d * ld + 4) + sub * (cpl + 4);
      if (cpl == MAX_COLS) {
        product<true, MODE, C, VL, B16>(t, zr_row, dk, m, d, ld, cpl);
      } else {
        product<false, MODE, C, VL, B16>(t, zr_row, dk, m, d, ld, cpl);
      }
    } else if (MODE == BILINEAR) {
      // More relations than the block stages: R[k]'s rows from device
      // memory, one row of left @ R a step, in the same order.
      const T* gm = rel + static_cast<size_t>(k) * d * d;
      for (int a = 0; a < d; ++a) {
        const float x = elem(zr_row, a);
#pragma unroll
        for (int j = 0; j < MAX_COLS / 4; ++j) {
          if (4 * j < cpl) {
            float g[4];
            loadc<4, 1>(gm + static_cast<size_t>(a) * d, b0 + 4 * j, d, g);
#pragma unroll
            for (int q = 0; q < 4; ++q) t[4 * j + q] = fmaf(x, g[q], t[4 * j + q]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      if (j < nbc) {
        const int b = b0 + C * j;
        float y[C];
        loadc<C, VL>(zc_row, b, d, y);
        if (MODE == DEDICOM) {
          float g[C];
          loadc<C, VL>(dk, b, d, g);
#pragma unroll
          for (int q = 0; q < C; ++q) y[q] *= g[q];
        }
        float s = t[C * j] * y[0];
#pragma unroll
        for (int q = 1; q < C; ++q) s += t[C * j + q] * y[q];
        acc += s;
      }
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
  if (live && sub == 0) out[e] = ok ? acc : NAN;
}

template <int MODE, bool B16, int VL>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t s, const void* zr, const void* zc,
                   const void* rel, const void* glb, const int32_t* ks, const int32_t* rows,
                   const int32_t* cols, float* out, long long b, int d, int n_r, int n_c,
                   int n_k, int l_log2, int nbc, int slots) {
  auto* kernel = sddmm_kernel<MODE, B16, VL>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, THREADS, smem, s>>>(zr, zc, rel, glb, ks, rows, cols, out, b, d, n_r, n_c,
                                     n_k, l_log2, nbc, slots);
  return cudaGetLastError();
}

template <bool B16, int VL>
cudaError_t launch_mode(int mode, dim3 grid, size_t smem, cudaStream_t s, const void* zr,
                        const void* zc, const void* rel, const void* glb, const int32_t* ks,
                        const int32_t* rows, const int32_t* cols, float* out, long long b,
                        int d, int n_r, int n_c, int n_k, int l_log2, int nbc, int slots) {
#define DT_LAUNCH(M)                                                                   \
  return launch<M, B16, VL>(grid, smem, s, zr, zc, rel, glb, ks, rows, cols, out, b, d, \
                            n_r, n_c, n_k, l_log2, nbc, slots)
  switch (mode) {
    case INNERPRODUCT: DT_LAUNCH(INNERPRODUCT);
    case DISTMULT: DT_LAUNCH(DISTMULT);
    case DEDICOM: DT_LAUNCH(DEDICOM);
    case BILINEAR: DT_LAUNCH(BILINEAR);
    default: return cudaErrorInvalidValue;
  }
#undef DT_LAUNCH
}

}  // namespace

extern "C" {

// mode: 0 innerproduct, 1 distmult, 2 dedicom, 3 bilinear.  zr [n_r, d],
// zc [n_c, d], rel [n_k, d] (distmult, dedicom) or [n_k, d, d] (bilinear),
// glb [d, d] (dedicom): all f32 ("highest", bf16 = 0) or all bf16 stored
// as uint16 ("default", bf16 = 1).  ks/rows/cols int32 [B]; out f32 [B].
// vl: 4 (f32) or 8 (bf16) when d % vl == 0 and every table is 16-byte
// aligned, else 1.  Pointers a mode does not read may be null.
int dt_sddmm(int mode, int bf16, const void* zr, const void* zc, const void* rel,
             const void* glb, const void* ks, const void* rows, const void* cols, void* out,
             long long num_edges, int d, int n_r, int n_c, int n_k, int vl, void* stream) {
  if (d < 1 || d > 4 * MAX_COLS || num_edges < 0 || !(bf16 == 0 || bf16 == 1) ||
      !(vl == 1 || vl == (bf16 ? 8 : 4)) || d % vl)
    return cudaErrorInvalidValue;
  if (num_edges == 0) return cudaSuccess;
  const int l_log2 = d <= 32 ? 0 : d <= 64 ? 1 : 2;
  const int lanes = 1 << l_log2;
  const int step = vl == 8 ? 8 : 4;
  const int nbc = ((d + lanes - 1) / lanes + step - 1) / step;
  const size_t mat = (static_cast<size_t>(d) * lanes * (step * nbc + 4) + 4) * sizeof(float);
  int slots = 0;
  size_t smem = 0;
  if (mode == DEDICOM) {
    smem = mat;
  } else if (mode == BILINEAR) {
    slots = static_cast<int>(SMEM_BUDGET / mat);
    if (slots < 1) slots = 1;
    if (n_k > 0 && slots > n_k) slots = n_k;
    smem = mat * slots;
  }
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const long long per_block = THREADS >> l_log2;
  const dim3 grid(static_cast<unsigned>((num_edges + per_block - 1) / per_block));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* iks = static_cast<const int32_t*>(ks);
  const auto* irows = static_cast<const int32_t*>(rows);
  const auto* icols = static_cast<const int32_t*>(cols);
  auto* fout = static_cast<float*>(out);
#define DT_MODE(B16, VL)                                                                 \
  return launch_mode<B16, VL>(mode, grid, smem, s, zr, zc, rel, glb, iks, irows, icols, \
                              fout, num_edges, d, n_r, n_c, n_k, l_log2, nbc, slots)
  if (bf16) {
    if (vl == 8) DT_MODE(true, 8);
    DT_MODE(true, 1);
  }
  if (vl == 4) DT_MODE(false, 4);
  DT_MODE(false, 1);
#undef DT_MODE
}

}  // extern "C"
