// Probes of the paired SpMM for Hopper (sm_90a): variants of K1/K2's
// former WMMA design that take its cost apart.
//
// Replaces the TPU probes
//   P3 scripts/probe_paired_parts.py::run (its kernel),
//   P2 scripts/probe_paired_orient.py::make_kernel.
// (P1 and P4, which measured the same design's forward in the node-major
// layout and its backward, now run the main path's sweep: paired_fwd.cu's
// dt_paired_fwd_aug and paired_bwd.cu's dt_paired_bwd_unscaled.)
//
// For K relations of an [Km >= K, N, N] mask B (int8, or bf16 for P2's
// both and small_t) and bf16 operands pe_k, po_k [H, N] (the halves of p4
// [2, K, H, N]) they compute, with f32 sums,
//
//   both / two_dots   out[h, n] = sum_k ae[k,n] (pe_k B_k^T)[h,n] + ao[k,n] (po_k B_k)[h,n]
//   direct (xe_only)  out = sum_k ae (pe_k B_k^T)
//   trans (xo_only, one_dot)  out = sum_k ao (po_k B_k)
//   m128 (m128_dot)   out = sum_k (pe_k B_k) + (po_k B_k): one mask orientation, both operands
//   dma (dma_only)    out = 0, after staging every operand as "both" does
//
// with the row scales ae, ao from sc [Km, 2, N] f32 (P2) or 1 (P3, sc
// null).  H <= 64 throughout (one hidden slice).
//
// Bound on this card: bytes.  Each mask byte is needed once (400 MB at the
// paper's K = 963, N = 645) and the products, 2 H N^2 per relation and
// orientation on the bf16 tensor cores, need about 0.1 ms of the card's
// peak there.
//
// Design.  The forward probes keep K1's former tiles, staging and
// accumulation so that their parts add up against that design's time: a
// block owns 64 output rows and the relations [b kb, (b+1) kb); per
// relation it sweeps the contraction in 64-wide chunks, stages the mask
// tiles (B[rows, chunk] for the direct orientation, B[chunk, rows] for the
// transposed one) as bf16 with one-byte loads and the operand chunks into
// shared memory, runs WMMA 16x16x16, and after each relation applies the
// row scales to the accumulators through shared memory.  Each block writes
// a partial output; a second pass adds the partials in block order, so two
// calls give equal bits.  "dma" stages exactly what "both" stages and
// skips the products; a checksum of the staged tiles, stored only under a
// flag that the wrapper never sets, keeps every load alive.
//
// small_t (P2) computes what "both" computes but stages each mask tile
// once and reads it in both orientations from shared memory (WMMA loads
// it row-major for the direct half and column-major for the transposed
// one).  A tile B[R, C] feeds output rows R (direct) and rows C
// (transposed), so a block owns a whole [N, 64] output strip in shared
// memory (N <= 768) and the relations [b kb, (b+1) kb); eight warps, four
// a half, and the row scales applied per tile product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;            // output rows per block
constexpr int TK = 64;            // contraction chunk
constexpr int HS = 64;            // hidden columns (H <= HS)
constexpr int WARPS = 4;          // each warp owns 16 output rows
constexpr int THREADS = WARPS * 32;
constexpr int LDA = TK + 8;       // bf16 row stride of the mask tiles
constexpr int LDP = HS + 8;       // bf16 row stride of the operand tiles
constexpr int LDC = HS + 4;       // f32 row stride of the accumulator staging
constexpr int NH = HS / 16;

constexpr int MASK_BYTES = TM * LDA * 2;
constexpr int OPND_BYTES = TK * LDP * 2;
constexpr int STAGE_BYTES = 2 * MASK_BYTES + 2 * OPND_BYTES;
constexpr int ACC_BYTES = 2 * TM * LDC * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > ACC_BYTES ? STAGE_BYTES : ACC_BYTES;

enum Mode { DIRECT = 1, TRANS = 2, BOTH = 3, M128 = 4, DMA = 5, SMALL_T = 6 };

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float as_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float as_f32(bf16 v) { return __bfloat162float(v); }

// me[r][c] = B[n0 + r, c0 + c] (K1's staging: one element a thread a step).
template <typename M>
__device__ __forceinline__ void stage_direct(bf16* me, const M* bk, int n0, int c0, int N,
                                             int tid, int threads) {
  for (int idx = tid; idx < TM * TK; idx += threads) {
    const int r = idx / TK, c = idx % TK;
    const int i = n0 + r, j = c0 + c;
    const float v = (i < N && j < N) ? as_f32(bk[static_cast<size_t>(i) * N + j]) : 0.f;
    me[r * LDA + c] = __float2bfloat16_rn(v);
  }
}

// mo[r][c] = B[c0 + c, n0 + r]: columns of B, for the transposed half.
template <typename M>
__device__ __forceinline__ void stage_trans(bf16* mo, const M* bk, int n0, int c0, int N,
                                            int tid) {
  for (int idx = tid; idx < TM * TK; idx += THREADS) {
    const int c = idx / TM, r = idx % TM;
    const int i = c0 + c, j = n0 + r;
    const float v = (i < N && j < N) ? as_f32(bk[static_cast<size_t>(i) * N + j]) : 0.f;
    mo[r * LDA + c] = __float2bfloat16_rn(v);
  }
}

// p[c][h] = the operand p_k [H, N] at contraction index c0 + c, hidden
// column h (zero past N and past H).
__device__ __forceinline__ void stage_operand(bf16* p, const bf16* pk, int c0, int N, int H,
                                              int nh, int tid, int threads) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int idx = tid; idx < nh * 16 * TK; idx += threads) {
    const int h = idx / TK, c = idx % TK;
    const int j = c0 + c;
    p[c * LDP + h] = (j < N && h < H) ? pk[static_cast<size_t>(h) * N + j] : zero;
  }
}

template <typename M, int MODE>
__global__ void __launch_bounds__(THREADS, 3)
probe_fwd_kernel(const M* __restrict__ mask, const bf16* __restrict__ pe_g,
                 const bf16* __restrict__ po_g, long long p_rel, const float* __restrict__ sc,
                 float* __restrict__ partial, int K, int N, int H, int kb, int sink) {
  constexpr bool STAGE_ME = MODE == DIRECT || MODE == BOTH || MODE == DMA;
  constexpr bool STAGE_MO = MODE != DIRECT;
  constexpr bool STAGE_PE = MODE != TRANS;
  constexpr bool STAGE_PO = MODE != DIRECT;
  constexpr bool HAS_E = MODE == DIRECT || MODE == BOTH || MODE == M128;
  constexpr bool HAS_O = MODE == TRANS || MODE == BOTH || MODE == M128;
  constexpr int PER_THREAD = TM * HS / THREADS;
  const int nh = (H + 15) / 16;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* me = reinterpret_cast<bf16*>(smem);
  bf16* mo = reinterpret_cast<bf16*>(smem + MASK_BYTES);
  bf16* pe = reinterpret_cast<bf16*>(smem + 2 * MASK_BYTES);
  bf16* po = reinterpret_cast<bf16*>(smem + 2 * MASK_BYTES + OPND_BYTES);
  // The accumulator staging reuses the same bytes once a relation is done.
  float* acc_e = reinterpret_cast<float*>(smem);
  float* acc_o = acc_e + TM * LDC;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * TM;
  const int k_begin = blockIdx.y * kb;
  const int k_end = k_begin + kb < K ? k_begin + kb : K;
  const size_t nn = static_cast<size_t>(N) * N;

  float total[PER_THREAD];
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) total[t] = 0.f;
  float checksum = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const M* bk = mask + k * nn;
    const bf16* pek = pe_g + k * p_rel;
    const bf16* pok = po_g + k * p_rel;

    FragC ce[NH], co[NH];
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      wmma::fill_fragment(ce[t], 0.f);
      wmma::fill_fragment(co[t], 0.f);
    }

    for (int c0 = 0; c0 < N; c0 += TK) {
      __syncthreads();  // the previous chunk (or staging) is consumed
      if (STAGE_ME) stage_direct(me, bk, n0, c0, N, tid, THREADS);
      if (STAGE_MO) stage_trans(mo, bk, n0, c0, N, tid);
      if (STAGE_PE) stage_operand(pe, pek, c0, N, H, nh, tid, THREADS);
      if (STAGE_PO) stage_operand(po, pok, c0, N, H, nh, tid, THREADS);
      __syncthreads();
      if (MODE == DMA) {
        if (sink) {
          const int x = (tid + c0) % (TM * LDA);
          checksum += __bfloat162float(me[x]) + __bfloat162float(mo[x]) +
                      __bfloat162float(pe[x % (TK * LDP)]) + __bfloat162float(po[x % (TK * LDP)]);
        }
        continue;
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        FragA fa_e, fa_o;
        if (STAGE_ME) wmma::load_matrix_sync(fa_e, me + warp * 16 * LDA + kk * 16, LDA);
        if (STAGE_MO) wmma::load_matrix_sync(fa_o, mo + warp * 16 * LDA + kk * 16, LDA);
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          if (t >= nh) break;
          FragB fb;
          if (HAS_E) {
            wmma::load_matrix_sync(fb, pe + kk * 16 * LDP + t * 16, LDP);
            if (MODE == M128)
              wmma::mma_sync(ce[t], fa_o, fb, ce[t]);
            else
              wmma::mma_sync(ce[t], fa_e, fb, ce[t]);
          }
          if (HAS_O) {
            wmma::load_matrix_sync(fb, po + kk * 16 * LDP + t * 16, LDP);
            wmma::mma_sync(co[t], fa_o, fb, co[t]);
          }
        }
      }
    }
    if (MODE == DMA) continue;
    __syncthreads();  // all warps are done with the staging bytes
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      if (t >= nh) break;
      if (HAS_E)
        wmma::store_matrix_sync(acc_e + warp * 16 * LDC + t * 16, ce[t], LDC, wmma::mem_row_major);
      if (HAS_O)
        wmma::store_matrix_sync(acc_o + warp * 16 * LDC + t * 16, co[t], LDC, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int e = tid + t * THREADS;
      const int r = e % TM, h = e / TM;  // threads on neighbouring rows
      const int n = n0 + r;
      if (n < N && h < H) {
        float se = 1.f, so = 1.f;
        if (sc != nullptr) {
          se = sc[static_cast<size_t>(k) * 2 * N + n];
          so = sc[static_cast<size_t>(k) * 2 * N + N + n];
        }
        float v = 0.f;
        if (HAS_E) v += se * acc_e[r * LDC + h];
        if (HAS_O) v += so * acc_o[r * LDC + h];
        total[t] += v;
      }
    }
  }

  float* dst = partial + blockIdx.y * static_cast<size_t>(H) * N;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int e = tid + t * THREADS;
    const int r = e % TM, h = e / TM;
    const int n = n0 + r;
    if (n < N && h < H) dst[static_cast<size_t>(h) * N + n] = total[t];
  }
  if (MODE == DMA && sink) dst[0] += checksum;
}

// small_t: each mask tile staged once, read in both orientations.
constexpr int ST_WARPS = 8;
constexpr int ST_THREADS = ST_WARPS * 32;
constexpr int ST_MAX_TILES = 12;  // N <= 768: the strip and the tiles fill 227 KB

__host__ __device__ constexpr int strip_smem_bytes(int tiles) {
  return tiles * TM * HS * 4 + MASK_BYTES + 2 * OPND_BYTES + ST_WARPS * 256 * 4;
}

template <typename M>
__global__ void __launch_bounds__(ST_THREADS, 1)
probe_small_t_kernel(const M* __restrict__ mask, const bf16* __restrict__ p4,
                     const float* __restrict__ sc, float* __restrict__ partial, int K, int N,
                     int H, int kb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = (N + TM - 1) / TM;
  float* strip = reinterpret_cast<float*>(smem);  // [tiles * TM][HS]: row n, column h
  bf16* tile = reinterpret_cast<bf16*>(smem + tiles * TM * HS * 4);  // B[R + r, C + c]
  bf16* pe = tile + TM * LDA;  // pe chunk at C
  bf16* po = pe + TK * LDP;    // po chunk at R
  float* scratch = reinterpret_cast<float*>(po + TK * LDP);  // [warp][16 * 16]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int half = warp / 4;      // 0: direct (rows R), 1: transposed (rows C)
  const int wrow = (warp % 4) * 16;
  const int nh = (H + 15) / 16;
  const int k_begin = blockIdx.x * kb;
  const int k_end = k_begin + kb < K ? k_begin + kb : K;
  const size_t nn = static_cast<size_t>(N) * N;
  float* scr = scratch + warp * 256;

  for (int x = tid; x < tiles * TM * HS; x += ST_THREADS) strip[x] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const M* bk = mask + k * nn;
    const bf16* pek = p4 + static_cast<size_t>(k) * H * N;
    const bf16* pok = p4 + (static_cast<size_t>(K) + k) * H * N;
    const float* ae = sc + static_cast<size_t>(k) * 2 * N;
    const float* ao = ae + N;
    for (int R = 0; R < tiles; ++R) {
      __syncthreads();  // the previous R's po chunk is consumed
      stage_operand(po, pok, R * TM, N, H, nh, tid, ST_THREADS);
      for (int C = 0; C < tiles; ++C) {
        if (C > 0) __syncthreads();  // the previous tile and pe chunk are consumed
        stage_direct(tile, bk, R * TM, C * TK, N, tid, ST_THREADS);
        stage_operand(pe, pek, C * TK, N, H, nh, tid, ST_THREADS);
        __syncthreads();
        FragC f[NH];
#pragma unroll
        for (int t = 0; t < NH; ++t) wmma::fill_fragment(f[t], 0.f);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          if (half == 0) {
            // rows R + wrow..: sum over the tile's columns of B[row, c] pe[c]
            FragA fa;
            wmma::load_matrix_sync(fa, tile + wrow * LDA + kk * 16, LDA);
#pragma unroll
            for (int t = 0; t < NH; ++t) {
              if (t >= nh) break;
              FragB fb;
              wmma::load_matrix_sync(fb, pe + kk * 16 * LDP + t * 16, LDP);
              wmma::mma_sync(f[t], fa, fb, f[t]);
            }
          } else {
            // rows C + wrow..: sum over the tile's rows of B[r, col] po[r]
            FragAT fa;
            wmma::load_matrix_sync(fa, tile + kk * 16 * LDA + wrow, LDA);
#pragma unroll
            for (int t = 0; t < NH; ++t) {
              if (t >= nh) break;
              FragB fb;
              wmma::load_matrix_sync(fb, po + kk * 16 * LDP + t * 16, LDP);
              wmma::mma_sync(f[t], fa, fb, f[t]);
            }
          }
        }
        // The direct half adds into rows R, then the transposed half into
        // rows C (the same rows when R == C): a fixed order.
        for (int phase = 0; phase < 2; ++phase) {
          if (phase > 0) __syncthreads();
          if (half != phase) continue;
          const int row0 = (half == 0 ? R : C) * TM + wrow;
          const float* s = half == 0 ? ae : ao;
#pragma unroll
          for (int t = 0; t < NH; ++t) {
            if (t >= nh) break;
            wmma::store_matrix_sync(scr, f[t], 16, wmma::mem_row_major);
            __syncwarp();
#pragma unroll
            for (int q = 0; q < 8; ++q) {
              const int e = lane + 32 * q;
              const int n = row0 + e / 16, h = t * 16 + e % 16;
              if (n < N && h < H) strip[n * HS + h] += s[n] * scr[e];
            }
            __syncwarp();
          }
        }
      }
    }
  }
  __syncthreads();
  float* dst = partial + static_cast<size_t>(blockIdx.x) * H * N;
  for (int x = tid; x < H * N; x += ST_THREADS) {
    const int h = x / N, n = x % N;
    dst[x] = strip[n * HS + h];
  }
}

// out[x] = sum over splits of partial[s, x], in split order.
__global__ void probe_sum_splits_kernel(const float* __restrict__ partial,
                                        float* __restrict__ out, int splits, size_t count) {
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < count;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * count + x];
    out[x] = acc;
  }
}

template <typename M, int MODE>
cudaError_t launch_fwd(const void* mask, const void* pe, const void* po, long long p_rel,
                       const float* sc, float* partial, int K, int N, int H, int kb,
                       int splits, cudaStream_t s) {
  dim3 grid((N + TM - 1) / TM, splits);
  probe_fwd_kernel<M, MODE><<<grid, THREADS, 0, s>>>(
      static_cast<const M*>(mask), static_cast<const bf16*>(pe), static_cast<const bf16*>(po),
      p_rel, sc, partial, K, N, H, kb, 0);
  return cudaGetLastError();
}

template <typename M>
cudaError_t launch_small_t(const void* mask, const void* p4, const float* sc, float* partial,
                           int K, int N, int H, int kb, int splits, cudaStream_t s) {
  const int tiles = (N + TM - 1) / TM;
  if (tiles > ST_MAX_TILES || sc == nullptr) return cudaErrorInvalidValue;
  const int bytes = strip_smem_bytes(tiles);
  cudaError_t err = cudaFuncSetAttribute(
      probe_small_t_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  probe_small_t_kernel<M><<<splits, ST_THREADS, bytes, s>>>(
      static_cast<const M*>(mask), static_cast<const bf16*>(p4), sc, partial, K, N, H, kb);
  return cudaGetLastError();
}

cudaError_t dispatch(int mode, int mask_bf16, const void* mask, const void* pe,
                     const void* po, long long p_rel, const float* sc, float* partial, int K,
                     int N, int H, int kb, int splits, cudaStream_t s) {
  if (mask_bf16) {
    switch (mode) {
      case BOTH: return launch_fwd<bf16, BOTH>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
      case SMALL_T: return launch_small_t<bf16>(mask, pe, sc, partial, K, N, H, kb, splits, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (mode) {
    case DIRECT: return launch_fwd<int8_t, DIRECT>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
    case TRANS: return launch_fwd<int8_t, TRANS>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
    case BOTH: return launch_fwd<int8_t, BOTH>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
    case M128: return launch_fwd<int8_t, M128>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
    case DMA: return launch_fwd<int8_t, DMA>(mask, pe, po, p_rel, sc, partial, K, N, H, kb, splits, s);
    case SMALL_T: return launch_small_t<int8_t>(mask, pe, sc, partial, K, N, H, kb, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Forward probes.  mask [Km >= K, N, N], int8 or bf16 (mask_bf16); pe, po
// bf16 operand stacks with p_rel elements a relation (the halves of p4
// [2, K, H, N]: pe = p4, po = p4 + K H N, p_rel = H N); sc f32 [Km, 2, N]
// row scales or null (required by small_t); mode: 1 direct, 2 trans, 3
// both, 4 m128, 5 dma, 6 small_t; kb relations a block.  partial: f32
// scratch of ceil(K / kb) outputs; out f32 [H, N].  int8 takes every
// mode; bf16 masks take both and small_t.
int dt_probe_paired(const void* mask, int mask_bf16, const void* pe, const void* po,
                    long long p_rel, const void* sc, int mode, void* partial, void* out, int K,
                    int N, int H, int kb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || N < 1 || H < 1 || H > HS || kb < 1) return cudaErrorInvalidValue;
  const int splits = (K + kb - 1) / kb;
  if (splits > 65535) return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  cudaError_t err = dispatch(mode, mask_bf16, mask, pe, po, p_rel, static_cast<const float*>(sc),
                             part, K, N, H, kb, splits, s);
  if (err != cudaSuccess) return err;
  const size_t count = static_cast<size_t>(H) * N;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  probe_sum_splits_kernel<<<blocks, 256, 0, s>>>(part, static_cast<float*>(out), splits, count);
  return cudaGetLastError();
}

}  // extern "C"
