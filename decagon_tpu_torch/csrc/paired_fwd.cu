// Paired factored SpMM forward for Hopper (sm_90a).
//
// Replaces the TPU kernel decagon_tpu/ops/spmm_paired.py::_fwd_kernel in
// both of its forms (small-N whole blocks and big-N 1024^2 blocks), which
// the JAX package splits only because of the TPU's scoped-memory limit.
// One kernel serves both here.  It computes, for one square
// transpose-paired edge type with K relation pairs over N nodes,
//
//   out[n, h] = sum_k a_e[k,n] * sum_j B_k[n,j] * bf16(p4[0,k,h,j] * b_e[k,j])
//             + a_o[k,n] * sum_i B_k[i,n] * bf16(p4[1,k,h,i] * b_o[k,i])
//
// with B the int8 edge-count mask [K, N, N] (direct half only), scales
// [K, 4, N] f32 rows (a_e, a_o, b_e, b_o), p4 [2, K, H, N] f32 (layer 1,
// the raw weights) or bf16 (layer 2, the projection), and out [N, H] f32.
// The cast points are the reference's: p * b rounds to bf16 (round to
// nearest even), the mask converts to bf16 exactly, products are exact in
// f32 and every sum is f32.
//
// Dropout keep-scales (K1/K2-ds, the identity-feature layer 1 under
// dropout; ``has_ds=True`` in the TPU kernel): ``ds`` f32 [K, 2, N], or
// null.  When given, the operands are bf16((p4[0,k,h,j] * ds[k,0,j]) *
// b_e[k,j]) and bf16((p4[1,k,h,i] * ds[k,1,i]) * b_o[k,i]), in the order of
// the plain version ``paired_ref_ds``.
//
// Any hidden width H: a block covers up to 64 columns of H (grid.z walks
// the slices); a partial 16-wide fragment is zero-padded in shared memory
// and its columns are not stored.
//
// Bound on this card: memory.  The mask is read once per orientation and
// is ~400 MB per layer at paper scale; the arithmetic (4*H*N^2 per pair)
// runs on the bf16 tensor cores through WMMA 16x16x16 fragments, far
// below their peak.
//
// Design.  A block owns TM = 64 output rows and a contiguous range of
// relations (a "split"): for each relation it sweeps the inner dimension
// in TK = 64 chunks, staging B[rows, chunk] (direct orientation) and
// B[chunk, rows]^T (transposed orientation) as bf16 in shared memory with
// the scaled operand chunks, and accumulates both products in registers.
// After each relation the two accumulators go through shared memory once
// so the per-row scales a_e / a_o can be applied, and the result adds
// into the block's running total.  Blocks never share output: each split
// writes its own partial [N, H], and a second pass sums the partials in
// split order.  The result is therefore deterministic.  Each B_k tile is
// read twice, once per orientation; reading it once for both halves (as
// the TPU kernel does) is later work, as are wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;            // output rows per block
constexpr int TK = 64;            // inner-dimension chunk
constexpr int WARPS = 4;          // each warp owns 16 output rows
constexpr int THREADS = WARPS * 32;
constexpr int LDA = TK + 8;       // bf16 row stride of the mask tiles

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int HS = 64;            // hidden columns per block (one slice)

struct Layout {
  static constexpr int LDP = HS + 8;  // bf16 row stride of operand tiles
  static constexpr int LDC = HS + 4;  // f32 row stride of accumulator staging
  static constexpr int MASK_BYTES = TM * LDA * 2;
  static constexpr int OPND_BYTES = TK * LDP * 2;
  static constexpr int STAGE_BYTES = 2 * MASK_BYTES + 2 * OPND_BYTES;
  static constexpr int ACC_BYTES = 2 * TM * LDC * 4;
  static constexpr int BYTES = STAGE_BYTES > ACC_BYTES ? STAGE_BYTES : ACC_BYTES;
};

// Three blocks an SM: the PPI call has only ceil(19081 / 64) = 299 blocks,
// which then run in one wave on 132 SMs (at two, the register count the
// runtime width guards reach uncapped, they take two).
template <typename P>
__global__ void __launch_bounds__(THREADS, 3)
paired_fwd_kernel(const int8_t* __restrict__ mask, const P* __restrict__ p4,
                  const float* __restrict__ scales, const float* __restrict__ ds,
                  float* __restrict__ partial, int K, int N, int H, int splits) {
  using L = Layout;
  constexpr int NH = HS / 16;
  constexpr int PER_THREAD = TM * HS / THREADS;
  const int h0 = blockIdx.z * HS;
  const int hs = H - h0 < HS ? H - h0 : HS;  // columns of this slice
  const int nh = (hs + 15) / 16;             // fragments that hold them
  __shared__ __align__(128) unsigned char smem[L::BYTES];
  __nv_bfloat16* me = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* mo = reinterpret_cast<__nv_bfloat16*>(smem + L::MASK_BYTES);
  __nv_bfloat16* pe = reinterpret_cast<__nv_bfloat16*>(smem + 2 * L::MASK_BYTES);
  __nv_bfloat16* po = reinterpret_cast<__nv_bfloat16*>(
      smem + 2 * L::MASK_BYTES + L::OPND_BYTES);
  // The accumulator staging reuses the same bytes once a relation is done.
  float* acc_e = reinterpret_cast<float*>(smem);
  float* acc_o = acc_e + TM * L::LDC;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int k_begin = static_cast<int>(static_cast<long long>(K) * split / splits);
  const int k_end = static_cast<int>(static_cast<long long>(K) * (split + 1) / splits);
  const size_t nn = static_cast<size_t>(N) * N;

  float total[PER_THREAD];
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) total[t] = 0.f;

  for (int k = k_begin; k < k_end; ++k) {
    const int8_t* bk = mask + k * nn;
    const P* pe_g = p4 + (static_cast<size_t>(k) * H + h0) * N;
    const P* po_g = p4 + ((static_cast<size_t>(K) + k) * H + h0) * N;
    const float* sc = scales + static_cast<size_t>(k) * 4 * N;
    const float* dk = ds == nullptr ? nullptr : ds + static_cast<size_t>(k) * 2 * N;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> ce[NH], co[NH];
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      wmma::fill_fragment(ce[t], 0.f);
      wmma::fill_fragment(co[t], 0.f);
    }

    for (int c0 = 0; c0 < N; c0 += TK) {
      __syncthreads();  // the previous chunk (or staging) is consumed
      // me[r][c] = B_k[n0 + r, c0 + c]: rows of the direct orientation.
      for (int idx = tid; idx < TM * TK; idx += THREADS) {
        const int r = idx / TK, c = idx % TK;
        const int i = n0 + r, j = c0 + c;
        const int v = (i < N && j < N) ? bk[static_cast<size_t>(i) * N + j] : 0;
        me[r * LDA + c] = __float2bfloat16_rn(static_cast<float>(v));
      }
      // mo[r][c] = B_k[c0 + c, n0 + r]: columns, for the transposed half.
      for (int idx = tid; idx < TM * TK; idx += THREADS) {
        const int c = idx / TM, r = idx % TM;
        const int i = c0 + c, j = n0 + r;
        const int v = (i < N && j < N) ? bk[static_cast<size_t>(i) * N + j] : 0;
        mo[r * LDA + c] = __float2bfloat16_rn(static_cast<float>(v));
      }
      // pe[c][h] = bf16(p4[0,k,h0+h,c0+c] * b_e[c0+c]); po likewise with
      // b_o; the keep-scales, when given, multiply p first.
      for (int idx = tid; idx < nh * 16 * TK; idx += THREADS) {
        const int h = idx / TK, c = idx % TK;
        const int j = c0 + c;
        float ve = 0.f, vo = 0.f;
        if (j < N && h < hs) {
          ve = as_f32(pe_g[static_cast<size_t>(h) * N + j]);
          vo = as_f32(po_g[static_cast<size_t>(h) * N + j]);
          if (dk != nullptr) {
            ve *= dk[j];
            vo *= dk[N + j];
          }
          ve *= sc[2 * N + j];
          vo *= sc[3 * N + j];
        }
        pe[c * L::LDP + h] = __float2bfloat16_rn(ve);
        po[c * L::LDP + h] = __float2bfloat16_rn(vo);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa_e, fa_o;
        wmma::load_matrix_sync(fa_e, me + warp * 16 * LDA + kk * 16, LDA);
        wmma::load_matrix_sync(fa_o, mo + warp * 16 * LDA + kk * 16, LDA);
#pragma unroll
        for (int t = 0; t < NH; ++t) {
          if (t >= nh) break;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, pe + kk * 16 * L::LDP + t * 16, L::LDP);
          wmma::mma_sync(ce[t], fa_e, fb, ce[t]);
          wmma::load_matrix_sync(fb, po + kk * 16 * L::LDP + t * 16, L::LDP);
          wmma::mma_sync(co[t], fa_o, fb, co[t]);
        }
      }
    }
    __syncthreads();  // all warps are done with the staging bytes
#pragma unroll
    for (int t = 0; t < NH; ++t) {
      if (t >= nh) break;
      wmma::store_matrix_sync(acc_e + warp * 16 * L::LDC + t * 16, ce[t], L::LDC,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(acc_o + warp * 16 * L::LDC + t * 16, co[t], L::LDC,
                              wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int e = tid + t * THREADS;
      const int r = e / HS, h = e % HS;
      const int n = n0 + r;
      if (n < N && h < hs) {
        total[t] += sc[n] * acc_e[r * L::LDC + h] + sc[N + n] * acc_o[r * L::LDC + h];
      }
    }
  }

  float* dst = partial + static_cast<size_t>(split) * N * H;
#pragma unroll
  for (int t = 0; t < PER_THREAD; ++t) {
    const int e = tid + t * THREADS;
    const int r = e / HS, h = e % HS;
    const int n = n0 + r;
    if (n < N && h < hs) dst[static_cast<size_t>(n) * H + h0 + h] = total[t];
  }
}

// out[x] = sum over splits of partial[s, x], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  size_t count) {
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       x < count; x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * count + x];
    out[x] = acc;
  }
}

template <typename P>
void launch(const void* mask, const void* p4, const void* scales, const float* ds,
            float* partial, int K, int N, int H, int splits, cudaStream_t stream) {
  dim3 grid((N + TM - 1) / TM, splits, (H + HS - 1) / HS);
  paired_fwd_kernel<P><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(mask), static_cast<const P*>(p4),
      static_cast<const float*>(scales), ds, partial, K, N, H, splits);
}

}  // namespace

extern "C" {

// mask int8 [K, N, N]; p4 [2, K, H, N] (f32, or bf16 when p_is_bf16);
// scales f32 [K, 4, N]; ds f32 [K, 2, N] keep-scales or null; out f32
// [N, H].  ``partial`` is scratch of [splits, N, H] f32, or ``out`` itself
// when splits == 1.
int dt_paired_fwd(const void* mask, const void* p4, int p_is_bf16,
                  const void* scales, const void* ds, void* partial, void* out,
                  int K, int N, int H, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || N < 1 || H < 1 || splits < 1 || splits > K || splits > 65535 ||
      (H + HS - 1) / HS > 65535)
    return cudaErrorInvalidValue;
  float* part = static_cast<float*>(partial);
  const float* dsf = static_cast<const float*>(ds);
  if (p_is_bf16)
    launch<__nv_bfloat16>(mask, p4, scales, dsf, part, K, N, H, splits, s);
  else
    launch<float>(mask, p4, scales, dsf, part, K, N, H, splits, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = static_cast<size_t>(N) * H;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(part, static_cast<float*>(out), splits, count);
  return cudaGetLastError();
}

const char* dt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
