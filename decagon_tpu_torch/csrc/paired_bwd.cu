// Paired factored SpMM backward for Hopper (sm_90a).
//
// Replaces the TPU kernels decagon_tpu/ops/spmm_paired.py::_bwd_kernel_small
// (K3, whole-N blocks) and ::_bwd_kernel_big (K4, 1024^2 blocks, K == 1
// only).  One kernel serves both forms here, for any K.  For one square
// transpose-paired edge type with K relation pairs over N nodes and the
// cotangent ct [H, N] f32 of the forward's output outT, it computes
//
//   d[0,k,h,j] = s_e[k,j] * sum_i B_k[i,j] * bf16(a_e[k,i] * ct[h,i])
//   d[1,k,h,i] = s_o[k,i] * sum_j B_k[i,j] * bf16(a_o[k,j] * ct[h,j])
//
// with B the int8 edge-count mask [K, N, N], scales [K, 4, N] f32 rows
// (a_e, a_o, b_e, b_o), s_e = b_e * ds[k,0] and s_o = b_o * ds[k,1] when
// the dropout keep-scales ds f32 [K, 2, N] are given (the identity-feature
// layer 1: d is then the finished weight gradient), else s = b.  d is
// [2, K, H, N] in f32 or bf16 (the primal's dtype).  Cast points are the
// TPU kernel's: a * ct rounds to bf16, the mask converts exactly, products
// are exact and sums f32.
//
// Bound on this card: memory.  Each relation's mask is read (400 MB per
// call at the paper's drug-drug shape) and d is written (318 MB f32 at
// layer 1); the arithmetic, 4*H*N^2 per pair on the bf16 tensor cores, is
// far below their peak.
//
// Design.  The backward has no sum over relations: each (relation, 64-node
// output tile, 64-column hidden slice) is one block that owns its piece of
// d for both halves and sweeps the whole contraction dimension in a fixed
// order, so there are no atomics and two calls are bitwise equal.  Per
// 64-wide chunk of the contraction it needs two 64 x 64 mask tiles: rows
// n0.. of B (direct half 1) and rows c0.. read at columns n0.. (half 0).
// Mask rows have N bytes and N need not be a multiple of 16, so each tile
// row is fetched as the five 16-byte-aligned chunks that cover it, by
// cp.async into a raw shared buffer, double-buffered: the next chunk's
// copies fly while this chunk converts to bf16 and runs WMMA 16x16x16.
// The cotangent chunk, shared by every relation, stays in L2.  The 1.25x
// over-fetch of the aligned chunks and the second read of each mask byte
// (once per half) are the price of owning outputs; reading a tile once for
// both halves would need a reduction across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TN = 64;            // output nodes per block
constexpr int TK = 64;            // contraction chunk
constexpr int HS = 64;            // hidden columns per block (one slice)
constexpr int WARPS = 4;          // each warp owns 16 output nodes
constexpr int THREADS = WARPS * 32;
constexpr int RAW_LD = 80;        // bytes per raw tile row: five 16-byte chunks
constexpr int LDA = TK + 8;       // bf16 row stride of the mask tiles
constexpr int LDP = HS + 8;       // bf16 row stride of the operand tiles
constexpr int LDC = HS + 4;       // f32 row stride of the accumulator staging

constexpr int RAW_BYTES = 2 * 2 * TN * RAW_LD;   // 2 stages x 2 tiles
constexpr int MASK_BYTES = TN * LDA * 2;
constexpr int OPND_BYTES = TK * LDP * 2;
constexpr int WORK_BYTES = 2 * MASK_BYTES + 2 * OPND_BYTES;
constexpr int ACC_BYTES = 2 * TN * LDC * 4;
constexpr int SMEM_BYTES =
    RAW_BYTES + (WORK_BYTES > ACC_BYTES ? WORK_BYTES : ACC_BYTES);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Copy mask rows row0 .. row0+63, bytes col0 .. col0+63 of each, as the
// 16-byte-aligned chunks covering them, into raw [64][RAW_LD].  Rows past
// N are skipped (the conversion zeroes them); a chunk that would cross the
// end of the mask is copied byte by byte.
__device__ __forceinline__ void issue_tile(unsigned char* raw, const int8_t* bk,
                                           const unsigned char* end, int row0,
                                           int col0, int N, int tid) {
  for (int idx = tid; idx < TN * 5; idx += THREADS) {
    const int r = idx / 5, q = idx % 5;
    const int row = row0 + r;
    if (row >= N) continue;
    const uintptr_t start = reinterpret_cast<uintptr_t>(
        bk + static_cast<size_t>(row) * N + col0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>((start & ~uintptr_t(15)) + 16 * q);
    unsigned char* dst = raw + r * RAW_LD + 16 * q;
    if (src + 16 <= end) {
      cp_async16(dst, src);
    } else {
      for (int b = 0; b < 16; ++b) dst[b] = src + b < end ? src[b] : 0;
    }
  }
}

// The byte of tile row r at column c: raw holds the aligned chunks, so the
// row's first byte sits at the start address's offset within 16 bytes.
__device__ __forceinline__ float tile_byte(const unsigned char* raw,
                                           const int8_t* bk, int row, int col0,
                                           int r, int c, int N) {
  const int off = static_cast<int>(
      reinterpret_cast<uintptr_t>(bk + static_cast<size_t>(row) * N + col0) & 15);
  return static_cast<float>(static_cast<int8_t>(raw[r * RAW_LD + off + c]));
}

template <typename O>
__global__ void __launch_bounds__(THREADS)
paired_bwd_kernel(const int8_t* __restrict__ mask, const float* __restrict__ ct,
                  const float* __restrict__ scales, const float* __restrict__ ds,
                  O* __restrict__ d, int K, int N, int H) {
  constexpr int NH = HS / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* raw = smem;  // [stage][tile][TN][RAW_LD]
  unsigned char* work = smem + RAW_BYTES;
  __nv_bfloat16* md = reinterpret_cast<__nv_bfloat16*>(work);  // B[n0+r, c0+c]
  __nv_bfloat16* mt = reinterpret_cast<__nv_bfloat16*>(work + MASK_BYTES);  // B[c0+c, n0+r]
  __nv_bfloat16* ce = reinterpret_cast<__nv_bfloat16*>(work + 2 * MASK_BYTES);
  __nv_bfloat16* co = reinterpret_cast<__nv_bfloat16*>(
      work + 2 * MASK_BYTES + OPND_BYTES);
  float* acc0 = reinterpret_cast<float*>(work);  // after the sweep
  float* acc1 = acc0 + TN * LDC;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * TN;
  const int k = blockIdx.y;
  const int h0 = blockIdx.z * HS;
  const int hs = H - h0 < HS ? H - h0 : HS;
  const int nh = (hs + 15) / 16;
  const size_t nn = static_cast<size_t>(N) * N;
  const int8_t* bk = mask + k * nn;
  const unsigned char* end = reinterpret_cast<const unsigned char*>(mask) + K * nn;
  const float* sc = scales + static_cast<size_t>(k) * 4 * N;
  const float* ct_h = ct + static_cast<size_t>(h0) * N;

  // f0: half 0 (output node j = n0 + row, contraction over i);
  // f1: half 1 (output node i = n0 + row, contraction over j).
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f0[NH], f1[NH];
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    wmma::fill_fragment(f0[t], 0.f);
    wmma::fill_fragment(f1[t], 0.f);
  }

  const int chunks = (N + TK - 1) / TK;
  issue_tile(raw, bk, end, n0, 0, N, tid);
  issue_tile(raw + TN * RAW_LD, bk, end, 0, n0, N, tid);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = ci * TK;
    if (ci + 1 < chunks) {
      unsigned char* nxt = raw + ((ci + 1) & 1) * 2 * TN * RAW_LD;
      issue_tile(nxt, bk, end, n0, c0 + TK, N, tid);
      issue_tile(nxt + TN * RAW_LD, bk, end, c0 + TK, n0, N, tid);
    }
    cp_async_commit();
    cp_async_wait_1();   // this chunk's copies have landed (this thread's)
    __syncthreads();     // ... and every thread's; the last MMA is done
    const unsigned char* rd = raw + (ci & 1) * 2 * TN * RAW_LD;
    const unsigned char* rt = rd + TN * RAW_LD;
    // md[r][c] = B[n0 + r, c0 + c]
    for (int idx = tid; idx < TN * TK; idx += THREADS) {
      const int r = idx / TK, c = idx % TK;
      const int i = n0 + r, j = c0 + c;
      const float v = (i < N && j < N) ? tile_byte(rd, bk, i, c0, r, c, N) : 0.f;
      md[r * LDA + c] = __float2bfloat16_rn(v);
    }
    // mt[r][c] = B[c0 + c, n0 + r]
    for (int idx = tid; idx < TN * TK; idx += THREADS) {
      const int c = idx / TN, r = idx % TN;
      const int i = c0 + c, j = n0 + r;
      const float v = (i < N && j < N) ? tile_byte(rt, bk, i, n0, c, r, N) : 0.f;
      mt[r * LDA + c] = __float2bfloat16_rn(v);
    }
    // ce[c][h] = bf16(a_e[c0+c] * ct[h0+h, c0+c]); co likewise with a_o.
    for (int idx = tid; idx < nh * 16 * TK; idx += THREADS) {
      const int h = idx / TK, c = idx % TK;
      const int x = c0 + c;
      float ve = 0.f, vo = 0.f;
      if (x < N && h < hs) {
        const float g = ct_h[static_cast<size_t>(h) * N + x];
        ve = sc[x] * g;
        vo = sc[N + x] * g;
      }
      ce[c * LDP + h] = __float2bfloat16_rn(ve);
      co[c * LDP + h] = __float2bfloat16_rn(vo);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> at, ad;
      wmma::load_matrix_sync(at, mt + warp * 16 * LDA + kk * 16, LDA);
      wmma::load_matrix_sync(ad, md + warp * 16 * LDA + kk * 16, LDA);
#pragma unroll
      for (int t = 0; t < NH; ++t) {
        if (t >= nh) break;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, ce + kk * 16 * LDP + t * 16, LDP);
        wmma::mma_sync(f0[t], at, fb, f0[t]);
        wmma::load_matrix_sync(fb, co + kk * 16 * LDP + t * 16, LDP);
        wmma::mma_sync(f1[t], ad, fb, f1[t]);
      }
    }
  }
  __syncthreads();  // every warp is done with the work tiles
#pragma unroll
  for (int t = 0; t < NH; ++t) {
    if (t >= nh) break;
    wmma::store_matrix_sync(acc0 + warp * 16 * LDC + t * 16, f0[t], LDC,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(acc1 + warp * 16 * LDC + t * 16, f1[t], LDC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const float* dk = ds == nullptr ? nullptr : ds + static_cast<size_t>(k) * 2 * N;
  O* d0 = d + (static_cast<size_t>(k) * H + h0) * N;
  O* d1 = d + ((static_cast<size_t>(K) + k) * H + h0) * N;
  for (int idx = tid; idx < hs * TN; idx += THREADS) {
    const int h = idx / TN, r = idx % TN;
    const int n = n0 + r;
    if (n >= N) continue;
    float s0 = sc[2 * N + n], s1 = sc[3 * N + n];
    if (dk != nullptr) {
      s0 *= dk[n];
      s1 *= dk[N + n];
    }
    store(d0 + static_cast<size_t>(h) * N + n, s0 * acc0[r * LDC + h]);
    store(d1 + static_cast<size_t>(h) * N + n, s1 * acc1[r * LDC + h]);
  }
}

template <typename O>
cudaError_t launch(const void* mask, const void* ct, const void* scales,
                   const void* ds, void* d, int K, int N, int H,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      paired_bwd_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + TN - 1) / TN, K, (H + HS - 1) / HS);
  paired_bwd_kernel<O><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(mask), static_cast<const float*>(ct),
      static_cast<const float*>(scales), static_cast<const float*>(ds),
      static_cast<O*>(d), K, N, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mask int8 [K, N, N] (16-byte aligned); ct f32 [H, N]; scales f32
// [K, 4, N]; ds f32 [K, 2, N] keep-scales or null; d [2, K, H, N], f32 or
// bf16 when out_bf16.
int dt_paired_bwd(const void* mask, const void* ct, const void* scales,
                  const void* ds, void* d, int out_bf16, int K, int N, int H,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > 65535 || N < 1 || H < 1 || (H + HS - 1) / HS > 65535 ||
      (reinterpret_cast<uintptr_t>(mask) & 15) != 0)
    return cudaErrorInvalidValue;
  return out_bf16
      ? launch<__nv_bfloat16>(mask, ct, scales, ds, d, K, N, H, s)
      : launch<float>(mask, ct, scales, ds, d, K, N, H, s);
}

}  // extern "C"
