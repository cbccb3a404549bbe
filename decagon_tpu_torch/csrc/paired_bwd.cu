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
// Design: the forward's sweep (paired_core.cuh) with the operands and the
// epilogue of the backward.
// 1. An operand pass writes q [2][K][Hq][Npad] bf16, q[t][k][h][x] =
//    bf16(scales[k,t,x] * ct[h,x]) (zero past N and H) from the
//    L2-resident ct.  The direct tile (rows of B) meets q[1] and gives
//    d[1]; the transposed tile meets q[0] and gives d[0].
// 2. The sweep: ``ops/spmm_paired.paired_schedule`` gives each block 64
//    nodes, a hidden slice, a range of relations and, where K x node tiles
//    would not fill whole waves (K = 1), a range of the contraction.  At
//    each relation's end a warp multiplies its accumulators by s per node
//    in registers and stores them.  The backward has no sum over
//    relations, so a block owns its piece of d: no atomics, bitwise
//    repeatable.
// 3. With the contraction split, blocks store unscaled f32 partials
//    instead, and a last pass sums them in a fixed order, applies s and
//    casts.

#include "paired_core.cuh"

namespace {

using namespace paired;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// q[t][k][h][x] = bf16(scales[k,t,x] * ct[h,x]) for h < H and x < N, else
// 0.  Grid: x walks the 2 K Hq rows, y the row's groups of eight columns.
__global__ void bwd_operands_kernel(const float* __restrict__ ct,
                                    const float* __restrict__ scales,
                                    __nv_bfloat16* __restrict__ q, int K, int N, int H, int Hq,
                                    int Npad) {
  const int row = blockIdx.x;  // (t * K + k) * Hq + h
  const int h = row % Hq, tk = row / Hq, k = tk % K, t = tk / K;
  const int j0 = 8 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (j0 >= Npad) return;
  const float* a = scales + (static_cast<size_t>(k) * 4 + t) * N;
  const float* g = ct + static_cast<size_t>(h) * N;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = j0 + e;
    v[e] = __float2bfloat16_rn(h < H && j < N ? a[j] * g[j] : 0.f);
  }
  *reinterpret_cast<uint4*>(q + static_cast<size_t>(row) * Npad + j0) =
      *reinterpret_cast<const uint4*>(v);
}

// Per relation: the direct half (half 0) holds d[1]'s piece, the
// transposed half d[0]'s.  Stored finished (s applied, cast) or, with the
// contraction split, as this split's f32 partial [2][K][H][N].
template <typename O>
struct BwdEpilogue {
  const float* scales;
  const float* ds;
  O* d;
  float* part;  // this split's partial, or null
  int K, N, H, n0, h0;

  __device__ __forceinline__ void relation(int k, int half, int rg, int lane,
                                           const float (&acc)[8][4]) {
    const int t = 1 - half;
    const int n = n0 + 16 * rg + (lane >> 2), c = h0 + 2 * (lane & 3);
    const size_t base = (static_cast<size_t>(t) * K + k) * H;
    if (part != nullptr) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int nn = n + (e >> 1) * 8, h = c + 8 * j + (e & 1);
          if (nn < N && h < H) part[(base + h) * N + nn] = acc[j][e];
        }
      return;
    }
    float s[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nn = n + 8 * e;
      s[e] = 0.f;
      if (nn < N) {
        s[e] = scales[(static_cast<size_t>(k) * 4 + 2 + t) * N + nn];
        if (ds != nullptr) s[e] *= ds[(static_cast<size_t>(k) * 2 + t) * N + nn];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nn = n + (e >> 1) * 8, h = c + 8 * j + (e & 1);
        if (nn < N && h < H) store(d + (base + h) * N + nn, s[e >> 1] * acc[j][e]);
      }
  }
};

template <typename O>
__global__ void __launch_bounds__(THREADS, 2)
paired_bwd_kernel(const int8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ q,
                  const float* __restrict__ scales, const float* __restrict__ ds,
                  O* __restrict__ d, float* __restrict__ partial, int K, int N, int H, int Hq,
                  int rel_splits, int con_splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t half_q = static_cast<size_t>(K) * Hq * ((N + TK - 1) / TK * TK);
  const Sweep s = block_sweep(mask, K, N, Hq, q + half_q, q, rel_splits, con_splits);
  float* part = nullptr;
  if (con_splits > 1)
    part = partial + static_cast<size_t>(blockIdx.y % con_splits) * 2 * K * H * N;
  BwdEpilogue<O> epi{scales, ds, d, part, K, N, H, s.n0, s.h0};
  sweep(s, epi, smem);
}

// d[x] = s(x) * sum over splits of partial[c, x], in split order, cast.
template <typename O>
__global__ void bwd_reduce_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scales,
                                  const float* __restrict__ ds, O* __restrict__ d, int splits,
                                  int K, int N, int H) {
  const size_t count = 2ull * K * H * N;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < count;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int n = static_cast<int>(x % N);
    const size_t tk = x / (static_cast<size_t>(H) * N);
    const int k = static_cast<int>(tk % K), t = static_cast<int>(tk / K);
    float acc = 0.f;
    for (int c = 0; c < splits; ++c) acc += partial[c * count + x];
    float sc = scales[(static_cast<size_t>(k) * 4 + 2 + t) * N + n];
    if (ds != nullptr) sc *= ds[(static_cast<size_t>(k) * 2 + t) * N + n];
    store(d + x, sc * acc);
  }
}

template <typename O>
cudaError_t launch(const void* mask, const __nv_bfloat16* q, const float* scales,
                   const float* ds, void* d, float* partial, int K, int N, int H, int Hq,
                   int rel_splits, int con_splits, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      paired_bwd_kernel<O>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TM - 1) / TM, rel_splits * con_splits, (H + HS - 1) / HS);
  paired_bwd_kernel<O><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const int8_t*>(mask), q, scales, ds, static_cast<O*>(d), partial, K, N, H,
      Hq, rel_splits, con_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || con_splits == 1) return err;
  const size_t count = 2ull * K * H * N;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  bwd_reduce_kernel<O><<<blocks, 256, 0, stream>>>(partial, scales, ds, static_cast<O*>(d),
                                                   con_splits, K, N, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mask int8 [K, N, N]; ct f32 [H, N]; scales f32 [K, 4, N]; ds f32
// [K, 2, N] keep-scales or null; q scratch bf16 [2, K, Hq, Npad] (Hq = H
// rounded up to 16, Npad = N rounded up to 64); partial scratch f32
// [con_splits, 2, K, H, N] when con_splits > 1 (else unused); d
// [2, K, H, N], f32 or bf16 when out_bf16.
int dt_paired_bwd(const void* mask, const void* ct, const void* scales, const void* ds,
                  void* q, void* partial, void* d, int out_bf16, int K, int N, int H,
                  int rel_splits, int con_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Hq = (H + 15) / 16 * 16, chunks = (N + TK - 1) / TK, Npad = chunks * TK;
  const long long rows = 2LL * K * Hq;
  if (K < 1 || N < 1 || H < 1 || rel_splits < 1 || rel_splits > K || con_splits < 1 ||
      con_splits > chunks || static_cast<long long>(rel_splits) * con_splits > 65535 ||
      (H + HS - 1) / HS > 65535 || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* dsf = static_cast<const float*>(ds);
  const dim3 pass(static_cast<unsigned>(rows), (Npad / 8 + 127) / 128);
  bwd_operands_kernel<<<pass, 128, 0, st>>>(static_cast<const float*>(ct), sc, qb, K, N, H,
                                            Hq, Npad);
  float* part = static_cast<float*>(partial);
  return out_bf16 ? launch<__nv_bfloat16>(mask, qb, sc, dsf, d, part, K, N, H, Hq,
                                          rel_splits, con_splits, st)
                  : launch<float>(mask, qb, sc, dsf, d, part, K, N, H, Hq, rel_splits,
                                  con_splits, st);
}

// The sweep kernel's registers, blocks an SM, shared and local bytes, as
// dt_paired_fwd_info (the f32-output instantiation).
int dt_paired_bwd_info(int* info) {
  cudaError_t err = cudaFuncSetAttribute(
      paired_bwd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, paired_bwd_kernel<float>);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], paired_bwd_kernel<float>,
                                                      THREADS, SMEM_BYTES);
  info[0] = attr.numRegs;
  info[2] = SMEM_BYTES;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // extern "C"
