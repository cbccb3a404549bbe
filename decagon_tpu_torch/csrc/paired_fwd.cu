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
// Bound on this card: memory.  The mask is ~400 MB per layer at paper
// scale; the arithmetic (4*H*N^2 per pair) is ~0.1 ms at the bf16
// tensor-core rate.
//
// Design (paired_core.cuh holds the staging and the products,
// paired_fwd.cuh the sweep kernel with its epilogue).
// 1. An operand pass writes q [2][K][Hq][Npad] bf16: the scaled, rounded
//    operands in p4's own [H, N] layout, Hq = H rounded up to 16 and Npad
//    = N rounded up to 64, zero beyond.  The sweep then copies them with
//    aligned 16-byte cp.async and never rescales them per node tile.
// 2. The sweep: a block owns 64 nodes, a 64-column hidden slice, a range
//    of relations and a range of contraction chunks, chosen by
//    ``ops/spmm_paired.paired_schedule`` so the grid fills whole waves at
//    the occupancy the card reports (it splits the contraction when K is
//    small, as at K = 1).  At each relation's end a warp multiplies its
//    accumulators by a_e (direct half) or a_o (transposed half) per node,
//    in registers, into a running total.
// 3. At the block's end the two halves' totals meet through shared memory
//    once and the block writes its partial [N, H]; a last pass sums the
//    partials in a fixed order, so the result is deterministic.

#include "paired_fwd.cuh"

namespace {

__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// q[t][k][h][j] = bf16((p4[t,k,h,j] * ds[k,t,j]) * scales[k,2+t,j]) for
// h < H and j < N, else 0.  Grid: x walks the 2 K Hq rows, y the row's
// 16-byte groups of eight columns.
template <typename P>
__global__ void fwd_operands_kernel(const P* __restrict__ p4, const float* __restrict__ scales,
                                    const float* __restrict__ ds,
                                    __nv_bfloat16* __restrict__ q, int K, int N, int H, int Hq,
                                    int Npad) {
  const int row = blockIdx.x;  // (t * K + k) * Hq + h
  const int h = row % Hq, tk = row / Hq, k = tk % K, t = tk / K;
  const int j0 = 8 * (blockIdx.y * blockDim.x + threadIdx.x);
  if (j0 >= Npad) return;
  const P* src = p4 + (static_cast<size_t>(tk) * H + h) * N;
  const float* b = scales + (static_cast<size_t>(k) * 4 + 2 + t) * N;
  const float* d = ds == nullptr ? nullptr : ds + (static_cast<size_t>(k) * 2 + t) * N;
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int j = j0 + e;
    float f = 0.f;
    if (h < H && j < N) {
      f = as_f32(src[j]);
      if (d != nullptr) f *= d[j];
      f *= b[j];
    }
    v[e] = __float2bfloat16_rn(f);
  }
  *reinterpret_cast<uint4*>(q + static_cast<size_t>(row) * Npad + j0) =
      *reinterpret_cast<const uint4*>(v);
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

constexpr auto MainSweep = paired_fwd_kernel<WholeSweep>;

}  // namespace

extern "C" {

// mask int8 [K, N, N]; p4 [2, K, H, N] (f32, or bf16 when p_is_bf16);
// scales f32 [K, 4, N]; ds f32 [K, 2, N] keep-scales or null; q scratch
// bf16 [2, K, Hq, Npad] (Hq = H rounded up to 16, Npad = N rounded up to
// 64); partial scratch f32 [rel_splits * con_splits, N, H], or ``out``
// itself when that product is 1; out f32 [N, H].
int dt_paired_fwd(const void* mask, const void* p4, int p_is_bf16, const void* scales,
                  const void* ds, void* q, void* partial, void* out, int K, int N, int H,
                  int rel_splits, int con_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int Hq = (H + 15) / 16 * 16, chunks = (N + TK - 1) / TK, Npad = chunks * TK;
  const long long rows = 2LL * K * Hq;
  if (K < 1 || N < 1 || H < 1 || rel_splits < 1 || rel_splits > K || con_splits < 1 ||
      con_splits > chunks || static_cast<long long>(rel_splits) * con_splits > 65535 ||
      (H + HS - 1) / HS > 65535 || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const dim3 pass(static_cast<unsigned>(rows), (Npad / 8 + 127) / 128);
  __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(q);
  const float* sc = static_cast<const float*>(scales);
  const float* dsf = static_cast<const float*>(ds);
  if (p_is_bf16)
    fwd_operands_kernel<<<pass, 128, 0, st>>>(static_cast<const __nv_bfloat16*>(p4), sc, dsf,
                                              qb, K, N, H, Hq, Npad);
  else
    fwd_operands_kernel<<<pass, 128, 0, st>>>(static_cast<const float*>(p4), sc, dsf, qb, K,
                                              N, H, Hq, Npad);
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      sweep_launch(MainSweep, mask, qb, sc, part, K, N, H, rel_splits, con_splits, st);
  const int splits = rel_splits * con_splits;
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = static_cast<size_t>(N) * H;
  const int blocks = static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(part, static_cast<float*>(out), splits, count);
  return cudaGetLastError();
}

// What the card gives the sweep kernel: info[0] registers a thread,
// info[1] blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// its shared memory), info[2] shared bytes a block, info[3] local
// (spilled) bytes a thread.
int dt_paired_fwd_info(int* info) {
  cudaError_t err =
      cudaFuncSetAttribute(MainSweep, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, MainSweep);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], MainSweep, THREADS,
                                                      SMEM_BYTES);
  info[0] = attr.numRegs;
  info[2] = SMEM_BYTES;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return err;
}

const char* dt_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"
