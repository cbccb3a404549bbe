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
//
// The probe P1 (``dt_paired_fwd_aug``; it replaces the TPU probe
// scripts/probe_paired_idioms.py::kernel) is the same function with
// b_e = b_o = 1 in the TPU probe's node-major "aug" layout: pe, po bf16
// [K, N, 128], columns :H the operands [N, H], column H the row scales
// a_e, a_o (bf16), and
//
//   out[n, h] = sum_k a_e[k,n] (B_k pe_k)[n, h] + a_o[k,n] (B_k^T po_k)[n, h]
//
// for h < H, out[n, H:] = 0, out [N, 128] f32.  It runs the same sweep
// with no operand pass: the sweep copies the operands' 16-byte aligned
// rows as they lie (paired_core.cuh's NODE_MAJOR layout) and reads their
// B fragments with ldmatrix.trans; the epilogue reads a_e / a_o from
// column H, and the last pass writes out with a row stride of 128 and the
// columns H: zero.  Its bound is the forward's: the mask's bytes.

#include "paired_fwd.cuh"

namespace {

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

int grid_blocks(size_t count) {
  return static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
}

constexpr auto MainSweep = paired_fwd_kernel<>;

// P1's row scales: bf16 column H of the node-major rows pe / po [K][N][AUG].
constexpr int AUG = 128;
struct ScaleColumn {
  const __nv_bfloat16* pe;
  const __nv_bfloat16* po;
  int N, H;
  __device__ __forceinline__ float operator()(int k, int half, int n) const {
    const __nv_bfloat16* p = half == 0 ? pe : po;
    return __bfloat162float(p[(static_cast<size_t>(k) * N + n) * AUG + H]);
  }
};

__global__ void __launch_bounds__(THREADS, 2)
paired_aug_kernel(const int8_t* __restrict__ mask, const __nv_bfloat16* __restrict__ pe,
                  const __nv_bfloat16* __restrict__ po, float* __restrict__ partial, int K,
                  int N, int H, int rel_splits, int con_splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  Sweep s = block_sweep(mask, K, N, (H + 15) / 16 * 16, pe, po, rel_splits, con_splits);
  s.ld = AUG;
  FwdEpilogue<ScaleColumn> epi{{pe, po, N, H}, N, s.n0};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi.total[j][e] = 0.f;
  sweep<Operands::NODE_MAJOR>(s, epi, smem);
  store_partial(epi, s, partial + static_cast<size_t>(blockIdx.y) * N * H, N, H, smem);
}

// P1's last pass: out[n, h] = sum over splits of partial[s, n, h] (partial
// [splits, N, H]) in split order for h < H, 0 for H <= h < AUG.
__global__ void sum_splits_aug_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int splits, int N, int H) {
  const size_t count = static_cast<size_t>(N) * H;
  for (int x = blockIdx.x * blockDim.x + threadIdx.x; x < N * AUG;
       x += gridDim.x * blockDim.x) {
    const int n = x / AUG, h = x % AUG;
    float acc = 0.f;
    if (h < H)
      for (int s = 0; s < splits; ++s) acc += partial[s * count + n * H + h];
    out[x] = acc;
  }
}

bool valid_cut(int K, int N, int rel_splits, int con_splits) {
  const int chunks = (N + TK - 1) / TK;
  return K >= 1 && N >= 1 && rel_splits >= 1 && rel_splits <= K && con_splits >= 1 &&
         con_splits <= chunks && static_cast<long long>(rel_splits) * con_splits <= 65535;
}

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
  const int Hq = (H + 15) / 16 * 16, Npad = (N + TK - 1) / TK * TK;
  const long long rows = 2LL * K * Hq;
  if (!valid_cut(K, N, rel_splits, con_splits) || H < 1 || (H + HS - 1) / HS > 65535 ||
      rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  __nv_bfloat16* qb = static_cast<__nv_bfloat16*>(q);
  const float* sc = static_cast<const float*>(scales);
  operand_pass(p4, p_is_bf16, sc, static_cast<const float*>(ds), qb, K, N, H, Hq, Npad, st);
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      sweep_launch(MainSweep, mask, qb, sc, part, K, N, H, rel_splits, con_splits, st);
  const int splits = rel_splits * con_splits;
  if (err != cudaSuccess || splits == 1) return err;
  const size_t count = static_cast<size_t>(N) * H;
  sum_splits_kernel<<<grid_blocks(count), 256, 0, st>>>(part, static_cast<float*>(out), splits,
                                                        count);
  return cudaGetLastError();
}

// P1.  mask int8 [K, N, N]; pe, po bf16 [K, N, 128], 16-byte aligned,
// columns :H the operands and column H the row scales (1 <= H <= 64);
// partial f32 scratch [rel_splits * con_splits, N, H]; out f32 [N, 128].
int dt_paired_fwd_aug(const void* mask, const void* pe, const void* po, void* partial,
                      void* out, int K, int N, int H, int rel_splits, int con_splits,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_cut(K, N, rel_splits, con_splits) || H < 1 || H > HS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      paired_aug_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + TM - 1) / TM, rel_splits * con_splits, 1);
  float* part = static_cast<float*>(partial);
  paired_aug_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const int8_t*>(mask), static_cast<const __nv_bfloat16*>(pe),
      static_cast<const __nv_bfloat16*>(po), part, K, N, H, rel_splits, con_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_splits_aug_kernel<<<grid_blocks(static_cast<size_t>(N) * AUG), 256, 0, st>>>(
      part, static_cast<float*>(out), rel_splits * con_splits, N, H);
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
