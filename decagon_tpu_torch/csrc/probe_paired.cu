// Probes of the paired SpMM for Hopper (sm_90a): P2 and P3, the paired
// forward's sweep (paired_core.cuh, paired_fwd.cuh) taken apart by parts
// policies.
//
// Replaces the TPU probes
//   P3 scripts/probe_paired_parts.py::run (its kernel),
//   P2 scripts/probe_paired_orient.py::make_kernel.
//
// For K relations of an [Km >= K, N, N] mask B (int8, or bf16 for P2's
// both and small_t) and bf16 operands pe_k, po_k [H, N] (the halves of p4
// [2, K, H, N]) they compute, with f32 sums,
//
//   both / two_dots   out[h, n] = sum_k ae[k,n] (pe_k B_k^T)[h,n] + ao[k,n] (po_k B_k)[h,n]
//   direct (xe_only)  out = sum_k ae (pe_k B_k^T)
//   trans (xo_only, one_dot)  out = sum_k ao (po_k B_k)
//   m128 (m128_dot)   out = sum_k (pe_k B_k) + (po_k B_k): one mask orientation, both operands
//   dma (dma_only)    out = 0, after staging every tile "both" stages
//   small_t           what "both" computes, each mask tile staged once
//
// with the row scales ae, ao from sc [Km, 2, N] f32 (P2) or 1 (P3, sc
// null).  H <= 64 (one hidden slice).
//
// Bound on this card: bytes.  Each mask byte is needed once (400 MB at the
// paper's K = 963, N = 645) and the products, 2 H N^2 a relation and
// orientation on the bf16 tensor cores, need about 0.1 ms of the card's
// peak there.
//
// Design.  Every mode but small_t is K1/K2's kernel (paired_fwd_kernel)
// on a parts policy of the sweep, after K1/K2's operand pass at unit
// column scales (bf16(p * 1) = p): "both" is the default policy, so with
// sc's rows for a_e, a_o it is K1/K2 on scales [K, 4, N] = (sc, 1, 1),
// bit for bit at the same cut.  "direct" and "trans" stage, convert and
// multiply one half's tile and operand; "m128" stages the transposed tile
// alone and both halves read it (warps 0-3 against pe, 4-7 against po);
// "dma" stages what "both" stages (the cp.async ring) with no conversion
// and no products, a word of every landed stage folded into a sink that is
// stored only where row scales are given, which P3 never gives.  The
// blocks' partials [splits, N, H] are summed in split order by a last pass
// that writes [H, N].
//
// small_t stages each mask tile once and reads it in both orientations: a
// block owns a node-tile pair (R, C), a relation range and a hidden slice;
// each step stages B_k[R, C] (one 64 x 64 chunk), the direct half
// converts its rows and multiplies them against pe at C, the transposed
// half converts its columns of the same raw tile and multiplies them
// against po at R (ldmatrix.trans, as the sweep's transposed half reads
// its own tile).  Each half writes a partial [64, H] of its nodes (R for
// the direct half, C for the transposed one); a last pass sums, for each
// node tile t, over the relation splits in order, the direct partials of
// (t, C) for C = 0.. and then the transposed partials of (R, t) for R =
// 0.., so two calls give equal bits.
//
// The bf16 mask is staged at two bytes a cell (nine 16-byte chunks a tile
// row, the window extracted at two-byte grain, no conversion).  "both" on
// it takes the ring's depth (3 stages, ~118 KiB: one block an SM; or 2
// stages, ~84 KiB: two), the trade-off its probe measures.

#include "paired_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Mode { DIRECT = 1, TRANS = 2, BOTH = 3, M128 = 4, DMA = 5, SMALL_T = 6 };

// Row scales a_e, a_o from sc [K, 2, N], or 1 where sc is null (P3).
struct RowScales {
  const float* scales;
  int N;
  __device__ __forceinline__ float operator()(int k, int half, int n) const {
    return scales == nullptr ? 1.f : scales[(static_cast<size_t>(k) * 2 + half) * N + n];
  }
};

struct DirectParts : Parts {
  static constexpr bool RAW_T = false, OPND_T = false, PROD_T = false;
};
struct TransParts : Parts {
  static constexpr bool RAW_D = false, OPND_D = false, PROD_D = false;
};
struct M128Parts : Parts {
  static constexpr bool RAW_D = false, D_READS_T = true;
};
struct DmaParts : Parts {
  static constexpr bool CONVERT = false, PROD_D = false, PROD_T = false, SINK = true;
};
struct SmallTParts : Parts {
  static constexpr bool RAW_T = false, SINGLE = true;
};
template <class Base, int R>
struct Bf16 : Base {
  using Mask = bf16;
  static constexpr int RING = R;
};

// small_t's epilogue: K1/K2's, with each half's own nodes (R for the
// direct half, C for the transposed one).
struct PairEpilogue {
  RowScales scale;
  int N;
  int n0_d, n0_t;  // the direct half's first node, the transposed half's
  float total[8][4];

  __device__ __forceinline__ void relation(int k, int half, int rg, int lane,
                                           const float (&acc)[8][4]) {
    const int n = (half == 0 ? n0_d : n0_t) + 16 * rg + (lane >> 2);
    const float lo = n < N ? scale(k, half, n) : 0.f;
    const float hi = n + 8 < N ? scale(k, half, n + 8) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      total[j][0] += lo * acc[j][0];
      total[j][1] += lo * acc[j][1];
      total[j][2] += hi * acc[j][2];
      total[j][3] += hi * acc[j][3];
    }
  }
};

// Grid: x the pair R * T + C of the T node tiles, y the relation split, z
// the hidden slice.  partial [rel_splits][T * T][2][64][H].
template <class P>
__global__ void __launch_bounds__(THREADS, 2)
small_t_kernel(const int8_t* __restrict__ mask, const bf16* __restrict__ q,
               const float* __restrict__ scales, float* __restrict__ partial, int K, int N, int H,
               int Hq, int rel_splits, int) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = (N + TM - 1) / TM;
  const size_t half_q = static_cast<size_t>(K) * Hq * (T * TK);
  Sweep s = block_sweep(reinterpret_cast<const typename P::Mask*>(mask), K, N, Hq, q, q + half_q,
                        rel_splits, 1);
  const int R = blockIdx.x / T, C = blockIdx.x % T;
  s.n0 = R * TM;
  s.ch0 = C;
  s.ch1 = C + 1;
  PairEpilogue epi{{scales, N}, N, R * TM, C * TK};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) epi.total[j][e] = 0.f;
  sweep<Operands::PLANES, P>(s, epi, smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp >> 2, rg = warp & 3;
  float* dst = partial +
      ((static_cast<size_t>(blockIdx.y) * T * T + blockIdx.x) * 2 + half) * TM * H;
  const int r = 16 * rg + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = r + (e >> 1) * 8, h = s.h0 + 8 * j + c + (e & 1);
      if (h < H) dst[static_cast<size_t>(rr) * H + h] = epi.total[j][e];
    }
  }
}

// out[h, n] = sum over splits of partial[s, n, h], in split order.
__global__ void sum_splits_t_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int splits, int N, int H) {
  const size_t count = static_cast<size_t>(N) * H;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < count;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t h = x / N, n = x % N;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partial[s * count + n * H + h];
    out[x] = acc;
  }
}

// small_t's last pass: out[h, n] for n = 64 t + r is, split by split, the
// direct partials of the pairs (t, C), C = 0..T-1, then the transposed
// partials of (R, t), R = 0..T-1, added in that order.
__global__ void sum_pairs_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                 int splits, int N, int H) {
  const int T = (N + TM - 1) / TM;
  const size_t count = static_cast<size_t>(N) * H;
  for (size_t x = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; x < count;
       x += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(x / N), n = static_cast<int>(x % N);
    const int t = n / TM, r = n % TM;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) {
      const size_t pairs = static_cast<size_t>(s) * T * T;
      for (int C = 0; C < T; ++C)
        acc += partial[(((pairs + t * T + C) * 2 + 0) * TM + r) * H + h];
      for (int R = 0; R < T; ++R)
        acc += partial[(((pairs + R * T + t) * 2 + 1) * TM + r) * H + h];
    }
    out[x] = acc;
  }
}

using Kernel = void (*)(const int8_t*, const bf16*, const float*, float*, int, int, int, int,
                        int, int);

struct Choice {
  Kernel kernel;
  int smem;
};

template <class P>
Choice fwd() {
  return {paired_fwd_kernel<P, RowScales>, Layout<P>::SMEM_BYTES};
}

// The instantiation of (mode, mask type, ring depth), or {nullptr, 0}.
Choice choose(int mode, int mask_bf16, int stages) {
  if (mask_bf16) {
    if (mode == BOTH && stages == 3) return fwd<Bf16<Parts, 3>>();
    if (mode == BOTH && stages == 2) return fwd<Bf16<Parts, 2>>();
    if (mode == SMALL_T && stages == 3)
      return {small_t_kernel<Bf16<SmallTParts, 3>>, Layout<Bf16<SmallTParts, 3>>::SMEM_BYTES};
    return {nullptr, 0};
  }
  if (stages != 3) return {nullptr, 0};
  switch (mode) {
    case DIRECT: return fwd<DirectParts>();
    case TRANS: return fwd<TransParts>();
    case BOTH: return fwd<Parts>();
    case M128: return fwd<M128Parts>();
    case DMA: return fwd<DmaParts>();
    case SMALL_T: return {small_t_kernel<SmallTParts>, Layout<SmallTParts>::SMEM_BYTES};
    default: return {nullptr, 0};
  }
}

int grid_blocks(size_t count) {
  return static_cast<int>((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
}

}  // namespace

extern "C" {

// mask [Km >= K, N, N], int8 or bf16 (mask_bf16); p4 bf16 [2, K, H, N]
// (1 <= H <= 64); sc f32 [Km, 2, N] row scales or null (unit); mode: 1
// direct, 2 trans, 3 both, 4 m128, 5 dma, 6 small_t; stages: the ring's
// depth (3; a bf16 mask's "both" also 2).  The cut: rel_splits relation
// ranges and con_splits contraction ranges (small_t: 1; its grid is the
// T * T node-tile pairs).  q scratch bf16 [2, K, Hq, Npad] (Hq = H rounded
// up to 16, Npad = N rounded up to 64); partial scratch f32
// [rel_splits * con_splits, N, H] (small_t: [rel_splits, T * T, 2, 64,
// H]); out f32 [H, N].  int8 takes every mode; bf16 both and small_t.
int dt_probe_parts(const void* mask, int mask_bf16, const void* p4, const void* sc, int mode,
                    int stages, void* q, void* partial, void* out, int K, int N, int H,
                    int rel_splits, int con_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (N + TK - 1) / TK, T = chunks;
  const Choice c = choose(mode, mask_bf16, stages);
  if (c.kernel == nullptr || K < 1 || N < 1 || H < 1 || H > HS || rel_splits < 1 ||
      rel_splits > K || con_splits < 1 || con_splits > chunks ||
      static_cast<long long>(rel_splits) * con_splits > 65535 ||
      (mode == SMALL_T && (con_splits != 1 || static_cast<long long>(T) * T > 0x7fffffffLL)))
    return cudaErrorInvalidValue;
  const int Hq = (H + 15) / 16 * 16, Npad = chunks * TK;
  bf16* qb = static_cast<bf16*>(q);
  operand_pass<true>(p4, 1, nullptr, nullptr, qb, K, N, H, Hq, Npad, st);
  cudaError_t err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(mode == SMALL_T ? T * T : T, rel_splits * con_splits, 1);
  float* part = static_cast<float*>(partial);
  c.kernel<<<grid, THREADS, c.smem, st>>>(static_cast<const int8_t*>(mask), qb,
                                          static_cast<const float*>(sc), part, K, N, H, Hq,
                                          rel_splits, con_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = grid_blocks(static_cast<size_t>(N) * H);
  if (mode == SMALL_T)
    sum_pairs_kernel<<<blocks, 256, 0, st>>>(part, static_cast<float*>(out), rel_splits, N, H);
  else
    sum_splits_t_kernel<<<blocks, 256, 0, st>>>(part, static_cast<float*>(out),
                                                rel_splits * con_splits, N, H);
  return cudaGetLastError();
}

// The instantiation's registers a thread, blocks an SM (at its shared
// memory), shared bytes a block and local (spilled) bytes a thread, as
// dt_paired_fwd_info reports K1/K2's.
int dt_probe_parts_info(int mode, int mask_bf16, int stages, int* info) {
  const Choice c = choose(mode, mask_bf16, stages);
  if (c.kernel == nullptr) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, c.kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[1], c.kernel, THREADS, c.smem);
  info[0] = attr.numRegs;
  info[2] = c.smem;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // extern "C"
