// Probe of the paired forward's sweep for Hopper (sm_90a): the sweep
// kernel of paired_fwd.cu (paired_fwd.cuh over paired_core.cuh) in parts,
// for measuring where its time goes (``scripts/probe_paired_sweep.py``).
//
// Each variant is the forward's kernel on a parts policy of the core's
// sweep: ``CopyConvert`` stages and converts the mask and stages the
// operands, and runs no products (the accumulators stay zero);
// ``ProductsOnly`` runs the products on zeroed shared memory and makes no
// copy and no conversion.

#include "paired_fwd.cuh"

namespace {

struct CopyConvert : Parts {
  static constexpr bool PROD_D = false, PROD_T = false;
};

struct ProductsOnly : Parts {
  static constexpr bool RAW_D = false, RAW_T = false, OPND_D = false, OPND_T = false;
  static constexpr bool CONVERT = false;
};

}  // namespace

extern "C" {

// The sweep kernel alone, in a variant: 0 the main path's sweep; 1 its
// copies and conversion without the products; 2 its products on zeroed
// shared memory without copies.  ``q`` holds the operand planes, written
// by the caller (as dt_paired_fwd's operand pass writes them); ``partial``
// f32 [rel_splits * con_splits, N, H], not summed here.
int dt_probe_paired_sweep(const void* mask, const void* scales, const void* q, void* partial,
                          int K, int N, int H, int rel_splits, int con_splits, int variant,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (N + TK - 1) / TK;
  if (K < 1 || N < 1 || H < 1 || rel_splits < 1 || rel_splits > K || con_splits < 1 ||
      con_splits > chunks || static_cast<long long>(rel_splits) * con_splits > 65535)
    return cudaErrorInvalidValue;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const float* sc = static_cast<const float*>(scales);
  float* part = static_cast<float*>(partial);
  switch (variant) {
    case 0:
      return sweep_launch(paired_fwd_kernel<>, mask, qb, sc, part, K, N, H, rel_splits,
                          con_splits, st);
    case 1:
      return sweep_launch<CopyConvert>(paired_fwd_kernel<CopyConvert>, mask, qb, sc, part, K,
                                       N, H, rel_splits, con_splits, st);
    case 2:
      return sweep_launch<ProductsOnly>(paired_fwd_kernel<ProductsOnly>, mask, qb, sc, part,
                                        K, N, H, rel_splits, con_splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
