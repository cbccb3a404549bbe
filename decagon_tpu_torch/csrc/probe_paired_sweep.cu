// Probe of the paired forward's sweep for Hopper (sm_90a): the sweep
// kernel of paired_fwd.cu (paired_fwd.cuh over paired_core.cuh) in parts,
// for measuring where its time goes (``scripts/probe_paired_sweep.py``).
//
// ``PartSweep<STAGING, PRODUCTS>`` repeats the core's ``paired::sweep``
// loop with either part switched off: without PRODUCTS the copies and the
// mask's conversion run and the accumulators stay zero; without STAGING
// the products run on zeroed shared memory and no copy is made.  The loop
// is a copy of the core's, so a change there must be made here too.

#include "paired_fwd.cuh"

namespace {

template <bool STAGING, bool PRODUCTS>
struct PartSweep {
  template <class Epi>
  __device__ __forceinline__ static void run(const Sweep& s, Epi& epi, unsigned char* smem) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int half = warp >> 2, rg = warp & 3;
    const int nc = s.ch1 - s.ch0;
    const int steps = (s.k1 - s.k0) * nc;
    unsigned char* tile = smem + STAGES * STAGE_BYTES + half * TILE_BYTES;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    if (!STAGING) {
      for (int i = tid; i < SMEM_BYTES / 16; i += THREADS)
        reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int it = 0; it < STAGES - 1; ++it) {
      if (STAGING && it < steps) stage(s, it, smem + it * STAGE_BYTES, tid);
      cp_async_commit();
    }
    int k = s.k0, ci = 0;
    for (int it = 0; it < steps; ++it) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int nx = it + STAGES - 1;
      if (STAGING && nx < steps) stage(s, nx, smem + (nx % STAGES) * STAGE_BYTES, tid);
      cp_async_commit();
      const unsigned char* st = smem + (it % STAGES) * STAGE_BYTES;
      const int8_t* bk = s.mask + static_cast<size_t>(k) * s.N * s.N;
      if (STAGING) convert(s, bk, (s.ch0 + ci) * TK, st, tile, half, rg, lane);
      __syncwarp();
      if (PRODUCTS)
        products(tile, st + 2 * RAW_BYTES + half * TILE_BYTES, acc, half, rg, lane, s.nh);
      if (++ci == nc) {
        epi.relation(k, half, rg, lane, acc);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        ci = 0;
        ++k;
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
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
      return sweep_launch(paired_fwd_kernel<WholeSweep>, mask, qb, sc, part, K, N, H,
                          rel_splits, con_splits, st);
    case 1:
      return sweep_launch(paired_fwd_kernel<PartSweep<true, false>>, mask, qb, sc, part, K, N,
                          H, rel_splits, con_splits, st);
    case 2:
      return sweep_launch(paired_fwd_kernel<PartSweep<false, true>>, mask, qb, sc, part, K, N,
                          H, rel_splits, con_splits, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
