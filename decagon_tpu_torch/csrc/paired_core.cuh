// Staging and product core of the paired kernels for Hopper (sm_90a):
// the forward (paired_fwd.cu, K1/K2 and K1/K2-ds) and the backward
// (paired_bwd.cu, K3/K4) run the same sweep with their own epilogues.
//
// What a block does.  A block owns TM = 64 nodes (output rows), one slice
// of up to HS = 64 hidden columns, a range of relations [k0, k1) and a
// range of contraction chunks [ch0, ch1) of TK = 64.  For each relation
// it sums two products over its chunks,
//
//   acc_D[n, h] = sum_c B_k[n, c] * qd_k[h, c]    (the direct tile: rows of B)
//   acc_T[n, h] = sum_c B_k[c, n] * qt_k[h, c]    (the transposed tile: columns)
//
// and hands both to the epilogue at the relation's last chunk.  qd and qt
// are bf16 operand planes [K][Hq][Npad] that a short pass writes first
// (the scaled, rounded operands; zero past N and past H), so the sweep
// reads them as they lie: rows of h with the contraction contiguous, the
// ".col" B operand of mma.sync.
//
// Staging.  The sweep walks the flattened (relation, chunk) sequence
// through a ring of STAGES shared-memory stages filled by 16-byte
// cp.async, with one barrier a chunk, so two chunks are in flight during
// each chunk's products.  Mask rows have N bytes and N need not be a
// multiple of 16, so each 64-byte tile row is fetched as the five aligned
// 16-byte chunks that cover it (RAW_LD bytes; the row's first byte sits at
// its address's offset within 16).  Rows past N are zero-filled; a chunk
// that crosses the end of the mask is cut by cp.async's source size (the
// rest zero-filled); one that starts before the mask (a base that is not
// 16-byte aligned) is copied byte by byte.  Bytes past column N are
// garbage but finite, and meet zero operand columns or output rows that
// are never stored.  Operand tiles [nh * 16 h][64 c] are copied straight
// into an XOR-swizzled layout (16-byte chunk q of row h at q ^ (h & 7)),
// so ldmatrix reads eight rows without bank conflicts.
//
// Products.  Eight warps: warps 0-3 take the direct tile, 4-7 the
// transposed one, each for 16 of the 64 nodes.  Each warp converts the
// int8 bytes it alone consumes to bf16 (exactly, by a float magic number)
// into its own part of a swizzled tile, so a __syncwarp, not a barrier,
// separates conversion from products.  The direct half reads that tile
// with ldmatrix, the transposed half with ldmatrix.trans (the tile is
// stored as the mask lies, [c][n]); B fragments come from the operand
// tile with ldmatrix.  mma.sync.m16n8k16 bf16 -> f32 accumulates 16 nodes
// x 64 columns a warp in registers, in a documented layout (c0, c1: row
// lane / 4, columns 2 (lane % 4) + {0, 1}; c2, c3: eight rows down), so
// the epilogue applies per-node scales in registers.
//
// Sums are f32 in a fixed order (chunk by chunk, relation by relation),
// and a block owns its outputs, so two calls give equal bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paired {

constexpr int TM = 64;          // nodes (output rows) per block
constexpr int TK = 64;          // contraction chunk
constexpr int HS = 64;          // hidden columns per block (one slice)
constexpr int WARPS = 8;        // 4 node groups of 16 x 2 halves
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;       // cp.async ring depth
constexpr int RAW_LD = 80;      // bytes per raw mask row: five 16-byte chunks
constexpr int RAW_BYTES = TM * RAW_LD;
constexpr int TILE_BYTES = 64 * 64 * 2;  // a bf16 64 x 64 tile, 128-byte rows
constexpr int STAGE_BYTES = 2 * RAW_BYTES + 2 * TILE_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * TILE_BYTES;

// One block's work, decoded from the grid: blockIdx.x the node tile,
// blockIdx.y = relation split * con_splits + contraction split (also the
// index of the block's partial), blockIdx.z the hidden slice.  The ranges
// are those of ``ops/spmm_paired.PairedSchedule.ranges``.
struct Sweep {
  const int8_t* mask;               // [K, N, N]
  const unsigned char* begin;       // the mask's first byte
  const unsigned char* end;         // one past its last
  const __nv_bfloat16* qd;          // direct tile's operand planes [K][Hq][Npad]
  const __nv_bfloat16* qt;          // transposed tile's
  int N, Hq, Npad;
  int n0, h0, nh;                   // first node, first column, 16-column groups
  int k0, k1, ch0, ch1;             // relations and chunks of this block
};

__device__ __forceinline__ Sweep block_sweep(const int8_t* mask, int K, int N, int Hq,
                                             const __nv_bfloat16* qd,
                                             const __nv_bfloat16* qt, int rel_splits,
                                             int con_splits) {
  Sweep s;
  const int chunks = (N + TK - 1) / TK;
  const int rs = blockIdx.y / con_splits, cs = blockIdx.y % con_splits;
  s.mask = mask;
  s.begin = reinterpret_cast<const unsigned char*>(mask);
  s.end = s.begin + static_cast<size_t>(K) * N * N;
  s.qd = qd;
  s.qt = qt;
  s.N = N;
  s.Hq = Hq;
  s.Npad = chunks * TK;
  s.n0 = blockIdx.x * TM;
  s.h0 = blockIdx.z * HS;
  s.nh = (Hq - s.h0) / 16 < 4 ? (Hq - s.h0) / 16 : 4;
  s.k0 = static_cast<int>(static_cast<long long>(K) * rs / rel_splits);
  s.k1 = static_cast<int>(static_cast<long long>(K) * (rs + 1) / rel_splits);
  s.ch0 = static_cast<int>(static_cast<long long>(chunks) * cs / con_splits);
  s.ch1 = static_cast<int>(static_cast<long long>(chunks) * (cs + 1) / con_splits);
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async of ``bytes`` (0..16) source bytes, the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of a 16-byte chunk ``q`` of row ``r`` in a swizzled tile.
__device__ __forceinline__ int swz(int r, int q) { return r * 128 + ((q ^ (r & 7)) << 4); }

// Copy the aligned 16-byte chunk ``q`` covering mask row ``row`` from
// column ``col`` (64 bytes) into ``dst``; zeros for rows past N.
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const Sweep& s,
                                            const int8_t* bk, int row, int col, int q) {
  if (row >= s.N) {
    cp_async16(dst, s.begin, 0);
    return;
  }
  const uintptr_t start =
      reinterpret_cast<uintptr_t>(bk + static_cast<size_t>(row) * s.N + col);
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>((start & ~uintptr_t(15)) + 16 * q);
  if (src >= s.begin) {
    const long long left = s.end - src;
    cp_async16(dst, left > 0 ? src : s.begin, left >= 16 ? 16 : (left > 0 ? int(left) : 0));
  } else {
    for (int b = 0; b < 16; ++b) dst[b] = src + b >= s.begin && src + b < s.end ? src[b] : 0;
  }
}

// Start the copies of flattened step ``it`` (relation k0 + it / nc, chunk
// ch0 + it % nc) into stage ``st``: [raw direct][raw transposed][qd][qt],
// the operand tiles straight from the operand pass's planes.
__device__ __forceinline__ void stage(const Sweep& s, int it, unsigned char* st, int tid) {
  const int nc = s.ch1 - s.ch0;
  const int k = s.k0 + it / nc;
  const int c0 = (s.ch0 + it % nc) * TK;
  const int8_t* bk = s.mask + static_cast<size_t>(k) * s.N * s.N;
  for (int idx = tid; idx < TM * 5; idx += THREADS) {
    const int r = idx / 5, q = idx % 5;
    stage_chunk(st + r * RAW_LD + 16 * q, s, bk, s.n0 + r, c0, q);
    stage_chunk(st + RAW_BYTES + r * RAW_LD + 16 * q, s, bk, c0 + r, s.n0, q);
  }
  unsigned char* td = st + 2 * RAW_BYTES;
  unsigned char* tt = td + TILE_BYTES;
  const int per = s.nh * 16 * 8;  // 16-byte chunks of one operand tile
  const size_t plane = (static_cast<size_t>(k) * s.Hq + s.h0) * s.Npad + c0;
  for (int idx = tid; idx < per; idx += THREADS) {
    const int h = idx >> 3, q = idx & 7;
    const size_t off = plane + static_cast<size_t>(h) * s.Npad + 8 * q;
    cp_async16(td + swz(h, q), s.qd + off);
    cp_async16(tt + swz(h, q), s.qt + off);
  }
}

// The 16 bytes at byte ``pos`` (any alignment, pos <= 63) of a raw row,
// from two aligned 16-byte loads.
__device__ __forceinline__ uint4 window16(const unsigned char* row, int pos) {
  const uint4* p = reinterpret_cast<const uint4*>(row) + (pos >> 4);
  const uint4 a = p[0], b = p[1];
  uint32_t x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int w = (pos >> 2) & 3;
  const unsigned sh = (pos & 3) * 8;
  uint32_t y[6], z[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) y[j] = (w & 2) ? x[j + 2] : x[j];
#pragma unroll
  for (int j = 0; j < 5; ++j) z[j] = (w & 1) ? y[j + 1] : y[j];
  return make_uint4(__funnelshift_r(z[0], z[1], sh), __funnelshift_r(z[1], z[2], sh),
                    __funnelshift_r(z[2], z[3], sh), __funnelshift_r(z[3], z[4], sh));
}

// Four signed bytes to four bf16 (two bf16x2 words), exactly: the byte
// plus 128 is the low mantissa of 2^23 + v + 128, the subtraction leaves
// v as a small f32 integer, whose upper 16 bits are its bf16.
__device__ __forceinline__ uint2 s8x4_to_bf16(uint32_t x) {
  const uint32_t u = x ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B00u, 0x5443)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

// Convert 16 raw bytes at ``pos`` of ``row`` into two 16-byte chunks of
// bf16 at logical chunks q0, q0 + 1 of tile row ``r``.
__device__ __forceinline__ void convert16(unsigned char* tile, int r, int q0,
                                          const unsigned char* row, int pos) {
  const uint4 v = window16(row, pos);
  const uint2 a = s8x4_to_bf16(v.x), b = s8x4_to_bf16(v.y);
  const uint2 c = s8x4_to_bf16(v.z), d = s8x4_to_bf16(v.w);
  *reinterpret_cast<uint4*>(tile + swz(r, q0)) = make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(tile + swz(r, q0 + 1)) = make_uint4(c.x, c.y, d.x, d.y);
}

// The warp's own part of this chunk's bf16 mask tile: the direct half
// converts its 16 rows (each lane half a row), the transposed half its 16
// columns of all 64 rows (each lane two rows).
__device__ __forceinline__ void convert(const Sweep& s, const int8_t* bk, int c0,
                                        const unsigned char* raw, unsigned char* tile,
                                        int half, int rg, int lane) {
  if (half == 0) {
    const int r = 16 * rg + (lane >> 1), hc = lane & 1;
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(bk + static_cast<size_t>(s.n0 + r) * s.N + c0) & 15);
    const unsigned char* row = raw + r * RAW_LD;
    convert16(tile, r, 4 * hc, row, off + 32 * hc);
    convert16(tile, r, 4 * hc + 2, row, off + 32 * hc + 16);
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = lane + 32 * e;
      const int off = static_cast<int>(
          reinterpret_cast<uintptr_t>(bk + static_cast<size_t>(c0 + r) * s.N + s.n0) & 15);
      convert16(tile, r, 2 * rg, raw + RAW_BYTES + r * RAW_LD, off + 16 * rg);
    }
  }
}

// acc[j] (columns 8j..8j+7 of the slice) += this chunk's product for the
// warp's 16 nodes.
__device__ __forceinline__ void products(const unsigned char* tile, const unsigned char* opnd,
                                         float (&acc)[8][4], int half, int rg, int lane,
                                         int nh) {
  const unsigned t = smem_u32(tile), o = smem_u32(opnd);
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t a[4];
    if (half == 0) {
      const int r = 16 * rg + (lane & 15);
      ldmatrix_x4(a, t + swz(r, 2 * kk + (lane >> 4)));
    } else {
      const int r = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
      ldmatrix_x4_trans(a, t + swz(r, 2 * rg + ((lane >> 3) & 1)));
    }
#pragma unroll
    for (int hp = 0; hp < HS / 16; ++hp) {
      if (hp < nh) {
        uint32_t b[4];
        const int r = 16 * hp + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(b, o + swz(r, 2 * kk + ((lane >> 3) & 1)));
        mma_bf16(acc[2 * hp], a, b[0], b[1]);
        mma_bf16(acc[2 * hp + 1], a, b[2], b[3]);
      }
    }
  }
}

// The sweep.  ``epi.relation(k, half, rg, lane, acc)`` runs at each
// relation's last chunk with the warp's accumulators (half 0: acc_D,
// half 1: acc_T), which are zeroed after.  On return every copy has
// landed and every thread has passed a barrier, so the caller may reuse
// the shared memory.
template <class Epi>
__device__ __forceinline__ void sweep(const Sweep& s, Epi& epi, unsigned char* smem) {
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

#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < steps) stage(s, it, smem + it * STAGE_BYTES, tid);
    cp_async_commit();
  }
  int k = s.k0, ci = 0;  // relation and chunk (within the block's range) of step it
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of step it have landed
    __syncthreads();              // everyone's; and step it - 1 is consumed
    const int nx = it + STAGES - 1;
    if (nx < steps) stage(s, nx, smem + (nx % STAGES) * STAGE_BYTES, tid);
    cp_async_commit();
    const unsigned char* st = smem + (it % STAGES) * STAGE_BYTES;
    const int8_t* bk = s.mask + static_cast<size_t>(k) * s.N * s.N;
    convert(s, bk, (s.ch0 + ci) * TK, st, tile, half, rg, lane);
    __syncwarp();
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

}  // namespace paired
