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
// Operand layouts.  PLANES (K1-K4): the operand pass's planes above.
// NODE_MAJOR (the probe P1, paired_fwd.cu's dt_paired_fwd_aug): bf16 rows
// [K][N][ld], one a contraction index with the hidden columns contiguous,
// read as they lie: each tile row is eight 16-byte chunks of one row
// (16-byte aligned when the base is and ld is a multiple of eight), rows
// past N zero-filled, into a swizzled tile [64 c][64 h] whose B fragments
// come with ldmatrix.trans.
//
// Parts.  A compile-time policy (``Parts`` and its variants) says what a
// step does: which raw mask tiles and operand tiles it stages, whether the
// mask is converted, which halves run products, whether the direct half
// reads the transposed tile (one orientation against both operands), and
// whether one tile feeds both halves (``SINGLE``: the transposed half reads
// the direct raw tile's columns, its operand tile lies at the node tile
// n0 and its outputs are the chunk's nodes), with the mask's element type
// (int8, or bf16 staged at two bytes a cell: nine 16-byte chunks a tile
// row, no conversion but the window's extraction) and the ring's depth.
// The default is K1-K4's; the probes (probe_paired.cu, probe_paired_sweep.cu)
// take the sweep apart with the others.
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

enum class Operands { PLANES, NODE_MAJOR };

// What a sweep step does (the header comment's "Parts"): K1-K4's.
struct Parts {
  using Mask = int8_t;                // mask element: int8_t or __nv_bfloat16
  static constexpr int RING = STAGES; // stages of the cp.async ring
  static constexpr bool RAW_D = true; // stage the direct tile B[n0 + r, c0 + c]
  static constexpr bool RAW_T = true; // stage the transposed tile B[c0 + r, n0 + c]
  static constexpr bool OPND_D = true, OPND_T = true;  // stage qd / qt
  static constexpr bool CONVERT = true;                // convert the mask tiles
  static constexpr bool PROD_D = true, PROD_T = true;  // products of each half
  static constexpr bool D_READS_T = false;  // the direct half reads the transposed tile
  static constexpr bool SINGLE = false;     // one direct tile feeds both halves
  static constexpr bool SINK = false;       // fold staged words into sweep's result
};

// The shared-memory layout of a policy: a stage holds the raw tiles it
// stages, then the operand tiles [qd][qt]; the two conversion tiles follow
// the ring.  Parts' values are the constants above.
template <class P>
struct Layout {
  static constexpr int ESZ = sizeof(typename P::Mask);
  static constexpr int CHUNKS = (64 * ESZ) / 16 + 1;  // 16-byte chunks a raw row
  static constexpr int RAW_LD = 16 * CHUNKS;
  static constexpr int RAW_BYTES = TM * RAW_LD;
  static constexpr int RAW_T_AT = P::RAW_D ? RAW_BYTES : 0;
  static constexpr int OPND_AT = (int(P::RAW_D) + int(P::RAW_T)) * RAW_BYTES;
  static constexpr int STAGE_BYTES = OPND_AT + 2 * TILE_BYTES;
  static constexpr int SMEM_BYTES = P::RING * STAGE_BYTES + 2 * TILE_BYTES;
};
static_assert(Layout<Parts>::RAW_LD == RAW_LD && Layout<Parts>::STAGE_BYTES == STAGE_BYTES &&
                  Layout<Parts>::SMEM_BYTES == SMEM_BYTES,
              "K1-K4's layout");

// One block's work, decoded from the grid: blockIdx.x the node tile,
// blockIdx.y = relation split * con_splits + contraction split (also the
// index of the block's partial), blockIdx.z the hidden slice.  The ranges
// are those of ``ops/spmm_paired.PairedSchedule.ranges``.
struct Sweep {
  const int8_t* mask;               // [K, N, N] (a bf16 mask's bytes, read as Parts::Mask)
  const unsigned char* begin;       // the mask's first byte
  const unsigned char* end;         // one past its last
  const __nv_bfloat16* qd;          // direct tile's operands: planes [K][Hq][Npad]
                                    // (NODE_MAJOR: rows [K][N][ld])
  const __nv_bfloat16* qt;          // transposed tile's
  int N, Hq, Npad;
  int ld;                           // NODE_MAJOR: elements a row (set by the caller)
  int n0, h0, nh;                   // first node, first column, 16-column groups
  int k0, k1, ch0, ch1;             // relations and chunks of this block
};

template <class M = int8_t>
__device__ __forceinline__ Sweep block_sweep(const M* mask, int K, int N, int Hq,
                                             const __nv_bfloat16* qd,
                                             const __nv_bfloat16* qt, int rel_splits,
                                             int con_splits) {
  Sweep s;
  const int chunks = (N + TK - 1) / TK;
  const int rs = blockIdx.y / con_splits, cs = blockIdx.y % con_splits;
  s.mask = reinterpret_cast<const int8_t*>(mask);
  s.begin = reinterpret_cast<const unsigned char*>(mask);
  s.end = s.begin + static_cast<size_t>(K) * N * N * sizeof(M);
  s.qd = qd;
  s.qt = qt;
  s.N = N;
  s.Hq = Hq;
  s.Npad = chunks * TK;
  s.ld = 0;
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
// column ``col`` (64 elements) into ``dst``; zeros for rows past N.
template <class M>
__device__ __forceinline__ void stage_chunk(unsigned char* dst, const Sweep& s, const M* bk,
                                            int row, int col, int q) {
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
// ch0 + it % nc) into stage ``st``: the raw tiles ``P`` stages, then
// [qd][qt], the operand tiles straight from the planes ([h][c]) or the
// node-major rows ([c][h]).  With ``P::SINGLE`` qt's tile lies at the node
// tile n0, not the chunk.
template <Operands OP = Operands::PLANES, class P = Parts>
__device__ __forceinline__ void stage(const Sweep& s, int it, unsigned char* st, int tid) {
  using L = Layout<P>;
  using M = typename P::Mask;
  const int nc = s.ch1 - s.ch0;
  const int k = s.k0 + it / nc;
  const int c0 = (s.ch0 + it % nc) * TK;
  const M* bk = reinterpret_cast<const M*>(s.mask) + static_cast<size_t>(k) * s.N * s.N;
  if constexpr (P::RAW_D || P::RAW_T) {
    for (int idx = tid; idx < TM * L::CHUNKS; idx += THREADS) {
      const int r = idx / L::CHUNKS, q = idx % L::CHUNKS;
      if constexpr (P::RAW_D) stage_chunk(st + r * L::RAW_LD + 16 * q, s, bk, s.n0 + r, c0, q);
      if constexpr (P::RAW_T)
        stage_chunk(st + L::RAW_T_AT + r * L::RAW_LD + 16 * q, s, bk, c0 + r, s.n0, q);
    }
  }
  unsigned char* td = st + L::OPND_AT;
  unsigned char* tt = td + TILE_BYTES;
  if constexpr (OP == Operands::PLANES) {
    if constexpr (P::OPND_D || P::OPND_T) {
      const int per = s.nh * 16 * 8;  // 16-byte chunks of one operand tile
      const size_t plane = (static_cast<size_t>(k) * s.Hq + s.h0) * s.Npad + c0;
      const size_t plane_t = P::SINGLE ? plane - c0 + s.n0 : plane;
      for (int idx = tid; idx < per; idx += THREADS) {
        const int h = idx >> 3, q = idx & 7;
        const size_t off = static_cast<size_t>(h) * s.Npad + 8 * q;
        if constexpr (P::OPND_D) cp_async16(td + swz(h, q), s.qd + plane + off);
        if constexpr (P::OPND_T) cp_async16(tt + swz(h, q), s.qt + plane_t + off);
      }
    }
  } else {
    for (int idx = tid; idx < TK * 8; idx += THREADS) {
      const int c = idx >> 3, q = idx & 7;
      if (q >= 2 * s.nh) continue;
      if (c0 + c < s.N) {
        const size_t off = (static_cast<size_t>(k) * s.N + c0 + c) * s.ld + s.h0 + 8 * q;
        cp_async16(td + swz(c, q), s.qd + off);
        cp_async16(tt + swz(c, q), s.qt + off);
      } else {
        cp_async16(td + swz(c, q), s.qd, 0);
        cp_async16(tt + swz(c, q), s.qt, 0);
      }
    }
  }
}

// The 16 bytes at byte ``pos`` (any alignment, pos + 16 <= the row's
// staged bytes) of a raw row, from two aligned 16-byte loads.
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

// ``n`` elements (16 or 32) of a raw row from element ``e`` into tile row
// ``r`` at logical chunk q0 on: int8 converted, bf16 extracted as it lies.
// ``off`` is the row's first byte's offset within 16.
template <class M, int n>
__device__ __forceinline__ void convert_run(unsigned char* tile, int r, int q0,
                                            const unsigned char* row, int off, int e) {
  if constexpr (sizeof(M) == 1) {
#pragma unroll
    for (int j = 0; j < n / 16; ++j) convert16(tile, r, q0 + 2 * j, row, off + e + 16 * j);
  } else {
#pragma unroll
    for (int j = 0; j < n / 8; ++j)
      *reinterpret_cast<uint4*>(tile + swz(r, q0 + j)) = window16(row, off + 2 * e + 16 * j);
  }
}

// The byte offset within 16 of mask row ``row`` at column ``col``.
template <class M>
__device__ __forceinline__ int row_offset(const Sweep& s, const M* bk, int row, int col) {
  return static_cast<int>(
      reinterpret_cast<uintptr_t>(bk + static_cast<size_t>(row) * s.N + col) & 15);
}

// The warp's own part of this chunk's bf16 mask tile.  A half that reads
// rows (the direct half) converts its 16 rows of the direct tile (each
// lane half a row); a half that reads columns (the transposed half, and
// the direct half under ``D_READS_T``) its 16 columns of all 64 rows of the
// transposed tile (each lane two rows), or of the direct tile under
// ``SINGLE``.  A half whose tile is not staged converts nothing.
template <class P = Parts>
__device__ __forceinline__ void convert(const Sweep& s, const int8_t* bk8, int c0,
                                        const unsigned char* raw, unsigned char* tile,
                                        int half, int rg, int lane) {
  using L = Layout<P>;
  using M = typename P::Mask;
  const M* bk = reinterpret_cast<const M*>(bk8);
  const bool by_rows = half == 0 && !P::D_READS_T;
  constexpr bool COLS_STAGED = P::SINGLE ? P::RAW_D : P::RAW_T;
  if (by_rows) {
    if constexpr (P::RAW_D) {
      const int r = 16 * rg + (lane >> 1), hc = lane & 1;
      const int off = row_offset(s, bk, s.n0 + r, c0);
      convert_run<M, 32>(tile, r, 4 * hc, raw + r * L::RAW_LD, off, 32 * hc);
    }
  } else if constexpr (COLS_STAGED) {
    // The tile's rows are the contraction: the chunk's mask rows, or the
    // node tile's under SINGLE (the direct tile read by columns).
    const unsigned char* base = P::SINGLE ? raw : raw + L::RAW_T_AT;
    const int row0 = P::SINGLE ? s.n0 : c0, col0 = P::SINGLE ? c0 : s.n0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = lane + 32 * e;
      const int off = row_offset(s, bk, row0 + r, col0);
      convert_run<M, 16>(tile, r, 2 * rg, base + r * L::RAW_LD, off, 16 * rg);
    }
  }
}

// acc[j] (columns 8j..8j+7 of the slice) += this chunk's product for the
// warp's 16 nodes.
template <Operands OP = Operands::PLANES, class P = Parts>
__device__ __forceinline__ void products(const unsigned char* tile, const unsigned char* opnd,
                                         float (&acc)[8][4], int half, int rg, int lane,
                                         int nh) {
  const unsigned t = smem_u32(tile), o = smem_u32(opnd);
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    uint32_t a[4];
    if (half == 0 && !P::D_READS_T) {
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
        if constexpr (OP == Operands::PLANES) {
          const int r = 16 * hp + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(b, o + swz(r, 2 * kk + ((lane >> 3) & 1)));
        } else {
          ldmatrix_x4_trans(b, o + swz(16 * kk + (lane & 15), 2 * hp + (lane >> 4)));
        }
        mma_bf16(acc[2 * hp], a, b[0], b[1]);
        mma_bf16(acc[2 * hp + 1], a, b[2], b[3]);
      }
    }
  }
}

// The sweep.  ``epi.relation(k, half, rg, lane, acc)`` runs at each
// relation's last chunk with the warp's accumulators (half 0: acc_D,
// half 1: acc_T) of each half that runs products, which are zeroed after.
// On return every copy has landed and every thread has passed a barrier,
// so the caller may reuse the shared memory.  Returns 0, or under
// ``P::SINK`` a word of every stage the thread saw land, folded (a policy
// that stages without converting has nothing else that reads the copies).
// A policy that stages nothing runs its products on zeroed shared memory.
template <Operands OP = Operands::PLANES, class P = Parts, class Epi>
__device__ __forceinline__ uint32_t sweep(const Sweep& s, Epi& epi, unsigned char* smem) {
  using L = Layout<P>;
  constexpr int RING = P::RING;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp >> 2, rg = warp & 3;
  const int nc = s.ch1 - s.ch0;
  const int steps = (s.k1 - s.k0) * nc;
  const bool prod = half == 0 ? P::PROD_D : P::PROD_T;
  unsigned char* tile = smem + RING * L::STAGE_BYTES + half * TILE_BYTES;
  uint32_t sink = 0;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if constexpr (!(P::RAW_D || P::RAW_T || P::OPND_D || P::OPND_T)) {
    for (int i = tid; i < L::SMEM_BYTES / 16; i += THREADS)
      reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  }

#pragma unroll
  for (int it = 0; it < RING - 1; ++it) {
    if (it < steps) stage<OP, P>(s, it, smem + it * L::STAGE_BYTES, tid);
    cp_async_commit();
  }
  int k = s.k0, ci = 0;  // relation and chunk (within the block's range) of step it
  for (int it = 0; it < steps; ++it) {
    cp_async_wait<RING - 2>();  // this thread's copies of step it have landed
    __syncthreads();            // everyone's; and step it - 1 is consumed
    const int nx = it + RING - 1;
    if (nx < steps) stage<OP, P>(s, nx, smem + (nx % RING) * L::STAGE_BYTES, tid);
    cp_async_commit();
    const unsigned char* st = smem + (it % RING) * L::STAGE_BYTES;
    if constexpr (P::SINK) sink ^= reinterpret_cast<const uint32_t*>(st)[tid];
    const int8_t* bk = s.mask +
        static_cast<size_t>(k) * s.N * s.N * sizeof(typename P::Mask);
    if constexpr (P::CONVERT) convert<P>(s, bk, (s.ch0 + ci) * TK, st, tile, half, rg, lane);
    __syncwarp();
    if (prod)
      products<OP, P>(tile, st + L::OPND_AT + half * TILE_BYTES, acc, half, rg, lane, s.nh);
    if (++ci == nc) {
      if (prod) epi.relation(k, half, rg, lane, acc);
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
  return sink;
}

}  // namespace paired
