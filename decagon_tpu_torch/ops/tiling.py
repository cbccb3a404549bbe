"""Host-side edge layout for the sparse aggregation kernel (K6): a
destination-sorted CSR with a fixed-size segment schedule.

Counterpart of ``decagon_tpu/ops/tiling.py``.  There the edges of the
aggregation ``out[dst] += val * P_flat[src]`` are packed into C-edge tiles
whose sources fit one dynamic ``block_s``-row window, with 16-bit local
indices and a cost model over MXU flops and VMEM DMA.  None of that binds
on Hopper, where a warp gathers rows directly.  The contract kept is the
set of edges: ``CsrEdges`` holds the same ``(dst, src, val)`` multiset as
``TiledEdges`` (zero-valued padding edges dropped, duplicate pairs kept as
separate entries), in the order the kernel sums them:

* ``row_ptr`` int32 [n_dst + 1], ``col`` int32 [E], ``val`` f32 [E]:
  row ``d`` holds edges ``row_ptr[d]:row_ptr[d+1]``, by ascending source
  (duplicates in input order).

The paper graph's rows are very uneven (645 drug rows of ~13,000 edges
in the drug-drug forward, 1.24M rows of ~7 in its backward), so the kernel
does not give one warp a row.  Each row is cut into segments of at most
``SEGMENT`` edges, and every row has at least one (an empty row gets an
empty segment, which writes its zeros):

* ``seg_ptr`` int32 [S + 1]: segment ``s`` holds edges
  ``seg_ptr[s]:seg_ptr[s+1]`` (segments are contiguous and in row order);
* ``seg_row`` int32 [S]: its row;
* ``seg_slot`` int32 [S]: -1 for a row's only segment, which writes the
  output row itself; else the segment's slot in the partial-sum buffer;
* ``multi_row`` int32 [M] and ``multi_ptr`` int32 [M + 1]: the rows with
  more than one segment and their slots, ``multi_ptr[m]:multi_ptr[m+1]``
  (contiguous, in segment order), which a second pass adds in order.

``build_tiles`` keeps the JAX function's name and first five arguments;
the TPU geometry (``block_r``, ``block_s``, ``tile_c``) has no meaning
here and is gone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Edges per segment: one warp reduces one segment.
SEGMENT = 256

_INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class CsrEdges:
    """One aggregation direction as a destination-sorted CSR with its
    segment schedule (module docstring); the counterpart of the JAX
    package's ``TiledEdges``.  Tensors are int32 but ``val`` (f32)."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    seg_ptr: torch.Tensor
    seg_row: torch.Tensor
    seg_slot: torch.Tensor
    multi_row: torch.Tensor
    multi_ptr: torch.Tensor
    n_dst: int
    n_src: int
    num_slots: int  # rows of the partial-sum buffer: multi_ptr[-1]

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def num_segments(self) -> int:
        return int(self.seg_row.shape[0])

    def dst_index(self) -> torch.Tensor:
        """int64 [E]: each edge's destination row (no host sync)."""
        counts = self.row_ptr[1:] - self.row_ptr[:-1]
        rows = torch.arange(self.n_dst, device=self.row_ptr.device)
        return torch.repeat_interleave(rows, counts.long(), output_size=self.nnz)

    def to(self, device) -> "CsrEdges":
        return dataclasses.replace(
            self, **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)
            }
        )


def _int32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def build_tiles(
    src: np.ndarray,
    dst: np.ndarray,
    vals: np.ndarray,
    n_src: int,
    n_dst: int,
) -> CsrEdges:
    """``CsrEdges`` (CPU tensors) for ``out[dst] += vals * P[src]`` with
    ``P`` of ``n_src`` rows and ``out`` of ``n_dst``.  Zero-valued edges
    are dropped; the sort is one stable argsort of the int64 key
    ``dst * n_src + src``, so duplicates keep their input order."""
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals, dtype=np.float32).reshape(-1)
    if not src.shape == dst.shape == vals.shape:
        raise ValueError("src, dst and vals must have one length")
    keep = vals != 0.0
    src, dst, vals = src[keep], dst[keep], vals[keep]
    if max(n_src, n_dst, src.size) > _INT32_MAX:
        raise ValueError("the CSR layout indexes with int32: sizes must stay below 2^31")
    if src.size and (src.min() < 0 or src.max() >= n_src or dst.min() < 0 or dst.max() >= n_dst):
        raise ValueError(f"edge index outside [0, {n_src}) x [0, {n_dst})")

    order = np.argsort(dst * max(n_src, 1) + src, kind="stable")
    counts = np.bincount(dst, minlength=n_dst).astype(np.int64)
    row_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    nseg = np.maximum(1, -(-counts // SEGMENT))
    first_seg = np.zeros(n_dst + 1, np.int64)
    np.cumsum(nseg, out=first_seg[1:])
    seg_row = np.repeat(np.arange(n_dst, dtype=np.int64), nseg)
    within = np.arange(seg_row.size, dtype=np.int64) - first_seg[seg_row]
    seg_ptr = np.append(row_ptr[seg_row] + within * SEGMENT, src.size)

    multi = nseg[seg_row] > 1
    seg_slot = np.full(seg_row.size, -1, np.int64)
    seg_slot[multi] = np.arange(int(multi.sum()), dtype=np.int64)
    multi_row = np.flatnonzero(nseg > 1)
    multi_ptr = np.zeros(multi_row.size + 1, np.int64)
    np.cumsum(nseg[multi_row], out=multi_ptr[1:])

    return CsrEdges(
        row_ptr=_int32(row_ptr),
        col=_int32(src[order]),
        val=torch.from_numpy(np.ascontiguousarray(vals[order])),
        seg_ptr=_int32(seg_ptr),
        seg_row=_int32(seg_row),
        seg_slot=_int32(seg_slot),
        multi_row=_int32(multi_row),
        multi_ptr=_int32(multi_ptr),
        n_dst=int(n_dst),
        n_src=int(n_src),
        num_slots=int(multi_ptr[-1]),
    )


def tiling_stats(tiles: CsrEdges) -> dict:
    """Row-length diagnostics (the JAX package reports tile occupancy,
    which has no meaning for a CSR)."""
    lengths = (tiles.row_ptr[1:] - tiles.row_ptr[:-1]).cpu()
    return {
        "nnz": tiles.nnz,
        "rows": tiles.n_dst,
        "max_row": int(lengths.max()) if tiles.n_dst else 0,
        "mean_row": tiles.nnz / max(1, tiles.n_dst),
        "segments": tiles.num_segments,
        "multi_segment_rows": int(tiles.multi_row.numel()),
    }
