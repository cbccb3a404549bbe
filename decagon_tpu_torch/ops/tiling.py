"""Host-side edge layout for the sparse aggregation kernel (K6): a
destination-sorted CSR with a schedule that separates short rows from
long ones.

Counterpart of ``decagon_tpu/ops/tiling.py``.  There the edges of the
aggregation ``out[dst] += val * P_flat[src]`` are packed into C-edge tiles
whose sources fit one dynamic ``block_s``-row window, with 16-bit local
indices and a cost model over MXU flops and VMEM DMA.  None of that binds
on Hopper, where lanes gather rows directly.  The contract kept is the set
of edges: ``CsrEdges`` holds the same ``(dst, src, val)`` multiset as
``TiledEdges`` (zero-valued padding edges dropped, duplicate pairs kept as
separate entries), in the order the kernel sums them:

* ``row_ptr`` int32 [n_dst + 1], ``col`` int32 [E], ``val`` f32 [E]:
  row ``d`` holds edges ``row_ptr[d]:row_ptr[d+1]``, by ascending source
  (duplicates in input order).

The paper graph's rows are very uneven (645 drug rows of ~13,000 edges in
the drug-drug forward, 1.24M rows of ~7 in its backward, PPI rows of ~135
either way), so rows are classified once, here:

* a **short** row (at most ``SHORT`` edges, empty rows included) needs no
  schedule word of its own: the kernel's row pass reads its bounds from
  ``row_ptr`` and sums it in edge order.  Runs of consecutive short rows
  are cut into chunks that a block stages at once: ``row_chunks`` int32
  [C, 4] holds each chunk's rows ``[c0, c1)`` and their edges
  ``[row_ptr[c0], row_ptr[c1])``, at most ``CHUNK_ROWS`` rows and
  ``CHUNK_EDGES`` edges;
* any other row is cut into segments: at every multiple of ``window``
  source rows (when ``window > 0``), then every ``SEGMENT`` edges.  A row
  of one segment (a **medium** row) is written by it; each segment of a
  **long** row writes one slot of a partial-sum buffer, and a second pass
  adds the row's slots in slot order.

The segments' schedule, segments in edge order (row by row, ascending
source):

* ``seg_edges`` int32 [S, 2]: segment ``s`` sums edges
  ``seg_edges[s, 0]:seg_edges[s, 1]``;
* ``seg_dst`` int32 [S]: a medium row's segment holds its row ``d >=
  0``; a long row's holds ``~slot`` (negative), slots numbered in edge
  order, so a row's slots are contiguous;
* ``seg_order`` int32 [S]: the segments in launch order, window by window
  (then row, then segment), so that the segments in flight at once gather
  from a few windows of the source table (edge order when ``window ==
  0``);
* ``multi_row`` int32 [M] and ``multi_ptr`` int32 [M + 1]: the long rows,
  ascending, and their slots ``multi_ptr[m]:multi_ptr[m+1]``.

Every pass adds each message (``val * P[col]``, rounded once) to an f32
sum in a fixed order, so two calls give equal bits.  ``build_tiles``
keeps the JAX function's name and first five arguments; the TPU geometry
(``block_r``, ``block_s``, ``tile_c``) has no meaning here and is gone.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Longest short row (the row pass), and the most edges a segment sums.
SHORT = 32
SEGMENT = 256
# The most rows and edges of a chunk of short rows (the kernel's staging
# buffers hold this many).
CHUNK_ROWS = 512
CHUNK_EDGES = 2048
# Source rows a window spans in the long rows' launch order (0: no
# windows, rows cut every SEGMENT edges only).  On the H100 the drug-drug
# forward (a [1.24M, 64] table) ran fastest at 131,072 rows of 0, 8,192,
# 32,768 and 131,072 (decagon_tpu_torch/scripts/probe_sparse_kernels.py).
WINDOW = 131072

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class CsrEdges:
    """One aggregation direction as a destination-sorted CSR with its
    long-row schedule (module docstring); the counterpart of the JAX
    package's ``TiledEdges``.  Tensors are int32 but ``val`` (f32)."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    row_chunks: torch.Tensor
    seg_edges: torch.Tensor
    seg_dst: torch.Tensor
    seg_order: torch.Tensor
    multi_row: torch.Tensor
    multi_ptr: torch.Tensor
    n_dst: int
    n_src: int
    num_slots: int  # rows of the partial-sum buffer: multi_ptr[-1]
    window: int = 0
    # (device, arguments) the kernel's wrapper last built from this layout
    # (ops/spmm_pallas._layout_args).
    launch_args: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False
    )

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    @property
    def num_segments(self) -> int:
        return int(self.seg_order.shape[0])

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


def _segments(col: np.ndarray, row_ptr: np.ndarray, rows: np.ndarray, window: int):
    """(seg_edges [S, 2], seg_row [S], seg_window [S]) of ``rows``: each
    cut at window boundaries, then every ``SEGMENT`` edges; in edge
    order."""
    starts, lens = row_ptr[rows], row_ptr[rows + 1] - row_ptr[rows]
    total = int(lens.sum())
    if total == 0:
        return np.zeros((0, 2), np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64)
    first = np.zeros(rows.size + 1, np.int64)
    np.cumsum(lens, out=first[1:])
    owner = np.repeat(np.arange(rows.size), lens)  # index into rows of each edge
    edge = starts[owner] + np.arange(total) - first[owner]  # its CSR index
    win = col[edge] // window if window > 0 else np.zeros(total, np.int64)
    piece = np.ones(total, bool)  # first edge of a (row, window) piece
    piece[1:] = (owner[1:] != owner[:-1]) | (win[1:] != win[:-1])
    piece_first = np.flatnonzero(piece)
    at = np.arange(total) - piece_first[np.cumsum(piece) - 1]
    seg_first = np.flatnonzero(at % SEGMENT == 0)
    seg_last = np.append(seg_first[1:], total) - 1
    seg_edges = np.stack([edge[seg_first], edge[seg_last] + 1], axis=1)
    return seg_edges, rows[owner[seg_first]], win[seg_first]


def _row_chunks(counts: np.ndarray, row_ptr: np.ndarray) -> np.ndarray:
    """[C, 4] (first row, end row, first edge, end edge) of the chunks of
    short rows: each run of consecutive short rows cut every
    ``CHUNK_ROWS`` rows and wherever its edge count passes a multiple of
    ``CHUNK_EDGES - SHORT`` (a chunk's last row adds at most ``SHORT``)."""
    short = np.flatnonzero(counts <= SHORT)
    if short.size == 0:
        return np.zeros((0, 4), np.int64)
    run_start = np.ones(short.size, bool)
    run_start[1:] = np.diff(short) != 1
    run = np.cumsum(run_start) - 1
    first = short[run_start][run]  # first row of each short row's run
    key_rows = (short - first) // CHUNK_ROWS
    key_edges = (row_ptr[short] - row_ptr[first]) // (CHUNK_EDGES - SHORT)
    new = run_start.copy()
    new[1:] |= (key_rows[1:] != key_rows[:-1]) | (key_edges[1:] != key_edges[:-1])
    c0 = short[new]
    last = np.append(np.flatnonzero(new)[1:], short.size) - 1
    c1 = short[last] + 1
    return np.stack([c0, c1, row_ptr[c0], row_ptr[c1]], axis=1)


def build_tiles(
    src: np.ndarray,
    dst: np.ndarray,
    vals: np.ndarray,
    n_src: int,
    n_dst: int,
    window: int = WINDOW,
) -> CsrEdges:
    """``CsrEdges`` (CPU tensors) for ``out[dst] += vals * P[src]`` with
    ``P`` of ``n_src`` rows and ``out`` of ``n_dst``.  Zero-valued edges
    are dropped; the sort is one stable argsort of the int64 key
    ``dst * n_src + src``, so duplicates keep their input order.
    ``window``: source rows a segment may span (0: any)."""
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    vals = np.asarray(vals, dtype=np.float32).reshape(-1)
    if not src.shape == dst.shape == vals.shape:
        raise ValueError("src, dst and vals must have one length")
    if window < 0:
        raise ValueError(f"window must be >= 0, not {window}")
    keep = vals != 0.0
    src, dst, vals = src[keep], dst[keep], vals[keep]
    if max(n_src, n_dst, src.size) > INT32_MAX:
        raise ValueError("the CSR layout indexes with int32: sizes must stay below 2^31")
    if src.size and (src.min() < 0 or src.max() >= n_src or dst.min() < 0 or dst.max() >= n_dst):
        raise ValueError(f"edge index outside [0, {n_src}) x [0, {n_dst})")

    order = np.argsort(dst * max(n_src, 1) + src, kind="stable")
    col = src[order]
    counts = np.bincount(dst, minlength=n_dst).astype(np.int64)
    row_ptr = np.zeros(n_dst + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    seg_edges, seg_row, seg_win = _segments(col, row_ptr, np.flatnonzero(counts > SHORT), window)
    per_row = np.bincount(seg_row, minlength=n_dst)
    multi = per_row[seg_row] > 1
    seg_dst = seg_row.copy()
    seg_dst[multi] = ~np.arange(int(multi.sum()), dtype=np.int64)
    multi_row = np.flatnonzero(per_row > 1)
    multi_ptr = np.zeros(multi_row.size + 1, np.int64)
    np.cumsum(per_row[multi_row], out=multi_ptr[1:])

    return CsrEdges(
        row_ptr=_int32(row_ptr),
        col=_int32(col),
        val=torch.from_numpy(np.ascontiguousarray(vals[order])),
        row_chunks=_int32(_row_chunks(counts, row_ptr).reshape(-1, 4)),
        seg_edges=_int32(seg_edges.reshape(-1, 2)),
        seg_dst=_int32(seg_dst),
        seg_order=_int32(np.argsort(seg_win, kind="stable")),
        multi_row=_int32(multi_row),
        multi_ptr=_int32(multi_ptr),
        n_dst=int(n_dst),
        n_src=int(n_src),
        num_slots=int(multi_ptr[-1]),
        window=int(window),
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
        "short_rows": int((lengths <= SHORT).sum()),
        "row_chunks": int(tiles.row_chunks.shape[0]),
        "long_rows": int(tiles.multi_row.numel()),
        "segments": tiles.num_segments,
        "partial_slots": tiles.num_slots,
    }
