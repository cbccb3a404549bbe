"""K6's summation order in plain PyTorch, for the tests.

``spmm_tiled_ordered`` sums what the kernel (``decagon_tpu_torch/csrc/
spmm_tiled.cu``) sums in the kernel's order: the CPU tests hold it to
``spmm_tiled_ref`` and to the JAX kernel, the card tests hold the kernel
to it bit for bit.  It imports neither JAX nor the JAX package, so the
card tests can use it on a machine that has neither.
"""

import torch

from decagon_tpu_torch.ops.spmm_pallas import _check_precision, _rounded
from decagon_tpu_torch.ops.tiling import SHORT, CsrEdges


def _sequential_sums(x: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``[len(starts), H]``: f32 sums of ``x[starts[i] : starts[i] + lens[i]]``
    from 0, one term after another."""
    acc = torch.zeros((starts.numel(), x.shape[1]), dtype=torch.float32, device=x.device)
    for j in range(int(lens.max()) if lens.numel() else 0):
        live = lens > j
        acc[live] = acc[live] + x[starts[live] + j]
    return acc


def spmm_tiled_ordered(p_flat: torch.Tensor, tiles: CsrEdges,
                       precision: str = "highest") -> torch.Tensor:
    """K6's summation order in plain PyTorch: each message ``val * P[col]``
    rounded once; a short row, and each segment, summed in edge order; a
    long row's segment sums then added in slot order.  Meant for test sizes
    (one step a row position)."""
    _check_precision(precision)
    p, val = _rounded(p_flat, tiles, precision)
    msgs = p[tiles.col.long()] * val[:, None]
    row_ptr = tiles.row_ptr.long()
    lens = row_ptr[1:] - row_ptr[:-1]
    out = torch.zeros((tiles.n_dst, p.shape[1]), dtype=torch.float32, device=p.device)
    short = lens <= SHORT
    out[short] = _sequential_sums(msgs, row_ptr[:-1][short], lens[short])
    if tiles.num_segments:
        edges, dst = tiles.seg_edges.long(), tiles.seg_dst.long()
        sums = _sequential_sums(msgs, edges[:, 0], edges[:, 1] - edges[:, 0])
        out[dst[dst >= 0]] = sums[dst >= 0]
        partial = torch.empty((tiles.num_slots, p.shape[1]), dtype=torch.float32, device=p.device)
        partial[~dst[dst < 0]] = sums[dst < 0]
        ptr = tiles.multi_ptr.long()
        out[tiles.multi_row.long()] = _sequential_sums(partial, ptr[:-1], ptr[1:] - ptr[:-1])
    return out
