"""Degree normalization of relation adjacencies.

Behavioral spec: ``decagon/deep/minibatch.py:80-93`` (``preprocess_graph``):

* square adjacency ``A``:  ``A_ = A + I``; with ``d = rowsum(A_)`` the
  normalized matrix is ``D^{-1/2} A_^T D^{-1/2}`` (the reference composes
  ``(A_ D^{-1/2})^T D^{-1/2}``, i.e. it normalizes the *transpose* — exact
  parity is kept, which matters when a train split is asymmetric);
* rectangular adjacency:  ``Dr^{-1/2} A Dc^{-1/2}`` with zero degrees
  mapped to zero (reference uses ``nan_to_num``).

Implemented directly on COO edge arrays (no scipy matrices on the hot
path): output is an edge list with float32 values, ready for the device
segment-sum SpMM.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def normalize_square(
    rows: np.ndarray, cols: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalize a square adjacency given by COO edges (values all 1).

    Returns (rows, cols, vals) of ``D^{-1/2} (A + I)^T D^{-1/2}`` where
    ``D`` is the row-degree of ``A + I``.  Edge ``(r, c)`` of ``A + I``
    lands at position ``(c, r)`` with value ``d[r]^{-1/2} d[c]^{-1/2}``
    (the scale is symmetric in ``(r, c)``; only the position flips).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    # A_ = A + I (duplicate (v,v) entries are impossible if A has no
    # self-loops; if it does, values accumulate as in scipy's coo->csr).
    eye = np.arange(n, dtype=np.int64)
    a_rows = np.concatenate([rows, eye])
    a_cols = np.concatenate([cols, eye])
    deg = np.bincount(a_rows, minlength=n).astype(np.float64)
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[~np.isfinite(dinv)] = 0.0
    vals = dinv[a_rows] * dinv[a_cols]
    # Transposed positions, matching the reference's (A_ D)^T D composition.
    out_rows, out_cols = a_cols, a_rows
    order = np.lexsort((out_cols, out_rows))
    return (
        out_rows[order].astype(np.int32),
        out_cols[order].astype(np.int32),
        vals[order].astype(np.float32),
    )


def normalize_rect(
    rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalize a rectangular adjacency: ``Dr^{-1/2} A Dc^{-1/2}``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    n_rows, n_cols = shape
    row_deg = np.bincount(rows, minlength=n_rows).astype(np.float64)
    col_deg = np.bincount(cols, minlength=n_cols).astype(np.float64)
    with np.errstate(divide="ignore"):
        rinv = np.power(row_deg, -0.5)
        cinv = np.power(col_deg, -0.5)
    rinv[~np.isfinite(rinv)] = 0.0
    cinv[~np.isfinite(cinv)] = 0.0
    vals = rinv[rows] * cinv[cols]
    order = np.lexsort((cols, rows))
    return (
        rows[order].astype(np.int32),
        cols[order].astype(np.int32),
        vals[order].astype(np.float32),
    )


def normalize_adjacency(
    rows: np.ndarray, cols: np.ndarray, shape: Tuple[int, int]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dispatch on square vs rectangular, as ``preprocess_graph`` does."""
    if shape[0] == shape[1]:
        return normalize_square(rows, cols, shape[0])
    return normalize_rect(rows, cols, shape)
