"""Train/val/test edge splitting with rejection-sampled negatives.

Behavioral spec: ``decagon/deep/minibatch.py:120-253``:

* per relation — shuffle edges; ``num_val = max(50, floor(E*val_frac))``,
  ``num_test = max(50, floor(E*test_frac))`` (the reference hardcodes the
  test fraction to 0 at ``minibatch.py:176``, leaving 50 test edges);
* negatives — uniformly sample (row, col) pairs, rejecting known edges and
  duplicates, until there are as many false edges as positives (the
  checked-in reference has a stray ``break`` at ``minibatch.py:202,216``
  that truncates the sets to one edge — upstream intent, equal-size sets,
  is implemented; membership checks use a hash set instead of the O(E)
  ``_ismember`` scan);
* transpose relations reuse the partner's splits with flipped endpoints
  (``minibatch.py:137-172``);
* drug-drug relations may take precomputed held-out edges from the active
  learner: those become val pos/neg, the test sets stay empty, and ALL
  edges train (``minibatch.py:235-253``);
* the train adjacency is rebuilt from surviving edges and degree-
  normalized (``preprocess_graph``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.normalize import normalize_adjacency


@dataclasses.dataclass
class EdgeSplit:
    """Per-relation edge split. All arrays are [N, 2] int32 (row, col)."""

    train: np.ndarray
    val: np.ndarray
    test: np.ndarray
    val_false: np.ndarray
    test_false: np.ndarray
    # Normalized train adjacency in COO (rows, cols, vals).
    adj_rows: np.ndarray = None
    adj_cols: np.ndarray = None
    adj_vals: np.ndarray = None

    def flipped(self) -> "EdgeSplit":
        def flip(edges: np.ndarray) -> np.ndarray:
            return edges[:, ::-1].copy() if edges.size else edges.reshape(0, 2)

        return EdgeSplit(
            train=flip(self.train),
            val=flip(self.val),
            test=flip(self.test),
            val_false=flip(self.val_false),
            test_false=flip(self.test_false),
            adj_rows=None,
            adj_cols=None,
            adj_vals=None,
        )


def _sample_false_edges(
    count: int,
    shape: Tuple[int, int],
    pos_keys: np.ndarray,
    rng: np.random.Generator,
) -> np.ndarray:
    """Rejection-sample ``count`` (row, col) pairs avoiding ``pos_keys``.

    ``pos_keys``: SORTED int64 linearized positives (``r * n_cols + c``).
    Large draws (``count > 4096``) go to the native C++ sampler
    (``decagon_tpu_torch.native``: hash-set rejection; the reference's
    equivalent was an O(E) scan per draw, ``minibatch.py:95-99``), seeded
    from ``rng`` exactly as the JAX package seeds its own, so the two
    packages draw the same negatives.  Without the library (it failed to
    build, or is switched off) the draw falls back to vectorized numpy
    (searchsorted membership tests — no Python-level per-edge loop), which
    equals the JAX package's fallback.
    """
    from decagon_tpu_torch import native

    n_cols = shape[1]
    if count > 4096 and pos_keys.size:
        sampled = native.sample_false_edges(
            pos_keys // n_cols, pos_keys % n_cols, shape, count,
            seed=int(rng.integers(0, 2**62)),
        )
        if sampled is not None:
            return sampled
    total_cells = shape[0] * shape[1]
    if total_cells - pos_keys.size < count:
        raise ValueError(
            f"cannot sample {count} false edges from a "
            f"{shape} matrix with {pos_keys.size} positives"
        )
    out_keys = np.empty(0, dtype=np.int64)
    while out_keys.size < count:
        cand = rng.integers(
            0, total_cells, size=2 * (count - out_keys.size) + 64
        )
        idx = np.searchsorted(pos_keys, cand)
        safe = np.minimum(idx, max(pos_keys.size - 1, 0))
        hit = (
            (idx < pos_keys.size) & (pos_keys[safe] == cand)
            if pos_keys.size
            else np.zeros(cand.shape, bool)
        )
        out_keys = np.unique(np.concatenate([out_keys, cand[~hit]]))
    out_keys = rng.permutation(out_keys)[:count]
    return np.stack(
        [out_keys // n_cols, out_keys % n_cols], axis=1
    ).astype(np.int32)


def split_relation(
    edges: np.ndarray,
    shape: Tuple[int, int],
    val_frac: float,
    test_frac: float,
    rng: np.random.Generator,
    min_holdout: int = 50,
    holdout_cap_frac: float = 0.25,
) -> EdgeSplit:
    """Split one relation's [E, 2] edge array; sample matching negatives.

    ``holdout_cap_frac`` clamps each holdout set to that fraction of the
    relation's edges — a divergence knob for relations under
    ``min_holdout / frac`` edges, where the reference's ``max(50, ...)``
    floor (``minibatch.py:176-177``) would otherwise eat the train set
    (its real data never hits this: >=500-edge filter).  Set to 1.0 for
    the reference's exact protocol on small relations."""
    edges = np.asarray(edges, dtype=np.int32).reshape(-1, 2)
    num_edges = edges.shape[0]
    num_val = max(min_holdout, int(np.floor(num_edges * val_frac)))
    num_test = max(min_holdout, int(np.floor(num_edges * test_frac)))
    cap = int(num_edges * holdout_cap_frac)
    num_val = min(num_val, cap)
    num_test = min(num_test, cap)
    if num_edges and num_val == 0:
        num_val = min(1, num_edges - 1)

    order = rng.permutation(num_edges)
    val = edges[order[:num_val]]
    test = edges[order[num_val : num_val + num_test]]
    train = edges[order[num_val + num_test :]]

    pos_keys = np.sort(
        edges[:, 0].astype(np.int64) * shape[1] + edges[:, 1]
    )
    test_false = _sample_false_edges(num_test, shape, pos_keys, rng)
    val_false = _sample_false_edges(num_val, shape, pos_keys, rng)

    adj_rows, adj_cols, adj_vals = normalize_adjacency(
        train[:, 0], train[:, 1], shape
    )
    return EdgeSplit(
        train=train,
        val=val,
        test=test,
        val_false=val_false,
        test_false=test_false,
        adj_rows=adj_rows,
        adj_cols=adj_cols,
        adj_vals=adj_vals,
    )


def split_graph(
    graph: RelationGraph,
    val_frac: float = 0.05,
    test_frac: float = 0.0,
    seed: int = 123,
    precomputed_holdout: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
    min_holdout: int = 50,
    holdout_cap_frac: float = 0.25,
) -> Dict[RelationKey, EdgeSplit]:
    """Split every relation of the graph.

    ``precomputed_holdout`` maps a drug-drug within-type relation index to
    ``{"positive": [P,2], "negative": [N,2]}`` held-out edges (the active-
    learner path, ``minibatch.py:33-36,125-126``).
    """
    rng = np.random.default_rng(seed)
    precomputed = precomputed_holdout or {}
    drug_drug = _drug_drug_edge_type(graph)
    splits: Dict[RelationKey, EdgeSplit] = {}

    for key in graph.relation_keys():
        i, j, k = key
        rel = graph.relation(key)
        if rel.transpose_of is not None and rel.transpose_of in splits:
            # Reuse the partner's splits AND its normalized train adjacency
            # with flipped coordinates (reference flips the stored tuple at
            # minibatch.py:143-149 rather than re-normalizing).
            partner = splits[rel.transpose_of]
            flipped = partner.flipped()
            flipped.adj_rows = partner.adj_cols.copy()
            flipped.adj_cols = partner.adj_rows.copy()
            flipped.adj_vals = partner.adj_vals.copy()
            splits[key] = flipped
        elif (i, j) == drug_drug and k in precomputed:
            hold = precomputed[k]
            rows, cols, vals = normalize_adjacency(rel.rows, rel.cols, rel.shape)
            splits[key] = EdgeSplit(
                train=rel.edges,
                val=np.asarray(hold["positive"], dtype=np.int32).reshape(-1, 2),
                test=np.empty((0, 2), dtype=np.int32),
                val_false=np.asarray(hold["negative"], dtype=np.int32).reshape(-1, 2),
                test_false=np.empty((0, 2), dtype=np.int32),
                adj_rows=rows,
                adj_cols=cols,
                adj_vals=vals,
            )
        else:
            splits[key] = split_relation(
                rel.edges, rel.shape, val_frac, test_frac, rng,
                min_holdout, holdout_cap_frac,
            )
    return splits


def _drug_drug_edge_type(graph: RelationGraph) -> Tuple[int, int]:
    """The (1, 1)-style edge type: highest-typed square edge type."""
    squares = [et for et in graph.relations if et[0] == et[1]]
    return max(squares) if squares else (-1, -1)
