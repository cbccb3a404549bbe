"""Host-side multi-relational typed graph container.

The graph is a set of node types (canonically ``("protein", "drug")``) and,
for every ordered pair of node types (an *edge type* ``(i, j)``), a list of
relations, each a sparse adjacency over ``(num_nodes[i], num_nodes[j])``.

Capability spec (reference): the adjacency dict built by
``main/Trainable/Decagon/DecagonDataSet.py:189-231`` and the legacy layout
in ``main.py:174-179`` — edge types ``(0,0)`` (PPI, plus transpose),
``(0,1)`` (protein->drug), ``(1,0)`` (its transpose), ``(1,1)`` (one
relation per side effect, plus transposes).  Transposed relations share
train/val/test splits with their partner downstream
(``main/Utils/Sparse.py:5-73``, ``decagon/deep/minibatch.py:123-172``) —
here the link is an explicit ``transpose_of`` field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

EdgeType = Tuple[int, int]
RelationKey = Tuple[int, int, int]  # (i, j, k)


@dataclasses.dataclass
class NodeFeatures:
    """Features for one node type: symbolic identity, or a dense matrix.

    The reference feeds features as sparse COO tuples (one-hot identity for
    featureless types, a binary drug x mono-side-effect matrix otherwise —
    ``main/DataSetParsers/NodeFeatures``).  Identity features stay
    *symbolic* (X @ W == W, no 19k x 19k one-hot ever materialized); real
    feature matrices are densified (small: #drugs x #mono-side-effects).
    """

    kind: str  # "identity" | "dense"
    dim: int
    dense: Optional[np.ndarray] = None  # [num_nodes, dim] float32 when kind=="dense"

    @staticmethod
    def identity(num_nodes: int) -> "NodeFeatures":
        return NodeFeatures(kind="identity", dim=num_nodes)

    @staticmethod
    def from_dense(matrix: np.ndarray) -> "NodeFeatures":
        matrix = np.asarray(matrix, dtype=np.float32)
        return NodeFeatures(kind="dense", dim=matrix.shape[1], dense=matrix)

    @property
    def nnz(self) -> int:
        if self.kind == "identity":
            return self.dim
        return int(np.count_nonzero(self.dense))


@dataclasses.dataclass
class Relation:
    """One relation: COO edges of an unweighted adjacency matrix.

    ``rows``/``cols`` index node type ``i``/``j`` of the owning edge type.
    ``transpose_of`` names the partner relation whose edge splits this one
    must mirror (with flipped endpoints).
    """

    rows: np.ndarray
    cols: np.ndarray
    shape: Tuple[int, int]
    name: str = ""
    transpose_of: Optional[RelationKey] = None

    def __post_init__(self) -> None:
        self.rows = np.asarray(self.rows, dtype=np.int32)
        self.cols = np.asarray(self.cols, dtype=np.int32)
        if self.rows.shape != self.cols.shape:
            raise ValueError("rows and cols must have equal length")

    @property
    def num_edges(self) -> int:
        return int(self.rows.shape[0])

    @property
    def edges(self) -> np.ndarray:
        """Edges as an [E, 2] array of (row, col) pairs."""
        return np.stack([self.rows, self.cols], axis=1)

    def transposed(self, of: RelationKey, name: str = "") -> "Relation":
        return Relation(
            rows=self.cols.copy(),
            cols=self.rows.copy(),
            shape=(self.shape[1], self.shape[0]),
            name=name or (self.name + "_T" if self.name else ""),
            transpose_of=of,
        )

    def col_degrees(self) -> np.ndarray:
        """Column sums of the adjacency (reference ``DecagonDataSet.py:276-292``)."""
        return np.bincount(self.cols, minlength=self.shape[1]).astype(np.float64)

    def to_dense(self) -> np.ndarray:
        dense = np.zeros(self.shape, dtype=np.float32)
        dense[self.rows, self.cols] = 1.0
        return dense

    @staticmethod
    def from_dense(matrix: np.ndarray, name: str = "") -> "Relation":
        rows, cols = np.nonzero(np.asarray(matrix))
        return Relation(rows=rows, cols=cols, shape=tuple(matrix.shape), name=name)

    @staticmethod
    def from_scipy(matrix, name: str = "") -> "Relation":
        coo = matrix.tocoo()
        return Relation(rows=coo.row, cols=coo.col, shape=tuple(coo.shape), name=name)


@dataclasses.dataclass
class RelationGraph:
    """A typed multi-relational graph plus per-type node features.

    ``relations`` maps each edge type to its ordered relation list; global
    relation indices enumerate ``(edge_type, k)`` in sorted edge-type order
    (matching the reference's ``edge_type2idx`` construction at
    ``decagon/deep/minibatch.py:45-54``).
    """

    node_type_names: Tuple[str, ...]
    num_nodes: Tuple[int, ...]
    relations: Dict[EdgeType, List[Relation]]
    features: Dict[int, NodeFeatures]
    decoders: Dict[EdgeType, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        for (i, j), rels in self.relations.items():
            for rel in rels:
                expect = (self.num_nodes[i], self.num_nodes[j])
                if tuple(rel.shape) != expect:
                    raise ValueError(
                        f"relation shape {rel.shape} != node counts {expect} "
                        f"for edge type {(i, j)}"
                    )

    # ---- enumeration ---------------------------------------------------

    @property
    def edge_types(self) -> Dict[EdgeType, int]:
        return {et: len(rels) for et, rels in sorted(self.relations.items())}

    @property
    def num_relations(self) -> int:
        return sum(len(r) for r in self.relations.values())

    def relation_keys(self) -> Iterator[RelationKey]:
        for (i, j), rels in sorted(self.relations.items()):
            for k in range(len(rels)):
                yield (i, j, k)

    def global_index(self) -> Dict[RelationKey, int]:
        return {key: idx for idx, key in enumerate(self.relation_keys())}

    def relation(self, key: RelationKey) -> Relation:
        i, j, k = key
        return self.relations[(i, j)][k]

    # ---- degrees (negative-sampling distributions) ---------------------

    def degrees(self) -> Dict[int, List[np.ndarray]]:
        """Per node type, one degree vector per *square* relation of that type.

        Mirrors the reference (legacy ``main.py:180-183``, framework
        ``DecagonDataSet.py:276-292``): node type ``i``'s degree list comes
        from the column sums of the ``(i, i)`` relations of the ORIGINAL
        (pre-split) adjacencies, and is indexed by within-type relation
        index for negative sampling (``decagon/deep/optimizer.py:36-49``).
        """
        out: Dict[int, List[np.ndarray]] = {}
        for t in range(len(self.num_nodes)):
            rels = self.relations.get((t, t), [])
            out[t] = [rel.col_degrees() for rel in rels]
            if not out[t]:
                # Fallback: uniform degrees when a type has no square relation.
                out[t] = [np.ones(self.num_nodes[t], dtype=np.float64)]
        return out

    # ---- transforms ----------------------------------------------------

    def with_transposes(self) -> "RelationGraph":
        """Augment every edge type with transposed relations.

        Mirrors ``DecagonDataSet._augmentAdjMtxDictWithTranspose``
        (``DecagonDataSet.py:212-231``): square edge types append their
        transposes in-type; rectangular type ``(i, j)`` contributes its
        transposes to edge type ``(j, i)``.  No-op for relations already
        marked as transposes.
        """
        new: Dict[EdgeType, List[Relation]] = {}
        for (i, j), rels in sorted(self.relations.items()):
            if any(r.transpose_of is not None for r in rels):
                raise ValueError("graph already contains transposed relations")
            if i == j:
                tposed = [
                    r.transposed(of=(i, j, k)) for k, r in enumerate(rels)
                ]
                new[(i, j)] = list(rels) + tposed
            else:
                new.setdefault((i, j), list(rels))
                new[(j, i)] = [
                    r.transposed(of=(i, j, k)) for k, r in enumerate(rels)
                ]
        decoders = dict(self.decoders)
        for (i, j) in new:
            if (i, j) not in decoders and (j, i) in decoders:
                decoders[(i, j)] = decoders[(j, i)]
        return RelationGraph(
            node_type_names=self.node_type_names,
            num_nodes=self.num_nodes,
            relations=new,
            features=self.features,
            decoders=decoders,
        )

    def masked(self, masks: Dict[RelationKey, np.ndarray]) -> "RelationGraph":
        """Return a copy with per-relation boolean edge masks applied.

        Used by the active-learning curriculum (reference
        ``RandomMaskingActiveLearner._applyMask``,
        ``main/ActiveLearner/RandomMaskingActiveLearner.py:188-200``).
        Mask arrays are per-edge booleans aligned with ``relation.edges``.
        """
        new: Dict[EdgeType, List[Relation]] = {}
        for (i, j), rels in self.relations.items():
            out_rels = []
            for k, rel in enumerate(rels):
                mask = masks.get((i, j, k))
                if mask is None:
                    out_rels.append(rel)
                else:
                    mask = np.asarray(mask, dtype=bool)
                    out_rels.append(
                        Relation(
                            rows=rel.rows[mask],
                            cols=rel.cols[mask],
                            shape=rel.shape,
                            name=rel.name,
                            transpose_of=rel.transpose_of,
                        )
                    )
            new[(i, j)] = out_rels
        return RelationGraph(
            node_type_names=self.node_type_names,
            num_nodes=self.num_nodes,
            relations=new,
            features=self.features,
            decoders=dict(self.decoders),
        )
