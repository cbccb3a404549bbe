"""Public polypharmacy dataset parsers (bio-decagon CSV family).

The port's copy of ``decagon_tpu/data/public.py`` (numpy and ``csv``);
it parses through the port's native library (``decagon_tpu_torch.native``).

Parity spec: reference ``main/DataSetParsers/**`` for DecagonPublicData:

* node lists: drugs = union of combo-file drugs and target-file ``CID``-
  prefixed nodes; proteins = union of PPI nodes and target-file non-CID
  nodes; both sorted ascending by integer ID
  (``DecagonPublicDataNodeListsBuilder.py:37-77``);
* drug-drug relations: one symmetric adjacency per side effect, filtered
  to >= 500 raw edges
  (``DecagonPublicDataAdjacencyMatricesBuilder.py:112-125``);
* protein x drug target matrix (protein-major, edge type (0, 1) —
  ``:127-136``) and the symmetric PPI matrix;
* features: proteins identity; drugs = binary drug x mono-side-effect
  matrix (``DecagonPublicDataNodeFeaturesBuilder.py:31-51``);
* decoders: bilinear everywhere, DEDICOM on drug-drug
  (``configuration.json``).

Parsing is plain ``csv`` (no networkx on this path — the files run to
millions of rows); header rows are skipped automatically.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Iterable, List, Optional, Set

import numpy as np

from decagon_tpu_torch.graph.container import (
    NodeFeatures,
    Relation,
    RelationGraph,
)
from decagon_tpu_torch.graph.ids import SideEffectId

# Per-side-effect dataset variants from the reference
# (NeutropeniaAdjMtxBuilder.py:5-11 etc.).
NAMED_SIDE_EFFECTS = {
    "neutropenia": 27947,
    "hyperglycaemia": 20456,
    "anosmia": 3126,
}


def _read_rows(path: str, min_cols: int) -> Iterable[List[str]]:
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if len(row) < min_cols:
                continue
            yield row


def _is_header(row: List[str]) -> bool:
    # Data ID fields are letters+digits only ("CID000...", "9796");
    # header fields contain spaces ("STITCH 1", "Gene 1").
    field = row[0].strip()
    return not (
        any(ch.isdigit() for ch in field)
        and all(ch.isalnum() for ch in field)
    )


def _parse_int_csv(path: str, n_fields: int) -> np.ndarray:
    """Parse the first ``n_fields`` columns of a STITCH-style CSV into an
    ``[N, n_fields]`` int64 array (digits-only codec — matches the
    ``NodeIds`` parse: strip letters/leading zeros, e.g.
    ``CID000000042 -> 42``, ``C0001234 -> 1234``).  Header rows and rows
    with malformed/missing ID fields are skipped.

    Uses the native C++ parser when available (the combo file runs to
    millions of rows); the Python fallback applies the identical rules.
    """
    from decagon_tpu_torch import native

    arr = native.parse_edge_csv(path, n_fields)
    if arr is not None:
        return arr
    out: List[List[int]] = []
    for row in _read_rows(path, n_fields):
        vals: List[int] = []
        for raw in row[:n_fields]:
            field = raw.strip()
            if not (
                any(ch.isdigit() for ch in field)
                and all(ch.isalnum() for ch in field)
            ):
                break
            vals.append(int("".join(ch for ch in field if ch.isdigit())))
        else:
            out.append(vals)
    return np.asarray(out, np.int64).reshape(-1, n_fields)


def _first_seen_unique(keys: np.ndarray) -> np.ndarray:
    """Indices of the first occurrence of each distinct key, in original
    (first-seen) order — the vectorized equivalent of a Python
    seen-set/insertion-ordered-dict loop."""
    _, first = np.unique(keys, return_index=True)
    return np.sort(first)


@dataclasses.dataclass
class PublicDataset:
    """Parsed dataset: the graph plus the external-ID orderings that
    downstream components (predictor, recorded-edge CSVs) need."""

    graph: RelationGraph
    protein_ids: List[int]
    drug_ids: List[int]
    relation_names: List[str]  # side-effect external IDs, graph order


def load_public_dataset(
    combo_path: str,
    ppi_path: str,
    targets_path: str,
    mono_path: Optional[str] = None,
    min_edges_per_relation: int = 500,
    relation_allowlist: Optional[Set[int]] = None,
    drug_decoder: str = "dedicom",
    other_decoder: str = "bilinear",
    with_transposes: bool = True,
) -> PublicDataset:
    # ---- raw parses -------------------------------------------------------
    combo = _parse_int_csv(combo_path, 3)  # [N, (drug_a, drug_b, rel)]
    ppi_raw = _parse_int_csv(ppi_path, 2)  # [N, (protein_a, protein_b)]

    # Targets file: which column is the drug (CID prefix)?  The format is
    # consistent per file, so peek at the first data row
    # (the reference checks per-row at
    # DecagonPublicDataNodeListsBuilder.py:37-77 — same outcome).
    target_drug_col = 0
    for row in _read_rows(targets_path, 2):
        if _is_header(row):
            continue
        target_drug_col = 0 if row[0].strip().startswith("CID") else 1
        break
    targets = _parse_int_csv(targets_path, 2)
    target_drug = targets[:, target_drug_col]
    target_protein = targets[:, 1 - target_drug_col]

    # ---- node orderings (sorted integer IDs) ------------------------------
    drug_ids_arr = np.unique(
        np.concatenate([combo[:, 0], combo[:, 1], target_drug])
    )
    protein_ids_arr = np.unique(
        np.concatenate([ppi_raw[:, 0], ppi_raw[:, 1], target_protein])
    )
    n_drugs, n_proteins = len(drug_ids_arr), len(protein_ids_arr)
    drug_ids = [int(d) for d in drug_ids_arr]
    protein_ids = [int(p) for p in protein_ids_arr]

    # ---- relations ---------------------------------------------------------
    def symmetric_relation(
        ia: np.ndarray, ib: np.ndarray, n: int, name: str
    ) -> Relation:
        """Symmetrized, deduped relation from undirected index pairs,
        self-loops dropped, in first-seen edge order."""
        lo = np.minimum(ia, ib)
        hi = np.maximum(ia, ib)
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        first = _first_seen_unique(lo.astype(np.int64) * n + hi)
        lo, hi = lo[first], hi[first]
        rows = np.empty(2 * len(lo), np.int32)
        cols = np.empty(2 * len(lo), np.int32)
        rows[0::2], rows[1::2] = lo, hi
        cols[0::2], cols[1::2] = hi, lo
        return Relation(rows=rows, cols=cols, shape=(n, n), name=name)

    # Group combo edges by relation id (stable sort keeps first-seen
    # edge order within each relation).
    order = np.argsort(combo[:, 2], kind="stable")
    rel_sorted = combo[order]
    rel_ids, rel_starts = np.unique(rel_sorted[:, 2], return_index=True)
    rel_bounds = np.append(rel_starts, len(rel_sorted))
    drug_relations: List[Relation] = []
    for i, rel_id in enumerate(rel_ids):
        edges = rel_sorted[rel_bounds[i]:rel_bounds[i + 1]]
        if relation_allowlist is not None:
            # Per-side-effect variants select by ID *instead of* the
            # >=500-edge filter (the reference subclasses replace
            # _filterEdgeSets outright, NeutropeniaAdjMtxBuilder.py:5-11).
            if int(rel_id) not in relation_allowlist:
                continue
        elif len(edges) < min_edges_per_relation:
            continue
        drug_relations.append(
            symmetric_relation(
                np.searchsorted(drug_ids_arr, edges[:, 0]),
                np.searchsorted(drug_ids_arr, edges[:, 1]),
                n_drugs,
                name=SideEffectId(int(rel_id)).to_external(),
            )
        )
    if not drug_relations:
        raise ValueError(
            "no drug-drug relation passed the "
            f">={min_edges_per_relation}-edge filter"
        )

    ppi = symmetric_relation(
        np.searchsorted(protein_ids_arr, ppi_raw[:, 0]),
        np.searchsorted(protein_ids_arr, ppi_raw[:, 1]),
        n_proteins,
        name="ppi",
    )

    pd_rows = np.searchsorted(protein_ids_arr, target_protein)
    pd_cols = np.searchsorted(drug_ids_arr, target_drug)
    first = _first_seen_unique(pd_rows.astype(np.int64) * n_drugs + pd_cols)
    protein_drug = Relation(
        rows=pd_rows[first].astype(np.int32),
        cols=pd_cols[first].astype(np.int32),
        shape=(n_proteins, n_drugs),
        name="protein_drug",
    )

    # ---- features ----------------------------------------------------------
    if mono_path is not None:
        mono = _parse_int_csv(mono_path, 2)  # [N, (drug, side_effect)]
        se_ids = np.unique(mono[:, 1])
        known = np.isin(mono[:, 0], drug_ids_arr)
        feats = np.zeros((n_drugs, len(se_ids)), dtype=np.float32)
        feats[
            np.searchsorted(drug_ids_arr, mono[known, 0]),
            np.searchsorted(se_ids, mono[known, 1]),
        ] = 1.0
        drug_features = NodeFeatures.from_dense(feats)
    else:
        drug_features = NodeFeatures.identity(n_drugs)

    graph = RelationGraph(
        node_type_names=("protein", "drug"),
        num_nodes=(n_proteins, n_drugs),
        relations={
            (0, 0): [ppi],
            (0, 1): [protein_drug],
            (1, 1): drug_relations,
        },
        features={
            0: NodeFeatures.identity(n_proteins),
            1: drug_features,
        },
        decoders={
            (0, 0): other_decoder,
            (0, 1): other_decoder,
            (1, 0): other_decoder,
            (1, 1): drug_decoder,
        },
    )
    if with_transposes:
        graph = graph.with_transposes()
    return PublicDataset(
        graph=graph,
        protein_ids=protein_ids,
        drug_ids=drug_ids,
        relation_names=[rel.name for rel in drug_relations],
    )


def load_public_graph(*args, **kwargs) -> RelationGraph:
    """Graph-only convenience wrapper around ``load_public_dataset``."""
    return load_public_dataset(*args, **kwargs).graph


__all__ = ["load_public_dataset", "load_public_graph", "NAMED_SIDE_EFFECTS"]
