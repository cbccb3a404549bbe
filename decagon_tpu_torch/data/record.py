"""Recorded held-out-edge CSVs for the offline predictor.

The port's copy of ``decagon_tpu/data/record.py`` over the port's
graph containers and ids.

Parity spec: reference ``DecagonTrainableBuilder._recordTestEdges``
(``main/Trainable/Decagon/DecagonTrainableBuilder.py:123-212``): every
relation's held-out val edges (positives label 1, sampled negatives
label 0) written as ``FromNode,ToNode,RelationId,Label`` rows in STITCH
external format, with transposed relations skipped (their edges mirror
the partner's).  The timestamped-filename convention is preserved via
``timestamped_path``.
"""

from __future__ import annotations

import csv
import datetime
from typing import Dict, Optional, Sequence

from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.ids import DrugId, ProteinId, SideEffectId
from decagon_tpu_torch.graph.split import EdgeSplit

FIELDS = ["FromNode", "ToNode", "RelationId", "Label"]


def timestamped_path(base: str) -> str:
    if base.endswith(".csv"):
        base = base[: -len(".csv")]
    stamp = str(datetime.datetime.now()).replace(" ", "-")
    return f"{base}-{stamp}.csv"


def write_heldout_edges_csv(
    graph: RelationGraph,
    splits: Dict[RelationKey, EdgeSplit],
    path: str,
    protein_ids: Optional[Sequence[int]] = None,
    drug_ids: Optional[Sequence[int]] = None,
    relation_names: Optional[Sequence[str]] = None,
    drug_type: int = 1,
) -> str:
    """Write val pos/neg edges for every non-transposed relation."""
    protein_ids = protein_ids or list(range(graph.num_nodes[0]))
    drug_ids = drug_ids or list(range(graph.num_nodes[drug_type]))

    def external(node_type: int, idx: int) -> str:
        if node_type == drug_type:
            return DrugId(drug_ids[idx]).to_external()
        return ProteinId(protein_ids[idx]).to_external()

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        for key in graph.relation_keys():
            i, j, k = key
            rel = graph.relation(key)
            if rel.transpose_of is not None:
                continue
            if (i, j) == (drug_type, drug_type):
                if relation_names is not None and k < len(relation_names):
                    rel_str = relation_names[k]
                elif rel.name and rel.name.startswith("C"):
                    rel_str = rel.name
                else:
                    rel_str = SideEffectId(k).to_external()
            else:
                rel_str = ""
            split = splits[key]
            for edges, label in ((split.val, 1), (split.val_false, 0)):
                for r, c in edges:
                    writer.writerow(
                        {
                            "FromNode": external(i, int(r)),
                            "ToNode": external(j, int(c)),
                            "RelationId": rel_str,
                            "Label": label,
                        }
                    )
    return path
