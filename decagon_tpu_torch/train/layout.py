"""What the CLI trains on, built from its config: the dataset, the graph
in the numbering the model trains on, and its device graph.

``cli.train_once`` trains on what these functions build and
``predict.export.main`` rebuilds it through the same functions, so the
exported template has the trained layout: the paired stacks the CLI
builds on the card by default, and the ``RenumberNodes`` numbering, whose
embeddings are written back in external row order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from decagon_tpu_torch.config import Config
from decagon_tpu_torch.data.public import NAMED_SIDE_EFFECTS, load_public_dataset
from decagon_tpu_torch.graph.container import RelationGraph, RelationKey
from decagon_tpu_torch.graph.device import DeviceGraph, build_device_graph
from decagon_tpu_torch.graph.split import EdgeSplit, split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph


def _side_effect_subset(config: Config):
    """``SideEffectSubset`` config -> relation allowlist (or None).

    Accepts a named variant ("neutropenia" / "hyperglycaemia" /
    "anosmia" — the reference's per-side-effect AdjMtxBuilder
    subclasses, ``NeutropeniaAdjMtxBuilder.py:5-11`` etc.), a single
    relation id, or a list of either."""
    raw = config.get("SideEffectSubset", None)
    if raw is None:
        return None
    items = raw if isinstance(raw, (list, tuple)) else [raw]
    subset = set()
    for item in items:
        if isinstance(item, str) and not item.isdigit():
            try:
                subset.add(NAMED_SIDE_EFFECTS[item.lower()])
            except KeyError:
                raise ValueError(
                    f"unknown side-effect name {item!r}; known: "
                    f"{sorted(NAMED_SIDE_EFFECTS)} (or pass relation ids)"
                )
        else:
            subset.add(int(item))
    return subset


def build_dataset(config: Config):
    """Returns (graph_without_transposes, protein_ids, drug_ids, names)."""
    dataset_type = config.get("DataSetType", "DecagonDummyData")
    if dataset_type == "DecagonPublicData":
        ds = load_public_dataset(
            combo_path=config.get("DecagonDrugDrugRelationsFilename"),
            ppi_path=config.get("DecagonProteinProteinRelationsFilename"),
            targets_path=config.get("DecagonDrugProteinRelationsFilename"),
            mono_path=(
                config.get("DecagonNodeFeaturesFilename", None)
                if config.get("UseMonoFeatures", True)
                else None
            ),
            min_edges_per_relation=int(config.get("MinEdgesPerRelation", 500)),
            relation_allowlist=_side_effect_subset(config),
            drug_decoder=config.get("DrugDrugEdgeDecoder", "dedicom"),
            other_decoder=config.get("PPIEdgeDecoder", "bilinear"),
            with_transposes=False,
        )
        return ds.graph, ds.protein_ids, ds.drug_ids, ds.relation_names
    if dataset_type == "DecagonDummyData":
        graph = make_synthetic_graph(
            n_genes=int(config.get("NumProteins", 500)),
            n_drugs=int(config.get("NumDrugs", 400)),
            n_drugdrug_types=int(config.get("NumDrugDrugRelationTypes", 3)),
            seed=int(config.get("Seed", 0)),
            with_transposes=False,
            drug_decoder=config.get("DrugDrugEdgeDecoder", "dedicom"),
            other_decoder=config.get("PPIEdgeDecoder", "bilinear"),
        )
        names = [r.name for r in graph.relations[(1, 1)]]
        return (
            graph,
            list(range(graph.num_nodes[0])),
            list(range(graph.num_nodes[1])),
            names,
        )
    raise ValueError(f"unknown DataSetType: {dataset_type}")


@dataclasses.dataclass
class TrainingGraph:
    """The graph the model trains on, in its node numbering: ``full`` (with
    transposes unless configured off), its ``splits``, the external ids in
    that numbering and, with ``RenumberNodes``, the ``{type: old_of_new}``
    permutations (else None)."""

    full: RelationGraph
    splits: Dict[RelationKey, EdgeSplit]
    protein_ids: List[int]
    drug_ids: List[int]
    node_perms: Optional[Dict[int, np.ndarray]]


def training_graph(
    config: Config, graph: RelationGraph, protein_ids, drug_ids, holdout=None
) -> TrainingGraph:
    """``graph`` (without transposes) as the CLI trains on it, with the
    active learner's ``holdout`` as precomputed drug-drug val edges."""
    full = (
        graph.with_transposes()
        if bool(config.get("TrainWithTransposedAdjacencyMatrices", True))
        else graph
    )
    node_perms = None
    if bool(config.get("RenumberNodes", False)):
        # Degree-clustered relabeling (graph/renumber.py): packs the hot
        # rows of K6's gathers together.  The external-id lists are
        # permuted alongside so the held-out CSV keeps STITCH ids correct,
        # active-learner holdouts are translated in, and npy exports
        # restore external row order on the way out.
        from decagon_tpu_torch.graph.renumber import renumber_by_degree

        full, node_perms = renumber_by_degree(full)
        inv = {t: np.argsort(node_perms[t]) for t in node_perms}
        protein_ids = [protein_ids[o] for o in node_perms[0]]
        drug_ids = [drug_ids[o] for o in node_perms[1]]
        if holdout:
            holdout = {
                k: {
                    tag: inv[1][np.asarray(edges).reshape(-1, 2)]
                    for tag, edges in h.items()
                }
                for k, h in holdout.items()
            }
    splits = split_graph(
        full,
        val_frac=float(config.get("ValFraction", 0.05)),
        test_frac=float(config.get("TestFraction", 0.0)),
        seed=int(config.get("Seed", 0)),
        precomputed_holdout=holdout or None,
        min_holdout=int(config.get("MinHoldoutEdges", 50)),
        holdout_cap_frac=float(config.get("HoldoutCapFraction", 0.25)),
    )
    return TrainingGraph(full, splits, list(protein_ids), list(drug_ids), node_perms)


def build_training_device_graph(
    config: Config, tg: TrainingGraph, device: torch.device
) -> DeviceGraph:
    """The device graph the CLI trains on: CSR layouts for ``SpmmImpl``
    "pallas"/"fused_pallas", or "auto" off the CPU; the int8 factored and
    paired stacks by default off the CPU (``DenseFactored`` /
    ``DensePaired``).  With ``MeshShape`` the paired stacks are off by
    default: the mesh trains on its own sharded graph, which has none, so
    its weights keep the standard ``[K, F, H]`` layout and this graph is
    the one its checkpoints restore into (``predict.export``)."""
    spmm_impl = config.model_config().spmm_impl
    on_card = device.type != "cpu"
    return build_device_graph(
        tg.full, tg.splits,
        tile_for_pallas="pallas" in spmm_impl or (spmm_impl == "auto" and on_card),
        densify_max_cells=int(config.get("DensifyMaxCells", 8_000_000)),
        dense_dtype=(
            torch.bfloat16
            if str(config.get("DenseDtype", "f32")) in ("bf16", "bfloat16")
            else torch.float32
        ),
        # int8 factored stacks (half the dense path's bytes).
        dense_factored=bool(config.get("DenseFactored", on_card)),
        # Paired half-mask stacks and the paired kernels: one int8 mask
        # read serves both transpose halves of a square edge type.
        dense_paired=bool(
            config.get("DensePaired", on_card and not config.has("MeshShape"))
        ),
        device=device,
    )
