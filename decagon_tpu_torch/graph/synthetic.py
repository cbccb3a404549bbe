"""Deterministic synthetic graphs shaped like the polypharmacy dataset.

Port of ``decagon_tpu/graph/synthetic.py::make_polypharmacy_like_graph``
(``make_synthetic_graph`` comes with a later slice).  The reference builds
its PPI graph with ``networkx.barabasi_albert_graph``; networkx is not a
dependency of the port, so ``barabasi_albert_adjacency`` replays the same
algorithm with the standard library and returns the same adjacency, edge
for edge (``tests/test_torch_graph.py`` holds it against networkx).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import scipy.sparse as sp

from decagon_tpu_torch.graph.container import NodeFeatures, Relation, RelationGraph


def barabasi_albert_adjacency(n: int, m: int, seed: int) -> sp.csr_matrix:
    """Symmetric 0/1 adjacency of ``networkx.barabasi_albert_graph(n, m,
    seed=seed)`` with nodes in order ``0..n-1``.

    Same draws as networkx: a star on ``m + 1`` nodes, a list holding each
    node once per incident edge, and ``m`` distinct targets per new node
    picked with ``random.Random(seed).choice`` until ``m`` are distinct.
    The targets live in a ``set`` and extend the list in set order, as
    networkx does, so later draws see the same list.
    """
    if m < 1 or m >= n:
        raise ValueError(f"Barabasi-Albert needs 1 <= m < n, got m={m}, n={n}")
    rng = random.Random(seed)
    src = [0] * m
    dst = list(range(1, m + 1))
    repeated = [0] * m + list(range(1, m + 1))
    for source in range(m + 1, n):
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        src.extend([source] * m)
        dst.extend(targets)
        repeated.extend(targets)
        repeated.extend([source] * m)
    rows = np.concatenate([src, dst]).astype(np.int64)
    cols = np.concatenate([dst, src]).astype(np.int64)
    adj = sp.coo_matrix(
        (np.ones(rows.size, np.int64), (rows, cols)), shape=(n, n)
    ).tocsr()
    adj.sum_duplicates()
    return adj


def _sample_unique_pairs(
    rng: np.random.RandomState, n: int, size: int
) -> np.ndarray:
    """``size`` unique unordered (a != b) pairs over [0, n), vectorized."""
    size = min(size, n * (n - 1) // 2)
    out = np.empty((0,), dtype=np.int64)
    while out.shape[0] < size:
        need = size - out.shape[0]
        a = rng.randint(0, n, size=2 * need + 16).astype(np.int64)
        b = rng.randint(0, n, size=2 * need + 16).astype(np.int64)
        mask = a != b
        lo = np.minimum(a, b)[mask]
        hi = np.maximum(a, b)[mask]
        out = np.unique(np.concatenate([out, lo * n + hi]))
    out = rng.permutation(out)[:size]
    return np.stack([out // n, out % n], axis=1)


def make_polypharmacy_like_graph(
    n_proteins: int = 2000,
    n_drugs: int = 400,
    n_side_effects: int = 50,
    min_edges_per_relation: int = 64,
    seed: int = 7,
    with_transposes: bool = True,
    drug_decoder: str = "dedicom",
    other_decoder: str = "bilinear",
    total_drugdrug_edges: Optional[int] = None,
    ppi_attachment: int = 5,
    mono_features: bool = False,
    n_mono_side_effects: int = 0,
    planted_rank: int = 0,
    planted_out: Optional[dict] = None,
    planted_noise: float = 0.3,
) -> RelationGraph:
    """A larger random graph shaped like the polypharmacy dataset.

    Used for throughput benchmarking at realistic sizes (BASELINE.json
    configs 2-4) when the public CSVs are unavailable; degree
    distributions are power-law-ish via preferential attachment.

    At paper scale (Zitnik et al. 2018; reference README.md:9-27) pass
    ``n_proteins=19081, n_drugs=645, n_side_effects=963,
    min_edges_per_relation=500, total_drugdrug_edges=4_651_131,
    ppi_attachment=37`` — 963 relations each with >=500 edges (the
    reference's filter at ``DecagonPublicDataAdjacencyMatricesBuilder.py:
    112-125``) and a Pareto-tailed size distribution like the real data.
    """
    rng = np.random.RandomState(seed)

    ppi = Relation.from_scipy(
        barabasi_albert_adjacency(n_proteins, ppi_attachment, seed), name="ppi"
    )

    # protein -> drug targets: each drug hits a handful of proteins
    # (vectorized; duplicates collapsed).
    targets_per_drug = rng.randint(1, 12, size=n_drugs)
    dp_cols = np.repeat(np.arange(n_drugs), targets_per_drug)
    dp_rows = rng.randint(0, n_proteins, size=dp_cols.shape[0])
    dp = np.unique(dp_rows * n_drugs + dp_cols)
    prot_drug = Relation(
        rows=dp // n_drugs, cols=dp % n_drugs,
        shape=(n_proteins, n_drugs), name="protein_drug",
    )

    # Side-effect relation sizes (>= min_edges_per_relation, mirroring the
    # reference's >=500-edge filter).  With total_drugdrug_edges set, a
    # Pareto tail over the floor is rescaled so undirected-pair counts sum
    # to the target (the real data: 4.65M edge instances over 963
    # relations, most near the 500 floor with a heavy tail).
    max_pairs = n_drugs * (n_drugs - 1) // 2
    if total_drugdrug_edges is not None:
        floor = min_edges_per_relation // 2  # pairs (each pair = 2 edges)
        target_pairs = total_drugdrug_edges // 2
        tail = rng.pareto(1.3, size=n_side_effects)
        extra = target_pairs - n_side_effects * floor
        tail = tail / max(tail.sum(), 1e-9) * max(extra, 0)
        sizes = np.minimum(
            (floor + tail).astype(np.int64), max_pairs
        )
    else:
        max_edges = max(
            min_edges_per_relation + 1, (n_drugs * (n_drugs - 1)) // 8
        )
        sizes = np.unique(
            np.round(
                np.exp(
                    rng.uniform(
                        np.log(min_edges_per_relation), np.log(max_edges),
                        size=n_side_effects,
                    )
                )
            ).astype(int)
        )
        sizes = rng.choice(sizes, size=n_side_effects, replace=True)
    # With ``planted_rank`` > 0 the relations carry learnable structure:
    # each side effect's edges are the top-scoring pairs of a planted
    # low-rank bilinear model score(a, b) = (z_a * d_s) . z_b + noise —
    # exactly the DistMult/DEDICOM family the decoders recover, so
    # quality runs measure learning, not noise.  0 = uniform pairs
    # (structure is irrelevant for throughput benchmarks).
    drug_rels = []
    if planted_rank > 0:
        z = rng.randn(n_drugs, planted_rank) / np.sqrt(planted_rank)
        iu, ju = np.triu_indices(n_drugs, k=1)
        if planted_out is not None:
            # Expose the ground-truth factors so quality analyses can
            # score the ORACLE ceiling of this proxy (the best any
            # DistMult-family learner could do on held-out edges).
            planted_out["z"] = z
            planted_out["d"] = []
    for s, size in enumerate(sizes):
        size = int(min(size, max_pairs))
        if planted_rank > 0:
            d = rng.randn(planted_rank)
            if planted_out is not None:
                planted_out["d"].append(d)
            logits = ((z * d) @ z.T)[iu, ju]
            # ``planted_noise`` sets the proxy's ceiling: the oracle
            # (true factors) scores held-out edges at ~0.856 AUROC at
            # the 0.3 default and ~0.93+ at 0.1 (scripts/
            # oracle_ceiling.py sweeps this).
            logits = logits + planted_noise * rng.randn(logits.shape[0])
            top = np.argpartition(-logits, size - 1)[:size]
            upper = np.stack([iu[top], ju[top]], axis=1)
        else:
            upper = _sample_unique_pairs(rng, n_drugs, size)
        rows = np.concatenate([upper[:, 0], upper[:, 1]])
        cols = np.concatenate([upper[:, 1], upper[:, 0]])
        drug_rels.append(
            Relation(rows=rows, cols=cols, shape=(n_drugs, n_drugs), name=f"se_{s}")
        )

    if mono_features and n_mono_side_effects > 0:
        # Binary drug x mono-side-effect matrix like the real
        # bio-decagon-mono.csv features (~10% fill).
        mono = (rng.rand(n_drugs, n_mono_side_effects) < 0.1).astype(
            np.float32
        )
        drug_features = NodeFeatures.from_dense(mono)
    else:
        drug_features = NodeFeatures.identity(n_drugs)
    graph = RelationGraph(
        node_type_names=("protein", "drug"),
        num_nodes=(n_proteins, n_drugs),
        relations={(0, 0): [ppi], (0, 1): [prot_drug], (1, 1): drug_rels},
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
    return graph
