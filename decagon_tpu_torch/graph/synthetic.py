"""Deterministic synthetic graphs: the reference's dummy config and graphs
shaped like the polypharmacy dataset.

Port of ``decagon_tpu/graph/synthetic.py::make_synthetic_graph`` and
``make_polypharmacy_like_graph``.  The JAX package builds their gene
networks with ``networkx.planted_partition_graph`` and
``networkx.barabasi_albert_graph``; networkx is not a dependency of the
port, so ``planted_partition_adjacency`` and ``barabasi_albert_adjacency``
replay the same algorithms with the standard library and return the same
adjacencies, edge for edge (``tests/test_torch_graph.py`` holds them
against networkx).
"""

from __future__ import annotations

import itertools
import math
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


def planted_partition_adjacency(
    l: int, k: int, p_in: float, p_out: float, seed: int
) -> sp.csr_matrix:
    """0/1 adjacency of ``networkx.planted_partition_graph(l, k, p_in,
    p_out, seed=seed)``, rows in the graph's node order (what
    ``networkx.adjacency_matrix`` returns).

    networkx runs ``stochastic_block_model(sparse=True)`` over ``l`` blocks
    of ``k`` nodes with ``random.Random(seed)``, and so does this: blocks
    are Python sets of consecutive labels (their iteration order is the
    graph's node order and the order of the candidate pairs); block pairs
    come in ``combinations_with_replacement`` order; a diagonal block draws
    one uniform per pair, then, because the ``sparse`` branch runs after
    it on the spent iterator, one more uniform that selects nothing; an
    off-diagonal block skips ``floor(log(u) / log(1 - p))`` pairs of its
    ``product`` between edges.
    """
    for name, p in (("p_in", p_in), ("p_out", p_out)):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"{name} must be in [0, 1], got {p}")
    rng = random.Random(seed)
    nodes = range(l * k)
    parts = [set(nodes[b * k:(b + 1) * k]) for b in range(l)]
    order = [node for part in parts for node in part]
    position = {node: i for i, node in enumerate(order)}
    src, dst = [], []
    for i, j in itertools.combinations_with_replacement(range(l), 2):
        p = p_in if i == j else p_out
        if i == j:
            pairs = itertools.combinations(parts[i], 2)
            for a, b in pairs:
                if rng.random() < p:
                    src.append(a)
                    dst.append(b)
        else:
            pairs = itertools.product(parts[i], parts[j])
        if p == 1:
            for a, b in pairs:
                src.append(a)
                dst.append(b)
        elif p > 0:
            log_q = math.log(1 - p)
            while True:
                skip = math.floor(math.log(rng.random()) / log_q)
                next(itertools.islice(pairs, skip, skip), None)
                edge = next(pairs, None)
                if edge is None:
                    break
                src.append(edge[0])
                dst.append(edge[1])
    n = l * k
    rows = np.array([position[a] for a in src + dst], dtype=np.int64)
    cols = np.array([position[b] for b in dst + src], dtype=np.int64)
    adj = sp.coo_matrix(
        (np.ones(rows.size, np.int64), (rows, cols)), shape=(n, n)
    ).tocsr()
    adj.sum_duplicates()
    return adj


def make_synthetic_graph(
    n_genes: int = 500,
    n_drugs: int = 400,
    n_drugdrug_types: int = 3,
    seed: int = 0,
    partition_seed: int = 42,
    with_transposes: bool = True,
    drug_decoder: str = "dedicom",
    other_decoder: str = "bilinear",
) -> RelationGraph:
    """The reference's toy data (legacy ``main.py:134-218``): a planted-
    partition gene network (``n_genes // 10`` groups of 10, p_in 0.2,
    p_out 0.05), gene-drug targets ``10 * randn > 15``, and drug-drug
    relation ``i`` where two drugs share exactly ``i + 4`` targets (thin
    relations topped up with seeded random pairs).  Identity features;
    DEDICOM on drug-drug, bilinear elsewhere."""
    rng = np.random.RandomState(seed)

    gene_adj = planted_partition_adjacency(
        max(1, n_genes // 10), 10, 0.2, 0.05, seed=partition_seed
    )
    n_genes = gene_adj.shape[0]
    ppi = Relation.from_scipy(gene_adj, name="ppi")

    gene_drug_dense = (10 * rng.randn(n_genes, n_drugs) > 15).astype(np.int8)
    gene_drug = Relation.from_dense(gene_drug_dense, name="gene_drug")

    overlap = gene_drug_dense.astype(np.int64).T @ gene_drug_dense.astype(np.int64)
    drug_rels = []
    min_edges = max(8, 4 * (n_drugs // 10))
    for i in range(n_drugdrug_types):
        hits = (overlap == i + 4)
        np.fill_diagonal(hits, False)
        sym = hits | hits.T
        while int(sym.sum()) < 2 * min_edges:
            a, b = rng.randint(0, n_drugs, size=2)
            if a != b:
                sym[a, b] = sym[b, a] = True
        drug_rels.append(Relation.from_dense(sym, name=f"dd_{i}"))

    relations = {
        (0, 0): [ppi],
        (0, 1): [gene_drug],
        (1, 1): drug_rels,
    }
    graph = RelationGraph(
        node_type_names=("gene", "drug"),
        num_nodes=(n_genes, n_drugs),
        relations=relations,
        features={
            0: NodeFeatures.identity(n_genes),
            1: NodeFeatures.identity(n_drugs),
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
