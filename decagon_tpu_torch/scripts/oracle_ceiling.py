"""Oracle ceiling of the paper-scale synthetic quality proxy.

    python -m decagon_tpu_torch.scripts.oracle_ceiling [NOISE ...] [--out PATH]

Port of ``scripts/oracle_ceiling.py``, number for number.  The planted graph
draws each side effect's edges as the top drug pairs of a low-rank bilinear
score ``(z_a * d_s) . z_b`` plus noise (``graph/synthetic.py``), so scoring
the held-out edges with the TRUE factors bounds what any learner of the
DistMult/DEDICOM family can reach on them.  For each planted noise (0.3,
0.15 and 0.1 by default): the paper-scale planted graph (19,081 proteins,
645 drugs, 963 side effects of >= 500 edges, 4,651,131 drug-drug edges,
``ppi_attachment=37``, seed 7, ``planted_rank=16``), split 5% / 5% on split
seed 8 (the converged run's), and the pooled drug-drug validation and test
edges, positives and sampled negatives, scored with the planted factors
(a transpose relation with its partner's).

Pure numpy on the host: it takes no device.  AUROC and AUPRC come from
``train/evaluate.fast_auroc`` and ``fast_average_precision``, which equal
sklearn's ``roc_auc_score`` and ``average_precision_score`` (the JAX
script's) to float precision.  Writes
``artifacts/quality/torch_oracle_ceiling.json`` (``--out``; never the JAX
run's ``oracle_ceiling.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.train.evaluate import fast_auroc, fast_average_precision

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "quality", "torch_oracle_ceiling.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7, planted_rank=16)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=8)
NOISES = [0.3, 0.15, 0.1]
NOTE = (
    "scores held-out edges with the TRUE planted (z, d) factors on "
    "the converged run's exact split (seed 8); the planted selection "
    "noise and the negative-sampling scheme set the ceiling below "
    "1.0 — it bounds any learner in the decoder family.  At the 0.3 "
    "default the BASELINE 0.87 target is unreachable by "
    "construction; the reduced-noise proxy (ceiling >= 0.9) is the "
    "config that honestly supports it"
)


def ceiling_for(noise: float, graph_kw: Optional[Dict] = None) -> Dict:
    """The oracle's pooled validation and test AUROC, AUPRC (5 decimals)
    and scored edges at planted noise ``noise``."""
    planted = {}
    graph = make_polypharmacy_like_graph(**(graph_kw or GRAPH), planted_out=planted,
                                         planted_noise=noise)
    splits = split_graph(graph, **SPLIT)
    z, ds = planted["z"], planted["d"]
    n_planted = len(ds)
    out = {}
    for tag, pos_attr, neg_attr in (("val", "val", "val_false"),
                                    ("test", "test", "test_false")):
        scores, labels = [], []
        for key, split in splits.items():
            if key[:2] != (1, 1):
                continue
            # Transposes (k >= n_planted) share their partner's factors;
            # the planted score is symmetric, so the orientation is moot.
            d = ds[key[2] % n_planted]
            for edges, label in ((getattr(split, pos_attr), 1.0),
                                 (getattr(split, neg_attr), 0.0)):
                if edges.size == 0:
                    continue
                s = np.einsum("er,er->e", z[edges[:, 0]] * d[None, :], z[edges[:, 1]])
                scores.append(s)
                labels.append(np.full(len(s), label))
        scores = np.concatenate(scores)
        labels = np.concatenate(labels)
        out[tag] = {
            "oracle_auroc": round(fast_auroc(labels, scores), 5),
            "oracle_auprc": round(fast_average_precision(labels, scores), 5),
            "n_scored": int(len(scores)),
        }
        print(tag, out[tag], flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("noises", nargs="*", type=float, help=f"default {NOISES}")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = {f"noise_{n}": ceiling_for(n) for n in (args.noises or NOISES)}
    out["note"] = NOTE
    out["host"] = dict(numpy=np.__version__, seconds=time.perf_counter() - t0,
                       scorer="train/evaluate.fast_auroc, fast_average_precision")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
