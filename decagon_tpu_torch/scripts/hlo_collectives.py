"""Inventory of the collectives a sharded train step issues, against the
scaling model's formulas.

    python -m decagon_tpu_torch.scripts.hlo_collectives [--device cpu] [--out PATH]

Port of ``scripts/hlo_collectives.py``.  The JAX script walks XLA's
compiled program for the collectives the partitioner emits; the port has
no compiled program, so it counts the collectives where the port issues
them: every call of ``parallel/collectives.py``'s all-reduce, all-gather
and reduce-scatter inside one weight-sharded step (``collectives.inventory``;
the gradient reduction, ``sharded.reduce_gradients``, labels its own).  On
poly50 (2,000 proteins, 400 drugs, 50 side effects, ``planted_rank=16``;
split seed 8), hidden 64 -> 32, dropout 0.1, batch 512, one step on each of
the meshes (1, 8), (2, 4) and (4, 2), each a world of 8 gloo ranks (on the
card all on ``cuda:0``; the counts do not depend on the device).

For each mesh: ``hlo_collectives`` (the JAX key): count and result-tensor
bytes by kind, over groups of more than one rank (the calls over one-rank
groups move nothing and are counted apart, ``one_rank_group_calls``);
``hlo_total_tensor_mib``: their total; ``counted_wire_mib``: the per-device
ring wire bytes of each term (an all-reduce of b bytes over n ranks sends
2b(n-1)/n, an all-gather of a b-byte result b(n-1)/n, a reduce-scatter to a
b-byte block b(n-1)), the terms being the activations' ``edge`` sums
(forward, and the backward's sum of the scattered block), the ``row``
gathers and their reduce-scatters, the relation-sharded gradients over
``row`` and the replicated ones (and the loss) over the mesh; and
``model_wire_prediction``: the JAX script's ``model_prediction`` (the
scaling model's formulas) at poly50, with the gap of each term.  Both
packages sum and gather each edge type's table apart (its rows are
normalized on their own), where the formulas count one table a node type,
and the port's forward exchanges every layer-2 table, also those the loss
does not read (their backward is skipped): ``model_wire_prediction_per_
edge_type`` applies the same formulas to exactly those tables
(``per_edge_type_prediction``), and the activation terms must equal it.  Writes
``artifacts/perf/torch_hlo_collectives.json`` (``--out``).  Runs its ranks
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import multihost_bench as mb
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import card_fields, launched, write_json
from decagon_tpu_torch.scripts.scaling_model import (
    ring_allgather_bytes as ring_allgather_wire,
    ring_allreduce_bytes as ring_allreduce_wire,
)

MODULE = "decagon_tpu_torch.scripts.hlo_collectives"
OUT = os.path.join(worlds.ROOT, "artifacts", "perf", "torch_hlo_collectives.json")
MESHES = [(1, 8), (2, 4), (4, 2)]
TERMS = ("act_edge_mib", "act_row_mib", "grad_row_mib", "grad_mesh_mib")
NOTE = (
    "The port issues its collectives from parallel/collectives.py, one call each, so the "
    "inventory counts calls, not compiled HLO ops. By design: (1) both packages sum over edge "
    "and gather over row each EDGE TYPE's [nb, H] table apart (its rows are L2-normalized on "
    "their own), while the scaling model counts one table per NODE TYPE (2 edge types into "
    "each node type here: twice the tables); (2) the port's forward computes and exchanges "
    "every layer-2 table, also those into node types the step's loss does not read (the "
    "proteins', for a drug-drug step), and only their backward is skipped, where XLA drops "
    "them from the JAX program; model_wire_prediction_per_edge_type counts exactly these "
    "tables, and the activation terms must equal it; (3) grad_mesh also carries the loss and "
    "every replicated small leaf in one flat buffer (sharded._reduce_flat); (4) grad_row "
    "reduces the relation blocks padded to ne * k_loc relations.")


# ---- the scaling model's formulas, at poly50 shapes (the JAX script's) ------


def model_prediction(nr, ne, n_prot, n_drug, h1, h2, enc_param_bytes, dec_param_bytes) -> dict:
    act_edge = act_row = 0.0
    for h in (h1, h2):
        for n_nodes in (n_prot, n_drug):
            nb = -(-n_nodes // nr)
            blk = nb * h * 4
            act_edge += ring_allreduce_wire(blk, ne)
            act_row += ring_allgather_wire(blk, nr)
    # fwd + mirrored bwd (gather_rows backward = row reduce-scatter + edge
    # sum of the scattered block: the forward's wire volume).
    act_edge *= 2
    act_row *= 2
    grad_row = ring_allreduce_wire(enc_param_bytes / ne, nr)
    grad_mesh = ring_allreduce_wire(dec_param_bytes, nr * ne)
    return {
        "act_edge_mib": round(act_edge / 2**20, 3),
        "act_row_mib": round(act_row / 2**20, 3),
        "grad_row_mib": round(grad_row / 2**20, 3),
        "grad_mesh_mib": round(grad_mesh / 2**20, 3),
        "total_mib": round((act_edge + act_row + grad_row + grad_mesh) / 2**20, 3),
    }


def per_edge_type_prediction(nr, ne, num_nodes, edge_types, hidden, scored, enc_param_bytes,
                             dec_param_bytes) -> dict:
    """The same formulas on the tables the step exchanges: forward, every
    edge type's ``[nb, H]`` table of both layers; backward, the tables the
    loss reaches (every layer-1 table here; of layer 2 those into the scored
    edge type's node types)."""
    act_edge = act_row = 0.0
    for layer, h in enumerate(hidden):
        for i, _ in edge_types:
            blk = -(-num_nodes[i] // nr) * h * 4
            passes = 2 if layer == 0 or i in scored else 1
            act_edge += passes * ring_allreduce_wire(blk, ne)
            act_row += passes * ring_allgather_wire(blk, nr)
    grad_row = ring_allreduce_wire(enc_param_bytes / ne, nr)
    grad_mesh = ring_allreduce_wire(dec_param_bytes, nr * ne)
    out = {"act_edge_mib": act_edge, "act_row_mib": act_row, "grad_row_mib": grad_row,
           "grad_mesh_mib": grad_mesh}
    out["total_mib"] = sum(out.values())
    return {k: round(v / 2**20, 3) for k, v in out.items()}


# ---- the inventory -----------------------------------------------------------

def wire_bytes(call: Dict) -> float:
    n, b = call["ranks"], call["bytes"]
    if call["kind"] == "all-reduce":
        return ring_allreduce_wire(b, n)
    if call["kind"] == "all-gather":
        return ring_allgather_wire(b / n, n)
    return b * (n - 1)  # reduce-scatter to a b-byte block


def term(call: Dict) -> str:
    """The model's term a call's traffic belongs to."""
    if call["site"] == "gradients":
        return "grad_row_mib" if call["group"] == "row" else "grad_mesh_mib"
    return "act_edge_mib" if call["group"] == "edge" else "act_row_mib"


def summarize(calls: List[Dict]) -> Dict:
    """The inventory by kind, the total and the wire bytes by term."""
    moving = [c for c in calls if c["ranks"] > 1]
    kinds: Dict[str, Dict[str, int]] = {}
    for c in moving:
        k = kinds.setdefault(c["kind"], {"count": 0, "tensor_bytes": 0})
        k["count"] += 1
        k["tensor_bytes"] += c["bytes"]
    wire = {t: 0.0 for t in TERMS}
    for c in moving:
        wire[term(c)] += wire_bytes(c)
    counted = {t: round(v / 2**20, 3) for t, v in wire.items()}
    counted["total_mib"] = round(sum(wire.values()) / 2**20, 3)
    return {
        "hlo_collectives": kinds,
        "hlo_total_tensor_mib": round(sum(c["bytes"] for c in moving) / 2**20, 3),
        "one_rank_group_calls": len(calls) - len(moving),
        "counted_wire_mib": counted,
    }


def rank_main(rank: int, n_ranks: int, port: int, nr: int, ne: int, device: str = "cuda",
              graph_kw: Optional[Dict] = None, model_kw: Optional[Dict] = None,
              batch_size: int = mb.TRAIN["batch_size"], threads: int = 1) -> Dict:
    """One rank: one weight-sharded step under ``collectives.inventory``;
    the calls (groups named "row", "edge" or "world"), the parameter bytes
    the model takes and the kernels' launches of the step."""
    from decagon_tpu_torch.parallel import collectives
    from decagon_tpu_torch.parallel.mesh import make_mesh, mesh_groups
    from decagon_tpu_torch.train.step import TrainConfig

    torch.set_num_threads(threads)
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port)
    try:
        graph, splits = mb.world(graph_kw)
        cfg = TrainConfig(**dict(mb.TRAIN, batch_size=batch_size))
        mesh = make_mesh(shape=(nr, ne), backend="gloo")
        sg, model, params, local, state, step = mb.mesh_setup(
            graph, splits, mesh, (nr, ne), dev, dict(mb.MODEL, **(model_kw or {})), cfg)
        b = mb.batches(splits, 1, batch_size)[0]
        rows, cols = (torch.from_numpy(b[:, c]).to(dev) for c in (0, 1))
        from decagon_tpu_torch.train.step import step_generator

        cuda_build.reset_launches()
        with collectives.inventory() as calls:
            _, _, loss = step(local, state, sg, mb.K, rows, cols, step_generator(0, 0, dev))
            float(loss)
        launches = launched()
        row_g, edge_g = mesh_groups(mesh)
        names = {id(row_g): "row", id(edge_g): "edge", id(None): "world"}
        calls = [dict(c, group=names[id(c["group"])]) for c in calls]
        enc_b = sum(int(np.prod(params[lvl][k].shape)) * 4
                    for lvl in ("enc1", "enc2") for k in params[lvl])
        dec_b = sum(int(np.prod(leaf.shape)) * 4
                    for et in params["dec"].values() for leaf in et.values())
        return {"pid": rank, "calls": calls, "enc_param_bytes": enc_b, "dec_param_bytes": dec_b,
                "launches": launches, "num_nodes": list(graph.num_nodes),
                "edge_types": [list(et) for et in sg.edge_types],
                "hidden": [model.config.hidden1, model.config.hidden2]}
    finally:
        worlds.leave_group(created)


def mesh_entry(nr: int, ne: int, results: Dict[int, Dict]) -> Dict:
    """A mesh's record entry from its ranks' results (every rank must issue
    the same collectives)."""
    r0 = results[0]
    for r, res in results.items():
        if [(c["kind"], c["group"], c["bytes"]) for c in res["calls"]] != \
                [(c["kind"], c["group"], c["bytes"]) for c in r0["calls"]]:
            raise AssertionError(f"rank {r} issued other collectives than rank 0")
    entry = summarize(r0["calls"])
    (n_prot, n_drug), (h1, h2) = r0["num_nodes"], r0["hidden"]
    entry["model_wire_prediction"] = model_prediction(
        nr, ne, n_prot, n_drug, h1, h2, r0["enc_param_bytes"], r0["dec_param_bytes"])
    entry["model_wire_prediction_per_edge_type"] = per_edge_type_prediction(
        nr, ne, r0["num_nodes"], r0["edge_types"], r0["hidden"], mb.EDGE_TYPE,
        r0["enc_param_bytes"], r0["dec_param_bytes"])
    entry["gap_mib"] = {t: round(entry["counted_wire_mib"][t] - entry["model_wire_prediction"][t],
                                 3) for t in TERMS + ("total_mib",)}
    entry["adam_launches_per_step"] = [results[r]["launches"].get("adam", 0)
                                       for r in sorted(results)]
    return entry


def hlo_collectives(device: str = "cuda", meshes=MESHES, log: Callable = print, **kw) -> Dict:
    """The record; ``kw`` (``graph_kw``, ``model_kw``, ``batch_size``) cuts
    the workload for tests."""
    dev = worlds.rank_device(device)
    if dev.type == "cuda":
        cuda_build.library()  # built once, before the ranks load it
    out = {"workload": "poly50 (2000 prot / 400 drug / 50 rel x2)", "note": NOTE,
           **card_fields(dev), "meshes": {}}
    for nr, ne in meshes:
        results = worlds.run_world(MODULE, nr * ne, dict(nr=nr, ne=ne, device=device, **kw))
        key = f"{nr}x{ne}"
        out["meshes"][key] = mesh_entry(nr, ne, results)
        log(f"[{key}] {json.dumps(out['meshes'][key])}")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = hlo_collectives(args.device)
    write_json(args.out, out)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
