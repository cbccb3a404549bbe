"""Two-rank multi-host simulation: one sharded train step and the sharded
embedding with the ``row`` axis across processes.

    python -m decagon_tpu_torch.scripts.multihost_sim [--ranks 2] [--device cpu]

Port of ``scripts/multihost_sim.py``: each rank is a host of its own
(``LOCAL_WORLD_SIZE=1``), gloo over localhost, and the global (n, 1) mesh
lays the ``row`` axis across them, so the destination-row-block all-gather
crosses processes as it would cross hosts.  On the synthetic graph (64
genes, 32 drugs, 1 drug-drug type, seed 1; split 10% / 5%, seed 2; edges
padded to 256), hidden 16 -> 8 (dropout 0.1), weights from seed 0, each rank
takes one sharded step of batch 16 (lr 1e-3) on relation (1, 1, 0), rows
from numpy seed 0, and the deterministic sharded embedding, held to the
single process's ``model.embeddings`` at rtol 2e-5, atol 1e-6.  Each rank
prints ``MULTIHOST_OK pid=... loss=...``; the summed loss is the same on
every rank.  On the card every rank sits on ``cuda:0`` (NCCL cannot place
two ranks on one card) and the step's Adam is one K7 launch.  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import worlds
from decagon_tpu_torch.scripts.records import launched

MODULE = "decagon_tpu_torch.scripts.multihost_sim"

# The JAX script's configuration.
GRAPH = dict(n_genes=64, n_drugs=32, n_drugdrug_types=1, seed=1)
SPLIT = dict(val_frac=0.1, test_frac=0.05, seed=2)
DEVICE_GRAPH = dict(edge_pad_multiple=256)
MODEL = dict(hidden1=16, hidden2=8)
TRAIN = dict(batch_size=16, learning_rate=1e-3)
RTOL, ATOL = 2e-5, 1e-6


def simulate(rank: int, n_ranks: int, device, params=None) -> Dict:
    """In a process group of ``n_ranks`` (this rank ``rank``): one sharded
    step and the sharded embedding on the (n_ranks, 1) mesh, from
    ``params`` (by default the weights of seed 0).  Returns the summed
    loss, both embeddings (numpy), their largest difference and the
    kernels' launches of the step."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.parallel.mesh import make_mesh, mesh_slot
    from decagon_tpu_torch.parallel.rowshard import build_sharded_device_graph
    from decagon_tpu_torch.parallel.sharded import make_sharded_embed_fn, make_sharded_train_step
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, step_generator

    graph = make_synthetic_graph(**GRAPH)
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    model = DecagonModel(ModelConfig(**MODEL), dg)
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0), dg)

    # row axis across processes (the cross-host axis), edge axis within.
    mesh = make_mesh(shape=(n_ranks, 1), multihost=True, backend="gloo")
    sg = build_sharded_device_graph(graph, splits, (n_ranks, 1), mesh_slot(mesh), device=device)
    cfg = TrainConfig(**TRAIN)
    opt = make_optimizer(cfg)
    step = make_sharded_train_step(model, (1, 1), cfg, opt, mesh, sg)
    train = splits[(1, 1, 0)].train
    idx = np.random.default_rng(0).integers(0, len(train), size=cfg.batch_size)
    rows, cols = (torch.from_numpy(train[idx, c]).to(device) for c in (0, 1))
    cuda_build.reset_launches()
    _, _, loss = step(params, opt.init(params), sg, 0, rows, cols, step_generator(0, 0, device))
    loss = float(loss)
    launches = launched()
    emb = make_sharded_embed_fn(model, mesh, sg)(params, sg)
    with torch.no_grad():
        want = model.embeddings(params, dg)
    emb = {k: v.cpu().numpy() for k, v in emb.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    err = max(float(np.abs(emb[k] - want[k]).max()) for k in want)
    return {"pid": rank, "loss": loss, "emb": emb, "single_emb": want, "emb_max_abs_err": err,
            "launches": launches}


def rank_main(rank: int, n_ranks: int, port: int, device: str = "cuda") -> Dict:
    """One rank: ``simulate``, the embeddings held to the single process's,
    ``MULTIHOST_OK`` printed; the JSON fields of the result."""
    torch.set_num_threads(1)
    dev = worlds.rank_device(device)
    created = worlds.join_group(rank, n_ranks, port)
    try:
        res = simulate(rank, n_ranks, dev)
    finally:
        worlds.leave_group(created)
    if not np.isfinite(res["loss"]):
        raise AssertionError(f"rank {rank}: loss {res['loss']}")
    for key, want in res["single_emb"].items():
        np.testing.assert_allclose(res["emb"][key], want, rtol=RTOL, atol=ATOL)
    line = f"MULTIHOST_OK pid={rank} loss={res['loss']:.5f}"
    print(line, flush=True)
    return {"pid": rank, "loss": res["loss"], "emb_max_abs_err": res["emb_max_abs_err"],
            "launches": res["launches"], "line": line}


def main(argv=None) -> Dict[int, Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if worlds.rank_device(args.device).type == "cuda":
        cuda_build.library()  # built once, before the ranks load it
    results = worlds.run_world(MODULE, args.ranks, dict(device=args.device),
                               env={"LOCAL_WORLD_SIZE": "1"})
    worlds.agree(results, "loss")
    for rank in sorted(results):
        print(results[rank]["line"])
    print(json.dumps({r: {k: v for k, v in res.items() if k != "line"}
                      for r, res in results.items()}))
    return results


if __name__ == "__main__":
    if worlds.is_worker(sys.argv[1:]):
        worlds.worker(rank_main, sys.argv[2])
    else:
        main()
