"""Perf probe 2: the dummy step with and without dropout, under the random
generator the card has, at a tile size.

    python -m decagon_tpu_torch.scripts.perf_probe2 [TILE_BLOCK] [rbg] [--device cpu] \\
        [--out PATH]

Port of ``scripts/perf_probe2.py`` on its workload (the dummy graph, split
5% / the 50-edge test floor, seed 1; hidden 64 -> 32, dropout 0.1,
``spmm_impl="pallas"``; the ``Trainer``, seed 0, batch 512, lr 1e-3,
chunks of 50): the full chunked step, and 50 encoder forwards with dropout
(``det=False``) and without (``det=True``), each in ms a step over 5 calls
after a warm-up call with one sync at the end.

Two of the JAX script's arguments have no counterpart, and the record keeps
each with what was measured in its place:

* ``rbg``: JAX's other PRNG.  torch has one generator on CUDA (Philox), so
  ``rng`` records ``philox`` whatever was asked (``rng_requested``).
* ``TILE_BLOCK``: the JAX tiles' capacity.  K6 reads a destination-sorted
  CSR (``ops/tiling.py``), not tiles, and the port's
  ``build_device_graph`` takes no such argument: the value is recorded and
  has no effect.

As in ``perf_probe.py`` the port builds K6's CSR layouts for every edge
type (``tile_even_if_dense``: the JAX package builds none where a dense
stack exists, and its "pallas" raises on this graph), so "pallas" runs K6.
The record adds the card's ``nvidia-smi`` name and power limit, the torch
version and the hand-written kernels' launches a step:
``artifacts/perf/torch_perf_probe2.json`` (``--out``).  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, Optional

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.scripts.perf_probe import GRAPH, MODEL, SPLIT, TRAIN, encoder_fwd, timeit
from decagon_tpu_torch.scripts.records import card_fields, per, write_json
from decagon_tpu_torch.train.step import TrainConfig, make_generator
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_perf_probe2.json")

# The JAX script's configuration.
CHUNK = 50
IMPL = "pallas"
TILE_BLOCK = 256
REPS = 5


def perf_probe2(tile_block: int = TILE_BLOCK, rng: str = "threefry", device=None,
                chunk: int = CHUNK, graph_kw: Optional[Dict] = None, reps: int = REPS,
                log: Callable = print) -> Dict:
    """The record."""
    device = resolve_device(device)
    graph = make_synthetic_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, tile_for_pallas=True, tile_even_if_dense=True,
                            device=device)
    model = DecagonModel(ModelConfig(spmm_impl=IMPL, **MODEL), dg)
    trainer = Trainer(model, graph, splits, dg, TrainConfig(scan_chunk=chunk, **TRAIN), seed=0)
    batches = list(trainer.scheduler.epoch())
    while len(batches) < chunk:
        batches += list(trainer.scheduler.epoch())
    batches = batches[:chunk]
    tag = f"[{IMPL} tb={tile_block} {rng}]"

    def full():
        trainer.train_chunk(batches, chunk)
        return trainer.params

    rec = dict(impl=IMPL, tile_block=tile_block, rng_requested=rng, rng="philox",
               notes=dict(rng="torch has one generator on CUDA (Philox); JAX's threefry and "
                              "rbg have no counterpart, so every line draws from Philox",
                          tile_block="K6 reads a destination-sorted CSR (ops/tiling.py), not "
                                     "tiles: the value is recorded and has no effect",
                          tiles="K6's CSR layouts on every edge type (tile_even_if_dense)"),
               config=dict(graph=graph_kw or GRAPH, split=SPLIT, model=MODEL, train=TRAIN,
                           chunk=chunk, reps=reps),
               **card_fields(device))
    seconds, launches = timeit(full, reps)
    rec.update(full_chunked_step_ms=seconds / chunk * 1e3,
               full_chunked_step_launches_per_step=per(launches, chunk))
    log(f"{tag} full chunked step: {rec['full_chunked_step_ms']:.3f} ms/step")
    params = trainer.params
    gen = make_generator(0, device)
    for det in (False, True):
        seconds, launches = timeit(
            lambda: encoder_fwd(model, dg, params, chunk, None if det else gen), reps)
        rec[f"encoder_fwd_det_{det}_ms"] = seconds / chunk * 1e3
        rec[f"encoder_fwd_det_{det}_launches_per_step"] = per(launches, chunk)
        log(f"{tag} encoder fwd det={det}: {rec[f'encoder_fwd_det_{det}_ms']:.3f} ms/step")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tile_block", nargs="?", type=int, default=TILE_BLOCK)
    ap.add_argument("rng", nargs="?", default="threefry", choices=["threefry", "rbg"])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rec = perf_probe2(args.tile_block, args.rng, args.device, log=lambda m: print(m, flush=True))
    write_json(args.out, rec)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
