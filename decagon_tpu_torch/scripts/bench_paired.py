"""Paper-scale A/B: the paired half-mask step against the int8 factored
step, with the masks' size and per-edge-type kernel timings.

    python -m decagon_tpu_torch.scripts.bench_paired [--device cpu] [--out PATH]

Port of ``scripts/bench_paired.py``: the paper graph (19,081 proteins, 645
drugs, 963 side effects of >= 500 edges, 4,651,131 drug-drug edges,
``ppi_attachment=37``, seed 7), split 5% / 5% (seed 1), device graphs with
the dense cap at 10^9 cells (bf16), no fused stream; then

1. each square edge type's half mask: built, shape, GiB (``pair_{key}``);
2. a per-edge-type micro-benchmark at H = 64 (``ub_{key}``, (1,1) then
   (0,0)): the paired forward (``ops/spmm_paired.spmm_paired``, K1/K2 on the
   card) and forward + backward (K3/K4) against the factored ones
   (``ops/segment.spmm_dense_factored``, plain PyTorch), the two operand
   layouts (paired ``[2, K/2, H, N]``, stacked ``[2K, N, H]``) cut from one
   seeded array as the JAX script's ``p_t`` / ``p_s``, with the forward's
   largest error relative to the factored one's largest output as a sanity
   check before timing (2 warm-up calls, then 10 calls and one sync);
3. the ``Trainer`` A/B, ``dense_factored`` against ``paired``, batch 512,
   chunks of 20: two warm-up chunks, then 5 timed ones (min and median ms a
   step, the last warm-up chunk's last 3 losses).

One divergence: the JAX script builds ONE device graph with both mask forms
(``dense_factored=True, dense_paired=True``); the port builds no factored
masks for a paired edge type (``graph/device.py``), so it builds two from
the same host graph and split: the paired one (``dense_paired`` and
``dense_factored``: half masks on the square types, factored masks on the
rectangular ones, as the JAX graph gives the paired step) and a factored
one (``dense_factored`` only), both kept on the card for the A/B.

The JAX script's ``nnz`` is hard-coded (12,179,510); the record gives the
graph's own count (``nnz``), the hard-coded one (``nnz_jax_script``), and
``paired_edges_per_s`` from the former.  Besides the JAX fields the record
names the card (``nvidia-smi`` name and power limit), the torch version,
the factored graph's mask GiB, peak memory and each timed run's kernel
launches (per call or per step).  Writes
``artifacts/perf/torch_paired_bench.json`` (``--out``).  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.bench import graph_nnz
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops.segment import spmm_dense_factored
from decagon_tpu_torch.ops.spmm_paired import spmm_paired
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, peak_gib, per, reset_peak
from decagon_tpu_torch.scripts.records import write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_paired_bench.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
H = 64
CHUNK, WINDOWS = 20, 5
NNZ_JAX_SCRIPT = 12179510
KEYS = ("1,1", "0,0")


def device_graphs(graph, splits, device):
    """(paired graph, factored graph): the two forms the JAX script's one
    graph holds."""
    paired = build_device_graph(graph, splits, dense_factored=True, dense_paired=True,
                                device=device, **DEVICE_GRAPH)
    factored = build_device_graph(graph, splits, dense_factored=True, device=device,
                                  **DEVICE_GRAPH)
    return paired, factored


def operands(k: int, n: int, h: int, seed: int, device):
    """(p_t [2, K, H, N], p_s [2K, N, H], ct [N, H]): the paired and the
    stacked layout of one seeded array, and a seeded cotangent."""
    rng = np.random.default_rng(seed)
    p_t = torch.from_numpy(rng.standard_normal((2, k, h, n)).astype(np.float32)).to(device)
    p_s = p_t.reshape(2 * k, h, n).transpose(1, 2).contiguous()
    ct = torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(device)
    return p_t, p_s, ct


def fwd_pair(p_t, adj, impl: str = "paired"):
    return spmm_paired(p_t, adj, impl=impl)


def fwd_fact(p_s, fadj):
    return spmm_dense_factored(p_s, fadj.dense_mask, fadj.dense_mask_t, fadj.row_scale,
                               fadj.col_scale)


def _grad(fn: Callable, q, ct):
    q = q.detach().requires_grad_(True)
    (d,) = torch.autograd.grad(torch.sum(fn(q) * ct), q)
    return d


def fwdbwd_pair(p_t, ct, adj, impl: str = "paired"):
    return _grad(lambda q: fwd_pair(q, adj, impl), p_t, ct)


def fwdbwd_fact(p_s, ct, fadj):
    return _grad(lambda q: fwd_fact(q, fadj), p_s, ct)


def rel_err(got, want) -> float:
    """The largest error relative to the largest output."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def timeit(fn: Callable, *args, reps: int = 10):
    """ms a call: two warm-up calls, then ``reps`` calls and one sync;
    and the kernels' launches a timed call."""
    with torch.no_grad() if fn in (fwd_pair, fwd_fact) else torch.enable_grad():
        hard_sync(fn(*args))
        hard_sync(fn(*args))
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            o = fn(*args)
        hard_sync(o)
        ms = (time.perf_counter() - t0) / reps * 1e3
    return ms, per(launched(), reps)


def microbench(adj, fadj, seed: int, device, h: int = H, reps: int = 10) -> Dict:
    """One square edge type's ``ub_{key}`` line."""
    k = adj.num_rel // 2
    p_t, p_s, ct = operands(k, adj.n_rows, h, seed, device)
    with torch.no_grad():
        err = rel_err(fwd_pair(p_t, adj), fwd_fact(p_s, fadj))
    out, launches = {}, {}
    for name, fn, args in (("fwd_pair", fwd_pair, (p_t, adj)), ("fwd_fact", fwd_fact, (p_s, fadj)),
                           ("fwdbwd_pair", fwdbwd_pair, (p_t, ct, adj)),
                           ("fwdbwd_fact", fwdbwd_fact, (p_s, ct, fadj))):
        out[f"{name}_ms"], launches[name] = timeit(fn, *args, reps=reps)
    out["fwd_max_rel_err"] = err
    out["launches_per_call"] = launches
    return out


def timed_chunks(trainer, batches, chunk: int, windows: int = WINDOWS) -> Dict:
    times = []
    cuda_build.reset_launches()
    for _ in range(windows):
        t0 = time.perf_counter()
        losses = trainer.train_chunk(batches[:chunk], chunk)
        hard_sync(losses)
        times.append((time.perf_counter() - t0) / chunk * 1e3)
    return {"min_ms": min(times), "median_ms": sorted(times)[len(times) // 2],
            "launches_per_step": per(launched(), windows * chunk)}


def step_ab(graph, splits, dg_paired, dg_factored, device, chunk: int = CHUNK,
            windows: int = WINDOWS) -> Dict:
    """The ``Trainer`` A/B: each implementation on its graph."""
    cfg = TrainConfig(batch_size=512, scan_chunk=chunk)
    results = {}
    for impl, dg in (("dense_factored", dg_factored), ("paired", dg_paired)):
        model = DecagonModel(ModelConfig(spmm_impl=impl), dg)
        trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
        batches = []
        while len(batches) < 2 * chunk:
            for b in trainer.scheduler.epoch():
                batches.append(b)
                if len(batches) >= 2 * chunk:
                    break
        reset_peak(device)
        losses = trainer.train_chunk(batches[:chunk], chunk)
        hard_sync(losses)
        losses = trainer.train_chunk(batches[chunk:2 * chunk], chunk)
        hard_sync(losses)
        t = timed_chunks(trainer, batches, chunk, windows)
        results[impl] = {
            "ms_per_step_min": t["min_ms"],
            "ms_per_step_median": t["median_ms"],
            "loss_tail": [float(x) for x in losses.cpu()[-3:]],
            "launches_per_step": t["launches_per_step"],
            "peak_gib": peak_gib(device),
        }
        print(impl, json.dumps(results[impl]), flush=True)
        del trainer
    return results


def mask_line(adj) -> Dict:
    m = adj.pair_mask
    return {"built": m is not None, "mask_shape": list(m.shape) if m is not None else None,
            "mask_gb": m.numel() / 2**30 if m is not None else None}


def bench_paired(device=None, graph_kw: Optional[Dict] = None, chunk: int = CHUNK,
                 windows: int = WINDOWS, reps: int = 10) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    graph = make_polypharmacy_like_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    dg, dg_f = device_graphs(graph, splits, device)
    hard_sync([dg.neg_cdf, dg_f.neg_cdf])
    print(f"graphs built {time.perf_counter() - t0:.0f}s", flush=True)
    out: Dict = {f"pair_{key}": mask_line(dg.adj[key]) for key in ("0,0", "1,1")}
    out["factored_mask_gb"] = sum(
        (a.dense_mask.numel() + a.dense_mask_t.numel()) for a in dg_f.adj.values()
        if a.dense_mask is not None) / 2**30
    print(json.dumps(out), flush=True)
    for key in KEYS:
        if dg.adj[key].pair_mask is None:
            continue
        out[f"ub_{key}"] = microbench(dg.adj[key], dg_f.adj[key], 0, device, reps=reps)
        print(key, json.dumps(out[f"ub_{key}"]), flush=True)
    out["step"] = step_ab(graph, splits, dg, dg_f, device, chunk, windows)
    nnz = graph_nnz(dg)
    out["nnz"], out["nnz_jax_script"] = nnz, NNZ_JAX_SCRIPT
    out["step"]["paired_edges_per_s"] = nnz / (out["step"]["paired"]["ms_per_step_min"] / 1e3)
    out.update(card_fields(device))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    out = bench_paired(args.device)
    write_json(args.out, out)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
