"""Training-step throughput of the port, in ``bench.py``'s schema.

    python -m decagon_tpu_torch.bench [--device cpu]

Ports the parts of the JAX package's ``bench.py`` that the port runs:

1. ``toy_dense``: the reference's dummy config (500 genes, 400 drugs, 3
   drug-drug relations and their transposes; ``Trainer`` with chunks of
   100 steps), the workload behind the reference's recorded ~5.5 ms per
   iteration, from which ``vs_baseline`` is taken;
2. ``full_paired_int8`` (the headline): the paper-scale polypharmacy-like
   graph (19,081 proteins, 645 drugs, 963 side effects, ~12.1M adjacency
   edges) through the paired int8 mask kernels, the ``Trainer`` in chunks
   of 320 steps;
3. ``full_pallas_bf16`` and ``full_pallas_f32``: the same graph (its CSR
   layouts built beside the paired masks) through the sparse kernel K6,
   ``spmm_impl="pallas"`` at ``spmm_precision`` "default" and "highest",
   the ``Trainer`` in chunks of 20 from fresh seeded weights (the paired
   config's weights have another layout), each with its ratio to the
   headline's step time (``vs_headline``).

Each config times its chunks (6 toy, 3 paired, 5 and 3 sparse) after one
warm-up chunk (host clock, synchronized after each chunk) and reports edges/s
(adjacency nonzeros aggregated per second of train step), min and median
ms per step and the effective TFLOP/s of the aggregation; the paired
config adds its HBM
share: the half mask stacks read four times a step (two layers, forward
and backward) over 3.35 TB/s (H100 SXM), and on CUDA one more chunk of 8
steps under ``torch.profiler``: the device's busy ms a step, its idle
share and the kernels that take the most device time.  The JAX package's dense and
factored trainers are not ported here.

Prints one JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``hbm_roofline_fraction``, ``configs``, and ``torch``, ``device`` (the
``nvidia-smi`` name and power limit) and ``backend``.  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.timing import hard_sync

REFERENCE_ITER_LATENCY_S = 0.0055  # decagon_iteration_results_0.csv Latency
HBM_BYTES_S = 3.35e12  # H100 SXM
TOY_CHUNK, TOY_WINDOWS = 100, 6
CHUNK, WINDOWS = 320, 3
PROFILE_STEPS = 8  # the headline's profiled chunk (on CUDA)
# The sparse configs: chunk, and timed windows per spmm_precision.
PALLAS_CHUNK = 20
PALLAS_CONFIGS = (("full_pallas_bf16", "default", 5), ("full_pallas_f32", "highest", 3))
PAPER = dict(
    n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
    total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7,
)


def _progress(msg: str) -> None:
    """Progress on stderr; stdout stays the one JSON line."""
    print(f"[bench +{time.perf_counter() - _T0:.0f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def steady_state_ms(trainer, chunk: int, windows: int) -> dict:
    """One warm-up chunk, then ``windows`` timed chunks: min and median ms
    per step, every window's, and the losses of all the chunks' steps (a
    CPU tensor)."""
    batches = []
    need = chunk * (windows + 1)
    while len(batches) < need:
        batches.extend(itertools.islice(trainer.scheduler.epoch(), need - len(batches)))
    losses = [trainer.train_chunk(batches[:chunk], chunk)]
    hard_sync(losses)
    times = []
    for rep in range(windows):
        lo = chunk * (1 + rep)
        start = time.perf_counter()
        losses.append(trainer.train_chunk(batches[lo:lo + chunk], chunk))
        hard_sync(trainer.params)
        times.append((time.perf_counter() - start) / chunk)
    return {
        "min_ms": min(times) * 1e3,
        "median_ms": statistics.median(times) * 1e3,
        "window_ms": [t * 1e3 for t in times],
        "losses": torch.cat(losses).cpu(),
    }


def device_profile(trainer, steps: int, step_ms: float, top: int = 12) -> dict:
    """``steps`` more steps in one chunk under ``torch.profiler`` (device
    activity only; its first use in a process costs several seconds of
    set-up): the device's busy ms a step (kernel self time summed; one
    stream), its idle share against ``step_ms`` (the unprofiled chunks'
    ms a step), and the ``top`` kernels by device time (ms a step and
    launches a step)."""
    from torch.profiler import ProfilerActivity, profile

    batches = list(itertools.islice(trainer.scheduler.epoch(), steps))
    hard_sync(trainer.params)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.train_chunk(batches, steps)
        hard_sync(trainer.params)
    kernels = [(e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(ms for ms, _, _ in kernels) / len(batches)
    kernels.sort(reverse=True)
    return {
        "steps": len(batches), "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / step_ms,
        "top": [{"name": name[:80], "ms_per_step": ms / len(batches),
                 "launches_per_step": n / len(batches)} for ms, n, name in kernels[:top]],
    }


def graph_nnz(device_graph) -> int:
    return sum(int(torch.count_nonzero(a.vals)) for a in device_graph.adj.values())


def config_metrics(nnz: int, t: dict, hidden=(64, 32)) -> dict:
    step_s = t["min_ms"] / 1e3
    # Aggregation applications per step: layer-1 forward and backward at
    # hidden1, layer-2 at hidden2; 2 operations per edge and feature.
    useful_flops = 2 * nnz * 2 * (hidden[0] + hidden[1])
    return {
        "edges_per_s": nnz / step_s,
        "ms_per_step_min": t["min_ms"],
        "ms_per_step_median": t["median_ms"],
        "window_ms": t["window_ms"],
        "nnz": nnz,
        "effective_tflops": useful_flops / step_s / 1e12,
    }


def bench_toy(device) -> dict:
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    graph = make_synthetic_graph(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    dg = build_device_graph(graph, splits, device=device)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="auto"), dg)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=TOY_CHUNK)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    return config_metrics(graph_nnz(dg), steady_state_ms(trainer, TOY_CHUNK, TOY_WINDOWS))


def bench_fullscale(device) -> dict:
    """The paper-scale configs: ``full_paired_int8`` (the headline) and the
    sparse ``full_pallas_*``, on one device graph holding both layouts."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    graph = make_polypharmacy_like_graph(**PAPER)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(
        graph, splits, densify_max_cells=1_000_000_000,
        dense_factored=True, dense_paired=True, tile_for_pallas=True,
        tile_even_if_dense=True, build_fused=False, device=device,
    )
    hard_sync(dg.neg_cdf)
    build_s = time.perf_counter() - t0
    _progress(f"paper-scale device graph built ({build_s:.0f}s)")
    model = DecagonModel(
        ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="paired"), dg
    )
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=CHUNK)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    pair_bytes = sum(a.pair_mask.numel() for a in dg.adj.values() if a.pair_mask is not None)
    t = steady_state_ms(trainer, CHUNK, WINDOWS)
    nnz = graph_nnz(dg)
    out = config_metrics(nnz, t)
    out["pair_mask_gb"] = pair_bytes / 1e9
    # The half mask stacks, read four times a step (two layers, forward
    # and backward), against the card's memory rate.
    out["hbm_util"] = 4 * pair_bytes / (t["min_ms"] / 1e3) / HBM_BYTES_S
    out["host_build_s"] = build_s
    if device.type == "cuda":
        out["profile"] = device_profile(trainer, PROFILE_STEPS, t["median_ms"])
    configs = {"full_paired_int8": out}
    del trainer
    for tag, precision, windows in PALLAS_CONFIGS:
        _progress(tag)
        model = DecagonModel(ModelConfig(
            hidden1=64, hidden2=32, dropout=0.1, spmm_impl="pallas", spmm_precision=precision,
        ), dg)
        trainer = Trainer(model, graph, splits, dg,
                          TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=PALLAS_CHUNK),
                          seed=0)
        tp = steady_state_ms(trainer, PALLAS_CHUNK, windows)
        configs[tag] = config_metrics(nnz, tp)
        configs[tag]["vs_headline"] = tp["min_ms"] / t["min_ms"]
        del trainer
    return configs


def _device_name(device) -> str:
    if device.type != "cuda":
        return str(device)
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    _progress("toy config")
    toy = bench_toy(device)
    _progress("paper-scale configs")
    full = bench_fullscale(device)
    headline = full["full_paired_int8"]
    _progress("done")
    print(json.dumps({
        "metric": "fullscale_train_step_edges_per_s_per_chip",
        "value": headline["edges_per_s"],
        "unit": "edges/s",
        "vs_baseline": REFERENCE_ITER_LATENCY_S * 1e3 / toy["ms_per_step_min"],
        "hbm_roofline_fraction": headline["hbm_util"],
        "configs": {"toy_dense": toy, **full},
        "torch": torch.__version__,
        "device": _device_name(device),
        "backend": device.type,
        "note": "headline = paper-scale train step (forward, backward, Adam) through the "
                "paired int8 mask kernels",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
