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
   config's weights have another layout); ``full_pallas_bf16`` also
   profiles one chunk of 8 steps, as the headline does;
4. ``full_dense_bf16`` and ``full_factored_int8``: the same graph and split
   on device graphs of their own, built once the configs above are freed
   (the port builds no dense stack beside a mask form): the bf16 dense
   stacks (``spmm_impl="dense"``), then the int8 factored masks and their
   transposes (``spmm_impl="dense_factored"``), each the ``Trainer`` in
   chunks of 320 steps, the factored one starting from the dense one's
   state, as the JAX bench does.  Both aggregations are plain PyTorch, as
   they are plain XLA in the JAX package; the only kernel they launch is
   the optimizer K7.

The headline is the fastest of ``full_paired_int8``, ``full_factored_int8``
and ``full_dense_bf16``, as the JAX bench picks it.  Each config times its
chunks (6 toy, 3 paired, dense and factored, 5 and 3 sparse) after one
warm-up chunk (host clock, synchronized after each chunk) and reports
edges/s (adjacency nonzeros aggregated per second of train step), min and
median ms per step and the effective TFLOP/s of the aggregation; the
paper-scale configs add their peak memory and their ratio to the
headline's step time (``vs_headline``) and, but for the dense one, to the
dense config's (``vs_dense``).  The stack configs add their HBM share
(``hbm_util``): the stacks a step reads four times (two layers, forward
and backward: the half mask stacks, the bf16 dense stacks, the forward
int8 masks whose transposes the backward reads) over 3.35 TB/s (H100
SXM), with the stacks' size in GB (``pair_mask_gb``, ``dense_stacks_gb``,
``mask_stacks_gb``).  On CUDA the headline, ``full_pallas_bf16``,
``full_dense_bf16`` and ``full_factored_int8`` each run one more chunk of 8
steps under ``torch.profiler``: the device's busy ms a step, its idle share
and the kernels that take the most device time.

Prints one JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``,
``hbm_roofline_fraction``, ``configs``, ``note`` (which config is the
headline), and ``torch``, ``device`` (the ``nvidia-smi`` name and power
limit) and ``backend``.  ``configs`` also holds ``sparse_regime_ref``, as
the JAX bench's does: the ``workload``, ``xla``, ``pallas_bf16`` and
``pallas_vs_xla`` of the sparse regime's record
(``artifacts/perf/torch_sparse_regime_bench.json``, written on the card by
``decagon_tpu_torch/scripts/bench_sparse_regime.py``), left out when the
file is missing; a malformed file is an error.  Runs on CUDA unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import sys
import time
from typing import Dict, Optional, Tuple

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.scripts.records import device_name, peak_gib
from decagon_tpu_torch.timing import hard_sync

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPARSE_REGIME = os.path.join(ROOT, "artifacts", "perf", "torch_sparse_regime_bench.json")
SPARSE_REGIME_FIELDS = ("workload", "xla", "pallas_bf16", "pallas_vs_xla")
REFERENCE_ITER_LATENCY_S = 0.0055  # decagon_iteration_results_0.csv Latency
HBM_BYTES_S = 3.35e12  # H100 SXM
TOY_CHUNK, TOY_WINDOWS = 100, 6
CHUNK, WINDOWS = 320, 3
PROFILE_STEPS = 8  # the profiled chunk of the stack configs and full_pallas_bf16 (on CUDA)
# The sparse configs: chunk, and timed windows per spmm_precision.
PALLAS_CHUNK = 20
PALLAS_CONFIGS = (("full_pallas_bf16", "default", 5), ("full_pallas_f32", "highest", 3))
# The configs the headline is picked from, as ``bench.py`` picks it.
HEADLINE_CANDIDATES = ("full_paired_int8", "full_factored_int8", "full_dense_bf16")
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


def device_profile(trainer, steps: int, step_ms: float, top: Optional[int] = 12,
                   groups: Optional[Dict[str, Tuple[str, ...]]] = None,
                   on_card: bool = True) -> dict:
    """``steps`` more steps of ``trainer`` in one chunk under
    ``profile_call``."""
    batches = list(itertools.islice(trainer.scheduler.epoch(), steps))
    hard_sync(trainer.params)

    def chunk():
        trainer.train_chunk(batches, steps)
        return trainer.params

    return profile_call(chunk, len(batches), step_ms, top, groups, on_card)


def profile_call(fn, steps: int, step_ms: float, top: Optional[int] = 12,
                 groups: Optional[Dict[str, Tuple[str, ...]]] = None,
                 on_card: bool = True) -> dict:
    """One call of ``fn`` (``steps`` steps; it returns the tensors to wait
    for) under ``torch.profiler`` (device activity only; its first use in a
    process costs several seconds of set-up): the device's busy ms a step
    (kernel self time summed; one stream), its idle share against
    ``step_ms`` (the unprofiled calls' ms a step), the ``top`` kernels by
    device time (ms a step and launches a step; ``top=None`` keeps every
    kernel) and, for each of ``groups`` (a name and the kernel names it
    sums), that group's ms a step; ``kernels_per_step``: every kernel the
    device ran, launches a step.  ``on_card=False`` traces host activity
    instead and reads each op's host self time (the CPU tests' trace); the
    profiler has already taken each event's children out of its self
    time."""
    from torch.profiler import ProfilerActivity, profile

    activity, kind = ((ProfilerActivity.CUDA, torch.autograd.DeviceType.CUDA) if on_card
                      else (ProfilerActivity.CPU, torch.autograd.DeviceType.CPU))
    with profile(activities=[activity]) as prof:
        hard_sync(fn())
    kernels = [((e.self_device_time_total if on_card else e.self_cpu_time_total) / 1e3,
                e.count, e.key) for e in prof.key_averages() if e.device_type == kind]
    kernels = [k for k in kernels if k[0] > 0]
    busy = sum(ms for ms, _, _ in kernels) / steps
    kernels.sort(reverse=True)
    return {
        "steps": steps, "device_busy_ms_per_step": busy, "idle_share": 1.0 - busy / step_ms,
        "kernels_per_step": sum(n for _, n, _ in kernels) / steps,
        "top": [{"name": name[:80], "ms_per_step": ms / steps,
                 "launches_per_step": n / steps} for ms, n, name in kernels[:top]],
        "groups_ms_per_step": {
            group: sum(ms for ms, _, name in kernels if any(k in name for k in names))
            / steps for group, names in (groups or {}).items()},
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


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _stack_config(trainer, device, nnz: int, stack_bytes: int, chunk: int, windows: int) -> dict:
    """A stack config's timing, metrics, HBM share (its stacks read four
    times a step) and peak memory; on CUDA its profile."""
    t = steady_state_ms(trainer, chunk, windows)
    out = config_metrics(nnz, t)
    out["hbm_util"] = 4 * stack_bytes / (t["min_ms"] / 1e3) / HBM_BYTES_S
    out["peak_memory_gib"] = peak_gib(device)
    if device.type == "cuda":
        out["profile"] = device_profile(trainer, PROFILE_STEPS, t["median_ms"])
    return out


def bench_paired_sparse(graph, splits, device) -> dict:
    """``full_paired_int8`` and the sparse ``full_pallas_*``, on one device
    graph holding both layouts."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    _reset_peak(device)
    t0 = time.perf_counter()
    dg = build_device_graph(
        graph, splits, densify_max_cells=1_000_000_000,
        dense_factored=True, dense_paired=True, tile_for_pallas=True,
        tile_even_if_dense=True, build_fused=False, device=device,
    )
    hard_sync(dg.neg_cdf)
    build_s = time.perf_counter() - t0
    _progress(f"paired and sparse device graph built ({build_s:.0f}s)")
    model = DecagonModel(
        ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="paired"), dg
    )
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=CHUNK)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=0)
    pair_bytes = sum(a.pair_mask.numel() for a in dg.adj.values() if a.pair_mask is not None)
    nnz = graph_nnz(dg)
    out = _stack_config(trainer, device, nnz, pair_bytes, CHUNK, WINDOWS)
    out["pair_mask_gb"] = pair_bytes / 1e9
    out["host_build_s"] = build_s  # the caller adds the host graph's seconds
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
        configs[tag]["peak_memory_gib"] = peak_gib(device)
        if device.type == "cuda" and precision == "default":
            configs[tag]["profile"] = device_profile(trainer, PROFILE_STEPS, tp["median_ms"])
        del trainer
    return configs


def bench_dense_factored(graph, splits, device, chunk: int = CHUNK, windows: int = WINDOWS,
                         trainer_cls=None) -> dict:
    """``full_dense_bf16`` and ``full_factored_int8``, each on a device
    graph of its own (the dense one freed before the factored one is
    built): the dense ``Trainer`` from seeded weights, the factored one
    from a copy of the dense one's state (``init_state``), as the JAX
    bench starts it.  ``trainer_cls``: the ``Trainer`` (for tests)."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.ops.optim import tree_map
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    trainer_cls = trainer_cls or Trainer
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, scan_chunk=chunk)
    configs = {}
    state = None
    for tag, impl, build in (
        ("full_dense_bf16", "dense", dict(dense_dtype=torch.bfloat16)),
        ("full_factored_int8", "dense_factored", dict(dense_factored=True)),
    ):
        _progress(tag)
        _reset_peak(device)
        t0 = time.perf_counter()
        dg = build_device_graph(graph, splits, densify_max_cells=1_000_000_000,
                                build_fused=False, device=device, **build)
        hard_sync(dg.neg_cdf)
        build_s = time.perf_counter() - t0
        model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl=impl), dg)
        trainer = trainer_cls(model, graph, splits, dg, cfg, seed=0, init_state=state)
        if impl == "dense":
            stacks = [a.dense for a in dg.adj.values() if a.dense is not None]
            size_key = "dense_stacks_gb"
        else:
            stacks = [a.dense_mask for a in dg.adj.values() if a.dense_mask is not None]
            size_key = "mask_stacks_gb"
        stack_bytes = sum(x.numel() * x.element_size() for x in stacks)
        out = _stack_config(trainer, device, graph_nnz(dg), stack_bytes, chunk, windows)
        out[size_key] = stack_bytes / 1e9
        out["host_build_s"] = build_s
        configs[tag] = out
        if state is None:
            state = tree_map(
                lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else x,
                trainer.state_dict())
        del trainer, model, dg
    return configs


def pick_headline(configs: dict) -> str:
    """The fastest (least ``ms_per_step_min``) of ``HEADLINE_CANDIDATES``
    present, as ``bench.py`` picks it."""
    present = [key for key in HEADLINE_CANDIDATES if key in configs]
    return min(present, key=lambda key: configs[key]["ms_per_step_min"])


def add_ratios(configs: dict, headline: str) -> None:
    """``vs_headline`` on every paper-scale config but the headline, and
    ``vs_dense`` on every one but the dense config: ratios of
    ``ms_per_step_min``."""
    head = configs[headline]["ms_per_step_min"]
    dense = configs["full_dense_bf16"]["ms_per_step_min"]
    for key, c in configs.items():
        if key != headline:
            c["vs_headline"] = c["ms_per_step_min"] / head
        if key != "full_dense_bf16":
            c["vs_dense"] = c["ms_per_step_min"] / dense


def bench_fullscale(device) -> dict:
    """The paper-scale configs, each with its ``vs_headline`` and
    ``vs_dense``; returns (configs, headline key)."""
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph

    t0 = time.perf_counter()
    graph = make_polypharmacy_like_graph(**PAPER)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    graph_s = time.perf_counter() - t0
    configs = bench_paired_sparse(graph, splits, device)
    configs["full_paired_int8"]["host_build_s"] += graph_s
    _progress("dense and factored configs")
    configs.update(bench_dense_factored(graph, splits, device))
    headline = pick_headline(configs)
    add_ratios(configs, headline)
    return configs, headline


def sparse_regime_ref(path: str = SPARSE_REGIME):
    """The sparse regime's summary fields, lifted from its record as
    ``bench.py`` lifts them from the JAX package's, with the record's
    source; None when there is no record.  Raises ``ValueError`` for a
    record that is not a JSON object holding every field."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        record = json.load(f)  # json.JSONDecodeError is a ValueError
    if not isinstance(record, dict) or any(k not in record for k in SPARSE_REGIME_FIELDS):
        raise ValueError(f"{path}: a record of bench_sparse_regime.py holds "
                         f"{', '.join(SPARSE_REGIME_FIELDS)}")
    return {"source": f"{os.path.relpath(path, ROOT)} "
                      "(decagon_tpu_torch/scripts/bench_sparse_regime.py)",
            **{k: record[k] for k in SPARSE_REGIME_FIELDS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    sparse_ref = sparse_regime_ref()
    _progress("toy config")
    toy = bench_toy(device)
    _progress("paper-scale configs")
    full, headline_key = bench_fullscale(device)
    headline = full[headline_key]
    _progress("done")
    print(json.dumps({
        "metric": "fullscale_train_step_edges_per_s_per_chip",
        "value": headline["edges_per_s"],
        "unit": "edges/s",
        "vs_baseline": REFERENCE_ITER_LATENCY_S * 1e3 / toy["ms_per_step_min"],
        "hbm_roofline_fraction": headline["hbm_util"],
        "configs": {"toy_dense": toy, **full,
                    **({"sparse_regime_ref": sparse_ref} if sparse_ref else {})},
        "torch": torch.__version__,
        "device": device_name(device),
        "backend": device.type,
        "note": f"headline = {headline_key}: the fastest paper-scale train step (forward, "
                "backward, Adam) of full_paired_int8 (the paired int8 mask kernels), "
                "full_factored_int8 and full_dense_bf16",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
