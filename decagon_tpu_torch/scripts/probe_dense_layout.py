"""Probe: the dense aggregation at paper scale as a batched einsum
``[K, Ni, Nj] x [K, Nj, H]`` against one flat GEMM ``[Ni, K*Nj] x [K*Nj, H]``.

    python -m decagon_tpu_torch.scripts.probe_dense_layout [--device cpu] [--out PATH]

Port of ``scripts/probe_dense_layout.py``: the paper graph (19,081 proteins,
645 drugs, 963 side effects of >= 500 edges, 4,651,131 drug-drug edges,
``ppi_attachment=37``, seed 7), split 5% / 5% (seed 1), the device graph
with bf16 dense stacks up to 10^9 cells and no fused stream.  For drug-drug
(1,1) (``[1926, 645, 645]``, 1.49 GiB) and protein-protein (0,0)
(``[2, 19081, 19081]``: the PPI relation and its transpose, 1.36 GiB): a
bf16 operand ``[K, Nj, 64]`` drawn from seed 1, the stack, and its flat
copy ``[Ni, K*Nj]`` (which doubles the stack's bytes);
``torch.einsum("kij,kjh->ih")`` on the stack and ``torch.matmul`` on the
flat copy, each the fastest of 8 synced calls after a warm-up call
(``timing.timed_ms``, the JAX package's ``timed_ms``), and the stack's
GiB read a second (the JAX script's "GB" is 2^30 bytes).

The JAX package computes both outside any Pallas kernel, so the library
calls are the port here.  JAX accumulates and returns f32
(``preferred_element_type``); a bf16 ``torch.einsum`` or ``torch.matmul``
returns bf16, and that is what is timed, with its reductions kept in f32
(``allow_bf16_reduced_precision_reduction`` off) and with PyTorch's
default, which lets cuBLAS reduce split-K partials in bf16
(``*_ms_bf16_reductions``).  Each form's output is held to the f32 product
of the same bf16 operands (the JAX form's value): within half a bf16 step
of the largest output, 2^-8 of its magnitude (``*_max_rel_err``); the two
forms round apart by at most one step, 2^-7 (``forms_max_rel_diff``).  The
CPU tests hold both forms to the JAX forms in the same way.

Prints the JAX script's lines and writes them as one record with the
card's ``nvidia-smi`` name and power limit, the torch version and peak
memory: ``artifacts/perf/torch_dense_layout_probe.json`` (``--out``).  Runs
on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, Dict, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.scripts.records import card_fields, peak_gib, reset_peak, write_json
from decagon_tpu_torch.timing import timed_ms
from decagon_tpu_torch.train.step import make_generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_dense_layout_probe.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
KEYS = ("1,1", "0,0")
H = 64


def eins(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.einsum("kij,kjh->ih", d, p)


def mm2d(p: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    return torch.matmul(d, p.reshape(-1, p.shape[-1]))


def flat_stack(d3: torch.Tensor) -> torch.Tensor:
    """``[K, Ni, Nj]`` as ``[Ni, K*Nj]`` (a copy)."""
    return d3.permute(1, 0, 2).reshape(d3.shape[1], d3.shape[0] * d3.shape[2])


def operand(adj, device, h: int = H) -> torch.Tensor:
    return torch.randn((adj.num_rel, adj.n_cols, h), generator=make_generator(1, device),
                       device=device).to(torch.bfloat16)


def probe_dense_layout(device=None, graph_kw: Optional[Dict] = None, reps: int = 8,
                       log: Callable = print) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    graph = make_polypharmacy_like_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    rec = {"config": dict(graph=graph_kw or GRAPH, split=SPLIT,
                          device_graph=dict(DEVICE_GRAPH, dense_dtype="bfloat16"), h=H,
                          reps=reps, timing="fastest of reps synced calls after one warm-up",
                          reductions="f32 (allow_bf16_reduced_precision_reduction off); "
                                     "*_ms_bf16_reductions: PyTorch's default"),
           **card_fields(device)}
    reset_peak(device)
    matmul = torch.backends.cuda.matmul
    default = matmul.allow_bf16_reduced_precision_reduction
    for key in KEYS:
        adj = dg.adj[key]
        p = operand(adj, device)
        d3 = adj.dense
        d2 = flat_stack(d3)
        gb = d3.numel() * d3.element_size() / 2**30
        line = dict(shape=list(d3.shape), stack_gb=gb,
                    flat_copy_gb=d2.numel() * d2.element_size() / 2**30)
        try:
            matmul.allow_bf16_reduced_precision_reduction = True
            line.update(einsum_ms_bf16_reductions=timed_ms(eins, p, d3, reps=reps),
                        mm2d_ms_bf16_reductions=timed_ms(mm2d, p, d2, reps=reps))
            matmul.allow_bf16_reduced_precision_reduction = False
            t_e = timed_ms(eins, p, d3, reps=reps)
            t_m = timed_ms(mm2d, p, d2, reps=reps)
            e, m = eins(p, d3), mm2d(p, d2)
        finally:
            matmul.allow_bf16_reduced_precision_reduction = default
        want = mm2d(p.float(), d2.float())
        scale = want.abs().max().clamp_min(1e-30)
        line.update(einsum_ms=t_e, mm2d_ms=t_m, einsum_gb_per_s=gb / (t_e / 1e3),
                    mm2d_gb_per_s=gb / (t_m / 1e3), out_dtype=str(e.dtype),
                    einsum_max_rel_err=float((e.float() - want).abs().max() / scale),
                    mm2d_max_rel_err=float((m.float() - want).abs().max() / scale),
                    forms_max_rel_diff=float((e.float() - m.float()).abs().max() / scale))
        rec[key] = line
        log(f"[{key}] stack {gb:.2f} GB: einsum {t_e:.2f} ms "
            f"({gb / (t_e / 1e3):.0f} GB/s), 2d {t_m:.2f} ms ({gb / (t_m / 1e3):.0f} GB/s)")
        del d2, e, m, p, want
    rec["peak_gib"] = peak_gib(device)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    rec = probe_dense_layout(args.device, log=lambda m: print(m, flush=True))
    write_json(args.out, rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
