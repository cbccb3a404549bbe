#!/usr/bin/env python3
"""Drive the port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each announced with the seconds elapsed since start:

1. device: the card's name, count, and ``nvidia-smi`` name and power limit;
2. build: ``nvcc`` builds the CUDA kernels of ``decagon_tpu_torch/csrc``;
3. serving state: the paper-scale polypharmacy-like graph (19,081
   proteins, 645 drugs, 963 side effects), its split, the device graph
   and seeded random weights (hidden 64 -> 32), as ``bench.py`` headlines;
4. kernels against their plain versions, on the card, on the main path's
   own inputs: the paired forward on drug-drug (963 pairs, N = 645) and
   PPI (1 pair, N = 19,081) at both layers, the scorer in DEDICOM and
   bilinear mode over ~0.94M edges; errors, CUDA-event times, bounds;
5. serve: launch counters set to 0, then one embedding, the pooled
   drug-drug evaluation on the validation and the test edges, and one
   evaluation each of PPI, protein->drug and drug->protein; every
   kernel must have launched and every output must be finite;
6. small-input reference: on a small graph, the slice through the
   kernels against the slice through the plain versions (which the CPU
   tests hold against the JAX package), on the card, layer by layer.

The second-to-last lines are the kernel report (one JSON object) and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Any failure raises.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

T0 = time.perf_counter()

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and plain f32 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# Kernel-vs-plain tolerances.  Paired forward: both round the same
# operands to bf16 and the products are exact, so only the f32 sums
# differ (tensor-core accumulation and order): max error <= 1e-4 of the
# largest output.  Scorer: f32 throughout, order only: <= 1e-5 of
# max(1, largest score).
PAIRED_REL_TOL = 1e-4
SDDMM_REL_TOL = 1e-5

PAPER = dict(
    n_proteins=19081, n_drugs=645, n_side_effects=963,
    min_edges_per_relation=500, total_drugdrug_edges=4_651_131,
    ppi_attachment=37, seed=7,
)
SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)


def phase(name: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] phase: {name}", flush=True)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s]   {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def build_state(kw, device, seed):
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(**kw)
    log(f"graph {time.perf_counter() - t:.1f}s: "
        f"{ {et: len(r) for et, r in sorted(graph.relations.items())} } relations")
    t = time.perf_counter()
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    log(f"split {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    dg = build_device_graph(
        graph, splits, densify_max_cells=1_000_000_000,
        dense_factored=True, dense_paired=True, device=device,
    )
    if device.type == "cuda":
        torch.cuda.synchronize()
    log(f"device graph {time.perf_counter() - t:.1f}s; paired edge types "
        f"{sorted(k for k, a in dg.adj.items() if a.pair_mask is not None)}; "
        f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    model = DecagonModel(
        ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="paired"), dg
    )
    params = model.init_params(torch.Generator().manual_seed(seed), dg)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    return graph, splits, dg, model, params, evaluator


def paired_cases(dg, params, model):
    """(label, p4, mask, scales) for both paired edge types and both
    layers, with the main path's own operands."""
    import torch

    from decagon_tpu_torch.models.encoder import _project_t, encode_layer

    h1 = encode_layer(params, dg, "enc1", dg.features, True, model.config.spmm_impl)
    cases = []
    for key, src in (("1,1", "1"), ("0,0", "0")):
        adj = dg.adj[key]
        p2 = _project_t(h1[src], params["enc2"][key]).to(torch.bfloat16).contiguous()
        for layer, p4 in (("layer 1 f32", params["enc1"][key]), ("layer 2 bf16", p2)):
            cases.append((f"({key}) {layer}", p4, adj.pair_mask, adj.pair_scales))
    return cases


def check_paired(dg, params, model):
    import torch

    from decagon_tpu_torch.ops.spmm_paired import paired_fwd, paired_ref

    rows = []
    for label, p4, mask, scales in paired_cases(dg, params, model):
        got = paired_fwd(p4, mask, scales)
        want = paired_ref(p4, mask, scales)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nnz = int(torch.count_nonzero(mask))
        nbytes = mask.numel() + p4.numel() * p4.element_size() + scales.numel() * 4 + n * h * 4
        flops = 4 * h * nnz  # two products over the mask's nonzeros
        row = dict(
            case=label, K=k, N=n, H=h, dtype=str(p4.dtype).replace("torch.", ""),
            max_abs_err=err, rel_err=err / scale,
            ms=cuda_ms(lambda: paired_fwd(p4, mask, scales), reps=5),
            plain_ms=cuda_ms(lambda: paired_ref(p4, mask, scales), reps=3),
            bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
        )
        log(json.dumps(row))
        if not row["rel_err"] <= PAIRED_REL_TOL:
            raise AssertionError(f"paired_fwd {label}: relative error {row['rel_err']:.3g} > {PAIRED_REL_TOL}")
        rows.append(row)
    return rows


def sddmm_cases(dg, params, emb, splits, seed):
    """DEDICOM over the pooled drug-drug validation sweep (positives and
    negatives of every (1,1) relation, as ``evaluate_all_drug_drug``
    scores them); bilinear over as many random PPI pairs, on relations 0
    and 1 of (0,0)."""
    import numpy as np
    import torch

    parts = [
        (k, e) for (i, j, k), sp in sorted(splits.items()) if (i, j) == (1, 1)
        for e in (sp.val, sp.val_false)
    ]
    ks = np.concatenate([np.full(e.shape[0], k, np.int32) for k, e in parts])
    edges = np.concatenate([e for _, e in parts]).astype(np.int32)
    dev = emb["1"].device
    ks, rows, cols = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        for a in (ks, edges[:, 0], edges[:, 1])
    )
    b = ks.numel()
    dd = params["dec"]["1,1"]
    g = torch.Generator(device=dev).manual_seed(seed)
    n_p = dg.num_nodes[0]
    pk = torch.randint(0, 2, (b,), generator=g, device=dev, dtype=torch.int32)
    pr = torch.randint(0, n_p, (b,), generator=g, device=dev, dtype=torch.int32)
    pc = torch.randint(0, n_p, (b,), generator=g, device=dev, dtype=torch.int32)
    z1, z0 = emb["1"].contiguous(), emb["0"].contiguous()
    return [
        ("dedicom (1,1) validation sweep", z1, z1, ks, rows, cols,
         dict(name="dedicom", glb=dd["global"], rel_diag=dd["local_diag"])),
        ("bilinear (0,0) random pairs", z0, z0, pk, pr, pc,
         dict(name="bilinear", rel_full=params["dec"]["0,0"]["relation"])),
    ]


def sddmm_flops(name, ks, rows, n_rows, d):
    """The least f32 operations the scores need on this data: the d x d
    product of a row with its relation's matrix once per distinct
    (row, relation) pair, then per edge the column's scaling and the dot
    product.  DEDICOM: 2d^2 + d per pair (z_r * d_k, then @ G), 3d per
    edge; bilinear: 2d^2 per pair (z_r @ R_k), 2d per edge."""
    import torch

    pairs = torch.unique(ks.long() * n_rows + rows.long()).numel()
    b = ks.numel()
    if name == "dedicom":
        return pairs * (2 * d * d + d) + b * 3 * d
    if name == "bilinear":
        return pairs * 2 * d * d + b * 2 * d
    raise ValueError(f"no operation count for {name!r}")


def check_sddmm(dg, params, emb, splits, seed):
    import torch

    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain

    rows_out = []
    for label, zr, zc, ks, rows, cols, kw in sddmm_cases(dg, params, emb, splits, seed):
        got = sddmm_edges(zr, zc, ks, rows, cols, **kw)
        want = sddmm_plain(zr, zc, ks, rows, cols, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        b, d = ks.numel(), zr.shape[1]
        tables = {t.data_ptr(): t.numel() * 4 for t in (zr, zc, *kw.values())
                  if isinstance(t, torch.Tensor)}
        row = dict(
            case=label, edges=b, d=d, max_abs_err=err, rel_err=err / scale,
            ms=cuda_ms(lambda: sddmm_edges(zr, zc, ks, rows, cols, **kw), reps=10),
            plain_ms=cuda_ms(lambda: sddmm_plain(zr, zc, ks, rows, cols, **kw), reps=3),
            bytes_ms=(16 * b + sum(tables.values())) / HBM_BYTES_S * 1e3,
            ops_ms=sddmm_flops(kw["name"], ks, rows, zr.shape[0], d) / F32_FLOPS * 1e3,
        )
        log(json.dumps(row))
        if not row["rel_err"] <= SDDMM_REL_TOL:
            raise AssertionError(f"sddmm {label}: error {err:.3g} > {SDDMM_REL_TOL} x {scale:.3g}")
        rows_out.append(row)
    return rows_out


def serve(dg, params, evaluator):
    """The requests, through the evaluator a user calls."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.timing import hard_sync

    cuda_build.reset_launches()
    t = time.perf_counter()
    emb = evaluator.embeddings(params, dg)
    hard_sync(emb)
    log(f"embedding {1e3 * (time.perf_counter() - t):.1f} ms")
    for key, n in (("0", dg.num_nodes[0]), ("1", dg.num_nodes[1])):
        if tuple(emb[key].shape) != (n, 32) or not bool(torch.isfinite(emb[key]).all()):
            raise AssertionError(f"embedding {key}: shape {tuple(emb[key].shape)} or non-finite")
    results = {}
    for use_test in (False, True):
        t = time.perf_counter()
        s = evaluator.evaluate_all_drug_drug(params, dg, use_test=use_test, embeddings=emb)
        results[f"drug-drug {'test' if use_test else 'val'}"] = (s, time.perf_counter() - t)
    for key in ((0, 0, 0), (0, 1, 0), (1, 0, 0)):
        t = time.perf_counter()
        s = evaluator.evaluate(params, dg, key, embeddings=emb)
        results[f"relation {key}"] = (s, time.perf_counter() - t)
    counts = dict(cuda_build.LAUNCHES)
    for name, (s, secs) in results.items():
        log(f"{name}: auroc {s.auroc:.4f} auprc {s.auprc:.4f} apk {s.apk:.4f} ({1e3 * secs:.1f} ms)")
        for v in (s.auroc, s.auprc, s.apk):
            if not 0.0 <= v <= 1.0:
                raise AssertionError(f"{name}: metric {v} outside [0, 1]")
    log(f"launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    return counts


def small_reference(device):
    """The whole slice through the kernels against the same slice through
    the plain versions (the path the CPU tests hold against the JAX
    package), on a small graph, on the card, with the same weights, one
    layer at a time: layer 1 on the features, layer 2 on the kernels'
    layer-1 output, and the evaluator on the kernels' embeddings, each to
    the CPU tests' 1e-4.

    Run end to end instead, the two paths feed layer 2 different h1, and
    the layer-2 projection, rounded to bf16 before the aggregation, can
    then round to neighbouring bf16 values; the count of such operands
    and the end-to-end difference are printed, not held to a bound."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.encoder import _project_t, encode_layer
    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator

    def hold(label, got, want, tol=1e-4):
        for key in want:
            if not torch.isfinite(got[key]).all():
                raise AssertionError(f"small graph {label} {key} is not finite")
            err = (got[key] - want[key]).abs().max().item()
            bound = tol * max(1.0, want[key].abs().max().item())
            log(f"small graph {label} {key}: max abs err {err:.3g} (bound {bound:.3g})")
            if not err <= bound:
                raise AssertionError(f"small graph {label} {key} differs by {err}")

    graph, splits, dg, model, params, ev = build_state(SMALL, device, seed=0)
    plain = DecagonModel(
        dataclasses.replace(model.config, spmm_impl="paired_ref", sddmm_impl="jnp"), dg
    )
    ev_plain = AccuracyEvaluator(plain, graph, splits, device=device)
    h1 = encode_layer(params, dg, "enc1", dg.features, True, "paired")
    h1_plain = encode_layer(params, dg, "enc1", dg.features, True, "paired_ref")
    hold("layer 1", h1, h1_plain)
    emb = encode_layer(params, dg, "enc2", h1, False, "paired")
    hold("layer 2 on the same h1", emb, encode_layer(params, dg, "enc2", h1, False, "paired_ref"))
    for key in ("1,1", "0,0"):
        src = key[0]
        p2, p2_plain = (
            _project_t(h[src], params["enc2"][key]).to(torch.bfloat16)
            for h in (h1, h1_plain)
        )
        log(f"small graph ({key}) layer-2 bf16 operands that differ when each path "
            f"runs its own layer 1: {int((p2 != p2_plain).sum())} of {p2.numel()}")
    emb_plain = ev_plain.embeddings(params, dg)
    log("small graph embeddings end to end, max abs differences: " + ", ".join(
        f"{k} {(emb[k] - emb_plain[k]).abs().max().item():.3g}" for k in emb))
    a = ev.evaluate_all_drug_drug(params, dg, embeddings=emb)
    b = ev_plain.evaluate_all_drug_drug(params, dg, embeddings=emb)
    log(f"small graph drug-drug auroc/auprc/apk {a.auroc:.6f} {a.auprc:.6f} {a.apk:.6f} "
        f"(kernels), {b.auroc:.6f} {b.auprc:.6f} {b.apk:.6f} (plain), same embeddings")
    for m in ("auroc", "auprc", "apk"):
        if not abs(getattr(a, m) - getattr(b, m)) <= 1e-4:
            raise AssertionError(f"small graph {m} differs between kernels and plain versions")


def kernel_entry(name, source, replaces, launches, rows):
    bytes_ms = sum(r["bytes_ms"] for r in rows)
    ops_ms = sum(r["ops_ms"] for r in rows)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None, cases=rows,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="weights and random pairs")
    args = ap.parse_args(argv)

    phase("device")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from decagon_tpu_torch import resolve_device
    from decagon_tpu_torch.ops import cuda_build

    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"{kind} x{count}; nvidia-smi: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")

    phase("build")
    cuda_build.library()
    log(f"nvcc build {cuda_build.BUILD_INFO['seconds']:.1f}s")
    for line in str(cuda_build.BUILD_INFO["ptxas"]).splitlines():
        if "Used" in line or "spill" in line:
            log("ptxas " + line.strip())

    phase("serving state (paper scale)")
    torch.cuda.reset_peak_memory_stats()
    graph, splits, dg, model, params, evaluator = build_state(PAPER, device, args.seed)
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("kernels against plain versions")
    paired_rows = check_paired(dg, params, model)
    emb = evaluator.embeddings(params, dg)
    sddmm_rows = check_sddmm(dg, params, emb, splits, args.seed)
    del emb
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("serve")
    counts = serve(dg, params, evaluator)

    phase("small-input reference")
    small_reference(device)

    phase("done")
    report = {"kernels": [
        kernel_entry("paired_fwd", "decagon_tpu_torch/csrc/paired_fwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:82", counts["paired_fwd"],
                     paired_rows),
        kernel_entry("sddmm", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", counts["sddmm"],
                     sddmm_rows),
    ]}
    print(json.dumps(report))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
