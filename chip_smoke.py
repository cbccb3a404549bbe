#!/usr/bin/env python3
"""Drive the port's serving and training paths on one NVIDIA GPU and
check them.

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
   bilinear mode over ~0.94M edges, with f32 tables (K5) and bf16 tables
   (K5-bf16, also held within 1e-2 of K5); errors, two calls bitwise
   equal, CUDA-event times, bounds, and for the paired forward the
   ``torch.bmm`` yardstick (``library_ms``), the sweep kernel's registers
   and blocks an SM and the schedule's waves;
5. serve: launch counters set to 0, then one embedding, the pooled
   drug-drug evaluation on the validation and the test edges, and one
   evaluation each of PPI, protein->drug and drug->protein; every
   kernel must have launched and every output must be finite;
6. small-input reference: on a small graph, the slice through the
   kernels against the slice through the plain versions (which the CPU
   tests hold against the JAX package), on the card, layer by layer;
7. train: launch counters set to 0, then ``make_train_step`` at paper
   scale (dropout 0.1, batch 512, hinge, bf16 Adam moments and large
   gradients): 4 steps on drug-drug (DEDICOM) and 2 on PPI (bilinear);
   losses, step ms, the forward/backward/Adam split from CUDA events, and
   the launches, which must be > 0 for both paired kernels.  The paired
   kernels' operands of the first step are recorded for phase 8.  Then
   one step's gradients through the kernels against the same step
   through the plain versions, same dropout bits and negatives;
8. kernels against plain versions, training: the keep-scale forward
   (K1/K2-ds) and the backward (K3/K4, with keep-scales into f32 and
   without into bf16) on the operands phase 7 recorded, plus a K > 1,
   N > 4096 case; errors, bitwise repeatability, CUDA-event times,
   bounds, the ``torch.bmm`` yardstick, registers, blocks an SM and
   waves;
9. small-input training: 3 Adam steps through the kernels and through
   the plain versions from the same state, bits and negatives;
10. trainer (paper scale): launch counters set to 0, then the ``Trainer``
   with the default ``TrainConfig`` (bf16 moments and large gradients) in
   chunks of 32 steps: one warm-up chunk and 3 timed ones; ms per step,
   edges/s in ``bench.py``'s schema, peak memory, the launches (both
   paired kernels > 0, the one-pass Adam 0: its gate wants f32 moments),
   and the gap to phase 7's single-step time;
11. one-pass Adam (K7) against its plain version: the paper leaf it
   updates (``[1, 19081, 64]``), P6's ``[1926, 64, 645]`` in f32 and in
   P6's bf16, a length that is not a multiple of 4 and a view off 16-byte
   alignment; bitwise equality, in place; device times (a replayed CUDA
   graph, operands outside the L2 cache) of the kernel, the plain chain
   and ``torch.optim.Adam(fused=True)``, and the bounds;
12. trainer with ``pallas_adam`` (paper scale, f32 moments and gradients):
   launch counters set to 0, one chunk of 4 steps from a copy of phase
   10's state, which must launch the one-pass Adam once a step, and the
   same chunk without it from another copy: parameters and moments equal;
13. dummy config on the card: the port's copy of the JAX package's
   ``test_dummy_config_learns_into_reference_band`` (500 genes, 400
   drugs, 3 side effects; the ``Trainer`` in chunks of 50), whose last
   epoch runs with a ``MetricsLogger`` and a ``Checkpointer`` in a
   temporary directory; the checkpoint is restored into a fresh
   ``Trainer``;
14. sparse state: phase 3's graph and split as the sparse regime builds
   them (``scripts/bench_sparse_regime.py`` ``paper_cap``: no dense or
   mask stack, the CSR layouts of K6 on every edge type, no fused stream);
   build seconds, each layout's rows, edges and longest row, memory;
15. K6 against its plain version on the sparse path's own operands: every
   edge type, both layers, forward and backward (a seeded cotangent over
   the transposed layout), both precisions; errors, bitwise
   repeatability, CUDA-event ms of the kernel, the plain version and
   ``torch.sparse.mm`` on the same CSR (f32), bounds;
16. sparse training (paper scale, ``spmm_impl="pallas"``): launch counters
   set to 0, then ``make_train_step`` at "default" (2 drug-drug steps, 1
   PPI) with the forward / backward / Adam split, the ``Trainer`` at both
   precisions (chunks of 8: one warm-up, 2 timed; ms per step, edges/s,
   peak memory) and the pooled drug-drug evaluation with bf16 scoring;
   K6 and K5-bf16 must launch and the paired kernels not.  Then one
   step's gradients through K6 against its plain version at both
   precisions, and one step with ``remat`` against the same step without
   it (gradients, K6 launches, peak memory);
17. small-input sparse checks: on the small graph with every layout,
   "pallas" and "fused_pallas" through K6 against their plain versions,
   layer by layer, at both precisions, and 3 Adam steps with
   "fused_pallas" at "default";
18. probes: the ports of the JAX package's paired-kernel probes P1-P5
   (``decagon_tpu_torch/scripts/probe_*``) at their shapes (the
   ``[964, 645, 645]`` int8 stack, K = 963, N = 645, H = 64; P1 and P4
   also at K = 4): each kernel against its plain version (P5 bit for bit,
   P1-P3 within 1e-5 of the largest output, P4 by the bf16 rule), two
   calls bitwise equal, P1's and P4's numpy oracles; then, launch
   counters set to 0, CUDA-event times of each kernel, its plain version
   and, for P5, ``torch.sum``, with bounds; K1's phase-4 time (the sweep
   design) is printed beside P3's parts (the former WMMA design, at the
   relations a block that design took).  P6's launches are those of its
   timing in phase 11.

The paired kernels K1/K2 (forward) and K3/K4 (backward) share one sweep
(``decagon_tpu_torch/csrc/paired_core.cuh``): a bf16 operand pass, then
16-byte ``cp.async`` mask staging in a three-stage ring with one barrier a
chunk, each warp converting the bytes it consumes, ``ldmatrix`` /
``ldmatrix.trans`` and ``mma.sync`` with the row scales applied in
registers, and relations and contraction cut into whole waves by
``ops/spmm_paired.paired_schedule``.

The second-to-last lines are the kernel report (one JSON object) and the
``nvidia-smi`` line; the last line is ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside the repository, it exits non-zero and
prints no result.  Any failure raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T0 = time.perf_counter()

from decagon_tpu_torch.scripts.probing import card, cuda_ms  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s,
# bf16 tensor-core and plain f32 FLOP/s.
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

# Kernel-vs-plain tolerances.  Paired forward and backward: both round the
# same operands to bf16 and the products are exact, so only the f32 sums
# differ (tensor-core accumulation and order): max error <= 1e-4 of the
# largest output.  A bf16 backward output may then round to the
# neighbouring bf16 value (one ulp, <= 2^-7 of the element), so it is held
# elementwise to 2^-7 |plain| + 1e-4 max|plain|.  Scorer: f32 throughout,
# order only: <= 1e-5 of max(1, largest score).
PAIRED_REL_TOL = 1e-4
BF16_ULP = 2.0 ** -7
SDDMM_REL_TOL = 1e-5
# K5-bf16 against K5 (phase 4): bf16 tables move a score by up to ~2^-8 of
# each of its terms; the reference states ~1e-2 relative.  Held to 1e-2
# of the largest "highest" score.
SDDMM_BF16_TOL = 1e-2
# K6 against its plain version (phases 15, 17): the same roundings, f32
# sums in other orders (segment, then partials, against index_add_'s):
# <= 1e-5 of the largest output.
SPMM_REL_TOL = 1e-5
# Whole-step gradients, kernels against plain versions (same parameters,
# dropout bits and negatives), each leaf to 2^-6 of its largest magnitude.
# The kernels and the plain versions sum in f32 in other orders, and the
# path from the loss back to a layer-1 weight gradient holds up to four
# bf16 roundings that such differences can flip, each at most 2^-8 of its
# value (8-bit significand): the layer-2 operand (projection times column
# scale), the layer-2 backward's bf16 output or its a * ct, the layer-1
# a * ct, and on the paired types the keep-scale backward, where the
# kernel rounds a * ct and the plain version (autograd of paired_ref_ds,
# as in the JAX package) rounds the product.  4 x 2^-8 = 2^-6.  Each
# kernel alone, on identical inputs, is held to 1e-4 in phase 8.
STEP_GRAD_TOL = 2.0 ** -6
# Phase 16, one step's gradients through K6 against its plain version:
# "highest" to 1e-4 of each leaf's max (f32 sums in other orders, as the
# CPU tests hold the encoder); "default" to STEP_GRAD_TOL, since layer 2's
# projection and every cotangent K6 reads are rounded to bf16 after f32
# sums that the two paths take in other orders, and a flipped rounding of
# one cotangent element moves each gradient element it reaches by up to
# 2^-7 of its term.
SPARSE_GRAD_TOL = {"highest": 1e-4, "default": STEP_GRAD_TOL}
# remat against no remat (phase 16): the same kernels on the same bits
# (drawn before the checkpointed region), deterministic algorithms: equal
# bits expected; held to 1e-6 of each leaf's max.
REMAT_TOL = 1e-6
SPARSE_TRAIN_STEPS = {(1, 1): 2, (0, 0): 1}
SPARSE_CHUNK, SPARSE_WINDOWS = 8, 2
TRAIN_STEPS = {(1, 1): 4, (0, 0): 2}
TRAINER_CHUNK = 32
TRAINER_WINDOWS = 3
PALLAS_CHUNK = 4
# Phase 12 holds the chunk with the one-pass Adam against the chunk without
# it to this share of each leaf's largest magnitude where the two are not
# equal bit for bit (the kernel rounds as the plain chain does).
PALLAS_REL_TOL = 1e-6
# Epochs of the dummy-config gate (phase 13).  The JAX test reads after 3,
# where the port's pooled test AUROC reaches 0.62 for only some trainer
# seeds; after 8 every seed swept clears it by 0.027 or more
# (``python -m decagon_tpu_torch.scripts.quality_sweep``).
GATE_EPOCHS = 8

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
        dense_factored=True, dense_paired=True, build_fused=False, device=device,
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


def bmm_library_ms(mask, qd, qt):
    """CUDA-event ms of the ``torch.bmm`` yardstick (``paired_bmm``: one
    call a half) on the direct and transposed operands ``[K, H, N]``.  The
    mask's bf16 copy, the operands' layout, the row scales and the sum
    over relations stay outside the timed region."""
    from decagon_tpu_torch.ops.spmm_paired import paired_bmm, paired_bmm_inputs

    m16, qd, qt = paired_bmm_inputs(mask, qd, qt)
    return cuda_ms(lambda: paired_bmm(m16, qd, qt), reps=5)


def sweep_fields(which, k, n, h, device):
    """The paired sweep kernel's registers and blocks an SM (as the card
    reports them) and the schedule's cut and waves for one call."""
    from decagon_tpu_torch.ops.spmm_paired import kernel_info, launch_schedule

    info = kernel_info(which, device.index or 0)
    sched = launch_schedule(which, k, n, h, device)
    return dict(registers=info["registers"], blocks_per_sm=info["blocks_per_sm"],
                splits=[sched.rel_splits, sched.con_splits], blocks=sched.blocks,
                waves=sched.waves)


def check_paired(dg, params, model):
    import torch

    from decagon_tpu_torch.ops.spmm_paired import paired_fwd, paired_operands, paired_ref

    rows = []
    for label, p4, mask, scales in paired_cases(dg, params, model):
        got = paired_fwd(p4, mask, scales)
        again = paired_fwd(p4, mask, scales)
        want = paired_ref(p4, mask, scales)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paired_fwd {label}: two calls differ")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nnz = int(torch.count_nonzero(mask))
        nbytes = mask.numel() + p4.numel() * p4.element_size() + scales.numel() * 4 + n * h * 4
        flops = 4 * h * nnz  # two products over the mask's nonzeros
        row = dict(
            case=label, K=k, N=n, H=h, dtype=str(p4.dtype).replace("torch.", ""),
            max_abs_err=err, rel_err=err / scale,
            bitwise_repeat=True,
            ms=cuda_ms(lambda: paired_fwd(p4, mask, scales), reps=5),
            plain_ms=cuda_ms(lambda: paired_ref(p4, mask, scales), reps=3),
            library_ms=bmm_library_ms(mask, *paired_operands(p4, scales)),
            bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
            **sweep_fields("fwd", k, n, h, p4.device),
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
    """K5 and K5-bf16 against their plain versions on each case; K5-bf16
    also within ``SDDMM_BF16_TOL`` of K5.  Returns (f32 rows, bf16 rows)."""
    import torch

    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain

    rows_out = {"highest": [], "default": []}
    for label, zr, zc, ks, rows, cols, kw in sddmm_cases(dg, params, emb, splits, seed):
        scores = {}
        for precision, tag in (("highest", ""), ("default", ", bf16 tables")):
            def kernel():
                return sddmm_edges(zr, zc, ks, rows, cols, precision=precision, **kw)

            def plain():
                return sddmm_plain(zr, zc, ks, rows, cols, precision=precision, **kw)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            scores[precision] = got
            err = (got - want).abs().max().item()
            scale = max(1.0, want.abs().max().item())
            b, d = ks.numel(), zr.shape[1]
            itemsize = 2 if precision == "default" else 4
            tables = {t.data_ptr(): t.numel() * itemsize for t in (zr, zc, *kw.values())
                      if isinstance(t, torch.Tensor)}
            row = dict(
                case=label + tag, edges=b, d=d, max_abs_err=err, rel_err=err / scale,
                ms=cuda_ms(kernel, reps=10), plain_ms=cuda_ms(plain, reps=3),
                bytes_ms=(16 * b + sum(tables.values())) / HBM_BYTES_S * 1e3,
                ops_ms=sddmm_flops(kw["name"], ks, rows, zr.shape[0], d) / F32_FLOPS * 1e3,
            )
            if precision == "default":
                high = scores["highest"]
                row["rel_to_highest"] = ((got - high).abs().max() / high.abs().max()).item()
            log(json.dumps(row))
            if not row["rel_err"] <= SDDMM_REL_TOL:
                raise AssertionError(f"sddmm {label}{tag}: error {err:.3g} > {SDDMM_REL_TOL} x {scale:.3g}")
            if not row.get("rel_to_highest", 0.0) <= SDDMM_BF16_TOL:
                raise AssertionError(f"sddmm {label}{tag}: {row['rel_to_highest']:.3g} from "
                                     f"'highest', past {SDDMM_BF16_TOL}")
            rows_out[precision].append(row)
    return rows_out["highest"], rows_out["default"]


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
    for name in ("paired_fwd", "sddmm"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the serving path")
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


def _paired_bytes_ops(mask, k, h, n, in_bytes, out_bytes):
    """Least bytes (each input once, each output once) and operations
    (two products over the mask's nonzeros) of one paired call."""
    import torch

    nnz = int(torch.count_nonzero(mask))
    return mask.numel() + in_bytes + out_bytes + k * 4 * n * 4, 4 * h * nnz


def _bwd_hold(got, want, bf16):
    """(max abs error, error relative to the largest plain value); raises
    past the bound (module constants)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    top = want.abs().max().item()
    bound = PAIRED_REL_TOL * top + (BF16_ULP * want.abs() if bf16 else 0.0)
    if not bool((err <= bound).all()):
        raise AssertionError(f"relative error {err.max().item() / top:.3g} past the bound")
    return err.max().item(), err.max().item() / top


class Recorder:
    """Wraps the paired kernels' wrappers to keep the operands of the
    keep-scale forwards and of the backwards, one per (edge type, layer),
    while ``on`` (the operands themselves: a step does not change them,
    it makes new parameters)."""

    def __init__(self):
        import decagon_tpu_torch.ops.spmm_paired as sp

        self.sp = sp
        self.orig = (sp.paired_fwd, sp.paired_bwd)
        self._fwd, self._bwd = {}, {}
        self.on = False

        def fwd(p4, mask, scales, ds=None):
            if self.on and ds is not None:
                self._fwd.setdefault(mask.data_ptr(), (p4, mask, scales, ds))
            return self.orig[0](p4, mask, scales, ds)

        def bwd(ct, mask, scales, ds, out_dtype):
            if self.on and (mask.data_ptr(), ds is None) not in self._bwd:
                self._bwd[(mask.data_ptr(), ds is None)] = (
                    ct.detach().clone(), mask, scales, ds, out_dtype)
            return self.orig[1](ct, mask, scales, ds, out_dtype)

        sp.paired_fwd, sp.paired_bwd = fwd, bwd

    @property
    def fwd(self):
        return list(self._fwd.values())

    @property
    def bwd(self):
        return list(self._bwd.values())

    def close(self):
        self.sp.paired_fwd, self.sp.paired_bwd = self.orig


def _batch(splits, et, k, n, seed):
    import numpy as np
    import torch

    edges = splits[et + (k,)].train
    idx = np.random.default_rng(seed).integers(0, edges.shape[0], n)
    return (torch.from_numpy(edges[idx, 0].astype(np.int32)).cuda(),
            torch.from_numpy(edges[idx, 1].astype(np.int32)).cuda())


def _draws(dg, params, model, cfg, gen):
    """One step's dropout bits per layer and negative uniforms, drawn from
    ``gen``, for feeding two paths the same randomness."""
    import torch

    from decagon_tpu_torch.models.encoder import draw_layer_bits

    c = model.config
    bits = draw_layer_bits(params, dg, gen, c.dropout, c.spmm_impl, c.per_relation_dropout_max)
    return bits, torch.rand(cfg.batch_size, generator=gen, device=gen.device)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_leaves(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def timed_steps(step, params, state, dg, splits, et, n_steps, seed, step_no, on_step=None):
    """``n_steps`` calls of a ``make_train_step`` step on edge type ``et``,
    each timed on the host clock and split into forward, backward and Adam
    by CUDA events; ``on_step(i)`` runs before step ``i`` (and ``on_step(
    None)`` after it).  Returns (params, state, summary, next step_no)."""
    import statistics

    import torch

    from decagon_tpu_torch.train.step import step_generator

    times, splits_ms, losses = [], [], []
    for i in range(n_steps):
        k = i % dg.num_relations(et)
        rows, cols = _batch(splits, et, k, 512, seed + i)
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def marks(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        if on_step is not None:
            on_step(i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        events["start"].record()
        params, state, loss = step(params, state, dg, k, rows, cols,
                                   step_generator(seed, step_no, "cuda"), marks=marks)
        step_no += 1
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
        if on_step is not None:
            on_step(None)
        loss = float(loss)
        if not loss == loss or loss in (float("inf"), float("-inf")):
            raise AssertionError(f"train step {et} {i}: loss {loss} is not finite")
        losses.append(loss)
        splits_ms.append({
            "forward": events["start"].elapsed_time(events["forward"]),
            "backward": events["forward"].elapsed_time(events["backward"]),
            "adam": events["backward"].elapsed_time(events["update"]),
        })
        log(f"train {et} step {i} (relation {k}): loss {loss:.4f}, {times[-1]:.1f} ms "
            f"(forward {splits_ms[-1]['forward']:.1f}, backward "
            f"{splits_ms[-1]['backward']:.1f}, adam {splits_ms[-1]['adam']:.1f} ms, CUDA events)")
    rest = splits_ms[1:] or splits_ms
    summary = dict(
        steps=n_steps, losses=losses,
        step_ms_median_after_first=statistics.median(times[1:] or times),
        **{f"{p}_ms_median": statistics.median(x[p] for x in rest)
           for p in ("forward", "backward", "adam")},
    )
    log(f"train {et} summary {json.dumps(summary)}")
    return params, state, summary, step_no


def train(dg, params, model, splits, seed):
    """The training path through the entry points a user calls; returns
    (launch counts, recorder, summary)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step

    cfg = TrainConfig(batch_size=512, loss="hinge", adam_moments_dtype="bfloat16",
                      grad_dtype="bfloat16")
    opt = make_optimizer(cfg)
    state = opt.init(params)
    step_no = 0
    rec = Recorder()
    summary = {}

    def record_first(i):
        rec.on = i == 0

    cuda_build.reset_launches()
    for et, n_steps in TRAIN_STEPS.items():
        step = make_train_step(model, et, cfg, opt)
        params, state, summary[str(et)], step_no = timed_steps(
            step, params, state, dg, splits, et, n_steps, seed, step_no, on_step=record_first)
    counts = dict(cuda_build.LAUNCHES)
    rec.close()
    log(f"train launches {counts}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("paired_fwd", "paired_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the training path")
    if not all(r[3] is not None for r in rec.fwd) or len(rec.fwd) != 2 or len(rec.bwd) != 4:
        raise AssertionError(f"recorded {len(rec.fwd)} ds forwards, {len(rec.bwd)} backwards")
    return counts, rec, summary, params


def hold_gradients(label, got, want, tol=STEP_GRAD_TOL):
    """Each gradient leaf through the kernels against the plain versions',
    to ``tol`` of the leaf's largest magnitude; logs every leaf, then
    raises if any is past the bound.  Returns the worst relative error."""
    worst, bad = 0.0, []
    for name, w in want.items():
        err = (got[name].float() - w.float()).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        log(f"{label} {name}: max abs err {err:.3g}, {rel:.3g} of its max "
            f"(bound {tol:.3g})")
        if not rel <= tol:
            bad.append(name)
    if bad:
        raise AssertionError(f"{label}: {bad} past the bound")
    return worst


def step_gradients(dg, params, model, splits, seed):
    """One (1,1) step's loss and gradients through the kernels against the
    same step through the plain versions (``spmm_impl="paired_ref"``),
    with the same parameters, dropout bits and negatives."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.train.step import TrainConfig, make_loss_fn, value_and_grad

    cfg = TrainConfig(batch_size=512)
    plain = DecagonModel(dataclasses.replace(model.config, spmm_impl="paired_ref"), dg)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    bits, u = _draws(dg, params, model, cfg, gen)
    rows, cols = _batch(splits, (1, 1), 7, cfg.batch_size, seed + 100)
    out = []
    for m in (model, plain):
        loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, 7, rows, cols,
                                     None, None, layer_bits=bits, neg_u=u)
        out.append((float(loss), _leaves(grads)))
    (lk, gk), (lp, gp) = out
    log(f"step gradients: loss {lk:.6f} (kernels) {lp:.6f} (plain)")
    if not abs(lk - lp) <= STEP_GRAD_TOL * abs(lp):
        raise AssertionError("step loss differs between kernels and plain versions")
    return hold_gradients("step gradient", gk, gp)


def check_training_kernels(dg, rec):
    """K1/K2-ds and K3/K4 against their plain versions on the operands the
    first train step gave them, plus a K > 1, N > 4096 case."""
    import torch

    from decagon_tpu_torch.ops.spmm_paired import (
        paired_bwd, paired_bwd_operands, paired_bwd_ref, paired_fwd, paired_operands,
        paired_ref_ds,
    )

    names = {a.pair_mask.data_ptr(): key for key, a in dg.adj.items() if a.pair_mask is not None}
    fwd_rows, bwd_rows = [], []
    for p4, mask, scales, ds in rec.fwd:
        got = paired_fwd(p4, mask, scales, ds)
        again = paired_fwd(p4, mask, scales, ds)
        want = paired_ref_ds(p4, mask, scales, ds)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError("paired_fwd with keep-scales: two calls differ")
        err, rel = _bwd_hold(got, want, bf16=False)
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nbytes, flops = _paired_bytes_ops(mask, k, h, n, p4.numel() * 4 + ds.numel() * 4, n * h * 4)
        row = dict(case=f"({names[mask.data_ptr()]}) layer 1 f32, keep-scales", K=k, N=n, H=h,
                   max_abs_err=err, rel_err=rel, bitwise_repeat=bool(torch.equal(got, again)),
                   ms=cuda_ms(lambda: paired_fwd(p4, mask, scales, ds), reps=5),
                   plain_ms=cuda_ms(lambda: paired_ref_ds(p4, mask, scales, ds), reps=3),
                   library_ms=bmm_library_ms(mask, *paired_operands(p4, scales, ds)),
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
                   **sweep_fields("fwd", k, n, h, p4.device))
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        fwd_rows.append(row)

    g = torch.Generator().manual_seed(5)
    k, n, h = 3, 5000, 64
    big = dict(
        mask=(torch.rand((k, n, n), generator=g) < 0.01).to(torch.int8).cuda(),
        scales=torch.rand((k, 4, n), generator=g).cuda(),
        ds=torch.where(torch.rand((k, 2, n), generator=g) < 0.9, 1 / 0.9, 0.0).float().cuda(),
        ct=torch.randn((h, n), generator=g).cuda(),
    )
    cases = [(f"({names[r[1].data_ptr()]}) layer {1 if r[3] is not None else 2}, "
              f"{'keep-scales, f32' if r[3] is not None else 'bf16'}", *r) for r in rec.bwd]
    cases += [(f"synthetic K={k} N={n} {lbl}", big["ct"], big["mask"], big["scales"], d, dt)
              for lbl, d, dt in (("keep-scales, f32", big["ds"], torch.float32),
                                 ("bf16", None, torch.bfloat16))]
    for label, ct, mask, scales, ds, dt in cases:
        got = paired_bwd(ct, mask, scales, ds, dt)
        again = paired_bwd(ct, mask, scales, ds, dt)
        want = paired_bwd_ref(ct, mask, scales, ds, torch.float32)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"paired_bwd {label}: two calls differ")
        err, rel = _bwd_hold(got, want, bf16=dt == torch.bfloat16)
        kk, (h, n) = mask.shape[0], ct.shape
        out_bytes = 2 * kk * h * n * (2 if dt == torch.bfloat16 else 4)
        in_bytes = h * n * 4 + (ds.numel() * 4 if ds is not None else 0)
        nbytes, flops = _paired_bytes_ops(mask, kk, h, n, in_bytes, out_bytes)
        row = dict(case=label, K=kk, N=n, H=h, out=str(dt).replace("torch.", ""),
                   max_abs_err=err, rel_err=rel, bitwise_repeat=True,
                   ms=cuda_ms(lambda: paired_bwd(ct, mask, scales, ds, dt), reps=5),
                   plain_ms=cuda_ms(lambda: paired_bwd_ref(ct, mask, scales, ds, dt), reps=3),
                   library_ms=bmm_library_ms(
                       mask, *paired_bwd_operands(ct, scales, kk).flip(0)),
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3,
                   **sweep_fields("bwd", kk, n, h, ct.device))
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        if not label.startswith("synthetic"):
            bwd_rows.append(row)
    return fwd_rows, bwd_rows


def adam_steps(label, dg, splits, model, plain, grad_tol, n_steps=3):
    """``n_steps`` Adam steps on drug-drug along ``model``'s trajectory; at
    each step ``plain`` starts from the same parameters, optimizer state,
    dropout bits and negatives (each piece on the same inputs, as the
    small-input reference does).  The loss and each gradient leaf are held
    to ``grad_tol`` of the leaf's largest magnitude.  The updated
    parameters: Adam moves each element by up to about the learning rate
    whatever the gradient's size, so an element whose gradient is near 0
    can move in opposite directions on the two paths; the bound is 2 * lr
    per element (with 2^-10 of it for the f32 rounding of the update and of
    the sum), and the count of elements beyond 1e-4 of the leaf's max is
    printed."""
    import torch

    from decagon_tpu_torch.train.step import (
        TrainConfig, apply_optimizer, cast_grads, make_loss_fn, make_optimizer, value_and_grad,
    )

    params = model.init_params(torch.Generator().manual_seed(0), dg)
    cfg = TrainConfig(batch_size=64)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    bound = 2 * cfg.learning_rate * (1 + 2.0 ** -10)
    for s in range(n_steps):
        bits, u = _draws(dg, params, model, cfg, gen)
        k = s % dg.num_relations((1, 1))
        rows, cols = _batch(splits, (1, 1), k, cfg.batch_size, s)
        res = {}
        for name, m in (("kernels", model), ("plain", plain)):
            loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, k, rows, cols,
                                         None, None, layer_bits=bits, neg_u=u)
            new, new_state = apply_optimizer(opt, cfg, cast_grads(cfg, grads), state, params)
            res[name] = (float(loss), _leaves(grads), _leaves(new), new, new_state)
        (lk, gk, pk, params, state), (lp, gp, pp, _, _) = res["kernels"], res["plain"]
        worst = hold_gradients(f"{label} step {s} gradient", gk, gp, grad_tol)
        perr = max((pk[n] - w).abs().max().item() for n, w in pp.items())
        beyond = sum(int(((pk[n] - w).abs() > 1e-4 * w.abs().max()).sum()) for n, w in pp.items())
        total = sum(w.numel() for w in pp.values())
        log(f"{label} step {s}: loss {lk:.6f} / {lp:.6f} (kernels / plain); worst "
            f"gradient leaf error {worst:.3g} of its max; updated "
            f"parameters max abs err {perr:.3g} (bound {bound:.3g}), {beyond} of {total} "
            "beyond 1e-4 of their leaf's max")
        if not (abs(lk - lp) <= grad_tol * abs(lp) and perr <= bound):
            raise AssertionError(f"{label} step {s}: kernels and plain versions differ")


def small_training(device):
    """3 Adam steps through the paired kernels and through the plain
    versions (``adam_steps``), gradients to ``STEP_GRAD_TOL``."""
    import dataclasses

    from decagon_tpu_torch.models.model import DecagonModel

    _, splits, dg, model, _, _ = build_state(SMALL, device, seed=0)
    plain = DecagonModel(dataclasses.replace(model.config, spmm_impl="paired_ref"), dg)
    adam_steps("small training", dg, splits, model, plain, STEP_GRAD_TOL)


def _clone(tree, dtype=None):
    import torch

    if isinstance(tree, dict):
        return {key: _clone(value, dtype) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone() if dtype is None else tree.detach().to(dtype, copy=True)
    return tree


def trainer_phase(graph, splits, dg, model, seed, step_ms):
    """The ``Trainer`` at paper scale with the default configuration, in
    chunks; returns (launch counts, summary, trainer state)."""
    import torch

    from decagon_tpu_torch.bench import config_metrics, graph_nnz, steady_state_ms
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(batch_size=512, scan_chunk=TRAINER_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(model, graph, splits, dg, cfg, seed=seed)
    cuda_build.reset_launches()
    timing = steady_state_ms(trainer, TRAINER_CHUNK, TRAINER_WINDOWS)
    counts = dict(cuda_build.LAUNCHES)
    losses = timing.pop("losses")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"trainer losses not finite: {losses.tolist()}")
    summary = dict(
        steps=len(losses), chunk=TRAINER_CHUNK, first_losses=losses[:4].tolist(),
        last_losses=losses[-4:].tolist(), **config_metrics(graph_nnz(dg), timing),
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        single_step_ms_phase7=step_ms,
        chunk_minus_single_step_ms=timing["median_ms"] - step_ms,
        launches=counts,
    )
    log(f"trainer summary {json.dumps(summary)}")
    for name in ("paired_fwd", "paired_bwd"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the Trainer's path")
    if counts["adam"] != 0:
        raise AssertionError("the one-pass Adam launched with bf16 moments")
    return counts, summary, _clone(trainer.state_dict())


def check_adam(device):
    """K7 and its bf16 instantiation against the plain chain.  P6's case
    (``scripts/probe_adam_onepass.py``'s own) is timed with the launch
    counters set to 0 just before and read just after: its launches."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts.probe_adam_onepass import make_case, run_case, time_case

    cases = [
        ("paper leaf enc1/1,0 [1, 19081, 64] f32", (1, 19081, 64), torch.float32, 0, 20),
        ("P6 shape [1926, 64, 645] f32", (1926, 64, 645), torch.float32, 0, 10),
        ("P6 case [1926, 64, 645] bf16 g/m/v", (1926, 64, 645), torch.bfloat16, 0, 10),
        ("odd length 1,000,003 f32", (1_000_003,), torch.float32, 0, 20),
        ("view at offset 3, 1,048,581 f32", (1_048_581,), torch.float32, 3, 20),
    ]
    rows, p6_launches = [], None
    for label, shape, dtype, offset, iters in cases:
        case = make_case(shape, dtype, device, seed=len(rows), offset=offset)
        if dtype == torch.bfloat16:
            row = run_case(label, case, iters, time_it=False)
            cuda_build.reset_launches()
            time_case(row, case, iters)
            p6_launches = cuda_build.LAUNCHES["adam"]
        else:
            row = run_case(label, case, iters)
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        rows.append(row)
        torch.cuda.empty_cache()
    if not p6_launches:
        raise AssertionError("P6's probe path never launched the one-pass Adam")
    return rows, p6_launches


def pallas_trainer(graph, splits, dg, model, seed, state):
    """One chunk with ``pallas_adam`` (f32 moments and gradients) from a
    copy of ``state``, and the same chunk without it from another copy;
    returns the launch counts of the first."""
    import dataclasses

    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.timing import hard_sync
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    cfg = TrainConfig(batch_size=512, scan_chunk=PALLAS_CHUNK, pallas_adam=True,
                      adam_moments_dtype="float32", grad_dtype="float32")
    opt32 = {"m": _clone(state["opt_state"]["m"], torch.float32),
             "v": _clone(state["opt_state"]["v"], torch.float32), "t": state["opt_state"]["t"]}
    start = dict(state, opt_state=opt32)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for pallas in (True, False):
            trainer = Trainer(model, graph, splits, dg, dataclasses.replace(cfg, pallas_adam=pallas),
                              seed=seed, init_state=_clone(start))
            epoch = trainer.scheduler.epoch()
            batches = [next(epoch) for _ in range(PALLAS_CHUNK)]
            cuda_build.reset_launches()
            losses = trainer.train_chunk(batches, PALLAS_CHUNK)
            hard_sync(trainer.params)
            out[pallas] = (dict(cuda_build.LAUNCHES), losses.cpu(), _leaves(trainer.params),
                           _leaves(trainer.opt_state["m"]), _leaves(trainer.opt_state["v"]))
    finally:
        torch.use_deterministic_algorithms(False)
    (counts, lk, pk, mk, vk), (counts_plain, lp, pp, mp, vp) = out[True], out[False]
    log(f"pallas_adam chunk: launches {counts} (without: {counts_plain}); losses {lk.tolist()} "
        f"/ {lp.tolist()}")
    if counts["adam"] != PALLAS_CHUNK or counts_plain["adam"] != 0:
        raise AssertionError(f"one-pass Adam launched {counts['adam']} times in "
                             f"{PALLAS_CHUNK} steps (one eligible leaf a step)")
    worst, unequal = 0.0, []
    for kind, got, want in (("param", pk, pp), ("m", mk, mp), ("v", vk, vp)):
        for name, w in want.items():
            if torch.equal(got[name], w):
                continue
            unequal.append(f"{kind}{name}")
            err = (got[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
            worst = max(worst, err)
    log(f"pallas_adam chunk against the chain: {len(unequal)} leaves not bitwise equal "
        f"{unequal[:8]}, worst {worst:.3g} of the leaf's max (bound {PALLAS_REL_TOL})")
    if worst > PALLAS_REL_TOL or not torch.allclose(lk, lp, rtol=1e-5, atol=0.0):
        raise AssertionError("the chunk with the one-pass Adam differs from the chain's")
    return counts, dict(steps=PALLAS_CHUNK, launches=counts, bitwise_equal=not unequal,
                        unequal_leaves=unequal, worst_rel_err=worst)


def checkpoint_round_trip(trainer, evaluator, seed):
    """One ``MetricsLogger`` epoch with a ``Checkpointer`` (in a temporary
    directory), then a fresh ``Trainer`` restored from it: the same state,
    on the same device."""
    import tempfile

    import torch

    from decagon_tpu_torch.train.checkpoint import Checkpointer
    from decagon_tpu_torch.train.logger import MetricsLogger
    from decagon_tpu_torch.train.trainer import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(f"{tmp}/ck", max_to_keep=2, every_n_iterations=10**9)
        logger = MetricsLogger(evaluator, f"{tmp}/log", checkpointer=ck,
                               every_n_iterations=10**9, quiet=True)
        trainer.iteration_hook, trainer.epoch_hook = logger.on_iteration, logger.on_epoch_end
        trainer.train(num_epochs=1)
        logger.close()
        with open(logger.path) as f:
            lines = f.read().splitlines()
        fresh = Trainer(trainer.model, trainer.graph, trainer.splits, trainer.device_graph,
                        trainer.config, seed=seed + 1)
        if not fresh.try_resume(ck):
            raise AssertionError("no checkpoint to restore")
        saved, restored = trainer.state_dict(), fresh.state_dict()
        same = (saved["global_step"], saved["opt_step"]) == (restored["global_step"],
                                                             restored["opt_step"])
        for tree in ("params", "opt_state"):
            a, b = _leaves(saved[tree]), _leaves(restored[tree])
            same = same and a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) and a[k].device == b[k].device
                if isinstance(a[k], torch.Tensor) else a[k] == b[k] for k in a)
        log(f"metrics log {len(lines)} lines, last {lines[-1]!r}; checkpoint at step "
            f"{ck.latest_step()} restored equal: {same}")
        if not same or ck.latest_step() != trainer.global_step:
            raise AssertionError("checkpoint round trip differs")


def dummy_gate(device, seed):
    """The port's copy of the JAX package's dummy-config quality gate; its
    last epoch is ``checkpoint_round_trip``'s."""
    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig
    from decagon_tpu_torch.train.trainer import Trainer

    graph = make_synthetic_graph(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    dg = build_device_graph(graph, splits, device=device)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1), dg)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, num_epochs=1, scan_chunk=50)
    trainer = Trainer(model, graph, splits, dg, cfg, seed=seed)
    evaluator = AccuracyEvaluator(model, graph, splits, device=device)
    before = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc
    t = time.perf_counter()
    trainer.train(num_epochs=GATE_EPOCHS - 1)
    checkpoint_round_trip(trainer, evaluator, seed)
    after = evaluator.evaluate_all_drug_drug(trainer.params, dg, use_test=True).auroc
    log(f"dummy config: pooled test AUROC {before:.4f} untrained, {after:.4f} after "
        f"{GATE_EPOCHS} epochs ({trainer.global_step} steps, {time.perf_counter() - t:.1f}s)")
    if not (0.4 <= before <= 0.6 and after >= 0.62 and after > before + 0.05):
        raise AssertionError(f"dummy config outside the reference band: {before} -> {after}")
    return dict(auroc_untrained=before, auroc_trained=after, epochs=GATE_EPOCHS,
                steps=trainer.global_step)


def sparse_state(graph, splits, device):
    """Phase 3's host graph and split as the sparse regime builds them
    (``scripts/bench_sparse_regime.py`` ``paper_cap``): no dense or mask
    stack, the CSR layouts of K6 on every edge type, no fused stream."""
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.ops.tiling import tiling_stats

    before = torch.cuda.memory_allocated()
    t = time.perf_counter()
    dg = build_device_graph(graph, splits, densify_max_cells=0, tile_for_pallas=True,
                            build_fused=False, device=device)
    torch.cuda.synchronize()
    summary = dict(build_s=time.perf_counter() - t,
                   device_gib=(torch.cuda.memory_allocated() - before) / 2**30, layouts={})
    for key, adj in sorted(dg.adj.items()):
        for direction in ("fwd", "bwd"):
            stats = tiling_stats(getattr(adj, f"tiles_{direction}"))
            summary["layouts"][f"({key}) {direction}"] = stats
            log(f"({key}) {direction}: {json.dumps(stats)}")
    log(f"sparse device graph {summary['build_s']:.1f}s, {summary['device_gib']:.2f} GiB "
        f"on the card; max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dg, summary


def sparse_model(dg, precision, **kw):
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    kw = {"spmm_impl": "pallas", **kw}
    return DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1,
                                    spmm_precision=precision, **kw), dg)


def spmm_cases(dg, params):
    """(label, P_flat, layout) for every edge type, both layers, forward
    (the projected stack) and backward (a seeded cotangent over the
    transposed layout), with the sparse path's own operands."""
    import torch

    from decagon_tpu_torch.models.encoder import _project, encode_layer

    h1 = encode_layer(params, dg, "enc1", dg.features, True, "pallas")
    gen = torch.Generator(device=dg.device).manual_seed(11)
    cases = []
    for key, adj in sorted(dg.adj.items()):
        src = key.split(",")[1]
        for layer, level, feat in (("layer 1", "enc1", dg.features[src]), ("layer 2", "enc2", h1[src])):
            p = _project(feat, params[level][key])
            h = p.shape[-1]
            cases.append((f"({key}) {layer} forward", p.reshape(-1, h).contiguous(), adj.tiles_fwd))
            ct = torch.randn((adj.n_rows, h), generator=gen, device=dg.device)
            cases.append((f"({key}) {layer} backward", ct, adj.tiles_bwd))
    return cases


def check_spmm(dg, params):
    """K6 against its plain version at both precisions on each case of
    ``spmm_cases``: error, bitwise repeatability, CUDA-event ms of the
    kernel, the plain version and ``torch.sparse.mm`` on the same CSR (f32;
    timed here only), and the bounds.  Returns (f32 rows, bf16 rows)."""
    import torch

    from decagon_tpu_torch.ops.spmm_pallas import spmm_tiled, spmm_tiled_ref

    out = {"highest": [], "default": []}
    for label, p, tiles in spmm_cases(dg, params):
        csr = torch.sparse_csr_tensor(tiles.row_ptr, tiles.col, tiles.val,
                                      size=(tiles.n_dst, tiles.n_src))
        lib = torch.sparse.mm(csr, p)
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, p), reps=5)
        distinct = int(torch.unique(tiles.col).numel())
        e, h = tiles.nnz, p.shape[1]
        for precision in ("highest", "default"):
            got = spmm_tiled(p, tiles, precision)
            again = spmm_tiled(p, tiles, precision)
            want = spmm_tiled_ref(p, tiles, precision)
            torch.cuda.synchronize()
            top = max(want.abs().max().item(), 1e-30)
            err = (got - want).abs().max().item()
            itemsize = 2 if precision == "default" else 4
            nbytes = 8 * e + 4 * (tiles.n_dst + 1) + distinct * h * itemsize + tiles.n_dst * h * 4
            row = dict(
                case=label, precision=precision, rows=tiles.n_dst, nnz=e, H=h,
                distinct_sources=distinct, max_abs_err=err, rel_err=err / top,
                bitwise_repeat=bool(torch.equal(got, again)),
                ms=cuda_ms(lambda: spmm_tiled(p, tiles, precision), reps=5),
                plain_ms=cuda_ms(lambda: spmm_tiled_ref(p, tiles, precision), reps=2),
                library_ms=library_ms,
                library_rel_err=((lib - want).abs().max() / top).item(),
                bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=2 * e * h / F32_FLOPS * 1e3,
            )
            row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
            log(json.dumps(row))
            if not (row["rel_err"] <= SPMM_REL_TOL and row["bitwise_repeat"]):
                raise AssertionError(f"spmm_tiled {label} {precision}: error {row['rel_err']:.3g} "
                                     f"(bound {SPMM_REL_TOL}), repeat {row['bitwise_repeat']}")
            out[precision].append(row)
        del csr, lib
    return out["highest"], out["default"]


def sparse_training(graph, splits, dg, seed):
    """The sparse regime through the entry points a user calls, launch
    counters set to 0 first: ``make_train_step`` at "default" (2
    drug-drug steps, 1 PPI), the ``Trainer`` at both precisions (chunks of
    ``SPARSE_CHUNK``, one warm-up chunk and ``SPARSE_WINDOWS`` timed), and
    the pooled drug-drug evaluation with ``sddmm_precision="default"``.
    K6 and K5-bf16 must launch, the paired kernels never."""
    import torch

    from decagon_tpu_torch.bench import config_metrics, graph_nnz, steady_state_ms
    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step
    from decagon_tpu_torch.train.trainer import Trainer

    model = sparse_model(dg, "default", sddmm_precision="default")
    params = model.init_params(torch.Generator().manual_seed(seed), dg)
    cfg = TrainConfig(batch_size=512)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    summary, step_no = {"steps": {}, "trainer": {}}, 0
    cuda_build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for et, n_steps in SPARSE_TRAIN_STEPS.items():
        step = make_train_step(model, et, cfg, opt)
        params, state, summary["steps"][str(et)], step_no = timed_steps(
            step, params, state, dg, splits, et, n_steps, seed, step_no)
    summary["steps"]["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    step_launches = dict(cuda_build.LAUNCHES)
    nnz = graph_nnz(dg)
    for precision in ("default", "highest"):
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(sparse_model(dg, precision), graph, splits, dg,
                          TrainConfig(batch_size=512, scan_chunk=SPARSE_CHUNK), seed=seed)
        timing = steady_state_ms(trainer, SPARSE_CHUNK, SPARSE_WINDOWS)
        losses = timing.pop("losses")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError(f"sparse trainer ({precision}) losses not finite")
        summary["trainer"][precision] = dict(
            steps=len(losses), chunk=SPARSE_CHUNK, last_losses=losses[-4:].tolist(),
            **config_metrics(nnz, timing),
            peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        )
        log(f"sparse trainer ({precision}) {json.dumps(summary['trainer'][precision])}")
        del trainer
    t = time.perf_counter()
    scores = AccuracyEvaluator(model, graph, splits, device=dg.device).evaluate_all_drug_drug(
        params, dg)
    summary["eval_default"] = dict(auroc=scores.auroc, auprc=scores.auprc, apk=scores.apk,
                                   seconds=time.perf_counter() - t)
    counts = dict(cuda_build.LAUNCHES)
    summary["launches"] = counts
    summary["launches_per_step"] = {
        name: step_launches[name] / sum(SPARSE_TRAIN_STEPS.values()) for name in step_launches}
    log(f"sparse path: evaluation at sddmm 'default' {json.dumps(summary['eval_default'])}; "
        f"launches {counts} (the {sum(SPARSE_TRAIN_STEPS.values())} single steps: {step_launches})")
    if counts["spmm_tiled"] <= 0 or counts["sddmm_bf16"] <= 0:
        raise AssertionError(f"K6 or K5-bf16 never launched on the sparse path: {counts}")
    if counts["paired_fwd"] or counts["paired_bwd"]:
        raise AssertionError(f"a paired kernel launched on the sparse path: {counts}")
    if not all(0.0 <= v <= 1.0 for v in (scores.auroc, scores.auprc, scores.apk)):
        raise AssertionError(f"sparse evaluation metrics outside [0, 1]: {scores}")
    return counts, summary, params


def sparse_gradients(dg, params, splits, seed):
    """One drug-drug step's loss and gradients through K6 against its plain
    version ("pallas_ref") at both precisions, with the same bits and
    negatives; then the same step with ``remat`` against without it
    (the port's own draws from explicit generators): gradients, K6
    launches and peak memory of each."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig, make_loss_fn, value_and_grad

    cfg = TrainConfig(batch_size=512)
    rows, cols = _batch(splits, (1, 1), 7, cfg.batch_size, seed + 100)
    out = {}
    for precision in ("default", "highest"):
        model = sparse_model(dg, precision)
        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        bits, u = _draws(dg, params, model, cfg, gen)
        res = []
        for m in (model, sparse_model(dg, precision, spmm_impl="pallas_ref")):
            loss, grads = value_and_grad(make_loss_fn(m, (1, 1), cfg), params, dg, 7, rows, cols,
                                         None, None, layer_bits=bits, neg_u=u)
            res.append((float(loss), _leaves(grads)))
        (lk, gk), (lp, gp) = res
        log(f"sparse step gradients ({precision}): loss {lk:.6f} (K6) {lp:.6f} (plain)")
        tol = SPARSE_GRAD_TOL[precision]
        if not abs(lk - lp) <= tol * abs(lp):
            raise AssertionError(f"sparse step loss ({precision}) differs between K6 and plain")
        out[precision] = hold_gradients(f"sparse step gradient ({precision})", gk, gp, tol)
    remat = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for on in (False, True):
            model = sparse_model(dg, "default", remat=on)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            before = cuda_build.LAUNCHES["spmm_tiled"]
            loss, grads = value_and_grad(
                make_loss_fn(model, (1, 1), cfg), params, dg, 7, rows, cols,
                torch.Generator(device="cuda").manual_seed(seed + 7),
                torch.Generator(device="cuda").manual_seed(seed + 8))
            torch.cuda.synchronize()
            remat[on] = (float(loss), _leaves(grads), dict(
                peak_gib_above_start=(torch.cuda.max_memory_allocated() - base) / 2**30,
                spmm_tiled_launches=cuda_build.LAUNCHES["spmm_tiled"] - before))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, g0, m0), (l1, g1, m1) = remat[False], remat[True]
    worst = max((g1[n] - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
                for n, w in g0.items())
    equal = all(torch.equal(g1[n], w) for n, w in g0.items()) and l0 == l1
    out["remat"] = dict(loss=[l0, l1], bitwise_equal=equal, worst_rel_err=worst,
                        without=m0, with_remat=m1)
    log(f"remat: {json.dumps(out['remat'])}")
    if not (worst <= REMAT_TOL and abs(l0 - l1) <= REMAT_TOL * abs(l0)):
        raise AssertionError(f"remat changes the step: {worst:.3g} of a leaf's max")
    return out


def small_sparse(device):
    """On the small graph with every layout (tilings on every edge type and
    the fused stream): "pallas" and "fused_pallas" through K6 against
    "pallas_ref" / "fused_pallas_ref" at both precisions, layer by layer
    (layer 2 on K6's layer-1 output) to ``SPMM_REL_TOL`` of max(1, largest
    output); then 3 Adam steps with "fused_pallas" at "default" against
    its plain version (``adam_steps``)."""
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.encoder import encode_layer

    graph = make_polypharmacy_like_graph(**SMALL)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(graph, splits, tile_for_pallas=True, tile_even_if_dense=True,
                            device=device)
    for impl in ("pallas", "fused_pallas"):
        for precision in ("highest", "default"):
            model = sparse_model(dg, precision, spmm_impl=impl)
            params = model.init_params(torch.Generator().manual_seed(0), dg)
            kw = dict(spmm_precision=precision)
            h1 = encode_layer(params, dg, "enc1", dg.features, True, impl, **kw)
            h1_ref = encode_layer(params, dg, "enc1", dg.features, True, impl + "_ref", **kw)
            emb = encode_layer(params, dg, "enc2", h1, False, impl, **kw)
            emb_ref = encode_layer(params, dg, "enc2", h1, False, impl + "_ref", **kw)
            for label, got, want in (("layer 1", h1, h1_ref), ("layer 2", emb, emb_ref)):
                for key in want:
                    err = (got[key] - want[key]).abs().max().item()
                    bound = SPMM_REL_TOL * max(1.0, want[key].abs().max().item())
                    log(f"small sparse {impl} {precision} {label} {key}: max abs err {err:.3g} "
                        f"(bound {bound:.3g})")
                    if not (torch.isfinite(got[key]).all() and err <= bound):
                        raise AssertionError(f"small sparse {impl} {precision} {label} {key}")
    model = sparse_model(dg, "default", spmm_impl="fused_pallas")
    adam_steps("small sparse fused_pallas", dg, splits, model,
               sparse_model(dg, "default", spmm_impl="fused_pallas_ref"),
               SPARSE_GRAD_TOL["default"])


# Phase 18: the paired-kernel probes, each under its launch counter, with
# its source and the JAX probe it replaces.
PROBES = (
    ("probe_int8_bw", "decagon_tpu_torch/csrc/probe_int8_bw.cu", "scripts/probe_int8_bw.py:35"),
    ("probe_paired_parts", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_parts.py:36"),
    ("probe_paired_orient", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_orient.py:23"),
    ("probe_paired_bwd_idioms", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_bwd_idioms.py:16"),
    ("probe_paired_idioms", "decagon_tpu_torch/csrc/probe_paired.cu",
     "scripts/probe_paired_idioms.py:23"),
)
PROBE_REPS = 3


def probes(device, seed, paired_rows):
    """P1-P5 at the JAX probes' shapes: each kernel against its plain
    version (P5 bit for bit, the others by their stated rules) and two
    calls bitwise equal, P1's and P4's numpy oracles at K = 4; then, with
    the launch counters set to 0, each probe's timing path (CUDA events:
    kernel, plain version, ``torch.sum`` for P5), read just after.
    Returns the launch counts, each probe's rows, and the case that heads
    each probe's kernel entry (the int8 read at kb 2 beside ``torch.sum``,
    K1's work at kb 4, the TPU probes' K = 963 shapes)."""
    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.scripts import (
        probe_int8_bw as p5,
        probe_paired_bwd_idioms as p4b,
        probe_paired_idioms as p1,
        probe_paired_orient as p2,
        probe_paired_parts as p3,
        probing,
    )

    torch.cuda.empty_cache()
    g = torch.Generator(device=device).manual_seed(seed)
    m8 = p5.make_stack(device, seed)  # [964, 645, 645]: P5's stack, P2's and P3's mask
    m16 = m8.to(torch.bfloat16)
    p4 = torch.randn((2, p3.K, p3.H, p3.N), generator=g, device=device).to(torch.bfloat16)
    sc = p2.make_scales(device, seed, kpad=m8.shape[0], n=p3.N)
    k1 = p3.k1_kb(p3.K, p3.N, p3.H, device)
    small4 = p4b.numpy_inputs(seed=seed)
    small1 = p1.numpy_inputs(seed=seed)
    on = [torch.from_numpy(a).to(device) for a in (small4[0], small4[1].T.copy(), small4[2])]
    m963 = m8[:p4b.K_FULL]
    full4 = (m963, torch.randn((p4b.H, p4b.N), generator=g, device=device),
             torch.rand((p4b.K_FULL, 2, p4b.N), generator=g, device=device))
    _, pe_aug, po_aug = p1.device_inputs(device, seed=seed + 1)
    aug4 = (torch.from_numpy(small1[0]).to(device),
            torch.from_numpy(small1[5]).to(device, torch.bfloat16),
            torch.from_numpy(small1[6]).to(device, torch.bfloat16))
    groups = {
        "probe_int8_bw": p5.variants(m8, m16, p5.padded(m8)),
        "probe_paired_parts": p3.variants(m8, p4, kbs=(4, 8, k1)),
        "probe_paired_orient": p2.variants(
            m8, p4, sc, m16, sweep=(("both", (2, 4, 8)), ("xe_only", (4,)), ("xo_only", (4,)),
                                    ("small_t", (4, 8)))),
        "probe_paired_bwd_idioms": [p4b.variant(*on), p4b.variant(*full4)],
        "probe_paired_idioms": [p1.variant(*aug4, h=p1.H),
                                p1.variant(m963, pe_aug, po_aug, h=p1.H, kb=1),
                                p1.variant(m963, pe_aug, po_aug, h=p1.H, kb=k1)],
    }
    de, do = p4b.paired_bwd(*on)
    err4 = p4b.oracle_error(small4[0], small4[1], small4[2], de.float().cpu().numpy(),
                            do.float().cpu().numpy())
    err1 = p1.oracle_error(*small1[:5], p1.paired(*aug4, h=p1.H).cpu().numpy())
    log(f"numpy oracles at K = 4 (bound 2e-2, the JAX probes'): P4 {err4:.3g}, P1 {err1:.3g}")
    if not (err4 < 2e-2 and err1 < 2e-2):
        raise AssertionError("a probe misses its numpy oracle")
    checked = {name: {v.key: probing.check(v) for v in vs} for name, vs in groups.items()}
    cuda_build.reset_launches()
    timed = {name: [probing.time_variant(v, PROBE_REPS, plain_reps=1) for v in vs]
             for name, vs in groups.items()}
    counts = dict(cuda_build.LAUNCHES)
    rows = {}
    for name, vs in timed.items():
        if counts[name] <= 0:
            raise AssertionError(f"probe {name} never launched its kernel")
        rows[name] = [{**checked[name][t["case"]], **t} for t in vs]
        for r in rows[name]:
            log(f"{name} {json.dumps(r)}")
    k1_ms = {r["case"]: r["ms"] for r in paired_rows if r["case"].startswith("(1,1)")}
    parts = {r["case"]: r["ms"] for r in rows["probe_paired_parts"]}
    log(f"K1, the sweep design, at (1,1), phase 4: {json.dumps(k1_ms)} (layer 1 scales f32 "
        f"operands, layer 2 bf16); beside it P3, the former WMMA design at its {k1} "
        "relations a block, bf16 operands, no scales: "
        + ", ".join(f"{m} {parts[f'{m}_kb{k1}']:.3f}" for m in p3.MODES)
        + f" ms; P5 int8 read: {rows['probe_int8_bw'][0]['ms']:.3f} ms")
    log(f"probe launches {json.dumps({n: counts[n] for n in groups})}; max memory allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    heads = {"probe_int8_bw": "sum_int8_kb2", "probe_paired_parts": "two_dots_kb4",
             "probe_paired_orient": "both_i8_kb4",
             "probe_paired_bwd_idioms": f"paired_bwd_K{p4b.K_FULL}",
             "probe_paired_idioms": f"paired_K{p1.K_FULL}_kb1"}
    return counts, rows, heads


def kernel_entry(name, source, replaces, launches, rows, library_rows=None, cases=None):
    """One kernel's line of the report, its numbers summed over ``rows``;
    ``library_ms`` summed over ``library_rows`` (None: no library call
    computes the function)."""
    bytes_ms = sum(r["bytes_ms"] for r in rows)
    ops_ms = sum(r["ops_ms"] for r in rows)
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
        ms=sum(r["ms"] for r in rows), plain_ms=sum(r["plain_ms"] for r in rows),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None if library_rows is None else sum(r["library_ms"] for r in library_rows),
        cases=rows if cases is None else cases,
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
    smi = card()
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
    sddmm_rows, sddmm_bf16_rows = check_sddmm(dg, params, emb, splits, args.seed)
    del emb
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("serve")
    counts = serve(dg, params, evaluator)

    phase("small-input reference")
    small_reference(device)

    phase("train (paper scale)")
    train_counts, rec, train_summary, _ = train(dg, params, model, splits, args.seed)
    step_gradients(dg, params, model, splits, args.seed)

    phase("kernels against plain versions, training")
    fwd_ds_rows, bwd_rows = check_training_kernels(dg, rec)
    del rec
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("small-input training")
    small_training(device)

    phase("trainer (paper scale)")
    step_ms = train_summary[str((1, 1))]["step_ms_median_after_first"]
    trainer_counts, trainer_summary, state = trainer_phase(graph, splits, dg, model, args.seed,
                                                           step_ms)

    phase("one-pass Adam against plain versions")
    adam_rows, p6_launches = check_adam(device)

    phase("trainer with pallas_adam (paper scale)")
    pallas_counts, pallas_summary = pallas_trainer(graph, splits, dg, model, args.seed, state)
    del state
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("dummy config on the card")
    gate = dummy_gate(device, args.seed)

    phase("sparse state (paper scale)")
    del dg, evaluator, model, params
    torch.cuda.empty_cache()
    dg_sparse, sparse_summary = sparse_state(graph, splits, device)

    phase("K6 against its plain version")
    params_sparse = sparse_model(dg_sparse, "default").init_params(
        torch.Generator().manual_seed(args.seed), dg_sparse)
    spmm_rows, spmm_bf16_rows = check_spmm(dg_sparse, params_sparse)
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("sparse training (paper scale)")
    sparse_counts, sparse_train, params_sparse = sparse_training(graph, splits, dg_sparse,
                                                                 args.seed)
    sparse_train["gradients"] = sparse_gradients(dg_sparse, params_sparse, splits, args.seed)
    del dg_sparse, params_sparse

    phase("small-input sparse checks")
    small_sparse(device)

    phase("probes")
    probe_counts, probe_rows, probe_heads = probes(device, args.seed, paired_rows)

    phase("done")
    launches = {name: counts[name] + train_counts[name] + trainer_counts[name]
                + pallas_counts[name] + sparse_counts[name] for name in train_counts}
    log(f"launches on the main path: serve {counts}, train {train_counts}, trainer "
        f"{trainer_counts}, trainer with pallas_adam {pallas_counts}, sparse {sparse_counts}")
    # The one-pass Adam's line: the leaf the main path gives it, then the
    # other f32 cases (K7's contract); P6's bf16 case is listed beside them
    # (no library call takes bf16 moments with f32 parameters).
    k7_rows = [r for r in adam_rows if r["dtype"] == "float32"]
    report = {"kernels": [
        kernel_entry("paired_fwd", "decagon_tpu_torch/csrc/paired_fwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:82", launches["paired_fwd"],
                     paired_rows + fwd_ds_rows, library_rows=paired_rows + fwd_ds_rows),
        kernel_entry("paired_bwd", "decagon_tpu_torch/csrc/paired_bwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:182", launches["paired_bwd"],
                     bwd_rows, library_rows=bwd_rows),
        kernel_entry("sddmm", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", launches["sddmm"],
                     sddmm_rows),
        kernel_entry("sddmm_bf16", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", launches["sddmm_bf16"],
                     sddmm_bf16_rows),
        # K6: the top-level numbers sum the f32 ("highest") cases, the
        # function torch.sparse.mm computes; every case of both precisions
        # is listed.
        kernel_entry("spmm_tiled", "decagon_tpu_torch/csrc/spmm_tiled.cu",
                     "decagon_tpu/ops/spmm_pallas.py:42", launches["spmm_tiled"],
                     spmm_rows, library_rows=spmm_rows, cases=spmm_rows + spmm_bf16_rows),
        kernel_entry("adam", "decagon_tpu_torch/csrc/adam.cu",
                     "decagon_tpu/ops/optim.py:133", launches["adam"], k7_rows,
                     library_rows=k7_rows, cases=adam_rows),
        # P6: the bf16 instantiation of K7 at the probe's shape, its
        # launches those of its own timing path in phase 11.
        kernel_entry("probe_adam_onepass", "decagon_tpu_torch/csrc/adam.cu",
                     "scripts/probe_adam_onepass.py:26", p6_launches,
                     [r for r in adam_rows if r["dtype"] == "bfloat16"]),
    ] + [
        kernel_entry(name, source, replaces, probe_counts[name], head,
                     library_rows=head if name == "probe_int8_bw" else None,
                     cases=probe_rows[name])
        for name, source, replaces in PROBES
        for head in [[r for r in probe_rows[name] if r["case"] == probe_heads[name]]]
    ], "train": train_summary, "trainer": trainer_summary, "pallas_adam": pallas_summary,
        "dummy_gate": gate, "sparse_state": sparse_summary, "sparse_training": sparse_train}
    print(json.dumps(report))
    print(card())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
