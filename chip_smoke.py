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
   bilinear mode over ~0.94M edges; errors, CUDA-event times, bounds;
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
   N > 4096 case; errors, bitwise repeatability, CUDA-event times and
   bounds;
9. small-input training: 3 Adam steps through the kernels and through
   the plain versions from the same state, bits and negatives.

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
TRAIN_STEPS = {(1, 1): 4, (0, 0): 2}

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

    from decagon_tpu_torch.models.encoder import layer_mask_spans, paired_edge_types

    paired = paired_edge_types(dg, model.config.spmm_impl)
    h1 = {str(t): torch.empty((n, model.config.hidden1)) for t, n in enumerate(dg.num_nodes)}
    bits = {}
    for level, inputs in (("enc1", dg.features), ("enc2", h1)):
        _, total = layer_mask_spans(params, dg, level, inputs, paired,
                                    model.config.per_relation_dropout_max)
        bits[level] = torch.rand(total, generator=gen, device=gen.device) < 1.0 - model.config.dropout
    u = torch.rand(cfg.batch_size, generator=gen, device=gen.device)
    return bits, u


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in tree:
            out.update(_leaves(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def train(dg, params, model, splits, seed):
    """The training path through the entry points a user calls; returns
    (launch counts, recorder, summary)."""
    import statistics

    import torch

    from decagon_tpu_torch.ops import cuda_build
    from decagon_tpu_torch.train.step import TrainConfig, make_optimizer, make_train_step

    cfg = TrainConfig(batch_size=512, loss="hinge", adam_moments_dtype="bfloat16",
                      grad_dtype="bfloat16")
    opt = make_optimizer(cfg)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rec = Recorder()
    summary = {}
    cuda_build.reset_launches()
    for et, n_steps in TRAIN_STEPS.items():
        step = make_train_step(model, et, cfg, opt)
        times, splits_ms, losses = [], [], []
        for i in range(n_steps):
            k = i % model.graph_meta.num_relations(et)
            rows, cols = _batch(splits, et, k, cfg.batch_size, seed + i)
            events = {"start": torch.cuda.Event(enable_timing=True)}

            def marks(name):
                events[name] = torch.cuda.Event(enable_timing=True)
                events[name].record()

            rec.on = i == 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            events["start"].record()
            params, state, loss = step(params, state, dg, k, rows, cols, gen, marks=marks)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            rec.on = False
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
        summary[str(et)] = dict(
            steps=n_steps, losses=losses,
            step_ms_median_after_first=statistics.median(times[1:] or times),
            **{f"{p}_ms_median": statistics.median(x[p] for x in rest)
               for p in ("forward", "backward", "adam")},
        )
        log(f"train {et} summary {json.dumps(summary[str(et)])}")
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


def hold_gradients(label, got, want):
    """Each gradient leaf through the kernels against the plain versions',
    to ``STEP_GRAD_TOL`` of the leaf's largest magnitude; logs every leaf,
    then raises if any is past the bound.  Returns the worst relative
    error."""
    worst, bad = 0.0, []
    for name, w in want.items():
        err = (got[name].float() - w.float()).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        worst = max(worst, rel)
        log(f"{label} {name}: max abs err {err:.3g}, {rel:.3g} of its max "
            f"(bound {STEP_GRAD_TOL:.3g})")
        if not rel <= STEP_GRAD_TOL:
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
        paired_bwd, paired_bwd_ref, paired_fwd, paired_ref_ds,
    )

    names = {a.pair_mask.data_ptr(): key for key, a in dg.adj.items() if a.pair_mask is not None}
    fwd_rows, bwd_rows = [], []
    for p4, mask, scales, ds in rec.fwd:
        got = paired_fwd(p4, mask, scales, ds)
        again = paired_fwd(p4, mask, scales, ds)
        want = paired_ref_ds(p4, mask, scales, ds)
        torch.cuda.synchronize()
        err, rel = _bwd_hold(got, want, bf16=False)
        k, h, n = p4.shape[1], p4.shape[2], p4.shape[3]
        nbytes, flops = _paired_bytes_ops(mask, k, h, n, p4.numel() * 4 + ds.numel() * 4, n * h * 4)
        row = dict(case=f"({names[mask.data_ptr()]}) layer 1 f32, keep-scales", K=k, N=n, H=h,
                   max_abs_err=err, rel_err=rel, bitwise_repeat=bool(torch.equal(got, again)),
                   ms=cuda_ms(lambda: paired_fwd(p4, mask, scales, ds), reps=5),
                   plain_ms=cuda_ms(lambda: paired_ref_ds(p4, mask, scales, ds), reps=3),
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3)
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
                   bytes_ms=nbytes / HBM_BYTES_S * 1e3, ops_ms=flops / BF16_FLOPS * 1e3)
        row["x_bound"] = row["ms"] / max(row["bytes_ms"], row["ops_ms"])
        log(json.dumps(row))
        if not label.startswith("synthetic"):
            bwd_rows.append(row)
    return fwd_rows, bwd_rows


def small_training(device):
    """3 Adam steps on drug-drug along the kernels' trajectory; at each
    step the plain versions start from the same parameters, optimizer
    state, dropout bits and negatives (each piece on the same inputs, as
    the small-input reference does).  The loss and each gradient leaf are
    held to ``STEP_GRAD_TOL`` of the leaf's largest magnitude.  The
    updated parameters: Adam moves each element by up to about the
    learning rate whatever the gradient's size, so an element whose
    gradient is near 0 can move in opposite directions on the two paths;
    the bound is 2 * lr per element (with 2^-10 of it for the f32
    rounding of the update and of the sum), and the count of elements
    beyond 1e-4 of the leaf's max is printed."""
    import dataclasses

    import torch

    from decagon_tpu_torch.models.model import DecagonModel
    from decagon_tpu_torch.train.step import (
        TrainConfig, apply_optimizer, cast_grads, make_loss_fn, make_optimizer, value_and_grad,
    )

    graph, splits, dg, model, params, _ = build_state(SMALL, device, seed=0)
    plain = DecagonModel(dataclasses.replace(model.config, spmm_impl="paired_ref"), dg)
    cfg = TrainConfig(batch_size=64)
    opt = make_optimizer(cfg)
    state = opt.init(params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    bound = 2 * cfg.learning_rate * (1 + 2.0 ** -10)
    for s in range(3):
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
        worst = hold_gradients(f"small training step {s} gradient", gk, gp)
        perr = max((pk[n] - w).abs().max().item() for n, w in pp.items())
        beyond = sum(int(((pk[n] - w).abs() > 1e-4 * w.abs().max()).sum()) for n, w in pp.items())
        total = sum(w.numel() for w in pp.values())
        log(f"small training step {s}: loss {lk:.6f} / {lp:.6f} (kernels / plain); worst "
            f"gradient leaf error {worst:.3g} of its max; updated "
            f"parameters max abs err {perr:.3g} (bound {bound:.3g}), {beyond} of {total} "
            "beyond 1e-4 of their leaf's max")
        if not (abs(lk - lp) <= STEP_GRAD_TOL * abs(lp) and perr <= bound):
            raise AssertionError(f"small training step {s}: kernels and plain versions differ")


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

    phase("train (paper scale)")
    train_counts, rec, train_summary, _ = train(dg, params, model, splits, args.seed)
    step_gradients(dg, params, model, splits, args.seed)

    phase("kernels against plain versions, training")
    fwd_ds_rows, bwd_rows = check_training_kernels(dg, rec)
    del rec
    log(f"max memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    phase("small-input training")
    small_training(device)

    phase("done")
    launches = {name: counts[name] + train_counts[name] for name in train_counts}
    log(f"launches on the main path: serve {counts}, train {train_counts}")
    report = {"kernels": [
        kernel_entry("paired_fwd", "decagon_tpu_torch/csrc/paired_fwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:82", launches["paired_fwd"],
                     paired_rows + fwd_ds_rows),
        kernel_entry("paired_bwd", "decagon_tpu_torch/csrc/paired_bwd.cu",
                     "decagon_tpu/ops/spmm_paired.py:182", launches["paired_bwd"],
                     bwd_rows),
        kernel_entry("sddmm", "decagon_tpu_torch/csrc/sddmm.cu",
                     "decagon_tpu/ops/sddmm_pallas.py:93", launches["sddmm"],
                     sddmm_rows),
    ], "train": train_summary}
    print(json.dumps(report))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
