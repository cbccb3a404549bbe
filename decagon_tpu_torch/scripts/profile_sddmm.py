"""Edge scoring's share of a paper-scale evaluation, the scorer K5 against
the plain scorer, and a warm pooled evaluation split into its parts.

    python -m decagon_tpu_torch.scripts.profile_sddmm [--device cpu] [--out PATH]

Port of ``scripts/profile_sddmm.py``: the paper graph (19,081 proteins,
645 drugs, 963 side effects of >= 500 edges, 4,651,131 drug-drug edges,
``ppi_attachment=37``, seed 7), split 5% / 5% (seed 1), the device graph
with bf16 dense stacks up to 10^9 cells and no fused stream, weights from
seed 0, and an evaluator on the plain scorer (``sddmm_impl="jnp"``).  Timed
(best of 5, each synced; the JAX script's fields): the encoder forward; the
flat scoring of every (1, 1) validation edge, cold (staging and upload
included) and warm; the pooled ``evaluate_all_drug_drug`` warm with its
host metrics.  On the card (the JAX script's TPU branches): the production
evaluator (``sddmm_impl="auto"``, ``sddmm_precision="default"``: K5-bf16)
end to end; K5 at "highest" and "default" on the flat stream against the
plain scorer; the bilinear K5-bf16 on random per-relation ``[d, d]``
matrices against a chunked gather of 65,536 edges at a time
(``ops/sddmm.sddmm_pairs``).  The JAX field names stay (``compiled_ms``:
the kernel's ms; ``xla_ms``: the chunked gather's); off the card those
entries read "not probed (cpu backend)", as in the JAX script.

Added (``evaluation_split``): a warm pooled evaluation of the validation
edges, on the production evaluator on the card, split into (a) staging: the
evaluator's ``_stage`` calls (its staged index tensors looked up); (b)
scoring: its scorer's device ms from CUDA events around each call
(K5-bf16 and the tables' bf16 casts; host ms off the card); (c) the
device-to-host copy of the probabilities and their split into relations
(what its ``_probs_flat`` calls hold beyond (a) and (b)); (d) the host
metrics (``train/evaluate.compute_scores``: AUROC and AUPRC off one sort,
AP@k).  Each part is the median over ``SPLIT_REPS`` calls of the
evaluator's own ``evaluate_all_drug_drug`` with clocks around those parts
(``other_ms``: the rest of the call, the edge lists' assembly and their
concatenation), whose scores must equal the evaluator's; they alternate
with as many calls without the clocks (``whole_ms_*``), the garbage
collector off.  ``parts_add_up`` (``split_checks``): in every clocked call
the parts and the rest add up to that call's total within 5%, and the
clocked calls' median lies within the unclocked calls' interquartile range
of theirs.

The record also names the card (``nvidia-smi`` name and power limit), the
torch version and the kernels' launches of each timed path.  Writes
``artifacts/perf/torch_sddmm_profile.json`` (``--out``).  Runs on CUDA
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts.records import card_fields, launched, per, write_json
from decagon_tpu_torch.timing import hard_sync
from decagon_tpu_torch.train import evaluate as evaluate_mod
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import make_generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "artifacts", "perf", "torch_sddmm_profile.json")

# The JAX script's configuration.
GRAPH = dict(n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
             total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7)
SPLIT = dict(val_frac=0.05, test_frac=0.05, seed=1)
DEVICE_GRAPH = dict(densify_max_cells=1_000_000_000, dense_dtype=torch.bfloat16,
                    build_fused=False)
GATHER_CHUNK = 65536
SPLIT_REPS = 15
# ``split_checks``: how far the parts and the rest of a clocked call may fall
# short of, or exceed, that call's total, as a share of it.
SPLIT_CALL_TOL = 0.05
NOT_PROBED = {"status": "not probed (cpu backend)"}


def timed(fn: Callable, *args, reps: int = 5):
    """Best seconds of ``reps`` synced calls after one, and the output."""
    out = fn(*args)
    hard_sync(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        hard_sync(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def split_once(ev: AccuracyEvaluator, params, dg, emb, use_test: bool = False):
    """One warm pooled evaluation through the evaluator's own
    ``evaluate_all_drug_drug``, with a clock around its parts: its
    ``_stage`` calls, its scorer's calls (CUDA events on the card, each
    call waited for), its ``_probs_flat`` calls (so the copy and the
    split into relations are what they hold beyond the two) and
    ``compute_scores``.  Returns (scores, ms of each part, the scorer's
    launches)."""
    on_card = emb[str(ev._drug_drug[0])].is_cuda
    et = ev._drug_drug
    ms = dict(staging=0.0, scoring_device=0.0, scoring_host=0.0, probs_flat=0.0, metrics=0.0)
    stage, probs_flat, score = ev._stage, ev._probs_flat, ev._score_fns[et]
    compute = evaluate_mod.compute_scores

    def clocked(key, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            ms[key] += (time.perf_counter() - t) * 1e3
            return out
        return run

    def scorer(*args):
        t = time.perf_counter()
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        out = score(*args)
        if on_card:
            end.record()
            end.synchronize()
            ms["scoring_device"] += start.elapsed_time(end)
        ms["scoring_host"] += (time.perf_counter() - t) * 1e3
        if not on_card:
            ms["scoring_device"] = ms["scoring_host"]
        return out

    ev._stage, ev._probs_flat = clocked("staging", stage), clocked("probs_flat", probs_flat)
    ev._score_fns = {**ev._score_fns, et: scorer}
    evaluate_mod.compute_scores = clocked("metrics", compute)
    cuda_build.reset_launches()
    try:
        t0 = time.perf_counter()
        scores = ev.evaluate_all_drug_drug(params, dg, use_test=use_test, embeddings=emb)
        total = (time.perf_counter() - t0) * 1e3
    finally:
        del ev._stage, ev._probs_flat
        ev._score_fns = {**ev._score_fns, et: score}
        evaluate_mod.compute_scores = compute
    copy = ms["probs_flat"] - ms["staging"] - ms["scoring_host"]
    parts = {"staging_ms": ms["staging"], "scoring_device_ms": ms["scoring_device"],
             "scoring_host_ms": ms["scoring_host"], "copy_ms": copy,
             "host_metrics_ms": ms["metrics"], "total_ms": total,
             "other_ms": total - ms["probs_flat"] - ms["metrics"]}
    return scores, parts, launched()


FOUR = ("staging_ms", "scoring_device_ms", "copy_ms", "host_metrics_ms")


def split_checks(runs, whole) -> Dict:
    """The two checks of a split (``runs``: the clocked calls' parts;
    ``whole``: the unclocked calls' ms, two or more).  In each clocked call
    the four parts and ``other_ms`` must add up to that call's own
    ``total_ms`` within ``SPLIT_CALL_TOL`` of it: the same call, so the
    host's noise cancels, and what is left is the scorer's host time beyond
    its device time.  The clocked calls' median total must lie within the
    unclocked calls' interquartile range of their median: the clocks must
    not change what they split."""
    residual = max(abs(r["total_ms"] - sum(r[k] for k in FOUR) - r["other_ms"]) / r["total_ms"]
                   for r in runs)
    q1, _, q3 = statistics.quantiles(whole, n=4)
    clocked = statistics.median(r["total_ms"] for r in runs)
    in_call = residual <= SPLIT_CALL_TOL
    in_whole = abs(clocked - statistics.median(whole)) <= q3 - q1
    return {"call_residual_share_max": residual, "parts_add_up_in_each_call": in_call,
            "clocked_total_ms_median": clocked, "whole_ms_q1": q1, "whole_ms_q3": q3,
            "clocked_within_whole_iqr": in_whole, "parts_add_up": in_call and in_whole}


def split_evaluation(ev: AccuracyEvaluator, params, dg, emb, use_test: bool = False,
                     reps: int = SPLIT_REPS) -> Dict:
    """The warm pooled evaluation's four parts (medians over ``reps``
    clocked calls) beside the evaluator's own time (``reps`` calls without
    the clocks), the two in turns, each first every other time, with the
    garbage collector off; ``split_checks``' verdict; raises if a clocked
    call's scores differ from the evaluator's."""
    want = ev.evaluate_all_drug_drug(params, dg, use_test=use_test, embeddings=emb)  # warm
    whole, runs, launches = [], [], None
    collecting = gc.isenabled()
    gc.disable()
    try:
        for rep in range(reps):
            for clocked in ((False, True) if rep % 2 else (True, False)):
                if clocked:
                    got, ms, launches = split_once(ev, params, dg, emb, use_test)
                    runs.append(ms)
                else:
                    t0 = time.perf_counter()
                    got = ev.evaluate_all_drug_drug(params, dg, use_test=use_test,
                                                    embeddings=emb)
                    whole.append((time.perf_counter() - t0) * 1e3)
                if (got.auroc, got.auprc, got.apk) != (want.auroc, want.auprc, want.apk):
                    raise AssertionError(f"evaluation scores {got} differ from {want}")
    finally:
        if collecting:
            gc.enable()
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return {
        **parts, "parts": list(FOUR), "parts_sum_ms": sum(parts[k] for k in FOUR),
        "whole_ms_median": statistics.median(whole), "whole_ms_min": min(whole),
        "whole_ms_max": max(whole), **split_checks(runs, whole),
        "whole_ms_runs": whole, "clocked_runs": runs,
        "reps": reps, "scoring_launches": launches,
        "edges": sum(e.shape[0] for key, sp in ev.splits.items() if key[:2] == ev._drug_drug
                     for e in ((sp.test, sp.test_false) if use_test else (sp.val, sp.val_false))),
        "auroc": want.auroc,
    }


def kernel_probe(ev, params, emb, batches, n_edges: int, dd=(1, 1)) -> Dict:
    """K5 at both precisions on the flat validation stream against the
    plain scorer (the JAX script's ``pallas_kernel_compiled``)."""
    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges

    dp = params["dec"]["1,1"]
    ks, rows, cols, _ = ev._stage(batches, cache_key=("prof", "flat"))
    z = emb["1"].contiguous()
    ref = ev._score_fns[dd](params, emb, ks, rows, cols).reshape(-1)[:n_edges]
    kernel = {}
    for precision in ("highest", "default"):
        def fn(precision=precision):
            return torch.sigmoid(sddmm_edges(z, z, ks, rows, cols, name="dedicom",
                                             glb=dp["global"], rel_diag=dp["local_diag"],
                                             precision=precision))
        cuda_build.reset_launches()
        t_k, out = timed(fn)
        got = out.reshape(-1)[:n_edges]
        kernel[precision] = {
            "compiled_ms": t_k * 1e3,
            "max_abs_prob_err_vs_jnp": float((got - ref).abs().max()),
            "launches_per_call": per(launched(), 6),
        }
    return kernel


def bilinear_probe(ev, emb, batches, n_edges: int, k_rel: int) -> Dict:
    """The bilinear K5-bf16 against a chunked gather, on random
    per-relation ``[d, d]`` matrices."""
    from decagon_tpu_torch.ops.sddmm import sddmm_pairs
    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges

    z = emb["1"].contiguous()
    d = z.shape[1]
    rng = np.random.default_rng(0)
    rel_full = torch.from_numpy(rng.standard_normal((k_rel, d, d)).astype(np.float32)).to(
        z.device)
    ks, rows, cols, _ = ev._stage(batches, cache_key=("prof", "flat"))

    def gather():
        with torch.no_grad():
            return torch.stack([
                sddmm_pairs(z[r.long()], z[c.long()], glb=rel_full[k.long()])
                for k, r, c in zip(ks.reshape(-1, GATHER_CHUNK), rows.reshape(-1, GATHER_CHUNK),
                                   cols.reshape(-1, GATHER_CHUNK))])

    def kernel():
        return sddmm_edges(z, z, ks, rows, cols, name="bilinear", rel_full=rel_full,
                           precision="default")

    t_x, out_x = timed(gather)
    cuda_build.reset_launches()
    t_k, out_k = timed(kernel)
    a, b = out_k.reshape(-1)[:n_edges], out_x.reshape(-1)[:n_edges]
    return {"xla_ms": t_x * 1e3, "kernel_bf16_ms": t_k * 1e3,
            "max_rel_err_vs_xla": float((a - b).abs().max() / (b.abs().max() + 1e-9)),
            "launches_per_call": per(launched(), 6)}


def profile_sddmm(device=None, graph_kw: Optional[Dict] = None, log=print) -> Dict:
    """The record; ``graph_kw`` defaults to the JAX script's graph."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    graph = make_polypharmacy_like_graph(**(graph_kw or GRAPH))
    splits = split_graph(graph, **SPLIT)
    dg = build_device_graph(graph, splits, device=device, **DEVICE_GRAPH)
    # The plain scorer (the JAX script forces its jnp path here; the
    # production evaluator is timed on the card below).
    model = DecagonModel(ModelConfig(spmm_impl="auto", sddmm_impl="jnp"), dg)
    params = model.init_params(make_generator(0, "cpu"), dg)
    ev = AccuracyEvaluator(model, graph, splits, device=device)

    t_embed, _ = timed(lambda: {k: v.sum() for k, v in ev._embed(params, dg).items()})
    emb = ev._embed(params, dg)
    log(f"encoder forward {t_embed * 1e3:.2f} ms")

    dd = (1, 1)
    batches = [(key[2], split.val) for key, split in splits.items() if key[:2] == dd]
    n_edges = sum(e.shape[0] for _, e in batches)
    t0 = time.perf_counter()
    hard_sync(ev._probs_flat(params, emb, dd, batches, cache_key=("prof", "val")))
    t_score_cold = time.perf_counter() - t0
    t_score, _ = timed(lambda: ev._probs_flat(params, emb, dd, batches,
                                              cache_key=("prof", "val")))
    ev.evaluate_all_drug_drug(params, dg, embeddings=emb)  # warm the staging
    t_all0 = time.perf_counter()
    scores = ev.evaluate_all_drug_drug(params, dg, embeddings=emb)
    t_all = time.perf_counter() - t_all0
    log(f"scoring warm {t_score * 1e3:.2f} ms, cold {t_score_cold * 1e3:.2f}; "
        f"evaluate_all warm {t_all * 1e3:.2f}")

    t_all_auto, kernel, bilinear, split_ev = None, dict(NOT_PROBED), dict(NOT_PROBED), None
    auto_launches = None
    ev_split = ev
    if on_card:
        model_auto = DecagonModel(ModelConfig(spmm_impl="auto", sddmm_impl="auto",
                                              sddmm_precision="default"), dg)
        ev_auto = AccuracyEvaluator(model_auto, graph, splits, device=device)
        emb_auto = ev_auto._embed(params, dg)
        ev_auto.evaluate_all_drug_drug(params, dg, embeddings=emb_auto)
        ev_auto.evaluate_all_drug_drug(params, dg, embeddings=emb_auto)
        cuda_build.reset_launches()
        t0 = time.perf_counter()
        ev_auto.evaluate_all_drug_drug(params, dg, embeddings=emb_auto)
        t_all_auto = time.perf_counter() - t0
        auto_launches = launched()
        ev_split, emb = ev_auto, emb_auto
        kernel = kernel_probe(ev, params, emb, batches, n_edges, dd)
        bilinear = bilinear_probe(ev, emb, batches, n_edges, dg.adj["1,1"].num_rel)
    split_ev = split_evaluation(ev_split, params, dg, emb)
    log(f"evaluation split: {json.dumps({k: split_ev[k] for k in split_ev['parts']})}, "
        f"sum {split_ev['parts_sum_ms']:.2f} against {split_ev['whole_ms_median']:.2f} "
        f"(interquartile {split_ev['whole_ms_q1']:.2f}-{split_ev['whole_ms_q3']:.2f}; "
        f"clocked {split_ev['clocked_total_ms_median']:.2f}), parts add up: "
        f"{split_ev['parts_add_up']}")

    share = t_score / (t_embed + t_score)
    best_kernel_ms = min((v["compiled_ms"] for v in kernel.values()
                          if isinstance(v, dict) and "compiled_ms" in v), default=None)
    parts = ", ".join(f"{k[:-3]} {split_ev[k]:.2f}" for k in split_ev["parts"])
    return {
        "relations": len(batches),
        "scored_edges_per_polarity": int(n_edges),
        "encoder_forward_ms": t_embed * 1e3,
        "sddmm_scoring_warm_ms": t_score * 1e3,
        "sddmm_scoring_cold_ms_incl_upload": t_score_cold * 1e3,
        "evaluate_all_warm_ms_incl_host_metrics": t_all * 1e3,
        "evaluate_all_warm_ms_production_auto": (
            t_all_auto * 1e3 if t_all_auto is not None else None),
        "sddmm_share_of_forward_plus_scoring": share,
        "pallas_kernel_compiled": kernel,
        "bilinear": bilinear,
        "kernel_vs_jnp_speedup": t_score * 1e3 / best_kernel_ms if best_kernel_ms else None,
        "verdict": (
            f"a warm pooled evaluation of {split_ev['edges']} edges on the "
            f"{'production' if on_card else 'plain'} evaluator takes "
            f"{split_ev['whole_ms_median']:.2f} ms (median of {split_ev['reps']}): {parts} ms "
            f"(sum {split_ev['parts_sum_ms']:.2f}; each clocked call's parts and rest "
            f"{'add' if split_ev['parts_add_up_in_each_call'] else 'do not add'} up to its "
            f"total within {SPLIT_CALL_TOL:.0%}, the clocked median "
            f"{split_ev['clocked_total_ms_median']:.2f} ms is "
            f"{'within' if split_ev['clocked_within_whole_iqr'] else 'outside'} the "
            f"interquartile range {split_ev['whole_ms_q1']:.2f}-{split_ev['whole_ms_q3']:.2f})"),
        "auroc_sanity": scores.auroc,
        "evaluation_split": split_ev,
        "production_auto_launches": auto_launches,
        "config": dict(graph=graph_kw or GRAPH, split=SPLIT,
                       device_graph=dict(DEVICE_GRAPH, dense_dtype="bfloat16")),
        **card_fields(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    result = profile_sddmm(args.device, log=lambda msg: print(msg, flush=True))
    write_json(args.out, result)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
