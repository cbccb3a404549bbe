"""K6 (sparse SpMM) and K5 (edge scoring) at the paper's shapes, with the
schedule options K6 can take, optionally against another checkout's
kernels.

    python decagon_tpu_torch/scripts/probe_sparse_kernels.py [--tree DIR] [--windows 0,16384]
        [--out FILE]

The paper-scale polypharmacy-like graph (``chip_smoke.py``'s ``PAPER``),
split 5%/5% with seed 1, built as the sparse regime builds it (the CSR
layouts on every edge type, no dense or mask stack, no fused stream),
seeded random weights (hidden 64 -> 32).  Then, on the card:

* K6 on ``chip_smoke.py`` phase 15's cases (``probing.spmm_cases``: every
  edge type, both layers, the forward over the projected stack and the
  backward over a seeded cotangent): at "highest" and "default", with the
  forward layouts cut at each ``--windows`` value (0: no source windows;
  the backward layouts keep the default), and where the row pass copies
  the table into shared memory, also with the table read from device
  memory; ``torch.sparse.mm`` on the same CSR (f32) beside each case;
* K5 and K5-bf16 on phase 4's cases (``probing.sddmm_cases``: DEDICOM over
  the pooled drug-drug validation sweep, relation by relation, and in a
  shuffled order; bilinear over as many random PPI pairs on 2
  relations); K5-bf16 on f32 tables (cast in each call) and on bf16
  tables (cast once, as ``train/step.make_emb_scores`` passes them);
* K6's row pass with the table staged in shared memory and read from
  device memory, over synthetic rows at a range of table reuse
  (``time_staging``).

Each time is the mean over CUDA events around back-to-back calls
(``ms``, what ``chip_smoke.py`` reports: it includes the wrapper's host
cost where that exceeds the kernel), for K6 also the host's ms a call
(``host_ms``), and for K5 the device alone (``device_ms``: the calls
replayed as one CUDA graph).

``--tree DIR`` imports ``decagon_tpu_torch`` from another checkout (for
example an unpacked parent commit) and times its kernels on the same
cases (this checkout's ``probing.py``, loaded by path, builds them); only
the calls both versions share are made there (one layout, no windows; K5
on bf16 tables where its wrapper takes them).  Each case prints one JSON line; the last line is one JSON object
with all of them and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys
import time
from unittest import mock

PAPER = dict(
    n_proteins=19081, n_drugs=645, n_side_effects=963, min_edges_per_relation=500,
    total_drugdrug_edges=4_651_131, ppi_attachment=37, seed=7,
)
REPS = 20


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def _probing():
    """This checkout's ``scripts/probing.py``, loaded by path, so that
    ``--tree`` swaps the package under test and not the cases."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "probing.py")
    spec = importlib.util.spec_from_file_location("_probing_here", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # dataclasses look their module up there
    spec.loader.exec_module(module)
    return module


def state(device, seed=0):
    """(splits, sparse device graph, model, params) at paper scale; only
    calls that every version of the package takes."""
    import torch

    from decagon_tpu_torch.graph.device import build_device_graph
    from decagon_tpu_torch.graph.split import split_graph
    from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
    from decagon_tpu_torch.models.model import DecagonModel, ModelConfig

    t = time.perf_counter()
    graph = make_polypharmacy_like_graph(**PAPER)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    dg = build_device_graph(graph, splits, densify_max_cells=0, tile_for_pallas=True,
                            build_fused=False, device=device)
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1, spmm_impl="pallas"), dg)
    params = model.init_params(torch.Generator().manual_seed(seed), dg)
    torch.cuda.synchronize()
    _log(f"state {time.perf_counter() - t:.1f}s")
    return splits, dg, model, params


_REWINDOWED = {}


def rewindow(tiles, window):
    """The same edges cut at ``window`` source rows (this checkout's
    ``build_tiles`` only), built once a layout and window."""
    from decagon_tpu_torch.ops.tiling import build_tiles

    if window == tiles.window:
        return tiles
    key = (id(tiles), window)
    if key not in _REWINDOWED:
        _REWINDOWED[key] = build_tiles(
            tiles.col.cpu().numpy(), tiles.dst_index().cpu().numpy(), tiles.val.cpu().numpy(),
            tiles.n_src, tiles.n_dst, window=window,
        ).to(tiles.col.device)
    return _REWINDOWED[key]


def host_ms(fn, calls=REPS):
    """Host ms a call of ``fn`` over ``calls`` calls issued without a
    synchronisation (the wrapper's own cost, where the card keeps up)."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    took = time.perf_counter() - start
    torch.cuda.synchronize()
    return took / calls * 1e3


def _staged(tiles, p, precision):
    """Whether this checkout's K6 copies ``p`` into shared memory for the
    row pass of ``tiles``."""
    import torch

    from decagon_tpu_torch.ops import spmm_pallas

    sms = torch.cuda.get_device_properties(p.device).multi_processor_count
    return spmm_pallas.launch_plan(tiles, p.shape[1], p.data_ptr(), p.dtype == torch.bfloat16,
                                   precision == "default", sms)[2]


def _unstaged():
    """K6's launch plan with the row pass's table left in device memory."""
    from decagon_tpu_torch.ops import spmm_pallas

    return mock.patch.object(spmm_pallas, "_STAGE_BYTES", -1)


def time_spmm(probing, dg, params, windows, tag):
    import torch

    from decagon_tpu_torch.ops.spmm_pallas import spmm_tiled, spmm_tiled_ref

    rows = []
    for label, p, forward, tiles in probing.spmm_cases(dg, params):
        csr = torch.sparse_csr_tensor(tiles.row_ptr, tiles.col, tiles.val,
                                      size=(tiles.n_dst, tiles.n_src))
        library_ms = probing.cuda_ms(lambda: torch.sparse.mm(csr, p), reps=REPS)
        del csr
        layouts = {0: tiles} if windows is None else {
            w: rewindow(tiles, w) for w in (windows if forward else [tiles.window])
        }
        for precision in ("highest", "default"):
            want = spmm_tiled_ref(p, tiles, precision)
            top = want.abs().max().item()
            variants = [(f"window {w}", contextlib.nullcontext, t) for w, t in layouts.items()]
            if windows is not None and _staged(tiles, p, precision):
                variants.append(("table in device memory", _unstaged, tiles))
            for name, plan, t in variants:
                def fn(t=t, plan=plan):
                    with plan():
                        return spmm_tiled(p, t, precision)

                got, again = fn(), fn()
                torch.cuda.synchronize()
                row = dict(tree=tag, kernel="spmm_tiled", case=label, precision=precision,
                           variant=name, rows=tiles.n_dst, nnz=tiles.nnz, H=p.shape[1],
                           rel_err=(got - want).abs().max().item() / top,
                           bitwise_repeat=bool(torch.equal(got, again)),
                           ms=probing.cuda_ms(fn, reps=REPS), host_ms=host_ms(fn),
                           library_ms=library_ms)
                print(json.dumps(row), flush=True)
                rows.append(row)
            del want
        del layouts
    return rows


def time_staging(probing, reuses=(0.25, 0.5, 1, 2, 4, 8, 32)):
    """K6's row pass with the table staged in shared memory and read from
    device memory, on rows of 7 edges from the drug-drug backward's table
    shape ([645, 64] and [645, 32]), at ``reuse`` gathers of each table
    row for each SM's copy (``nnz = reuse * SMs * 645``): where staging
    starts to pay (``ops/spmm_pallas._STAGE_REUSE``).  Device ms (a
    replayed CUDA graph), so the wrapper's host cost stays out."""
    import numpy as np
    import torch

    from decagon_tpu_torch.ops import spmm_pallas
    from decagon_tpu_torch.ops.spmm_pallas import spmm_tiled
    from decagon_tpu_torch.ops.tiling import build_tiles

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    rows = []
    for reuse in reuses:
        nnz = int(reuse * sms * 645) // 7 * 7
        dst = np.repeat(np.arange(nnz // 7), 7)
        tiles = build_tiles(rng.integers(0, 645, nnz), dst,
                            rng.normal(size=nnz).astype(np.float32), 645, nnz // 7).to("cuda")
        for h in (64, 32):
            p = torch.randn((645, h), device="cuda")
            for precision in ("highest", "default"):
                plans = {"staged": lambda: mock.patch.object(spmm_pallas, "_STAGE_REUSE", 0),
                         "device memory": _unstaged}
                row = dict(kernel="spmm_tiled", case="staging", reuse=reuse, nnz=nnz, H=h,
                           precision=precision)
                for name, plan in plans.items():
                    def fn(plan=plan):
                        with plan():
                            return spmm_tiled(p, tiles, precision)

                    row[f"{name} device_ms"] = probing.device_ms([fn], REPS)
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


def time_sddmm(probing, splits, dg, model, params, tag):
    import torch

    from decagon_tpu_torch.ops.sddmm_pallas import sddmm_edges, sddmm_plain

    with torch.no_grad():
        emb = model.embeddings(params, dg)
    rows = []
    for label, zr, zc, ks, r, c, kw in probing.sddmm_cases(dg, params, emb, splits, 0,
                                                           shuffled=True):
        variants = [("highest", "f32 tables", lambda t: t), ("default", "f32 tables", lambda t: t),
                    # K5-bf16 as the scorer calls it, its tables cast once
                    ("default", "bf16 tables", lambda t: t.to(torch.bfloat16))]
        for precision, variant, table in variants:
            tr, tc = table(zr), table(zc)
            tkw = {k: table(v) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
            fn = lambda: sddmm_edges(tr, tc, ks, r, c, precision=precision, **tkw)  # noqa: E731
            try:
                got, again = fn(), fn()
            except ValueError as err:  # another tree's wrapper may take f32 tables only
                _log(f"{tag}: {label}, {variant}: {err}")
                continue
            want = sddmm_plain(zr, zc, ks, r, c, precision=precision, **kw)
            torch.cuda.synchronize()
            row = dict(tree=tag, kernel="sddmm", case=label, precision=precision,
                       variant=variant, edges=ks.numel(),
                       rel_err=(got - want).abs().max().item() / max(1.0, want.abs().max().item()),
                       bitwise_repeat=bool(torch.equal(got, again)),
                       ms=probing.cuda_ms(fn, reps=REPS), device_ms=probing.device_ms([fn], REPS))
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None, help="import decagon_tpu_torch from this checkout")
    ap.add_argument("--windows", default="0", help="K6 forward windows, comma-separated")
    ap.add_argument("--out", default=None, help="write the last line here too")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.tree) if args.tree else os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("probe_sparse_kernels: no CUDA device; the probe measures the card only",
              file=sys.stderr)
        return 1
    import decagon_tpu_torch

    probing = _probing()
    device = decagon_tpu_torch.resolve_device("cuda")
    tag = "tree " + (args.tree or "this checkout")
    _log(f"{tag}: {decagon_tpu_torch.__file__}")
    splits, dg, model, params = state(device)
    windows = None if args.tree else [int(w) for w in args.windows.split(",")]
    rows = time_spmm(probing, dg, params, windows, tag)
    rows += time_sddmm(probing, splits, dg, model, params, tag)
    bad = [r for r in rows if not (r["bitwise_repeat"] and r["rel_err"] <= 1e-5)]
    if not args.tree:
        rows += time_staging(probing)
    out = json.dumps({"card": probing.card(), "tree": tag, "rows": rows, "failed": len(bad)})
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
