"""The converged quality runs of ``scripts/quality_run.py`` on the CPU, over
seeds, in either package: the JAX reference's own spread around the 0.74
gate, and the port against the JAX package on one platform, one seed and
one split.

    python -m tests.torch_quality_seeds [--package jax|torch] [--config dummy|poly50] \\
        [--seeds 0 1 2 3] [--max-epochs N] [--threads 2]

Each seed runs its package's ``train_to_plateau`` (the JAX script's, loaded
by path, or ``decagon_tpu_torch/scripts/quality_run.py``'s with
``device="cpu"``; either CSV goes to a temporary directory, never over a
checked-in one) on the config's graph (``dummy``:
``make_synthetic_graph(500, 400, 3, seed=0)``, at most 200 epochs;
``poly50``: the 50-relation planted graph, at most 80), in a process of
its own with ``--threads`` CPU threads.  The seed is ``train_to_plateau``'s:
the trainer's and, plus one, the split's, so one seed gives both packages
the same validation and test edges.  Writes
``artifacts/quality/<package>_cpu_<config>_seeds.json``: per seed the CSV's
rows, the epoch and the reason it stopped, the final test AUROC and
whether it clears the gate, and their spread.  It lives with the tests
because it imports the JAX package, which the port never does.
"""

import argparse
import csv
import importlib.util
import json
import multiprocessing
import os
import statistics
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(ROOT, "scripts", "quality_run.py")
ART = os.path.join(ROOT, "artifacts", "quality")
GRAPHS = {
    "dummy": dict(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0),
    "poly50": dict(n_proteins=2000, n_drugs=400, n_side_effects=50, seed=7, planted_rank=16),
}
MAX_EPOCHS = {"dummy": 200, "poly50": 80}
GATE = 0.74


def _graph(package: str, config: str, graph_kw):
    if package == "jax":
        from decagon_tpu.graph import synthetic
    else:
        from decagon_tpu_torch.graph import synthetic
    make = (synthetic.make_synthetic_graph if config == "dummy"
            else synthetic.make_polypharmacy_like_graph)
    return make(**(graph_kw or GRAPHS[config]))


def run_seed(seed: int, package: str = "jax", config: str = "dummy",
             max_epochs: int = None, graph_kw=None, eval_every: int = 5,
             threads: int = 2) -> dict:
    """One seed of ``package``'s ``train_to_plateau`` on the CPU: its rows
    (the CSV's columns, ``Seconds`` as the CPU's), where and why it
    stopped, its final test AUROC and the gate's verdict."""
    max_epochs = max_epochs or MAX_EPOCHS[config]
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(threads)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        graph = _graph(package, config, graph_kw)
        if package == "jax":
            spec = importlib.util.spec_from_file_location("_jax_quality_run", JAX_SCRIPT)
            q = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(q)
            q.ART_DIR = tmp
            path, (epoch, _, test) = q.train_to_plateau(
                f"seed{seed}", graph, max_epochs=max_epochs, seed=seed, eval_every=eval_every)
        else:
            from decagon_tpu_torch.scripts import quality_run

            path, (epoch, _, test) = quality_run.train_to_plateau(
                f"seed{seed}", graph, max_epochs=max_epochs, seed=seed, eval_every=eval_every,
                device="cpu", artifact_dir=tmp)
        with open(path) as f:
            rows = [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]
    return dict(seed=seed, rows=rows, epochs=epoch,
                stopped=("max_epochs reached" if epoch == max_epochs
                         else f"plateau at epoch {epoch}"),
                final_test_auroc=float(test.auroc), meets_gate=bool(test.auroc >= GATE),
                seconds=time.time() - t0)


def _run(job):
    return run_seed(**job)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="jax", choices=["jax", "torch"])
    ap.add_argument("--config", default="dummy", choices=sorted(GRAPHS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="default: the JAX script's (dummy 200, poly50 80)")
    ap.add_argument("--threads", type=int, default=2, help="CPU threads of each seed's process")
    args = ap.parse_args(argv)
    max_epochs = args.max_epochs or MAX_EPOCHS[args.config]
    jobs = [dict(seed=s, package=args.package, config=args.config, max_epochs=max_epochs,
                 threads=args.threads) for s in args.seeds]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        runs = pool.map(_run, jobs)
    finals = [r["final_test_auroc"] for r in runs]
    import jax
    import torch

    record = dict(
        config=dict(package=args.package, config=args.config, graph=GRAPHS[args.config],
                    max_epochs=max_epochs, gate=GATE, threads=args.threads,
                    script=("scripts/quality_run.py" if args.package == "jax" else
                            "decagon_tpu_torch/scripts/quality_run.py") + " train_to_plateau"),
        platform="cpu", jax=jax.__version__, torch=torch.__version__, runs=runs,
        final_test_auroc=dict(min=min(finals), max=max(finals),
                              mean=statistics.fmean(finals),
                              meeting_gate=sum(r["meets_gate"] for r in runs),
                              seeds=len(runs)))
    out = os.path.join(ART, f"{args.package}_cpu_{args.config}_seeds.json")
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    for r in runs:
        print(f"{args.package} {args.config} seed {r['seed']}: {r['stopped']}, final test "
              f"AUROC {r['final_test_auroc']:.5f} ({r['seconds']:.0f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
