"""The converged quality runs of ``scripts/quality_run.py`` on the CPU, over
seeds, in either package: the JAX reference's own spread around the 0.74
gate, and the port against the JAX package on one platform, one seed and
one split.

    python -m tests.torch_quality_seeds [--package jax|torch] [--config dummy|poly50] \\
        [--seeds 0 1 2 3] [--max-epochs N] [--threads 2] [--out PATH]
    python -m tests.torch_quality_seeds --rule [--seeds 0 1 2 3 4 5 6 7]

Each seed runs its package's ``train_to_plateau`` (the JAX script's, loaded
by path, or ``decagon_tpu_torch/scripts/quality_run.py``'s with
``device="cpu"``; either CSV goes to a temporary directory, never over a
checked-in one) on the config's graph (``dummy``:
``make_synthetic_graph(500, 400, 3, seed=0)``, at most 200 epochs;
``poly50``: the 50-relation planted graph, at most 80), in a process of
its own with ``--threads`` CPU threads.  The seed is ``train_to_plateau``'s:
the trainer's and, plus one, the split's, so one seed gives both packages
the same validation and test edges.  Merges into
``artifacts/quality/<package>_cpu_<config>_seeds.json`` (or ``--out``) by
seed: a seed that is run again replaces its own entry, the others stay.
Per seed the record holds the CSV's rows, the epoch and the reason it
stopped, the final test AUROC and whether it clears the gate; the spread
is recomputed over every seed the record holds.  It lives with the tests
because it imports the JAX package, which the port never does.

``--rule`` runs nothing: it reads the port's card runs of the dummy config
(``artifacts/quality/torch_dummy{,_seedN}_metrics.csv``) and the JAX
package's CPU record (``jax_cpu_dummy_seeds.json``) for ``--seeds`` and
applies the rule ``gate_rule`` states, printing the table and the verdict
as one JSON object.
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


# The record's settings that a merged run must share with the record.
SHARED = ("package", "config", "graph", "max_epochs", "gate")


def summarize(runs) -> dict:
    finals = [r["final_test_auroc"] for r in runs]
    return dict(min=min(finals), max=max(finals), mean=statistics.fmean(finals),
                meeting_gate=sum(r["meets_gate"] for r in runs), seeds=len(runs))


def merge_record(record: dict, path: str) -> dict:
    """``record`` merged into the one at ``path`` (if there is one) by
    seed: its runs replace the old runs of the same seeds, the old runs of
    other seeds stay, runs are in seed order and the summary is over all
    of them.  Raises when the two records ran different settings."""
    runs = list(record["runs"])
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        for key in SHARED:
            if old["config"][key] != record["config"][key]:
                raise ValueError(f"{path} ran {key}={old['config'][key]!r}, "
                                 f"this run {record['config'][key]!r}")
        fresh = {r["seed"] for r in runs}
        runs += [r for r in old["runs"] if r["seed"] not in fresh]
    runs.sort(key=lambda r: r["seed"])
    return dict(record, runs=runs, final_test_auroc=summarize(runs))


def _card_rows(seed: int, art: str):
    tag = "dummy" if seed == 0 else f"dummy_seed{seed}"
    with open(os.path.join(art, f"torch_{tag}_metrics.csv")) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def gate_rule(seeds, art: str = ART) -> dict:
    """The dummy gate's rule over ``seeds``, each trained with seed N on
    split seed N + 1 in both packages (the port on the card, the JAX
    package on the CPU).

    (a) Validation AUROC at epoch 100, or, where a run stopped earlier, at
    the last epoch both packages evaluated; per seed d = port - JAX; the
    mean of the d must lie within two standard errors of 0 (sample
    standard deviation over sqrt(n)).  (b) Final test AUROC: the
    difference of the two packages' means must lie within two standard
    errors of that difference (Welch: sqrt(s_port^2 / n + s_jax^2 / n)).
    Beside (b), how many seeds meet the gate in each package."""
    with open(os.path.join(art, "jax_cpu_dummy_seeds.json")) as f:
        jax_runs = {r["seed"]: r for r in json.load(f)["runs"]}
    table = []
    for seed in seeds:
        port, ref = _card_rows(seed, art), jax_runs[seed]["rows"]
        port_val = {int(r["Epoch"]): r["ValAUROC"] for r in port}
        jax_val = {int(r["Epoch"]): r["ValAUROC"] for r in ref}
        both = sorted(set(port_val) & set(jax_val))
        epoch = 100 if 100 in both else both[-1]
        table.append(dict(seed=seed, epoch=epoch, val_port=port_val[epoch],
                          val_jax=jax_val[epoch], val_diff=port_val[epoch] - jax_val[epoch],
                          port_stop=int(port[-1]["Epoch"]), jax_stop=int(ref[-1]["Epoch"]),
                          test_port=port[-1]["TestAUROC"],
                          test_jax=jax_runs[seed]["final_test_auroc"]))
    n = len(table)
    diffs = [r["val_diff"] for r in table]
    mean_d = statistics.fmean(diffs)
    se_d = statistics.stdev(diffs) / n ** 0.5
    port_t, jax_t = [r["test_port"] for r in table], [r["test_jax"] for r in table]
    diff_t = statistics.fmean(port_t) - statistics.fmean(jax_t)
    se_t = (statistics.variance(port_t) / n + statistics.variance(jax_t) / n) ** 0.5
    a = dict(mean_diff=mean_d, se=se_d, holds=abs(mean_d) <= 2 * se_d)
    b = dict(mean_port=statistics.fmean(port_t), mean_jax=statistics.fmean(jax_t),
             diff=diff_t, se_welch=se_t, holds=abs(diff_t) <= 2 * se_t,
             meeting_gate_port=sum(t >= GATE for t in port_t),
             meeting_gate_jax=sum(t >= GATE for t in jax_t))
    return dict(seeds=list(seeds), table=table, a_validation=a, b_final_test=b,
                verdict=("not a fault" if a["holds"] and b["holds"] else
                         "fault" if not a["holds"] else "open"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="jax", choices=["jax", "torch"])
    ap.add_argument("--config", default="dummy", choices=sorted(GRAPHS))
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--max-epochs", type=int, default=None,
                    help="default: the JAX script's (dummy 200, poly50 80)")
    ap.add_argument("--threads", type=int, default=2, help="CPU threads of each seed's process")
    ap.add_argument("--out", default=None,
                    help="record to merge into (default artifacts/quality/"
                         "<package>_cpu_<config>_seeds.json)")
    ap.add_argument("--rule", action="store_true",
                    help="run nothing: apply the dummy gate's rule to the records")
    args = ap.parse_args(argv)
    if args.rule:
        print(json.dumps(gate_rule(args.seeds), indent=1))
        return 0
    max_epochs = args.max_epochs or MAX_EPOCHS[args.config]
    jobs = [dict(seed=s, package=args.package, config=args.config, max_epochs=max_epochs,
                 threads=args.threads) for s in args.seeds]
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        runs = pool.map(_run, jobs)
    import jax
    import torch

    record = dict(
        config=dict(package=args.package, config=args.config, graph=GRAPHS[args.config],
                    max_epochs=max_epochs, gate=GATE, threads=args.threads,
                    script=("scripts/quality_run.py" if args.package == "jax" else
                            "decagon_tpu_torch/scripts/quality_run.py") + " train_to_plateau"),
        platform="cpu", jax=jax.__version__, torch=torch.__version__, runs=runs)
    out = args.out or os.path.join(ART, f"{args.package}_cpu_{args.config}_seeds.json")
    record = merge_record(record, out)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    for r in runs:
        print(f"{args.package} {args.config} seed {r['seed']}: {r['stopped']}, final test "
              f"AUROC {r['final_test_auroc']:.5f} ({r['seconds']:.0f} s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
