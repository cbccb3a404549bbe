"""The port's mesh through its entry points, in several processes on the
CPU: the CLI under ``torch.distributed.run`` (the counterpart of
``tests/test_parallel.py::test_cli_mesh_end_to_end_with_active_learning``)
and two ranks as two hosts (the counterpart of
``tests/test_multihost.py``).  A second file beside
``tests/test_torch_parallel.py`` so that the test runner's workers share
the spawned worlds' time.

The processes run with gloo and one CPU thread each; each run has a time
limit of its own and is killed when it runs out.  Tolerances: the two
ranks' summed losses are equal (the same all-reduce result on both); the
sharded embeddings match the single process to ``rtol=2e-5, atol=1e-6``,
as ``tests/test_parallel.py`` holds the JAX mesh's.
"""

import csv
import glob
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests import torch_mesh_ranks as ranks

ROOT = Path(__file__).resolve().parent.parent
RUN_TIMEOUT_S = 300


def _torchrun(conf_path, n=4):
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", "-m", "decagon_tpu_torch.cli", "--config", str(conf_path),
           "--set", "Device=cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(f"torchrun did not finish in {RUN_TIMEOUT_S} s:\n{out[-3000:]}")
    assert proc.returncode == 0, out[-5000:]
    return out


def test_cli_mesh_end_to_end_with_active_learning(tmp_path):
    """``MeshShape: [2, 2]`` with ``DistributedInit`` over four torchrun
    ranks: a masking active learner's outer loop driving the mesh trainer
    with checkpoints, then a resume run.  Only rank 0 writes: one
    iteration CSV per active-learning iteration."""
    conf = {
        "DataSetType": "DecagonDummyData",
        "ActiveLearnerType": "RandomMaskingActiveLearner",
        "InitialUnmaskedProportion": 0.5,
        "NumProteins": 60,
        "NumDrugs": 30,
        "NumDrugDrugRelationTypes": 1,
        "hidden1": 8,
        "hidden2": 4,
        "batch_size": 16,
        "NumEpochs": 1,
        "NumIterationsPerLog": 50,
        "TrainIterationResultDir": str(tmp_path / "results"),
        "ShouldCheckpoint": True,
        "CheckpointDirectory": str(tmp_path / "ck"),
        "NumIterationsPerCheckpoint": 4,
        "ValFraction": 0.1,
        "TestFraction": 0.05,
        "TestEdgeFilename": str(tmp_path / "edges.csv"),
        "MeshShape": [2, 2],
        "DistributedInit": True,
    }
    path = tmp_path / "conf.json"
    path.write_text(json.dumps(conf))
    out = _torchrun(path)
    logs = sorted(glob.glob(str(tmp_path / "results" / "decagon_iteration_results_*.csv")))
    iterations = out.count("=== active-learning iteration") // 4
    assert iterations >= 1 and len(logs) == iterations, (logs, out[-2000:])
    ids = []
    for log in logs:
        with open(log) as f:
            rows = list(csv.DictReader(f))
        assert rows and rows[-1]["EvaluateAll"] == "True"
        assert 0.0 <= float(rows[-1]["AUROC"]) <= 1.0
        ids.append(rows[0]["DataSetId"])
    assert len(set(ids)) == len(ids)
    assert len(glob.glob(str(tmp_path / "edges-*.csv"))) == iterations
    steps = os.listdir(tmp_path / "ck")
    assert steps and all(name.endswith(".pt") and name[:-3].isdigit() for name in steps)

    conf["ActiveLearnerType"] = "NoopActiveLearner"
    conf["ResumeFromCheckpoint"] = True
    path.write_text(json.dumps(conf))
    out = _torchrun(path)
    assert out.count("resumed from checkpoint at step") == 4, out[-3000:]

    # The mesh's checkpoint restores into the single-process export.
    from decagon_tpu_torch.predict import export

    export.main(["--config", str(path), "--set", "Device=cpu",
                 "--set", f"NpSaveDir={tmp_path / 'export'}"])
    emb = np.load(tmp_path / "export" / "embeddings.npy")
    assert emb.shape == (conf["NumDrugs"], conf["hidden2"]) and np.isfinite(emb).all()


@pytest.fixture(scope="module")
def two_hosts():
    return ranks.run_world(ranks.multihost_world, 2, env={"LOCAL_WORLD_SIZE": "1"}, init=False)


def test_two_ranks_as_two_hosts(two_hosts):
    """Two ranks, each a host (``LOCAL_WORLD_SIZE=1``), the ``row`` axis
    across them: one sharded step gives both the same summed loss, the
    sharded embedding the single process's."""
    assert two_hosts[0]["loss"] == two_hosts[1]["loss"] and np.isfinite(two_hosts[0]["loss"])
    for r in (0, 1):
        for key, want in two_hosts[r]["single_emb"].items():
            np.testing.assert_allclose(two_hosts[r]["emb"][key], want, rtol=2e-5, atol=1e-6)


def test_mesh_that_is_not_the_world_raises(two_hosts):
    """In a world of two: a (2, 2) mesh, an ``edge`` axis across hosts and
    another backend than the group's raise ``ValueError``."""
    for r in (0, 1):
        refused = two_hosts[r]["refused"]
        assert "needs 4 ranks" in refused["size"]
        assert "within" in refused["edge_across_hosts"]
        assert "backend" in refused["backend"]


def test_no_process_group_raises(monkeypatch):
    """Nothing falls back to one process: no group, no torchrun
    environment, or an unknown backend raise before any group exists."""
    import torch.distributed as dist

    from decagon_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    assert not dist.is_initialized()
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(shape=(1, 1))
    with pytest.raises(RuntimeError, match="torchrun"):
        initialize_distributed()
    with pytest.raises(ValueError, match="backend"):
        initialize_distributed("127.0.0.1:1", 1, 0, backend="mpi")
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("127.0.0.1:1")
    assert not dist.is_initialized()
