"""End-to-end training CLI.

Capability spec: reference ``main/main.py:74-91`` — config → dataset →
active learner → loop(get masked dataset → build trainable → train) —
plus the recorded held-out-edge CSV and checkpoint/metrics plumbing.

Port of ``decagon_tpu/cli.py``.  Usage::

    python -m decagon_tpu_torch.cli --config configuration.json
    python -m decagon_tpu_torch.cli --config conf.json --set NumEpochs=5
    python -m decagon_tpu_torch.cli --config conf.json --set Device=cpu

Config keys follow the reference's ``configuration.json`` (DataSetType,
ActiveLearnerType, hidden1/hidden2, dropout, batch_size, learning_rate,
max_margin, NumEpochs, TestSetProportion, InitTrainSetProportion,
CheckpointDirectory, TrainIterationResultDir, NumIterationsPerLog,
NumIterationsPerCheckpoint, MaxCheckpointsToKeep, TestEdgeFilename,
WriteNdarrays, NdarrayWriteDir, file paths for the public CSVs, …), as
in the JAX package.  The port adds ``Device`` (unset: ``cuda``): where
the JAX CLI asks its backend whether it runs on an accelerator (the CSR
layouts of ``SpmmImpl: "auto"``, the ``DenseFactored`` / ``DensePaired``
defaults), the port asks whether that device is not the CPU.
``ProfileDir`` records a ``torch.profiler`` trace.

Mesh: ``"MeshShape": [rows, edge_shards]`` trains over a (row, edge) mesh
(``decagon_tpu_torch.parallel``) of that many ranks, one process each;
``"DistributedInit": true`` first creates the process group from the
``torchrun`` environment (NCCL on cards, gloo on the CPU), and
``"MultiHostMesh": true`` keeps the ``edge`` axis within a host::

    python -m torch.distributed.run --nproc_per_node 4 -m decagon_tpu_torch.cli \
        --config conf.json --set 'MeshShape=[2,2]' --set DistributedInit=true

Every rank runs the same program; the iteration CSV, the held-out-edge
CSV, checkpoints and exports come from rank 0 only.

The dataset, the graph the model trains on (transposes,
``RenumberNodes``, the split) and its device graph are built by
``train/layout.py``, which ``predict.export`` builds through too: the
exported template has the trained layout (paired stacks on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from decagon_tpu_torch.config import Config
from decagon_tpu_torch.data.record import timestamped_path, write_heldout_edges_csv
from decagon_tpu_torch.graph.container import RelationGraph
from decagon_tpu_torch.models.model import DecagonModel
from decagon_tpu_torch.parallel.mesh import process_rank
from decagon_tpu_torch.train.checkpoint import Checkpointer
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.layout import (
    build_dataset,
    build_training_device_graph,
    training_graph,
)
from decagon_tpu_torch.train.logger import MetricsLogger
from decagon_tpu_torch.train.trainer import Trainer


def build_active_learner(config: Config, graph: RelationGraph):
    from decagon_tpu_torch import registry
    from decagon_tpu_torch.train.active import BaseActiveLearner

    kind = config.get("ActiveLearnerType", "NoopActiveLearner")
    seed = int(config.get("Seed", 0))
    if kind == "NoopActiveLearner":
        return registry.build(BaseActiveLearner, kind, graph=graph)
    kwargs = dict(
        graph=graph,
        test_set_proportion=float(config.get("TestSetProportion", 0.8)),
        init_train_proportion=float(config.get("InitTrainSetProportion", 1.0)),
        seed=seed,
    )
    if kind == "RelationFullMaskingLearner":
        kwargs["invalid_relations"] = set(
            config.get("InvalidRelationIds", [])
        )
    return registry.build(BaseActiveLearner, kind, **kwargs)


def build_mesh(config: Config, device: torch.device):
    """The (row, edge) mesh of ``MeshShape`` (None without it), after
    ``initialize_distributed`` when ``DistributedInit`` is set; the backend
    is NCCL on a card and gloo on the CPU."""
    if not config.has("MeshShape"):
        return None
    from decagon_tpu_torch.parallel.mesh import (
        default_backend,
        initialize_distributed,
        make_mesh,
    )

    backend = default_backend(device)
    if bool(config.get("DistributedInit", False)):
        initialize_distributed(backend=backend)
    return make_mesh(
        shape=tuple(int(x) for x in config.get("MeshShape")),
        multihost=bool(config.get("MultiHostMesh", False)),
        backend=backend,
    )


def train_once(
    config: Config,
    graph: RelationGraph,
    holdout,
    dataset_id: str,
    protein_ids,
    drug_ids,
    relation_names,
    learner=None,
) -> Trainer:
    device = config.device()
    mesh = build_mesh(config, device)
    model_cfg = config.model_config()
    train_cfg = config.train_config()
    seed = int(config.get("Seed", 0))

    tg = training_graph(config, graph, protein_ids, drug_ids, holdout)
    full, splits = tg.full, tg.splits
    if config.has("TestEdgeFilename") and process_rank() == 0:
        path = write_heldout_edges_csv(
            full, splits, timestamped_path(config.get("TestEdgeFilename")),
            protein_ids=tg.protein_ids, drug_ids=tg.drug_ids,
            relation_names=relation_names,
        )
        print(f"recorded held-out edges -> {path}")

    device_graph = build_training_device_graph(config, tg, device)
    model = DecagonModel(model_cfg, device_graph)

    checkpointer = None
    if bool(config.get("ShouldCheckpoint", False)):
        checkpointer = Checkpointer(
            config.get("CheckpointDirectory", "ckpts"),
            max_to_keep=int(config.get("MaxCheckpointsToKeep", 3)),
            every_n_iterations=int(config.get("NumIterationsPerCheckpoint", 1)),
        )

    trainer = Trainer(model, full, splits, device_graph, train_cfg, seed=seed, mesh=mesh)
    evaluator = AccuracyEvaluator(
        model, full, splits, apk_k=int(config.get("ApkRank", 50)),
        embed_fn=trainer.embed_fn, device=device,
    )
    logger = MetricsLogger(
        evaluator,
        result_dir=config.get("TrainIterationResultDir", "results"),
        dataset_id=dataset_id,
        every_n_iterations=int(config.get("NumIterationsPerLog", 1)),
        checkpointer=checkpointer,
        ndarray_dir=(
            config.get("NdarrayWriteDir", "ndarray-dump")
            if bool(config.get("WriteNdarrays", False))
            else None
        ),
        relation_names=relation_names,
        node_perms=tg.node_perms,
    )

    trainer.iteration_hook = logger.on_iteration
    trainer.epoch_hook = logger.on_epoch_end
    if checkpointer is not None and bool(
        config.get("ResumeFromCheckpoint", False)
    ):
        if trainer.try_resume(checkpointer):
            print(f"resumed from checkpoint at step {trainer.global_step}")
    profiler = None
    profile_dir = config.get("ProfileDir", None)
    if profile_dir:
        # torch.profiler trace (view with tensorboard or Perfetto); the
        # reference's only tracing was the wall-clock Latency CSV column
        # (SURVEY.md §5.1), which is written too.
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(profile_dir)),
        )
        profiler.start()
    if learner is not None and hasattr(learner, "scorer"):
        # Wire the greedy learner to the live model: ONE encoder forward
        # + one chunked scoring pass per selection round, regardless of
        # relation count.
        def batch_scorer(batches):
            emb = evaluator.embeddings(trainer.params, trainer.device_graph)
            return evaluator._probs_flat(
                trainer.params, emb, (1, 1), batches
            )

        def scorer(k: int, edges: np.ndarray) -> np.ndarray:
            return evaluator._probs(
                trainer.params, trainer.device_graph, (1, 1, k), edges
            )

        learner.scorer = scorer
        if hasattr(learner, "batch_scorer"):
            learner.batch_scorer = batch_scorer
    try:
        trainer.train()
    finally:
        if profiler is not None:
            profiler.stop()
        logger.close()
    return trainer


def main(argv=None) -> None:
    config = Config.from_argv(argv)
    graph, protein_ids, drug_ids, relation_names = build_dataset(config)
    learner = build_active_learner(config, graph)

    outer_iter = 0
    while learner.has_update():
        masked_graph, holdout = learner.get_update()
        dataset_id = f"{type(learner).__name__}-iter{outer_iter}"
        print(f"=== active-learning iteration {outer_iter} ===")
        train_once(
            config, masked_graph, holdout, dataset_id,
            protein_ids, drug_ids, relation_names, learner=learner,
        )
        outer_iter += 1


if __name__ == "__main__":
    main()
