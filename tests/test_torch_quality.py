"""The port's copy of the dummy-config quality gate
(``tests/test_quality.py::test_dummy_config_learns_into_reference_band``).

Same graph, split, model and ``TrainConfig`` as the JAX package's test, and
the same three conditions on the pooled drug-drug test AUROC: untrained in
[0.4, 0.6], trained at least 0.62 and more than 0.05 above untrained.  The
random streams differ (Philox against threefry), so the port cannot
replay the JAX package's trajectory.  After 3 epochs, where the JAX test
reads, the port's pooled test AUROC passes 0.62 for only some trainer
seeds; after 8 epochs every seed swept clears it by 0.027 or more
(``python -m decagon_tpu_torch.scripts.quality_sweep --device cpu``;
numbers in ``PERF.md``).  So this copy trains 8 epochs.  It takes several
minutes on one CPU worker and is marked ``slow``; ``chip_smoke.py`` phase
13 runs it on the card.
"""

import pytest

from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph
from decagon_tpu_torch.models.model import DecagonModel, ModelConfig
from decagon_tpu_torch.train.evaluate import AccuracyEvaluator
from decagon_tpu_torch.train.step import TrainConfig
from decagon_tpu_torch.train.trainer import Trainer

EPOCHS = 8


@pytest.mark.slow
def test_dummy_config_learns_into_reference_band():
    graph = make_synthetic_graph(n_genes=500, n_drugs=400, n_drugdrug_types=3, seed=0)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.0, seed=1)
    device_graph = build_device_graph(graph, splits, device="cpu")
    model = DecagonModel(ModelConfig(hidden1=64, hidden2=32, dropout=0.1), device_graph)
    cfg = TrainConfig(batch_size=512, learning_rate=1e-3, num_epochs=1, scan_chunk=50)
    trainer = Trainer(model, graph, splits, device_graph, cfg, seed=0)
    evaluator = AccuracyEvaluator(model, graph, splits, device="cpu")
    before = evaluator.evaluate_all_drug_drug(trainer.params, device_graph, use_test=True)
    trainer.train(num_epochs=EPOCHS)
    after = evaluator.evaluate_all_drug_drug(trainer.params, device_graph, use_test=True)
    assert 0.4 <= before.auroc <= 0.6, f"untrained AUROC {before.auroc}"
    assert after.auroc >= 0.62, f"{EPOCHS}-epoch pooled test AUROC {after.auroc:.3f}"
    assert after.auroc > before.auroc + 0.05
