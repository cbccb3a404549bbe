"""Offline prediction from exported checkpoint artifacts."""

from decagon_tpu_torch.predict.predictor import (  # noqa: F401
    NpPredictor,
    PredictionsInfo,
    TrainingEdgeIterator,
)
