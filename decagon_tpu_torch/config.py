"""Configuration: JSON settings file + command-line overrides.

Capability spec: reference ``main/Utils/Config.py`` + ``ArgParser.py`` —
a JSON settings file (``configuration.json``) whose values can be
overridden per-invocation from argv; ``getSetting`` raises on unknown
keys.  This implementation accepts arbitrary ``--set key=value``
overrides (the reference's parser only ever grew ``--config``) and maps
the reference's configuration.json key names onto the framework's model/
train configs so existing configs carry over.

Port of ``decagon_tpu/config.py``: the same keys and defaults build the
port's ``ModelConfig`` and ``TrainConfig``.  One key is the port's own:
``Device`` names the device the CLI runs on (unset: ``cuda``; e.g.
``--set Device=cpu``).
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

import torch

from decagon_tpu_torch import resolve_device
from decagon_tpu_torch.models.model import ModelConfig
from decagon_tpu_torch.train.step import TrainConfig


class Config:
    """Settings lookup: overrides first, then the JSON file."""

    def __init__(
        self,
        settings: Optional[Dict[str, Any]] = None,
        overrides: Optional[Dict[str, Any]] = None,
    ):
        self.settings = dict(settings or {})
        self.overrides = dict(overrides or {})

    @staticmethod
    def from_json(path: str, overrides: Optional[Dict[str, Any]] = None) -> "Config":
        with open(path) as f:
            return Config(json.load(f), overrides)

    @staticmethod
    def from_argv(argv: Optional[List[str]] = None) -> "Config":
        parser = argparse.ArgumentParser(
            description="Train a decagon_tpu_torch model from a JSON config."
        )
        parser.add_argument("--config", default="configuration.json")
        parser.add_argument(
            "--set",
            action="append",
            default=[],
            metavar="KEY=VALUE",
            help="override any config setting",
        )
        args = parser.parse_args(argv)
        overrides: Dict[str, Any] = {}
        for item in args.set:
            key, _, value = item.partition("=")
            try:
                overrides[key] = json.loads(value)
            except json.JSONDecodeError:
                overrides[key] = value
        return Config.from_json(args.config, overrides)

    def get(self, name: str, default: Any = ...) -> Any:
        if name in self.overrides:
            return self.overrides[name]
        if name in self.settings:
            return self.settings[name]
        if default is not ...:
            return default
        raise KeyError(f"Setting {name} not in overrides or config file")

    def has(self, name: str) -> bool:
        return name in self.overrides or name in self.settings

    # ---- typed views -----------------------------------------------------

    def device(self) -> torch.device:
        """``Device`` (unset: ``cuda``), as ``resolve_device`` checks it."""
        try:
            return resolve_device(self.get("Device", None))
        except RuntimeError as exc:
            raise RuntimeError(f"{exc} (in a config: Device=cpu)") from None

    def model_config(self) -> ModelConfig:
        return ModelConfig(
            hidden1=int(self.get("hidden1", 64)),
            hidden2=int(self.get("hidden2", 32)),
            dropout=float(self.get("dropout", 0.1)),
            spmm_impl=str(self.get("SpmmImpl", "auto")),
            spmm_precision=str(self.get("SpmmPrecision", "highest")),
            sddmm_impl=str(self.get("SddmmImpl", "auto")),
            remat=bool(self.get("Remat", False)),
        )

    def train_config(self) -> TrainConfig:
        return TrainConfig(
            batch_size=int(self.get("batch_size", 512)),
            learning_rate=float(self.get("learning_rate", 1e-3)),
            loss=str(self.get("Loss", "hinge")),
            margin=float(self.get("max_margin", 0.1)),
            neg_sample_size=int(self.get("neg_sample_size", 1)),
            neg_sample_weight=float(self.get("neg_sample_weights", 1.0)),
            num_epochs=int(self.get("NumEpochs", self.get("epochs", 50))),
            scan_chunk=int(self.get("ScanChunk", 0)),
            schedule=str(self.get("TrainSchedule", "reference")),
            relation_group=int(self.get("RelationGroup", 1)),
            lazy_decoder_adam=bool(self.get("LazyDecoderAdam", False)),
            shard_weights=bool(self.get("ShardWeights", True)),
            grad_reduce_dtype=str(self.get("GradReduceDtype", "float32")),
            adam_moments_dtype=str(
                self.get("AdamMomentsDtype", "float32")
            ),
        )
