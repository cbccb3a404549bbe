"""Training and evaluation: steps, the Trainer, checkpoints, the metrics log."""
