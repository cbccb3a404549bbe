"""Link-prediction losses.

Port of ``decagon_tpu/models/losses.py`` (reference
``decagon/deep/optimizer.py:108-127``): hinge pairs positive and negative
scores elementwise, ``sum(relu(neg - pos + margin))``; sigmoid
cross-entropy is ``sum(xent(pos, 1)) + w * sum(xent(neg, 0))``.  Both are
sums, not means.
"""

from __future__ import annotations

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` without a linear cut-over (``jax.nn.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def hinge_loss(pos: torch.Tensor, neg: torch.Tensor, margin: float = 0.1) -> torch.Tensor:
    return torch.sum(torch.relu(neg - pos + margin))


def xent_loss(
    pos: torch.Tensor, neg: torch.Tensor, neg_sample_weight: float = 1.0
) -> torch.Tensor:
    # -log sigmoid(pos) = softplus(-pos);  -log(1 - sigmoid(neg)) = softplus(neg)
    return torch.sum(_softplus(-pos)) + neg_sample_weight * torch.sum(_softplus(neg))


LOSSES = {"hinge": hinge_loss, "xent": xent_loss}
