"""Weight initializers (Glorot & Bengio uniform).

Parity spec: reference ``decagon/deep/inits.py:5-12`` — uniform in
``[-sqrt(6/(fan_in+fan_out)), +sqrt(6/(fan_in+fan_out))]``.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def glorot(
    generator: torch.Generator,
    shape: Sequence[int],
    fan: Tuple[int, int],
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Glorot-uniform sample of ``shape`` with explicit (fan_in, fan_out),
    drawn from ``generator`` on the generator's device.

    ``fan`` is separate from ``shape`` because stacked per-relation weights
    use the per-matrix fan, and diagonal relation vectors use a (d, 1)
    fan (reference ``decagon/deep/layers.py:131-133, 158-160``)."""
    limit = math.sqrt(6.0 / (fan[0] + fan[1]))
    u = torch.rand(
        tuple(shape), generator=generator, dtype=dtype,
        device=generator.device,
    )
    return u * (2 * limit) - limit
