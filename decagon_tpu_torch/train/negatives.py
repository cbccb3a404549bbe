"""Degree-weighted negative sampling by inverse CDF.

Port of ``decagon_tpu/train/negatives.py`` (reference
``decagon/deep/optimizer.py:36-49``, ``tf.nn.fixed_unigram_candidate_sampler``
with distortion 0.75): row nodes are drawn from the relation's precomputed
CDF (``DeviceGraph.neg_cdf``) by a binary search of uniforms.
"""

from __future__ import annotations

from typing import Optional

import torch


def sample_unigram(
    generator: Optional[torch.Generator],
    cdf: torch.Tensor,
    num_samples: int,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Draw ``num_samples`` int32 indices from the distribution with CDF
    ``cdf`` ([N], nondecreasing, ending at 1.0).  ``u``: the uniforms in
    [0, 1) to use instead of drawing them from ``generator``."""
    if u is None:
        u = torch.rand(
            num_samples, generator=generator, dtype=cdf.dtype, device=generator.device
        )
    u = u.to(device=cdf.device, dtype=cdf.dtype)
    idx = torch.searchsorted(cdf, u, right=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1).to(torch.int32)
