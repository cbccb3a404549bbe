"""Carry model parameters between the JAX package and the port.

Both packages keep one parameter layout, ``{"enc1": {etk: W}, "enc2":
{etk: W}, "dec": {etk: {"global" | "local_diag" | "relation_diag" |
"relation": A}}}``, including the paired ``[2, K/2, H, F]`` encoder stacks.
So a conversion only changes the container.  Both sides must use the same
``spmm_impl`` family: paired edge types store their weights transposed.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from decagon_tpu_torch import DeviceLike, resolve_device


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays (e.g. ``jax.device_get`` of JAX params)
    -> the same nested dict of tensors on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {key: conv(value) for key, value in node.items()}
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return conv(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {key: params_to_numpy(value) for key, value in params.items()}
    return params.detach().cpu().numpy()
