"""Carry model parameters between the JAX package and the port.

Both packages keep one parameter layout, ``{"enc1": {etk: W}, "enc2":
{etk: W}, "dec": {etk: {"global" | "local_diag" | "relation_diag" |
"relation": A}}}``, including the paired ``[2, K/2, H, F]`` encoder stacks.
So a conversion only changes the container.  Both sides must use the same
``spmm_impl`` family: paired edge types store their weights transposed.
The fused Adam's state (``{"m", "v", "t"}``, moments possibly bf16)
converts the same way, so that a step can start from the same optimizer
state in both packages.
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
        return _tensor(node).to(dev)

    return conv(tree)


def _tensor(a) -> torch.Tensor:
    """numpy array (bf16 ones included, as ``jax.device_get`` returns
    them) -> CPU tensor of the same dtype."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def adam_state_from_numpy(state: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX ``fused_adam`` state (``m``, ``v`` nested dicts of numpy
    arrays, ``t`` a scalar) -> the port's ``ops/optim.fused_adam`` state."""
    return {
        "m": params_from_numpy(state["m"], device),
        "v": params_from_numpy(state["v"], device),
        "t": int(np.asarray(state["t"])),
    }


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's parameters -> nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {key: params_to_numpy(value) for key, value in params.items()}
    return params.detach().cpu().numpy()
