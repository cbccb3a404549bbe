"""decagon_tpu_torch: the PyTorch/CUDA port of ``decagon_tpu`` for NVIDIA Hopper.

Same layout as the JAX package (``graph/``, ``ops/``, ``models/``,
``train/``).  The port imports ``torch`` and never ``jax`` or anything of
``decagon_tpu``; the numpy-only host modules it needs are its own copies.

Every entry point takes a ``device`` argument and runs on ``cuda`` unless
the caller names another device: the hand-written kernels under ``csrc/``
run only there, and their plain PyTorch versions run for CPU tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` names
    another one.  Raises when CUDA is asked for (or defaulted to) and no
    card is present, so nothing falls back to the CPU silently.  A bare
    ``cuda`` in a rank of a multi-process run (``LOCAL_RANK`` set, as
    ``torchrun`` sets it) is that rank's card, ``cuda:{LOCAL_RANK}``.

    Also turns TF32 off for float32 products and convolutions: the port's
    plain versions are references, and TF32 keeps only ~3 decimal digits.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "decagon_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev
