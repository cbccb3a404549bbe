"""What the ported profilers and quality runs share: the card's fields of a
record, peak memory and the kernels' launch counts over a window.

Every record names the card it was taken on (``nvidia-smi``'s name and
power limit, the torch version) and, for each timed window, how many times
each hand-written kernel launched (``ops/cuda_build.LAUNCHES``), so a
reader knows which kernels a number went through.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from decagon_tpu_torch.ops import cuda_build


def device_name(device: torch.device) -> str:
    """The card's ``nvidia-smi`` name and power limit, or the device's name
    off the card."""
    if device.type != "cuda":
        return str(device)
    from decagon_tpu_torch.scripts.probing import card

    return card()


def card_fields(device: torch.device) -> Dict[str, str]:
    """``torch`` (its version) and ``device`` (``device_name``)."""
    return {"torch": torch.__version__, "device": device_name(device)}


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device: torch.device) -> Optional[float]:
    """``torch.cuda.max_memory_allocated`` in GiB since the last reset (None
    off the card)."""
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def launched() -> Dict[str, int]:
    """The kernels that launched since ``cuda_build.reset_launches()``, with
    their counts."""
    return {k: v for k, v in cuda_build.LAUNCHES.items() if v}


def per(counts: Dict[str, int], n: int) -> Dict[str, float]:
    """The non-zero counts divided by ``n`` (launches a step or a call)."""
    return {k: v / max(1, n) for k, v in counts.items() if v}


def write_json(path: str, record) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
