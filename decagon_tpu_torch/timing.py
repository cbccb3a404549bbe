"""Timing helpers for the card.

PyTorch returns before the device finishes, so every host-clock timing
here ends in ``hard_sync``, which waits for the devices holding the
tensors it is given.
"""

from __future__ import annotations

import time

import torch


def _cuda_devices(tree, found):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for value in tree.values():
            _cuda_devices(value, found)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            _cuda_devices(value, found)
    return found


def hard_sync(tree) -> None:
    """Block the host until the work producing ``tree``'s CUDA tensors has
    run (``torch.cuda.synchronize`` on each of their devices)."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)


def timed_ms(fn, *args, reps: int = 8, warmup: int = 1) -> float:
    """Min-of-``reps`` wall time of ``fn(*args)`` in ms, each call synced
    (``hard_sync`` of its result)."""
    for _ in range(warmup):
        hard_sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        hard_sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3
