"""Rank worlds for the mesh scripts: one process a rank, started, timed out
and collected in one place.

    results = run_world("decagon_tpu_torch.scripts.multihost_bench", 4, dict(nr=2, ne=2))

``run_world(module, n_ranks, kw)`` starts ``n_ranks`` processes, each
``python -m <module> worker <json>`` with the repo root as its working
directory and on its ``PYTHONPATH``; the JSON holds ``kw`` and the rank's
``rank``, ``n_ranks`` and ``port`` (one free localhost port a world, the
process group's address).  The module's ``worker`` entry (``worker`` here)
calls its ``rank_main(**kw)`` and prints one line ``RESULT <json>``.  The
parent waits for every rank within ``timeout`` seconds; a rank that fails,
prints no result or outlives the limit fails the world, and every rank still
running is killed.  ``pin=True`` runs rank ``r`` under ``taskset -c r`` where
``taskset`` exists (one core a rank).

``agree`` holds the ranks to one loss trace: every rank reports the mesh's
summed loss, so the traces must be equal, bit for bit.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORLD_TIMEOUT_S = 1500
RESULT = "RESULT "


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment of a spawned rank: the repo root first on
    ``PYTHONPATH``, no inherited ``torchrun`` variables."""
    out = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    out["PYTHONPATH"] = ROOT + os.pathsep + out.get("PYTHONPATH", "")
    out.update(env or {})
    return out


def run_world(module: str, n_ranks: int, kw: Optional[Dict] = None,
              timeout: float = WORLD_TIMEOUT_S, pin: bool = False,
              env: Optional[Dict[str, str]] = None) -> Dict[int, Dict]:
    """``{rank: rank_main(rank=..., n_ranks=..., port=..., **kw)}`` of
    ``module``, each rank a process of its own.  Raises with the failing
    rank's output tail, or ``TimeoutError``; no rank outlives the call."""
    port = free_port()
    taskset = pin and shutil.which("taskset") is not None
    cores = os.cpu_count() or 1
    procs: List[subprocess.Popen] = []
    try:
        for rank in range(n_ranks):
            args = dict(kw or {}, rank=rank, n_ranks=n_ranks, port=port)
            argv = [sys.executable, "-m", module, "worker", json.dumps(args)]
            if taskset:
                argv = ["taskset", "-c", str(rank % cores)] + argv
            procs.append(subprocess.Popen(argv, cwd=ROOT, env=rank_env(env),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        deadline = time.monotonic() + timeout
        results: Dict[int, Dict] = {}
        for rank, p in enumerate(procs):
            left = deadline - time.monotonic()
            try:
                out, _ = p.communicate(timeout=max(left, 0.1))
            except subprocess.TimeoutExpired:
                raise TimeoutError(f"{module}: rank {rank} of {n_ranks} gave no result within "
                                   f"{timeout} s") from None
            lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
            if p.returncode != 0 or len(lines) != 1:
                raise RuntimeError(f"{module}: rank {rank} of {n_ranks} exited "
                                   f"{p.returncode}:\n{out[-4000:]}")
            results[rank] = json.loads(lines[0][len(RESULT):])
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def worker(rank_main: Callable[..., Dict], arg: str) -> None:
    """A spawned rank: ``rank_main(**json.loads(arg))``, its result printed
    as the ``RESULT`` line."""
    result = rank_main(**json.loads(arg))
    print(RESULT + json.dumps(result), flush=True)


def is_worker(argv: Sequence[str]) -> bool:
    return len(argv) == 2 and argv[0] == "worker"


def agree(results: Dict[int, Dict], key: str = "losses"):
    """The one value (a loss, a trace) every rank reported under ``key``;
    raises if two ranks differ (each reports the mesh's sum)."""
    traces = {json.dumps(r[key]) for r in results.values()}
    if len(traces) != 1:
        raise AssertionError(f"the ranks disagree on the summed {key}: "
                             f"{ {rank: r[key] for rank, r in results.items()} }")
    return results[min(results)][key]


def join_group(rank: int, n_ranks: int, port: int, backend: str = "gloo") -> bool:
    """Join (or create) the world's process group; True if this call
    created it (the caller then destroys it with ``leave_group``).  A
    process whose group exists already (a rank of a larger harness) keeps
    it."""
    import torch.distributed as dist

    from decagon_tpu_torch.parallel.mesh import initialize_distributed

    if dist.is_initialized():
        if dist.get_world_size() != n_ranks or dist.get_rank() != rank:
            raise ValueError(f"the process group is rank {dist.get_rank()} of "
                             f"{dist.get_world_size()}, not {rank} of {n_ranks}")
        return False
    initialize_distributed(f"127.0.0.1:{port}", n_ranks, rank, backend=backend)
    return True


def leave_group(created: bool) -> None:
    import torch.distributed as dist

    if created and dist.is_initialized():
        dist.destroy_process_group()


def rank_device(device: str):
    """A rank's device: ``device`` as named (every gloo rank of a one-card
    machine shares ``cuda:0``), set current on the card."""
    import torch

    from decagon_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    return dev
