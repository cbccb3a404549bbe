"""Raw read rate of the paper-scale int8 mask stack on the card (port of
the probe P5, ``scripts/probe_int8_bw.py``).

    python -m decagon_tpu_torch.scripts.probe_int8_bw

``pallas_sum(x, kb, conv)`` is the kernel of ``csrc/probe_int8_bw.cu``: the
column sums ``[1, n2]`` f32 of ``x [K, n1, n2]`` over the first
``kb * (K // kb)`` relations (the TPU probe's grid of ``K // kb`` blocks
of ``kb``), with ``x`` int8, int8 rounded through bf16 first (``conv``),
or bf16.  ``pallas_sum_ref`` is its plain version.  The sums are small
integers, exact in f32 in any order, so the kernel must equal the plain
version bit for bit.

``main`` runs the TPU probe's sweep on the card at its shapes: the int8
stack ``[964, 645, 645]`` (1% ones, from a seed) at ``kb`` 2 and 8, the
``conv`` form at 8, a bf16 copy at 2 and 8 and the stack pre-padded to
``[964, 672, 768]`` at 2 and 8.  Each kernel is checked against its plain
version, then timed with CUDA events beside ``torch.sum(x, dim=(0, 1),
dtype=torch.float32)``, the library call that computes the same function
(the TPU probe's ``xla_sum``; at ``kb = 2`` it covers the same 964
relations).  It prints the TPU probe's keys with ``pl_`` as ``cuda_`` and
``xla_`` as ``torch_``, each time in ms with its GB/s (10^9 bytes a second
over the bytes read), and last one JSON object naming the card.
"""

from __future__ import annotations

import json
import sys
from typing import List

import torch

from decagon_tpu_torch.ops import cuda_build
from decagon_tpu_torch.scripts import probing

K, N = 964, 645
PADDED = (672, 768)
DENSITY = 0.01
KBS = (2, 8)
MAX_N2 = 768  # MAX_N2 in the CUDA source
REPS = 10


def pallas_sum_ref(x: torch.Tensor, kb: int, conv: bool = False) -> torch.Tensor:
    """Plain version: ``[1, n2]`` f32 sums over relations and rows of the
    first ``kb * (K // kb)`` relations."""
    used = kb * (x.shape[0] // kb)
    part = x[:used]
    if conv:
        part = part.to(torch.bfloat16)
    return part.float().sum(dim=(0, 1)).reshape(1, -1)


def pallas_sum(x: torch.Tensor, kb: int, conv: bool = False) -> torch.Tensor:
    """The column sums of ``pallas_sum_ref``: through the CUDA kernel for
    a CUDA tensor (int8, or bf16 without ``conv``; contiguous, 16-byte
    aligned, rows of at most 768 elements, ``1 <= kb <= K``), through the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return pallas_sum_ref(x, kb, conv)
    if x.device.type != "cuda":
        raise ValueError(f"pallas_sum runs on cuda or cpu, not {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [K, n1, n2], got {tuple(x.shape)}")
    if x.dtype not in (torch.int8, torch.bfloat16) or (conv and x.dtype != torch.int8):
        raise TypeError(f"x must be int8 (or bf16 without conv), got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and start on a 16-byte boundary")
    k, n1, n2 = x.shape
    if not 1 <= n2 <= MAX_N2 or n1 < 1:
        raise ValueError(f"rows of 1..{MAX_N2} elements, got {tuple(x.shape)}")
    if not 1 <= kb <= k:
        raise ValueError(f"kb must be in 1..{k}, got {kb}")
    kind = 2 if x.dtype == torch.bfloat16 else int(conv)
    groups = k // kb
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        partial = torch.empty((groups, n2), dtype=torch.float32, device=x.device)
        out = torch.empty((1, n2), dtype=torch.float32, device=x.device)
        status = lib.dt_probe_column_sum(
            x.data_ptr(), kind, n1 * n2, n2, groups, kb, partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "probe_int8_bw")
    cuda_build.LAUNCHES["probe_int8_bw"] += 1
    return out


def make_stack(device, seed: int = 0, shape=(K, N, N)) -> torch.Tensor:
    """The int8 mask stack: ones with probability ``DENSITY``, from
    ``seed``, made on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand(shape, generator=g, device=device) < DENSITY).to(torch.int8)


def padded(x: torch.Tensor, shape=PADDED) -> torch.Tensor:
    """``x`` zero-padded to ``[K, *shape]``."""
    out = torch.zeros((x.shape[0], *shape), dtype=x.dtype, device=x.device)
    out[:, :x.shape[1], :x.shape[2]] = x
    return out


def summed_bytes(x: torch.Tensor, kb: int) -> int:
    """Bytes the sums need: the relations read once, the row written."""
    used = kb * (x.shape[0] // kb)
    return used * x.shape[1] * x.shape[2] * x.element_size() + x.shape[2] * 4


def variants(m8: torch.Tensor, m16: torch.Tensor, mpad: torch.Tensor,
             kbs=KBS) -> List[probing.Variant]:
    """The TPU probe's sweep over the int8 stack, its bf16 copy and its
    padded copy (keys without ``pl_``): int8 and bf16 at each ``kb``,
    ``conv`` at the largest, padded at each; ``torch.sum`` beside the
    variants at ``kb = 2``."""
    out = []

    def add(tag, x, kb, conv=False):
        library = None
        if kb == 2 and not conv and tag != "int8pad":
            library = lambda: torch.sum(x, dim=(0, 1), dtype=torch.float32)  # noqa: E731
        out.append(probing.Variant(
            key=f"sum_{tag}_kb{kb}", kernel=lambda: pallas_sum(x, kb, conv),
            plain=lambda: pallas_sum_ref(x, kb, conv), nbytes=summed_bytes(x, kb),
            flops=0, library=library, hold=probing.EQUAL,
        ))

    for kb in kbs:
        add("int8", m8, kb)
    add("int8conv", m8, max(kbs), conv=True)
    for kb in kbs:
        add("bf16", m16, kb)
    for kb in kbs:
        add("int8pad", mpad, kb)
    return out


def main() -> int:
    device = probing.require_card("probe_int8_bw")
    if device is None:
        return 1
    smi = probing.card()
    print(f"device: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.library()
    m8 = make_stack(device)
    m16 = m8.to(torch.bfloat16)
    mpad = padded(m8)
    rows = probing.run(variants(m8, m16, mpad), REPS, plain_reps=2)
    out = {"logical_gb": m8.numel() / 1e9}
    for r in rows:
        if r["library_ms"] is not None:
            tag = r["case"].split("_")[1]
            out[f"torch_sum_{tag}_ms"] = r["library_ms"]
            out[f"torch_sum_{tag}_gbps"] = r["gbps"] * r["ms"] / r["library_ms"]
        out[f"cuda_{r['case']}_ms"] = r["ms"]
        out[f"cuda_{r['case']}_gbps"] = r["gbps"]
    print(json.dumps({"probe": "int8_bw", "device": smi, "reps": REPS, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
