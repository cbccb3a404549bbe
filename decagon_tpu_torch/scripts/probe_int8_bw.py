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

On the card ``kb`` decides only how many relations are read: the kernel
streams the used relations as one run of 16-byte vectors, on a grid of
the card's SMs times the blocks an SM holds (``kernel_info``), each block
an equal run of whole tiles of ``n2`` vectors (``column_sum_plan``), with
its loads software-pipelined, and adds the blocks' partial rows in a
fixed order in the same launch.  The ``conv`` variant converts each int8
word to bf16 with the paired sweep's own conversion (``s8x4_to_bf16`` of
``csrc/paired_core.cuh``) before it adds, so it reads what the main
path's conversion costs at the stream's rate.

``main`` runs the TPU probe's sweep on the card at its shapes: the int8
stack ``[964, 645, 645]`` (1% ones, from a seed) at ``kb`` 2 and 8, the
``conv`` form at 8, a bf16 copy at 2 and 8 and the stack pre-padded to
``[964, 672, 768]`` at 2 and 8.  Each kernel is checked against its plain
version, then timed with CUDA events beside ``torch.sum(x, dim=(0, 1),
dtype=torch.float32)``, the library call that computes the same function
(the TPU probe's ``xla_sum``; at ``kb = 2`` it covers the same 964
relations), and on the device alone (``device_ms``: the calls replayed from
a CUDA graph, so the wrapper's host time between a synchronize and the
first call stays out).  It prints the TPU probe's keys with ``pl_`` as
``cuda_`` and ``xla_`` as ``torch_``, each time in ms with its GB/s (10^9
bytes a second over the bytes read), the kernel's grid, and last one JSON
object naming the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import math
import sys
import types
from typing import Dict, List, Mapping

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


@dataclasses.dataclass(frozen=True)
class ColumnSumPlan:
    """How the kernel cuts the stream of ``total`` elements of the used
    relations: tiles of ``n2`` 16-byte vectors (``tile`` elements, vector
    ``t`` of every tile in the same columns), ``whole`` whole tiles, then
    ``ragged`` elements of a partial last tile (tile ``whole``); block ``b``
    of ``blocks`` reads the tiles ``tiles_of(b)``, every ``blocks``-th from
    ``b``; the last of each ``group`` blocks to finish adds the group's
    partial rows, the last of the ``groups`` groups adds theirs."""

    vector: int
    tile: int
    total: int
    whole: int
    ragged: int
    blocks: int
    group: int
    groups: int

    def tiles_of(self, block: int) -> range:
        return range(block, self.whole + (self.ragged > 0), self.blocks)


def column_sum_plan(used: int, plane: int, n2: int, elem_bytes: int,
                    blocks: int) -> ColumnSumPlan:
    """The cut of ``column_sum_kernel`` (``csrc/probe_int8_bw.cu``) for
    ``used`` relations of ``plane`` elements in rows of ``n2``, of
    ``elem_bytes`` bytes each, on a grid of ``blocks``."""
    if elem_bytes not in (1, 2) or not 1 <= n2 <= MAX_N2 or plane % n2 or used < 1 or \
            blocks < 1:
        raise ValueError(f"no plan for used={used}, plane={plane}, n2={n2}, "
                         f"elem_bytes={elem_bytes}, blocks={blocks}")
    vector = 16 // elem_bytes
    tile = n2 * vector
    whole, ragged = divmod(used * plane, tile)
    group = combine_group(blocks)
    return ColumnSumPlan(vector=vector, tile=tile, total=used * plane, whole=whole,
                         ragged=ragged, blocks=blocks, group=group, groups=-(-blocks // group))


def combine_group(blocks: int) -> int:
    """Blocks a first-level combine adds: ``ceil(sqrt(blocks))``, so that
    neither level adds more rows than that (the kernel's ``group``)."""
    return math.isqrt(blocks - 1) + 1


@functools.lru_cache(maxsize=None)
def kernel_info(kind: int, device_index: int) -> Mapping[str, int]:
    """What the card gives the kernel of ``kind`` (0 int8, 1 conv, 2 bf16):
    registers a thread, resident blocks an SM, the SMs, local and shared
    bytes, and the grid (SMs x blocks an SM); queried once a device."""
    info = (ctypes.c_int * 5)()
    lib = cuda_build.library()
    with torch.cuda.device(device_index):
        status = lib.dt_probe_column_sum_info(kind, ctypes.addressof(info))
    cuda_build.check(status, "probe_int8_bw info")
    return types.MappingProxyType(dict(
        registers=info[0], blocks_per_sm=info[1], sms=info[2], local_bytes=info[3],
        shared_bytes=info[4], grid=info[1] * info[2]))


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
    blocks = kernel_info(kind, x.device.index)["grid"]
    groups = -(-blocks // combine_group(blocks))
    lib = cuda_build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = torch.empty((blocks + groups, n2), dtype=torch.float32, device=x.device)
        # The combine's counters, zeroed for every call: no launch depends
        # on what an earlier one (or a graph replayed beside it) left.
        count = torch.zeros(groups + 1, dtype=torch.int32, device=x.device)
        out = torch.empty((1, n2), dtype=torch.float32, device=x.device)
        status = lib.dt_probe_column_sum(
            x.data_ptr(), kind, n1 * n2, n2, k // kb, kb, blocks, partial.data_ptr(),
            count.data_ptr(), out.data_ptr(), stream,
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


def device_rows(vs: List[probing.Variant], iters: int = REPS) -> Dict[str, Dict[str, float]]:
    """Each variant's kernel on the device alone (the better of two
    replays): ms and GB/s."""
    out = {}
    for v in vs:
        ms = min(probing.device_ms([v.kernel], iters) for _ in range(2))
        out[v.key] = dict(device_ms=ms, device_gbps=v.nbytes / ms / 1e6)
    return out


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
    vs = variants(m8, m16, mpad)
    rows = probing.run(vs, REPS, plain_reps=2)
    alone = device_rows(vs)
    out = {"logical_gb": m8.numel() / 1e9,
           "grid": {name: dict(kernel_info(kind, device.index))
                    for kind, name in ((0, "int8"), (1, "conv"), (2, "bf16"))}}
    for r in rows:
        if r["library_ms"] is not None:
            tag = r["case"].split("_")[1]
            out[f"torch_sum_{tag}_ms"] = r["library_ms"]
            out[f"torch_sum_{tag}_gbps"] = r["gbps"] * r["ms"] / r["library_ms"]
        out[f"cuda_{r['case']}_ms"] = r["ms"]
        out[f"cuda_{r['case']}_gbps"] = r["gbps"]
        out[f"device_{r['case']}_ms"] = alone[r["case"]]["device_ms"]
        out[f"device_{r['case']}_gbps"] = alone[r["case"]]["device_gbps"]
    print(json.dumps({"probe": "int8_bw", "device": smi, "reps": REPS, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
