"""Paired factored SpMM: forward, backward and dropout keep-scales.

Port of ``decagon_tpu/ops/spmm_paired.py``.  A square transpose-augmented
edge type has relations ``[r_0..r_{K-1}, r_0^T..r_{K-1}^T]``, so with the
rank-1 normalization the aggregation is

    out = sum_k  a_e[k] * (B_k   @ (b_e[k] * p_e[k]))     (direct half)
        + sum_k  a_o[k] * (B_k^T @ (b_o[k] * p_o[k]))     (transposed half)

over ONE int8 mask stack ``B`` of K relations.  Operands ride transposed,
``p4 [2, K, H, N]`` (the encoder's paired weight layout), and the result
``outT [H, N]``.

Kernels (``decagon_tpu_torch/csrc/``) and their plain versions:

* ``paired_fwd`` wraps ``paired_fwd.cu`` (K1/K2, and K1/K2-ds with the
  dropout keep-scales ``ds [K, 2, N]``); plain: ``paired_ref`` /
  ``paired_ref_ds``.
* ``paired_bwd`` wraps ``paired_bwd.cu`` (K3/K4); plain: ``paired_bwd_ref``,
  with the kernel's cast points.

Both kernels run one sweep (``csrc/paired_core.cuh``: 16-byte ``cp.async``
staging in a three-stage ring, ``ldmatrix`` and ``mma.sync`` with the row
scales applied in registers) over bf16 operands that a short pass writes
first (``paired_operands`` / ``paired_bwd_operands`` are their plain
versions), cut into blocks by ``paired_schedule`` so the grid fills whole
waves at the occupancy the card reports (``kernel_info``).
``paired_bmm`` is the yardstick: the same products as one ``torch.bmm`` a
half, which ``chip_smoke.py`` times and no path of the port calls.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs the
plain version on a CPU tensor.  ``_PairedApply`` and ``_PairedApplyDs``
are the two ``torch.autograd.Function``s (``_paired_apply`` and
``_paired_apply_ds`` in the JAX package): through the kernels on CUDA,
through the plain versions on the CPU or under ``impl="paired_ref"``, where
the ``ds`` backward is autograd of ``paired_ref_ds`` as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import types
from typing import TYPE_CHECKING, Mapping, Optional

import torch

from decagon_tpu_torch.ops import cuda_build

if TYPE_CHECKING:  # pragma: no cover
    from decagon_tpu_torch.graph.device import EdgeTypeAdj

# A kernel block's nodes, hidden columns and contraction chunk (``TM``,
# ``HS`` and ``TK`` in ``csrc/paired_core.cuh``).
_ROWS_PER_BLOCK = 64
_COLS_PER_BLOCK = 64
_CHUNK = 64
# ``paired_schedule``'s cost model, in chunk steps of one block: a
# relation's epilogue, and a block's pipeline fill and final store.  Fitted
# to the times of every cut at the paper's shapes on an H100
# (``scripts/probe_paired_cuts.py``, its record ``scripts/paired_cuts_h100.json``).
_EPILOGUE_STEPS = 0.25
_BLOCK_STEPS = 3.0
# The schedule considers grids of at most this many waves (and always the
# unsplit grid).
_MAX_WAVES = 16
PAIRED_IMPLS = ("auto", "paired", "paired_ref")


def paired_ref(
    p4: torch.Tensor, mask: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """Plain version: ``outT [H, N]`` f32 with the kernel's cast points
    (``p * b`` rounded to bf16, exact products, f32 sums).  Accepts masks
    and scales padded beyond ``[K, N]``, as the JAX package builds them."""
    k, n = p4.shape[1], p4.shape[3]
    b = mask[:k, :n, :n].float()
    ae = scales[:k, 0:1, :n]  # [K, 1, N]
    ao = scales[:k, 1:2, :n]
    be = scales[:k, 2:3, :n]
    bo = scales[:k, 3:4, :n]
    pe = (p4[0].float() * be).to(torch.bfloat16).float()  # [K, H, N]
    po = (p4[1].float() * bo).to(torch.bfloat16).float()
    xe = torch.matmul(pe, b.transpose(1, 2))  # [K, H, N_i]
    xo = torch.matmul(po, b)  # [K, H, N_j]
    return torch.sum(ae * xe + ao * xo, dim=0)


def paired_ref_ds(
    p4: torch.Tensor, mask: torch.Tensor, scales: torch.Tensor, ds: torch.Tensor
) -> torch.Tensor:
    """Plain version of the identity fast path: the keep-scales ``ds``
    [K, 2, N] applied to the halves of the f32 ``p4`` before
    ``paired_ref``."""
    k, n = p4.shape[1], p4.shape[3]
    p4_eff = torch.stack([
        p4[0] * ds[:k, 0, None, :n], p4[1] * ds[:k, 1, None, :n],
    ])
    return paired_ref(p4_eff, mask, scales)


def paired_bwd_ref(
    ct: torch.Tensor,
    mask: torch.Tensor,
    scales: torch.Tensor,
    ds: Optional[torch.Tensor],
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain version of the backward kernel: ``d [2, K, H, N]`` from the
    cotangent ``ct [H, N]`` of ``outT``, with the kernel's cast points
    (``a * ct`` rounded to bf16, exact products, f32 sums) and the
    keep-scales, when given, folded into the column scales first.  Without
    ``ds`` it is the JAX package's non-kernel backward."""
    k, n = mask.shape[0], ct.shape[1]
    b = mask[:k, :n, :n].float()
    ct = ct.float()
    cta_e = (scales[:k, 0:1, :n] * ct[None]).to(torch.bfloat16).float()
    cta_o = (scales[:k, 1:2, :n] * ct[None]).to(torch.bfloat16).float()
    de = torch.matmul(cta_e, b)  # [K, H, N]: sum over B's rows
    do = torch.matmul(cta_o, b.transpose(1, 2))  # sum over B's columns
    se, so = scales[:k, 2:3, :n], scales[:k, 3:4, :n]
    if ds is not None:
        se = se * ds[:k, 0:1, :n]
        so = so * ds[:k, 1:2, :n]
    return torch.stack([se * de, so * do]).to(out_dtype)


def paired_operands(
    p4: torch.Tensor, scales: torch.Tensor, ds: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The forward's bf16 operands ``q [2, K, H, N]``: each half of ``p4``
    times its keep-scales (when given), then its column scale ``b_e`` /
    ``b_o``, rounded to bf16 (``paired_ref_ds``'s and ``paired_ref``'s
    cast points)."""
    k, n = p4.shape[1], p4.shape[3]
    p = p4.float()
    if ds is not None:
        p = p * ds[:k, :, None, :n].transpose(0, 1)
    return (p * scales[:k, 2:4, None, :n].transpose(0, 1)).to(torch.bfloat16)


def paired_bwd_operands(ct: torch.Tensor, scales: torch.Tensor, k: int) -> torch.Tensor:
    """The backward's bf16 operands ``[2, K, H, N]``: ``bf16(a_e * ct)`` and
    ``bf16(a_o * ct)`` of each relation (``paired_bwd_ref``'s cast point)."""
    n = ct.shape[1]
    return (scales[:k, 0:2, None, :n].transpose(0, 1) * ct.float()).to(torch.bfloat16)


def paired_bmm_inputs(mask: torch.Tensor, qd: torch.Tensor, qt: torch.Tensor):
    """The ``torch.bmm`` yardstick's inputs: a bf16 copy of the mask
    ``[K, N, N]`` and the operands ``[K, H, N]`` of the direct and the
    transposed half as contiguous ``[K, N, H]``.  The forward passes
    ``paired_operands``' halves 0 and 1, the backward
    ``paired_bwd_operands``' halves 1 and 0.  Only ``chip_smoke.py`` and
    the tests call it: no path of the port does."""
    k, n = qd.shape[0], qd.shape[2]
    return (mask[:k, :n, :n].to(torch.bfloat16), qd.transpose(1, 2).contiguous(),
            qt.transpose(1, 2).contiguous())


def paired_bmm(m16: torch.Tensor, qd: torch.Tensor, qt: torch.Tensor):
    """The two halves' products as one library call each: ``B_k @ qd_k``
    and ``B_k^T @ qt_k``, bf16 ``[K, N, H]`` (f32 sums rounded to bf16).
    The row scales and the sum over relations are left to the caller."""
    return torch.bmm(m16, qd), torch.bmm(m16.transpose(1, 2), qt)


def _check_common(name, dev, k, n, mask, scales, ds) -> None:
    if mask.dtype != torch.int8 or tuple(mask.shape) != (k, n, n):
        raise ValueError(
            f"mask must be int8 [{k}, {n}, {n}], got {mask.dtype} "
            f"{tuple(mask.shape)}"
        )
    if scales.dtype != torch.float32 or tuple(scales.shape) != (k, 4, n):
        raise ValueError(
            f"scales must be float32 [{k}, 4, {n}], got {scales.dtype} "
            f"{tuple(scales.shape)}"
        )
    if ds is not None and (ds.dtype != torch.float32 or tuple(ds.shape) != (k, 2, n)):
        raise ValueError(
            f"ds must be float32 [{k}, 2, {n}], got {ds.dtype} {tuple(ds.shape)}"
        )
    for label, t in (("mask", mask), ("scales", scales), ("ds", ds)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {label} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _check_fwd_args(p4, mask, scales, ds) -> None:
    if p4.dim() != 4 or p4.shape[0] != 2:
        raise ValueError(f"p4 must be [2, K, H, N], got {tuple(p4.shape)}")
    if p4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p4 must be float32 or bfloat16, got {p4.dtype}")
    if ds is not None and p4.dtype != torch.float32:
        raise TypeError("keep-scales apply to the f32 identity-feature operand")
    if not p4.is_contiguous():
        raise ValueError("p4 must be contiguous")
    _, k, _, n = p4.shape
    _check_common("paired_fwd", p4.device, k, n, mask, scales, ds)


@dataclasses.dataclass(frozen=True)
class PairedSchedule:
    """How the paired kernels cut one call's work into blocks: ``tiles``
    node tiles of 64 x ``hslices`` hidden slices of 64 x ``rel_splits``
    relation ranges x ``con_splits`` contraction ranges (of the ``chunks``
    chunks of 64), on a card that runs ``wave`` blocks at once."""

    k: int
    n: int
    h: int
    tiles: int
    hslices: int
    chunks: int
    rel_splits: int
    con_splits: int
    wave: int

    @property
    def partials(self) -> int:
        """Blocks that share a node tile and slice; the forward sums their
        partials in index order, the backward its ``con_splits``."""
        return self.rel_splits * self.con_splits

    @property
    def blocks(self) -> int:
        return self.tiles * self.hslices * self.partials

    @property
    def waves(self) -> float:
        return self.blocks / self.wave

    @property
    def hq(self) -> int:
        """Rows of each operand plane: H rounded up to 16."""
        return -(-self.h // 16) * 16

    @property
    def npad(self) -> int:
        """Columns of each operand plane: N rounded up to a chunk."""
        return self.chunks * _CHUNK

    def ranges(self):
        """Each block's work in launch order (``blockIdx`` x fastest, then
        y, then z): ``(tile, hslice, k0, k1, ch0, ch1, partial)`` with the
        kernel's integer arithmetic (``block_sweep`` in
        ``csrc/paired_core.cuh``)."""
        for z in range(self.hslices):
            for y in range(self.partials):
                rs, cs = divmod(y, self.con_splits)
                k0 = self.k * rs // self.rel_splits
                k1 = self.k * (rs + 1) // self.rel_splits
                ch0 = self.chunks * cs // self.con_splits
                ch1 = self.chunks * (cs + 1) // self.con_splits
                for x in range(self.tiles):
                    yield x, z, k0, k1, ch0, ch1, y


def _grid(k: int, n: int, h: int, sms: int, blocks_per_sm: int):
    """(node tiles x hidden slices, chunks, blocks a wave) of a call."""
    return -(-n // _ROWS_PER_BLOCK) * -(-h // _COLS_PER_BLOCK), -(-n // _CHUNK), sms * blocks_per_sm


def schedule_cuts(k: int, n: int, h: int, sms: int, blocks_per_sm: int):
    """The (rel_splits, con_splits) cuts ``paired_schedule`` weighs: grids
    of at most ``_MAX_WAVES`` waves (and always the unsplit grid), with
    each split count the fewest that gives its longest range (the kernel
    gives each range a floor- or ceil-divided share)."""
    base, chunks, wave = _grid(k, n, h, sms, blocks_per_sm)
    cap = max(_MAX_WAVES * wave, base)
    for rs in range(1, k + 1):
        if base * rs > cap:
            break
        if rs > 1 and -(-k // (rs - 1)) == -(-k // rs):
            continue  # the same longest block with fewer splits
        for cs in range(1, chunks + 1):
            if base * rs * cs > cap or rs * cs > 65535:
                break
            if cs > 1 and -(-chunks // (cs - 1)) == -(-chunks // cs):
                continue
            yield rs, cs


def cut_cost(k: int, n: int, h: int, sms: int, blocks_per_sm: int, rel_splits: int,
             con_splits: int, epilogue_steps: float = _EPILOGUE_STEPS,
             block_steps: float = _BLOCK_STEPS) -> float:
    """The cost model: whole waves times the longest block's chunk steps,
    a relation's epilogue counted as ``epilogue_steps`` and a block's
    pipeline fill and final store as ``block_steps``."""
    base, chunks, wave = _grid(k, n, h, sms, blocks_per_sm)
    kb, cb = -(-k // rel_splits), -(-chunks // con_splits)
    waves = -(-base * rel_splits * con_splits // wave)
    return waves * (kb * (cb + epilogue_steps) + block_steps)


def cheapest_cut(k: int, n: int, h: int, sms: int, blocks_per_sm: int,
                 epilogue_steps: float = _EPILOGUE_STEPS,
                 block_steps: float = _BLOCK_STEPS):
    """The ``schedule_cuts`` cut of least ``cut_cost``; ties go to fewer
    splits, then fewer relation splits."""
    def key(cut):
        rs, cs = cut
        cost = cut_cost(k, n, h, sms, blocks_per_sm, rs, cs, epilogue_steps, block_steps)
        return cost, rs * cs, rs

    return min(schedule_cuts(k, n, h, sms, blocks_per_sm), key=key)


@functools.lru_cache(maxsize=None)
def paired_schedule(k: int, n: int, h: int, sms: int, blocks_per_sm: int) -> PairedSchedule:
    """The cut of a paired call's work (K relations, N nodes, H columns)
    that finishes first on ``sms`` SMs running ``blocks_per_sm`` blocks
    each, under the cost model ``cut_cost`` (``cheapest_cut``).  At K = 1
    only the contraction can be split, so it is."""
    rs, cs = cheapest_cut(k, n, h, sms, blocks_per_sm)
    return schedule_at(k, n, h, sms, blocks_per_sm, rs, cs)


def schedule_at(k: int, n: int, h: int, sms: int, blocks_per_sm: int, rel_splits: int,
                con_splits: int) -> PairedSchedule:
    """The ``PairedSchedule`` of a given cut."""
    return PairedSchedule(k, n, h, -(-n // _ROWS_PER_BLOCK), -(-h // _COLS_PER_BLOCK),
                          -(-n // _CHUNK), rel_splits, con_splits, sms * blocks_per_sm)


@functools.lru_cache(maxsize=None)
def kernel_info(which: str, device_index: int) -> Mapping[str, int]:
    """What the card gives the paired sweep kernel ``which`` ("fwd" or
    "bwd"): registers a thread, blocks an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), shared and local
    (spilled) bytes, and the SMs; queried once a device (read-only)."""
    info = (ctypes.c_int * 4)()
    lib = cuda_build.library()
    with torch.cuda.device(device_index):
        status = getattr(lib, f"dt_paired_{which}_info")(ctypes.addressof(info))
    cuda_build.check(status, f"paired_{which} info")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return types.MappingProxyType(dict(
        registers=info[0], blocks_per_sm=info[1], smem_bytes=info[2], local_bytes=info[3],
        sms=sms))


def launch_schedule(which: str, k: int, n: int, h: int, device) -> PairedSchedule:
    """``paired_schedule`` at the occupancy the card reports for ``which``."""
    info = kernel_info(which, torch.device(device).index or 0)
    return paired_schedule(k, n, h, info["sms"], max(1, info["blocks_per_sm"]))


def paired_fwd(
    p4: torch.Tensor,
    mask: torch.Tensor,
    scales: torch.Tensor,
    ds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``outT [H, N]`` f32 of the paired aggregation.

    ``p4`` [2, K, H, N] f32 or bf16 (f32 with ``ds``); ``mask`` int8
    [K, N, N]; ``scales`` f32 [K, 4, N]; ``ds`` f32 [K, 2, N] keep-scales
    or None.  CUDA tensors go through the kernel (an operand pass, then
    the sweep cut by ``paired_schedule`` into whole waves, partial sums
    reduced in a fixed order, so the result is deterministic); CPU tensors
    through ``paired_ref`` / ``paired_ref_ds``.
    """
    if p4.device.type == "cpu":
        if ds is None:
            return paired_ref(p4, mask, scales)
        return paired_ref_ds(p4, mask, scales, ds)
    if p4.device.type != "cuda":
        raise ValueError(f"paired_fwd runs on cuda or cpu, not {p4.device}")
    _check_fwd_args(p4, mask, scales, ds)
    _, k, h, n = p4.shape
    with torch.cuda.device(p4.device):
        out = run_fwd(p4, mask, scales, ds, launch_schedule("fwd", k, n, h, p4.device))
    cuda_build.LAUNCHES["paired_fwd"] += 1
    return out


def run_fwd(p4, mask, scales, ds, sched: PairedSchedule) -> torch.Tensor:
    """The forward kernel on checked CUDA operands at the cut ``sched``
    (``paired_fwd`` passes ``launch_schedule``'s; ``scripts/probe_paired_cuts``
    others); counts no launch."""
    _, k, h, n = p4.shape
    q = torch.empty((2, k, sched.hq, sched.npad), dtype=torch.bfloat16, device=p4.device)
    out = torch.empty((n, h), dtype=torch.float32, device=p4.device)
    partial = out if sched.partials == 1 else torch.empty(
        (sched.partials, n, h), dtype=torch.float32, device=p4.device
    )
    status = cuda_build.library().dt_paired_fwd(
        mask.data_ptr(), p4.data_ptr(), int(p4.dtype == torch.bfloat16),
        scales.data_ptr(), 0 if ds is None else ds.data_ptr(),
        q.data_ptr(), partial.data_ptr(), out.data_ptr(),
        k, n, h, sched.rel_splits, sched.con_splits,
        torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(status, "paired_fwd")
    return out.t()


def paired_bwd(
    ct: torch.Tensor,
    mask: torch.Tensor,
    scales: torch.Tensor,
    ds: Optional[torch.Tensor],
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """``d [2, K, H, N]`` in ``out_dtype`` (f32 or bf16) from the cotangent
    ``ct [H, N]`` of ``outT``: the gradient of the paired aggregation with
    respect to ``p4`` (with respect to the raw weights, when ``ds`` is
    given).  CUDA tensors go through the kernel (an operand pass, then
    the sweep cut by ``paired_schedule``; each block owns its outputs, or
    its partial where the contraction is split, summed in a fixed order),
    so two calls are bitwise equal; CPU tensors through
    ``paired_bwd_ref``."""
    if ct.device.type == "cpu":
        return paired_bwd_ref(ct, mask, scales, ds, out_dtype)
    if ct.device.type != "cuda":
        raise ValueError(f"paired_bwd runs on cuda or cpu, not {ct.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if ct.dim() != 2:
        raise ValueError(f"ct must be [H, N], got {tuple(ct.shape)}")
    ct = ct.float().contiguous()
    h, n = ct.shape
    k = mask.shape[0]
    _check_common("paired_bwd", ct.device, k, n, mask, scales, ds)
    with torch.cuda.device(ct.device):
        d = run_bwd(ct, mask, scales, ds, out_dtype, launch_schedule("bwd", k, n, h, ct.device))
    cuda_build.LAUNCHES["paired_bwd"] += 1
    return d


def run_bwd(ct, mask, scales, ds, out_dtype, sched: PairedSchedule) -> torch.Tensor:
    """The backward kernel on checked CUDA operands (``ct`` contiguous f32)
    at the cut ``sched``, as ``run_fwd``; counts no launch."""
    h, n = ct.shape
    k = mask.shape[0]
    q = torch.empty((2, k, sched.hq, sched.npad), dtype=torch.bfloat16, device=ct.device)
    d = torch.empty((2, k, h, n), dtype=out_dtype, device=ct.device)
    partial = d if sched.con_splits == 1 else torch.empty(
        (sched.con_splits, 2, k, h, n), dtype=torch.float32, device=ct.device
    )
    status = cuda_build.library().dt_paired_bwd(
        mask.data_ptr(), ct.data_ptr(), scales.data_ptr(),
        0 if ds is None else ds.data_ptr(), q.data_ptr(), partial.data_ptr(),
        d.data_ptr(), int(out_dtype == torch.bfloat16), k, n, h,
        sched.rel_splits, sched.con_splits, torch.cuda.current_stream().cuda_stream,
    )
    cuda_build.check(status, "paired_bwd")
    return d


class _PairedApply(torch.autograd.Function):
    """``outT = paired(p4)`` with the JAX package's custom VJP: the
    backward is the kernel on CUDA (``use_kernel``), else the plain
    formula (``_paired_bwd``'s non-kernel branch).  The gradient has the
    primal's dtype."""

    @staticmethod
    def forward(ctx, p4, mask, scales, use_kernel):
        ctx.save_for_backward(mask, scales)
        ctx.use_kernel = use_kernel
        ctx.p_dtype = p4.dtype
        if use_kernel:
            return paired_fwd(p4, mask, scales)
        return paired_ref(p4, mask, scales)

    @staticmethod
    def backward(ctx, ct):
        mask, scales = ctx.saved_tensors
        bwd = paired_bwd if ctx.use_kernel else paired_bwd_ref
        return bwd(ct, mask, scales, None, ctx.p_dtype), None, None, None


class _PairedApplyDs(torch.autograd.Function):
    """Identity-feature fast path: ``p4`` is the raw f32 weight stack and
    the keep-scales ``ds`` apply inside the kernels, forward and backward.
    The plain backward is autograd of ``paired_ref_ds``, as in the JAX
    package (``_paired_ds_bwd``); it rounds the product, not ``a * ct``, to
    bf16, so it differs from the kernel at the bf16 level."""

    @staticmethod
    def forward(ctx, p4, mask, scales, ds, use_kernel):
        ctx.save_for_backward(mask, scales, ds)
        ctx.use_kernel = use_kernel
        ctx.p_shape, ctx.p_dtype = p4.shape, p4.dtype
        if use_kernel:
            return paired_fwd(p4, mask, scales, ds)
        return paired_ref_ds(p4, mask, scales, ds)

    @staticmethod
    def backward(ctx, ct):
        mask, scales, ds = ctx.saved_tensors
        if ctx.use_kernel:
            d = paired_bwd(ct, mask, scales, ds, ctx.p_dtype)
        else:
            with torch.enable_grad():
                q = torch.zeros(
                    ctx.p_shape, dtype=ctx.p_dtype, device=ct.device,
                    requires_grad=True,
                )
                (d,) = torch.autograd.grad(paired_ref_ds(q, mask, scales, ds), q, ct)
            d = d.to(ctx.p_dtype)
        return d, None, None, None, None


def _use_kernel(t: torch.Tensor, adj: "EdgeTypeAdj", impl: str) -> bool:
    if adj.pair_mask is None:
        raise ValueError(
            "edge type has no paired mask stack; build the device graph "
            "with dense_paired=True"
        )
    if impl not in PAIRED_IMPLS:
        raise ValueError(f"unknown paired impl: {impl!r}")
    return impl != "paired_ref" and t.device.type == "cuda"


def spmm_paired_identity(
    weights: torch.Tensor,
    dropscale: Optional[torch.Tensor],
    adj: "EdgeTypeAdj",
    impl: str = "auto",
) -> torch.Tensor:
    """Identity-feature layer-1 aggregation for a paired edge type:
    ``weights`` is the raw [2, K, H, F] f32 encoder stack (with identity
    features the projection is the weights); ``dropscale`` the per-step
    keep-scales f32 [K, 2, N] (0 or 1/keep), or None for the deterministic
    forward.  Returns [N, H] f32.  ``impl``: "auto"/"paired" (the kernels
    on CUDA, the plain versions on the CPU) or "paired_ref" (the plain
    versions on any device)."""
    use = _use_kernel(weights, adj, impl)
    w = weights.contiguous()
    if dropscale is None:
        out_t = _PairedApply.apply(w, adj.pair_mask, adj.pair_scales, use)
    else:
        out_t = _PairedApplyDs.apply(
            w, adj.pair_mask, adj.pair_scales, dropscale.contiguous(), use
        )
    return out_t.t()


def spmm_paired(
    p_t: torch.Tensor, adj: "EdgeTypeAdj", impl: str = "auto"
) -> torch.Tensor:
    """Aggregate ``sum_k A_k @ P_k`` for a transpose-paired edge type.

    ``p_t``: [2, K, H, N] projected features, f32, unscaled; it is cast to
    bf16 here, as in the JAX package, so its gradient rounds through bf16
    too.  Returns [N, H] f32."""
    use = _use_kernel(p_t, adj, impl)
    p4 = p_t.to(torch.bfloat16).contiguous()
    return _PairedApply.apply(p4, adj.pair_mask, adj.pair_scales, use).t()
