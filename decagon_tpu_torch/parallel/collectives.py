"""Collectives with explicit adjoints.

Port of ``decagon_tpu/parallel/collectives.py``: each collective is a
``torch.autograd.Function`` whose backward is the adjoint the JAX package
defines with ``custom_vjp``.

* ``all_reduce_sum(group)``: sum forward, sum backward.  Its output feeds
  computation that differs from rank to rank (each scores its own batch
  shard), so the cotangent of the shared sum is every rank's cotangent,
  summed.
* ``edge_accum(group)``: sum forward, identity backward, for the
  weight-sharded encoder, whose cotangent arrives already summed over the
  mesh (by ``gather_rows``' backward).
* ``gather_rows(row_group, groups, n_rows, n_block, n_row_devices)``: a
  tiled all-gather over ``row`` trimmed to ``n_rows``; backward, the
  cotangent zero-padded to ``n_row_devices * n_block`` rows,
  reduce-scattered over ``row`` and all-reduced over the other groups of
  ``groups``: every rank's cotangent summed, restricted to the block.

Each is a ``Collective``: calling it runs the forward collective at once;
``start(x, pending)`` issues it with ``async_op`` (outside autograd) and
returns a callable that, after ``pending.wait()``, ties the result into
autograd, so that later work overlaps the exchange.  Backward collectives
run synchronously.

Backends.  NCCL takes CUDA tensors, gloo CPU ones; gloo's CUDA support
differs from op to op and version to version, so under gloo a CUDA tensor
goes through the host (copied out, reduced, copied back), synchronously.
The choice reads ``dist.get_backend(group)``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


class Pending:
    """Forward collectives in flight; ``wait`` makes their outputs
    readable (on the current stream, for NCCL)."""

    def __init__(self):
        self._works: List = []

    def add(self, work) -> None:
        self._works.append(work)

    def wait(self) -> None:
        works, self._works = self._works, []
        for work in works:
            work.wait()


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through the host: a CUDA tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def _size(group) -> int:
    return dist.get_world_size(group)


def _all_reduce_(t: torch.Tensor, group, pending: Optional[Pending] = None) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        return t
    work = dist.all_reduce(t, group=group, async_op=pending is not None)
    if pending is not None:
        pending.add(work)
    return t


def _all_gather(block: torch.Tensor, group, pending: Optional[Pending] = None) -> torch.Tensor:
    """``[size * rows, ...]``: every rank's ``block`` stacked in rank order."""
    n = _size(group)
    src = block.contiguous()
    if _staged(src, group):
        host = src.cpu()
        full = torch.empty((n * host.shape[0],) + tuple(host.shape[1:]), dtype=host.dtype)
        dist.all_gather(list(full.chunk(n)), host, group=group)
        return full.to(block.device)
    full = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                       device=src.device)
    work = dist.all_gather(list(full.chunk(n)), src, group=group,
                           async_op=pending is not None)
    if pending is not None:
        pending.add(work)
    return full


def _reduce_scatter(full: torch.Tensor, group) -> torch.Tensor:
    """This rank's ``[rows / size, ...]`` block of ``full`` summed over
    ``group``."""
    n = _size(group)
    src = full.contiguous()
    if _staged(src, group):
        host = src.cpu()
        out = torch.empty((host.shape[0] // n,) + tuple(host.shape[1:]), dtype=host.dtype)
        dist.reduce_scatter_tensor(out, host, group=group)
        return out.to(full.device)
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


class _Ready:
    """A forward collective's output computed outside autograd (an async
    one, waited for), handed to the Function as a non-tensor argument."""

    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        self.value = value


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ready):
        ctx.group = group
        return ready.value if ready is not None else _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce_(ct.clone(), ctx.group), None, None


class _EdgeAccum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ready):
        return ready.value if ready is not None else _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, row_group, other_groups, n_rows, ready):
        ctx.row_group, ctx.other_groups = row_group, other_groups
        ctx.n_rows, ctx.n_block = n_rows, x.shape[0]
        full = ready.value if ready is not None else _all_gather(x, row_group)
        return full[:n_rows]

    @staticmethod
    def backward(ctx, ct):
        n = _size(ctx.row_group)
        padded = ct.new_zeros((n * ctx.n_block,) + tuple(ct.shape[1:]))
        padded[: ctx.n_rows] = ct
        block = _reduce_scatter(padded, ctx.row_group)
        for group in ctx.other_groups:
            _all_reduce_(block, group)
        return block, None, None, None, None


class Collective:
    """A collective with its adjoint: ``f(x)`` runs it; ``f.start(x,
    pending)`` issues it with ``async_op`` and returns a callable that,
    after ``pending.wait()``, gives the same output tied into autograd."""

    def __init__(self, fn, group, run, *extra):
        self._fn, self._group, self._run, self._extra = fn, group, run, extra

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self._fn.apply(x, self._group, *self._extra, None)

    def start(self, x: torch.Tensor, pending: Pending) -> Callable[[], torch.Tensor]:
        ready = _Ready(self._run(x.detach(), pending))
        return lambda: self._fn.apply(x, self._group, *self._extra, ready)


def all_reduce_sum(group) -> Collective:
    """The sum of ``x`` over ``group``; backward, the sum of the
    cotangents."""
    return Collective(_AllReduceSum, group, lambda x, p: _all_reduce_(x.clone(), group, p))


def edge_accum(group) -> Collective:
    """The sum of ``x`` over ``group``; backward, the cotangent as it is."""
    return Collective(_EdgeAccum, group, lambda x, p: _all_reduce_(x.clone(), group, p))


def gather_rows(
    row_group, groups: Sequence, n_rows: int, n_block: int, n_row_devices: int
) -> Collective:
    """The ``[n_block, ...]`` blocks of the ``row`` group stacked in rank
    order and trimmed to ``n_rows``; backward, the cotangent summed over
    the ``row`` group (reduce-scatter: each rank keeps its block) and then
    over the other groups of ``groups``."""
    if _size(row_group) != n_row_devices:
        raise ValueError(
            f"gather_rows: the row group has {_size(row_group)} ranks, not {n_row_devices}"
        )
    if n_rows > n_row_devices * n_block:
        raise ValueError(f"gather_rows: {n_rows} rows exceed {n_row_devices} x {n_block}")
    others = tuple(g for g in groups if g is not row_group)
    return Collective(_GatherRows, row_group, lambda x, p: _all_gather(x, row_group, p),
                      others, n_rows)
