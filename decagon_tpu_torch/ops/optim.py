"""Fused per-leaf Adam, and the multi-tensor one-pass Adam kernel (K7).

Port of ``decagon_tpu/ops/optim.py``.  ``fused_adam`` is the JAX
package's plain elementwise chain: the math is ``optax.adam``'s, the bias
corrections fold into the scalar multipliers ``s1``, ``s2``, and ``eps`` is
added after the square root (TF1 AdamOptimizer defaults, reference
``decagon/deep/optimizer.py:111-114``).  Moments may be stored in bf16; the
update arithmetic runs in f32 either way.

The step's update is ``fused_adam``'s ``apply``: ``adam_apply``, which
sends every leaf of a CUDA tree through ONE launch of the kernel of
``csrc/adam.cu`` (``ceil(leaves / MAX_LEAVES)`` launches for a larger
tree), writing new p, m and v tensors, and gives CPU leaves the same
chain (``adam_apply_ref``).  ``fused_adam_apply`` is the JAX package's
opt-in single-pass update (``TrainConfig.pallas_adam``): the same launch,
with the leaves that pass the JAX gate (``pallas_gate``: 3-D, at least
``min_pallas_size`` elements, f32 gradient and moments) updated in place.
All scalars (``s1``, ``s2``, the scheduled learning rate) are computed on
the host from the int step count, so an update never waits for the device.
"""

from __future__ import annotations

import ctypes
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from decagon_tpu_torch.ops import cuda_build

# Leaves a launch takes (``csrc/adam.cu``'s table, a kernel parameter).
MAX_LEAVES = 48
# Leaf codes of ``csrc/adam.cu``: the gradient's type (f32, bf16, or f32
# rounded to bf16 as the kernel reads it), bf16 moments, the vector loop.
_G_F32, _G_BF16, _G_ROUND, _M_BF16, _VECTORIZED = 0, 1, 2, 4, 8
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)``, over nested dicts of tensors.  ``apply(grads, state, params,
    round_grad=None, in_place=None) -> (params, state)`` is the step's
    update (``train/step.apply_optimizer``): ``fused_adam``'s one-pass
    update, and ``make_optimizer``'s every optimizer has one."""

    init: Callable[[Any], Dict[str, Any]]
    update: Callable[[Any, Dict[str, Any]], Any]
    apply: Optional[Callable[..., Any]] = None


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the same keys."""
    if isinstance(trees[0], dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in trees[0]}
    return fn(*trees)


def bias_scales(t: int, b1: float, b2: float):
    """``(s1, s2) = (1 / (1 - b1^t), 1 / (1 - b2^t))`` in f32, as the JAX
    package computes them, returned as Python floats."""
    tf = torch.tensor(float(t), dtype=torch.float32)
    s1 = (1.0 / (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf))).item()
    s2 = (1.0 / (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf))).item()
    return s1, s2


def _chain(g, m, v, lr, s1, s2, b1, b2, eps):
    """The elementwise Adam chain in f32: ``(upd, m', v')``, the moments
    still f32."""
    g = g.float()
    m_new = b1 * m.float() + (1.0 - b1) * g
    v_new = b2 * v.float() + (1.0 - b2) * (g * g)
    upd = (-lr) * (s1 * m_new) / (torch.sqrt(s2 * v_new) + eps)
    return upd, m_new, v_new


def _chain_leaf(g, m, v, p, lr, s1, s2, b1, b2, eps, round_grad=None):
    """One leaf through the chain: ``(p', m', v')`` in their own dtypes,
    the gradient first cast to bf16 where ``round_grad(g)`` says so."""
    if round_grad is not None and round_grad(g):
        g = g.to(torch.bfloat16)
    upd, m_new, v_new = _chain(g, m, v, lr, s1, s2, b1, b2, eps)
    return (p + upd).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def _unzip(outs, t):
    """A tree of ``(x, m, v)`` leaves as ``(x tree, {"m", "v", "t"})``."""
    x, m, v = (tree_map(lambda o, i=i: o[i], outs) for i in range(3))
    return x, {"m": m, "v": v, "t": t}


def fused_adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    moments_dtype: Optional[torch.dtype] = None,
    schedule: Optional[Callable[[int], float]] = None,
    one_pass: Optional[Callable[..., Any]] = None,
) -> GradientTransformation:
    """Adam with one elementwise chain per leaf.  State ``{"m", "v",
    "t"}``: the moments in ``moments_dtype`` (the parameter's dtype when
    None) and the step count ``t``, an int.  ``schedule``: optional
    ``lr(t)`` of the int step count (``train/step._lr_schedule_fn``),
    evaluated on the host.  ``apply`` runs ``one_pass`` (``adam_apply``
    unless given; ``adam_apply_ref`` runs the plain version on any
    device)."""
    one_pass = adam_apply if one_pass is None else one_pass

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=moments_dtype or p.dtype)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "t": 0}

    def update(grads, state):
        t = state["t"] + 1
        lr = learning_rate if schedule is None else schedule(t)
        s1, s2 = bias_scales(t, b1, b2)

        def one(g, m, v):
            upd, m_new, v_new = _chain(g, m, v, lr, s1, s2, b1, b2, eps)
            return upd, m_new.to(m.dtype), v_new.to(v.dtype)

        return _unzip(tree_map(one, grads, state["m"], state["v"]), t)

    def apply(grads, state, params, round_grad=None, in_place=None):
        lr = learning_rate if schedule is None else schedule(state["t"] + 1)
        return one_pass(grads, state, params, lr, b1, b2, eps, round_grad=round_grad,
                        in_place=in_place)

    return GradientTransformation(init, update, apply)


# ---- the one-pass update (K7) -----------------------------------------


def adam_apply_ref(grads, state, params, lr, b1=0.9, b2=0.999, eps=1e-8, round_grad=None,
                   in_place=None):
    """Plain version of ``adam_apply``: ``(params', state')``, each leaf
    through the chain and ``p + upd``, new tensors in each input's dtype
    (``in_place`` is not read: the values are the same either way);
    ``round_grad(g)`` True: ``g`` cast to bf16 first (``cast_grads``)."""
    t = state["t"] + 1
    s1, s2 = bias_scales(t, b1, b2)
    outs = tree_map(
        lambda g, m, v, p: _chain_leaf(g, m, v, p, lr, s1, s2, b1, b2, eps, round_grad),
        grads, state["m"], state["v"], params,
    )
    return _unzip(outs, t)


def _check_leaf(g, m, v, p):
    """What the kernel takes: f32 or bf16 g, m and v of one dtype in f32
    or bf16, f32 p, one shape and one CUDA device, m, v, p contiguous."""
    if g.dtype not in _KERNEL_DTYPES or m.dtype not in _KERNEL_DTYPES or v.dtype != m.dtype:
        raise TypeError(f"the one-pass Adam takes f32 or bf16 g and f32 or bf16 m, v of one "
                        f"dtype, got {g.dtype}, {m.dtype}, {v.dtype}")
    if p.dtype != torch.float32:
        raise TypeError(f"the one-pass Adam takes f32 parameters, got {p.dtype}")
    for name, x in (("g", g), ("m", m), ("v", v)):
        if x.shape != p.shape or x.device != p.device:
            raise ValueError(f"the one-pass Adam: {name} is {tuple(x.shape)} on {x.device}, "
                             f"p is {tuple(p.shape)} on {p.device}")
    for name, x in (("g", g), ("m", m), ("v", v), ("p", p)):
        if not x.is_contiguous():
            raise ValueError(f"the one-pass Adam needs contiguous tensors; {name} is not")


def _launch(leaves, lr, s1, s2, b1, b2, eps, block_threads=256) -> None:
    """The kernel over ``leaves``, each ``(g, m, v, p, m_out, v_out, p_out,
    round)`` checked by ``_check_leaf``: one launch a ``MAX_LEAVES`` of
    the non-empty leaves.  Leaves on more than one device raise."""
    leaves = [leaf for leaf in leaves if leaf[3].numel() > 0]
    if not leaves:
        return
    device = leaves[0][3].device
    for leaf in leaves:
        if leaf[3].device != device:
            raise ValueError(f"the one-pass Adam launches on one device; a leaf is on "
                             f"{leaf[3].device}, another on {device}")
    lib = cuda_build.library()
    for start in range(0, len(leaves), MAX_LEAVES):
        part = leaves[start:start + MAX_LEAVES]
        tensors = [x for leaf in part for x in leaf[:7]]
        ptrs = (ctypes.c_void_p * len(tensors))(*(x.data_ptr() for x in tensors))
        ns = (ctypes.c_longlong * len(part))(*(leaf[3].numel() for leaf in part))
        codes = []
        for g, m, *rest in part:
            code = _G_BF16 if g.dtype == torch.bfloat16 else _G_ROUND if rest[-1] else _G_F32
            code |= _M_BF16 if m.dtype == torch.bfloat16 else 0
            if all(x.data_ptr() % 16 == 0 for x in (g, m, *rest[:-1])):
                code |= _VECTORIZED
            codes.append(code)
        with torch.cuda.device(device):
            status = lib.dt_adam_multi(
                len(part), ptrs, ns, (ctypes.c_int * len(part))(*codes), int(block_threads),
                b1, 1.0 - b1, b2, 1.0 - b2, s1, s2, -lr, eps,
                torch.cuda.current_stream().cuda_stream,
            )
        cuda_build.check(status, "adam")
        cuda_build.LAUNCHES["adam"] += 1


def _on_card(p) -> bool:
    """True for a CUDA leaf (the kernel's), False for a CPU leaf (the plain
    version's); another device raises."""
    if p.device.type == "cpu":
        return False
    if p.device.type != "cuda":
        raise ValueError(f"the one-pass Adam runs on cuda or cpu, not {p.device}")
    return True


def adam_apply(grads, state, params, lr, b1=0.9, b2=0.999, eps=1e-8, round_grad=None,
               in_place=None):
    """One Adam step over a tree: ``(params', state')`` with the
    ``{"m", "v", "t"}`` state of ``fused_adam``, the same bits as
    ``adam_apply_ref``.

    Every leaf on a CUDA device goes through the kernel of
    ``csrc/adam.cu``, all of them in one launch (one a ``MAX_LEAVES``),
    into new tensors, or into ``m``, ``v``, ``p`` themselves where
    ``in_place(g, m, v, p)`` is True.  The kernel takes f32 ``p``, f32 or
    bf16 ``g`` and f32 or bf16 ``m``, ``v`` (``_check_leaf``; a CUDA leaf
    of other dtypes raises, as do non-contiguous ``m``, ``v`` or ``p``); a
    non-contiguous gradient is copied to a contiguous one first.
    ``round_grad(g)`` True: an f32 gradient is rounded to bf16 as the
    kernel reads it (what ``cast_grads`` does before the chain).  CPU
    leaves take the chain (the plain version); another device raises."""
    t = state["t"] + 1
    s1, s2 = bias_scales(t, b1, b2)
    launch = []

    def one(g, m, v, p):
        if not _on_card(p):
            return _chain_leaf(g, m, v, p, lr, s1, s2, b1, b2, eps, round_grad)
        if not g.is_contiguous():
            g = g.contiguous()  # a copy: the kernel reads the leaf as flat
        _check_leaf(g, m, v, p)
        if in_place is not None and in_place(g, m, v, p):
            out = (m, v, p)
        else:
            out = tuple(torch.empty_like(x) for x in (m, v, p))
        rounds = g.dtype == torch.float32 and round_grad is not None and bool(round_grad(g))
        launch.append((g, m, v, p, *out, rounds))
        return out[2], out[0], out[1]

    outs = tree_map(one, grads, state["m"], state["v"], params)
    _launch(launch, lr, s1, s2, b1, b2, eps)
    return _unzip(outs, t)


def adam_onepass_ref(g, m, v, p, s1, s2, lr, b1, b2, eps) -> None:
    """Plain version of ``adam_onepass``: the same chain, op for op, then
    m, v (in their own dtype) and p written in place."""
    upd, m_new, v_new = _chain(g, m, v, lr, s1, s2, b1, b2, eps)
    p_new = p + upd
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def adam_onepass(g, m, v, p, s1, s2, lr, b1, b2, eps, block_threads: int = 256) -> None:
    """One Adam pass over one leaf, updating ``m``, ``v`` and ``p`` in
    place: the kernel's one-leaf case, with the bias scales given (P6's
    probe).

    ``g``, ``m``, ``v``: f32 or bf16, of one dtype (f32 arithmetic); ``p``
    f32; all contiguous and of one shape.  CUDA tensors go through the
    kernel of ``csrc/adam.cu`` (16-byte vectors where every pointer is
    16-byte aligned, scalar loads otherwise); CPU tensors through
    ``adam_onepass_ref``.  ``block_threads``: the kernel's block size (a
    multiple of 32, at most 256)."""
    if p.device.type == "cpu":
        adam_onepass_ref(g, m, v, p, s1, s2, lr, b1, b2, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_onepass runs on cuda or cpu, not {p.device}")
    if m.dtype != g.dtype:
        raise TypeError(f"adam_onepass takes g, m, v of one dtype, got "
                        f"{g.dtype}, {m.dtype}, {v.dtype}")
    _check_leaf(g, m, v, p)
    _launch([(g, m, v, p, m, v, p, False)], lr, s1, s2, b1, b2, eps, block_threads)


def pallas_gate(min_size: int = 1 << 20, round_grad=None) -> Callable[..., bool]:
    """``in_place(g, m, v, p)`` of ``pallas_adam``: the JAX package's gate
    for its one-pass kernel (3-D, at least ``min_size`` elements, f32
    gradient and moments), with "a CUDA tensor" in place of "on the
    TPU".  A gradient that ``round_grad`` rounds counts as the bf16 one
    the JAX gate sees after the cast."""

    def takes(g, m, v, p) -> bool:
        return (
            g.dim() == 3
            and g.numel() >= min_size
            and g.dtype == m.dtype == v.dtype == torch.float32
            and not (round_grad is not None and round_grad(g))
            and _on_card(p)
        )

    return takes


def fused_adam_apply(
    grads, state, params,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    min_pallas_size: int = 1 << 20,
):
    """``(params', state')`` with the same math and ``{"m", "v", "t"}``
    state as ``fused_adam``: ``adam_apply`` with the leaves that pass the
    JAX gate updated IN PLACE (the returned trees hold the same tensors);
    the others take new tensors, through the same launch on CUDA."""
    return adam_apply(grads, state, params, learning_rate, b1, b2, eps,
                      in_place=pallas_gate(min_pallas_size))
