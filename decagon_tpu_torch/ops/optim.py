"""Fused per-leaf Adam, and the one-pass in-place Adam kernel (K7).

Port of ``decagon_tpu/ops/optim.py``.  ``fused_adam`` is the JAX
package's plain elementwise chain: the math is ``optax.adam``'s, the bias
corrections fold into the scalar multipliers ``s1``, ``s2``, and ``eps`` is
added after the square root (TF1 AdamOptimizer defaults, reference
``decagon/deep/optimizer.py:111-114``).  Moments may be stored in bf16; the
update arithmetic runs in f32 either way.

``fused_adam_apply`` is the JAX package's opt-in single-pass update
(``TrainConfig.pallas_adam``): leaves that pass the JAX gate (3-D, at least
``min_pallas_size`` elements, f32 gradient and moments) go through
``adam_onepass``, which updates m, v and p in place with the CUDA kernel of
``csrc/adam.cu`` on a CUDA tensor; every other leaf, and every CPU leaf,
takes the plain chain with ``p + upd``.  All scalars (``s1``, ``s2``, the
scheduled learning rate) are computed on the host from the int step count,
so an update never waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from decagon_tpu_torch.ops import cuda_build


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)``, over nested dicts of tensors."""

    init: Callable[[Any], Dict[str, Any]]
    update: Callable[[Any, Dict[str, Any]], Any]


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


def fused_adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    moments_dtype: Optional[torch.dtype] = None,
    schedule: Optional[Callable[[int], float]] = None,
) -> GradientTransformation:
    """Adam with one elementwise chain per leaf.  State ``{"m", "v",
    "t"}``: the moments in ``moments_dtype`` (the parameter's dtype when
    None) and the step count ``t``, an int.  ``schedule``: optional
    ``lr(t)`` of the int step count (``train/step._lr_schedule_fn``),
    evaluated on the host."""

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

        outs = tree_map(one, grads, state["m"], state["v"])
        upd, m, v = (tree_map(lambda o, i=i: o[i], outs) for i in range(3))
        return upd, {"m": m, "v": v, "t": t}

    return GradientTransformation(init, update)


# ---- one-pass in-place update (K7) -----------------------------------


def adam_onepass_ref(g, m, v, p, s1, s2, lr, b1, b2, eps) -> None:
    """Plain version of ``adam_onepass``: the same chain, op for op, then
    m, v (in their own dtype) and p written in place."""
    upd, m_new, v_new = _chain(g, m, v, lr, s1, s2, b1, b2, eps)
    p_new = p + upd
    m.copy_(m_new)
    v.copy_(v_new)
    p.copy_(p_new)


def adam_onepass(g, m, v, p, s1, s2, lr, b1, b2, eps, block_threads: int = 256) -> None:
    """One Adam pass over a leaf, updating ``m``, ``v`` and ``p`` in place.

    ``g``, ``m``, ``v``: f32 (the kernel of ``fused_adam_apply``) or bf16
    (the probe's case, f32 arithmetic); ``p`` f32; all contiguous and of
    one shape.  CUDA tensors go through the kernel of ``csrc/adam.cu``
    (16-byte vectors where every pointer is 16-byte aligned, scalar loads
    otherwise); CPU tensors through ``adam_onepass_ref``.
    ``block_threads``: the kernel's block size (a multiple of 32, at most
    256)."""
    if p.device.type == "cpu":
        adam_onepass_ref(g, m, v, p, s1, s2, lr, b1, b2, eps)
        return
    if p.device.type != "cuda":
        raise ValueError(f"adam_onepass runs on cuda or cpu, not {p.device}")
    dt = g.dtype
    if dt not in (torch.float32, torch.bfloat16) or m.dtype != dt or v.dtype != dt:
        raise TypeError(
            f"adam_onepass takes f32 or bf16 g, m, v of one dtype, got "
            f"{g.dtype}, {m.dtype}, {v.dtype}"
        )
    if p.dtype != torch.float32:
        raise TypeError(f"adam_onepass takes f32 parameters, got {p.dtype}")
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"adam_onepass: {name} is {tuple(t.shape)} on {t.device}, "
                             f"p is {tuple(p.shape)} on {p.device}")
    for name, t in (("g", g), ("m", m), ("v", v), ("p", p)):
        if not t.is_contiguous():
            raise ValueError(f"adam_onepass needs contiguous tensors; {name} is not")
    aligned = all(t.data_ptr() % 16 == 0 for t in (g, m, v, p))
    lib = cuda_build.library()
    with torch.cuda.device(p.device):
        status = lib.dt_adam(
            g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(), p.numel(),
            int(dt == torch.bfloat16), int(aligned), int(block_threads),
            b1, 1.0 - b1, b2, 1.0 - b2, s1, s2, -lr, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_build.check(status, "adam")
    cuda_build.LAUNCHES["adam"] += 1


def _takes_kernel(g, m, v, p, min_size: int) -> bool:
    """The JAX package's gate for its one-pass kernel, with "a CUDA
    tensor" in place of "on the TPU"."""
    return (
        g.dim() == 3
        and g.numel() >= min_size
        and g.dtype == m.dtype == v.dtype == torch.float32
        and p.is_cuda
    )


def fused_adam_apply(
    grads, state, params,
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    min_pallas_size: int = 1 << 20,
):
    """``(params', state')`` with the same math and ``{"m", "v", "t"}``
    state as ``fused_adam``.  Leaves that pass the gate are updated IN
    PLACE by ``adam_onepass`` (the returned trees hold the same tensors);
    the others take the plain chain into new tensors."""
    t = state["t"] + 1
    s1, s2 = bias_scales(t, b1, b2)

    def one(g, m, v, p):
        if _takes_kernel(g, m, v, p, min_pallas_size):
            adam_onepass(g, m, v, p, s1, s2, learning_rate, b1, b2, eps)
            return p, m, v
        upd, m_new, v_new = _chain(g, m, v, learning_rate, s1, s2, b1, b2, eps)
        return p + upd, m_new.to(m.dtype), v_new.to(v.dtype)

    outs = tree_map(one, grads, state["m"], state["v"], params)
    new_p, new_m, new_v = (tree_map(lambda o, i=i: o[i], outs) for i in range(3))
    return new_p, {"m": new_m, "v": new_v, "t": t}

