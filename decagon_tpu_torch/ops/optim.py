"""Fused per-leaf Adam (plain PyTorch).

Port of ``decagon_tpu/ops/optim.py::fused_adam``, which the JAX package
computes as plain XLA elementwise code (the Pallas one-pass update, K7, is
an opt-in there and is not ported yet).  The math is ``optax.adam``'s:
the bias corrections fold into the scalar multipliers ``s1``, ``s2``, and
``eps`` is added after the square root (TF1 AdamOptimizer defaults,
reference ``decagon/deep/optimizer.py:111-114``).  Moments may be stored
in bf16; the update arithmetic runs in f32 either way.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch


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


def fused_adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    moments_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """Adam with one elementwise chain per leaf.  State ``{"m", "v",
    "t"}``: the moments in ``moments_dtype`` (the parameter's dtype when
    None) and the step count ``t``, an int."""

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=moments_dtype or p.dtype)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params), "t": 0}

    def update(grads, state):
        t = state["t"] + 1
        tf = torch.tensor(float(t), dtype=torch.float32)
        s1 = (1.0 / (1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), tf))).item()
        s2 = (1.0 / (1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), tf))).item()

        def one(g, m, v):
            g = g.float()
            m_new = b1 * m.float() + (1.0 - b1) * g
            v_new = b2 * v.float() + (1.0 - b2) * (g * g)
            upd = (-learning_rate) * (s1 * m_new) / (torch.sqrt(s2 * v_new) + eps)
            return upd, m_new.to(m.dtype), v_new.to(v.dtype)

        outs = tree_map(one, grads, state["m"], state["v"])
        upd, m, v = (tree_map(lambda o, i=i: o[i], outs) for i in range(3))
        return upd, {"m": m, "v": v, "t": t}

    return GradientTransformation(init, update)
