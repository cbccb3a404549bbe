"""Two-layer multi-relational graph-convolution encoder.

Port of ``decagon_tpu/models/encoder.py``:

    layer 1:  T1_{ij} = l2norm_rows( sum_k A^{ij}_k (drop_k(X_j) W1^{ij}_k) )
              h1_i    = relu( sum_j T1_{ij} )
    layer 2:  T2_{ij} = l2norm_rows( sum_k A^{ij}_k (drop_k(h1_j) W2^{ij}_k) )
              emb_i   = sum_j T2_{ij}                       (no relu)

(reference ``decagon/deep/model.py:64-88``, ``layers.py:70-118``).  Square
transpose-paired edge types aggregate through the paired kernels
(``ops/spmm_paired.py``) and store their weights transposed,
``[2, K/2, H, F]``; the others through ``ops/segment.spmm`` (the int8
factored stack, the dense stack, the COO stream, or the CSR layouts
through the K6 kernel at ``spmm_precision``).  ``"fused"`` and
``"fused_pallas"`` aggregate every edge type of a layer at once over
``graph.fused`` (``fused_layer``): a gather and one ``index_add_``, or one
K6 launch.

Dropout: one Bernoulli draw per layer covers every edge type's mask, in
sorted edge-type order, with the JAX package's shapes (identity features:
a per-(relation, node) row mask; dense features: a fresh mask per relation
up to ``per_relation_dropout_max`` relations, else one shared mask).  On
the paired identity path the mask becomes keep-scales ``ds [K, 2, N]``
that the kernels apply.  ``layer_bits`` replaces the draw, so a test can
feed the JAX package's own bits; ``draw_layer_bits`` makes both layers'
draws up front, which is how ``DecagonModel`` hands them to a
rematerialized encoder.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from decagon_tpu_torch.graph.device import DeviceGraph, etkey, parse_etkey
from decagon_tpu_torch.models.init import glorot
from decagon_tpu_torch.ops.segment import (
    SPMM_IMPLS,
    l2_normalize_rows,
    spmm,
)
from decagon_tpu_torch.ops.spmm_pallas import spmm_pallas_flat
from decagon_tpu_torch.ops.spmm_paired import (
    PAIRED_IMPLS,
    spmm_paired,
    spmm_paired_identity,
)

Params = Dict[str, Dict[str, torch.Tensor]]
LayerBits = Dict[str, torch.Tensor]

# The fused all-edge-type stream: plain gather and index_add_, K6, and
# K6's plain version on any device.
FUSED_IMPLS = ("fused", "fused_pallas", "fused_pallas_ref")
SPMM_IMPL_NAMES = ("auto",) + PAIRED_IMPLS[1:] + SPMM_IMPLS + FUSED_IMPLS


def check_spmm_impl(spmm_impl: str) -> None:
    """Raise for an ``spmm_impl`` the port does not run: the JAX
    package's interpret modes (NotImplementedError, pointing at the plain
    version), anything else unknown (ValueError)."""
    if spmm_impl in SPMM_IMPL_NAMES:
        return
    plain = {"paired_interpret": "paired_ref", "pallas_interpret": "pallas_ref",
             "fused_pallas_interpret": "fused_pallas_ref"}
    if spmm_impl in plain:
        raise NotImplementedError(
            f"{spmm_impl!r} is the JAX package's interpret-mode kernel; CUDA "
            f"kernels have no interpret mode: use {plain[spmm_impl]!r}"
        )
    raise ValueError(f"unknown spmm_impl: {spmm_impl!r}")


def paired_edge_types(graph: DeviceGraph, spmm_impl: str) -> set:
    """Edge-type keys that run the PAIRED path — and therefore store their
    encoder weights transposed ``[2, K/2, H, F]``.  Empty unless
    ``spmm_impl`` is a paired one.  Must agree between
    ``init_encoder_params`` and ``encode``."""
    check_spmm_impl(spmm_impl)
    if spmm_impl not in PAIRED_IMPLS:
        return set()
    return {key for key, adj in graph.adj.items() if adj.pair_mask is not None}


def init_encoder_params(
    generator: torch.Generator,
    graph: DeviceGraph,
    hidden1: int,
    hidden2: int,
    dtype: torch.dtype = torch.float32,
    spmm_impl: str = "auto",
) -> Params:
    """Stacked per-relation Glorot weights per edge type, drawn from
    ``generator``: enc1[etk] [K, F_j, hidden1], enc2[etk] [K, hidden1,
    hidden2]; paired edge types store the same weights transposed,
    [2, K/2, hidden1, F_j] / [2, K/2, hidden2, hidden1]."""
    paired = paired_edge_types(graph, spmm_impl)
    enc1, enc2 = {}, {}
    for et in graph.edge_types:
        key = etkey(et)
        k_rel = graph.num_relations(et)
        feat_dim = graph.feature_dims[et[1]]
        if key in paired:
            shape1 = (2, k_rel // 2, hidden1, feat_dim)
            shape2 = (2, k_rel // 2, hidden2, hidden1)
        else:
            shape1 = (k_rel, feat_dim, hidden1)
            shape2 = (k_rel, hidden1, hidden2)
        enc1[key] = glorot(generator, shape1, fan=(feat_dim, hidden1), dtype=dtype)
        enc2[key] = glorot(generator, shape2, fan=(hidden1, hidden2), dtype=dtype)
    return {"enc1": enc1, "enc2": enc2}


def _dropped(mask: Optional[torch.Tensor], x: torch.Tensor, keep: float) -> torch.Tensor:
    return x if mask is None else torch.where(mask, x / keep, 0.0)


def _project(
    feat: Optional[torch.Tensor],
    weights: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    keep: float = 1.0,
) -> torch.Tensor:
    """Per-relation projected features P [K, N_src, H] (identity features:
    ``X @ W == W``).  ``mask``: this edge type's keep-mask from the layer's
    draw ([K, F, 1], [K, N, F] or [N, F]), or None for no dropout."""
    if feat is None:
        return _dropped(mask, weights, keep)
    x = _dropped(mask, feat, keep)
    if x.dim() == 3:
        return torch.einsum("knf,kfh->knh", x, weights)
    return torch.einsum("nf,kfh->knh", x, weights)


def _project_t(
    feat: Optional[torch.Tensor],
    weights_t: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    keep: float = 1.0,
) -> torch.Tensor:
    """Transposed projection for paired edge types: P^T [2, K, H, N].
    ``mask``: [2, K, 1, F] (identity), [2K, N, F] or [N, F] (dense), or
    None."""
    if feat is None:
        return _dropped(mask, weights_t, keep)
    x = _dropped(mask, feat, keep)
    if x.dim() == 3:
        x = x.reshape(weights_t.shape[0], weights_t.shape[1], *x.shape[1:])
        return torch.einsum("skhf,sknf->skhn", weights_t, x)
    return torch.einsum("skhf,nf->skhn", weights_t, x)


def layer_mask_spans(
    params: Params,
    graph: DeviceGraph,
    level: str,
    inputs: Dict[str, Optional[torch.Tensor]],
    paired: set,
    per_relation_dropout_max: int,
):
    """(etkey, start, shape) of each edge type's mask within the layer's
    one flat draw, in sorted edge-type order, and the draw's length."""
    spans, total = [], 0
    for et in graph.edge_types:
        key = etkey(et)
        w = params[level][key]
        k = 2 * w.shape[1] if key in paired else w.shape[0]
        feat = inputs[str(et[1])]
        if feat is None:
            shape = (
                (2, w.shape[1], 1, w.shape[3]) if key in paired
                else (k, w.shape[1], 1)
            )
        elif k <= per_relation_dropout_max:
            shape = (k,) + tuple(feat.shape)
        else:
            shape = tuple(feat.shape)
        spans.append((key, total, shape))
        total += int(np.prod(shape))
    return spans, total


def _layer_masks(
    params: Params,
    graph: DeviceGraph,
    level: str,
    inputs: Dict[str, Optional[torch.Tensor]],
    paired: set,
    per_relation_dropout_max: int,
    bits: Optional[torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """{etkey: keep-mask} cut from the layer's flat draw ``bits`` (empty
    for None)."""
    if bits is None:
        return {}
    spans, total = layer_mask_spans(
        params, graph, level, inputs, paired, per_relation_dropout_max
    )
    if tuple(bits.shape) != (total,):
        raise ValueError(f"{level}: expected {total} dropout bits, got {tuple(bits.shape)}")
    return {
        key: bits[start : start + int(np.prod(shape))].reshape(shape)
        for key, start, shape in spans
    }


def resolve_impl(adj, base_impl: str) -> str:
    """The aggregation form of one non-paired edge type: ``base_impl``
    unless it is "auto".  On CUDA the JAX package's accelerator dispatch
    (the factored stack, the dense stack, the CSR layouts through K6, the
    COO stream); on the CPU the factored stack where built, else the COO
    stream."""
    if base_impl != "auto":
        return base_impl
    if adj.dense_mask is not None:
        return "dense_factored"
    if adj.senders.is_cuda and adj.dense is not None:
        return "dense"
    if adj.senders.is_cuda and adj.tiles_fwd is not None:
        return "pallas"
    return "xla"


def encode_layer(
    params: Params,
    graph: DeviceGraph,
    level: str,
    inputs: Dict[str, Optional[torch.Tensor]],
    relu: bool,
    spmm_impl: str = "auto",
    dropout_rate: float = 0.0,
    bits: Optional[torch.Tensor] = None,
    per_relation_dropout_max: int = 64,
    spmm_precision: str = "highest",
    group=None,
) -> Dict[str, torch.Tensor]:
    """One encoder layer: per node type, the sum over incoming edge types
    of the row-normalized aggregation (``relu`` applied to the sum).
    ``bits``: the layer's flat bool keep-draw (``layer_mask_spans``), or
    None for no dropout.  ``group``: a process group over which each
    aggregation is summed (``parallel.collectives.all_reduce_sum``) before
    it is normalized, for a graph whose edges are split over its ranks."""
    if spmm_impl in FUSED_IMPLS:
        return fused_layer(
            params, graph, level, inputs, relu, spmm_impl, dropout_rate, bits,
            per_relation_dropout_max, spmm_precision, group,
        )
    paired = paired_edge_types(graph, spmm_impl)
    pimpl = "paired_ref" if spmm_impl == "paired_ref" else "auto"
    base_impl = "auto" if spmm_impl in PAIRED_IMPLS else spmm_impl
    keep = 1.0 - dropout_rate
    masks = _layer_masks(params, graph, level, inputs, paired, per_relation_dropout_max, bits)

    out: Dict[str, torch.Tensor] = {}
    for i in range(len(graph.num_nodes)):
        acc = None
        for et in graph.edge_types:
            if et[0] != i:
                continue
            key = etkey(et)
            adj = graph.adj[key]
            feat = inputs[str(et[1])]
            w = params[level][key]
            m = masks.get(key)
            if key in paired and feat is None:
                ds = None
                if m is not None:
                    ds = torch.where(m[:, :, 0, :], 1.0 / keep, 0.0).transpose(0, 1)
                agg = spmm_paired_identity(w, ds, adj, impl=pimpl)
            elif key in paired:
                agg = spmm_paired(_project_t(feat, w, m, keep), adj, impl=pimpl)
            else:
                agg = spmm(
                    _project(feat, w, m, keep), adj, impl=resolve_impl(adj, base_impl),
                    precision=spmm_precision,
                )
            if group is not None:
                from decagon_tpu_torch.parallel.collectives import all_reduce_sum

                agg = all_reduce_sum(group)(agg)
            term = l2_normalize_rows(agg)
            acc = term if acc is None else acc + term
        if acc is None:
            raise ValueError(f"node type {i} has no incoming edge types")
        out[str(i)] = torch.relu(acc) if relu else acc
    return out


def fused_layer(
    params: Params,
    graph: DeviceGraph,
    level: str,
    inputs: Dict[str, Optional[torch.Tensor]],
    relu: bool,
    spmm_impl: str = "fused",
    dropout_rate: float = 0.0,
    bits: Optional[torch.Tensor] = None,
    per_relation_dropout_max: int = 64,
    spmm_precision: str = "highest",
    group=None,
) -> Dict[str, torch.Tensor]:
    """``encode_layer``'s math with every edge type aggregated at once over
    ``graph.fused``: the projected stacks concatenated in layout order,
    then one gather and one ``index_add_`` ("fused") or one K6 launch
    ("fused_pallas"; "fused_pallas_ref" its plain version); each term is
    row-normalized on its own, as in ``encode_layer``.  ``group``: as
    there, the whole term space summed over it."""
    fa = graph.fused
    if fa is None:
        raise ValueError(
            f"spmm_impl={spmm_impl!r} requires a device graph built with the "
            "fused stream (build_device_graph default)"
        )
    keep = 1.0 - dropout_rate
    masks = _layer_masks(params, graph, level, inputs, set(), per_relation_dropout_max, bits)
    parts = []
    for key, _, _, _ in fa.layout:
        w = params[level][key]
        p = _project(inputs[str(parse_etkey(key)[1])], w, masks.get(key), keep)
        parts.append(p.reshape(-1, w.shape[-1]))
    p_global = torch.cat(parts, dim=0)
    if spmm_impl == "fused":
        msgs = p_global[fa.src.long()] * fa.vals[:, None]
        t_global = torch.zeros(
            (fa.n_t_rows, p_global.shape[1]), dtype=msgs.dtype, device=msgs.device
        ).index_add(0, fa.dst.long(), msgs)
    else:
        t_global = spmm_pallas_flat(
            p_global, fa, spmm_precision, ref=spmm_impl == "fused_pallas_ref"
        )
    if group is not None:
        from decagon_tpu_torch.parallel.collectives import all_reduce_sum

        t_global = all_reduce_sum(group)(t_global)
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(graph.num_nodes)):
        acc = None
        for key, t_start, n_i in fa.terms:
            if parse_etkey(key)[0] != i:
                continue
            term = l2_normalize_rows(t_global[t_start : t_start + n_i])
            acc = term if acc is None else acc + term
        if acc is None:
            raise ValueError(f"node type {i} has no incoming edge types")
        out[str(i)] = torch.relu(acc) if relu else acc
    return out


def draw_layer_bits(
    params: Params,
    graph: DeviceGraph,
    generator: torch.Generator,
    dropout_rate: float,
    spmm_impl: str = "auto",
    per_relation_dropout_max: int = 64,
) -> LayerBits:
    """Both layers' flat keep-draws, {"enc1": bool [total1], "enc2": bool
    [total2]} on the graph's device: one ``torch.rand`` per layer from
    ``generator``, layer 1 first, the draws ``encode`` makes itself."""
    paired = paired_edge_types(graph, spmm_impl)
    key = etkey(graph.edge_types[0])
    w = params["enc1"][key]
    hidden1 = w.shape[2] if key in paired else w.shape[-1]
    h1 = {
        str(t): torch.empty((n, hidden1), device="meta")
        for t, n in enumerate(graph.num_nodes)
    }
    bits = {}
    for level, inputs in (("enc1", graph.features), ("enc2", h1)):
        _, total = layer_mask_spans(
            params, graph, level, inputs, paired, per_relation_dropout_max
        )
        u = torch.rand(total, generator=generator, device=generator.device)
        bits[level] = (u < 1.0 - dropout_rate).to(graph.device)
    return bits


def encode(
    params: Params,
    graph: DeviceGraph,
    generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    spmm_impl: str = "auto",
    per_relation_dropout_max: int = 64,
    layer_bits: Optional[LayerBits] = None,
    spmm_precision: str = "highest",
    group=None,
) -> Dict[str, torch.Tensor]:
    """Node embeddings per type: {"0": [N_0, H2], ...}.

    Dropout runs when ``deterministic`` is False, ``dropout_rate`` > 0 and
    either ``generator`` (one Bernoulli draw per layer, on the generator's
    device, ``draw_layer_bits``) or ``layer_bits`` ({"enc1": bool [total1],
    "enc2": bool [total2]}, replacing the draws) is given.
    ``spmm_precision`` steers the K6 paths ("pallas", "fused_pallas").
    ``group`` (the JAX package's ``axis_name``): a process group over which
    every aggregation is summed before normalization, so that ranks holding
    disjoint parts of the edges and the same parameters compute the whole
    graph's embeddings."""
    check_spmm_impl(spmm_impl)
    paired = paired_edge_types(graph, spmm_impl)
    if paired and spmm_impl in FUSED_IMPLS:
        raise ValueError(
            "fused spmm impls are incompatible with paired mask stacks; "
            "build the device graph without dense_paired"
        )
    bits = None
    if not deterministic and dropout_rate > 0.0:
        if layer_bits is None and generator is not None:
            layer_bits = draw_layer_bits(
                params, graph, generator, dropout_rate, spmm_impl, per_relation_dropout_max
            )
        if layer_bits is not None:
            bits = {level: b.to(graph.device) for level, b in layer_bits.items()}
    kw = dict(
        spmm_impl=spmm_impl, dropout_rate=dropout_rate,
        per_relation_dropout_max=per_relation_dropout_max, spmm_precision=spmm_precision,
        group=group,
    )
    h1 = encode_layer(
        params, graph, "enc1", graph.features, True,
        bits=None if bits is None else bits["enc1"], **kw,
    )
    return encode_layer(
        params, graph, "enc2", h1, False, bits=None if bits is None else bits["enc2"], **kw
    )
