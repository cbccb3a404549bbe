"""The port's bench (``decagon_tpu_torch/bench.py``): its dense and
factored configs, ported from the JAX package's ``bench.py`` (``full_dense_bf16``,
``full_factored_int8``), run on a small graph on the CPU, and the headline's
choice among the stack configs, and ``sparse_regime_ref``, the sparse
regime's record lifted into the bench's output."""

import json

import pytest
import torch

from decagon_tpu_torch import bench
from decagon_tpu_torch.graph.device import build_device_graph
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_polypharmacy_like_graph
from decagon_tpu_torch.train.trainer import Trainer

SMALL = dict(
    n_proteins=300, n_drugs=60, n_side_effects=6, min_edges_per_relation=20,
    ppi_attachment=5, seed=7,
)
# The fields of a config in the JAX bench (``_config_metrics`` and the
# stack configs' additions), by config.
JAX_FIELDS = {
    "full_dense_bf16": {"edges_per_s", "ms_per_step_min", "ms_per_step_median", "nnz",
                        "effective_tflops", "hbm_util", "dense_stacks_gb"},
    "full_factored_int8": {"edges_per_s", "ms_per_step_min", "ms_per_step_median", "nnz",
                           "effective_tflops", "hbm_util", "mask_stacks_gb", "vs_dense"},
}


class RecordingTrainer(Trainer):
    """A ``Trainer`` that keeps every instance and the ``init_state`` it
    was given."""

    made = []

    def __init__(self, *args, init_state=None, **kwargs):
        super().__init__(*args, init_state=init_state, **kwargs)
        self.given_state = init_state
        RecordingTrainer.made.append(self)


@pytest.fixture(scope="module")
def run():
    graph = make_polypharmacy_like_graph(**SMALL)
    splits = split_graph(graph, val_frac=0.05, test_frac=0.05, seed=1)
    RecordingTrainer.made = []
    configs = bench.bench_dense_factored(graph, splits, torch.device("cpu"), chunk=2, windows=1,
                                         trainer_cls=RecordingTrainer)
    return graph, splits, configs, list(RecordingTrainer.made)


def test_dense_and_factored_configs_carry_the_jax_fields(run):
    _, _, configs, _ = run
    configs = {key: dict(c) for key, c in configs.items()}
    paired = dict(configs["full_dense_bf16"], ms_per_step_min=1e9)
    configs["full_paired_int8"] = paired
    headline = bench.pick_headline(configs)
    bench.add_ratios(configs, headline)
    for key, fields in JAX_FIELDS.items():
        assert fields <= set(configs[key]), (key, fields - set(configs[key]))
        c = configs[key]
        assert c["ms_per_step_min"] > 0 and c["nnz"] > 0 and c["peak_memory_gib"] is None
        assert len(c["window_ms"]) == 1 and c["host_build_s"] > 0
        assert ("vs_headline" in c) == (key != headline)


@pytest.mark.parametrize("key,build,field", [
    ("full_dense_bf16", dict(dense_dtype=torch.bfloat16), "dense"),
    ("full_factored_int8", dict(dense_factored=True), "dense_mask"),
])
def test_hbm_util_reads_the_stacks_bytes(run, key, build, field):
    graph, splits, configs, _ = run
    dg = build_device_graph(graph, splits, densify_max_cells=1_000_000_000, build_fused=False,
                            device="cpu", **build)
    stacks = [getattr(a, field) for a in dg.adj.values() if getattr(a, field) is not None]
    assert len(stacks) == len(dg.adj)
    if field == "dense":
        assert all(x.dtype == torch.bfloat16 for x in stacks)
        assert all(a.dense_mask is None and a.pair_mask is None for a in dg.adj.values())
    else:
        assert all(x.dtype == torch.int8 for x in stacks)
        assert all(a.pair_mask is None and a.dense_mask_t is not None for a in dg.adj.values())
    stack_bytes = sum(x.numel() * x.element_size() for x in stacks)
    c = configs[key]
    size = c["dense_stacks_gb" if field == "dense" else "mask_stacks_gb"]
    assert size == stack_bytes / 1e9
    want = 4 * stack_bytes / (c["ms_per_step_min"] / 1e3) / bench.HBM_BYTES_S
    assert c["hbm_util"] == pytest.approx(want, rel=1e-12)


def test_factored_trainer_starts_from_the_dense_trainers_state(run):
    _, _, _, (dense, factored) = run
    assert dense.given_state is None and factored.given_state is not None
    assert dense.model.config.spmm_impl == "dense"
    assert factored.model.config.spmm_impl == "dense_factored"
    start = factored.given_state
    assert start["global_step"] == dense.global_step > 0
    assert start["opt_state"]["t"] == dense.opt_state["t"]

    def same(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for key in a:
                same(a[key], b[key])
        elif isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()

    # A copy of the dense trainer's final state, which the factored run
    # does not write through.
    same(start["params"], dense.params)
    same(start["opt_state"], dense.opt_state)


@pytest.mark.parametrize("fastest", bench.HEADLINE_CANDIDATES)
def test_headline_is_the_fastest_stack_config(fastest):
    configs = {key: {"ms_per_step_min": 10.0 + i} for i, key in enumerate(
        bench.HEADLINE_CANDIDATES + ("full_pallas_bf16",))}
    configs[fastest]["ms_per_step_min"] = 5.0
    configs["full_pallas_bf16"]["ms_per_step_min"] = 1.0  # not a candidate
    assert bench.pick_headline(configs) == fastest
    bench.add_ratios(configs, fastest)
    assert "vs_headline" not in configs[fastest]
    dense = configs["full_dense_bf16"]["ms_per_step_min"]
    for key, c in configs.items():
        if key != fastest:
            assert c["vs_headline"] == c["ms_per_step_min"] / 5.0
        assert ("vs_dense" in c) == (key != "full_dense_bf16")
        if key != "full_dense_bf16":
            assert c["vs_dense"] == c["ms_per_step_min"] / dense


@pytest.mark.parametrize("chunk_cells", [1 << 27, 3000], ids=["one-chunk", "chunks"])
def test_bf16_dense_spmm_matches_reference(monkeypatch, chunk_cells):
    """``full_dense_bf16``'s aggregation (``ops/segment.spmm_dense`` on a bf16
    stack, a chunk of relations at a time) against the JAX package's
    ``spmm(impl="dense")`` on the same bf16 stack: output and VJP within
    1e-5 of the largest value (f32 sums in other orders), the gradient
    also one bf16 ulp of each element (both round ``A^T ct`` to bf16, where
    sums in another order can round to the neighbouring value)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from decagon_tpu.graph.device import build_device_graph as jax_build
    from decagon_tpu.graph.split import split_graph as jax_split
    from decagon_tpu.graph.synthetic import make_polypharmacy_like_graph as jax_graph
    from decagon_tpu.ops import segment as jax_segment
    from decagon_tpu_torch.ops import segment

    monkeypatch.setattr(segment, "_DENSE_CHUNK_CELLS", chunk_cells)
    g_ref = jax_graph(**SMALL)
    ref = jax_build(g_ref, jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=1),
                    dense_dtype=jnp.bfloat16, build_fused=False)
    g = make_polypharmacy_like_graph(**SMALL)
    dg = build_device_graph(g, split_graph(g, val_frac=0.05, test_frac=0.05, seed=1),
                            dense_dtype=torch.bfloat16, build_fused=False, device="cpu")
    rng = np.random.default_rng(7)
    for key in ("0,1", "1,1", "0,0"):
        a_ref, a = ref.adj[key], dg.adj[key]
        assert a.dense.dtype == torch.bfloat16
        if a.num_rel > 1 and chunk_cells < a.dense.numel():
            assert len(segment._relation_chunks(a.dense)) > 1
        p = rng.standard_normal((a.num_rel, a.n_cols, 8)).astype(np.float32)
        ct = rng.standard_normal((a.n_rows, 8)).astype(np.float32)
        out_j, vjp = jax.vjp(lambda q: jax_segment.spmm(q, a_ref, impl="dense"),
                             jnp.asarray(p))
        (want,) = vjp(jnp.asarray(ct))
        pt = torch.from_numpy(p).requires_grad_(True)
        out = segment.spmm(pt, a, impl="dense")
        out.backward(torch.from_numpy(ct))
        for got, w in ((out.detach().numpy(), np.asarray(out_j)),
                       (pt.grad.numpy(), np.asarray(want))):
            err = np.abs(got.astype(np.float64) - w)
            assert (err <= 1e-5 * np.abs(w).max() + 2.0 ** -7 * np.abs(w)).all(), key


# ``sparse_regime_ref``: the sparse regime's summary fields lifted from its
# record, as the JAX bench lifts them from ``sparse_regime_bench.json``.
SPARSE_RECORD = {
    "paper_cap": {"workload": "w"}, "workload": "w", "xla": {"ms_per_step_min": 20.0},
    "pallas_bf16": {"ms_per_step_min": 8.0}, "pallas_vs_xla": 2.5, "device": "NVIDIA H100",
}


def test_sparse_regime_ref_lifts_the_summary_fields(tmp_path):
    path = tmp_path / "torch_sparse_regime_bench.json"
    path.write_text(json.dumps(SPARSE_RECORD))
    ref = bench.sparse_regime_ref(str(path))
    assert set(ref) == {"source", *bench.SPARSE_REGIME_FIELDS}
    for key in bench.SPARSE_REGIME_FIELDS:
        assert ref[key] == SPARSE_RECORD[key]
    assert "bench_sparse_regime.py" in ref["source"]
    assert bench.SPARSE_REGIME.endswith("artifacts/perf/torch_sparse_regime_bench.json")


def test_sparse_regime_ref_is_absent_without_a_record(tmp_path):
    assert bench.sparse_regime_ref(str(tmp_path / "missing.json")) is None


@pytest.mark.parametrize("text", [
    "{not json", "[1, 2]",
    json.dumps({k: v for k, v in SPARSE_RECORD.items() if k != "pallas_vs_xla"}),
], ids=["not-json", "not-an-object", "missing-field"])
def test_sparse_regime_ref_raises_on_a_malformed_record(tmp_path, text):
    path = tmp_path / "torch_sparse_regime_bench.json"
    path.write_text(text)
    with pytest.raises(ValueError):
        bench.sparse_regime_ref(str(path))
