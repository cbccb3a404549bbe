"""The port's data layer (``decagon_tpu_torch.data``, ``graph/ids.py``)
against the JAX package's, on the same files.

The public-data loaders parse CSVs that the tests write (``_write_public_csvs``,
the port's copy of the JAX shell tests' helper), through the native parser
and through the Python fallback; relations, ids, names and features must be
equal.  The repair tools and the held-out-edge CSV must write the same
bytes.  Everything here is numpy and ``csv``: exact equality throughout.
"""

import numpy as np
import pytest

from decagon_tpu import native as jax_native
from decagon_tpu.data import public as jax_public
from decagon_tpu.data import record as jax_record
from decagon_tpu.data import repair as jax_repair
from decagon_tpu.graph import ids as jax_ids
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu.graph.synthetic import make_synthetic_graph as jax_synthetic
from decagon_tpu_torch import native
from decagon_tpu_torch.data import public, record, repair
from decagon_tpu_torch.graph import ids
from decagon_tpu_torch.graph.split import split_graph
from decagon_tpu_torch.graph.synthetic import make_synthetic_graph


def _write_public_csvs(tmp_path):
    rng = np.random.default_rng(0)
    drugs = [f"CID{d:09d}" for d in range(1, 21)]
    proteins = [str(p) for p in range(1000, 1030)]
    combo = ["STITCH 1,STITCH 2,Polypharmacy Side Effect,Side Effect Name"]
    for rel, count in [("C0000001", 30), ("C0000002", 25), ("C0000003", 3)]:
        seen = set()
        while len(seen) < count:
            a, b = rng.choice(20, 2, replace=False)
            seen.add((min(a, b), max(a, b)))
        combo += [f"{drugs[a]},{drugs[b]},{rel},fake" for a, b in seen]
    ppi = ["Gene 1,Gene 2"] + [
        f"{proteins[a]},{proteins[b]}"
        for a, b in {(min(a, b), max(a, b))
                     for a, b in rng.choice(30, (60, 2)) if a != b}
    ]
    targets = ["STITCH,Gene"] + [
        f"{drugs[rng.integers(20)]},{proteins[rng.integers(30)]}"
        for _ in range(40)
    ]
    mono = ["STITCH,Individual Side Effect,Side Effect Name"] + [
        f"{drugs[rng.integers(20)]},C005{rng.integers(10):04d},fake"
        for _ in range(50)
    ]
    paths = {}
    for name, rows in [("combo", combo), ("ppi", ppi),
                       ("targets", targets), ("mono", mono)]:
        p = tmp_path / f"{name}.csv"
        p.write_text("\n".join(rows) + "\n")
        paths[name] = str(p)
    return paths


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A build directory of this worker's own for the JAX package's
    library: its build writes one fixed temporary name, which another
    test worker building at the same moment would share."""
    return str(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture(params=["native", "python"])
def parse_path(request, monkeypatch, jax_cache):
    """Both packages' CSV parsing through their native libraries, or both
    through the Python fallback (globals restored after the test)."""
    monkeypatch.setenv("DECAGON_TPU_NATIVE_CACHE", jax_cache)
    for module, env in ((native, native.DISABLE_ENV),
                        (jax_native, "DECAGON_TPU_DISABLE_NATIVE")):
        monkeypatch.setattr(module, "_TRIED", False)
        monkeypatch.setattr(module, "_LIB", None)
        if request.param == "python":
            monkeypatch.setenv(env, "1")
        else:
            monkeypatch.delenv(env, raising=False)
    if request.param == "native":
        assert native.get_library() is not None and jax_native.get_library() is not None
    return request.param


def _assert_datasets_equal(got, want):
    assert got.drug_ids == want.drug_ids
    assert got.protein_ids == want.protein_ids
    assert got.relation_names == want.relation_names
    g, w = got.graph, want.graph
    assert g.node_type_names == w.node_type_names and g.num_nodes == w.num_nodes
    assert g.decoders == w.decoders
    assert sorted(g.relations) == sorted(w.relations)
    for et in w.relations:
        assert len(g.relations[et]) == len(w.relations[et])
        for a, b in zip(g.relations[et], w.relations[et]):
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.cols, b.cols)
            assert (a.shape, a.name, a.transpose_of) == (b.shape, b.name, b.transpose_of)
    for t in w.features:
        a, b = g.features[t], w.features[t]
        assert a.kind == b.kind
        if b.kind == "dense":
            np.testing.assert_array_equal(a.dense, b.dense)


@pytest.mark.parametrize(
    "kwargs",
    [dict(min_edges_per_relation=20, with_transposes=True),
     dict(min_edges_per_relation=1, with_transposes=False, drug_decoder="distmult"),
     dict(relation_allowlist={3}, with_transposes=False, mono=False)],
    ids=["filtered", "all_relations", "allowlist_no_mono"],
)
def test_public_dataset_equals_jax(tmp_path, parse_path, kwargs):
    paths = _write_public_csvs(tmp_path)
    kwargs = dict(kwargs)
    mono = paths["mono"] if kwargs.pop("mono", True) else None
    args = (paths["combo"], paths["ppi"], paths["targets"], mono)
    got = public.load_public_dataset(*args, **kwargs)
    want = jax_public.load_public_dataset(*args, **kwargs)
    _assert_datasets_equal(got, want)
    assert public.load_public_graph(*args, **kwargs).num_nodes == got.graph.num_nodes


def test_public_dataset_native_equals_python(tmp_path, monkeypatch):
    """The port's own two parse paths give the same dataset."""
    paths = _write_public_csvs(tmp_path)
    args = (paths["combo"], paths["ppi"], paths["targets"], paths["mono"])
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    got = public.load_public_dataset(*args, min_edges_per_relation=20)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setenv(native.DISABLE_ENV, "1")
    want = public.load_public_dataset(*args, min_edges_per_relation=20)
    _assert_datasets_equal(got, want)


def test_public_dataset_constants_and_errors(tmp_path):
    assert public.NAMED_SIDE_EFFECTS == jax_public.NAMED_SIDE_EFFECTS
    paths = _write_public_csvs(tmp_path)
    with pytest.raises(ValueError, match="no drug-drug relation"):
        public.load_public_dataset(paths["combo"], paths["ppi"], paths["targets"],
                                   min_edges_per_relation=1000)


@pytest.mark.parametrize(
    "value", ["CID000012314", "C0001234", "9796", 42, "CID000000000", "", "x10y20", "0007"]
)
@pytest.mark.parametrize("kind", ["ProteinId", "DrugId", "SideEffectId"])
def test_ids_equal_jax(kind, value):
    got, want = getattr(ids, kind)(value), getattr(jax_ids, kind)(value)
    assert int(got) == int(want) and got.to_external() == want.to_external()
    assert type(got).from_external(got.to_external()) == got


def _write_bad_csv(path):
    path.write_text(
        "FromNode,ToNode,RelationId,Label\n"
        "CID000000001,CID000000002,C0000001,1\n"
        "CID000000003,,C0000001,1\n"
        " CID000000004 ,CID000000005,C0000001,0\n"
        "CID000000006,CID000000007,C0000001,2\n"
        "CID000000008,CID000000009,C0000001\n"
        "CID000000010,CID000000011,,C0000002,0\n"
    )


def test_repair_heldout_csv_writes_the_same_bytes(tmp_path, capsys):
    bad = tmp_path / "edges.csv"
    _write_bad_csv(bad)
    got = repair.repair_heldout_edges_csv(str(bad), str(tmp_path / "port.csv"))
    want = jax_repair.repair_heldout_edges_csv(str(bad), str(tmp_path / "jax.csv"))
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port.csv", "") == out[1].replace("jax.csv", "")
    assert open(got, "rb").read() == open(want, "rb").read()
    assert len(open(got).read().splitlines()) == 4
    assert repair.repair_heldout_edges_csv(str(bad)) == str(bad) + ".repaired"


def test_repair_npz_equals_jax(tmp_path):
    npz = tmp_path / "dump.npz"
    np.savez(npz, arr_0=np.ones(3), arr_1=np.arange(4.0), keepme=np.zeros((2, 2)))
    key_map = {"arr_0": "EmbeddingImportance-C0000001", "arr_1": "GlobalRelations"}
    got = repair.repair_npz_archive(str(npz), key_map, str(tmp_path / "port.npz"))
    want = jax_repair.repair_npz_archive(str(npz), key_map, str(tmp_path / "jax.npz"))
    with np.load(got) as a, np.load(want) as b:
        assert a.files == b.files
        for name in b.files:
            np.testing.assert_array_equal(a[name], b[name])
    assert repair.HEADER == jax_repair.HEADER


@pytest.mark.parametrize("with_ids", [False, True], ids=["index_ids", "stitch_ids"])
def test_heldout_csv_writes_the_same_bytes(tmp_path, with_ids):
    g_ref = jax_synthetic(n_genes=60, n_drugs=30, n_drugdrug_types=2, seed=0)
    g = make_synthetic_graph(n_genes=60, n_drugs=30, n_drugdrug_types=2, seed=0)
    s_ref = jax_split(g_ref, val_frac=0.1, test_frac=0.05, seed=1)
    s = split_graph(g, val_frac=0.1, test_frac=0.05, seed=1)
    kw = {}
    if with_ids:
        rng = np.random.default_rng(5)
        kw = dict(
            protein_ids=[int(x) for x in rng.choice(10**6, 60, replace=False)],
            drug_ids=[int(x) for x in rng.choice(10**6, 30, replace=False)],
            relation_names=["C0027947", "C0020456"],
        )
    got = record.write_heldout_edges_csv(g, s, str(tmp_path / "port.csv"), **kw)
    want = jax_record.write_heldout_edges_csv(g_ref, s_ref, str(tmp_path / "jax.csv"), **kw)
    data = open(got, "rb").read()
    assert data == open(want, "rb").read()
    assert data.count(b"\n") > 20
    assert record.FIELDS == jax_record.FIELDS


def test_timestamped_path_keeps_the_reference_form():
    got = record.timestamped_path("out/edges.csv")
    assert got.startswith("out/edges-") and got.endswith(".csv") and " " not in got
    assert record.timestamped_path("edges").startswith("edges-")
