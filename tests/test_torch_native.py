"""The port's native host runtime (``decagon_tpu_torch.native``) against the
JAX package's, and the split that uses it.

Both packages build their own copy of ``graphcore.cpp`` with ``g++``; the
port's sampler and CSV parser must give the JAX package's rows bit for
bit, and ``split_graph`` with a holdout over 4,096 edges (the size at
which the samplers hand off to C++) must equal the JAX split exactly, with
both libraries loaded and with both switched off.  Each test that turns a
library off restores both packages' module globals and switches after it
(``monkeypatch``), so no other test in the worker sees the change.
"""

import numpy as np
import pytest

from decagon_tpu import native as jax_native
from decagon_tpu.graph import container as jax_container
from decagon_tpu.graph.split import split_graph as jax_split
from decagon_tpu_torch import native
from decagon_tpu_torch.graph import container
from decagon_tpu_torch.graph.split import split_graph

CSV_TEXT = (
    "STITCH 1,STITCH 2,Side Effect\n"
    "CID000000042,CID000000007,C0001234\n"
    "CID000000001,CID000000002,C0000099\n"
    "bad,row,here\n"
    "CID000000003,CID000000004,C0000001\n"
)


def _fresh(monkeypatch, module, disabled_env, disabled):
    """Make ``module`` try its library again at next use, on or off; the
    globals and the switch come back after the test."""
    monkeypatch.setattr(module, "_TRIED", False)
    monkeypatch.setattr(module, "_LIB", None)
    if disabled:
        monkeypatch.setenv(disabled_env, "1")
    else:
        monkeypatch.delenv(disabled_env, raising=False)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A build directory of this worker's own for the JAX package's
    library: its build writes one fixed temporary name, which another
    test worker building at the same moment would share."""
    return str(tmp_path_factory.mktemp("jax_native"))


@pytest.fixture
def libs(monkeypatch, jax_cache):
    """Both packages' libraries, built (or found) afresh."""
    monkeypatch.setenv("DECAGON_TPU_NATIVE_CACHE", jax_cache)
    _fresh(monkeypatch, native, native.DISABLE_ENV, False)
    _fresh(monkeypatch, jax_native, "DECAGON_TPU_DISABLE_NATIVE", False)
    if native.get_library() is None or jax_native.get_library() is None:
        pytest.fail("g++ failed to build a native library")


@pytest.fixture
def both_off(monkeypatch):
    _fresh(monkeypatch, native, native.DISABLE_ENV, True)
    _fresh(monkeypatch, jax_native, "DECAGON_TPU_DISABLE_NATIVE", True)


def test_library_builds_into_the_port_tree(libs):
    path = native.BUILD_INFO["path"]
    assert path.startswith(str(native.BUILD_DIR)) and path.endswith(".so")
    assert native.BUILD_INFO["seconds"] >= 0.0
    lib = native.get_library()
    assert hasattr(lib, "dt_sample_false_edges") and hasattr(lib, "dt_parse_edge_csv")
    assert not hasattr(native, "build_tiles_arrays")


def test_switches_are_separate(monkeypatch, libs):
    """Turning one package's library off leaves the other's on."""
    _fresh(monkeypatch, native, native.DISABLE_ENV, True)
    assert native.get_library() is None
    assert native.sample_false_edges(np.zeros(1), np.zeros(1), (4, 4), 2, 0) is None
    assert jax_native.get_library() is not None
    _fresh(monkeypatch, native, native.DISABLE_ENV, False)
    _fresh(monkeypatch, jax_native, "DECAGON_TPU_DISABLE_NATIVE", True)
    assert jax_native.get_library() is None
    assert native.get_library() is not None


def test_failed_build_falls_back(monkeypatch, capsys):
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ["-fno-such-flag"])
    _fresh(monkeypatch, native, native.DISABLE_ENV, False)
    assert native.get_library() is None
    assert "build failed" in capsys.readouterr().err
    assert native.parse_edge_csv(__file__, 2) is None


@pytest.mark.parametrize(
    "n_rows,n_cols,n_pos,count,seed",
    [(120, 120, 3000, 5000, 7), (300, 57, 900, 4097, 1), (2000, 2000, 40000, 30000, 2**61 + 5)],
)
def test_sampler_equals_jax_bit_for_bit(libs, n_rows, n_cols, n_pos, count, seed):
    rng = np.random.default_rng(n_rows)
    pos = np.unique(
        np.stack([rng.integers(0, n_rows, n_pos), rng.integers(0, n_cols, n_pos)], 1), axis=0
    ).astype(np.int64)
    got = native.sample_false_edges(pos[:, 0], pos[:, 1], (n_rows, n_cols), count, seed=seed)
    want = jax_native.sample_false_edges(pos[:, 0], pos[:, 1], (n_rows, n_cols), count, seed=seed)
    assert got is not None and got.dtype == np.int32 and got.shape == (count, 2)
    np.testing.assert_array_equal(got, want)
    forbidden = {(int(r), int(c)) for r, c in pos}
    drawn = {(int(r), int(c)) for r, c in got}
    assert len(drawn) == count and drawn.isdisjoint(forbidden)


def test_sampler_refuses_an_impossible_draw(libs):
    pos = np.array([[0, 0], [0, 1], [1, 0]], np.int64)
    assert native.sample_false_edges(pos[:, 0], pos[:, 1], (2, 2), 2, seed=0) is None


@pytest.mark.parametrize("n_fields", [2, 3])
def test_csv_parser_equals_jax(tmp_path, libs, n_fields):
    path = tmp_path / "edges.csv"
    path.write_text(CSV_TEXT)
    got = native.parse_edge_csv(str(path), n_fields)
    want = jax_native.parse_edge_csv(str(path), n_fields)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.array([[42, 7, 1234], [1, 2, 99], [3, 4, 1]])[:, :n_fields])


def test_csv_parser_equals_jax_on_a_large_file(tmp_path, libs):
    """CRLF line ends, blank lines, extra columns and malformed rows."""
    rng = np.random.default_rng(3)
    lines = ["STITCH 1,STITCH 2,Polypharmacy Side Effect,Side Effect Name"]
    for i in range(20000):
        a, b, c = rng.integers(0, 10**9, 3)
        kind = i % 50
        if kind == 0:
            lines.append("")
        elif kind == 1:
            lines.append(f"CID{a:09d},,C{c:07d},x")
        elif kind == 2:
            lines.append(f"CID {a},CID{b:09d},C{c:07d}")
        else:
            lines.append(f"CID{a:09d},CID{b:09d},C{c:07d},name {i}")
    path = tmp_path / "big.csv"
    path.write_bytes("\r\n".join(lines).encode() + b"\r\n")
    for n_fields in (2, 3):
        got = native.parse_edge_csv(str(path), n_fields)
        np.testing.assert_array_equal(got, jax_native.parse_edge_csv(str(path), n_fields))
        assert got.shape == (20000 - 3 * 400, n_fields)


def _big_graph(c):
    """A two-type graph whose drug-drug relation holds out 5,000 edges at
    ``val_frac=0.05`` and whose protein-drug relation holds out 4,500."""
    rng = np.random.default_rng(11)
    n_p, n_d = 400, 1500

    def edges(n_rows, n_cols, count, square):
        cells = rng.choice(n_rows * n_cols, size=count, replace=False)
        r, c = np.divmod(cells, n_cols)
        if square:
            keep = r < c
            r, c = r[keep], c[keep]
            r, c = np.concatenate([r, c]), np.concatenate([c, r])
        return r.astype(np.int32), c.astype(np.int32)

    dd = edges(n_d, n_d, 100_100, True)
    pd = edges(n_p, n_d, 90_000, False)
    pp = edges(n_p, n_p, 3_000, True)
    return c.RelationGraph(
        node_type_names=("protein", "drug"),
        num_nodes=(n_p, n_d),
        relations={
            (0, 0): [c.Relation(rows=pp[0], cols=pp[1], shape=(n_p, n_p), name="ppi")],
            (0, 1): [c.Relation(rows=pd[0], cols=pd[1], shape=(n_p, n_d), name="pd")],
            (1, 1): [c.Relation(rows=dd[0], cols=dd[1], shape=(n_d, n_d), name="dd")],
        },
        features={0: c.NodeFeatures.identity(n_p), 1: c.NodeFeatures.identity(n_d)},
    ).with_transposes()


@pytest.fixture(scope="module")
def big_graphs():
    return _big_graph(jax_container), _big_graph(container)


def _assert_splits_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        for field in ("train", "val", "test", "val_false", "test_false",
                      "adj_rows", "adj_cols", "adj_vals"):
            a, b = getattr(got[key], field), getattr(want[key], field)
            assert a.dtype == b.dtype, (key, field)
            np.testing.assert_array_equal(a, b, err_msg=f"{key} {field}")


@pytest.mark.parametrize("mode", ["native", "numpy"])
def test_large_split_equals_jax(request, big_graphs, mode):
    request.getfixturevalue("libs" if mode == "native" else "both_off")
    g_ref, g = big_graphs
    want = jax_split(g_ref, val_frac=0.05, test_frac=0.05, seed=3)
    got = split_graph(g, val_frac=0.05, test_frac=0.05, seed=3)
    assert max(s.val_false.shape[0] for s in got.values()) > 4096
    _assert_splits_equal(got, want)


def test_large_split_takes_the_native_sampler(monkeypatch, big_graphs, libs):
    """The negatives over 4,096 come from the native sampler: with it
    switched off they differ (the numpy path draws another stream)."""
    _, g = big_graphs
    with_lib = split_graph(g, val_frac=0.05, test_frac=0.05, seed=3)
    _fresh(monkeypatch, native, native.DISABLE_ENV, True)
    without = split_graph(g, val_frac=0.05, test_frac=0.05, seed=3)
    big = [k for k, s in with_lib.items() if s.val_false.shape[0] > 4096]
    assert big
    for key in big:
        assert not np.array_equal(with_lib[key].val_false, without[key].val_false)
