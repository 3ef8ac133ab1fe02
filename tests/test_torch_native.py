"""The port's native graph core (``textgcn_tpu_torch.native``) and its three
callers, on the CPU with the host's C++ compiler.

Each entry point is held against the JAX package's pure numpy/scipy
functions (``textgcn_tpu.graph.normalize``, ``build_textgcn``); the JAX
package's own binding (``textgcn_tpu.native``) is not imported. The prepared
graphs of the native chain and of the port's numpy chain (forced by patching
``native.available``) are held bit for bit as float32 ``SparseGraph``s."""
import hashlib
import os
import subprocess

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from textgcn_tpu.graph.build_textgcn import window_word_incidence
from textgcn_tpu.graph.normalize import max_symmetrize_coo, sym_normalize_coo

from textgcn_tpu_torch import native
from textgcn_tpu_torch.graph import build_topic as tbt
from textgcn_tpu_torch.train import prepare as tprepare

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ compiler on PATH")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "textgcn_tpu", "native")


def _dense(r, c, v, n):
    return sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()


def test_parse_edgelist(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("0 5 0.5\n1 6 0.25\n7 2 1.5\n3 4\n")
    r, c, v = native.parse_edgelist(str(p))
    np.testing.assert_array_equal(r, [0, 1, 7, 3])
    np.testing.assert_array_equal(c, [5, 6, 2, 4])
    np.testing.assert_array_equal(v, [0.5, 0.25, 1.5, 1.0])
    with pytest.raises(FileNotFoundError):
        native.parse_edgelist(str(tmp_path / "missing.txt"))


def test_parse_large_roundtrip(tmp_path):
    """10,000 "u v w" lines written with repr: the native parse gives the
    written arrays, bit for bit (strtod and float() both round correctly)."""
    rng = np.random.RandomState(0)
    n = 10000
    rows, cols, vals = rng.randint(0, 1000, n), rng.randint(0, 1000, n), rng.rand(n)
    p = tmp_path / "big.txt"
    with open(p, "w") as f:
        for a, b, w in zip(rows, cols, vals):
            f.write(f"{a} {b} {float(w)!r}\n")
    r, c, v = native.parse_edgelist(str(p))
    np.testing.assert_array_equal(r, rows)
    np.testing.assert_array_equal(c, cols)
    np.testing.assert_array_equal(v, vals)


def test_coalesce_max_symmetrize_matches_python():
    """Against JAX's numpy ``max_symmetrize_coo``: the same sorted COO, the
    same values (a max picks one of the inputs)."""
    rng = np.random.RandomState(1)
    n_nodes = 50
    rows, cols, vals = rng.randint(0, n_nodes, 300), rng.randint(0, n_nodes, 300), rng.rand(300)
    r1, c1, v1 = native.coalesce(rows, cols, vals, n_nodes, reduce="max", symmetrize=True)
    r2, c2, v2 = max_symmetrize_coo(rows, cols, vals, n_nodes)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(v1, v2)
    r3, c3, v3 = native.coalesce(rows, cols, vals, n_nodes)  # sum, no transpose
    np.testing.assert_allclose(
        _dense(r3, c3, v3, n_nodes), _dense(rows, cols, vals, n_nodes), rtol=1e-12
    )
    with pytest.raises(ValueError, match="outside"):
        native.coalesce([0, n_nodes], [1, 2], [1.0, 1.0], n_nodes)
    with pytest.raises(ValueError, match="unknown reduce"):
        native.coalesce(rows, cols, vals, n_nodes, reduce="mean")


def test_sym_normalize_matches_python():
    """Against JAX's numpy ``sym_normalize_coo`` on a coalesced COO: the
    same matrix within 1e-12 relative (degrees summed in another order)."""
    rng = np.random.RandomState(2)
    n_nodes = 40
    rows, cols, vals = rng.randint(0, n_nodes, 200), rng.randint(0, n_nodes, 200), rng.rand(200)
    r0, c0, v0 = native.coalesce(rows, cols, vals, n_nodes, reduce="max", symmetrize=True)
    r1, c1, v1 = native.sym_normalize(r0, c0, v0, n_nodes)
    r2, c2, v2 = sym_normalize_coo(r0, c0, v0, n_nodes)
    assert len(r1) == len(r2)
    np.testing.assert_allclose(
        _dense(r1, c1, v1, n_nodes), _dense(r2, c2, v2, n_nodes), rtol=1e-12, atol=0
    )


def test_window_cooccurrence_matches_python():
    """Against JAX's scipy incidence: the window count, each word's windows
    and every pair's count; the pairs come sorted by (i, j)."""
    docs = ["a b c d e", "c d e f", "a f", "b b a"]
    vocab = ["a", "b", "c", "d", "e", "f"]
    w2i = {w: i for i, w in enumerate(vocab)}
    tokens, offsets = [], [0]
    for d in docs:
        tokens.extend(w2i[w] for w in d.split())
        offsets.append(len(tokens))
    i, j, cnt, occ, n_win = native.window_cooccurrence(
        np.asarray(tokens), np.asarray(offsets), len(vocab), 3
    )
    inc = window_word_incidence(docs, vocab, window_size=3)
    assert n_win == inc.shape[0]
    np.testing.assert_array_equal(occ, np.asarray(inc.sum(axis=0)).ravel().astype(np.int64))
    co = sp.triu((inc.T @ inc).tocsr(), k=1).tocoo()
    order = np.lexsort((co.col, co.row))
    np.testing.assert_array_equal(i, co.row[order])
    np.testing.assert_array_equal(j, co.col[order])
    np.testing.assert_array_equal(cnt, co.data[order])
    with pytest.raises(ValueError, match="outside"):
        native.window_cooccurrence(np.asarray([0, 6]), np.asarray([0, 2]), len(vocab), 3)


def _synthetic_edgelist(path):
    """A seeded graph with duplicate edges (both directions, other weights),
    some diagonal entries and nodes with none, written as "u v w" lines."""
    rng = np.random.RandomState(3)
    n = 300
    src, dst = rng.randint(0, n, 4000), rng.randint(0, n, 4000)
    dup = rng.randint(0, 4000, 800)
    src = np.r_[src, dst[dup], np.arange(0, n, 3)]
    dst = np.r_[dst, src[dup], np.arange(0, n, 3)]
    w = rng.rand(len(src))
    with open(path, "w") as f:
        for a, b, x in zip(src, dst, w):
            f.write(f"{a} {b} {float(x)!r}\n")
    return n


@pytest.mark.parametrize("graph", ["r8_topic", "synthetic"])
def test_load_graph_edges_native_equals_numpy_bit_for_bit(graph, tmp_path, monkeypatch):
    """``load_graph_edges`` on the native chain (parse, max-coalesce,
    sym-normalize in C++) against the port's numpy chain: the float32
    ``SparseGraph`` (row, col, val, edge count) is bit-equal."""
    if graph == "r8_topic":
        path, n = os.path.join(REPO, "data", "graph", "R8_topic.txt"), 7724
    else:
        path = str(tmp_path / "g.txt")
        n = _synthetic_edgelist(path)
    got = tprepare.load_graph_edges(path, n, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        m.setattr(native, "parse_edgelist", None)  # the numpy path must not reach it
        want = tprepare.load_graph_edges(path, n, device="cpu")
    assert got.n_edges == want.n_edges > n
    for k in ("row", "col", "val"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_malformed_lines_skipped_natively_and_raise_in_the_loop(tmp_path, monkeypatch):
    """As in JAX: the native parser skips a line whose u or v is not an
    integer (a last line without a weight gets weight 1); the Python loop
    skips a line of fewer than two fields and raises on the others."""
    p = tmp_path / "e.txt"
    p.write_text("0 1 0.5\nx 2 1.0\n3 y\n6 7 2.5\n4 5\n")
    r, c, v = tbt.read_weighted_edgelist(str(p))
    np.testing.assert_array_equal(r, [0, 6, 4])
    np.testing.assert_array_equal(c, [1, 7, 5])
    np.testing.assert_array_equal(v, [0.5, 2.5, 1.0])
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(ValueError):
        tbt.read_weighted_edgelist(str(p))
    p.write_text("0 1 0.5\n\n2\n4 5\n")
    r, c, v = tbt.read_weighted_edgelist(str(p))
    np.testing.assert_array_equal(r, [0, 4])
    np.testing.assert_array_equal(v, [0.5, 1.0])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_fields_stop_at_the_line_end(path, tmp_path, monkeypatch):
    """A line of two fields gets weight 1 and a line of one field is skipped,
    wherever they stand in the file: no field is read from the next line."""
    p = tmp_path / "e.txt"
    p.write_text("4 5\n6 7 2.5\n2\n8 9 \r\n10 11\t0.25\n3 1")
    if path == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    r, c, v = tbt.read_weighted_edgelist(str(p))
    np.testing.assert_array_equal(r, [4, 6, 8, 10, 3])
    np.testing.assert_array_equal(c, [5, 7, 9, 11, 1])
    np.testing.assert_array_equal(v, [1.0, 2.5, 1.0, 0.25, 1.0])


def _snapshot(d):
    return {
        name: (os.path.getsize(os.path.join(d, name)), os.path.getmtime(os.path.join(d, name)))
        for name in sorted(os.listdir(d))
    }


def test_build_writes_only_under_the_port_build_dir(tmp_path, monkeypatch):
    """A fresh build compiles the port's copy of the source, without
    ``-march=native``, into the build directory (by default the gitignored
    ``textgcn_tpu_torch/_build/``), under a name hashed from the source and
    the flags; the JAX package's ``native/`` directory and its committed
    ``libgraphcore.so`` stay as they were."""
    assert native.BUILD_DIR == native.SRC.parent.parent / "_build"
    assert native.BUILD_DIR.name == "_build" and native.SRC.parent.parent.name == "textgcn_tpu_torch"
    so = os.path.join(JAX_NATIVE, "libgraphcore.so")
    so_hash = hashlib.sha256(open(so, "rb").read()).hexdigest()
    before = _snapshot(JAX_NATIVE)
    cmds = []
    real_run = subprocess.run

    def run(cmd, **kw):
        cmds.append(cmd)
        return real_run(cmd, **kw)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(subprocess, "run", run)
    path = native.build()
    (cmd,) = cmds
    assert cmd[-1] == str(native.SRC) and "-march=native" not in cmd
    assert path.parent == tmp_path / "_build" and path.exists()
    assert path.name.startswith("libgraphcore_") and path.name.endswith(".so")
    assert sorted(os.listdir(tmp_path / "_build")) == [path.name]
    assert native.build() == path and len(cmds) == 1  # reused, not rebuilt
    assert _snapshot(JAX_NATIVE) == before
    assert hashlib.sha256(open(so, "rb").read()).hexdigest() == so_hash


def test_no_compiler_takes_the_numpy_path_and_a_compile_error_raises(tmp_path, monkeypatch):
    """Without a compiler on PATH the callers take their numpy path; with
    one, a source that does not compile raises with the compiler's output,
    in ``build`` and through a caller, instead of falling back."""
    path = os.path.join(REPO, "data", "graph", "R8_topic.txt")
    want = tprepare.load_graph_edges(path, 7724, device="cpu")
    with monkeypatch.context() as m:
        m.setattr(native.shutil, "which", lambda name: None)
        assert not native.available()
        got = tprepare.load_graph_edges(path, 7724, device="cpu")
        with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
            native.build()
    assert torch.equal(got.val, want.val) and torch.equal(got.row, want.row)

    bad = tmp_path / "graphcore.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match=r"(?s)building the native graph core failed.*error"):
            native.build()
        with pytest.raises(RuntimeError, match="building the native graph core failed"):
            tprepare.load_graph_edges(path, 7724, device="cpu")
        assert [p.name for p in (tmp_path / "_build").iterdir()] == []
    finally:
        native._library.cache_clear()
