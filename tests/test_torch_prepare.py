"""Host data layer of the PyTorch port against the JAX package: the same
numpy inputs go through both, and the results must be equal (the port's host
code is the JAX package's numpy code, so equal means equal, bit for bit,
except where a float32 round-trip is noted)."""
import os
import shutil
import time

import numpy as np
import pytest
import scipy.sparse as sp

from textgcn_tpu.graph import normalize as jnorm
from textgcn_tpu.graph import reorder as jreorder
from textgcn_tpu.text.datasets import load_labels as j_load_labels
from textgcn_tpu.train import prepare as jprepare

from textgcn_tpu_torch.graph import normalize as tnorm
from textgcn_tpu_torch.graph import reorder as treorder
from textgcn_tpu_torch.text.datasets import load_labels as t_load_labels
from textgcn_tpu_torch.train import prepare as tprepare

from torch_tiny_data import build_tiny


def _powerlaw_coo(n=600, e=6000, seed=0):
    """Directed power-law-ish COO with repeated edges (as tests/test_reorder)."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -0.8
    p /= p.sum()
    r = rng.choice(n, size=e, p=p)
    c = rng.choice(n, size=e, p=p)
    keep = r != c
    return r[keep].astype(np.int64), c[keep].astype(np.int64), rng.rand(keep.sum()), n


def _assert_coo_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_max_symmetrize_and_sym_normalize_equal_jax(seed):
    r, c, v, n = _powerlaw_coo(seed=seed)
    sym_t = tnorm.max_symmetrize_coo(r, c, v, n)
    sym_j = jnorm.max_symmetrize_coo(r, c, v, n)
    _assert_coo_equal(sym_t, sym_j)
    _assert_coo_equal(
        tnorm.sym_normalize_coo(*sym_t, n), jnorm.sym_normalize_coo(*sym_j, n)
    )
    # and against scipy: D^-1/2 (A + I) D^-1/2
    row, col, val = tnorm.sym_normalize_coo(*sym_t, n)
    a = sp.coo_matrix((sym_t[2], (sym_t[0], sym_t[1])), shape=(n, n)) + sp.eye(n)
    d = np.asarray(a.sum(axis=1)).ravel() ** -0.5
    want = sp.diags(d) @ a @ sp.diags(d)
    got = sp.coo_matrix((val, (row, col)), shape=(n, n))
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed", [0, 3])
def test_degree_sort_and_tile_split_equal_jax(seed):
    r, c, v, n = _powerlaw_coo(n=900, e=30000, seed=seed)
    r, c, v = tnorm.max_symmetrize_coo(r, c, v, n)
    perm = treorder.degree_sort_permutation(r, c, n)
    np.testing.assert_array_equal(perm, jreorder.degree_sort_permutation(r, c, n))
    r2, c2, _ = treorder.permute_coo(r, c, v, perm)
    for kw in (
        dict(),
        dict(bm=64, bn=64, min_nnz=16),
        # byte budget of 3 tiles: tau rises above min_nnz
        dict(min_nnz=1, max_block_bytes=3 * 128 * 128 * 4),
    ):
        mask = treorder.tile_fill_threshold_split(r2, c2, n, **kw)
        np.testing.assert_array_equal(
            mask, jreorder.tile_fill_threshold_split(r2, c2, n, **kw)
        )
        assert 0 < mask.sum() < len(mask)


def test_load_labels_and_permute_rows_1d_docs_equal_jax():
    path = "data/text_dataset/R8.txt"
    t, j = t_load_labels(path), j_load_labels(path)
    assert t.label_names == j.label_names
    for k in ("target", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    perm = np.random.RandomState(0).permutation(t.n_docs + 500)
    np.testing.assert_array_equal(
        tprepare.permute_rows_1d_docs(t.target, perm),
        jprepare.permute_rows_1d_docs(j.target, perm),
    )


def test_prepare_docword_r8_equals_jax():
    """The committed R8 doc-word artifact gives the same Â, labels and splits.

    Indices must be equal; values agree to float32 rounding (the JAX package
    may normalize in its C++ core, test-pinned to its numpy path at 1e-12).
    """
    t = tprepare.prepare_docword_data("R8", device="cpu")
    j = jprepare.prepare_docword_data("R8")
    assert (t.n_nodes, t.n_feat, t.num_docs) == (j.n_nodes, j.n_feat, j.num_docs)
    assert t.graph.n_edges == j.graph.n_edges == 3_454_070
    tr, tc, tv = t.graph.coo_numpy()
    e = j.graph.n_edges
    np.testing.assert_array_equal(tr, np.asarray(j.graph.row)[:e])
    np.testing.assert_array_equal(tc, np.asarray(j.graph.col)[:e])
    np.testing.assert_allclose(tv, np.asarray(j.graph.val)[:e], rtol=1e-6, atol=0)
    for k in ("target", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t.labels, k), getattr(j.labels, k))
    assert t.labels.label_names == j.labels.label_names
    assert t.features is None and j.features is None


def _fresh_copy(tmp_path, dataset="R8"):
    """A data root holding copies of the committed topic artifacts of
    ``dataset`` (the label files linked), the theta cache written after the
    model pickle: both packages take the cache, as the build stage left it,
    whatever order a checkout gave the files' mtimes."""
    graph = tmp_path / "data" / "graph"
    graph.mkdir(parents=True)
    os.symlink(os.path.abspath("data/text_dataset"), tmp_path / "data" / "text_dataset")
    for suffix in (".txt", "_model.pkl", "_theta.npy"):
        shutil.copyfile(f"data/graph/{dataset}_topic{suffix}", graph / f"{dataset}_topic{suffix}")
    now = time.time()
    os.utime(graph / f"{dataset}_topic_model.pkl", (now - 10, now - 10))
    os.utime(graph / f"{dataset}_topic_theta.npy", (now, now))
    return str(tmp_path / "data")


def test_prepare_topic_r8_equals_jax(tmp_path):
    """The committed R8 topic artifacts (a copy with a fresh theta cache)
    give the same Â, X, labels and splits. X is bit-equal (the same numpy
    feature code on the same cached theta). Â: indices equal, values equal
    to the bit; the JAX package normalizes in its native C++ core where it
    is built (``native.available()``) and with numpy otherwise, the port
    always with numpy."""
    root = _fresh_copy(tmp_path)
    t = tprepare.prepare_topic_data("R8", data_root=root, device="cpu")
    j = jprepare.prepare_topic_data("R8", data_root=root)
    assert (t.n_nodes, t.n_feat, t.num_docs, t.num_topics) == (7724, 100, 7674, 50)
    assert (t.n_nodes, t.n_feat, t.num_docs, t.num_topics) == (
        j.n_nodes, j.n_feat, j.num_docs, j.num_topics
    )
    assert t.features.dtype == j.features.dtype == np.float32
    np.testing.assert_array_equal(t.features, j.features)
    e = j.graph.n_edges
    assert t.graph.n_edges == e
    tr, tc, tv = t.graph.coo_numpy()
    np.testing.assert_array_equal(tr, np.asarray(j.graph.row)[:e])
    np.testing.assert_array_equal(tc, np.asarray(j.graph.col)[:e])
    np.testing.assert_array_equal(tv, np.asarray(j.graph.val)[:e])
    for k in ("target", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(t.labels, k), getattr(j.labels, k))
    assert t.labels.label_names == j.labels.label_names


def test_prepare_topic_reinfers_a_missing_theta_as_jax(tmp_path):
    """The tiny topic dataset built by the JAX package, its theta cache
    deleted: the port re-infers theta with its E-step and writes the cache
    again. theta within atol 1e-4 of JAX's re-inference (two f32 E-steps,
    whose iteration carries last-bit differences of digamma and the
    matmuls: ``tests/test_torch_topics.py`` ``THETA_TOL``), X within atol
    1e-4 (unit-norm rows of theta), the graph and labels equal."""
    root = build_tiny(tmp_path / "t")
    cache = os.path.join(root, "graph", "tiny_topic_theta.npy")
    os.remove(cache)
    t = tprepare.prepare_topic_data("tiny", data_root=root, num_topics=4, device="cpu")
    assert os.path.exists(cache)
    theta_t = np.load(cache)
    os.remove(cache)
    j = jprepare.prepare_topic_data("tiny", data_root=root, num_topics=4)
    theta_j = np.load(cache)
    assert theta_t.shape == (24, 4) and theta_t.dtype == theta_j.dtype == np.float32
    np.testing.assert_allclose(theta_t, theta_j, rtol=0, atol=1e-4)
    assert t.features.shape == j.features.shape == (28, 100)
    np.testing.assert_allclose(t.features, j.features, rtol=0, atol=1e-4)
    e = j.graph.n_edges
    tr, tc, tv = t.graph.coo_numpy()
    np.testing.assert_array_equal(tr, np.asarray(j.graph.row)[:e])
    np.testing.assert_array_equal(tc, np.asarray(j.graph.col)[:e])
    np.testing.assert_allclose(tv, np.asarray(j.graph.val)[:e], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(t.labels.target, j.labels.target)
    # the cache JAX wrote now is taken: the port's X is then JAX's, bit for bit
    again = tprepare.prepare_topic_data("tiny", data_root=root, num_topics=4, device="cpu")
    np.testing.assert_array_equal(again.features, j.features)


def test_cached_theta_follows_the_mtime_and_shape_rule(tmp_path):
    base = str(tmp_path / "x_topic")
    np.save(base + "_theta.npy", np.ones((3, 2), np.float32))
    open(base + "_model.pkl", "wb").close()
    os.utime(base + "_model.pkl", (100, 100))
    os.utime(base + "_theta.npy", (100, 100))  # as new as the model: taken
    got = tprepare.cached_theta(base, 3, 2)
    assert got.dtype == np.float32 and got.shape == (3, 2)
    assert tprepare.cached_theta(base, 4, 2) is None  # another shape
    os.utime(base + "_theta.npy", (99, 99))  # older than the model
    assert tprepare.cached_theta(base, 3, 2) is None
    os.remove(base + "_theta.npy")
    assert tprepare.cached_theta(base, 3, 2) is None
