"""Host data layer of the PyTorch port against the JAX package: the same
numpy inputs go through both, and the results must be equal (the port's host
code is the JAX package's numpy code, so equal means equal, bit for bit,
except where a float32 round-trip is noted)."""
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
