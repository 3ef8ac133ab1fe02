"""The hybrid SpMM layout and pass of the PyTorch port against the JAX
package (Pallas kernels in interpret mode) and scipy, on the CPU, where the
port's kernel wrappers run their plain PyTorch versions. The CUDA kernels
themselves are held against those plain versions in
``tests/test_torch_kernels.py``."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

from textgcn_tpu.graph import reorder as jreorder
from textgcn_tpu.ops.pallas_spmm import GroupedBSR
from textgcn_tpu.ops.spmm import spmm_coo_segment as j_segment

from textgcn_tpu_torch.graph import reorder as treorder
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.structs import DenseGraph, SparseGraph
from textgcn_tpu_torch.ops.spmm import spmm

CPU = torch.device("cpu")


def _normalized_powerlaw(n=700, e=24000, seed=0, skew=1.0):
    """A sym-normalized power-law graph whose degree-sorted pattern has
    both tiles with >= 24 edges and a residual."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -skew
    p /= p.sum()
    r = rng.choice(n, size=e, p=p)
    c = rng.choice(n, size=e, p=p)
    r, c, v = max_symmetrize_coo(r, c, rng.rand(e), n)
    r, c, v = sym_normalize_coo(r, c, v, n)
    return r, c, v.astype(np.float32).astype(np.float64), n


def _jax_flat_tiles(bsr):
    """(block_rows, block_cols, tiles) of JAX's tile leg in the flat layout,
    zero tiles (group padding, coverage) dropped."""
    blocks = np.asarray(bsr.blocks.astype(jnp.float32))
    if isinstance(bsr, GroupedBSR):
        g, bm, bn = bsr.group, bsr.bm, bsr.bn
        tiles = blocks.reshape(-1, bm, g, bn).transpose(0, 2, 1, 3).reshape(-1, bm, bn)
        rows = np.repeat(np.asarray(bsr.group_rows), g)
        cols = np.asarray(bsr.group_cols)
    else:
        tiles, rows, cols = blocks, np.asarray(bsr.block_rows), np.asarray(bsr.block_cols)
    keep = np.abs(tiles).sum(axis=(1, 2)) > 0
    return rows[keep], cols[keep], tiles[keep]


def _jax_residual_edges(rest):
    """(row, col, val) of JAX's one-hot residual plan, phantom slots dropped."""
    p = rest.fwd
    lrow = np.asarray(p.lrow).reshape(p.n_sc, p.c_sc, p.k)
    wloc = np.asarray(p.wloc)
    win = (np.arange(p.n_sc)[:, None] * p.w_sc + wloc)[:, :, None]
    rows = (win * p.w + lrow).reshape(-1)
    real = lrow.reshape(-1) < p.w
    return (
        rows[real],
        np.asarray(p.col).reshape(-1)[real],
        np.asarray(p.val).reshape(-1)[real],
    )


def _sorted_coo(r, c, v):
    o = np.lexsort((c, r))
    return r[o], c[o], v[o]


@pytest.mark.parametrize("seed", [0, 1])
def test_hybrid_layout_equals_jax(seed):
    r, c, v, n = _normalized_powerlaw(seed=seed)
    perm_t, h_t = treorder.reorder_and_build(r, c, v, n, symmetric=True, device=CPU)
    perm_j, h_j = jreorder.reorder_and_build(r, c, v, n, symmetric=True)
    np.testing.assert_array_equal(perm_t, perm_j)
    assert h_t.rest is not None and 0.5 < h_t.dense_fraction < 1.0
    assert h_t.bsr.n_edges == h_j.bsr.n_edges

    rows_j, cols_j, tiles_j = _jax_flat_tiles(h_j.bsr)
    b = h_t.bsr
    tiles_t = b.blocks.float().numpy()
    keep = np.abs(tiles_t).sum(axis=(1, 2)) > 0
    rows_t, cols_t = b.block_rows.numpy()[keep], b.block_cols.numpy()[keep]
    key_t, key_j = rows_t * 10_000 + cols_t, rows_j * 10_000 + cols_j
    assert sorted(key_t) == sorted(key_j)
    np.testing.assert_array_equal(
        tiles_t[keep][np.argsort(key_t)], tiles_j[np.argsort(key_j)]
    )
    # the tile CSR the CUDA kernel walks
    ptr = b.tile_ptr.numpy()
    np.testing.assert_array_equal(
        np.repeat(np.arange(b.n_block_rows), np.diff(ptr)), b.block_rows.numpy()
    )

    rest = h_t.rest
    rr = np.repeat(np.arange(n), np.diff(rest.row_ptr.numpy()))
    got = _sorted_coo(rr, rest.col.numpy().astype(np.int64), rest.val.numpy())
    want = _sorted_coo(*_jax_residual_edges(h_j.rest))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("store_bf16", [True, False])
def test_spmm_hybrid_matches_jax_and_scipy(store_bf16):
    r, c, v, n = _normalized_powerlaw(seed=2)
    perm, h_t = treorder.reorder_and_build(
        r, c, v, n, symmetric=True, store_bf16=store_bf16, device=CPU
    )
    _, h_j = jreorder.reorder_and_build(
        r, c, v, n, symmetric=True, store_bf16=store_bf16
    )
    x = np.random.RandomState(3).randn(n, 40).astype(np.float32)
    got = treorder.spmm_hybrid(h_t, torch.from_numpy(x)).numpy()
    want_j = np.asarray(jreorder.spmm_hybrid(h_j, jnp.asarray(x), True, store_bf16))
    # the JAX residual rounds each product to bf16; the port sums in f32
    np.testing.assert_allclose(got, want_j, rtol=2e-2, atol=2e-2)
    r2, c2, v2 = treorder.permute_coo(r, c, v, perm)
    oracle = sp.coo_matrix((v2, (r2, c2)), shape=(n, n)) @ x.astype(np.float64)
    # f32 tiles: only the residual's bf16 features round; bf16 tiles and
    # features round at 2^-9 relative, summed over up to ~n terms
    tol = 2e-2 if store_bf16 else 2e-3
    np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)


def test_spmm_hybrid_backward_matches_jax_grad():
    r, c, v, n = _normalized_powerlaw(seed=4)
    _, h_t = treorder.reorder_and_build(
        r, c, v, n, symmetric=True, store_bf16=False, device=CPU
    )
    _, h_j = jreorder.reorder_and_build(r, c, v, n, symmetric=True, store_bf16=False)
    x = np.random.RandomState(1).randn(n, 8).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    (treorder.spmm_hybrid(h_t, xt) ** 2).sum().backward()
    g_j = jax.grad(lambda a: jnp.sum(jreorder.spmm_hybrid(h_j, a, True, False) ** 2))(
        jnp.asarray(x)
    )
    # residual products round to bf16 on the JAX side only
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_j), rtol=2e-2, atol=2e-2)
    # d/dx sum((Ax)^2) = 2 A A x for symmetric A, through the port's own pass
    ax = treorder.hybrid_pass(h_t, torch.from_numpy(x))
    want = 2.0 * treorder.hybrid_pass(h_t, ax)
    np.testing.assert_allclose(xt.grad.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_hybrid_all_dense_edge_case():
    """Every edge in one tile: rest is None and the pass still works."""
    n = 32
    r = np.repeat(np.arange(8), 8)
    c = np.tile(np.arange(8), 8)
    v = np.ones(64)
    h = treorder.HybridGraph.from_coo(
        r, c, v, n, symmetric=False, min_nnz=1, store_bf16=False, device=CPU
    )
    assert h.rest is None and h.dense_fraction == 1.0
    x = np.random.RandomState(0).randn(n, 8).astype(np.float32)
    want = sp.coo_matrix((v, (r, c)), shape=(n, n)) @ x
    got = treorder.spmm_hybrid(h, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="symmetric"):
        xt = torch.from_numpy(x).requires_grad_(True)
        treorder.spmm_hybrid(h, xt).sum().backward()


def test_segment_and_dense_spmm_match_jax_with_grads():
    """The segment oracle (and the dense format) against JAX's
    spmm_coo_segment, forward and backward: f32 sums in another order."""
    r, c, v, n = _normalized_powerlaw(n=300, e=3000, seed=5)
    g = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=512, device=CPU)
    x = np.random.RandomState(2).randn(n, 12).astype(np.float32)
    cot = np.random.RandomState(3).randn(n, 12).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    y = spmm(g, xt)
    y.backward(torch.from_numpy(cot))
    jrow, jcol, jval = (jnp.asarray(a.numpy()) for a in (g.row, g.col, g.val))
    y_j, vjp = jax.vjp(lambda a: j_segment(jrow, jcol, jval, a, n), jnp.asarray(x))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        xt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), rtol=1e-5, atol=1e-6
    )
    yd = spmm(DenseGraph.from_sparse_graph(g), torch.from_numpy(x))
    np.testing.assert_allclose(yd.numpy(), y.detach().numpy(), rtol=1e-5, atol=1e-6)
