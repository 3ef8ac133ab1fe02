"""The frozen lattice generator: exactly symmetric, the counts its
configuration promises, the same tensors from the same seed."""
import numpy as np
import pytest
import torch

from gpubench.traffic.lattice import lattice_config, make_lattice


def dense(lat):
    n = lat.n_rows
    a = np.zeros((n, n), dtype=np.float64)
    for row_ptr, col, val, r0 in lat:
        rows = r0 + np.repeat(np.arange(row_ptr.numel() - 1), np.diff(row_ptr.numpy()))
        np.add.at(a, (rows, col.numpy()), val.numpy().astype(np.float64))
    return a


@pytest.mark.parametrize("n_chunks_target, seed", [(6, 0), (7, 12345), (5, 2**31 + 7)])
def test_lattice_is_exactly_symmetric(n_chunks_target, seed):
    lat = make_lattice(n_chunks_target * 64, 12, seed, device="cpu", w=16, w_sc=4)
    a = dense(lat)
    assert np.array_equal(a, a.T)
    assert (a > 0).sum() > 0


def test_lattice_counts():
    n_chunks, w_sc, w, cell_e = lattice_config(10_000_000, 50)
    assert (n_chunks, w_sc, w, cell_e) == (610, 32, 512, 800)
    assert n_chunks * w_sc * w == 9_994_240
    assert n_chunks * w_sc * w_sc * cell_e == 499_712_000
    lat = make_lattice(5 * 64, 12, 3, device="cpu", w=16, w_sc=4)
    chunks = list(lat)
    assert len(chunks) == lat.n_chunks == 5
    for j, (row_ptr, col, val, r0) in enumerate(chunks):
        assert r0 == j * lat.rows_per_chunk
        assert row_ptr.dtype == col.dtype == torch.int32 and val.dtype == torch.float32
        assert int(row_ptr[0]) == 0 and int(row_ptr[-1]) == col.numel() == lat.chunk_edges
        assert bool((torch.diff(row_ptr) >= 0).all())
        assert bool(((col >= 0) & (col < lat.n_rows)).all())
        assert bool(((val >= 0) & (val < 1)).all())
    assert sum(c.col.numel() for c in chunks) == lat.n_edges


def test_same_seed_same_tensors():
    a = list(make_lattice(6 * 64, 12, 99, device="cpu", w=16, w_sc=4))
    b = list(make_lattice(6 * 64, 12, 99, device="cpu", w=16, w_sc=4))
    c = list(make_lattice(6 * 64, 12, 100, device="cpu", w=16, w_sc=4))
    for x, y in zip(a, b):
        assert all(torch.equal(s, t) for s, t in zip(x[:3], y[:3])) and x.r0 == y.r0
    assert any(not torch.equal(x.val, z.val) for x, z in zip(a, c))
