"""K2's row split (``textgcn_tpu_torch.ops.row_reduce.RowSplit``) on the CPU.

The CUDA kernel walks no more than S edges with one warp: the rows longer
than S are cut into row-local segments whose partial sums a second pass adds
onto the base in segment order. The kernel runs only on the card
(``tests/test_torch_kernels.py``); here the table is checked on its own, a
plain emulation of the split sum is held against the plain reduce and
against the JAX package's one-hot kernel (``_onehot_kernel``, Pallas in
interpret mode), a table built from another CSR is refused, and the CSR
containers are checked to build the table once and carry it. On the CPU
``row_reduce`` runs its plain version, so the kernel itself is held against
the plain version only in the GPU tests.
"""
import numpy as np
import pytest
import torch

from textgcn_tpu.ops.pallas_onehot import OneHotGraph, spmm_onehot

from textgcn_tpu_torch.graph.reorder import ResidualCSR
from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.ops.attention import AttentionGraph, sddmm, sddmm_plain
from textgcn_tpu_torch.ops.row_reduce import (
    SEGMENT_EDGES, row_reduce, row_reduce_plain, row_split,
)

CPU = torch.device("cpu")


def _degrees(s, hub=3000, seed=0):
    """Rows of 0, 1, S-1, S, S+1, 3S+5 and ``hub`` edges among short rows."""
    rng = np.random.RandomState(seed)
    special = [0, 1, s - 1, s, s + 1, 3 * s + 5, hub]
    short = list(rng.randint(0, 40, size=20))
    degs = short[:7] + special + short[7:]
    return np.asarray(degs, dtype=np.int64)


def _csr(degs, n_x, seed=0, pow2_vals=False):
    """(row_ptr, col, val) numpy arrays of a row-sorted CSR with ``degs``."""
    rng = np.random.RandomState(seed)
    rp = np.concatenate([[0], np.cumsum(degs)])
    e = int(rp[-1])
    col = rng.randint(0, n_x, e)
    if pow2_vals:  # exact bf16 products with bf16 features
        val = 2.0 ** rng.randint(-3, 2, e) * rng.choice([-1.0, 1.0], e)
    else:
        val = rng.rand(e)
    return rp, col, val.astype(np.float32)


@pytest.mark.parametrize("hub", [SEGMENT_EDGES + 1, 2 * SEGMENT_EDGES, 3000, 10_000])
def test_row_split_covers_every_edge_once_in_row_local_segments(hub):
    s = SEGMENT_EDGES
    degs = _degrees(s, hub=hub)
    rp = np.concatenate([[0], np.cumsum(degs)])
    sp = row_split(rp)
    seg_row, seg_e0, long_ptr = (t.numpy() for t in (sp.seg_row, sp.seg_e0, sp.long_ptr))
    assert sp.table.dtype == torch.int32
    assert (sp.n_rows, sp.n_edges) == (len(degs), rp[-1])
    long_rows = np.flatnonzero(degs > s)
    assert sp.n_long == len(long_rows) and list(seg_row[long_ptr[:-1]]) == list(long_rows)
    assert sp.n_seg == len(seg_row) == len(seg_e0) == long_ptr[-1]
    covered = np.zeros(rp[-1], dtype=np.int64)
    for r in np.flatnonzero(degs <= s):  # the rows one warp walks whole
        covered[rp[r] : rp[r + 1]] += 1
    for i, r in enumerate(long_rows):
        segs = np.arange(long_ptr[i], long_ptr[i + 1])
        assert (seg_row[segs] == r).all()
        # row-local boundaries at multiples of S from the row's first edge
        assert list(seg_e0[segs]) == list(rp[r] + s * np.arange(len(segs)))
        for e0 in seg_e0[segs]:
            e1 = min(e0 + s, rp[r + 1])
            assert 0 < e1 - e0 <= s
            covered[e0:e1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize(
    "degs", [[], [0, 0, 0], [1, SEGMENT_EDGES, 0, SEGMENT_EDGES - 1, 50]],
    ids=["no-rows", "no-edges", "at-most-S"],
)
def test_row_split_is_none_without_a_row_longer_than_s(degs):
    rp = np.concatenate([[0], np.cumsum(np.asarray(degs, dtype=np.int64))])
    assert row_split(rp) is None
    assert row_split(torch.from_numpy(rp).to(torch.int32)) is None


def _split_sum(rp, col, val, x, base, sp):
    """The kernel's order of sums, emulated in f32: a row of at most S edges
    is ``base + its sum``; a longer row ``base + p_0 + p_1 + ...``, its
    segments' partial sums added in segment order."""
    prod = val[:, None] * x[col]
    out = np.zeros((len(rp) - 1, x.shape[1]), np.float32) if base is None else base.copy()
    s = SEGMENT_EDGES
    for r in np.flatnonzero(np.diff(rp) <= s):
        out[r] = out[r] + prod[rp[r] : rp[r + 1]].sum(0)
    seg_row, seg_e0, long_ptr = (t.numpy() for t in (sp.seg_row, sp.seg_e0, sp.long_ptr))
    for i in range(sp.n_long):
        r = seg_row[long_ptr[i]]
        acc = out[r]
        for k in range(long_ptr[i], long_ptr[i + 1]):
            e0 = seg_e0[k]
            acc = acc + prod[e0 : min(e0 + s, rp[r + 1])].sum(0)
        out[r] = acc
    return out


@pytest.mark.parametrize("hub", [700, 3000])
@pytest.mark.parametrize("with_base", [False, True])
def test_split_sum_matches_plain_and_the_jax_onehot_kernel(hub, with_base):
    """The split sum vs ``row_reduce_plain`` (f32 sums of up to 3,000 terms
    in another order: 1e-5 relative to the largest output, ~100 ulp) and, from
    zero, vs JAX ``spmm_onehot`` in interpret mode; the weights are powers of
    two and the features bf16, so JAX's bf16 products are exact and only the
    order of the f32 sums differs."""
    degs = _degrees(SEGMENT_EDGES, hub=hub)
    n_x, f = 500, 16
    rp, col, val = _csr(degs, n_x, seed=hub, pow2_vals=True)
    rng = np.random.RandomState(1)
    x16 = torch.from_numpy(rng.randn(n_x, f).astype(np.float32)).bfloat16()
    x = x16.float().numpy()
    base = rng.randn(len(degs), f).astype(np.float32) if with_base else None
    sp = row_split(rp)
    want = _split_sum(rp, col, val, x, base, sp)
    scale = np.abs(want).max()
    tp, tc, tv = (torch.from_numpy(a) for a in (rp.astype(np.int32), col.astype(np.int32), val))
    got = row_reduce_plain(
        tp, tc, tv, x16, None if base is None else torch.from_numpy(base.copy())
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    if not with_base:
        rows = np.repeat(np.arange(len(degs)), degs)
        n = max(len(degs), n_x)  # a square operator over x's rows
        g = OneHotGraph.from_coo(rows, col, val, n)
        xj = np.zeros((n, f), np.float32)
        xj[:n_x] = x
        jax_out = np.asarray(spmm_onehot(g.fwd, g.bwd, xj, True))[: len(degs)]
        np.testing.assert_allclose(jax_out, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("other", ["rows", "edges"])
def test_row_reduce_refuses_a_split_table_of_another_csr(other):
    """The table records its CSR's row and edge counts; a table built from
    a CSR with another count is refused before anything runs (host integers,
    no sync), on the CPU as on the card, and its own CSR's is taken."""
    degs = _degrees(SEGMENT_EDGES)
    rp, col, val = _csr(degs, 50)
    wrong = np.append(degs, 0) if other == "rows" else degs + (np.arange(len(degs)) == 0)
    sp_other = row_split(np.concatenate([[0], np.cumsum(wrong)]))
    tp, tc, tv = (torch.from_numpy(a) for a in (rp.astype(np.int32), col.astype(np.int32), val))
    x = torch.randn(50, 8, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="split table"):
        row_reduce(tp, tc, tv, x, split=sp_other)
    torch.testing.assert_close(
        row_reduce(tp, tc, tv, x, split=row_split(rp)), row_reduce_plain(tp, tc, tv, x)
    )


def test_csr_containers_build_the_split_once_and_carry_it(tmp_path):
    s = SEGMENT_EDGES
    degs = _degrees(s)
    n = len(degs)
    rp, col, val = _csr(degs, n)
    rows = np.repeat(np.arange(n), degs)
    want = row_split(rp).table

    rest = ResidualCSR.from_coo(rows, col, val, n, device=CPU)
    assert torch.equal(rest.split.table, want)
    assert ResidualCSR.from_coo(rows[:10], col[:10], val[:10], n, device=CPU).split is None

    # the attention graph's transpose CSR: column degrees of the same edges
    key = np.unique(rows * n + col)
    ag = AttentionGraph.from_coo(key // n, key % n, np.ones(len(key)), n, device=CPU)
    t_split = row_split(ag.row_ptr_t)
    if t_split is None:
        assert ag.split_t is None
    else:
        assert torch.equal(ag.split_t.table, t_split.table)

    # stream chunks: each chunk's split is its local CSR's; it survives
    # .to() and a save/load round trip
    chunks = ss.csr_stream(torch.from_numpy(rp), torch.from_numpy(col.astype(np.int32)),
                           torch.from_numpy(val), max_chunk_edges=2 * s)
    assert any(c.split is not None for c in chunks)
    for c in chunks:
        local = row_split(c.row_ptr)
        assert (c.split is None) == (local is None)
        if local is not None:
            assert torch.equal(c.split.table, local.table)
            assert c.nbytes == local.nbytes + sum(
                t.numel() * t.element_size() for t in (c.row_ptr, c.col, c.val)
            )
            assert torch.equal(c.to(CPU).split.table, local.table)
    ss.save_chunks(chunks, str(tmp_path), n)
    load = ss.chunk_loader_from_dir(str(tmp_path))
    for i, c in enumerate(chunks):
        got = load(i).split
        assert (got is None) == (c.split is None)
        if got is not None:
            assert torch.equal(got.table, c.split.table)


def test_streamed_pass_over_split_chunks_matches_one_reduce():
    """A stream of chunks, some holding rows longer than S, against one plain
    reduce over the whole CSR: the chunk adds land on their row ranges."""
    degs = _degrees(SEGMENT_EDGES, hub=700)
    n = len(degs)
    rp, col, val = _csr(degs, n, seed=3)
    x = torch.from_numpy(np.random.RandomState(2).randn(n, 8).astype(np.float32))
    tp, tc, tv = torch.from_numpy(rp), torch.from_numpy(col.astype(np.int32)), torch.from_numpy(val)
    chunks = ss.csr_stream(tp, tc, tv, max_chunk_edges=300)
    got = ss.spmm_streamed_sorted(chunks, x)
    torch.testing.assert_close(got, row_reduce_plain(tp, tc, tv, x), rtol=1e-5, atol=1e-5)


def test_sddmm_plain_takes_and_ignores_the_row_array():
    degs = _degrees(128)
    n = len(degs)
    rp, col, _ = _csr(degs, n, seed=4)
    rng = np.random.RandomState(5)
    g, x = (torch.from_numpy(rng.randn(n, 16).astype(np.float32)) for _ in range(2))
    tp, tc = torch.from_numpy(rp.astype(np.int32)), torch.from_numpy(col.astype(np.int32))
    row = torch.from_numpy(np.repeat(np.arange(n), degs).astype(np.int32))
    want = (g.numpy()[row.numpy()] * x.numpy()[col]).sum(1)
    np.testing.assert_allclose(sddmm(tp, tc, g, x, row).numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(sddmm_plain(tp, tc, g, x, row), sddmm_plain(tp, tc, g, x))
