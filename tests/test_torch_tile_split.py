"""K1's tile split (``textgcn_tpu_torch.ops.split.TileSplit``), the split
tables' fingerprints and the ``--graph`` default, on the CPU.

The CUDA kernel K1 walks no more than T tiles with one block: a block-row
of more than T tiles is cut into block-row-local segments whose partial sums
a second pass adds in segment order. The kernel runs only on the card
(``tests/test_torch_kernels.py``); here the table is checked on its own, a
numpy emulation of the segmented tile sum is held against the plain version
and against the JAX package's hybrid SpMM (Pallas in interpret mode), the
containers are checked to build the table once and carry it (the shards'
tables put together equal the single-device table), and every split table is
checked to be refused with a CSR or tile stack it was not built from, even
one with the same counts. On the CPU the wrappers run their plain versions.
The ``--graph`` default is held on the tiny corpus of ``tests/test_runner.py``.
"""
import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textgcn_tpu.graph import reorder as jreorder

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph import reorder as treorder
from textgcn_tpu_torch.graph.normalize import sym_normalize_coo
from textgcn_tpu_torch.graph.structs import BlockSparseGraph
from textgcn_tpu_torch.ops import attention as att
from textgcn_tpu_torch.ops.bsr_spmm import (
    SEGMENT_TILES, TILE, bsr_leg, bsr_spmm, tile_split,
)
from textgcn_tpu_torch.ops.row_reduce import SEGMENT_EDGES, row_reduce, row_split
from textgcn_tpu_torch.ops.split import (
    RowSplit, TileSplit, build_split, fingerprint, fingerprint_of,
)
from textgcn_tpu_torch.parallel.mesh_kernels import MeshHybridAllGather
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train.run import run_experiment

from torch_tiny_data import N_DOCS, N_TOPICS, build_tiny

CPU = torch.device("cpu")
T = SEGMENT_TILES


def _tile_counts(hub):
    """Tiles per block-row: 0, 1, T-1, T, T+1, 2T, 2T+3 and ``hub`` among
    short block-rows."""
    return np.asarray([3, 0, 1, T - 1, 5, T, T + 1, 2 * T, 2 * T + 3, hub, 2, 7], np.int64)


@pytest.mark.parametrize("hub", [T + 1, 3 * T, 120])
def test_tile_split_covers_every_tile_once_in_block_row_local_segments(hub):
    counts = _tile_counts(hub)
    tp = np.concatenate([[0], np.cumsum(counts)])
    sp = tile_split(tp)
    assert isinstance(sp, TileSplit) and sp.table.dtype == torch.int32
    assert (sp.n_block_rows, sp.n_tiles, sp.seg_len) == (len(counts), tp[-1], T)
    assert sp.fingerprint == fingerprint(tp)
    seg_row, seg_t0, long_ptr = (t.numpy() for t in (sp.seg_row, sp.seg_e0, sp.long_ptr))
    long_rows = np.flatnonzero(counts > T)
    assert sp.n_long == len(long_rows) and list(seg_row[long_ptr[:-1]]) == list(long_rows)
    assert sp.n_seg == len(seg_row) == long_ptr[-1]
    covered = np.zeros(tp[-1], np.int64)
    for br in np.flatnonzero(counts <= T):  # the block-rows one block walks whole
        covered[tp[br] : tp[br + 1]] += 1
    for i, br in enumerate(long_rows):
        segs = np.arange(long_ptr[i], long_ptr[i + 1])
        assert (seg_row[segs] == br).all()
        # block-row-local boundaries at multiples of T from its first tile
        assert list(seg_t0[segs]) == list(tp[br] + T * np.arange(len(segs)))
        for t0 in seg_t0[segs]:
            t1 = min(t0 + T, tp[br + 1])
            assert 0 < t1 - t0 <= T
            covered[t0:t1] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize(
    "counts", [[], [0, 0], [1, T, 0, T - 1, 3]], ids=["no-block-rows", "no-tiles", "at-most-T"]
)
def test_tile_split_is_none_without_a_block_row_longer_than_t(counts):
    tp = np.concatenate([[0], np.cumsum(np.asarray(counts, np.int64))])
    assert tile_split(tp) is None
    assert tile_split(torch.from_numpy(tp).to(torch.int32)) is None


def _block_graph(seed=0, edges_per_tile=40):
    """A symmetric, sym-normalized graph of 35 blocks of 128 nodes whose
    tiles each hold ``edges_per_tile`` edges or more (so every edge lands in
    a tile): block-row 0 meets all 35 block-columns (3 segments at T = 16),
    block-row 1 meets 16 (one block walks it), block-row 2 meets 17 (2
    segments), the others two to four."""
    rng = np.random.RandomState(seed)
    nb = 35
    pairs = {(0, j) for j in range(nb)} | {(1, j) for j in range(1, 16)}
    pairs |= {(2, j) for j in range(2, 17)} | {(j, j) for j in range(nb)}
    pairs |= {(j, j + 1) for j in range(20, nb - 1, 3)}
    pairs |= {(j, i) for i, j in pairs}
    rows, cols = [], []
    for bi, bj in sorted(pairs):
        if bi > bj:
            continue
        r = rng.randint(0, TILE, edges_per_tile) + bi * TILE
        c = rng.randint(0, TILE, edges_per_tile) + bj * TILE
        rows += [r, c]
        cols += [c, r]
    key = np.unique(np.concatenate(rows) * (nb * TILE) + np.concatenate(cols))
    n = nb * TILE
    r, c = key // n, key % n
    r, c, v = sym_normalize_coo(r, c, np.ones(len(r)), n)
    return r, c, v.astype(np.float32).astype(np.float64), n


def _segmented_tile_sum(b, x, split):
    """The kernel's order of sums, emulated in f32: a block-row of at most T
    tiles is the sum of its tile products in tile order; a longer one
    p_0 + p_1 + ..., each segment's partial (its tiles in order) added in
    segment order."""
    tiles = b.blocks.float().numpy()
    tp, cols = b.tile_ptr.numpy(), b.block_cols.numpy()
    xb = x.reshape(-1, TILE, x.shape[1])

    def tile_sum(t0, t1):
        acc = np.zeros((TILE, x.shape[1]), np.float32)
        for t in range(t0, t1):
            acc = acc + tiles[t] @ xb[cols[t]]
        return acc

    out = np.zeros((b.n_block_rows, TILE, x.shape[1]), np.float32)
    for br in np.flatnonzero(np.diff(tp) <= T):
        out[br] = tile_sum(tp[br], tp[br + 1])
    seg_row, seg_t0, long_ptr = (t.numpy() for t in (split.seg_row, split.seg_e0, split.long_ptr))
    for i in range(split.n_long):
        br = seg_row[long_ptr[i]]
        acc = np.zeros((TILE, x.shape[1]), np.float32)
        for k in range(long_ptr[i], long_ptr[i + 1]):
            acc = acc + tile_sum(seg_t0[k], min(seg_t0[k] + T, tp[br + 1]))
        out[br] = acc
    return out.reshape(-1, x.shape[1])


@pytest.mark.parametrize("store_bf16", [True, False])
def test_segmented_tile_sum_matches_plain_and_the_jax_hybrid(store_bf16):
    """The split tile sum against ``bsr_spmm_plain`` (f32 sums of up to 35
    tile products in another order: 1e-5 relative to the largest output)
    and against JAX ``spmm_hybrid`` in interpret mode on the same layout
    (every edge in a tile, so the hybrid is its tile leg; JAX casts x to
    bf16, so the features are drawn bf16-representable and only the order
    of f32 sums differs; 1e-4)."""
    r, c, v, n = _block_graph()
    h_t = treorder.HybridGraph.from_coo(
        r, c, v, n, symmetric=True, store_bf16=store_bf16, device=CPU
    )
    h_j = jreorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, store_bf16=store_bf16)
    b = h_t.bsr
    assert h_t.rest is None and h_j.rest is None
    counts = np.diff(b.tile_ptr.numpy())
    assert counts.max() == 35 and (counts == T).any() and (counts == T + 1).any()
    assert (b.split.n_long, b.split.n_seg) == (2, 5)
    x16 = torch.from_numpy(np.random.RandomState(1).randn(n, 24).astype(np.float32)).bfloat16()
    x = x16.float().numpy()
    want = _segmented_tile_sum(b, x, b.split)
    scale = np.abs(want).max()
    got = bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, x16 if store_bf16 else x16.float(),
                   split=b.split)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    jax_out = np.asarray(jreorder.spmm_hybrid(h_j, jnp.asarray(x), True, store_bf16))
    np.testing.assert_allclose(jax_out, want, rtol=0, atol=1e-4 * scale)


def test_containers_build_the_tile_split_once_and_carry_it():
    r, c, v, n = _block_graph(seed=1)
    b = BlockSparseGraph.from_coo(r, c, v, n, device=CPU)
    want = tile_split(b.tile_ptr.numpy())
    assert torch.equal(b.split.table, want.table)
    assert fingerprint_of(b.tile_ptr) == want.fingerprint
    h = treorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, device=CPU)
    assert torch.equal(h.bsr.split.table, want.table)
    # a stack without a block-row longer than T carries none: block-rows 3-5
    m = (r >= 3 * TILE) & (r < 6 * TILE)
    small = BlockSparseGraph.from_coo(r[m] - 3 * TILE, c[m], v[m], 3 * TILE, n_cols=n,
                                      device=CPU)
    assert small.split is None and bsr_spmm(
        small.blocks, small.tile_ptr, small.block_cols, torch.zeros(n, 16), split=None
    ).shape == (3 * TILE, 16)


@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_shard_tile_splits_put_together_equal_the_single_device_split(n_shards):
    """Every shard's block carries its own table, and a global block-row is
    cut into the same segments (at the same offsets from its first tile) in
    the shard's stack as in the single-device stack; the legs give the
    single-device pass's rows."""
    r, c, v, n = _block_graph(seed=2)
    h = treorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, device=CPU)

    def segments(b, sp, offset):
        if sp is None:
            return {}
        tp = b.tile_ptr.numpy()
        seg_row, seg_t0 = sp.seg_row.numpy(), sp.seg_e0.numpy()
        out = {}
        for br, t0 in zip(seg_row, seg_t0):
            out.setdefault(int(br) + offset, []).append(int(t0 - tp[br]))
        return out

    want = segments(h.bsr, h.bsr.split, 0)
    got = {}
    x = torch.from_numpy(np.random.RandomState(3).randn(n, 16).astype(np.float32))
    outs = []
    for p in range(n_shards):
        mh = MeshHybridAllGather.from_coo(r, c, v, n, n_shards, p, symmetric=True, device=CPU)
        b = mh.bsr
        got.update(segments(b, b.split, p * mh.rows_per_shard // TILE))
        if b.split is not None:
            assert fingerprint_of(b.tile_ptr) == b.split.fingerprint
        x_full = torch.zeros(mh.n_pad, 16)
        x_full[:n] = x
        xp = treorder.feature_table(x_full, mh.n_pad, torch.bfloat16)
        outs.append(bsr_leg(b.blocks, b.tile_ptr, b.block_cols, xp, split=b.split))
    assert got == want and len(want) == 2
    xp = treorder.feature_table(x, h.bsr.n_block_rows * TILE, torch.bfloat16)
    single = bsr_spmm(h.bsr.blocks, h.bsr.tile_ptr, h.bsr.block_cols, xp, split=h.bsr.split)
    assert torch.equal(torch.cat(outs)[:n], single[:n])


def _asymmetric_graph(n=1300, seed=0):
    """A square, asymmetric attention graph: row 3 has 1,100 out-edges and
    column 9 has 700 in-edges, so both CSRs have tables, with equal counts
    (n rows, E edges) but different row pointers."""
    rng = np.random.RandomState(seed)
    row = np.r_[np.full(1100, 3), rng.permutation(n)[:700], rng.randint(0, n, 3000)]
    col = np.r_[rng.permutation(n)[:1100], np.full(700, 9), rng.randint(0, n, 3000)]
    key = np.unique(row * n + col)
    return key // n, key % n, rng.rand(len(key)) * 0.9 + 0.1, n


@pytest.mark.parametrize(
    "kernel",
    ["row_reduce", "attn_agg", "bsr_spmm", "stats_logits", "softmax_stats", "rowsum"],
)
def test_a_table_of_another_csr_with_equal_counts_is_refused(kernel):
    """C.2: the forward table with the transpose CSR (and the other way
    round), or one tile stack's table with another stack of the same counts,
    is refused on the fingerprint before anything runs; each table is
    taken with its own CSR."""
    if kernel == "bsr_spmm":
        counts = _tile_counts(40)
        other = np.roll(counts, 1)  # the same block-rows and tiles, moved
        tp, tp_other = (np.concatenate([[0], np.cumsum(k)]).astype(np.int32) for k in (counts, other))
        nt = int(tp[-1])
        tiles = torch.zeros(nt, TILE, TILE)
        cols = torch.zeros(nt, dtype=torch.int32)
        x = torch.zeros(TILE, 16)
        ptr = torch.from_numpy(tp)
        sp, sp_other = tile_split(ptr), tile_split(tp_other)
        assert (sp_other.n_rows, sp_other.n_edges) == (sp.n_rows, sp.n_edges)
        with pytest.raises(ValueError, match="fingerprint"):
            bsr_spmm(tiles, ptr, cols, x, split=sp_other)
        with pytest.raises(ValueError, match="fingerprint"):
            bsr_leg(tiles, ptr, cols, x, split=sp_other)
        assert bsr_spmm(tiles, ptr, cols, x, split=sp).shape == (len(counts) * TILE, 16)
        with pytest.raises(ValueError, match="TileSplit"):
            bsr_spmm(tiles, ptr, cols, x, split=build_split(tp, T, RowSplit))
        return
    r, c, v, n = _asymmetric_graph()
    ag = att.AttentionGraph.from_coo(r, c, v, n, device=CPU)
    assert ag.split is not None and ag.split_t is not None
    assert (ag.split.n_rows, ag.split.n_edges) == (ag.split_t.n_rows, ag.split_t.n_edges)
    assert ag.split.fingerprint != ag.split_t.fingerprint
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(n, 8).astype(np.float32))
    if kernel == "row_reduce":
        w_t = torch.from_numpy(rng.rand(ag.n_edges).astype(np.float32))
        with pytest.raises(ValueError, match="fingerprint"):
            row_reduce(ag.row_ptr_t, ag.col_t, w_t, x, split=ag.split)
        with pytest.raises(ValueError, match="fingerprint"):
            row_reduce(ag.row_ptr, ag.col, w_t, x, split=ag.split_t)
        row_reduce(ag.row_ptr_t, ag.col_t, w_t, x, split=ag.split_t)
    elif kernel == "attn_agg":
        lg = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32))
        mx, sm = att.softmax_stats(ag.row_ptr, lg)
        with pytest.raises(ValueError, match="fingerprint"):
            att.attn_agg(ag.row_ptr, ag.col, lg, mx, sm, x, split=ag.split_t)
        with pytest.raises(ValueError, match="split table"):
            att.attn_agg(ag.row_ptr_t, ag.col_t, lg, mx, sm, x, split=ag.split)
        att.attn_agg(ag.row_ptr, ag.col, lg, mx, sm, x, split=ag.split)
    elif kernel == "stats_logits":
        es, ed = (torch.from_numpy(rng.randn(n).astype(np.float32)) for _ in range(2))
        with pytest.raises(ValueError, match="fingerprint"):
            att.stats_logits(ag.row_ptr, ag.col, ag.logval, es, ed, 0.2, split=ag.split_t)
        att.stats_logits(ag.row_ptr, ag.col, ag.logval, es, ed, 0.2, split=ag.split)
    elif kernel == "softmax_stats":
        lg = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32))
        with pytest.raises(ValueError, match="fingerprint"):
            att.softmax_stats(ag.row_ptr, lg, split=ag.split_t)
        with pytest.raises(ValueError, match="fingerprint"):
            att.softmax_stats(ag.row_ptr_t, lg, split=ag.split)
        att.softmax_stats(ag.row_ptr, lg, split=ag.split)
    else:
        v = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32))
        with pytest.raises(ValueError, match="fingerprint"):
            att.rowsum(ag.row_ptr_t, v, split=ag.split)
        with pytest.raises(ValueError, match="fingerprint"):
            att.rowsum(ag.row_ptr, v, split=ag.split_t)
        att.rowsum(ag.row_ptr, v, split=ag.split)
        att.rowsum(ag.row_ptr_t, v, split=ag.split_t)


def test_fingerprint_records_survive_moves_and_void_on_change():
    """The containers record each table's fingerprint on the pointer tensor
    they build, and again on the copies their ``.to`` makes: a check reads
    the record (a tensor on the meta device has no values to hash, and
    passes), and an in-place change to the tensor voids it."""
    r, c, v, n = _asymmetric_graph(seed=2)
    ag = att.AttentionGraph.from_coo(r, c, v, n, device=CPU)
    meta = ag.to(torch.device("meta"))
    assert meta.split.table.device.type == "meta" and meta.row_ptr.device.type == "meta"
    assert fingerprint_of(meta.row_ptr) == ag.split.fingerprint
    assert fingerprint_of(meta.row_ptr_t) == ag.split_t.fingerprint
    ptr = ag.row_ptr.clone()
    assert fingerprint_of(ptr) == ag.split.fingerprint  # hashed from its values
    ptr[1] += 1
    assert fingerprint_of(ptr) != ag.split.fingerprint


def test_attention_graph_builds_the_forward_split_and_moves_it():
    r, c, v, n = _asymmetric_graph(seed=3)
    ag = att.AttentionGraph.from_coo(r, c, v, n, device=CPU)
    want = row_split(ag.row_ptr.numpy())
    assert want is not None and want.n_long >= 1
    assert torch.equal(ag.split.table, want.table)
    moved = ag.to(CPU)
    assert torch.equal(moved.split.table, want.table) and moved.n_edges == ag.n_edges
    for f in ("row_ptr", "col", "logval", "row_ptr_t", "col_t", "perm_t", "edge_pos"):
        assert torch.equal(getattr(moved, f), getattr(ag, f))
    # no row longer than S: no table
    keep = r != 3
    short = att.AttentionGraph.from_coo(r[keep], c[keep], v[keep], n, device=CPU)
    assert np.diff(short.row_ptr.numpy()).max() <= SEGMENT_EDGES and short.split is None


@pytest.mark.parametrize(
    "graph", [None, "topic", "docword"], ids=["default", "topic", "docword"]
)
def test_cli_graph_defaults_to_topic_and_prepares_it(graph, monkeypatch, tmp_path):
    """C.1: as in the JAX package, ``--graph`` defaults to ``topic``, and
    ``train`` without it (or with ``--graph topic``) prepares the topic graph
    (docs, then topics; dense features) and trains on it; ``--graph
    docword`` prepares the doc-word graph (identity features). The tiny
    corpus's graphs are built by the JAX package's builders; the CLI runs on
    the CPU here (it sees a CUDA device, and its ``run_experiment`` is given
    the CPU). The library's ``run_experiment`` defaults the same way."""
    root = build_tiny(tmp_path / "t", docword=True)
    prepared, prepare_data = [], trun.prepare_data

    def prepare(*a, **k):
        prepared.append(prepare_data(*a, **k))
        return prepared[-1]

    monkeypatch.setattr(trun, "prepare_data", prepare)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        cli, "run_experiment", lambda *a, **k: run_experiment(*a, **{**k, "device": "cpu"})
    )
    argv = ["train", "--dataset", "tiny", "--data_root", root, "--max_epoch", "2",
            "--nhid", "8", "--quiet", "--output_dir", str(tmp_path)]
    if graph is not None:
        argv += ["--graph", graph]
    assert cli.main(argv) == 0
    (pre,) = prepared
    family = graph or "topic"
    assert (tmp_path / f"tiny_{family}_training_results.json").exists()
    if family == "topic":
        assert (pre.num_docs, pre.num_topics, pre.n_nodes) == (N_DOCS, N_TOPICS, N_DOCS + N_TOPICS)
        assert pre.features.shape == (N_DOCS + N_TOPICS, pre.n_feat)
    else:
        assert pre.features is None and pre.num_topics == 0 and pre.n_nodes > N_DOCS
    assert inspect.signature(run_experiment).parameters["graph_family"].default == "topic"
