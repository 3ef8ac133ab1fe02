"""The port's CUDA kernels and their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(``--noconftest``: the repo's conftest imports JAX). Tests marked ``cuda``
build the kernels and hold them against the plain versions; they skip where
there is no GPU. The plain versions are held against numpy everywhere.
"""
import numpy as np
import pytest
import torch

from textgcn_tpu_torch.graph import reorder
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.ops import attention as att
from textgcn_tpu_torch.graph.structs import BlockSparseGraph
from textgcn_tpu_torch.ops.bsr_spmm import (
    SEGMENT_TILES, bsr_leg, bsr_spmm, bsr_spmm_f32, bsr_spmm_plain, tile_split,
)
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather,
    shard_hybrid_pass,
    shard_hybrid_pass_plain,
)
from textgcn_tpu_torch.ops import _build
from textgcn_tpu_torch.ops.row_reduce import (
    RUN_TILE_ROWS, SEGMENT_EDGES, row_reduce, row_reduce_plain, row_reduce_run_plain, row_split,
)

CPU = torch.device("cpu")


def _graph(n=700, e=24000, seed=0):
    """A sym-normalized power-law graph with both hybrid legs non-empty."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -1.0
    p /= p.sum()
    r, c, v = max_symmetrize_coo(rng.choice(n, e, p=p), rng.choice(n, e, p=p), rng.rand(e), n)
    return (*sym_normalize_coo(r, c, v, n), n)


def _hybrid(dev, f, seed=0):
    r, c, v, n = _graph(seed=seed)
    _, h = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((h.bsr.n_block_rows * 128, f), generator=gen, device=dev)
    return h, xp.to(torch.bfloat16)


def test_bsr_spmm_plain_matches_dense_numpy():
    h, xp = _hybrid(CPU, 24)
    b = h.bsr
    a = np.zeros((b.n_block_rows * 128,) * 2)
    for t in range(b.nnzb):
        i, j = int(b.block_rows[t]) * 128, int(b.block_cols[t]) * 128
        a[i : i + 128, j : j + 128] += b.blocks[t].float().numpy()
    want = a @ xp.float().numpy().astype(np.float64)
    got = bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, xp)  # CPU: plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _shard(dev, n_shards, shard, store_bf16=True):
    """One shard's hybrid block (its block-rows against all block-columns)
    of the degree-sorted test graph."""
    r, c, v, n = _graph(seed=2)
    perm = reorder.degree_sort_permutation(r, c, n)
    return MeshHybridAllGather.from_coo(
        perm[r], perm[c], v, n, n_shards, shard, store_bf16=store_bf16, device=dev
    )


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_bsr_spmm_plain_on_a_rectangular_block_matches_dense_numpy(shard):
    """A shard's tiles: 256 rows x 1024 columns at 4 shards of the 700-node
    graph; shard 3 holds only rows past the last node, so its block-rows
    have no tiles and come out zero."""
    mh = _shard(CPU, 4, shard, store_bf16=False)
    b = mh.bsr
    assert (b.n_block_rows * 128, mh.n_pad) == (mh.rows_per_shard, 1024) == (256, 1024)
    a = np.zeros((mh.rows_per_shard, mh.n_pad))
    for t in range(b.nnzb):
        i, j = int(b.block_rows[t]) * 128, int(b.block_cols[t]) * 128
        a[i : i + 128, j : j + 128] += b.blocks[t].numpy()
    x = torch.from_numpy(np.random.RandomState(shard).randn(mh.n_pad, 24).astype(np.float32))
    got = bsr_leg(b.blocks, b.tile_ptr, b.block_cols, x)  # CPU: plain version
    assert got.shape == (mh.rows_per_shard, 24)
    np.testing.assert_allclose(got.numpy(), a @ x.numpy().astype(np.float64), rtol=1e-5, atol=1e-5)
    if shard == 3:
        assert b.nnzb == 0 and not got.any()
    with pytest.raises(ValueError, match="outside"):
        BlockSparseGraph.from_coo(
            np.array([0]), np.array([600]), np.array([1.0]), 128, n_cols=512, device=CPU
        )


@pytest.mark.parametrize("with_base", [True, False])
def test_row_reduce_plain_matches_numpy(with_base):
    h, xp = _hybrid(CPU, 24, seed=1)
    rest = h.rest
    rows = np.repeat(np.arange(rest.row_ptr.numel() - 1), np.diff(rest.row_ptr.numpy()))
    base = torch.randn((xp.shape[0], 24)) if with_base else None
    want = np.zeros((xp.shape[0] if with_base else h.n_nodes, 24))
    if with_base:
        want += base.numpy()
    np.add.at(want, rows, rest.val.numpy()[:, None] * xp.float().numpy()[rest.col.numpy()])
    got = row_reduce(rest.row_ptr, rest.col, rest.val, xp, base=base)
    if with_base:
        assert got is base  # updated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 64, 208])
def test_bsr_spmm_kernel_matches_plain(cuda_dev, f):
    h, xp = _hybrid(cuda_dev, f)
    b = h.bsr
    args = (b.blocks, b.tile_ptr, b.block_cols, xp)
    n0 = bsr_spmm.launches
    got = bsr_spmm(*args)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == n0 + 1
    # the same bf16 products summed in f32 in another order
    torch.testing.assert_close(got, bsr_spmm_plain(*args), rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError, match="bf16"):
        bsr_spmm(b.blocks.float(), b.tile_ptr, b.block_cols, xp)
    with pytest.raises(ValueError, match="multiple of"):
        bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, xp[:, :8].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 2, 3])
@pytest.mark.parametrize("f", [16, 208])
def test_bsr_leg_kernel_on_a_rectangular_block_matches_plain(cuda_dev, shard, f):
    """K1 as B10: one shard's block-rows against all block-columns (shard 3
    has no tiles), then the shard's whole pass (K1, K2 in place)."""
    mh = _shard(cuda_dev, 4, shard)
    b = mh.bsr
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    x = torch.randn((mh.n_pad, f), generator=gen, device=cuda_dev).to(torch.bfloat16)
    args = (b.blocks, b.tile_ptr, b.block_cols, x)
    n_leg, n_spmm = bsr_leg.launches, bsr_spmm.launches
    got = bsr_leg(*args)
    torch.cuda.synchronize()
    assert (bsr_leg.launches, bsr_spmm.launches) == (n_leg + 1, n_spmm)
    assert got.shape == (mh.rows_per_shard, f)
    # the same bf16 products summed in f32 in another order
    torch.testing.assert_close(got, bsr_spmm_plain(*args), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        shard_hybrid_pass(mh, x), shard_hybrid_pass_plain(mh, x), rtol=1e-4, atol=1e-4
    )
    with pytest.raises(ValueError, match="multiple of 128"):
        bsr_leg(b.blocks, b.tile_ptr, b.block_cols, x[:-8].contiguous())


def _long_block_rows(dev, f, n_block_cols=128, seed=0):
    """A tile stack whose block-rows hold 3, 0, 1, T-1, T, T+1, 2T+3, 120, 0
    and 7 tiles (block-row 7 is the hub), random block-columns among
    ``n_block_cols``, tile values uniform in [0, 1) over 128 * sqrt(the
    block-row's tile count) (the row sums stay O(1), as in a normalized
    adjacency), and a bf16 feature table [n_block_cols * 128, f]."""
    t = SEGMENT_TILES
    counts = [3, 0, 1, t - 1, t, t + 1, 2 * t + 3, 120, 0, 7]
    rng = np.random.RandomState(seed)
    tp = np.concatenate([[0], np.cumsum(counts)])
    scale = np.repeat(1.0 / (128 * np.sqrt(np.maximum(counts, 1))), counts)
    tiles = rng.rand(tp[-1], 128, 128) * scale[:, None, None]
    cols = np.concatenate([rng.choice(n_block_cols, k, replace=False) for k in counts])

    def d(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    x = d(rng.randn(n_block_cols * 128, f), torch.float32).to(torch.bfloat16)
    return (d(tiles, torch.float32).to(torch.bfloat16), d(tp, torch.int32),
            d(cols, torch.int32), x)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", [bsr_spmm, bsr_leg], ids=["bsr_spmm", "bsr_leg"])
@pytest.mark.parametrize("f", [16, 48, 208, 256])
def test_bsr_spmm_kernel_splits_long_block_rows(cuda_dev, wrapper, f):
    """K1 (and as B10's ``bsr_leg``, on a rectangular block: 10 block-rows
    against 128 block-columns) over block-rows of up to 120 tiles through
    its split table: against the plain version, two launches bit-equal, the
    hub block-row bit-equal alone and inside the stack, and without a
    table."""
    tiles, tp, cols, x = _long_block_rows(cuda_dev, f)
    split = tile_split(tp)
    assert (split.n_long, split.n_seg) == (3, 13)
    n0 = wrapper.launches
    got = wrapper(tiles, tp, cols, x, split=split)
    again = wrapper(tiles, tp, cols, x, split=split)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 2
    assert torch.equal(got, again)
    want = bsr_spmm_plain(tiles, tp, cols, x)
    # the same bf16 products summed in f32 in another order
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    t0, t1 = int(tp[7]), int(tp[8])
    one_ptr = torch.tensor([0, t1 - t0], dtype=torch.int32, device=cuda_dev)
    alone = wrapper(tiles[t0:t1], one_ptr, cols[t0:t1].contiguous(), x,
                    split=tile_split(one_ptr))
    assert torch.equal(alone, got[7 * 128 : 8 * 128])
    # without a table every block-row is walked whole by one block
    torch.testing.assert_close(wrapper(tiles, tp, cols, x), want, rtol=1e-4, atol=1e-4)
    assert _build.load().textgcn_bsr_spmm_segment_tiles() == SEGMENT_TILES


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 112, 208, 256])
def test_bsr_spmm_f32_kernel_splits_long_block_rows(cuda_dev, f):
    """K1's f32 mode (3xTF32 on the tensor cores) over the same block-rows
    (f32 tiles and features, through ``bsr_spmm``, which counts its launches
    on ``bsr_spmm_f32``): 23 work items, fewer than the card's SMs, so the
    kernel also cuts them into row slabs. Against the plain version within
    2e-5 of the largest output; against the f64 oracle (the plain version
    on f64 inputs) at most 4x the plain f32 version's error; two launches
    bit-equal, without a table too; a mix of f32 and bf16 is refused."""
    tiles, tp, cols, x = _long_block_rows(cuda_dev, f)
    tiles, x = tiles.float() * (1 + torch.rand_like(tiles.float()) / 7), x.float()
    split = tile_split(tp)
    n0, n1 = bsr_spmm_f32.launches, bsr_spmm.launches
    got = bsr_spmm(tiles, tp, cols, x, split=split)
    again = bsr_spmm_f32(tiles, tp, cols, x, split=split)
    torch.cuda.synchronize()
    assert (bsr_spmm_f32.launches, bsr_spmm.launches) == (n0 + 2, n1)
    assert torch.equal(got, again)
    want = bsr_spmm_plain(tiles, tp, cols, x)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale
    exact = bsr_spmm_plain(tiles.double(), tp, cols, x.double())
    assert exact.dtype == torch.float64
    err64, plain64 = (float((t.double() - exact).abs().max()) for t in (got, want))
    assert err64 <= 4 * plain64
    assert float((bsr_spmm_f32(tiles, tp, cols, x) - want).abs().max()) <= 2e-5 * scale
    with pytest.raises(TypeError, match="f32 tiles with f32 features"):
        bsr_spmm(tiles, tp, cols, x.to(torch.bfloat16), split=split)
    assert _build.load().textgcn_bsr_spmm_f32_segment_tiles() == SEGMENT_TILES


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 112, 208])
def test_bsr_spmm_f32_kernel_bits_do_not_depend_on_the_grid(cuda_dev, f):
    """A block-row's result whether the call has fewer work items than SMs
    (each item cut into row slabs) or more (one block an item a feature
    slab): the hub block-row of the long stack alone (its 8 segments and
    itself: 9 items), and inside a stack of 300 one-tile block-rows
    besides. Above 64 features both grids run the same products: the same
    bits. At most 64 features the larger grid runs the narrow layout (the
    tile as the register operand, x as the shared one), which splits other
    operands: within 2e-5 of the largest output."""
    tiles, tp, cols, x = _long_block_rows(cuda_dev, f)
    tiles, x = tiles.float(), x.float()
    t0, t1 = int(tp[7]), int(tp[8])
    hub, hub_cols = tiles[t0:t1], cols[t0:t1]
    one_ptr = torch.tensor([0, t1 - t0], dtype=torch.int32, device=cuda_dev)
    alone = bsr_spmm_f32(hub, one_ptr, hub_cols.contiguous(), x, split=tile_split(one_ptr))
    extra = 300
    big_tiles = torch.cat([hub, tiles[:1].expand(extra, 128, 128)]).contiguous()
    big_cols = torch.cat([hub_cols, cols[:1].expand(extra)]).contiguous()
    big_ptr = torch.cat([one_ptr, (t1 - t0) + torch.arange(1, extra + 1, device=cuda_dev,
                                                           dtype=torch.int32)])
    inside = bsr_spmm_f32(big_tiles, big_ptr, big_cols, x, split=tile_split(big_ptr))
    torch.cuda.synchronize()
    assert torch.cuda.get_device_properties(cuda_dev).multi_processor_count < extra
    if f > 64:
        assert torch.equal(alone, inside[:128])
    else:
        assert float((alone - inside[:128]).abs().max()) <= 2e-5 * float(alone.abs().max())
    first = bsr_spmm_plain(tiles[:1], torch.tensor([0, 1], dtype=torch.int32, device=cuda_dev),
                           cols[:1], x)
    assert float((inside[128:256] - first).abs().max()) <= 2e-5 * float(first.abs().max())


@pytest.mark.cuda
def test_segment_sums_on_cuda_give_the_same_bits_every_call(cuda_dev):
    """``--spmm segment`` on the card: ``spmm_coo_segment`` (and its
    transpose backward) and the GAT segment layer's forward and gradients
    give the same bits on every call (the scatter-add is
    ``index_put_(accumulate=True)`` there; ``index_add_`` adds with
    atomics), and match the CPU's."""
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.models import gat as tgat
    from textgcn_tpu_torch.ops.spmm import spmm_coo_segment

    r, c, v, n = _graph(seed=4)
    g = SparseGraph.from_coo(r, c, v, n, device=cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    x = torch.randn((n, 200), generator=gen, device=cuda_dev)
    cot = torch.randn((n, 200), generator=gen, device=cuda_dev)

    def segment():
        xr = x.clone().requires_grad_(True)
        y = spmm_coo_segment(g.row, g.col, g.val, xr, n)
        y.backward(cot)
        return y.detach(), xr.grad

    def gat_layer():
        es, ed = x[:, 0].clone().requires_grad_(True), x[:, 1].clone().requires_grad_(True)
        h = x.clone().requires_grad_(True)
        out = tgat.gat_attention_segment(g, es, ed, h)
        out.backward(cot)
        return out.detach(), es.grad, ed.grad, h.grad

    for fn in (segment, gat_layer):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
    y, gx = segment()
    gc = SparseGraph.from_coo(r, c, v, n, device=CPU)
    want = spmm_coo_segment(gc.row, gc.col, gc.val, x.cpu(), n)
    torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 208])
def test_shard_legs_with_long_block_rows_equal_the_single_device_pass(cuda_dev, f):
    """A degree-sorted power-law graph of 4,600 nodes whose hub block-rows
    hold more than T tiles: each shard's pass (K1 as ``bsr_leg`` with the
    shard's split table, then K2) at 2 and 3 shards, put together, gives
    the single-device hybrid pass's bits."""
    r, c, v, n = _graph(n=4600, e=600_000, seed=7)
    perm = reorder.degree_sort_permutation(r, c, n)
    r, c = perm[r], perm[c]
    h = reorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, device=cuda_dev)
    assert h.bsr.split is not None
    gen = torch.Generator(device=cuda_dev).manual_seed(f)
    x = torch.randn((n, f), generator=gen, device=cuda_dev)
    want = reorder.hybrid_pass(h, x)
    for n_shards in (2, 3):
        outs = []
        for p in range(n_shards):
            mh = MeshHybridAllGather.from_coo(r, c, v, n, n_shards, p, device=cuda_dev)
            x_full = torch.zeros((mh.n_pad, f), device=cuda_dev)
            x_full[:n] = x
            outs.append(shard_hybrid_pass(mh, x_full))
        assert torch.equal(torch.cat(outs)[:n], want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [True, False])
def test_row_reduce_kernel_matches_plain(cuda_dev, with_base):
    h, xp = _hybrid(cuda_dev, 208, seed=1)
    rest = h.rest
    args = (rest.row_ptr, rest.col, rest.val, xp)
    base = torch.randn(xp.shape, device=cuda_dev) if with_base else None
    n0 = row_reduce.launches
    got = row_reduce(*args, base=None if base is None else base.clone())
    torch.cuda.synchronize()
    assert row_reduce.launches == n0 + 1
    want = row_reduce_plain(*args, base=None if base is None else base.clone())
    # f32 sums of a few products per row (fma vs mul + add)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="bf16"):
        row_reduce(rest.row_ptr, rest.col, rest.val, xp.float())
    # the kernel walks at most the S that the split tables are built for
    assert _build.load().textgcn_row_reduce_segment_edges() == SEGMENT_EDGES


def _long_rows(dev, f, seed=0):
    """A row-sorted CSR whose rows hold 0, 1, S-1, S, S+1, 3S+5 and 10,000
    edges among short rows (the hub is row 7), weights uniform in [0, 1)
    over the square root of their row's degree (as a normalized adjacency:
    the row sums and their partial sums stay O(1)), and bf16 features
    [2000, f]."""
    s = SEGMENT_EDGES
    degs = [3, 0, 1, s - 1, s, s + 1, 3 * s + 5, 10_000, 0, 7, 50, 2]
    rng = np.random.RandomState(seed)
    rp = np.concatenate([[0], np.cumsum(degs)])
    col = rng.randint(0, 2000, rp[-1])
    val = rng.rand(rp[-1]) / np.sqrt(np.repeat(degs, degs))
    x = rng.randn(2000, f)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    return (t(rp, torch.int32), t(col, torch.int32), t(val, torch.float32),
            t(x, torch.float32).to(torch.bfloat16), rng)


@pytest.mark.cuda
@pytest.mark.parametrize("with_base", [True, False])
@pytest.mark.parametrize("f", [8, 16, 200, 264, 18])
def test_row_reduce_kernel_splits_long_rows(cuda_dev, f, with_base):
    """K2 over rows up to 10,000 edges through its split table (F=18 takes
    the 4-byte path): against the plain version, two launches bit-equal,
    the hub row bit-equal alone and inside the CSR, and without a table."""
    rp, col, val, x, rng = _long_rows(cuda_dev, f)
    n_rows = rp.numel() - 1
    split = row_split(rp)
    assert split.n_long == 3
    base = torch.from_numpy(rng.randn(n_rows, f).astype(np.float32)).to(cuda_dev)

    def run(*args, b=base, sp=split):
        return row_reduce(*args, base=b.clone() if with_base else None, split=sp)

    n0 = row_reduce.launches
    got = run(rp, col, val, x)
    again = run(rp, col, val, x)
    torch.cuda.synchronize()
    assert row_reduce.launches == n0 + 2
    assert torch.equal(got, again)
    want = row_reduce_plain(rp, col, val, x, base.clone() if with_base else None)
    # f32 sums of up to 10,000 products in another order (the smoke's K2 tolerance
    # for GAT's hub rows, ATT_TOL)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    e0, e1 = int(rp[7]), int(rp[8])
    one_ptr = torch.tensor([0, e1 - e0], dtype=torch.int32, device=cuda_dev)
    alone = run(one_ptr, col[e0:e1].contiguous(), val[e0:e1].contiguous(), x,
                b=base[7:8], sp=row_split(one_ptr))
    assert torch.equal(alone[0], got[7])
    # without a table every row is walked whole by one warp: right, unbalanced
    torch.testing.assert_close(run(rp, col, val, x, sp=None), want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 200, 264])
def test_attn_agg_kernel_splits_long_rows(cuda_dev, f):
    """``attn_agg`` over rows up to 10,000 edges through the forward CSR's
    split table, with some logits -inf: against the plain version, two
    launches bit-equal, the hub row bit-equal alone and inside the CSR,
    and without a table."""
    rp, col, _, x, rng = _long_rows(cuda_dev, f, seed=2)
    lg = torch.from_numpy(rng.randn(col.numel()).astype(np.float32)).to(cuda_dev)
    lg[::41] = -float("inf")
    mx, sm = att.softmax_stats_plain(rp, lg)
    split = row_split(rp)
    assert split.n_long == 3
    n0 = att.attn_agg.launches
    got = att.attn_agg(rp, col, lg, mx, sm, x, split=split)
    again = att.attn_agg(rp, col, lg, mx, sm, x, split=split)
    torch.cuda.synchronize()
    assert att.attn_agg.launches == n0 + 2
    assert torch.equal(got, again)
    want = att.attn_agg_plain(rp, col, lg, mx, sm, x)
    # f32 weights times bf16 features summed in f32 in another order, over
    # up to 10,000 edges whose weights sum to 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    e0, e1 = int(rp[7]), int(rp[8])
    one_ptr = torch.tensor([0, e1 - e0], dtype=torch.int32, device=cuda_dev)
    alone = att.attn_agg(one_ptr, col[e0:e1].contiguous(), lg[e0:e1].contiguous(),
                         mx[7:8], sm[7:8], x, split=row_split(one_ptr))
    assert torch.equal(alone[0], got[7])
    torch.testing.assert_close(att.attn_agg(rp, col, lg, mx, sm, x), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stats_logits", "softmax_stats"])
def test_attn_stats_kernel_splits_long_rows(cuda_dev, mode):
    """``attn_stats`` in B5 mode (``stats_logits``) and B6 mode
    (``softmax_stats``) over rows up to 10,000 edges through the forward
    CSR's split table, with some logits -inf (in B6 every logit of the hub
    row's second segment and of a short row, which keeps the sentinel):
    against the plain version, two launches bit-equal, the hub row
    bit-equal alone and inside the CSR, and without a table: the same
    logits and max bits (a max does not depend on order) and sums as
    close to the plain version."""
    rp, col, val, _, rng = _long_rows(cuda_dev, 8, seed=3)
    n_rows, n_edges = rp.numel() - 1, col.numel()
    split = row_split(rp)
    assert split.n_long == 3
    e0, e1 = int(rp[7]), int(rp[8])  # the hub row
    one_ptr = torch.tensor([0, e1 - e0], dtype=torch.int32, device=cuda_dev)
    if mode == "stats_logits":
        logval = torch.log(val)
        logval[::41] = -float("inf")  # val 0: the edge drops out
        es = torch.from_numpy(rng.randn(n_rows).astype(np.float32)).to(cuda_dev)
        ed = torch.from_numpy(rng.randn(2000).astype(np.float32)).to(cuda_dev)
        wrapper = att.stats_logits

        def run(sp, ptr=rp, lo=0, hi=n_edges, es_=es):
            return att.stats_logits(ptr, col[lo:hi].contiguous(), logval[lo:hi].contiguous(),
                                    es_, ed, 0.2, split=sp)

        want = att.stats_logits_plain(rp, col, logval, es, ed, 0.2)
        alone = run(row_split(one_ptr), one_ptr, e0, e1, es[7:8])
        hub = (alone[0], *(t[0] for t in alone[1:]))
    else:
        lg = torch.from_numpy(rng.randn(n_edges).astype(np.float32) * 3).to(cuda_dev)
        lg[::41] = -float("inf")
        lg[e0 + SEGMENT_EDGES : e0 + 2 * SEGMENT_EDGES] = -float("inf")
        lg[int(rp[0]) : int(rp[1])] = -float("inf")  # row 0: 3 edges
        wrapper = att.softmax_stats

        def run(sp, ptr=rp, lo=0, hi=n_edges):
            return att.softmax_stats(ptr, lg[lo:hi].contiguous(), split=sp)

        want = att.softmax_stats_plain(rp, lg)
        alone = run(row_split(one_ptr), one_ptr, e0, e1)
        hub = tuple(t[0] for t in alone)
    n0 = wrapper.launches
    got, again = run(split), run(split)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # the same f32 logits; exp-sums of up to 10,000 terms in another order
    # (the smoke's ATT_TOL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    mx, sm = got[-2:]
    if mode == "softmax_stats":
        assert (mx[0].item(), sm[0].item()) == (np.float32(-1e30), 0.0)
    # the hub row alone, with its own table, gives the same bits
    if mode == "stats_logits":
        assert torch.equal(hub[0], got[0][e0:e1])
    assert (torch.equal(hub[-2], mx[7]), torch.equal(hub[-1], sm[7])) == (True, True)
    # without a table every row is one warp's: the logits and the max keep
    # their bits, the sums are as close to the plain version
    no_table = run(None)
    for a, b in zip(no_table[:-1], got[:-1]):
        assert torch.equal(a, b)
    torch.testing.assert_close(no_table[-1], want[-1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_rowsum_kernel_splits_long_rows(cuda_dev):
    """``rowsum`` over both CSRs of an asymmetric square graph (a hub row of
    10,000 edges and a hub column of 3,000 in-edges), each through its own
    split table: against the plain version, two launches bit-equal, the hub
    row bit-equal alone and inside the CSR, and without a table."""
    n = 12_000
    rng = np.random.RandomState(4)
    row = np.r_[np.full(10_000, 3), rng.permutation(n)[:3000], rng.randint(0, n, 30_000)]
    col = np.r_[rng.permutation(n)[:10_000], np.full(3000, 9), rng.randint(0, n, 30_000)]
    key = np.unique(row * n + col)
    ag = att.AttentionGraph.from_coo(key // n, key % n, np.ones(len(key)), n, device=cuda_dev)
    assert ag.split.n_long >= 1 and ag.split_t.n_long >= 1
    assert ag.split.fingerprint != ag.split_t.fingerprint
    v = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32) / 100).to(cuda_dev)
    for ptr, sp, vals, hub in ((ag.row_ptr, ag.split, v, 3),
                               (ag.row_ptr_t, ag.split_t, v[ag.perm_t.long()], 9)):
        n0 = att.rowsum.launches
        got = att.rowsum(ptr, vals, split=sp)
        assert torch.equal(got, att.rowsum(ptr, vals, split=sp))
        torch.cuda.synchronize()
        assert att.rowsum.launches == n0 + 2
        want = att.rowsum_plain(ptr, vals)
        # f32 sums of up to 10,000 values in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        e0, e1 = int(ptr[hub]), int(ptr[hub + 1])
        assert e1 - e0 > SEGMENT_EDGES
        one_ptr = torch.tensor([0, e1 - e0], dtype=torch.int32, device=cuda_dev)
        alone = att.rowsum(one_ptr, vals[e0:e1].contiguous(), split=row_split(one_ptr))
        assert torch.equal(alone[0], got[hub])
        torch.testing.assert_close(att.rowsum(ptr, vals), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 16, 200, 264])
def test_sddmm_kernel_on_long_rows(cuda_dev, f):
    """The edge-parallel sddmm over the same rows: against the plain version,
    two launches bit-equal, and the hub row's products the same bits in a
    CSR of its own."""
    rp, col, _, x, rng = _long_rows(cuda_dev, f, seed=1)
    n_rows = rp.numel() - 1
    g = torch.from_numpy(rng.randn(n_rows, f).astype(np.float32)).to(cuda_dev).bfloat16()
    row = torch.repeat_interleave(torch.arange(n_rows, dtype=torch.int32, device=cuda_dev),
                                  torch.diff(rp))
    n0 = att.sddmm.launches
    u = att.sddmm(rp, col, g, x, row)
    assert torch.equal(u, att.sddmm(rp, col, g, x, row))
    assert att.sddmm.launches == n0 + 2
    # exact bf16 products summed in f32 in another order
    torch.testing.assert_close(u, att.sddmm_plain(rp, col, g, x), rtol=1e-5, atol=1e-4)
    e0, e1 = int(rp[7]), int(rp[8])
    one_ptr = torch.tensor([0, e1 - e0], dtype=torch.int32, device=cuda_dev)
    alone = att.sddmm(one_ptr, col[e0:e1].contiguous(), g[7:8], x, torch.zeros_like(row[e0:e1]))
    assert torch.equal(alone, u[e0:e1])
    with pytest.raises(ValueError, match="entries"):
        att.sddmm(rp, col, g, x, row[1:])


@pytest.mark.cuda
def test_hybrid_pass_on_gpu_matches_cpu_plain(cuda_dev):
    r, c, v, n = _graph(seed=6)
    x = torch.from_numpy(np.random.RandomState(0).randn(n, 200).astype(np.float32))
    _, h_cpu = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=CPU)
    _, h_gpu = reorder.reorder_and_build(r, c, v, n, symmetric=True, device=cuda_dev)
    n1, n2 = bsr_spmm.launches, row_reduce.launches
    got = reorder.spmm_hybrid(h_gpu, x.to(cuda_dev)).cpu()
    assert (bsr_spmm.launches, row_reduce.launches) == (n1 + 1, n2 + 1)
    torch.testing.assert_close(got, reorder.spmm_hybrid(h_cpu, x), rtol=1e-4, atol=1e-4)


def _attention_graph(dev, seed=0):
    """A degree-sorted attention graph: hub rows of a few hundred edges, a
    long tail, and rows without edges."""
    r, c, v, n = _graph(seed=seed)
    perm = reorder.degree_sort_permutation(r, c, n)
    r, c = perm[r], perm[c]
    keep = (r % 61) != 3
    return att.AttentionGraph.from_coo(
        r[keep], c[keep], v[keep], n, device=dev
    ), np.random.RandomState(seed)


def test_attention_plain_versions_match_numpy():
    ag, rng = _attention_graph(CPU, seed=2)
    n = ag.n_nodes
    rows, col = ag.row.numpy(), ag.col.numpy()
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    x = rng.randn(n, 12).astype(np.float32)
    lg, mx, sm = att.stats_logits(
        ag.row_ptr, ag.col, ag.logval, torch.from_numpy(es), torch.from_numpy(ed), 0.2
    )
    base = es[rows] + ed[col]
    want_lg = np.where(base >= 0, base, 0.2 * base) + ag.logval.numpy()
    np.testing.assert_allclose(lg.numpy(), want_lg, rtol=1e-6, atol=1e-6)
    out = att.attn_agg(ag.row_ptr, ag.col, lg, mx, sm, torch.from_numpy(x))
    want = np.zeros((n, 12))
    for r in range(n):
        e = rows == r
        if e.any():
            w = np.exp(want_lg[e] - want_lg[e].max())
            assert np.isclose(sm[r].item(), w.sum(), rtol=1e-5)
            want[r] = (w / w.sum()) @ x[col[e]]
        else:
            assert mx[r].item() == np.float32(-1e30) and sm[r].item() == 0
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-6)
    u = att.sddmm(ag.row_ptr, ag.col, torch.from_numpy(x), torch.from_numpy(x), ag.row)
    np.testing.assert_allclose(u.numpy(), np.sum(x[rows] * x[col], axis=1), rtol=1e-5, atol=1e-5)
    v = rng.randn(ag.n_edges).astype(np.float32)
    np.testing.assert_allclose(
        att.rowsum(ag.row_ptr, torch.from_numpy(v)).numpy(),
        np.bincount(rows, weights=v, minlength=n), rtol=1e-5, atol=1e-5,
    )


@pytest.mark.cuda
def test_attn_stats_kernel_matches_plain_in_both_modes(cuda_dev):
    ag, rng = _attention_graph(cuda_dev, seed=3)
    es = torch.from_numpy(rng.randn(ag.n_nodes).astype(np.float32)).to(cuda_dev)
    ed = torch.from_numpy(rng.randn(ag.n_nodes).astype(np.float32)).to(cuda_dev)
    args = (ag.row_ptr, ag.col, ag.logval, es, ed, 0.2)
    n0 = att.stats_logits.launches
    got = att.stats_logits(*args)
    torch.cuda.synchronize()
    assert att.stats_logits.launches == n0 + 1
    want = att.stats_logits_plain(*args)
    # the same f32 logit per edge; exp-sums of up to ~650 terms in another
    # order (the plain version adds with atomics)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    n1 = att.softmax_stats.launches
    for a, b in zip(att.softmax_stats(ag.row_ptr, want[0]), want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert att.softmax_stats.launches == n1 + 1
    with pytest.raises(TypeError, match="float32"):
        att.stats_logits(ag.row_ptr, ag.col, ag.logval, es.double(), ed, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [8, 200, 264])
def test_attn_agg_and_sddmm_kernels_match_plain(cuda_dev, f):
    ag, rng = _attention_graph(cuda_dev, seed=4)
    n = ag.n_nodes
    lg = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32)).to(cuda_dev)
    lg[::37] = -float("inf")
    mx, sm = att.softmax_stats_plain(ag.row_ptr, lg)
    x = torch.randn((n, f), device=cuda_dev).to(torch.bfloat16)
    g = torch.randn((n, f), device=cuda_dev).to(torch.bfloat16)
    n0, n1 = att.attn_agg.launches, att.sddmm.launches
    out = att.attn_agg(ag.row_ptr, ag.col, lg, mx, sm, x)
    u = att.sddmm(ag.row_ptr, ag.col, g, x, ag.row)
    torch.cuda.synchronize()
    assert (att.attn_agg.launches, att.sddmm.launches) == (n0 + 1, n1 + 1)
    # f32 weights times bf16 features, and exact bf16 products, summed in
    # f32 in another order
    torch.testing.assert_close(
        out, att.attn_agg_plain(ag.row_ptr, ag.col, lg, mx, sm, x), rtol=1e-5, atol=1e-5
    )
    torch.testing.assert_close(u, att.sddmm_plain(ag.row_ptr, ag.col, g, x), rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="multiple of"):
        att.sddmm(ag.row_ptr, ag.col, g[:, :6].contiguous(), x[:, :6].contiguous(), ag.row)
    with pytest.raises(TypeError, match="bfloat16"):
        att.attn_agg(ag.row_ptr, ag.col, lg, mx, sm, x.float())


@pytest.mark.cuda
def test_rowsum_kernel_matches_plain_on_both_csrs(cuda_dev):
    ag, rng = _attention_graph(cuda_dev, seed=5)
    v = torch.from_numpy(rng.randn(ag.n_edges).astype(np.float32)).to(cuda_dev)
    n0 = att.rowsum.launches
    for ptr, vals in ((ag.row_ptr, v), (ag.row_ptr_t, v[ag.perm_t.long()])):
        # f32 sums in another order
        torch.testing.assert_close(
            att.rowsum(ptr, vals), att.rowsum_plain(ptr, vals), rtol=1e-5, atol=1e-5
        )
    assert att.rowsum.launches == n0 + 2


@pytest.mark.cuda
def test_gat_attention_on_gpu_matches_cpu_plain(cuda_dev):
    """The op and its three gradients through the kernels (and K2 for dx)
    equal the same op through the plain versions on the CPU."""
    ag_c, rng = _attention_graph(CPU, seed=6)
    ag_g, _ = _attention_graph(cuda_dev, seed=6)
    n = ag_c.n_nodes
    ins = [rng.randn(n), rng.randn(n), rng.randn(n, 200)]
    cot = torch.from_numpy(rng.randn(n, 200).astype(np.float32))
    grads = []
    for ag, dev in ((ag_c, CPU), (ag_g, cuda_dev)):
        ts = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True) for a in ins]
        out = att.gat_attention(ag, *ts, 0.2)
        out.backward(cot.to(dev))
        grads.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [0, 3])
def test_mesh_gat_attention_rank_on_gpu_matches_cpu_plain(cuda_dev, shard):
    """Route B.3: one rank's rectangular attention graph (its rows against
    all ``n_pad`` columns, ``MeshAttentionAllGather``; rank 0 holds the hub
    rows, split at S) through ``gat_attention`` on the kernels: the output
    and the gradients of es, ed and the all-gathered features (dx and ded
    over all columns) equal the plain versions on the CPU (rtol and atol
    1e-4: f32 sums in another order)."""
    from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather

    r, c, v, n = _graph()
    res = []
    for dev in (CPU, cuda_dev):
        mg = MeshAttentionAllGather.from_coo(r, c, v, n, 4, shard, device=dev)
        rng = np.random.RandomState(3)
        ins = [rng.randn(mg.rows_per_shard), rng.randn(mg.n_pad), rng.randn(mg.n_pad, 200)]
        cot = torch.tensor(rng.randn(mg.rows_per_shard, 200), dtype=torch.float32, device=dev)
        ts = [torch.tensor(a, dtype=torch.float32, device=dev, requires_grad=True) for a in ins]
        out = att.gat_attention(mg.ag, *ts, 0.2)
        out.backward(cot)
        res.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    if shard == 0:
        assert mg.ag.split is not None
    for a, b in zip(*res):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


def _lattice_chunks(dev, seed=0):
    from textgcn_tpu_torch.ops.streamed_sorted import make_lattice_stream

    # two blocks of 4 windows of 32 rows, degree 50: one cross pair
    return make_lattice_stream(4, 4, 32, 400, seed=seed, device=dev)


def test_sorted_chunk_add_plain_matches_numpy():
    from textgcn_tpu_torch.ops.streamed_sorted import sorted_chunk_add

    lat = _lattice_chunks(CPU)
    ch = lat.chunk(1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(lat.n_rows, 16).astype(np.float32)).bfloat16()
    base = rng.randn(lat.n_rows, 16).astype(np.float32)
    want = base.astype(np.float64)
    rows = ch.r0 + np.repeat(np.arange(ch.rows), np.diff(ch.row_ptr.numpy()))
    np.add.at(want, rows, ch.val.numpy()[:, None] * x.float().numpy()[ch.col.numpy()])
    got = sorted_chunk_add(torch.from_numpy(base.copy()), ch, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 8])
def test_sorted_chunk_add_kernel_matches_plain(cuda_dev, f):
    """B11: K2 onto one row-sorted chunk's row range of an accumulator."""
    from textgcn_tpu_torch.ops.streamed_sorted import sorted_chunk_add

    lat = _lattice_chunks(cuda_dev, seed=1)
    ch = lat.chunk(2)
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    x = torch.randn((lat.n_rows, f), generator=gen, device=cuda_dev).bfloat16()
    base = torch.randn((lat.n_rows, f), generator=gen, device=cuda_dev)
    n0 = row_reduce.launches
    got = sorted_chunk_add(base.clone(), ch, x)
    torch.cuda.synchronize()
    assert row_reduce.launches == n0 + 1
    want = sorted_chunk_add(base.clone(), ch, x, reduce=row_reduce_plain)
    # f32 sums of 50 products per row in another order
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    outside = torch.ones(lat.n_rows, dtype=torch.bool, device=cuda_dev)
    outside[ch.r0 : ch.r0 + ch.rows] = False
    assert torch.equal(got[outside], base[outside])


@pytest.mark.cuda
def test_lattice_pass_and_its_vjp_on_gpu_match_plain(cuda_dev):
    from textgcn_tpu_torch.ops import streamed_sorted as ss

    lat = _lattice_chunks(cuda_dev, seed=2)
    gen = torch.Generator(device=cuda_dev).manual_seed(1)
    x = torch.randn((lat.n_rows, 16), generator=gen, device=cuda_dev).bfloat16()
    n0 = row_reduce.launches
    got = ss.spmm_streamed_sorted(lat, x)
    assert row_reduce.launches == n0 + len(lat)
    torch.testing.assert_close(
        got, ss.spmm_streamed_sorted(lat, x, reduce=row_reduce_plain), rtol=1e-5, atol=1e-5
    )
    xg = x.clone().requires_grad_(True)
    g = torch.randn((lat.n_rows, 16), generator=gen, device=cuda_dev)
    ss.spmm_streamed_sorted_sym(lat, xg).backward(g)
    # symmetric Â: the VJP is the same pass on the cotangent, cast to bf16
    assert xg.grad.dtype == torch.bfloat16
    torch.testing.assert_close(
        xg.grad, ss.spmm_streamed_sorted(lat, g.bfloat16()).bfloat16(), rtol=0, atol=0
    )


@pytest.mark.cuda
def test_hostfed_pass_with_lookahead_matches_resident(cuda_dev):
    from textgcn_tpu_torch.ops import streamed_sorted as ss

    lat = _lattice_chunks(CPU, seed=3)
    host = [c.pin_memory() for c in lat]
    dev_chunks = [c.to(cuda_dev) for c in host]
    x = torch.randn((lat.n_rows, 24), device=cuda_dev).bfloat16()
    resident = ss.spmm_streamed_sorted(dev_chunks, x)
    n0 = row_reduce.launches
    for _ in range(3):
        got = ss.spmm_streamed_sorted_hostfed(host, x)
        # the same kernel on the same chunks: bit-equal
        assert torch.equal(got, resident)
    assert row_reduce.launches == n0 + 3 * len(host)
    # a source with some chunks cached on the device and the rest on the host
    src = ss.CachedChunkSource(lambda i: host[i], len(host), host[0].nbytes, cuda_dev)
    assert torch.equal(ss.spmm_streamed_sorted_hostfed(src, x), resident)
    assert torch.equal(ss.spmm_streamed_sorted_hostfed(src, x), resident)
    assert src.host_loads == 1 + 2 * (len(host) - 1)


@pytest.mark.cuda
def test_streamed_step_beyond_the_device_cache_matches_resident(cuda_dev):
    """The streamed GCN step through a CachedChunkSource whose budget holds
    one chunk of four: the others are copied in from pinned host chunks on
    every pass, and loss and gradients equal the step on resident chunks."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss
    from textgcn_tpu_torch.train import streamed as st

    lat = _lattice_chunks(CPU, seed=4)
    host = [c.pin_memory() for c in lat]
    n, f, h, c = lat.n_rows, 24, 16, 8
    gen = torch.Generator(device=cuda_dev).manual_seed(2)
    x = torch.randn((n, f), generator=gen, device=cuda_dev).bfloat16()
    y = torch.randint(0, c, (n,), generator=gen, device=cuda_dev)
    mask = (torch.rand(n, generator=gen, device=cuda_dev) < 0.5).float()
    src = ss.CachedChunkSource(host.__getitem__, len(host), host[0].nbytes, cuda_dev)
    res = []
    for chunks in ([ch.to(cuda_dev) for ch in host], src):
        params, _ = st.init_streamed(
            torch.Generator(device=cuda_dev).manual_seed(3), f, h, c, device=cuda_dev
        )
        opt = torch.optim.SGD(params.values(), lr=0.0)
        step = st.make_streamed_train_step_segmented(st.make_sorted_stream(chunks), n, opt)
        n0 = row_reduce.launches
        loss = float(step(params, x, y, mask))
        assert row_reduce.launches == n0 + 4 * len(host)
        res.append((loss, {k: p.grad for k, p in params.items()}))
    (loss_r, grads_r), (loss_c, grads_c) = res
    # the same kernel over the same chunks in the same order
    assert loss_c == loss_r
    for k in grads_r:
        assert torch.equal(grads_c[k], grads_r[k]), k
    assert src.cached_bytes == host[0].nbytes
    assert src.host_loads == len(host) + 3 * (len(host) - 1)


def _on(chunks, dev):
    return [c.to(dev) for c in chunks]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [2, 8, 16, 64, 200])
def test_row_reduce_run_kernel_equals_the_per_chunk_calls(cuda_dev, f):
    """K2's run entry against ``sorted_chunk_add`` a chunk, bit-equal: the
    runs of ``tests/torch_stream_chunks.py`` (empty rows; broken by a host
    chunk, a split chunk and an overlap) with the two other chunks' calls
    between them, then one run of every disjoint chunk without a split
    table; one launch a run; against the plain version."""
    from textgcn_tpu_torch.ops.row_reduce import reduce_run, row_reduce_run
    from textgcn_tpu_torch.ops.streamed_sorted import sorted_chunk_add
    from torch_stream_chunks import N_ROWS, PLAN, SPLIT, broken_runs

    chunks = _on(broken_runs(seed=5)[0], cuda_dev)
    gen = torch.Generator(device=cuda_dev).manual_seed(6)
    x = torch.randn((N_ROWS, f), generator=gen, device=cuda_dev).bfloat16()
    base = torch.randn((N_ROWS, f), generator=gen, device=cuda_dev)

    def csrs(ks):
        return [(chunks[k].row_ptr, chunks[k].col, chunks[k].val, chunks[k].r0) for k in ks]

    want, got = base.clone(), base.clone()
    for p in PLAN:
        for k in p if isinstance(p, tuple) else (p,):
            sorted_chunk_add(want, chunks[k], x)
    n0, b0 = row_reduce.launches, row_reduce.batched_chunks
    for p in PLAN:
        if isinstance(p, tuple):
            row_reduce_run(reduce_run(csrs(p)), x, got)
        else:
            sorted_chunk_add(got, chunks[p], x)
    torch.cuda.synchronize()
    assert row_reduce.launches - n0 == len(PLAN)
    assert row_reduce.batched_chunks - b0 == sum(len(p) for p in PLAN if isinstance(p, tuple))
    assert torch.equal(got, want)

    disjoint = [0, 1, 2, 3, 5, 7]
    run = reduce_run(csrs(disjoint))
    got = row_reduce_run(run, x, base.clone())
    want = base.clone()
    for k in disjoint:
        sorted_chunk_add(want, chunks[k], x)
    assert torch.equal(got, want)
    # f32 sums of up to ~30 products a row in another order
    torch.testing.assert_close(got, row_reduce_run_plain(run, x, base.clone()),
                               rtol=1e-5, atol=1e-5)
    assert chunks[SPLIT].split is not None
    with pytest.raises(TypeError, match="bf16"):
        row_reduce_run(run, x.float(), base.clone())
    with pytest.raises(ValueError, match="base must be"):
        row_reduce_run(run, x, base[: run.r_end - 1].clone())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 200])
def test_streamed_pass_over_runs_equals_the_per_chunk_pass(cuda_dev, f):
    """A CachedChunkSource over pinned host chunks that keeps all but one:
    once the first pass has filled the cache, a pass launches K2 once a run
    and once a chunk between runs (the host chunk, copied one ahead, and
    the split chunk), and equals the per-chunk pass over the same chunks
    bit for bit."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss
    from torch_stream_chunks import N_ROWS, PLAN, broken_runs

    chunks, budget = broken_runs(seed=7)
    host = [c.pin_memory() for c in chunks]
    x = torch.randn((N_ROWS, f), device=cuda_dev).bfloat16()
    want = ss.spmm_streamed_sorted_hostfed(host, x)
    src = ss.CachedChunkSource(host.__getitem__, len(host), budget, cuda_dev)
    assert torch.equal(ss.spmm_streamed_sorted_hostfed(src, x), want)
    for _ in range(2):
        n0, b0 = row_reduce.launches, row_reduce.batched_chunks
        assert torch.equal(ss.spmm_streamed_sorted_hostfed(src, x), want)
        assert row_reduce.launches - n0 == len(PLAN)
        assert row_reduce.batched_chunks - b0 == 6
    assert src.host_loads == len(host) + 2


@pytest.mark.cuda
def test_streamed_step_over_runs_equals_the_per_chunk_step(cuda_dev):
    """Three Adam steps of the streamed GCN over a CachedChunkSource that
    keeps half the lattice's chunks (one run, the rest copied from pinned
    host memory) give the losses and parameters of the per-chunk steps
    over the same chunks on the card, bit for bit; K2 launches once a
    chunk in the first pass, then once for the run and once a host chunk."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss
    from textgcn_tpu_torch.train import streamed as st

    lat = _lattice_chunks(CPU, seed=8)
    host = [c.pin_memory() for c in lat]
    kept = 2
    n, f, h, c = lat.n_rows, 24, 16, 8
    gen = torch.Generator(device=cuda_dev).manual_seed(9)
    x = torch.randn((n, f), generator=gen, device=cuda_dev).bfloat16()
    y = torch.randint(0, c, (n,), generator=gen, device=cuda_dev)
    mask = (torch.rand(n, generator=gen, device=cuda_dev) < 0.5).float()
    src = ss.CachedChunkSource(host.__getitem__, len(host),
                               sum(ch.nbytes for ch in host[:kept]), cuda_dev)
    res = []
    for chunks in (_on(host, cuda_dev), src):
        params, opt = st.init_streamed(
            torch.Generator(device=cuda_dev).manual_seed(10), f, h, c, device=cuda_dev, lr=0.01
        )
        step = st.make_streamed_train_step_segmented(st.make_sorted_stream(chunks), n, opt)
        n0 = row_reduce.launches
        losses = [float(step(params, x, y, mask)) for _ in range(3)]
        res.append((losses, params, row_reduce.launches - n0))
    (loss_c, params_c, launches_c), (loss_r, params_r, launches_r) = res
    assert loss_r == loss_c
    for k in params_c:
        assert torch.equal(params_r[k], params_c[k]), k
    copies = len(host) - kept
    assert launches_c == 12 * len(host)
    assert launches_r == len(host) + 11 * (1 + copies)


def _tile_case(case, rng):
    """The chunks of a run that reaches one of the tiled run kernel's
    edges: ``(degrees a chunk, gap in rows before each chunk)``."""
    T = RUN_TILE_ROWS
    if case == "long_row":  # a row past a stage's 4,096 edges, no split table
        deg = rng.integers(0, 40, 3 * T)
        deg[T + 5], deg[T + 6] = 10_000, 4_100
        return [deg], [0]
    if case == "empty_ends":  # empty rows at both ends of every tile
        deg = rng.integers(1, 60, 4 * T)
        for t in range(4):
            deg[t * T : t * T + 5] = 0
            deg[t * T + T - 7 : t * T + T] = 0
        deg[2 * T : 3 * T] = 0  # and a tile without edges
        return [deg], [0]
    if case == "unaligned":  # odd edge counts, windows off 16 bytes
        return [2 * rng.integers(0, 20, r) + 1 for r in (T + 3, 1, 2 * T - 1, 5)], [0, 1, 2, 0]
    if case == "many":  # more chunks and tiles than the grid has blocks
        return [rng.integers(0, 30, int(r)) for r in rng.integers(1, 3 * T, 300)], [0] * 300
    assert case == "one_row"
    return [np.array([7])], [3]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [6, 8, 16, 64])
@pytest.mark.parametrize("case", ["long_row", "empty_ends", "unaligned", "many", "one_row"])
def test_row_reduce_run_tiles_equal_the_per_chunk_calls(cuda_dev, case, f):
    """The tiled run kernel at its edges, bit-equal to ``row_reduce`` a
    chunk with no split table, and ``row_reduce.run_tiles`` counting the
    tiles of RUN_TILE_ROWS rows it walked. In the ``unaligned`` case the
    CSRs are views one entry into larger tensors, so neither row_ptr, col
    nor val starts on 16 bytes; f = 6 takes the 4-byte loads."""
    from textgcn_tpu_torch.ops.row_reduce import reduce_run, row_reduce_run

    rng = np.random.default_rng(11)
    degs, gaps = _tile_case(case, rng)
    csrs, r0 = [], 0
    for deg, gap in zip(degs, gaps):
        r0 += gap
        rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
        col = rng.integers(0, 1000, rp[-1]).astype(np.int32)
        val = rng.random(rp[-1]).astype(np.float32)
        off = int(case == "unaligned")
        t = [torch.from_numpy(np.concatenate([np.zeros(off, a.dtype), a])).to(cuda_dev)[off:]
             for a in (rp, col, val)]
        csrs.append((*t, r0))
        r0 += len(deg)
    gen = torch.Generator(device=cuda_dev).manual_seed(12)
    x = torch.randn((1000, f), generator=gen, device=cuda_dev).bfloat16()
    base = torch.randn((r0, f), generator=gen, device=cuda_dev)
    want = base.clone()
    for rp, col, val, r in csrs:
        row_reduce(rp, col, val, x, base=want[r : r + rp.numel() - 1])
    run = reduce_run(csrs)
    tiles = sum(-(-len(d) // RUN_TILE_ROWS) for d in degs)
    n0, t0 = row_reduce.launches, row_reduce.run_tiles
    got = row_reduce_run(run, x, base.clone())
    torch.cuda.synchronize()
    assert row_reduce.launches - n0 == 1
    assert run.n_tiles == tiles and row_reduce.run_tiles - t0 == tiles
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_learnable_edge_ops_on_gpu_match_cpu_plain(cuda_dev):
    """``edge_logit_base`` and ``spmm_onehot_ew`` forward and backward on
    the kernels (``rowsum`` over both CSRs, K2 from zero forward and as dx,
    ``sddmm`` for dval) against the same ops on CPU tensors (the plain
    versions), on the degree-sorted attention graph: f32 sums in another
    order, 1e-4 relative to each output's largest entry; two GPU runs
    bit-equal."""
    ag_cpu, rng = _attention_graph(CPU, seed=9)
    ag = ag_cpu.to(cuda_dev)
    n, e = ag.n_nodes, ag.n_edges
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    g_e = rng.randn(e).astype(np.float32)
    val = np.exp(ag_cpu.logval.numpy() + 0.1 * rng.randn(e)).astype(np.float32)
    x, cot = rng.randn(n, 40).astype(np.float32), rng.randn(n, 40).astype(np.float32)

    def run(graph, dev):
        t = [torch.from_numpy(a).to(dev).requires_grad_(True) for a in (es, ed, val, x)]
        base = att.edge_logit_base(graph, t[0], t[1])
        base.backward(torch.from_numpy(g_e).to(dev))
        out = att.spmm_onehot_ew(graph, t[2], t[3])
        out.backward(torch.from_numpy(cot).to(dev))
        return [base.detach(), out.detach()] + [a.grad for a in t]

    launches = (att.rowsum.launches, row_reduce.launches, att.sddmm.launches)
    got = run(ag, cuda_dev)
    assert (att.rowsum.launches, row_reduce.launches, att.sddmm.launches) == (
        launches[0] + 2, launches[1] + 2, launches[2] + 1
    )
    assert all(map(torch.equal, got, run(ag, cuda_dev)))
    for a, b in zip(got, run(ag_cpu, CPU)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# the one call path of the hand kernels (ops/_build.py check / launch,
# ops/split.py split_args)
# ---------------------------------------------------------------------------

CUDA0 = torch.device("cuda", 0)  # a device object only: nothing runs on it here


def _meta_call(wrapper):
    """A call of public wrapper ``wrapper`` with every tensor on the meta
    device, which has neither a plain path nor a kernel."""
    from textgcn_tpu_torch.ops.row_reduce import reduce_run, row_reduce_run

    m = torch.device("meta")
    i = torch.zeros(3, dtype=torch.int32, device=m)
    v = torch.zeros(2, device=m)
    x = torch.zeros(2, 8, dtype=torch.bfloat16, device=m)
    tiles, x128 = torch.empty((1, 128, 128), device=m), torch.empty((128, 16), device=m)
    k1 = (tiles, i[:2], i[:1], x128)
    return {
        "row_reduce": lambda: row_reduce(i, i[:2], v, x),
        "row_reduce_run": lambda: row_reduce_run(
            reduce_run([(i, i[:2], v, 0)]), x, torch.zeros(2, 8, device=m)),
        "bsr_spmm": lambda: bsr_spmm(*k1),
        "bsr_spmm_f32": lambda: bsr_spmm_f32(*k1),
        "bsr_leg": lambda: bsr_leg(*k1),
        "stats_logits": lambda: att.stats_logits(i, i[:2], v, v, v, 0.2),
        "softmax_stats": lambda: att.softmax_stats(i, v),
        "attn_agg": lambda: att.attn_agg(i, i[:2], v, v, v, x),
        "sddmm": lambda: att.sddmm(i, i[:2], x, x, i[:2]),
        "rowsum": lambda: att.rowsum(i, v),
    }[wrapper]


WRAPPERS = ["row_reduce", "row_reduce_run", "bsr_spmm", "bsr_spmm_f32", "bsr_leg",
            "stats_logits", "softmax_stats", "attn_agg", "sddmm", "rowsum"]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_wrappers_raise_off_cpu_and_cuda(wrapper):
    """A tensor on neither the CPU nor a CUDA device reaches no plain path:
    every public wrapper of a hand kernel refuses it, naming itself."""
    with pytest.raises(ValueError, match=f"{wrapper}: no kernel for device meta"):
        _meta_call(wrapper)()


def _fake(device=CUDA0, contiguous=True, dtype=torch.int32):
    """A stand-in for a tensor on a CUDA device, as far as the checker looks."""
    from types import SimpleNamespace

    return SimpleNamespace(device=device, is_contiguous=lambda: contiguous, dtype=dtype)


@pytest.mark.parametrize("case, named, error, match", [
    ("no kernel", (), ValueError, "k: no kernel for device meta"),
    ("device", (("t", torch.zeros(2, dtype=torch.int32), torch.int32),), ValueError,
     "k: t is on cpu, expected cuda:0"),
    ("layout", (("t", _fake(contiguous=False), torch.int32),), ValueError,
     "k: t must be contiguous"),
    ("dtype", (("a", _fake(), torch.int32), ("t", _fake(dtype=torch.float64), torch.int32)),
     TypeError, r"k: t must be torch.int32, got torch.float64"),
    ("passes", (("t", _fake(), torch.int32), ("any dtype", _fake(dtype=torch.float64), None),
                ("absent", None, torch.float32)), None, None),
])
def test_the_checker_refuses_device_layout_and_dtype(case, named, error, match):
    device = torch.device("meta") if case == "no kernel" else CUDA0
    if error is None:
        _build.check("k", device, *named)
        return
    with pytest.raises(error, match=match):
        _build.check("k", device, *named)


def test_split_args_without_a_table_pass_nothing():
    from textgcn_tpu_torch.ops.split import split_args

    assert split_args("row_reduce", None, CUDA0, 16) == (None, None, 0, 0)


@pytest.mark.parametrize("where", ["meta", "cpu"])
def test_split_args_refuse_a_table_on_another_device(where):
    """A table on another device than the wrapper's tensors is refused,
    naming the wrapper, before any partial is allocated."""
    from textgcn_tpu_torch.ops.split import split_args

    split = row_split(np.array([0, SEGMENT_EDGES + 1, SEGMENT_EDGES + 3]), device=where)
    assert split is not None and split.table.device.type == where
    with pytest.raises(ValueError, match=f"attn_agg: split is on {where}, expected cuda:0"):
        split_args("attn_agg", split, CUDA0, 8)


class _Entry:
    """A C entry point that records its arguments and returns ``err``."""

    def __init__(self, err):
        self.err, self.args = err, None

    def __call__(self, *args):
        self.args = args
        return self.err


@pytest.mark.parametrize("err, spans_on", [(0, False), (0, True), (700, False)])
def test_launch_passes_addresses_counts_once_and_closes_the_span(monkeypatch, err, spans_on):
    """``_build.launch`` with the library, the device guard and the stream
    stood in for: tensors go as their addresses and everything else as it
    is, the current stream last; the wrapper's counter rises by one, also
    when the launch fails (then it raises naming the wrapper); the span is
    recorded only while the recorder is on and the wrapper took a start."""
    import contextlib
    import time
    from types import SimpleNamespace

    from textgcn_tpu_torch.utils import profiling

    entry = _Entry(err)
    monkeypatch.setattr(_build, "load", lambda: SimpleNamespace(textgcn_k=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=77))

    def wrapper():
        pass

    wrapper.launches = 5
    t = torch.zeros(4)
    profiling.record_spans(spans_on)
    try:
        t0 = profiling.spans_on and time.time_ns()
        with (pytest.raises(RuntimeError, match="wrapper_name: CUDA launch failed with "
                            "cudaError 700") if err else contextlib.nullcontext()):
            _build.launch("wrapper_name", wrapper, "textgcn_k", CUDA0, t, None, 3, 0.5,
                          span="k9.launch", t0=t0)
    finally:
        spans = profiling.record_spans(False)
    assert entry.args == (t.data_ptr(), None, 3, 0.5, 77)
    assert wrapper.launches == 6
    assert [s.name for s in spans] == (["k9.launch"] if spans_on and not err else [])


def _counters():
    """Every launch counter of the hand kernels' wrappers."""
    return {
        "row_reduce": row_reduce.launches, "batched_chunks": row_reduce.batched_chunks,
        "run_tiles": row_reduce.run_tiles, "bsr_spmm": bsr_spmm.launches,
        "bsr_spmm_f32": bsr_spmm_f32.launches, "bsr_leg": bsr_leg.launches,
        **{k: getattr(att, k).launches
           for k in ("stats_logits", "softmax_stats", "attn_agg", "sddmm", "rowsum")},
    }


def _site(site, dev):
    """``(call, the counters it moves and by how much, its spans' names)``
    for one launch of ``site`` on ``dev``, with split tables where the
    wrapper takes one (inputs built before the call)."""
    from textgcn_tpu_torch.ops.row_reduce import reduce_run, row_reduce_run

    rp, col, val, x, _ = _long_rows(dev, 16)
    split, n = row_split(rp), rp.numel() - 1
    tiles, tp, cols, xt = _long_block_rows(dev, 16)
    tsplit = tile_split(tp)
    gen = torch.Generator(device=dev).manual_seed(0)
    es, ed = torch.randn(n, generator=gen, device=dev), torch.randn(2000, generator=gen, device=dev)
    logits = torch.randn(col.numel(), generator=gen, device=dev)
    mx, sm = att.softmax_stats_plain(rp, logits)
    row = torch.repeat_interleave(torch.arange(n, device=dev), torch.diff(rp.long())).int()
    run = reduce_run([(rp, col, val, 0), (rp, col, val, n)])
    k2, k1 = ["k2.launch"], ["k1.launch"]
    return {
        "row_reduce": (lambda: row_reduce(rp, col, val, x, split=split), {"row_reduce": 1}, k2),
        "row_reduce_run": (lambda: row_reduce_run(run, x, torch.zeros(2 * n, 16, device=dev)),
                           {"row_reduce": 1, "batched_chunks": 2, "run_tiles": run.n_tiles}, k2),
        "bsr_spmm": (lambda: bsr_spmm(tiles, tp, cols, xt, split=tsplit), {"bsr_spmm": 1}, k1),
        "bsr_spmm (f32 tiles)": (lambda: bsr_spmm(tiles.float(), tp, cols, xt.float(), tsplit),
                                 {"bsr_spmm_f32": 1}, k1),
        "bsr_spmm_f32": (lambda: bsr_spmm_f32(tiles.float(), tp, cols, xt.float(), tsplit),
                         {"bsr_spmm_f32": 1}, k1),
        "bsr_leg": (lambda: bsr_leg(tiles, tp, cols, xt, split=tsplit), {"bsr_leg": 1}, k1),
        "stats_logits": (lambda: att.stats_logits(rp, col, logits, es, ed, 0.2, split=split),
                         {"stats_logits": 1}, []),
        "softmax_stats": (lambda: att.softmax_stats(rp, logits, split=split),
                          {"softmax_stats": 1}, []),
        "attn_agg": (lambda: att.attn_agg(rp, col, logits, mx, sm, x, split=split),
                     {"attn_agg": 1}, []),
        "sddmm": (lambda: att.sddmm(rp, col, x[:n].contiguous(), x, row), {"sddmm": 1}, []),
        "rowsum": (lambda: att.rowsum(rp, logits, split=split), {"rowsum": 1}, []),
    }[site]


@pytest.mark.cuda
@pytest.mark.parametrize("site", [
    "row_reduce", "row_reduce_run", "bsr_spmm", "bsr_spmm (f32 tiles)", "bsr_spmm_f32",
    "bsr_leg", "stats_logits", "softmax_stats", "attn_agg", "sddmm", "rowsum",
])
def test_a_launch_raises_its_own_counter_by_one(cuda_dev, site):
    """One call of each launch site (K1's through each of its wrappers and
    dtypes) raises its own counter by exactly one and no other counter (a
    run launch also its chunks and tiles), and records its span: K2's
    ``k2.launch``, K1's ``k1.launch``, the attention kernels none."""
    from textgcn_tpu_torch.utils import profiling

    call, moved, names = _site(site, cuda_dev)
    call()  # the first call builds and loads the library
    torch.cuda.synchronize()
    before = _counters()
    profiling.record_spans(True)
    try:
        call()
        torch.cuda.synchronize()
    finally:
        spans = profiling.record_spans(False)
    after = _counters()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == moved
    assert [s.name for s in spans] == names
