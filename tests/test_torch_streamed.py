"""The port's sorted edge stream and streamed GCN training
(``textgcn_tpu_torch/ops/streamed_sorted.py``, ``train/streamtape.py``,
``train/streamed.py``) against the JAX package on the CPU, where K2's
wrapper runs its plain version. Pallas runs in interpret mode, as in
``tests/test_streamed_sorted.py``. The JAX plan-layout chunks are converted
to the port's CSR chunks through their COO (the layouts differ)."""
import os
import sys

import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import textgcn_tpu.models as jax_models
from textgcn_tpu.ops import streamed_sorted as jss
from textgcn_tpu.train import streamed as jst

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph.format import convert_graph
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.models.gcn import params_from_jax
from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.ops.spmm import spmm
from textgcn_tpu_torch.train import streamed as st
from textgcn_tpu_torch.train.streamtape import StreamTape

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "benchmarks"))
from synthetic_large import lattice_config as j_lattice_config  # noqa: E402

N_CHUNKS, W_SC, W, CELL_E, K = 5, 2, 8, 64, 128
G = W_SC * W
N_PAD = N_CHUNKS * G


def _jax_lattice():
    edge_fn, spec = jss.make_lattice_edge_fn(N_CHUNKS, W_SC, W, CELL_E, K, seed=3)
    return edge_fn, spec


def _port_chunks_of_jax_lattice():
    edge_fn, spec = _jax_lattice()
    r, c, v = jss.lattice_to_coo(edge_fn, N_CHUNKS, spec)
    # every G-row block holds exactly chunk_edges edges, so the edge-count
    # cut falls on the JAX chunks' row ranges
    chunks = ss.SortedStreamGraph.from_coo(r, c, v, N_PAD, max_chunk_edges=spec.chunk_edges).chunks
    return edge_fn, spec, chunks, (r, c, v)


def _matrix(r, c, v, n):
    return sp.coo_matrix((v.astype(np.float64), (r, c)), shape=(n, n)).tocsr()


def test_jax_lattice_converts_to_row_range_chunks():
    _, spec, chunks, (r, _, _) = _port_chunks_of_jax_lattice()
    assert len(chunks) == N_CHUNKS and spec.rows_per_chunk == G
    for j, ch in enumerate(chunks):
        assert ch.r0 == j * G and ch.rows == G
        assert ch.n_edges == spec.chunk_edges == int(((r >= j * G) & (r < (j + 1) * G)).sum())


def test_sorted_stream_matches_jax_f32():
    edge_fn, spec, chunks, _ = _port_chunks_of_jax_lattice()
    x = np.random.default_rng(0).normal(size=(N_PAD, 10)).astype(np.float32)
    want = jss.spmm_streamed_sorted(edge_fn, jnp.asarray(x), N_CHUNKS, spec, interpret=True)
    got = ss.spmm_streamed_sorted(chunks, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_sorted_stream_matches_jax_bf16():
    """bf16 features: JAX rounds each edge weight and each product to bf16
    before the f32 sum, the port multiplies in f32. Each term may differ by
    2^-8 of its size, so the bound is 2^-8 * (|A| @ |x|) per entry."""
    edge_fn, spec, chunks, (r, c, v) = _port_chunks_of_jax_lattice()
    x = jnp.asarray(np.random.default_rng(1).normal(size=(N_PAD, 12)), jnp.bfloat16)
    xt = torch.tensor(np.asarray(x.astype(jnp.float32))).bfloat16()
    want = np.asarray(jss.spmm_streamed_sorted(edge_fn, x, N_CHUNKS, spec, interpret=True))
    got = ss.spmm_streamed_sorted(chunks, xt).numpy()
    bound = 2.0**-8 * (abs(_matrix(r, c, v, N_PAD)) @ np.abs(xt.float().numpy()))
    assert (np.abs(got - want) <= bound + 1e-6).all()
    assert np.abs(got - want).max() > 0  # the roundings do differ


@pytest.mark.parametrize("j", [0, 3])
def test_sorted_chunk_add_matches_jax_chunk(j):
    """B11 on one chunk with a random base (JAX's x padded to 128 lanes, as
    its caller pads it)."""
    edge_fn, spec, chunks, _ = _port_chunks_of_jax_lattice()
    rng = np.random.default_rng(2 + j)
    f = 6
    x = rng.normal(size=(N_PAD, f)).astype(np.float32)
    base = rng.normal(size=(N_PAD, f)).astype(np.float32)
    xp = np.zeros((N_PAD, 128), np.float32)
    xp[:, :f] = x
    accp = np.zeros((N_PAD, 128), np.float32)
    accp[:, :f] = base
    want = jss._sorted_chunk_add(
        jnp.asarray(accp), edge_fn(jnp.asarray(j, jnp.int32)), jnp.asarray(xp), spec, True
    )
    acc = torch.from_numpy(base.copy())
    out = ss.sorted_chunk_add(acc, chunks[j], torch.from_numpy(x))
    assert out is acc  # in place
    np.testing.assert_allclose(acc.numpy(), np.asarray(want)[:, :f], rtol=2e-5, atol=2e-5)
    # rows outside the chunk's range keep the base exactly
    outside = np.ones(N_PAD, bool)
    outside[j * G : (j + 1) * G] = False
    assert np.array_equal(acc.numpy()[outside], base[outside])


def test_sorted_chunk_add_rejects_a_range_outside_the_accumulator():
    _, _, chunks, _ = _port_chunks_of_jax_lattice()
    with pytest.raises(ValueError, match="outside"):
        ss.sorted_chunk_add(torch.zeros(G, 4), chunks[1], torch.zeros(N_PAD, 4))


def test_sym_vjp_matches_jax_grad():
    edge_fn, spec, chunks, _ = _port_chunks_of_jax_lattice()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(N_PAD, 6)).astype(np.float32)
    t = rng.normal(size=(N_PAD, 6)).astype(np.float32)
    want = jax.grad(
        lambda xx: jnp.sum(jss.spmm_streamed_sorted_sym(edge_fn, xx, N_CHUNKS, spec, True) * t)
    )(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (ss.spmm_streamed_sorted_sym(chunks, xt) * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_odd_width_pads_one_column():
    _, _, chunks, (r, c, v) = _port_chunks_of_jax_lattice()
    x = torch.randn(N_PAD, 7, generator=torch.Generator().manual_seed(0))
    got = ss.spmm_streamed_sorted(chunks, x)
    assert got.shape == (N_PAD, 7)
    np.testing.assert_allclose(got.numpy(), _matrix(r, c, v, N_PAD) @ x.numpy(), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# The port's own lattice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_chunks,w_sc,w,cell_e", [(5, 2, 8, 64), (4, 4, 16, 24)])
def test_port_lattice_is_symmetric_sorted_and_sized(n_chunks, w_sc, w, cell_e):
    lat = ss.make_lattice_stream(n_chunks, w_sc, w, cell_e, seed=7, device="cpu")
    g_rows = w_sc * w
    assert lat.n_rows == n_chunks * g_rows
    assert lat.n_edges == n_chunks * w_sc * w_sc * cell_e
    assert lat.degree == w_sc * cell_e / w
    chunks = list(lat)
    for j, ch in enumerate(chunks):
        rp = ch.row_ptr.numpy()
        assert ch.r0 == j * g_rows and ch.rows == g_rows
        assert rp[0] == 0 and rp[-1] == ch.n_edges == w_sc * w_sc * cell_e
        assert (np.diff(rp) >= 0).all()
        # columns lie in the partner block
        p = int(lat.partner[j])
        assert ((ch.col >= p * g_rows) & (ch.col < (p + 1) * g_rows)).all()
    r, c, v = ss.lattice_to_coo(chunks)
    assert len(r) == lat.n_edges
    # exactly symmetric: the edge multiset equals its transpose
    fwd = sorted(zip(r.tolist(), c.tolist(), v.tolist()))
    rev = sorted(zip(c.tolist(), r.tolist(), v.tolist()))
    assert fwd == rev
    # every w-row window holds exactly w * degree edges
    per_window = np.bincount(r, minlength=lat.n_rows).reshape(-1, w).sum(1)
    assert (per_window == w * lat.degree).all()
    # regenerating a chunk draws the same edges
    again = lat.chunk(n_chunks - 1)
    assert torch.equal(again.col, chunks[-1].col) and torch.equal(again.val, chunks[-1].val)


def test_port_lattice_has_a_self_paired_block_when_odd():
    lat = ss.make_lattice_stream(5, 2, 8, 64, seed=7, device="cpu")
    assert (lat.partner[lat.partner] == np.arange(5)).all()
    assert int((lat.partner == np.arange(5)).sum()) == 1


@pytest.mark.parametrize("n,deg", [(10_000_000, 50), (20_000, 10), (500_000, 32), (3, 2)])
def test_lattice_config_matches_the_benchmark(n, deg):
    assert ss.lattice_config(n, deg) == j_lattice_config(n, deg)[:4]


def test_lattice_config_at_the_baseline_scale():
    n_chunks, w_sc, w, cell_e = ss.lattice_config(10_000_000, 50)
    assert (n_chunks, w_sc, w, cell_e) == (610, 32, 512, 800)
    assert n_chunks * w_sc * w == 9_994_240
    assert n_chunks * w_sc * w_sc * cell_e == 499_712_000
    assert w_sc * cell_e / w == 50


# ---------------------------------------------------------------------------
# Host chunks, files, the cache
# ---------------------------------------------------------------------------


def _random_coo(n, e, seed):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n, e).astype(np.int64),
        rng.integers(0, n, e).astype(np.int64),
        rng.random(e).astype(np.float64),
    )


def test_sorted_stream_graph_matches_jax():
    n, e = 300, 4000
    row, col, val = _random_coo(n, e, 4)
    jg = jss.SortedStreamGraph.from_coo(row, col, val, n, k=128, w=8, max_p_bytes=64 * 128 * 4)
    assert jg.n_chunks > 1
    tg = ss.SortedStreamGraph.from_coo(row, col, val, n, max_chunk_edges=900)
    assert tg.n_chunks == 5 and tg.n_edges == e == jg.n_edges
    x = np.random.default_rng(5).normal(size=(n, 16)).astype(np.float32)
    want = np.asarray(jg.spmm(jnp.asarray(x), interpret=True))
    got = tg.spmm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(spmm(tg, torch.from_numpy(x)).numpy(), want, rtol=2e-5, atol=2e-5)
    one = ss.SortedStreamGraph.from_coo(row, col, val, n)  # one chunk of CHUNK_EDGES
    assert one.n_chunks == 1 and one.n_edges == e
    np.testing.assert_allclose(one.spmm(torch.from_numpy(x)).numpy(), want, rtol=2e-5, atol=2e-5)


def _check_cut(chunks, n, e, max_edges):
    """Chunks tile rows [0, n) in order, each within ``max_edges`` edges
    unless it is one longer row, and each as long as the next row allows."""
    assert chunks[0].r0 == 0 and sum(c.rows for c in chunks) == n
    assert sum(c.n_edges for c in chunks) == e
    for a, b in zip(chunks, chunks[1:]):
        assert b.r0 == a.r0 + a.rows
        assert a.n_edges + int(b.row_ptr[1]) > max_edges  # the next row did not fit
    for c in chunks:
        assert c.n_edges <= max_edges or c.rows == 1


def test_convert_graph_streamed_and_the_cli_choices():
    """A graph above CHUNK_EDGES is cut into row ranges of at most that many
    edges; the CLI's --spmm choices do not include the stream."""
    n, e = 20_000, 1_000_000
    row, col, val = _random_coo(n, e, 6)
    g = SparseGraph.from_coo(row, col, val, n, device=torch.device("cpu"))
    sg, perm = convert_graph(g, "streamed")
    assert isinstance(sg, ss.SortedStreamGraph) and perm is None
    assert sg.n_chunks == 2 and sg.n_nodes == n and sg.symmetric
    _check_cut(sg.chunks, n, e, ss.CHUNK_EDGES)
    x = torch.randn(n, 4, generator=torch.Generator().manual_seed(1))
    want = _matrix(row, col, val, n) @ x.numpy()
    np.testing.assert_allclose(spmm(sg, x).numpy(), want, rtol=2e-5, atol=2e-5)
    # the CLI does not offer the stream: its --spmm choices are the JAX CLI's
    parser = cli.build_parser()
    train = parser._subparsers._group_actions[0].choices["train"]
    (action,) = [a for a in train._actions if a.dest == "spmm"]
    assert action.choices == ["auto", "segment", "dense", "bsr", "onehot", "hybrid"]
    with pytest.raises(SystemExit):
        parser.parse_args(["train", "--dataset", "R8", "--spmm", "streamed"])
    with pytest.raises(ValueError, match="unknown spmm format"):
        convert_graph(g, "stream")


@pytest.mark.parametrize("max_edges", [1, 7, 12, 40, 100])
def test_csr_stream_cuts_by_edge_count(max_edges):
    """Rows of 0-12 edges, some empty, one of 30: each chunk holds whole
    rows up to ``max_edges`` edges, and a longer row makes a chunk alone."""
    deg = np.array([3, 0, 0, 5, 12, 30, 0, 1, 7, 0, 2, 9, 0, 0])
    n, e = len(deg), int(deg.sum())
    row_ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)]))
    col = torch.arange(e, dtype=torch.int32)
    val = torch.rand(e, generator=torch.Generator().manual_seed(0))
    chunks = ss.csr_stream(row_ptr, col, val, max_edges)
    _check_cut(chunks, n, e, max_edges)
    assert torch.equal(torch.cat([c.col for c in chunks]), col)
    got = torch.cat([torch.diff(c.row_ptr.long()) for c in chunks]).numpy()
    assert (got == deg).all()


def test_hostfed_from_disk_is_reiterable(tmp_path):
    n, e = 200, 3000
    row, col, val = _random_coo(n, e, 6)
    tg = ss.SortedStreamGraph.from_coo(row, col, val, n, max_chunk_edges=700)
    d = str(tmp_path / "chunks")
    ss.save_chunks(tg.chunks, d, n)
    chunks, n_chunks, n_nodes = ss.sorted_chunks_from_dir(d)
    assert (n_chunks, n_nodes) == (tg.n_chunks, n) and n_chunks == 5
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(n, 16)).astype(np.float32))
    resident = ss.spmm_streamed_sorted(tg.chunks, x)
    first = ss.spmm_streamed_sorted_hostfed(chunks, x)
    second = ss.spmm_streamed_sorted_hostfed(chunks, x)  # the backward's replay
    assert torch.equal(first, resident) and torch.equal(second, first)


def test_cached_chunk_source_counts_host_loads(tmp_path):
    """As the JAX test: a full budget reads the source once, a zero budget
    on every pass."""
    n, e = 200, 3000
    row, col, val = _random_coo(n, e, 16)
    tg = ss.SortedStreamGraph.from_coo(row, col, val, n, max_chunk_edges=700)
    d = str(tmp_path / "chunks")
    ss.save_chunks(tg.chunks, d, n)
    _, n_chunks, _ = ss.sorted_chunks_from_dir(d)
    x = torch.from_numpy(np.random.default_rng(17).normal(size=(n, 16)).astype(np.float32))
    src = ss.CachedChunkSource(ss.chunk_loader_from_dir(d), n_chunks, 1 << 30, "cpu")
    out1 = ss.spmm_streamed_sorted_hostfed(src, x)
    assert src.host_loads == n_chunks
    out2 = ss.spmm_streamed_sorted_hostfed(src, x)
    assert src.host_loads == n_chunks  # second pass: no loads
    assert torch.equal(out1, out2)
    assert src.cached_bytes == sum(c.nbytes for c in tg.chunks)
    src0 = ss.CachedChunkSource(ss.chunk_loader_from_dir(d), n_chunks, 0, "cpu")
    ss.spmm_streamed_sorted_hostfed(src0, x)
    ss.spmm_streamed_sorted_hostfed(src0, x)
    assert src0.host_loads == 2 * n_chunks and src0.cached_bytes == 0
    assert torch.equal(ss.spmm_streamed_sorted_hostfed(src0, x), out1)


# ---------------------------------------------------------------------------
# The stream node and the segmented GCN step
# ---------------------------------------------------------------------------


def test_stream_node_cast_chain():
    """Forward stream(v.to(sd)); backward stream(g.to(sd)).to(sd).to(v.dtype),
    with a stream whose f32 output is not bf16-representable."""
    seen = []

    def stream(v):
        seen.append(v.dtype)
        return v.float() / 3.0

    tape = StreamTape(stream, torch.bfloat16)
    v = torch.randn(10, 4, generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    out = tape.stream_node(v)
    assert out.dtype == torch.float32 and seen == [torch.bfloat16]
    assert torch.equal(out, v.detach().to(torch.bfloat16).float() / 3.0)
    g = torch.randn(10, 4, generator=torch.Generator().manual_seed(1))
    out.backward(g)
    assert seen == [torch.bfloat16, torch.bfloat16]
    want = (g.to(torch.bfloat16).float() / 3.0).to(torch.bfloat16).to(torch.float32)
    assert v.grad.dtype == torch.float32 and torch.equal(v.grad, want)
    assert not torch.equal(v.grad, g / 3.0)  # the casts did round


def _train_inputs(f, c, dtype, seed=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N_PAD, f)).astype(np.float32)
    y = rng.integers(0, c, N_PAD).astype(np.int32)
    mask = (rng.random(N_PAD) < 0.5).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32)))
    if dtype == jnp.bfloat16:
        xt = xt.bfloat16()
    return xj, jnp.asarray(y), jnp.asarray(mask), xt, torch.from_numpy(y).long(), torch.from_numpy(mask)


def _jax_rounding_reduce(row_ptr, col, val, x, base, split=None):
    """The plain reduce with the JAX sorted stream's roundings: each edge
    weight cast to x's dtype and each product rounded to it, then f32 sums
    (``split``, K2's row split, is ignored)."""
    rows = torch.repeat_interleave(torch.arange(row_ptr.numel() - 1), torch.diff(row_ptr.long()))
    return base.index_add_(0, rows, (x[col.long()] * val.to(x.dtype)[:, None]).float())


# family -> the hyperparameters of both steps (APPNP and GCNII at depth 3, as
# the JAX package's own streamed tests; the JAX init takes GCNII's depth too)
FAMILY_HYPER = {
    "gcn": {}, "sgc": {}, "appnp": {"k": 3}, "sage": {}, "gin": {}, "gcnii": {"k": 3},
}
FAMILIES = list(FAMILY_HYPER)
NEW_FAMILIES = FAMILIES[1:]
# streamed passes a step at the JAX package's depths (init_streamed's)
PASSES = {"gcn": 4, "sgc": 4, "appnp": 20, "sage": 4, "gin": 4, "gcnii": 16}


def _one_step(dtype, j_opt, t_opt_cls, t_lr, reduce=ss.row_reduce, family="gcn"):
    """One step of a family's JAX segmented step on the JAX sorted stream and
    of the port's on the converted chunks, from the same weights."""
    edge_fn, spec, chunks, _ = _port_chunks_of_jax_lattice()
    f, h, c = 12, 6, 3
    hyper = FAMILY_HYPER[family]
    xj, yj, mj, xt, yt, mt = _train_inputs(f, c, dtype)
    j_init = jax_models.MODELS[family][0]
    jparams = j_init(jax.random.PRNGKey(0), f, h, c, **(hyper if family == "gcnii" else {}))
    j_state = j_opt.init(jparams)

    def stream_fn(v):
        return jss.spmm_streamed_sorted(edge_fn, v, N_CHUNKS, spec, interpret=True)[:, : v.shape[1]]

    j_step = jst.STREAMED_SEGMENTED_FACTORIES[family](
        None, N_PAD, N_CHUNKS, optimizer=j_opt, stream_dtype=dtype, stream_fn=stream_fn,
        **hyper,
    )
    jp2, _, jloss = j_step(jax.tree_util.tree_map(jnp.copy, jparams), j_state, xj, yj, mj)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    opt = t_opt_cls(params.values(), lr=t_lr)
    sd = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    step = st.STREAMED_SEGMENTED_FACTORIES[family](
        st.make_sorted_stream(chunks, reduce), N_PAD, opt, stream_dtype=sd, **hyper
    )
    tloss = step(params, xt, yt, mt)
    return jparams, jp2, float(jloss), params, float(tloss)


def _leaves(jparams):
    """(port key, JAX leaf path) of every parameter."""
    return [(f"{layer}.{leaf}", (layer, leaf)) for layer, leaves in jparams.items() for leaf in leaves]


def _check_adam_f32(family):
    """Adam, f32 stream: loss at rtol 1e-5, parameters after one step at the
    JAX package's own sorted-stream tolerance."""
    jparams, jp2, jloss, params, tloss = _one_step(
        jnp.float32, optax.adam(0.02), torch.optim.Adam, 0.02, family=family
    )
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for key, (layer, leaf) in _leaves(jparams):
        np.testing.assert_allclose(
            params[key].detach().numpy(), np.asarray(jp2[layer][leaf]),
            rtol=2e-3, atol=2e-4, err_msg=key,
        )


def _check_sgd_bf16(family, rounding, loss_rtol, grad_rel):
    """bf16 features and stream, SGD with lr 1 (the step is the gradient):
    loss at ``loss_rtol``, every gradient within ``grad_rel`` of its largest
    entry. ``rounding`` "jax" reduces with the JAX stream's roundings, "k2"
    with the port's own reduce."""
    jparams, jp2, jloss, params, tloss = _one_step(
        jnp.bfloat16, optax.sgd(1.0), torch.optim.SGD, 1.0,
        _jax_rounding_reduce if rounding == "jax" else ss.row_reduce, family=family,
    )
    np.testing.assert_allclose(tloss, jloss, rtol=loss_rtol)
    for key, (layer, leaf) in _leaves(jparams):
        jg = np.asarray(jparams[layer][leaf]) - np.asarray(jp2[layer][leaf])
        tg = params[key].grad.numpy()
        assert np.abs(tg - jg).max() <= grad_rel * np.abs(jg).max(), key


def test_segmented_step_matches_jax_f32():
    """The GCN's step: Adam, f32 stream (:func:`_check_adam_f32`)."""
    _check_adam_f32("gcn")


@pytest.mark.parametrize("rounding", ["jax", "k2"])
def test_segmented_step_gradients_match_jax_bf16(rounding):
    """bf16 features and stream; SGD with lr 1 exposes each gradient as the
    step. With the JAX stream's roundings in the reduce (each edge weight and
    product rounded to bf16) only f32 sums in another order remain: loss and
    gradients agree to 1e-5. With the port's own reduce (exact f32 products,
    as K2) each term moves by up to 2^-8; at 80 nodes a stream output that
    then rounds to another bf16 value, or crosses the relu, moves a whole
    node's share of a gradient: loss to 1e-3, gradients to 0.1 of their
    largest entry (measured: 1.2e-4 and 5.2e-2)."""
    if rounding == "jax":
        _check_sgd_bf16("gcn", "jax", 1e-5, 1e-5)
    else:
        _check_sgd_bf16("gcn", "k2", 1e-3, 1e-1)


def test_streamed_factories_have_the_jax_keys():
    assert list(st.STREAMED_SEGMENTED_FACTORIES) == list(jst.STREAMED_SEGMENTED_FACTORIES)
    assert set(PASSES) == set(st.STREAMED_SEGMENTED_FACTORIES)


@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_family_step_matches_jax_f32(family):
    """Each other family's step against the JAX factory's: Adam, f32
    stream, as the GCN's."""
    _check_adam_f32(family)


@pytest.mark.parametrize("family", NEW_FAMILIES)
@pytest.mark.parametrize("rounding", ["jax", "k2"])
def test_family_step_gradients_match_jax_bf16(family, rounding):
    """Each other family's step against the JAX factory's in bf16, SGD with
    lr 1. With the JAX stream's roundings: loss and gradients to 1e-5, as
    the GCN's (measured: 2.3e-7 at most). With the port's own reduce the
    JAX stream's bf16 edge weights and products are what differ: each edge
    term of a pass moves by up to 2^-8 of its size. SGC, SAGE and GIN put
    logits several times the GCN's through the passes, and the loss, near
    linear in logits of that size, moves by up to that share: loss to 4e-3
    (2^-8; measured 1.3e-3 at most, SAGE, past the GCN's 1e-3), gradients to
    2e-2 of their largest entry (measured 5.8e-3 at most; no relu crossing
    here moves a node's share as the GCN's 5.2e-2 does)."""
    if rounding == "jax":
        _check_sgd_bf16(family, "jax", 1e-5, 1e-5)
    else:
        _check_sgd_bf16(family, "k2", 4e-3, 2e-2)


def _through_a_cache(family, budget_chunks):
    """A CachedChunkSource whose byte budget holds fewer chunks than the
    graph has: the rest stream from host chunks on every pass, and the step's
    loss and gradients equal the resident step's."""
    lat = ss.make_lattice_stream(N_CHUNKS, W_SC, W, CELL_E, seed=9, device="cpu")
    host = list(lat)
    budget = sum(c.nbytes for c in host[:budget_chunks])
    f, h, c = 12, 6, 3
    xj, yj, mj, xt, yt, mt = _train_inputs(f, c, jnp.bfloat16)
    res = []
    for chunks in (host, ss.CachedChunkSource(host.__getitem__, len(host), budget, "cpu")):
        params, _ = st.init_streamed(
            torch.Generator().manual_seed(3), f, h, c, device="cpu", family=family
        )
        opt = torch.optim.SGD(params.values(), lr=0.0)
        step = st.STREAMED_SEGMENTED_FACTORIES[family](st.make_sorted_stream(chunks), N_PAD, opt)
        res.append((float(step(params, xt, yt, mt)), {k: p.grad for k, p in params.items()}))
    (loss_r, grads_r), (loss_c, grads_c) = res
    assert loss_c == loss_r
    for k in grads_r:
        assert torch.equal(grads_c[k], grads_r[k]), k
    # the step's first pass loads every chunk, each other pass the chunks
    # the budget did not hold
    src = chunks
    assert src.cached_bytes == budget
    assert src.host_loads == N_CHUNKS + (PASSES[family] - 1) * (N_CHUNKS - budget_chunks)


@pytest.mark.parametrize("budget_chunks", [0, 2])
def test_segmented_step_through_a_cache_below_the_graph_matches_resident(budget_chunks):
    """The GCN's step (:func:`_through_a_cache`): four passes a step."""
    _through_a_cache("gcn", budget_chunks)


@pytest.mark.parametrize("family", NEW_FAMILIES)
@pytest.mark.parametrize("budget_chunks", [0, 2])
def test_family_step_through_a_cache_below_the_graph_matches_resident(family, budget_chunks):
    """Each other family's step at its default depth (:func:`_through_a_cache`)."""
    _through_a_cache(family, budget_chunks)


def _trains_in_bf16(family):
    """Ten bf16 steps on the port's lattice, features carrying the label,
    lower the loss below 0.9 of the first."""
    lat = ss.make_lattice_stream(N_CHUNKS, W_SC, W, CELL_E, seed=5, device="cpu")
    src = ss.CachedChunkSource(lat.chunk, len(lat), 1 << 30, "cpu")
    f, h, c = 12, 8, 3
    rng = np.random.default_rng(6)
    y = rng.integers(0, c, N_PAD)
    x = rng.normal(size=(N_PAD, f)) * 0.1 + np.eye(c)[y][:, np.arange(f) % c]
    params, opt = st.init_streamed(
        torch.Generator().manual_seed(7), f, h, c, device="cpu", family=family
    )
    step = st.STREAMED_SEGMENTED_FACTORIES[family](st.make_sorted_stream(src), N_PAD, opt)
    xt = torch.tensor(x, dtype=torch.bfloat16)
    yt, mt = torch.from_numpy(y), torch.ones(N_PAD)
    losses = [float(step(params, xt, yt, mt)) for _ in range(10)]
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.9 * losses[0], losses
    assert src.host_loads == len(lat)  # generated once, then served from the cache
    with pytest.raises(ValueError, match="rows"):
        step(params, xt[:-1], yt[:-1], mt[:-1])


def test_segmented_step_trains_in_bf16():
    """The GCN (:func:`_trains_in_bf16`)."""
    _trains_in_bf16("gcn")


@pytest.mark.parametrize("family", NEW_FAMILIES)
def test_family_step_trains_in_bf16(family):
    """Each other family at its default depth (:func:`_trains_in_bf16`)."""
    _trains_in_bf16(family)


def test_init_streamed_gives_each_family_its_init():
    """``init_streamed(family=...)`` draws the family's module init from the
    generator, requiring grad, with Adam at the trainer's settings; the
    default is the GCN's, and a family without a streamed step is refused."""
    for family in FAMILIES:
        params, opt = st.init_streamed(
            torch.Generator().manual_seed(1), 12, 6, 3, device="cpu", family=family
        )
        want = MODELS[family].init_params(torch.Generator().manual_seed(1), 12, 6, 3, device="cpu")
        assert params.keys() == want.keys()
        for k in want:
            assert params[k].requires_grad and torch.equal(params[k].detach(), want[k]), k
        assert opt.defaults["lr"] == 0.02 and opt.defaults["betas"] == (0.9, 0.999)
    default, _ = st.init_streamed(torch.Generator().manual_seed(1), 12, 6, 3, device="cpu")
    assert set(default) == {"gc1.w", "gc1.b", "gc2.w", "gc2.b"}
    with pytest.raises(ValueError, match="no streamed step"):
        st.init_streamed(torch.Generator(), 12, 6, 3, device="cpu", family="gat")
