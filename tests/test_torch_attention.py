"""The port's attention ops (textgcn_tpu_torch/ops/attention.py) against the
JAX package's (textgcn_tpu/ops/pallas_attention.py), on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_attention.py runs
them; the port's wrappers run their plain PyTorch versions on CPU tensors
(the CUDA kernels are held against those in tests/test_torch_kernels.py).
JAX keeps per-edge values in plan slots and the port in forward-CSR order:
``fwd_dst`` and ``edge_pos`` map both to the input edge order.

Tolerances: where both sides compute in f32 from the same (bf16-rounded)
inputs, only the order of f32 sums differs (rtol 1e-5 .. 1e-4); where JAX
rounds to bf16 and the port does not (the aggregation weights, the
products of the dx pass), 2e-2, the JAX package's own bf16 tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textgcn_tpu.ops import pallas_attention as jatt

from textgcn_tpu_torch.ops import attention as tatt

CPU = torch.device("cpu")
SLOPE = 0.2


def _graph(n=300, e=3000, seed=0, symmetric=False):
    """Coalesced COO whose row degrees span two orders of magnitude (rows
    drawn from a power law), with rows that have no edges (the tail, and
    every row = 5 mod 97), and val in [0.1, 1)."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -1.2
    p /= p.sum()
    row = rng.choice(n, e, p=p)
    col = rng.randint(0, n, e)
    if symmetric:
        row, col = np.concatenate([row, col]), np.concatenate([col, row])
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    keep = (row % 97) != 5
    row, col = row[keep], col[keep]
    val = rng.rand(len(row)) * 0.9 + 0.1
    if symmetric:
        lo = np.minimum(row, col) * n + np.maximum(row, col)
        val = 0.1 + 0.9 * ((lo * 2654435761) % 1000) / 1000.0
    return row, col, val, n


def _both(row, col, val, n):
    tg = tatt.AttentionGraph.from_coo(row, col, val, n, device=CPU)
    jg = jatt.AttentionGraph.from_coo(row, col, val, n, w=8, k=128)
    return tg, jg


def _port_to_edges(tg, a):
    """Port per-edge values (forward-CSR order) -> input edge order."""
    return np.asarray(a)[tg.edge_pos.numpy()]


def _jax_to_edges(jg, slots, plan="fwd"):
    dst = jg.fwd_dst if plan == "fwd" else jg.bwd_dst
    return np.asarray(slots).reshape(-1)[np.asarray(dst)]


def _jax_slots(jg, edge_vals, fill):
    flat = np.full(jg.fwd.n_sc * jg.fwd.c_sc * jg.fwd.k, fill, np.float32)
    flat[np.asarray(jg.fwd_dst)] = edge_vals
    return jnp.asarray(flat.reshape(jg.fwd.n_sc, -1))


def _port_edges(tg, edge_vals):
    """Input-order per-edge values -> port forward-CSR order."""
    out = np.empty(len(edge_vals), np.float32)
    out[tg.edge_pos.numpy()] = edge_vals
    return torch.from_numpy(out)


def _jax_stats_logits(jg, es, ed):
    """JAX's forward prologue (``_gat_attention_fwd_impl``) up to the
    stats+logits kernel."""
    plan = jg.fwd
    n_rows = plan.n_sc * plan.w_sc * plan.w
    es_rep = jnp.broadcast_to(
        jnp.pad(jnp.asarray(es), (0, n_rows - len(es)))[:, None], (n_rows, 128)
    )
    gd = jnp.take(
        jnp.asarray(ed), plan.col.reshape(-1), mode="fill", fill_value=0.0
    ).reshape(plan.n_sc, -1)
    return jatt.stats_logits(plan, es_rep, gd, jnp.log(plan.val), SLOPE, True)


def test_attention_graph_layout():
    row, col, val, n = _graph(seed=1)
    tg = tatt.AttentionGraph.from_coo(row, col, val, n, device=CPU)
    ptr = tg.row_ptr.numpy()
    rows = np.repeat(np.arange(n), np.diff(ptr))
    np.testing.assert_array_equal(rows, tg.row.numpy())
    # forward CSR sorted by (row, col); edge_pos maps input edges into it
    key = rows * n + tg.col.numpy()
    assert np.all(np.diff(key) > 0)
    pos = tg.edge_pos.numpy()
    np.testing.assert_array_equal(rows[pos], row)
    np.testing.assert_array_equal(tg.col.numpy()[pos], col)
    np.testing.assert_array_equal(
        tg.logval.numpy()[pos], np.log(val.astype(np.float32))
    )
    # transpose CSR sorted by (col, row); perm_t points at the same edge
    perm = tg.perm_t.numpy()
    rows_t = np.repeat(np.arange(n), np.diff(tg.row_ptr_t.numpy()))
    np.testing.assert_array_equal(tg.col.numpy()[perm], rows_t)
    np.testing.assert_array_equal(rows[perm], tg.col_t.numpy())
    assert np.all(np.diff(rows_t * n + tg.col_t.numpy()) > 0)
    assert tg.max_degree == np.diff(ptr).max() > 20 * np.median(np.diff(ptr))
    with pytest.raises(ValueError, match="coalesced"):
        tatt.AttentionGraph.from_coo(
            np.r_[row, row[:1]], np.r_[col, col[:1]], np.r_[val, val[:1]], n,
            device=CPU,
        )


def test_stats_logits_match_jax():
    row, col, val, n = _graph(seed=2)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(3)
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    lg_t, mx_t, sm_t = tatt.stats_logits(
        tg.row_ptr, tg.col, tg.logval, torch.from_numpy(es), torch.from_numpy(ed),
        SLOPE,
    )
    lg_j, mx_j, sm_j = _jax_stats_logits(jg, es, ed)
    # the same f32 operations per edge, but log(val) from numpy on the port's
    # side and from XLA on JAX's (they may differ in the last bit)
    np.testing.assert_allclose(
        _port_to_edges(tg, lg_t), _jax_to_edges(jg, lg_j), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(mx_t.numpy(), np.asarray(mx_j)[:n, 0], rtol=1e-6)
    # f32 exp-sums in another order (online rescaling on both sides)
    np.testing.assert_allclose(sm_t.numpy(), np.asarray(sm_j)[:n, 0], rtol=1e-5)
    empty = np.diff(tg.row_ptr.numpy()) == 0
    assert empty.sum() >= 4
    assert np.all(mx_t.numpy()[empty] == np.float32(-1e30))
    assert np.all(sm_t.numpy()[empty] == 0)


def test_softmax_stats_match_jax():
    row, col, val, n = _graph(seed=4)
    tg, jg = _both(row, col, val, n)
    elog = np.random.RandomState(5).randn(len(row)).astype(np.float32) * 3
    mx_t, sm_t = tatt.softmax_stats(tg.row_ptr, _port_edges(tg, elog))
    mx_j, sm_j = jatt.softmax_stats(jg.fwd, _jax_slots(jg, elog, -np.inf), True)
    np.testing.assert_array_equal(mx_t.numpy(), np.asarray(mx_j)[:n, 0])
    # f32 exp-sums in another order
    np.testing.assert_allclose(sm_t.numpy(), np.asarray(sm_j)[:n, 0], rtol=1e-5)


def test_rowsum_forward_and_transpose_match_jax():
    row, col, val, n = _graph(seed=6)
    tg, jg = _both(row, col, val, n)
    v = np.random.RandomState(7).randn(len(row)).astype(np.float32)
    vt = _port_edges(tg, v)
    got_f = tatt.rowsum(tg.row_ptr, vt)
    want_f = jatt.rowsum_slots(jg.fwd, _jax_slots(jg, v, 0.0), True)
    flat_b = np.zeros(jg.bwd.n_sc * jg.bwd.c_sc * jg.bwd.k, np.float32)
    flat_b[np.asarray(jg.bwd_dst)] = v
    got_t = tatt.rowsum(tg.row_ptr_t, vt[tg.perm_t.long()])
    want_t = jatt.rowsum_slots(
        jg.bwd, jnp.asarray(flat_b.reshape(jg.bwd.n_sc, -1)), True
    )
    # f32 sums in another order
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f)[:n, 0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t)[:n, 0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f", [8, 20])
def test_sddmm_matches_jax(f):
    row, col, val, n = _graph(seed=8)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(9)
    g = rng.randn(n, f).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    u_t = tatt.sddmm(
        tg.row_ptr, tg.col,
        tatt.features_bf16(torch.from_numpy(g)), tatt.features_bf16(torch.from_numpy(x)),
        tg.row,
    )
    u_j = jatt.sddmm_slots(jg.fwd, jnp.asarray(g), jnp.asarray(x), True)
    # both round g and x to bf16; their products are exact in f32, summed in
    # another order
    np.testing.assert_allclose(
        _port_to_edges(tg, u_t), _jax_to_edges(jg, u_j), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("f", [8, 20])
def test_attn_agg_matches_jax(f):
    row, col, val, n = _graph(seed=10)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(11)
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    lg, mx, sm = tatt.stats_logits(
        tg.row_ptr, tg.col, tg.logval, torch.from_numpy(es), torch.from_numpy(ed), SLOPE
    )
    got = tatt.attn_agg(tg.row_ptr, tg.col, lg, mx, sm, tatt.features_bf16(torch.from_numpy(x)))
    want = jatt._attn_agg(jg.fwd, *_jax_stats_logits(jg, es, ed), jnp.asarray(x), True)
    # JAX rounds the softmax weights to bf16 before its dot; the port keeps f32
    np.testing.assert_allclose(got[:, :f].numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)
    assert np.all(got[np.diff(tg.row_ptr.numpy()) == 0].numpy() == 0)


def _hub_graph(n=1300, seed=0, hub_cols=False):
    """Coalesced COO with two hub rows longer than K2's S (row 0: 1,200
    edges, row 7: 600) among power-law rows, and val in [0.1, 1). With
    ``hub_cols`` also two hub columns (column 3: 1,100 in-edges, column 9:
    700), so the transpose CSR has a split table too, with the forward
    table's counts (a square graph) but another row pointer."""
    row, col, _, _ = _graph(n=n, e=4000, seed=seed)
    rng = np.random.RandomState(seed + 100)
    row = np.r_[row, np.zeros(1200, np.int64), np.full(600, 7)]
    col = np.r_[col, rng.permutation(n)[:1200], rng.permutation(n)[:600]]
    if hub_cols:
        row = np.r_[row, rng.permutation(n)[:1100], rng.permutation(n)[:700]]
        col = np.r_[col, np.full(1100, 3), np.full(700, 9)]
    key = np.unique(row * n + col)
    row, col = key // n, key % n
    return row, col, rng.rand(len(row)) * 0.9 + 0.1, n


def _split_attn_sum(tg, logits, mx, sm, x):
    """The split kernel's order of sums, emulated in f32: a row of at most
    S edges sums its weighted features; a longer row adds its segments'
    partial sums in segment order (pass 2, from zero)."""
    rp, col = tg.row_ptr.numpy(), tg.col.numpy()
    rows = np.repeat(np.arange(len(rp) - 1), np.diff(rp))
    shift = np.where(mx > -0.5e30, mx, 0.0)[rows]
    w = (np.exp(logits - shift) / np.maximum(sm, 1e-30)[rows]).astype(np.float32)
    prod = w[:, None] * x[col]
    out = np.zeros((len(rp) - 1, x.shape[1]), np.float32)
    s = tatt.SEGMENT_EDGES
    for r in np.flatnonzero(np.diff(rp) <= s):
        out[r] = prod[rp[r] : rp[r + 1]].sum(0)
    sp = tg.split
    seg_row, seg_e0, long_ptr = (t.numpy() for t in (sp.seg_row, sp.seg_e0, sp.long_ptr))
    for i in range(sp.n_long):
        r = seg_row[long_ptr[i]]
        acc = np.zeros(x.shape[1], np.float32)
        for k in range(long_ptr[i], long_ptr[i + 1]):
            acc = acc + prod[seg_e0[k] : min(seg_e0[k] + s, rp[r + 1])].sum(0)
        out[r] = acc
    return out


@pytest.mark.parametrize("f", [8, 24])
def test_split_attn_agg_matches_plain_and_jax(f):
    """The forward split table (``AttentionGraph.split``) on hub rows of
    1,200 and 600 edges: a numpy emulation of the split sum against
    ``attn_agg_plain`` (f32 sums in another order, 1e-5 relative to the
    largest output) and against JAX ``_attn_agg`` in interpret mode (which
    rounds the weights to bf16: 2e-2)."""
    row, col, val, n = _hub_graph(seed=f)
    tg, jg = _both(row, col, val, n)
    sp = tg.split
    assert (sp.n_long, sp.n_seg) == (2, 5) and sp.n_rows == n and sp.n_edges == len(row)
    rng = np.random.RandomState(f)
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    x = torch.from_numpy(rng.randn(n, f).astype(np.float32)).bfloat16().float()
    lg, mx, sm = tatt.stats_logits(
        tg.row_ptr, tg.col, tg.logval, torch.from_numpy(es), torch.from_numpy(ed), SLOPE
    )
    want = _split_attn_sum(tg, lg.numpy(), mx.numpy(), sm.numpy(), x.numpy())
    scale = np.abs(want).max()
    # on the CPU the wrapper checks the table and runs attn_agg_plain
    got = tatt.attn_agg(tg.row_ptr, tg.col, lg, mx, sm, tatt.features_bf16(x), split=sp)
    np.testing.assert_allclose(got[:, :f].numpy(), want, rtol=0, atol=1e-5 * scale)
    jax_out = jatt._attn_agg(jg.fwd, *_jax_stats_logits(jg, es, ed), jnp.asarray(x.numpy()), True)
    np.testing.assert_allclose(np.asarray(jax_out), want, rtol=2e-2, atol=2e-2)


def _segments(sp, rp):
    """Each long row of a split table with its segments' edge ranges, in
    segment order: ``[(row, [(e0, e1), ...]), ...]``."""
    s = tatt.SEGMENT_EDGES
    seg_row, seg_e0, long_ptr = (t.numpy() for t in (sp.seg_row, sp.seg_e0, sp.long_ptr))
    out = []
    for i in range(sp.n_long):
        r = seg_row[long_ptr[i]]
        ks = range(long_ptr[i], long_ptr[i + 1])
        out.append((r, [(seg_e0[k], min(seg_e0[k] + s, rp[r + 1])) for k in ks]))
    return out


def _f32(x):
    return np.float32(x)


def _warp_pair(lg):
    """One warp's softmax pair (max, sum of exp(x - max)) over its edges, in
    f32, from the sentinel -1e30: -inf logits add exp(-inf) = 0."""
    m = _f32(max(_f32(-1e30), lg.max())) if len(lg) else _f32(-1e30)
    return m, np.exp(lg - m, dtype=np.float32).sum(dtype=np.float32)


def _split_stats(tg, logits):
    """The split kernel's softmax statistics, emulated in f32: a row of at
    most S edges is one warp's pair; a longer row's segments' pairs are
    merged in segment order from (-1e30, 0) with the online rescale
    (``row_split.cuh`` softmax_merge)."""
    rp = tg.row_ptr.numpy()
    lg = np.asarray(logits, np.float32)
    pairs = [_warp_pair(lg[rp[r] : rp[r + 1]]) for r in range(len(rp) - 1)]
    mx, sm = (np.asarray(a, np.float32) for a in zip(*pairs))
    for r, segs in _segments(tg.split, rp):
        m, s = _f32(-1e30), _f32(0)
        for e0, e1 in segs:
            m_k, s_k = _warp_pair(lg[e0:e1])
            m_new = max(m, m_k)
            s = s * np.exp(m - m_new) + s_k * np.exp(m_k - m_new)
            m = m_new
        mx[r], sm[r] = m, s
    return mx, sm


def _split_rowsum(rp, sp, v):
    """The split kernel's row sums, emulated in f32: a row of at most S
    edges is one warp's sum; a longer row adds its segments' sums in
    segment order from zero."""
    v = np.asarray(v, np.float32)
    out = np.asarray([v[rp[r] : rp[r + 1]].sum(dtype=np.float32) for r in range(len(rp) - 1)],
                     np.float32)
    for r, segs in _segments(sp, rp):
        acc = _f32(0)
        for e0, e1 in segs:
            acc = acc + v[e0:e1].sum(dtype=np.float32)
        out[r] = acc
    return out


@pytest.mark.parametrize("op", ["stats_logits", "softmax_stats"])
def test_split_softmax_stats_match_plain_and_jax(op):
    """The forward split table on hub rows of 1,200 and 600 edges: a numpy
    emulation of the split statistics (per-segment (max, sum) pairs merged
    in segment order) against the plain version (mx bit-equal: a max does
    not depend on order; sm f32 exp-sums in another order, 1e-6 relative)
    and against JAX ``stats_logits`` / ``softmax_stats`` in interpret mode
    (at ``test_stats_logits_match_jax``'s and
    ``test_softmax_stats_match_jax``'s tolerances). In ``softmax_stats`` some
    logits are -inf, among them every edge of the hub row's second segment
    and of a short row, which keep the sentinel (-1e30, 0)."""
    row, col, val, n = _hub_graph(seed=31 if op == "stats_logits" else 32)
    tg, jg = _both(row, col, val, n)
    sp = tg.split
    assert (sp.n_long, sp.n_seg) == (2, 5)
    rng = np.random.RandomState(33)
    if op == "stats_logits":
        es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
        args = (tg.row_ptr, tg.col, tg.logval, torch.from_numpy(es), torch.from_numpy(ed), SLOPE)
        lg, mx, sm = tatt.stats_logits(*args, split=sp)
        _, mx_p, sm_p = tatt.stats_logits_plain(*args)
        lg_j, mx_j, sm_j = _jax_stats_logits(jg, es, ed)
        np.testing.assert_allclose(
            _port_to_edges(tg, lg), _jax_to_edges(jg, lg_j), rtol=1e-6, atol=1e-6
        )
        lg = lg.numpy()
        # log(val) from numpy here, from XLA in JAX: the last bit of a logit
        # of magnitude ~1, so near-zero maxima get an absolute 1e-6 too
        mx_tol = {"rtol": 1e-6, "atol": 1e-6}
    else:
        lg = rng.randn(tg.n_edges).astype(np.float32) * 3
        lg[::50] = -np.inf
        rp = tg.row_ptr.numpy()
        (_, segs), = [(r, g) for r, g in _segments(sp, rp) if r == 0]
        lg[segs[1][0] : segs[1][1]] = -np.inf
        short = np.flatnonzero(np.diff(rp) == 3)[0]
        lg[rp[short] : rp[short + 1]] = -np.inf
        mx, sm = tatt.softmax_stats(tg.row_ptr, torch.from_numpy(lg), split=sp)
        mx_p, sm_p = tatt.softmax_stats_plain(tg.row_ptr, torch.from_numpy(lg))
        mx_j, sm_j = jatt.softmax_stats(
            jg.fwd, _jax_slots(jg, _port_to_edges(tg, lg), -np.inf), True
        )
        mx_tol = {"rtol": 0}
        assert (mx[short].item(), sm[short].item()) == (np.float32(-1e30), 0)
    want_mx, want_sm = _split_stats(tg, lg)
    # on the CPU the wrapper checks the table and runs the plain version
    np.testing.assert_array_equal(mx.numpy(), want_mx)
    np.testing.assert_array_equal(mx_p.numpy(), want_mx)
    np.testing.assert_allclose(sm.numpy(), want_sm, rtol=1e-6)
    np.testing.assert_allclose(sm_p.numpy(), want_sm, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mx_j)[:n, 0], want_mx, **mx_tol)
    # f32 exp-sums in another order (online rescaling on both sides)
    np.testing.assert_allclose(np.asarray(sm_j)[:n, 0], want_sm, rtol=1e-5)


@pytest.mark.parametrize("csr", ["forward", "transpose"])
def test_split_rowsum_matches_plain_and_jax(csr):
    """``rowsum`` over each CSR with its own table (hub rows of 1,200 and 600
    edges, hub columns of 1,100 and 700): a numpy emulation of the split sum
    (segment sums added in segment order) against ``rowsum_plain`` and
    against JAX ``rowsum_slots`` in interpret mode over the forward or
    transpose plan (``test_rowsum_forward_and_transpose_match_jax``'s
    tolerance). The plain version adds a row's values one after another in
    f32: each add rounds at 2^-24 of a running sum that reaches ~sqrt(1,100)
    times a value, so over a hub's ~1,100 adds the two orders differ by up
    to ~1e-5 of the largest output (1.6e-6 seen)."""
    row, col, val, n = _hub_graph(seed=34, hub_cols=True)
    tg, jg = _both(row, col, val, n)
    assert tg.split.n_long == 2 and tg.split_t.n_long == 2
    v = np.random.RandomState(35).randn(len(row)).astype(np.float32)
    vt = _port_edges(tg, v)
    if csr == "forward":
        rp, sp, vals, plan, dst = tg.row_ptr, tg.split, vt, jg.fwd, jg.fwd_dst
    else:
        rp, sp, vals, plan, dst = tg.row_ptr_t, tg.split_t, vt[tg.perm_t.long()], jg.bwd, jg.bwd_dst
    want = _split_rowsum(rp.numpy(), sp, vals.numpy())
    scale = np.abs(want).max()
    np.testing.assert_allclose(tatt.rowsum(rp, vals, split=sp).numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    np.testing.assert_allclose(tatt.rowsum_plain(rp, vals).numpy(), want, rtol=0,
                               atol=1e-5 * scale)
    flat = np.zeros(plan.n_sc * plan.c_sc * plan.k, np.float32)
    flat[np.asarray(dst)] = v
    want_j = jatt.rowsum_slots(plan, jnp.asarray(flat.reshape(plan.n_sc, -1)), True)
    np.testing.assert_allclose(np.asarray(want_j)[:n, 0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["gat_attention", "attention_spmm"])
def test_ops_with_split_tables_match_jax_vjp(op):
    """Both autograd ops on a graph whose forward and transpose CSRs each
    have a split table (equal counts, other row pointers): every call that
    takes a table gets its own CSR's, or the fingerprint check raises; the
    forward and the gradients match the JAX vjp at the tolerances of
    ``test_gat_attention_forward_and_grads_match_jax_vjp`` and
    ``test_attention_spmm_forward_and_grads_match_jax_vjp``, except dx (see
    below)."""
    row, col, val, n = _hub_graph(seed=36, hub_cols=True)
    tg, jg = _both(row, col, val, n)
    assert tg.split.fingerprint != tg.split_t.fingerprint
    rng = np.random.RandomState(37)
    x = rng.randn(n, 16).astype(np.float32)
    cot = rng.randn(n, 16).astype(np.float32)
    x_t = torch.from_numpy(x).requires_grad_(True)
    if op == "gat_attention":
        es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
        out_j, vjp = jax.vjp(
            lambda a, b, c: jatt.gat_attention(jg, a, b, c, SLOPE, True),
            jnp.asarray(es), jnp.asarray(ed), jnp.asarray(x),
        )
        des_j, ded_j, dx_j = vjp(jnp.asarray(cot))
        es_t, ed_t = (torch.from_numpy(a).requires_grad_(True) for a in (es, ed))
        lg, mx, sm = tatt.stats_logits(tg.row_ptr, tg.col, tg.logval, es_t.detach(),
                                       ed_t.detach(), SLOPE)
        out_t = tatt.gat_attention(tg, es_t, ed_t, x_t, SLOPE)
        out_t.backward(torch.from_numpy(cot))
        # both take f32 weights from the stats and u from the same bf16 g and
        # x (exact products); f32 sums in another order
        np.testing.assert_allclose(es_t.grad.numpy(), np.asarray(des_j), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(ed_t.grad.numpy(), np.asarray(ded_j), rtol=1e-4, atol=1e-4)
    else:
        elog = rng.randn(len(row)).astype(np.float32)
        elog[::50] = -np.inf
        out_j, vjp = jax.vjp(
            lambda lg, xx: jatt.attention_spmm(jg, lg, xx, True),
            _jax_slots(jg, elog, -np.inf), jnp.asarray(x),
        )
        dlog_j, dx_j = vjp(jnp.asarray(cot))
        lg_t = _port_edges(tg, elog).requires_grad_(True)
        lg = lg_t.detach()
        mx, sm = tatt.softmax_stats(tg.row_ptr, lg)
        out_t = tatt.attention_spmm(tg, lg_t, x_t)
        out_t.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(
            _port_to_edges(tg, lg_t.grad), _jax_to_edges(jg, dlog_j), rtol=1e-4, atol=1e-5
        )
    # JAX rounds the forward weights to bf16
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    # dx[c] sums w * g over c's in-edges (1,100 at a hub column, with much
    # cancellation). JAX rounds each weight and each product to bf16, so its
    # error follows the sum of the terms' magnitudes, not of the terms: the
    # small graph's 2e-2 is taken relative to that sum. The port's dx (f32
    # weights times bf16 g, f32 sums) is held against an f64 sum of the
    # same terms at 1e-4 of it (f32 sums of up to 1,100 terms).
    w = tatt.edge_weights(tg, lg, mx, sm).numpy().astype(np.float64)
    g16 = torch.from_numpy(cot).bfloat16().double().numpy()[tg.row.numpy()]
    want, mag = np.zeros((n, 16)), np.zeros((n, 16))
    np.add.at(want, tg.col.numpy(), w[:, None] * g16)
    np.add.at(mag, tg.col.numpy(), np.abs(w[:, None] * g16))
    dx_t = x_t.grad.numpy()
    assert np.all(np.abs(dx_t - want) <= 1e-4 * (1 + mag))
    assert np.all(np.abs(dx_t - np.asarray(dx_j)) <= 2e-2 * (1 + mag))


def test_gat_attention_forward_and_grads_match_jax_vjp():
    row, col, val, n = _graph(seed=12, symmetric=True)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(13)
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    x = rng.randn(n, 24).astype(np.float32)
    cot = rng.randn(n, 24).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda a, b, c: jatt.gat_attention(jg, a, b, c, SLOPE, True),
        jnp.asarray(es), jnp.asarray(ed), jnp.asarray(x),
    )
    des_j, ded_j, dx_j = vjp(jnp.asarray(cot))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (es, ed, x)]
    out_t = tatt.gat_attention(tg, *args, SLOPE)
    out_t.backward(torch.from_numpy(cot))

    # JAX rounds the forward weights, and the products of its dx pass, to bf16
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(args[2].grad.numpy(), np.asarray(dx_j), rtol=2e-2, atol=2e-2)
    # des and ded: both take f32 weights from the stats and u from the same
    # bf16 g and x (exact products); f32 sums in another order
    np.testing.assert_allclose(args[0].grad.numpy(), np.asarray(des_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(args[1].grad.numpy(), np.asarray(ded_j), rtol=1e-4, atol=1e-4)


def test_attention_spmm_forward_and_grads_match_jax_vjp():
    row, col, val, n = _graph(seed=14)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(15)
    elog = rng.randn(len(row)).astype(np.float32)
    elog[::50] = -np.inf  # dropped edges
    x = rng.randn(n, 16).astype(np.float32)
    cot = rng.randn(n, 16).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda lg, xx: jatt.attention_spmm(jg, lg, xx, True),
        _jax_slots(jg, elog, -np.inf), jnp.asarray(x),
    )
    dlog_j, dx_j = vjp(jnp.asarray(cot))
    lg_t = _port_edges(tg, elog).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out_t = tatt.attention_spmm(tg, lg_t, x_t)
    out_t.backward(torch.from_numpy(cot))

    # bf16 weights and dx products on the JAX side only
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(dx_j), rtol=2e-2, atol=2e-2)
    # dlogits = wt * (u - S): f32 on both sides from the same bf16 inputs
    np.testing.assert_allclose(
        _port_to_edges(tg, lg_t.grad), _jax_to_edges(jg, dlog_j), rtol=1e-4, atol=1e-5
    )


def test_gat_attention_matches_its_segment_oracle_in_f32():
    """With bf16-representable features and cotangent, the kernel path's
    casts are exact: the op and its three gradients equal the plain segment
    layout under autograd up to f32 sums in another order."""
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.models.gat import gat_attention_segment

    row, col, val, n = _graph(seed=16, symmetric=True)
    tg = tatt.AttentionGraph.from_coo(row, col, val, n, device=CPU)
    sg = SparseGraph.from_coo(row, col, val.astype(np.float32), n, device=CPU)
    gen = torch.Generator().manual_seed(0)
    es, ed = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    x = torch.randn(n, 12, generator=gen).bfloat16().float()
    cot = torch.randn(n, 12, generator=gen).bfloat16().float()
    a = [t.clone().requires_grad_(True) for t in (es, ed, x)]
    b = [t.clone().requires_grad_(True) for t in (es, ed, x)]
    out_a, out_b = tatt.gat_attention(tg, *a), gat_attention_segment(sg, *b)
    torch.testing.assert_close(out_a, out_b, rtol=1e-4, atol=1e-5)
    out_a.backward(cot)
    out_b.backward(cot)
    for p, q in zip(a, b):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-5)


def test_gat_attention_backward_takes_the_leaky_slope_from_the_base_sign():
    """An edge whose pre-activation ``es[r] + ed[c]`` is a tiny negative
    number: its leaky value vanishes beside log(val) in the f32 logit, so
    the sign cannot be read back from ``logit - log(val)`` (which is 0:
    JAX's ``_gat_bwd`` then takes slope 1). The backward takes it from the
    pre-activation itself, as the segment oracle's autograd does."""
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.models.gat import gat_attention_segment

    row, col, val, n = _graph(seed=16, symmetric=True)
    tg = tatt.AttentionGraph.from_coo(row, col, val, n, device=CPU)
    sg = SparseGraph.from_coo(row, col, val.astype(np.float32), n, device=CPU)
    gen = torch.Generator().manual_seed(1)
    es, ed = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    r, c = int(tg.row[0]), int(tg.col[0])
    ed[c], es[r] = 0.5, -0.5 - 2.0 ** -24  # base = -2^-24, leaky ~ -1.2e-8
    assert float(tg.logval[0]) < -1.0
    x = torch.randn(n, 12, generator=gen).bfloat16().float()
    cot = torch.randn(n, 12, generator=gen).bfloat16().float()
    a = [t.clone().requires_grad_(True) for t in (es, ed, x)]
    b = [t.clone().requires_grad_(True) for t in (es, ed, x)]
    tatt.gat_attention(tg, *a).backward(cot)
    gat_attention_segment(sg, *b).backward(cot)
    for p, q in zip(a, b):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-5)
