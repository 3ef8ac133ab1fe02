"""The port's learnable-edge ops against the JAX package's, on the CPU.

- ``ops/spmm.py`` ``spmm_coo_segment_ew`` against
  ``textgcn_tpu.ops.spmm.spmm_coo_segment_ew`` (both plain: XLA there,
  PyTorch here);
- ``models/gcn.py`` ``gcn_edge_init`` / ``gcn_edge_forward`` against the JAX
  functions, parameters carried by ``params_from_jax``;
- ``ops/attention.py`` ``edge_logit_base`` and ``spmm_onehot_ew`` against
  ``textgcn_tpu/ops/pallas_attention.py`` in interpret mode, on a small
  graph and on one whose forward and transpose CSRs have split tables
  (the port's wrappers run their plain versions on CPU tensors). JAX keeps
  per-edge values in plan slots and the port in forward-CSR order; the
  mappings are those of ``tests/test_torch_attention.py``.

Inputs are drawn with numpy from a seed. Tolerances are stated at each
assert: where both sides compute in f32 from the same inputs only the order
of f32 sums differs; where JAX rounds to bf16 and the port does not (the
one-hot kernel's products), 2e-2, the JAX package's own bf16 tolerance.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textgcn_tpu.graph.normalize import sym_normalize_coo as j_sym_normalize
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models import gcn as jgcn
from textgcn_tpu.ops import pallas_attention as jatt
from textgcn_tpu.ops.spmm import spmm_coo_segment_ew as j_spmm_ew

from test_torch_attention import (
    _both, _graph, _hub_graph, _jax_slots, _jax_to_edges, _port_edges, _port_to_edges,
)

from textgcn_tpu_torch.graph.structs import DenseGraph, SparseGraph
from textgcn_tpu_torch.models import gcn as tgcn
from textgcn_tpu_torch.models.family import params_from_jax
from textgcn_tpu_torch.ops import attention as tatt
from textgcn_tpu_torch.ops.spmm import spmm_coo_segment_ew

CPU = torch.device("cpu")


def _coo(n=60, e=400, seed=0):
    """A sym-normalized COO with duplicates summed by the normalizer."""
    rng = np.random.RandomState(seed)
    r, c = rng.randint(0, n, e), rng.randint(0, n, e)
    r, c, v = j_sym_normalize(np.r_[r, c], np.r_[c, r], rng.rand(2 * e) + 0.1, n)
    return r, c, v, n, rng


def test_spmm_coo_segment_ew_matches_jax():
    """Forward, dval and dx on a padded COO (padding edges carry row = col =
    n and val 0), against ``jax.vjp`` of the JAX op. Both sides compute in
    f32 (the same products; the segment sums in another order): rtol 1e-5,
    atol 1e-6. dval of a padding edge is 0 on both sides."""
    r, c, v, n, rng = _coo(seed=1)
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=64)
    tg = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=64, device=CPU)
    assert jg.row.shape[0] == tg.row.shape[0] > tg.n_edges
    val = (np.asarray(jg.val) * (0.5 + rng.rand(jg.row.shape[0]))).astype(np.float32)
    x = rng.randn(n, 12).astype(np.float32)
    cot = rng.randn(n, 12).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda vv, xx: j_spmm_ew(jg.row, jg.col, vv, xx, n, True), jnp.asarray(val), jnp.asarray(x)
    )
    dval_j, dx_j = vjp(jnp.asarray(cot))
    val_t = torch.from_numpy(val).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out_t = spmm_coo_segment_ew(tg.row, tg.col, val_t, x_t, n)
    out_t.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(val_t.grad.numpy(), np.asarray(dval_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    assert not val_t.grad[tg.n_edges:].any()


def _edge_params(rng, jg, n_feat, hidden, classes):
    """JAX's ``gcn_edge_init`` with ``edge_logit`` drawn away from 0 (so
    the scale is not 1 and its gradient is generic), as host arrays."""
    params = jgcn.gcn_edge_init(jax.random.PRNGKey(3), jg, n_feat, hidden, classes)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["edge_logit"] = (0.3 * rng.randn(*params["edge_logit"].shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("features", ["identity", "dense"])
def test_gcn_edge_forward_matches_jax(features):
    """Logits and the gradient of ``sum(logits * cot)`` in every parameter,
    ``edge_logit`` included, from the same parameters (``params_from_jax``
    carries ``edge_logit``), with identity and with dense features. Both
    sides compute in f32; the exp and the sums differ in order and last
    bits: logits rtol 1e-5 / atol 1e-6, gradients 1e-4 of each one's
    largest entry."""
    r, c, v, n, rng = _coo(seed=2)
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=64)
    tg = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=64, device=CPU)
    x = None if features == "identity" else rng.randn(n, 10).astype(np.float32)
    n_feat = n if x is None else x.shape[1]
    params = _edge_params(rng, jg, n_feat, 16, 4)
    cot = rng.randn(n, 4).astype(np.float32)
    jx = None if x is None else jnp.asarray(x)

    def loss_j(p):
        return jnp.sum(jgcn.gcn_edge_forward(p, jg, jx, train=False) * cot)

    logits_j = np.asarray(jgcn.gcn_edge_forward(params, jg, jx, train=False))
    grads_j = jax.grad(loss_j)(jax.tree_util.tree_map(jnp.asarray, params))
    tp = {k: t.requires_grad_(True) for k, t in params_from_jax(params, device=CPU).items()}
    assert sorted(tp) == ["edge_logit", "gc1.b", "gc1.w", "gc2.b", "gc2.w"]
    tx = None if x is None else torch.from_numpy(x)
    logits_t = tgcn.gcn_edge_forward(tp, tg, tx, train=False)
    (logits_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(logits_t.detach().numpy(), logits_j, rtol=1e-5, atol=1e-6)
    want = {"edge_logit": grads_j["edge_logit"]}
    want.update({f"{k}.{leaf}": grads_j[k][leaf] for k in ("gc1", "gc2") for leaf in ("w", "b")})
    for k, g in want.items():
        g = np.asarray(g)
        np.testing.assert_allclose(
            tp[k].grad.numpy(), g, rtol=0, atol=1e-4 * np.abs(g).max(), err_msg=k
        )
    assert np.abs(want["edge_logit"]).max() > 0


def test_gcn_edge_init_is_the_fixed_graph_model_and_refuses_other_layouts():
    """``gcn_edge_init`` draws ``gcn_init``'s weights from the same generator
    and one zero ``edge_logit`` per padded COO entry (JAX's shape), so at
    init the learnable-edge logits equal ``gcn_forward``'s (exp(0) = 1:
    bit-equal); a graph that is not a ``SparseGraph`` raises TypeError, as
    in JAX."""
    r, c, v, n, rng = _coo(seed=4)
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=64)
    tg = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=64, device=CPU)
    p = tgcn.gcn_edge_init(torch.Generator().manual_seed(5), tg, 10, 8, 3, device=CPU)
    q = tgcn.gcn_init(torch.Generator().manual_seed(5), 10, 8, 3, device=CPU)
    jp = jgcn.gcn_edge_init(jax.random.PRNGKey(0), jg, 10, 8, 3)
    assert p["edge_logit"].shape == jp["edge_logit"].shape and not p["edge_logit"].any()
    assert all(torch.equal(p[k], q[k]) for k in q)
    x = torch.from_numpy(rng.randn(n, 10).astype(np.float32))
    assert torch.equal(tgcn.gcn_edge_forward(p, tg, x), tgcn.gcn_forward(q, tg, x))
    with pytest.raises(TypeError, match="SparseGraph"):
        tgcn.gcn_edge_forward(p, DenseGraph.from_sparse_graph(tg), x)


def _graphs(kind):
    if kind == "small":
        return _graph(seed=20)
    # forward and transpose CSRs with split tables (rows and columns of up
    # to 1,200 edges, beyond K2's S)
    return _hub_graph(seed=21, hub_cols=True)


@pytest.mark.parametrize("kind", ["small", "split"])
def test_edge_logit_base_matches_jax(kind):
    """``edge_logit_base`` forward and its scatter-free backward against
    the JAX op (``rowsum_slots`` in interpret mode). The forward is one f32
    add per edge on both sides: bit-equal. des and ded are f32 row sums of
    the same cotangent in another order (over the split tables' segments
    on the port's side): rtol 1e-5, atol 1e-5."""
    row, col, val, n = _graphs(kind)
    tg, jg = _both(row, col, val, n)
    if kind == "split":
        assert tg.split is not None and tg.split_t is not None
    rng = np.random.RandomState(22)
    es, ed = rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)
    cot = rng.randn(len(row)).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda a, b: jatt.edge_logit_base(jg, a, b, True), jnp.asarray(es), jnp.asarray(ed)
    )
    des_j, ded_j = vjp(_jax_slots(jg, cot, 0.0))
    es_t, ed_t = (torch.from_numpy(a).requires_grad_(True) for a in (es, ed))
    out_t = tatt.edge_logit_base(tg, es_t, ed_t)
    out_t.backward(_port_edges(tg, cot))
    np.testing.assert_array_equal(_port_to_edges(tg, out_t.detach()), _jax_to_edges(jg, out_j))
    np.testing.assert_allclose(es_t.grad.numpy(), np.asarray(des_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ed_t.grad.numpy(), np.asarray(ded_j), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="edge_logit_base"):
        tatt.edge_logit_base(tg, es_t[:-1], ed_t)


def _f64_sum(tg, val, a, transpose=False):
    """``A @ a`` (``Aᵀ @ a``) in f64 over the bf16-rounded ``a``, and the
    sum of its terms' magnitudes, per output row."""
    rows, cols = tg.row.numpy(), tg.col.numpy()
    if transpose:
        rows, cols = cols, rows
    terms = val.astype(np.float64)[:, None] * torch.from_numpy(a).bfloat16().double().numpy()[cols]
    want, mag = np.zeros((tg.n_nodes, a.shape[1])), np.zeros((tg.n_nodes, a.shape[1]))
    np.add.at(want, rows, terms)
    np.add.at(mag, rows, np.abs(terms))
    return want, mag


@pytest.mark.parametrize("kind", ["small", "split"])
def test_spmm_onehot_ew_matches_jax(kind):
    """``spmm_onehot_ew`` forward, dx and dval against the JAX op in
    interpret mode. Forward and dx: the port (K2's plain version: f32 val
    times bf16 x, f32 sums) is held against an f64 sum of the same terms at
    1e-5 of the sum of their magnitudes; JAX rounds each product of the
    one-hot kernel to bf16, so its error follows that sum too, and the two
    agree within 2e-2 of it (the JAX package's bf16 tolerance, as
    ``tests/test_torch_attention.py`` holds the hub graph's dx). dval: both
    take g[row] . x[col] from the same bf16 g and x, exact products summed
    in f32 in another order: rtol 1e-4, atol 1e-5."""
    row, col, val, n = _graphs(kind)
    tg, jg = _both(row, col, val, n)
    rng = np.random.RandomState(23)
    ev = (rng.rand(len(row)) + 0.1).astype(np.float32)
    x = rng.randn(n, 20).astype(np.float32)
    cot = rng.randn(n, 20).astype(np.float32)

    out_j, vjp = jax.vjp(
        lambda vv, xx: jatt.spmm_onehot_ew(jg, vv, xx, True), _jax_slots(jg, ev, 0.0),
        jnp.asarray(x),
    )
    dval_j, dx_j = vjp(jnp.asarray(cot))
    val_t = _port_edges(tg, ev).requires_grad_(True)
    x_t = torch.from_numpy(x).requires_grad_(True)
    out_t = tatt.spmm_onehot_ew(tg, val_t, x_t)
    out_t.backward(torch.from_numpy(cot))
    assert out_t.shape == (n, 20)
    val_csr = val_t.detach().numpy()
    for got, want_j, (want, mag) in (
        (out_t.detach().numpy(), np.asarray(out_j)[:n], _f64_sum(tg, val_csr, x)),
        (x_t.grad.numpy(), np.asarray(dx_j), _f64_sum(tg, val_csr, cot, transpose=True)),
    ):
        assert np.all(np.abs(got - want) <= 1e-5 * (1 + mag))
        assert np.all(np.abs(got - want_j) <= 2e-2 * (1 + mag))
    np.testing.assert_allclose(
        _port_to_edges(tg, val_t.grad), _jax_to_edges(jg, dval_j), rtol=1e-4, atol=1e-5
    )
    with pytest.raises(ValueError, match="spmm_onehot_ew"):
        tatt.spmm_onehot_ew(tg, val_t[:-1], x_t)
