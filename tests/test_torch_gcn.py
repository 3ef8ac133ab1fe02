"""The PyTorch port's GCN model and metrics against the JAX package, with
shared parameters (JAX init converted by ``params_from_jax``) and shared
numpy inputs, on the CPU."""
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.graph.structs import DenseGraph as JDenseGraph
from textgcn_tpu.models.gcn import gcn_forward as j_forward
from textgcn_tpu.models.gcn import graph_conv as j_graph_conv
from textgcn_tpu.models.gcn import gcn_init as j_init
from textgcn_tpu.train import metrics as jmetrics

from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.structs import DenseGraph, SparseGraph
from textgcn_tpu_torch.models.gcn import GCN, gcn_forward, gcn_init, graph_conv, params_from_jax
from textgcn_tpu_torch.train import metrics as tmetrics

CPU = torch.device("cpu")


def _graphs(n=120, e=900, seed=0, fmt="segment"):
    rng = np.random.RandomState(seed)
    r, c, v = max_symmetrize_coo(rng.randint(0, n, e), rng.randint(0, n, e), rng.rand(e), n)
    r, c, v = sym_normalize_coo(r, c, v, n)
    gt = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=256, device=CPU)
    gj = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    if fmt == "dense":
        return DenseGraph.from_sparse_graph(gt), JDenseGraph.from_sparse_graph(gj)
    return gt, gj


def _jax_params(n_feat, n_hidden=16, n_class=4, seed=0):
    p = j_init(jax.random.PRNGKey(seed), n_feat, n_hidden, n_class)
    return jax.tree_util.tree_map(np.asarray, p)


def test_params_from_jax_round_trips_into_the_module():
    pj = _jax_params(30)
    pt = params_from_jax(pj, device=CPU)
    assert set(pt) == {"gc1.w", "gc1.b", "gc2.w", "gc2.b"}
    for layer in ("gc1", "gc2"):
        for k in ("w", "b"):
            np.testing.assert_array_equal(pt[f"{layer}.{k}"].numpy(), pj[layer][k])
    model = GCN(30, 16, 4, device=CPU)
    model.load_state_dict(pt)
    back = {k: v.numpy() for k, v in model.state_dict().items()}
    for k, v in pt.items():
        np.testing.assert_array_equal(back[k], v.numpy())


def test_gcn_init_shapes_and_range():
    gen = torch.Generator().manual_seed(0)
    p = gcn_init(gen, 50, 16, 4, device=CPU)
    assert p["gc1.w"].shape == (50, 16) and p["gc2.b"].shape == (4,)
    assert float(p["gc1.w"].abs().max()) <= 1 / np.sqrt(16)
    assert float(p["gc2.w"].abs().max()) <= 1 / np.sqrt(4)


@pytest.mark.parametrize("fmt", ["segment", "dense"])
@pytest.mark.parametrize("identity", [True, False])
def test_gcn_forward_matches_jax(fmt, identity):
    """Eval-mode logits with shared params: f32 math in another order."""
    n = 120
    gt, gj = _graphs(n=n, fmt=fmt)
    x = None if identity else np.random.RandomState(1).randn(n, 20).astype(np.float32)
    pj = _jax_params(n if identity else 20)
    got = gcn_forward(
        params_from_jax(pj, device=CPU), gt, None if x is None else torch.from_numpy(x)
    )
    want = j_forward(pj, gj, None if x is None else jnp.asarray(x), train=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("fmt", ["segment", "dense"])
def test_graph_conv_matches_jax(fmt):
    """One layer, Â (x W) + b, with JAX's layer dict: f32 math in another
    order (1e-5); the eval-mode GCN is two of them with a ReLU between, bit
    for bit."""
    n = 120
    gt, gj = _graphs(n=n, fmt=fmt)
    x = np.random.RandomState(2).randn(n, 20).astype(np.float32)
    pj = _jax_params(20)
    layer = {k: torch.from_numpy(np.asarray(v)) for k, v in pj["gc1"].items()}
    got = graph_conv(layer, gt, torch.from_numpy(x))
    want = j_graph_conv(pj["gc1"], gj, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    pt = params_from_jax(pj, device=CPU)
    gc2 = {"w": pt["gc2.w"], "b": pt["gc2.b"]}
    assert torch.equal(
        gcn_forward(pt, gt, torch.from_numpy(x)), graph_conv(gc2, gt, torch.relu(got))
    )


def test_masked_cross_entropy_gradients_match_jax():
    n = 120
    gt, gj = _graphs(n=n, seed=3)
    pj = _jax_params(n, seed=2)
    y = np.random.RandomState(4).randint(0, 4, n)
    idx = np.random.RandomState(5).choice(n, 40, replace=False)

    def j_loss(p):
        logits = j_forward(p, gj, None, train=False)[idx]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y[idx]))

    gj_ = jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, pj))
    pt = {k: v.requires_grad_(True) for k, v in params_from_jax(pj, device=CPU).items()}
    loss = F.cross_entropy(gcn_forward(pt, gt, None)[idx], torch.from_numpy(y[idx]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss(pj)), rtol=1e-5)
    for layer in ("gc1", "gc2"):
        for k in ("w", "b"):
            np.testing.assert_allclose(
                pt[f"{layer}.{k}"].grad.numpy(), np.asarray(gj_[layer][k]),
                rtol=1e-4, atol=1e-6,
            )


def test_dropout_is_inverted_and_seeded():
    n = 120
    gt, _ = _graphs(n=n)
    p = params_from_jax(_jax_params(n), device=CPU)
    a = gcn_forward(p, gt, None, dropout=0.5, train=True,
                    generator=torch.Generator().manual_seed(1))
    b = gcn_forward(p, gt, None, dropout=0.5, train=True,
                    generator=torch.Generator().manual_seed(1))
    c = gcn_forward(p, gt, None, dropout=0.5, train=False)
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    """Same logits → same accuracy and reference-convention macro P/R/F1
    (f32; one class never predicted in seed 2)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(200, 5).astype(np.float32)
    if seed == 2:
        logits[:, 3] = -10.0
    target = rng.randint(0, 5, 200)
    lt, tt = torch.from_numpy(logits), torch.from_numpy(target)
    lj, tj = jnp.asarray(logits), jnp.asarray(target)
    np.testing.assert_allclose(
        float(tmetrics.accuracy(lt, tt)), float(jmetrics.accuracy(lj, tj)), rtol=1e-6
    )
    for a, b in zip(tmetrics.macro_f1(lt, tt, 5), jmetrics.macro_f1(lj, tj, 5)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
