"""The port's GAT (textgcn_tpu_torch/models/gat.py, its data prep, trainer
and CLI) against the JAX package's, on the CPU, with shared parameters
(JAX init converted by ``params_from_jax``) and shared numpy inputs.

The kernel layout runs the port's plain PyTorch versions here and JAX's
Pallas kernels in interpret mode. Tolerances: f32-tight (rtol 1e-4) on the
segment layout, where both sides compute in f32; 2e-2, the JAX package's own
bf16 tolerance, where bf16 rounding enters (the dense layout's weights and
features, the kernel layout's features, and JAX's bf16 weights there).
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models import gat as jgat
from textgcn_tpu.ops.pallas_attention import AttentionGraph as JAttentionGraph
from textgcn_tpu.text.datasets import DatasetLabels as JLabels
from textgcn_tpu.train import prepare as jprepare
from textgcn_tpu.train import trainer as jtrainer

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.reorder import HybridGraph
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import gat as tgat
from textgcn_tpu_torch.ops.attention import AttentionGraph
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
N_DOCS, N_WORDS, N_CLASSES = 160, 500, 4


def _normalized(n=150, e=1500, seed=0):
    """Sym-normalized (coalesced) power-law graph with self-loops."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -1.0
    p /= p.sum()
    r, c, v = max_symmetrize_coo(rng.choice(n, e, p=p), rng.randint(0, n, e), rng.rand(e), n)
    r, c, v = sym_normalize_coo(r, c, v, n)
    return r, c, v.astype(np.float32).astype(np.float64), n


def _layouts(layout, r, c, v, n):
    """(port graph, JAX graph) of one GAT layout for the same COO."""
    if layout == "kernel":
        return (
            AttentionGraph.from_coo(r, c, v, n, device=CPU),
            JAttentionGraph.from_coo(r, c, v, n, w=8, k=128),
        )
    gt = SparseGraph.from_coo(r, c, v, n, pad_to_multiple=256, device=CPU)
    gj = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    if layout == "dense":
        return (
            tgat.DenseAttentionGraph.from_sparse_graph(gt),
            jgat.DenseAttentionGraph.from_sparse_graph(gj),
        )
    return gt, gj


def _jax_params(n_feat, n_hidden=16, n_class=4, seed=0):
    p = jgat.gat_init(jax.random.PRNGKey(seed), n_feat, n_hidden, n_class)
    return jax.tree_util.tree_map(np.asarray, p)


TOL = {"segment": 1e-4, "dense": 2e-2, "kernel": 2e-2}


def test_params_from_jax_round_trip_and_init():
    pj = _jax_params(30)
    pt = tgat.params_from_jax(pj, device=CPU)
    assert set(pt) == {f"{l}.{k}" for l in tgat.LAYERS for k in tgat.KEYS}
    model = tgat.GAT(30, 16, 4, device=CPU)
    model.load_state_dict(pt)
    for k, v in model.state_dict().items():
        layer, key = k.split(".")
        np.testing.assert_array_equal(v.numpy(), pj[layer][key])
    p = tgat.gat_init(torch.Generator().manual_seed(0), 50, 16, 4, device=CPU)
    assert p["gat1.w"].shape == (50, 16) and p["gat2.a_dst"].shape == (4,)
    assert float(p["gat1.a_src"].abs().max()) <= 1 / np.sqrt(16)
    assert float(p["gat2.w"].abs().max()) <= 1 / np.sqrt(4)
    # drawn in the order w, b, a_src, a_dst per layer
    gen = torch.Generator().manual_seed(0)
    w = torch.empty(50, 16).uniform_(-0.25, 0.25, generator=gen)
    torch.testing.assert_close(p["gat1.w"], w)


@pytest.mark.parametrize("layout", ["segment", "dense", "kernel"])
@pytest.mark.parametrize("identity", [True, False])
def test_gat_forward_matches_jax(layout, identity):
    r, c, v, n = _normalized(seed=1)
    gt, gj = _layouts(layout, r, c, v, n)
    x = None if identity else np.random.RandomState(2).randn(n, 20).astype(np.float32)
    pj = _jax_params(n if identity else 20)
    got = tgat.gat_forward(
        tgat.params_from_jax(pj, device=CPU), gt,
        None if x is None else torch.from_numpy(x),
    )
    want = jgat.gat_forward(pj, gj, None if x is None else jnp.asarray(x))
    tol = TOL[layout]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("layout", ["segment", "kernel"])
def test_gat_masked_loss_gradients_match_jax(layout):
    r, c, v, n = _normalized(seed=3)
    gt, gj = _layouts(layout, r, c, v, n)
    pj = _jax_params(n, seed=4)
    y = np.random.RandomState(5).randint(0, 4, n)
    idx = np.random.RandomState(6).choice(n, 60, replace=False)

    def j_loss(p):
        logits = jgat.gat_forward(p, gj, None)[idx]
        return jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, y[idx]))

    g_j = jax.grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, pj))
    pt = {k: t.requires_grad_(True) for k, t in tgat.params_from_jax(pj, device=CPU).items()}
    loss = F.cross_entropy(tgat.gat_forward(pt, gt, None)[idx], torch.from_numpy(y[idx]))
    loss.backward()
    tol = TOL[layout]
    np.testing.assert_allclose(loss.item(), float(j_loss(pj)), rtol=tol)
    for name, t in pt.items():
        layer, k = name.split(".")
        np.testing.assert_allclose(
            t.grad.numpy(), np.asarray(g_j[layer][k]), rtol=tol, atol=tol * 1e-2,
            err_msg=name,
        )


def test_attention_layouts_reject_duplicate_edges():
    r, c, v, n = _normalized(seed=7)
    g = SparseGraph.from_coo(np.r_[r, r[:1]], np.r_[c, c[:1]], np.r_[v, v[:1]], n, device=CPU)
    with pytest.raises(ValueError, match="coalesced"):
        tgat.DenseAttentionGraph.from_sparse_graph(g)
    with pytest.raises(ValueError, match="coalesced"):
        AttentionGraph.from_sparse_graph(g)


def test_dense_attention_graph_equals_jax():
    r, c, v, n = _normalized(seed=8)
    gt, gj = _layouts("dense", r, c, v, n)
    np.testing.assert_array_equal(
        gt.loga.float().numpy(), np.asarray(gj.loga.astype(jnp.float32))
    )


def _docword(seed=0):
    """Docs [0, D) then words [D, D+W), each doc linked to Zipf-drawn words
    tilted towards its class, plus word-word links among frequent words."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, N_CLASSES, N_DOCS)
    base = np.arange(1, N_WORDS + 1) ** -0.9
    src, dst = [], []
    for d in range(N_DOCS):
        p = base.copy()
        p[target[d] :: N_CLASSES] *= 4.0
        words = rng.choice(N_WORDS, size=15, p=p / p.sum())
        src += [d] * len(words)
        dst += list(N_DOCS + words)
    ww = rng.choice(40, size=(800, 2)) + N_DOCS
    src += list(ww[:, 0])
    dst += list(ww[:, 1])
    n = N_DOCS + N_WORDS
    r, c, v = max_symmetrize_coo(np.asarray(src), np.asarray(dst), rng.rand(len(src)) + 0.1, n)
    keep = r != c
    r, c, v = sym_normalize_coo(r[keep], c[keep], v[keep], n)
    idx = rng.permutation(N_DOCS)
    return r, c, v, n, target, np.sort(idx[:110]), np.sort(idx[110:])


def _prepared(seed=0):
    r, c, v, n, target, tr, te = _docword(seed)
    common = dict(features=None, n_feat=n, num_docs=N_DOCS, num_topics=0)
    names = [f"c{i}" for i in range(N_CLASSES)]
    pt = tprepare.PreparedData(
        graph=SparseGraph.from_coo(r, c, v, n, device=CPU),
        labels=DatasetLabels(target, names, tr, te), **common,
    )
    pj = jprepare.PreparedData(
        graph=JSparseGraph.from_coo(r, c, v, n),
        labels=JLabels(target, names, tr, te), **common,
    )
    return pt, pj


@pytest.mark.parametrize("degree_sort", [True, False])
def test_apply_attention_format_equals_jax(degree_sort):
    pt, pj = _prepared()
    at = tprepare.apply_attention_format(pt, degree_sort=degree_sort)
    aj = jprepare.apply_attention_format(pj, degree_sort=degree_sort)
    assert isinstance(at.graph, AttentionGraph)
    if degree_sort:
        np.testing.assert_array_equal(at.perm, aj.perm)
    else:
        assert at.perm is None and aj.perm is None
    for k in ("target", "train_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(at.labels, k), getattr(aj.labels, k))
    # the same edges, row by row: JAX's plan slots mapped back to edges
    g = at.graph
    rows = g.row.numpy().astype(np.int64)
    plan = aj.graph.fwd
    lrow = np.asarray(plan.lrow).reshape(plan.n_sc, plan.c_sc, plan.k)
    win = (np.arange(plan.n_sc)[:, None] * plan.w_sc + np.asarray(plan.wloc))[:, :, None]
    jrow = (win * plan.w + lrow).reshape(-1)
    real = lrow.reshape(-1) < plan.w
    jrow, jcol = jrow[real], np.asarray(plan.col).reshape(-1)[real].astype(np.int64)
    o = np.lexsort((jcol, jrow))
    np.testing.assert_array_equal(rows, jrow[o])
    np.testing.assert_array_equal(g.col.numpy(), jcol[o])
    np.testing.assert_allclose(
        g.logval.numpy(), np.log(np.asarray(plan.val).reshape(-1)[real][o]), rtol=1e-6
    )
    assert tprepare.apply_attention_format(at) is at  # already converted


def test_gat_trainer_matches_jax_trainer_per_epoch():
    """The slice as a whole: 3 epochs on the degree-sorted kernel layout,
    dropout 0, shared init. Per-epoch train loss, val loss and val acc
    agree at the bf16 tolerance (JAX rounds the aggregation weights and the
    dx products to bf16, the port does not); the loss falls and every
    parameter moves."""
    pt, pj = _prepared(seed=1)
    pt = trun.apply_gat_format(pt, "hybrid")
    pj = jprepare.apply_attention_format(pj, degree_sort=True)
    kw = dict(n_hidden=16, dropout=0.0, max_epoch=3, seed=7, spmm="hybrid", model="gat")
    jt = jtrainer.Trainer(
        pj.graph, None, pj.labels.target, pj.labels.train_idx,
        pj.labels.test_idx, N_CLASSES,
        config=jtrainer.TrainConfig(epoch_block=3, **kw),
    )
    jt.fit(verbose=False)
    _, init_key = jax.random.split(jax.random.PRNGKey(7))
    params = tgat.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgat.gat_init(init_key, pt.n_nodes, 16, N_CLASSES)),
        device=CPU,
    )
    tt = ttrainer.Trainer(
        pt.graph, None, pt.labels.target, pt.labels.train_idx,
        pt.labels.test_idx, N_CLASSES, config=ttrainer.TrainConfig(**kw), device=CPU,
    )
    tt.fit(verbose=False, params={k: t.clone() for k, t in params.items()})
    assert len(tt.history) == len(jt.history) == 3
    for a, b in zip(tt.history, jt.history):
        for k in ("train_loss", "val_loss", "acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-2, err_msg=k)
    losses = [h["train_loss"] for h in tt.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for k, t in tt.model.state_dict().items():
        assert not torch.equal(t, params[k]), k


def test_gat_trainer_with_dropout_trains_on_every_layout():
    pt, _ = _prepared(seed=2)
    for fmt, kind in (
        ("hybrid", AttentionGraph), ("onehot", AttentionGraph),
        ("dense", tgat.DenseAttentionGraph), ("segment", SparseGraph),
    ):
        p = trun.apply_gat_format(pt, fmt)
        assert isinstance(p.graph, kind), fmt
        tr = ttrainer.Trainer(
            p.graph, None, p.labels.target, p.labels.train_idx, p.labels.test_idx,
            N_CLASSES, config=ttrainer.TrainConfig(
                n_hidden=16, max_epoch=5, seed=3, model="gat", spmm=fmt),
            device=CPU,
        )
        tr.fit(verbose=False)
        losses = [h["train_loss"] for h in tr.history]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0], fmt
        assert 0.0 <= tr.test()["acc"] <= 1.0


def test_model_and_format_checks(tmp_path, monkeypatch):
    pt, _ = _prepared(seed=3)
    hybrid = tprepare.apply_spmm_format(pt, "hybrid")
    assert isinstance(hybrid.graph, HybridGraph)
    with pytest.raises(ValueError, match="GAT needs"):
        ttrainer.model_class("gat", hybrid.graph)
    with pytest.raises(ValueError, match="unknown model"):
        ttrainer.model_class("graphormer", pt.graph)
    with pytest.raises(ValueError, match="GAT takes"):
        trun.apply_gat_format(pt, "bsr")
    monkeypatch.setattr(trun, "DENSE_MAX_NODES", 100)
    # above DENSE_MAX_NODES GAT's auto is priced and returns a layout
    assert isinstance(trun.apply_gat_format(pt, "auto").graph, (tgat.DenseAttentionGraph, AttentionGraph))
    cfg = ttrainer.TrainConfig(n_hidden=8, max_epoch=2, model="gat", spmm="onehot")
    summary = trun.run_experiment(
        "toy", graph_family="docword", output_dir=str(tmp_path), config=cfg,
        pre_data=pt, verbose=False, device="cpu",
    )
    assert summary["hyperparameters"] == dataclasses.asdict(cfg)
    assert (tmp_path / "toy_docword_training_results.txt").read_text().startswith(
        "docword GAT training results"
    )


def test_cli_model_and_onehot(monkeypatch):
    args = cli.build_parser().parse_args(
        ["train", "--dataset", "R8", "--model", "gat", "--spmm", "onehot"]
    )
    assert (args.model, args.spmm) == ("gat", "onehot")
    assert cli.build_parser().parse_args(["train", "--dataset", "R8"]).model == "gcn"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["train", "--dataset", "R8", "--model", "graphormer"])
    # GCN through --spmm onehot gets past the format check to the GPU check
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--dataset", "R8", "--graph", "docword", "--spmm", "onehot"])
