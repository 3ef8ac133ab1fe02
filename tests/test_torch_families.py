"""The model families of the PyTorch port (SGC, SGC-pre, APPNP, SAGE, GIN,
GCNII) against the JAX package's, on the CPU, and the topic slice through
the trainer, the runner and the CLI.

Forwards and gradients share parameters (``params_from_jax`` of JAX's
init) and run on the same graph in each format: segment and dense in f32
(1e-4 of the largest entry), hybrid at bf16 tolerance (2e-2 of the largest
entry: both packages round the features and tiles to bf16; the JAX residual
also rounds each edge product). On the CPU the port's hybrid runs the plain
versions of K1 and K2, the JAX package's its Pallas kernels in interpret
mode."""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textgcn_tpu import models as jmodels
from textgcn_tpu.graph.normalize import max_symmetrize_coo as j_max_symmetrize
from textgcn_tpu.graph.normalize import sym_normalize_coo as j_sym_normalize
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models.sgc import sgc_precompute as j_sgc_precompute
from textgcn_tpu.text.datasets import DatasetLabels as JLabels
from textgcn_tpu.train import prepare as jprepare
from textgcn_tpu.train import run as jrun
from textgcn_tpu.train import trainer as jtrainer

from torch_tiny_data import build_tiny

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph.reorder import HybridGraph
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.models.family import params_from_jax
from textgcn_tpu_torch.models.sgc import sgc_precompute
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
FAMILIES = ("sgc", "sgc_pre", "appnp", "sage", "gin", "gcnii")
FORMATS = ("segment", "dense", "hybrid")
N, F, H, C = 400, 20, 16, 4
TOL = {"segment": 1e-4, "dense": 1e-4, "hybrid": 2e-2}


def _graph(seed=0):
    """30 hubs linked to 40 nodes each and 100 uniform edges,
    max-symmetrized and sym-normalized, with dense features and 4 classes:
    after the degree sort, 8 tiles and a residual of 44 edges."""
    rng = np.random.RandomState(seed)
    hubs = rng.choice(N, 30, replace=False)
    src = np.r_[np.repeat(hubs, 40), rng.randint(0, N, 100)]
    dst = np.r_[rng.randint(0, N, 30 * 40), rng.randint(0, N, 100)]
    keep = src != dst
    r, c, v = j_max_symmetrize(src[keep], dst[keep], rng.rand(keep.sum()) + 0.1, N)
    r, c, v = j_sym_normalize(r, c, v, N)
    x = rng.rand(N, F).astype(np.float32)
    return r, c, v, x, rng.randint(0, C, N)


@pytest.fixture(scope="module")
def prepared():
    """Each package's PreparedData of :func:`_graph`, in each format."""
    r, c, v, x, target = _graph()
    idx = np.arange(N)
    common = dict(features=x, n_feat=F, num_docs=N, num_topics=0)
    names = [f"c{i}" for i in range(C)]
    pt = tprepare.PreparedData(
        graph=SparseGraph.from_coo(r, c, v, N, device=CPU),
        labels=DatasetLabels(target, names, idx[:300], idx[300:]), **common,
    )
    pj = jprepare.PreparedData(
        graph=JSparseGraph.from_coo(r, c, v, N),
        labels=JLabels(target, names, idx[:300], idx[300:]), **common,
    )
    out = {}
    for fmt in FORMATS:
        out[fmt] = tprepare.apply_spmm_format(pt, fmt), jprepare.apply_spmm_format(pj, fmt)
    h = out["hybrid"][0].graph
    assert isinstance(h, HybridGraph) and h.bsr.nnzb > 0 and h.rest is not None
    np.testing.assert_array_equal(out["hybrid"][0].perm, out["hybrid"][1].perm)
    return out


def _jax_init(family, n_feat, seed=0):
    init, _ = jmodels.MODELS[family]
    return jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(seed), n_feat, H, C)
    )


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(float(np.abs(want).max()), 1e-6), err_msg=what
    )


@pytest.mark.parametrize("family", [*FAMILIES, "gcn", "gat"])
def test_params_from_jax_round_trips(family):
    """JAX's init → ``params_from_jax`` → the family's module → back to the
    JAX pytree, unchanged; and the port's own init has JAX's names and
    shapes."""
    pj = _jax_init(family, F)
    flat = params_from_jax(pj, device=CPU)
    model = MODELS[family](F, H, C, device=CPU)
    model.load_state_dict(flat)
    back = {}
    for key, t in model.state_dict().items():
        layer, leaf = key.split(".")
        back.setdefault(layer, {})[leaf] = t.numpy()
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(pj)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_array_equal(a, b)
    own = MODELS[family](
        F, H, C, device=CPU, generator=torch.Generator().manual_seed(0)
    ).state_dict()
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in flat.items()
    }


@pytest.mark.parametrize("features", ["identity", "dense"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_and_gradients_match_jax(family, fmt, features, prepared):
    """Logits of all nodes and the gradient of each parameter of
    ``sum(logits * cot)`` (no dropout), from shared parameters; sgc_pre with
    identity features raises on both sides."""
    pt, pj = prepared[fmt]
    x = None if features == "identity" else pt.features
    n_feat = N if x is None else F
    params_np = _jax_init(family, n_feat)
    _, j_forward = jmodels.MODELS[family]
    cot = np.random.RandomState(1).randn(N, C).astype(np.float32)
    if family == "sgc_pre" and x is None:
        with pytest.raises(ValueError, match="precomputed"):
            j_forward(params_np, pj.graph, None)
        with pytest.raises(ValueError, match="precomputed"):
            MODELS[family].forward_params(params_from_jax(params_np, device=CPU), pt.graph, None)
        return
    xj = None if x is None else jnp.asarray(x)
    want, vjp = jax.vjp(lambda p: j_forward(p, pj.graph, xj, train=False), params_np)
    (want_grads,) = vjp(jnp.asarray(cot))
    model = MODELS[family](n_feat, H, C, device=CPU)
    model.load_state_dict(params_from_jax(params_np, device=CPU))
    model.eval()
    got = model(pt.graph, None if x is None else torch.from_numpy(x))
    (got * torch.from_numpy(cot)).sum().backward()
    tol = TOL[fmt]
    _close(got.detach(), want, tol, "logits")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for layer, leaves in want_grads.items():
        for leaf, g in leaves.items():
            _close(grads[f"{layer}.{leaf}"], g, tol, f"d {layer}.{leaf}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_sgc_precompute_equals_jax(fmt, prepared):
    pt, pj = prepared[fmt]
    got = sgc_precompute(pt.graph, torch.from_numpy(pt.features))
    want = j_sgc_precompute(pj.graph, pj.features)
    _close(got, want, TOL[fmt], "Â²X")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return build_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize(
    "family,fmt", [("gcn", "segment"), ("gcnii", "segment"), ("gcnii", "hybrid")]
)
def test_trainer_matches_jax_trainer_per_epoch(family, fmt, tiny_root):
    """The tiny topic graph, prepared by each package, 6 epochs at dropout 0
    from JAX's init: per-epoch train loss, val loss and val acc within 1e-4
    relative (f32) or 2e-2 (hybrid, bf16), and the test accuracy."""
    pt = tprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4, device=CPU)
    pj = jprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4)
    np.testing.assert_array_equal(pt.features, pj.features)
    pt, pj = tprepare.apply_spmm_format(pt, fmt), jprepare.apply_spmm_format(pj, fmt)
    kw = dict(n_hidden=H, dropout=0.0, max_epoch=6, early_stopping=100, seed=7, spmm=fmt,
              model=family)
    jt = jtrainer.Trainer(
        pj.graph, pj.features, pj.labels.target, pj.labels.train_idx, pj.labels.test_idx,
        pj.labels.n_classes, config=jtrainer.TrainConfig(epoch_block=6, **kw),
    )
    jt.fit(verbose=False)
    # the JAX trainer's init: split PRNGKey(seed), init from the second key
    _, init_key = jax.random.split(jax.random.PRNGKey(7))
    init, _ = jmodels.MODELS[family]
    params = jax.tree_util.tree_map(np.asarray, init(init_key, pt.n_feat, H, pt.labels.n_classes))
    tt = ttrainer.Trainer(
        pt.graph, pt.features, pt.labels.target, pt.labels.train_idx, pt.labels.test_idx,
        pt.labels.n_classes, config=ttrainer.TrainConfig(**kw), device=CPU,
    )
    tt.fit(verbose=False, params=params_from_jax(params, device=CPU))
    rtol = 2e-2 if fmt == "hybrid" else 1e-4
    assert len(tt.history) == len(jt.history) == 6
    for a, b in zip(tt.history, jt.history):
        for k in ("train_loss", "val_loss", "acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tt.test()["acc"], jt.test()["acc"], rtol=rtol)


def test_restore_best_hands_back_the_best_epoch(tiny_root, tmp_path):
    """``restore_best=True``: after fit the model holds the params of the
    lowest-val-loss epoch, bit-equal to a run stopped at that epoch (the CPU
    run is deterministic); without it, the last epoch's. The report's
    hyperparameters carry ``restore_best`` as the JAX schema does."""
    pre = tprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4, device=CPU)
    # a large step makes the val loss overshoot, so the best epoch is early
    kw = dict(n_hidden=H, lr=1.0, max_epoch=12, early_stopping=100, seed=3)

    def fit(**over):
        t = ttrainer.Trainer(
            pre.graph, pre.features, pre.labels.target, pre.labels.train_idx,
            pre.labels.test_idx, pre.labels.n_classes,
            config=ttrainer.TrainConfig(**{**kw, **over}), device=CPU,
        )
        t.fit(verbose=False)
        return t

    best = fit(restore_best=True)
    losses = [r["val_loss"] for r in best.history]
    b = int(np.argmin(losses))
    assert len(losses) == 12 and b < 11
    last = fit()
    stopped = fit(max_epoch=b + 1)
    for k, v in best.model.state_dict().items():
        assert torch.equal(v, stopped.model.state_dict()[k]), k
    assert any(
        not torch.equal(v, last.model.state_dict()[k]) for k, v in best.model.state_dict().items()
    )
    summary = trun.run_experiment(
        "tiny", config=ttrainer.TrainConfig(max_epoch=2, restore_best=True), seeds=[1],
        pre_data=pre, output_dir=str(tmp_path), verbose=False, device=CPU,
    )
    assert summary["hyperparameters"]["restore_best"] is True
    with open("results/R8_topic_training_results.json", encoding="utf-8") as f:
        ref = json.load(f)["hyperparameters"]  # written by the JAX package
    # every JAX hyperparameter, epoch_block too (accepted, no effect)
    assert set(summary["hyperparameters"]) == set(ref)


def _cli_on_cpu(monkeypatch):
    """Let ``cli.main`` run on the CPU: it sees a CUDA device and its
    ``run_experiment`` is given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        cli, "run_experiment", lambda *a, **k: trun.run_experiment(*a, **{**k, "device": "cpu"})
    )


@pytest.mark.parametrize("family", sorted(MODELS))
def test_cli_trains_every_family_on_the_topic_graph(family, tiny_root, tmp_path, monkeypatch):
    """``train --dataset tiny`` with no ``--graph`` trains the topic graph
    for each family and writes ``tiny_topic_training_results.json`` (named by
    graph family, as the JAX package names it) with the JAX schema."""
    _cli_on_cpu(monkeypatch)
    rc = cli.main([
        "train", "--dataset", "tiny", "--data_root", tiny_root, "--model", family,
        "--max_epoch", "3", "--nhid", "8", "--seeds", "5", "11", "--quiet",
        "--output_dir", str(tmp_path),
    ])
    assert rc == 0
    with open(tmp_path / "tiny_topic_training_results.json", encoding="utf-8") as f:
        got = json.load(f)
    with open("results/R8_topic_training_results.json", encoding="utf-8") as f:
        ref = json.load(f)  # written by the JAX package
    assert set(ref) <= set(got)
    for part in ("test_accuracy", "train_time"):
        assert set(ref[part]) == set(got[part])
    assert set(ref["runs"][0]) == set(got["runs"][0])
    assert set(ref["runs"][0]["test"]) == set(got["runs"][0]["test"])
    assert set(ref["runs"][0]["history"][0]) == set(got["runs"][0]["history"][0])
    assert got["graph_family"] == "topic" and got["hyperparameters"]["model"] == family
    assert [r["seed"] for r in got["runs"]] == [5, 11]
    assert all(r["epochs_run"] == 3 for r in got["runs"])
    assert 0.0 <= got["test_accuracy"]["mean"] <= 1.0


def test_sgc_pre_raises_on_identity_features_with_jax_message(tiny_root):
    pre = tprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4, device=CPU)
    pre = dataclasses.replace(pre, features=None)
    with pytest.raises(ValueError, match="use --model sgc instead"):
        trun.run_experiment(
            "tiny", config=ttrainer.TrainConfig(model="sgc_pre"), pre_data=pre, device=CPU
        )
    with pytest.raises(ValueError, match="use --model sgc instead"):
        jrun.run_experiment(
            "tiny", config=jtrainer.TrainConfig(model="sgc_pre"),
            pre_data=jprepare.PreparedData(**{
                f.name: getattr(pre, f.name) for f in dataclasses.fields(jprepare.PreparedData)
            }),
        )


def test_sharded_topic_run_equals_the_one_rank_run(tiny_root, tmp_path):
    """``run_experiment(n_shards=2, partition="allgather")`` on 2 gloo ranks
    on the tiny topic graph (dense features) trains, and its per-epoch
    losses equal the one-rank run's within 1e-4 relative (the order of f32
    sums), as ``tests/test_torch_sharded.py`` holds the sharded GCN."""
    cfg = ttrainer.TrainConfig(n_hidden=H, max_epoch=8, early_stopping=100, spmm="hybrid")
    runs = []
    for n_shards in (2, 1):
        s = trun.run_experiment(
            "tiny", config=cfg, seeds=[7], data_root=tiny_root, verbose=False,
            n_shards=n_shards, partition="allgather", output_dir=str(tmp_path), device="cpu",
        )
        assert s["sharding"]["n_shards"] == n_shards and s["graph_family"] == "topic"
        runs.append(s["runs"][0])
    two, one = runs
    assert len(two["history"]) == len(one["history"]) == 8
    for a, b in zip(two["history"], one["history"]):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert two["history"][-1]["train_loss"] < two["history"][0]["train_loss"]
