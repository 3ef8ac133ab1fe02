"""The PyTorch port's trainer and runner against the JAX package's, on the
CPU: the slice as a whole (a small doc-word-like graph through the hybrid
format, shared init, dropout 0, the same numpy split) and the report schema."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models.gcn import gcn_init as j_init
from textgcn_tpu.text.datasets import DatasetLabels as JLabels
from textgcn_tpu.train import prepare as jprepare
from textgcn_tpu.train import trainer as jtrainer

from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.reorder import HybridGraph
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models.gcn import params_from_jax
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.train.run import run_experiment

CPU = torch.device("cpu")
N_DOCS, N_WORDS, N_CLASSES = 360, 1400, 4


def _docword_coo(seed=0):
    """Docs [0, D) then words [D, D+W): each doc links to words drawn from a
    Zipf-like law tilted towards its class, plus word-word links among the
    frequent words; so the degree-sorted pattern has hub tiles and a tail."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, N_CLASSES, N_DOCS)
    base = np.arange(1, N_WORDS + 1) ** -0.9
    src, dst = [], []
    for d in range(N_DOCS):
        p = base.copy()
        p[target[d] :: N_CLASSES] *= 4.0
        words = rng.choice(N_WORDS, size=20, p=p / p.sum())
        src += [d] * len(words)
        dst += list(N_DOCS + words)
    ww = rng.choice(60, size=(3000, 2)) + N_DOCS
    src += list(ww[:, 0])
    dst += list(ww[:, 1])
    n = N_DOCS + N_WORDS
    r, c, v = max_symmetrize_coo(
        np.asarray(src), np.asarray(dst), rng.rand(len(src)) + 0.1, n
    )
    keep = r != c
    r, c, v = sym_normalize_coo(r[keep], c[keep], v[keep], n)
    idx = rng.permutation(N_DOCS)
    return r, c, v, n, target, np.sort(idx[:250]), np.sort(idx[250:])


def _prepared(seed=0):
    """The same graph and labels as each package's PreparedData."""
    r, c, v, n, target, tr, te = _docword_coo(seed)
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


def test_hybrid_trainer_matches_jax_trainer_per_epoch():
    """3 epochs, dropout 0, shared init: per-epoch train loss, val loss and
    val acc agree (rtol 1e-3: both run bf16 tile and residual legs, and the
    JAX residual also rounds each edge product to bf16)."""
    pt, pj = _prepared()
    pt = tprepare.apply_spmm_format(pt, "hybrid")
    pj = jprepare.apply_spmm_format(pj, "hybrid")
    assert isinstance(pt.graph, HybridGraph) and pt.graph.rest is not None
    assert 0.5 < pt.graph.dense_fraction < 1.0
    np.testing.assert_array_equal(pt.perm, pj.perm)

    kw = dict(n_hidden=16, dropout=0.0, max_epoch=3, seed=7, spmm="hybrid")
    jt = jtrainer.Trainer(
        pj.graph, None, pj.labels.target, pj.labels.train_idx,
        pj.labels.test_idx, N_CLASSES,
        config=jtrainer.TrainConfig(epoch_block=3, **kw),
    )
    jt.fit(verbose=False)
    # the JAX trainer's init: split PRNGKey(seed), init from the second key
    _, init_key = jax.random.split(jax.random.PRNGKey(7))
    params = j_init(init_key, pt.graph.n_nodes, 16, N_CLASSES)
    tt = ttrainer.Trainer(
        pt.graph, None, pt.labels.target, pt.labels.train_idx,
        pt.labels.test_idx, N_CLASSES, config=ttrainer.TrainConfig(**kw),
        device=CPU,
    )
    tt.fit(verbose=False, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), device=CPU))
    assert len(tt.history) == len(jt.history) == 3
    for a, b in zip(tt.history, jt.history):
        for k in ("train_loss", "val_loss", "acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)
    assert tt.history[-1]["train_loss"] < tt.history[0]["train_loss"]
    np.testing.assert_allclose(tt.test()["acc"], jt.test()["acc"], rtol=1e-3)


def test_early_stopping_and_split_equal_jax():
    for seed in (0, 5):
        for a, b in zip(
            ttrainer.train_val_split(np.arange(100, 600), 0.1, seed),
            jtrainer.train_val_split(np.arange(100, 600), 0.1, seed),
        ):
            np.testing.assert_array_equal(a, b)
    losses = [1.0, 0.9, 0.95, 0.91, 0.92, 0.8, 0.85, 0.86, 0.87]
    st, sj = ttrainer.EarlyStopping(3), jtrainer.EarlyStopping(3)
    assert [st(x) for x in losses] == [sj(x) for x in losses]


def test_run_experiment_writes_reports_with_the_jax_schema(tmp_path):
    pt, _ = _prepared(seed=1)
    cfg = ttrainer.TrainConfig(n_hidden=8, max_epoch=4, spmm="hybrid")
    summary = run_experiment(
        "toy", times=2, graph_family="docword", output_dir=str(tmp_path), config=cfg,
        pre_data=pt, verbose=False, device="cpu",
    )
    with open("results/R8_docword_training_results.json", encoding="utf-8") as f:
        ref = json.load(f)  # written by the JAX package
    with open(tmp_path / "toy_docword_training_results.json", encoding="utf-8") as f:
        got = json.load(f)
    assert set(ref) <= set(got)
    assert set(ref["runs"][0]) == set(got["runs"][0])
    assert set(ref["runs"][0]["test"]) == set(got["runs"][0]["test"])
    assert set(ref["runs"][0]["history"][0]) == set(got["runs"][0]["history"][0])
    assert set(ref["test_accuracy"]) == set(got["test_accuracy"])
    assert got["device"] == {"type": "cpu", "name": "cpu"}
    assert got["times"] == 2 and got["device_memory"] == {}
    assert got["hyperparameters"] == dataclasses.asdict(cfg)
    assert summary["runs"][0]["epochs_run"] == 4
    assert os.path.exists(tmp_path / "toy_docword_training_results.txt")
    # as in JAX, any other name only names the reports
    run_experiment("toy", graph_family="wordnet", output_dir=str(tmp_path), config=cfg,
                   pre_data=pt, verbose=False, device="cpu")
    for ext in ("json", "txt"):
        assert os.path.exists(tmp_path / f"toy_wordnet_training_results.{ext}")
    with pytest.raises(ValueError, match="cannot name a report file"):
        run_experiment("toy", graph_family="a/b", pre_data=pt, device="cpu")
