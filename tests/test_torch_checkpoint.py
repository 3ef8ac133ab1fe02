"""Checkpoints of the PyTorch port, on the CPU (the counterparts of
``tests/test_checkpoint.py``): ``save_checkpoint`` / ``restore_checkpoint``,
the trainer's ``save``, ``load``, ``save_training_state`` and
``fit(resume_from=)``, the run-level ``resume_training`` and
``evaluate_checkpoint``, and the CLI's ``--save_model``, ``--load_model``,
``--save_state``, ``--resume``, ``--spmm bsr`` and ``--spmm onehot``. The
sharded trainer's checkpoints are ``tests/test_torch_sharded_checkpoint.py``'s.

A resumed run must give an uninterrupted run's bits: on the CPU every op of
an epoch is deterministic, so the histories and params are compared for
equality, with dropout on."""
import dataclasses
import json

import numpy as np
import pytest
import torch

from test_torch_families import _graph
from torch_tiny_data import build_tiny

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

CPU = torch.device("cpu")
H = 16


def _pre(features=True):
    """The families' test graph (400 nodes, 4 classes) as PreparedData, with
    its dense features or identity features."""
    r, c, v, x, target = _graph()
    n = x.shape[0]
    idx = np.arange(n)
    return tprepare.PreparedData(
        graph=SparseGraph.from_coo(r, c, v, n, device=CPU),
        features=x if features else None,
        labels=DatasetLabels(target, [f"c{i}" for i in range(4)], idx[:300], idx[300:]),
        n_feat=x.shape[1] if features else n, num_docs=n, num_topics=0,
    )


def _trainer(pre, **kw):
    cfg = ttrainer.TrainConfig(**{"n_hidden": H, "early_stopping": 1000, "seed": 3, **kw})
    return ttrainer.Trainer(
        pre.graph, pre.features, pre.labels.target, pre.labels.train_idx,
        pre.labels.test_idx, pre.labels.n_classes, config=cfg, device=CPU, perm=pre.perm,
    )


def _params(t):
    return {k: v.clone() for k, v in t.model.state_dict().items()}


def test_save_and_restore_checkpoint_round_trip(tmp_path):
    """A directory holding one ``torch.save`` file, read back with
    ``weights_only=True``: tensors (moved to the CPU), the optimizer state
    and plain metadata, unchanged; a missing checkpoint names its path."""
    params = {"gc1.w": torch.randn(3, 4), "gc1.b": torch.randn(4)}
    opt = torch.optim.Adam([torch.nn.Parameter(torch.randn(2))])
    md = {"epoch": 7, "best_val": float("inf"), "model": "gcn"}
    path = save_checkpoint(str(tmp_path / "ck"), params, opt_state=opt.state_dict(), metadata=md)
    got = restore_checkpoint(path)
    assert set(got) == {"params", "opt_state", "metadata"} and got["metadata"] == md
    for k, v in params.items():
        assert torch.equal(got["params"][k], v)
    assert got["opt_state"]["param_groups"] == opt.state_dict()["param_groups"]
    with pytest.raises(FileNotFoundError, match="missing"):
        restore_checkpoint(str(tmp_path / "missing"))


@pytest.mark.parametrize("features", [True, False], ids=["dense", "identity"])
def test_resume_is_bit_identical_to_an_uninterrupted_run(features, tmp_path):
    """10 epochs, ``save_training_state``, then ``fit(resume_from=)`` to 20:
    the histories put together and the params equal a straight 20-epoch run
    bit for bit, dropout on; the resume skips the init draws and goes on
    with the saved dropout generator."""
    pre = _pre(features)
    straight = _trainer(pre, max_epoch=20)
    straight.fit(verbose=False)
    first = _trainer(pre, max_epoch=10)
    first.fit(verbose=False)
    first.save_training_state(str(tmp_path / "state"))
    md = restore_checkpoint(str(tmp_path / "state"))["metadata"]
    assert {"epoch", "best_val", "stopper_best", "stopper_counter", "stopped", "seed"} <= set(md)
    assert (md["epoch"], md["stopped"], md["seed"]) == (10, 0, 3)
    resumed = _trainer(pre, max_epoch=20)
    resumed.fit(verbose=False, resume_from=str(tmp_path / "state"))
    assert first.history + resumed.history == straight.history
    assert [h["epoch"] for h in resumed.history] == list(range(10, 20))
    for k, v in _params(straight).items():
        assert torch.equal(_params(resumed)[k], v), k


def test_early_stop_counters_survive_the_boundary(tmp_path):
    """A run that stops early after the boundary stops at the same epoch
    when resumed: the stopper's best score and counter are restored."""
    pre = _pre()
    kw = dict(lr=3.0, early_stopping=4, max_epoch=40)
    straight = _trainer(pre, **kw)
    straight.fit(verbose=False)
    n = len(straight.history)
    assert 10 < n < 40, n  # stops early, after the boundary
    first = _trainer(pre, **{**kw, "max_epoch": 10})
    first.fit(verbose=False)
    assert first._live["metadata"]["stopper_counter"] > 0
    first.save_training_state(str(tmp_path / "s"))
    resumed = _trainer(pre, **kw)
    resumed.fit(verbose=False, resume_from=str(tmp_path / "s"))
    assert first.history + resumed.history == straight.history


def test_a_stopped_run_refuses_to_resume_and_restore_best_is_refused(tmp_path):
    pre = _pre()
    stopped = _trainer(pre, lr=1.0, early_stopping=2, max_epoch=40)
    stopped.fit(verbose=False)
    assert len(stopped.history) < 40
    stopped.save_training_state(str(tmp_path / "s"))
    with pytest.raises(ValueError, match="early-stopped"):
        _trainer(pre, max_epoch=60).fit(verbose=False, resume_from=str(tmp_path / "s"))
    live = _trainer(pre, max_epoch=5)
    live.fit(verbose=False)
    live.save_training_state(str(tmp_path / "l"))
    with pytest.raises(ValueError, match="restore_best"):
        _trainer(pre, max_epoch=9, restore_best=True).fit(
            verbose=False, resume_from=str(tmp_path / "l"))


def test_save_training_state_under_restore_best_saves_the_live_params(tmp_path):
    """Under ``restore_best`` the model holds the best epoch's params after
    fit, but the resumable state holds the last epoch's, beside its Adam
    moments."""
    pre = _pre()
    best = _trainer(pre, lr=0.2, max_epoch=12, restore_best=True)
    best.fit(verbose=False)
    last = _trainer(pre, lr=0.2, max_epoch=12)
    last.fit(verbose=False)
    assert any(not torch.equal(v, _params(last)[k]) for k, v in _params(best).items())
    best.save_training_state(str(tmp_path / "s"))
    saved = restore_checkpoint(str(tmp_path / "s"))["params"]
    for k, v in _params(last).items():
        assert torch.equal(saved[k], v), k


def test_run_level_save_resume_and_evaluate(tmp_path):
    """``run_experiment(save_model=, save_state=)`` saves the best-accuracy
    run; ``resume_training`` reads the seed from the checkpoint (not the
    config's) and continues it; ``evaluate_checkpoint`` of the saved params
    gives the run's test metrics exactly."""
    pre = _pre()
    cfg = ttrainer.TrainConfig(n_hidden=H, max_epoch=6, early_stopping=1000)
    out = str(tmp_path / "out")
    summary = trun.run_experiment(
        "toy", config=cfg, seeds=[5, 9], pre_data=pre, output_dir=out, verbose=False,
        save_model=str(tmp_path / "m"), save_state=str(tmp_path / "s"), device=CPU,
    )
    best = max(summary["runs"], key=lambda r: r["test"]["acc"])
    assert summary["checkpoint"] == str(tmp_path / "m")
    assert restore_checkpoint(str(tmp_path / "s"))["metadata"]["seed"] == best["seed"]
    got = trun.evaluate_checkpoint("toy", str(tmp_path / "m"), pre_data=pre, spmm="auto",
                                   device=CPU)
    for k in ("test_loss", "acc", "macro_f1", "precision", "recall"):
        assert got[k] == best["test"][k], k
    resumed = trun.resume_training(
        "toy", str(tmp_path / "s"), config=dataclasses.replace(cfg, max_epoch=10, seed=42),
        pre_data=pre, output_dir=out, verbose=False, device=CPU,
    )
    run = resumed["runs"][0]
    assert run["seed"] == best["seed"] and resumed["resumed_from"] == str(tmp_path / "s")
    assert [h["epoch"] for h in run["history"]] == [6, 7, 8, 9]
    straight = trun.run_experiment(
        "toy", config=dataclasses.replace(cfg, max_epoch=10), seeds=[best["seed"]], pre_data=pre,
        output_dir=out, verbose=False, device=CPU,
    )
    assert run["history"] == straight["runs"][0]["history"][6:]


def test_a_checkpoint_is_refused_on_another_node_order_or_model(tmp_path):
    """A hybrid (relabeled) checkpoint of identity features loaded on the
    segment layout is refused, as is a checkpoint of another family; on
    dense features the node order does not touch the params, so it loads."""
    ident = _pre(features=False)
    cfg = ttrainer.TrainConfig(n_hidden=H, max_epoch=2, spmm="hybrid")
    trun.run_experiment("toy", config=cfg, seeds=[1], pre_data=ident, verbose=False,
                        output_dir=str(tmp_path / "o"), save_model=str(tmp_path / "h"), device=CPU)
    with pytest.raises(ValueError, match="node order"):
        trun.evaluate_checkpoint("toy", str(tmp_path / "h"), pre_data=ident, spmm="segment",
                                 device=CPU)
    with pytest.raises(ValueError, match="node order"):
        _trainer(ident).load(str(tmp_path / "h"))
    assert trun.evaluate_checkpoint("toy", str(tmp_path / "h"), pre_data=ident, spmm="hybrid",
                                    device=CPU)["acc"] >= 0.0
    with pytest.raises(ValueError, match="'gcn' model"):
        trun.evaluate_checkpoint("toy", str(tmp_path / "h"), pre_data=ident, spmm="hybrid",
                                 model="sgc", device=CPU)
    dense = _pre()
    trun.run_experiment("toy", config=cfg, seeds=[1], pre_data=dense, verbose=False,
                        output_dir=str(tmp_path / "o"), save_model=str(tmp_path / "d"), device=CPU)
    assert trun.evaluate_checkpoint("toy", str(tmp_path / "d"), pre_data=dense, spmm="segment",
                                    device=CPU)["acc"] >= 0.0


def test_sharded_checkpoint_flags_raise_before_any_data_is_read(tmp_path, monkeypatch):
    """The checkpoint flags pass the sharded gate: ``run_experiment`` with
    ``n_shards`` and ``save_state`` reaches the missing dataset; through
    ``cli.main`` ``--save_model``, ``--save_state`` and ``--resume`` reach
    the device-count check of ``--shards 2`` and ``--load_model``, which
    evaluates on one card, the data read. ``restore_best`` with ``n_shards``
    is still refused before any data is read."""
    with pytest.raises(FileNotFoundError, match="missing"):
        trun.run_experiment("missing", data_root=str(tmp_path), n_shards=2,
                            partition="allgather", save_state=str(tmp_path / "s"), device=CPU)
    with pytest.raises(NotImplementedError, match="restore_best"):
        trun.run_experiment("missing", data_root=str(tmp_path), n_shards=2,
                            config=ttrainer.TrainConfig(restore_best=True), device=CPU)
    _cli_on_cpu(monkeypatch)
    for flag, err, match in (("--save_model", RuntimeError, "needs 2 CUDA devices"),
                             ("--save_state", RuntimeError, "needs 2 CUDA devices"),
                             ("--resume", RuntimeError, "needs 2 CUDA devices"),
                             ("--load_model", FileNotFoundError, "missing")):
        with pytest.raises(err, match=match):
            cli.main(["train", "--dataset", "missing", "--data_root", str(tmp_path), "--shards",
                      "2", "--partition", "allgather", "--spmm", "hybrid", flag, str(tmp_path)])


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return build_tiny(tmp_path_factory.mktemp("tiny"))


def _cli_on_cpu(monkeypatch):
    """Let ``cli.main`` run on the CPU: it sees a CUDA device and its run
    functions are given the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name, fn in (("run_experiment", trun.run_experiment),
                     ("resume_training", trun.resume_training),
                     ("evaluate_checkpoint", trun.evaluate_checkpoint)):
        monkeypatch.setattr(cli, name, lambda *a, _fn=fn, **k: _fn(*a, **{**k, "device": "cpu"}))


@pytest.mark.parametrize("spmm", ["bsr", "onehot"])
def test_cli_trains_on_bsr_and_onehot(spmm, tiny_root, tmp_path, monkeypatch):
    """``cli train --dataset tiny --spmm bsr|onehot`` trains the topic graph
    (the CPU runs the kernels' plain versions) and reports the format."""
    _cli_on_cpu(monkeypatch)
    assert cli.main(["train", "--dataset", "tiny", "--data_root", tiny_root, "--spmm", spmm,
                     "--max_epoch", "3", "--nhid", "8", "--seeds", "5", "--quiet",
                     "--output_dir", str(tmp_path)]) == 0
    with open(tmp_path / "tiny_topic_training_results.json", encoding="utf-8") as f:
        got = json.load(f)
    assert got["hyperparameters"]["spmm"] == spmm and got["runs"][0]["epochs_run"] == 3


def test_cli_save_state_resume_and_load_model(tiny_root, tmp_path, monkeypatch, capsys):
    """``--save_state`` then ``--resume`` through ``cli.main``: the resumed
    epochs equal the tail of a straight run's; ``--save_model`` then
    ``--load_model`` prints the run's test accuracy."""
    _cli_on_cpu(monkeypatch)
    base = ["train", "--dataset", "tiny", "--data_root", tiny_root, "--nhid", "8",
            "--early_stopping", "1000", "--quiet"]

    def report(out):
        with open(tmp_path / out / "tiny_topic_training_results.json", encoding="utf-8") as f:
            return json.load(f)

    assert cli.main([*base, "--max_epoch", "8", "--seeds", "5", "--output_dir",
                     str(tmp_path / "a"), "--save_model", str(tmp_path / "m")]) == 0
    assert cli.main([*base, "--max_epoch", "4", "--seeds", "5", "--output_dir",
                     str(tmp_path / "b"), "--save_state", str(tmp_path / "s")]) == 0
    assert cli.main([*base, "--max_epoch", "8", "--resume", str(tmp_path / "s"),
                     "--output_dir", str(tmp_path / "c")]) == 0
    straight, resumed = report("a")["runs"][0], report("c")["runs"][0]
    assert resumed["seed"] == 5 and resumed["history"] == straight["history"][4:]
    capsys.readouterr()
    assert cli.main([*base, "--load_model", str(tmp_path / "m")]) == 0
    assert f"acc={straight['test']['acc']:.4f}" in capsys.readouterr().out
