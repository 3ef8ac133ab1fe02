"""The port's build → train → inspect pipeline (``textgcn_tpu_torch``:
``TopicGraphBuilder.build``, ``inspect_topics``, ``run_experiment_config``
and the CLI's subcommands) on the CPU, on the tiny corpus of the JAX
package's runner tests, against the JAX package where both compute the same
thing. Every test runs in a temporary directory (cwd and data root)."""
import json
import os

import numpy as np
import pytest
import torch
import yaml

from textgcn_tpu import cli as jcli
from textgcn_tpu.graph.build_topic import TopicGraphBuilder as JBuilder
from textgcn_tpu.inspect.topics import inspect_topics as j_inspect
from textgcn_tpu.runner import load_config as j_load_config

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph.build_topic import TopicGraphBuilder as TBuilder
from textgcn_tpu_torch.inspect.topics import inspect_topics as t_inspect
from textgcn_tpu_torch.runner import load_config, run_experiment_config
from textgcn_tpu_torch.train.prepare import cached_theta, prepare_topic_data

from test_runner import _write_tiny_dataset

CPU = torch.device("cpu")
BUILD = dict(num_topics=4, min_df=1, max_df=1.0, lda_max_iter=8, verbose=False)


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_tiny_dataset(str(tmp_path))
    return tmp_path


def test_topic_builder_equals_jax(tiny_root):
    """The whole topic build of the tiny corpus (4 topics, 8 EM iterations,
    Word2Vec) from the same seeds: lambda within 1e-4 relative (f32 fits
    whose E-step stops may differ by an iteration), theta within 1e-4; the
    same edges with weights within 1e-4. The Word2Vec vectors within 1e-3
    of the largest: on this corpus one padded batch an epoch repeats each
    example ~13 times at lr 0.025 for 10 epochs, so the vectors grow to
    ~1e6 and the f32 rounding differences grow with them (2 epochs hold
    1e-5 in ``test_torch_build.py``). Then the saved artifacts: theta is
    written after the pickle, so training takes it, and the port's prepare
    reads the port's build."""
    jb = JBuilder("tiny", data_root=str(tiny_root / "data"), **BUILD)
    tb = TBuilder("tiny", data_root=str(tiny_root / "data"), device=CPU, **BUILD)
    jg, tg = jb.build(), tb.build()
    jm, tm = jb.topic_model, tb.topic_model
    np.testing.assert_allclose(tm.lda.components_, jm.lda.components_, rtol=1e-4, atol=0)
    jv = jm.word2vec_model.vectors
    np.testing.assert_allclose(tm.word2vec_model.vectors, jv, rtol=0, atol=1e-3 * np.abs(jv).max())
    np.testing.assert_allclose(tb._theta, jb._theta, atol=1e-4, rtol=0)
    for k in ("src", "dst"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    np.testing.assert_allclose(tg.weight, jg.weight, atol=1e-4, rtol=1e-4)
    assert (tg.n_doc_topic_edges, tg.n_topic_topic_edges) == (jg.n_doc_topic_edges, jg.n_topic_topic_edges)
    tb.save()
    base = str(tiny_root / "data" / "graph" / "tiny_topic")
    for suffix in (".txt", "_model.pkl", "_theta.npy", "_nodes.csv", "_edges.csv"):
        assert os.path.exists(base + suffix)
    np.testing.assert_array_equal(cached_theta(base, 24, 4), tb._theta)
    pre = prepare_topic_data("tiny", data_root=str(tiny_root / "data"), device=CPU)
    assert (pre.num_docs, pre.num_topics, pre.graph.n_nodes) == (24, 4, 28)


def test_inspect_topics_report_equals_jax(tiny_root):
    """From one built topic model (the JAX builder's): the port's report
    (theta by its E-step on the CPU) equals the JAX package's text."""
    b = JBuilder("tiny", data_root=str(tiny_root / "data"), **BUILD)
    b.build()
    b.save()
    kw = dict(data_root=str(tiny_root / "data"), top_n_words=3, top_n_docs=2, heatmap=False)
    want = j_inspect("tiny", output_dir=str(tiny_root / "j"), **kw)
    got = t_inspect("tiny", output_dir=str(tiny_root / "t"), device=CPU, **kw)
    assert got == want
    assert (tiny_root / "t" / "tiny_topic_inspection.txt").read_text(encoding="utf-8") == got


def _write_config(root, cfg):
    path = root / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_run_experiment_config_topic_family_on_the_cpu(tiny_root):
    cfg = {
        "dataset": "tiny",
        "build": {"num_topics": 4, "min_df": 1, "max_df": 1.0, "lda_max_iter": 8},
        "train": {"times": 2, "max_epoch": 30, "nhid": 16, "epoch_block": 3},
        "inspect": {"top_n_words": 3, "top_n_docs": 2, "heatmap": False},
    }
    assert run_experiment_config(_write_config(tiny_root, cfg), device=CPU) == 0
    exp = tiny_root / "experiments" / "tiny"
    for stage in ("build", "train", "inspect"):
        assert "[stage " in (exp / "logs" / f"{stage}.log").read_text(encoding="utf-8")
    assert "TOTAL" in (exp / "logs" / "stage_times.txt").read_text(encoding="utf-8")
    assert yaml.safe_load((exp / "config_used.yaml").read_text()) == cfg
    with open(exp / "results" / "tiny_topic_training_results.json") as f:
        summary = json.load(f)
    assert summary["times"] == 2 and summary["device"]["type"] == "cpu"
    assert summary["hyperparameters"]["n_hidden"] == 16
    assert (exp / "results" / "tiny_topic_inspection.txt").exists()
    assert (tiny_root / "data" / "graph" / "tiny_topic_theta.npy").exists()


def test_run_experiment_config_docword_family_on_the_cpu(tiny_root):
    cfg = {"dataset": "tiny", "graph": "docword", "build": {"window": 5},
           "train": {"times": 1, "max_epoch": 20, "nhid": 16}}
    assert run_experiment_config(_write_config(tiny_root, cfg), device=CPU) == 0
    exp = tiny_root / "experiments" / "tiny_docword"
    assert (exp / "results" / "tiny_docword_training_results.json").exists()
    assert not (exp / "logs" / "inspect.log").exists()
    assert (tiny_root / "data" / "graph" / "tiny_docword_vocab.txt").exists()


@pytest.mark.parametrize("name", ["r8.yaml", "r8_docword.yaml", "mr.yaml"])
def test_load_config_equals_jax(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "experiments", name)
    got = load_config(path)
    assert got == j_load_config(path) and got["dataset"]


def test_run_experiment_config_refuses_halo_and_unknown_keys(tiny_root):
    """A YAML's ``partition: halo`` with shards and ``spmm: hybrid`` raises
    before training (the JAX trainer's gate: the hybrid kernel runs on the
    allgather partition only), and an unknown key before any stage runs."""
    bad = _write_config(tiny_root, {"dataset": "tiny", "bogus": 1})
    with pytest.raises(ValueError, match="bogus"):
        run_experiment_config(bad, device=CPU)
    assert not (tiny_root / "experiments").exists()
    halo = _write_config(tiny_root, {
        "dataset": "tiny", "graph": "docword", "build": {"window": 5},
        "train": {"shards": 2, "partition": "halo", "spmm": "hybrid"},
    })
    with pytest.raises(ValueError, match="halo"):
        run_experiment_config(halo, device=CPU)


SUBCOMMANDS = {
    "clean": ["clean", "--dataset", "R8"],
    "build-graph": ["build-graph", "--dataset", "R8"],
    "build-docword": ["build-docword", "--dataset", "R8"],
    "train": ["train", "--dataset", "R8"],
    "inspect": ["inspect", "--dataset", "R8"],
    "experiment": ["experiment", "--config", "x.yaml"],
}


def _jax_args(monkeypatch, argv):
    seen = []
    for name in ("cmd_clean", "cmd_build_graph", "cmd_build_docword", "cmd_train",
                 "cmd_inspect", "cmd_experiment"):
        monkeypatch.setattr(jcli, name, lambda a: seen.append(a) or 0)
    assert jcli.main(argv) == 0
    return vars(seen[0])


@pytest.mark.parametrize("command", sorted(SUBCOMMANDS))
def test_cli_subcommands_parse_with_the_jax_flags_and_defaults(command, monkeypatch):
    """Every subcommand of the JAX CLI parses in the port with the same
    flags and defaults (``train`` on the flags both have)."""
    argv = SUBCOMMANDS[command]
    got = {k: v for k, v in vars(cli.build_parser().parse_args(argv)).items() if k != "fn"}
    want = {k: v for k, v in _jax_args(monkeypatch, argv).items() if k != "fn"}
    if command == "train":
        assert {"trace", "graph", "spmm", "model", "shards", "partition"} <= set(got)
        want = {k: v for k, v in want.items() if k in got}
        got = {k: v for k, v in got.items() if k in want}
    assert got == want


@pytest.mark.parametrize("argv", [
    ["build-graph", "--dataset", "R8"],
    ["inspect", "--dataset", "R8"],
    ["experiment", "--config", "missing.yaml"],
], ids=["build-graph", "inspect", "experiment"])
def test_cli_device_commands_raise_without_cuda(argv, tmp_path, monkeypatch):
    """The device subcommands name the CUDA device they lack and write
    nothing."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(argv)
    assert os.listdir(tmp_path) == []


def test_cli_host_commands_run_without_a_device(tiny_root, monkeypatch):
    """``clean`` and ``build-docword`` are host work: they run with no CUDA
    device, into the given data root."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = tiny_root / "data"
    corpus = data / "text_dataset" / "corpus"
    corpus.mkdir(parents=True)
    (corpus / "mr.txt").write_bytes(b"It's a (good) film!\nA bad one?\n")
    assert cli.main(["clean", "--dataset", "mr", "--data_root", str(data)]) == 0
    assert (data / "text_dataset" / "clean_corpus" / "mr.txt").read_text() == (
        "it 's a \\( good \\) film ! \na bad one \\? \n"
    )
    assert cli.main(["build-docword", "--dataset", "tiny", "--window", "5", "--data_root", str(data)]) == 0
    assert (data / "graph" / "tiny_docword.txt").stat().st_size > 0
