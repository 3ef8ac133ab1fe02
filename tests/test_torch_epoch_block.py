"""``--epoch_block``, the JAX ``train`` flag, in the PyTorch port, on the CPU.

The JAX trainer runs ``epoch_block`` epochs in one ``lax.scan`` and gives
the same bits for every block size. The port takes the flag (and the YAML
key, into ``TrainConfig.epoch_block``) with no effect on the run: a run with
it must give the bits of a run without it."""
import json

import pytest

from test_torch_checkpoint import _cli_on_cpu
from torch_tiny_data import build_tiny

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.utils.config import ExperimentConfig, TrainSection


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return build_tiny(tmp_path_factory.mktemp("tiny"))


def _run(tmp_path, tiny_root, name, extra):
    out = tmp_path / name
    assert cli.main(["train", "--dataset", "tiny", "--data_root", tiny_root, "--spmm", "segment",
                     "--nhid", "8", "--max_epoch", "12", "--early_stopping", "1000",
                     "--seeds", "5", "--quiet", "--output_dir", str(out), *extra]) == 0
    with open(out / "tiny_topic_training_results.json", encoding="utf-8") as f:
        return json.load(f)


@pytest.mark.parametrize("block", [1, 10])
def test_cli_epoch_block_gives_the_bits_of_a_run_without_it(block, tiny_root, tmp_path,
                                                          monkeypatch):
    """``cli train --spmm segment --epoch_block N`` (dropout on): every
    epoch's losses and metrics, and the test metrics (not the clock's
    train_time), equal those of the same run without the flag; the report
    records the block size."""
    _cli_on_cpu(monkeypatch)
    without = _run(tmp_path, tiny_root, "without", [])
    with_block = _run(tmp_path, tiny_root, "with", ["--epoch_block", str(block)])
    assert with_block["hyperparameters"]["epoch_block"] == block
    assert without["hyperparameters"]["epoch_block"] == 10
    a, b = with_block["runs"][0], without["runs"][0]
    assert len(a["history"]) == 12
    assert a["history"] == b["history"]
    timing = {"train_time"}
    assert {k: v for k, v in a["test"].items() if k not in timing} == {
        k: v for k, v in b["test"].items() if k not in timing}


def test_epoch_block_parses_and_reaches_train_config():
    """The flag's default and type are the JAX CLI's; the YAML ``train``
    section's ``epoch_block`` reaches ``TrainConfig``."""
    args = cli.build_parser().parse_args(["train", "--dataset", "R8"])
    assert args.epoch_block == 10
    assert cli.build_parser().parse_args(
        ["train", "--dataset", "R8", "--epoch_block", "3"]).epoch_block == 3
    assert TrainSection(epoch_block=3).to_train_config().epoch_block == 3
    cfg = ExperimentConfig.from_dict({"dataset": "tiny", "train": {"epoch_block": 1}})
    assert cfg.train.to_train_config().epoch_block == 1
