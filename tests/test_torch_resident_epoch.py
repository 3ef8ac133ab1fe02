"""``Trainer.epoch``, the body of ``Trainer.fit``'s loop, on the CPU: driven
in a loop from the state ``fit`` starts from, it gives ``fit``'s history and
parameters bit for bit on the tiny corpus's doc-word graph (identity
features, dropout on), through the hybrid layout and the segment path. The
spans of one epoch are in ``tests/test_torch_spans.py``."""
import numpy as np
import pytest
import torch

from torch_tiny_data import build_tiny

from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.utils import profiling

CPU = torch.device("cpu")
EPOCHS = 7


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return build_tiny(tmp_path_factory.mktemp("tiny"), docword=True)


def _trainer(pre):
    cfg = ttrainer.TrainConfig(n_hidden=8, max_epoch=EPOCHS, early_stopping=1000, seed=11)
    return ttrainer.Trainer(
        pre.graph, pre.features, pre.labels.target, pre.labels.train_idx,
        pre.labels.test_idx, pre.labels.n_classes, config=cfg, device=CPU, perm=pre.perm,
    )


@pytest.mark.parametrize("spmm", ["hybrid", "segment"])
def test_epochs_in_a_loop_give_fits_history_and_params(tiny_root, spmm):
    pre = tprepare.apply_spmm_format(
        tprepare.prepare_docword_data("tiny", data_root=tiny_root, device=CPU), spmm)
    assert pre.features is None
    fitted = _trainer(pre)
    fitted.fit(verbose=False)

    t = _trainer(pre)
    cfg = t.cfg
    tr, va = ttrainer.train_val_split(t.train_idx_all, cfg.val_ratio, cfg.seed)
    train_idx = torch.tensor(tr, dtype=torch.int64)
    val_idx = torch.tensor(va, dtype=torch.int64)
    gen = torch.Generator(device=CPU).manual_seed(cfg.seed)
    model = ttrainer.model_class(cfg.model, pre.graph)(
        pre.n_nodes, cfg.n_hidden, t.num_classes, cfg.dropout, device=CPU, generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    history = [{"epoch": e, **t.epoch(model, opt, gen, train_idx, val_idx)}
               for e in range(EPOCHS)]

    assert len(fitted.history) == EPOCHS
    assert history == fitted.history
    got, want = model.state_dict(), fitted.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # dropout drew its masks: the train loss moves with the generator
    assert len({r["train_loss"] for r in history}) == EPOCHS
    assert np.isfinite([r["val_loss"] for r in history]).all()


def test_fit_records_an_epoch_span_each(tiny_root):
    """With the recorder on, ``fit`` records one ``step`` span an epoch,
    each with its ``train`` and ``eval`` spans; with it off, nothing."""
    pre = tprepare.apply_spmm_format(
        tprepare.prepare_docword_data("tiny", data_root=tiny_root, device=CPU), "hybrid")
    profiling.record_spans(False)
    _trainer(pre).fit(verbose=False)
    assert profiling.record_spans(True) == []
    try:
        _trainer(pre).fit(verbose=False)
    finally:
        spans = profiling.record_spans(False)
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    assert len(steps) == EPOCHS and len({spans[i].step for i in steps}) == EPOCHS
    for i in steps:
        assert [s.name for s in spans if s.parent == i] == ["train", "eval"]

