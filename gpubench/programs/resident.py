"""The port's resident path as ``cli train --spmm hybrid`` runs it: the
benchmark's chunks as the port's ``SparseGraph``, ``apply_spmm_format(pre,
"hybrid")`` (the degree sort, 128x128 bfloat16 tiles through K1 and the
residual edges through K2), and one epoch of ``Trainer.epoch`` a step: the
train forward with dropout, the cross-entropy over the loss rows, backward,
Adam, the eval forward and the validation metrics read back.

The traffic numbers the nodes in the degree sort's order, so the sort is
the identity; :class:`Resident` refuses a graph on which it is not. The
loss rows are the harness's mask; the validation rows are ``val_rows``
rows outside it, evenly spaced.

``FAULTS``: the faults planted in this path (``gpubench/faults.py``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def residual_left_out():
    """Every hybrid pass runs the tile leg (K1) only."""
    from textgcn_tpu_torch.graph import reorder

    orig = reorder.tile_and_residual

    def tiles_only(bsr, rest, xp, *args, **kwargs):
        return orig(bsr, None, xp, *args, **kwargs)

    reorder.tile_and_residual = tiles_only
    try:
        yield
    finally:
        reorder.tile_and_residual = orig


@contextlib.contextmanager
def dropout_left_out():
    """The program's dropout passes its input through."""
    from textgcn_tpu_torch.models import gcn

    orig = gcn._dropout
    gcn._dropout = lambda h, p, train, generator: h
    try:
        yield
    finally:
        gcn._dropout = orig


class _HalfBatchF:
    """``torch.nn.functional`` whose cross-entropy leaves out the second
    half of the rows it is given."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def cross_entropy(logits, y, *args, **kwargs):
        h = logits.shape[0] // 2
        return F.cross_entropy(logits[:h], y[:h], *args, **kwargs)


@contextlib.contextmanager
def half_batch():
    """The loss leaves out the second half of the loss rows and takes the
    mean over the rest."""
    from textgcn_tpu_torch.train import trainer

    orig = trainer.F
    trainer.F = _HalfBatchF()
    try:
        yield
    finally:
        trainer.F = orig


FAULTS = {"residual_left_out": residual_left_out, "dropout_left_out": dropout_left_out,
          "half_batch": half_batch}


def build(cfg: dict, workload: dict, inputs, spans: bool = False) -> "Resident":
    return Resident(cfg, inputs)


def sparse_graph(inputs):
    """The benchmark's chunks as the port's padded COO."""
    from textgcn_tpu_torch.graph.structs import SparseGraph

    rows, cols, vals = [], [], []
    for row_ptr, col, val, r0 in inputs.chunks():
        counts = np.diff(row_ptr.cpu().numpy())
        rows.append(r0 + np.repeat(np.arange(counts.size), counts))
        cols.append(col.cpu().numpy())
        vals.append(val.cpu().numpy())
    n = inputs.graph.n_rows
    return SparseGraph.from_coo(np.concatenate(rows), np.concatenate(cols),
                                np.concatenate(vals), n, device=inputs.device)


def val_rows(mask: torch.Tensor, count: int) -> torch.Tensor:
    """``count`` rows outside the loss rows, evenly spaced among them."""
    outside = (mask == 0).nonzero()[:, 0]
    pick = torch.linspace(0, outside.numel() - 1, count, device=mask.device)
    return outside[pick.round().long()]


def launches() -> Dict[str, int]:
    """K1's launches (bf16 and f32 tiles) and K2's, as their wrappers
    count them."""
    from textgcn_tpu_torch.ops.bsr_spmm import bsr_spmm, bsr_spmm_f32
    from textgcn_tpu_torch.ops.row_reduce import row_reduce

    return {"k1_launches": bsr_spmm.launches + bsr_spmm_f32.launches,
            "k2_launches": row_reduce.launches}


class Resident:
    """``Trainer.epoch`` on the benchmark's inputs, with the benchmark's
    weights loaded into the model and the configuration's Adam settings."""

    def __init__(self, cfg: dict, inputs):
        from textgcn_tpu_torch.text.datasets import DatasetLabels
        from textgcn_tpu_torch.train.prepare import PreparedData, apply_spmm_format
        from textgcn_tpu_torch.train.trainer import TrainConfig, Trainer

        dev = inputs.device
        n, c = inputs.graph.n_rows, cfg["n_class"]
        train_idx = inputs.mask.nonzero()[:, 0]
        val_idx = val_rows(inputs.mask, cfg["val_rows"])
        labels = DatasetLabels(target=inputs.y.cpu().numpy(),
                               label_names=[str(k) for k in range(c)],
                               train_idx=train_idx.cpu().numpy(), test_idx=val_idx.cpu().numpy())
        pre = apply_spmm_format(PreparedData(graph=sparse_graph(inputs), features=None,
                                             labels=labels, n_feat=n, num_docs=n, num_topics=0),
                                "hybrid")
        if pre.perm is None or not np.array_equal(pre.perm, np.arange(n)):
            raise RuntimeError("the degree sort of the benchmark's graph is not the identity")
        config = TrainConfig(n_hidden=cfg["n_hidden"], lr=cfg["learning_rate"],
                             dropout=cfg["dropout"], seed=cfg["dropout_seed"],
                             spmm="hybrid", model="gcn")
        self.trainer = Trainer(pre.graph, None, pre.labels.target, pre.labels.train_idx,
                               pre.labels.test_idx, c, config, device=dev, perm=pre.perm)
        model = self.trainer._new_model(None)
        want = {k: tuple(w.shape) for k, w in inputs.weights.items()}
        have = {k: tuple(p.shape) for k, p in model.named_parameters()}
        if want != have:
            raise RuntimeError(f"the program's parameters {have} are not the reference's {want}")
        model.load_state_dict(inputs.weights)
        self.model = self.trainer.model = model
        opt_cfg = cfg["optimizer"]
        self.opt = torch.optim.Adam(model.parameters(), lr=cfg["learning_rate"],
                                    betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
        self.gen = torch.Generator(device=dev).manual_seed(cfg["dropout_seed"])
        self.train_idx, self.val_idx = train_idx, val_idx
        self.graph = pre.graph

    def step(self) -> float:
        rec = self.trainer.epoch(self.model, self.opt, self.gen, self.train_idx, self.val_idx)
        return rec["train_loss"]

    def first_grad(self) -> Dict[str, Optional[torch.Tensor]]:
        """``exp_avg / (1 - beta1)`` after step 1: the gradient Adam got."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.model.named_parameters():
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[k] = None if m is None else m.detach().float() / (1.0 - beta1)
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().float().clone() for k, p in self.model.named_parameters()}

    def record_spans(self, on: bool) -> None:
        pass

    def program_spans(self, on: bool) -> list:
        """The program's own span recorder switched ``on`` or off; what it
        recorded since it was last switched."""
        from textgcn_tpu_torch.utils.profiling import record_spans

        return record_spans(on)

    def pass_ms(self) -> list:
        return []

    def counters(self) -> Dict[str, int]:
        return launches()

    def notes(self) -> dict:
        g = self.graph
        return {"tiles": g.bsr.nnzb, "dense_fraction": g.dense_fraction,
                "residual_edges": 0 if g.rest is None else g.rest.n_edges,
                "degree_sort": "identity"}
