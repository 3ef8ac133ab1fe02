"""A runner for the tests of a second runner
(``gpubench/tests/test_gpubench_new_runner.py``): the two-layer GCN with
identity features (X = I_N) through the port's resident
``gcn_forward(params, graph, None)`` on a ``SparseGraph`` (the segment
path), without dropout, its loss the cross-entropy over the rows in the
loss as ``train/trainer.py`` takes it, and torch's Adam. The harness finds
it as ``gpubench.programs.fixture_resident`` once the test puts this
directory on that package's path.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def rows_left_out():
    """Every aggregation leaves out every other row. ``gcn_forward`` looks
    ``spmm`` up in ``textgcn_tpu_torch.models.gcn``: patched there."""
    from textgcn_tpu_torch.models import gcn

    orig = gcn.spmm

    def half(graph, x):
        out = orig(graph, x)
        keep = torch.arange(out.shape[0], device=out.device) % 2 == 0
        return out * keep[:, None]

    gcn.spmm = half
    try:
        yield
    finally:
        gcn.spmm = orig


FAULTS = {"rows_left_out": rows_left_out}


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


class Resident:
    """The step over the whole graph on the device, from the benchmark's
    weights, with the configuration's Adam settings."""

    def __init__(self, cfg: dict, inputs):
        opt_cfg = cfg["optimizer"]
        self.graph = sparse_graph(inputs)
        self.params = {k: w.detach().clone().requires_grad_(True)
                       for k, w in inputs.weights.items()}
        self.opt = torch.optim.Adam(self.params.values(), lr=cfg["learning_rate"],
                                    betas=tuple(opt_cfg["betas"]), eps=opt_cfg["eps"])
        self.x, self.y = inputs.x, inputs.y
        self.train_idx = inputs.mask.nonzero()[:, 0]

    def step(self) -> float:
        from textgcn_tpu_torch.models.gcn import gcn_forward

        self.opt.zero_grad()
        logits = gcn_forward(self.params, self.graph, self.x, dropout=0.0, train=True)
        loss = F.cross_entropy(logits[self.train_idx], self.y[self.train_idx])
        loss.backward()
        self.opt.step()
        return loss.item()

    def first_grad(self) -> Dict[str, Optional[torch.Tensor]]:
        """``exp_avg / (1 - beta1)`` after step 1: the gradient Adam got."""
        beta1 = self.opt.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.params.items():
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[k] = None if m is None else m.detach().float() / (1.0 - beta1)
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().float().clone() for k, p in self.params.items()}

    def record_spans(self, on: bool) -> None:
        pass

    def program_spans(self, on: bool) -> list:
        from textgcn_tpu_torch.utils.profiling import record_spans

        return record_spans(on)

    def pass_ms(self) -> list:
        return []

    def counters(self) -> dict:
        return {}

    def notes(self) -> dict:
        return {}
