"""Full-batch semi-supervised training of any model family.

Port of ``textgcn_tpu/train/trainer.py`` (``TrainConfig``, ``EarlyStopping``,
``train_val_split``, ``Trainer.fit / evaluate / test``, the model families'
graph check):

- Adam with the reference's settings (lr 0.02, betas 0.9/0.999, eps 1e-8);
- cross-entropy on the train nodes' logits only (semi-supervised masking);
- early stopping on val loss with the reference's patience semantics; on a
  stop the params of the stopping epoch are kept, or with ``restore_best``
  those of the epoch with the lowest val loss;
- init and dropout draw from one ``torch.Generator`` seeded with
  ``cfg.seed``; the train/val split is the JAX package's numpy split, so it
  is identical for a given seed.

The epoch loop is a plain Python loop. The JAX trainer runs blocks of epochs
in one ``lax.scan`` to spread the round-trips of a remote TPU; the port has no
such link to amortize, so it has no ``epoch_block``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.models.gat import DenseAttentionGraph
from textgcn_tpu_torch.models.gcn import Params
from textgcn_tpu_torch.ops.attention import AttentionGraph
from textgcn_tpu_torch.train.metrics import accuracy, macro_f1


@dataclasses.dataclass
class TrainConfig:
    """Hyperparameters; defaults mirror the reference."""

    n_hidden: int = 200
    lr: float = 0.02
    dropout: float = 0.5
    max_epoch: int = 200
    early_stopping: int = 10
    val_ratio: float = 0.1
    seed: int = 42
    # hand back the params of the lowest-val-loss epoch after fit, not the
    # last epoch's (off by default, as in the reference)
    restore_best: bool = False
    # SpMM graph format (textgcn_tpu_torch.graph.format.SPMM_FORMATS, and
    # onehot for GAT), applied by run_experiment before the Trainer is built
    spmm: str = "auto"
    # model family (textgcn_tpu_torch.models.MODELS): gcn | gat | sgc |
    # sgc_pre | appnp | sage | gin | gcnii
    model: str = "gcn"


class EarlyStopping:
    """Patience counter on val loss."""

    def __init__(self, patience: int = 10, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.best_score: Optional[float] = None
        self.counter = 0

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best_score is None:
            self.best_score = score
            return False
        if score < self.best_score + self.delta:
            self.counter += 1
            return self.counter >= self.patience
        self.best_score = score
        self.counter = 0
        return False


def train_val_split(
    train_idx: np.ndarray, val_ratio: float, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Shuffled split of the labeled train set into train/val (numpy
    ``RandomState(seed)``, as the JAX package does)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(train_idx))
    n_val = int(round(len(train_idx) * val_ratio))
    return np.asarray(train_idx)[perm[n_val:]], np.asarray(train_idx)[perm[:n_val]]


def _eval_metrics(logits, y, idx, num_classes):
    sl, st = logits[idx], y[idx]
    loss = F.cross_entropy(sl, st)
    f1, p, r = macro_f1(sl, st, num_classes)
    return torch.stack([loss, accuracy(sl, st), f1, p, r])


def model_class(model: str, graph) -> type:
    """The module class of family ``model`` for ``graph``; raises for an
    unknown family or a GAT on a container that has no attention layout."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose one of {sorted(MODELS)}")
    if model == "gat" and not isinstance(
        graph, (SparseGraph, AttentionGraph, DenseAttentionGraph)
    ):
        raise ValueError(
            "GAT needs the segment format (SparseGraph), the attention-kernel "
            "AttentionGraph (spmm onehot or hybrid) or the dense "
            f"DenseAttentionGraph (spmm dense or auto); got {type(graph).__name__}"
        )
    return MODELS[model]


class Trainer:
    """Trains a model of family ``config.model`` full-batch on a prepared
    graph on ``device`` (the graph's tensors must already be there)."""

    def __init__(
        self,
        graph,
        features: Optional[np.ndarray],
        target: np.ndarray,
        train_idx: np.ndarray,
        test_idx: np.ndarray,
        num_classes: int,
        config: TrainConfig = TrainConfig(),
        *,
        device,
    ):
        self.device = torch.device(device)
        self.graph = graph
        # features=None → identity features; layer 1 is then an embedding
        # table of shape [n_nodes, n_hidden]
        self.x = (
            None
            if features is None
            else torch.tensor(np.asarray(features), dtype=torch.float32, device=self.device)
        )
        self.y = torch.tensor(np.asarray(target), dtype=torch.int64, device=self.device)
        self.train_idx_all = np.asarray(train_idx)
        self.test_idx = torch.tensor(np.asarray(test_idx), dtype=torch.int64, device=self.device)
        self.num_classes = int(num_classes)
        self.cfg = config
        self.history: List[Dict[str, float]] = []
        self.model: Optional[torch.nn.Module] = None
        self.train_time = 0.0
        self.model_param = 0

    def fit(self, verbose: bool = True, params: Optional[Params] = None) -> Dict[str, Any]:
        """Train to ``max_epoch`` or an early stop.

        ``params``: starting parameters (the flat dict of the family's
        ``*_init``, e.g. :func:`textgcn_tpu_torch.models.gcn.gcn_init`); by
        default they are drawn from the generator seeded with ``cfg.seed``.
        """
        cfg = self.cfg
        tr, va = train_val_split(self.train_idx_all, cfg.val_ratio, cfg.seed)
        train_idx = torch.tensor(tr, dtype=torch.int64, device=self.device)
        val_idx = torch.tensor(va, dtype=torch.int64, device=self.device)

        model_cls = model_class(cfg.model, self.graph)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        n_feat = self.graph.n_nodes if self.x is None else self.x.shape[1]
        model = model_cls(
            n_feat, cfg.n_hidden, self.num_classes, cfg.dropout,
            device=self.device, generator=None if params is not None else gen,
        )
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        self.model_param = sum(p.numel() for p in model.parameters())
        opt = torch.optim.Adam(
            model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8
        )
        stopper = EarlyStopping(cfg.early_stopping)
        best_val, best_params = float("inf"), None

        start = time.perf_counter()
        for epoch in range(cfg.max_epoch):
            model.train()
            logits = model(self.graph, self.x, generator=gen)
            loss = F.cross_entropy(logits[train_idx], self.y[train_idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

            model.eval()
            with torch.no_grad():
                vals = _eval_metrics(
                    model(self.graph, self.x), self.y, val_idx, self.num_classes
                )
                tloss, vloss, vacc, vf1, vp, vr = (
                    torch.cat([loss.detach()[None], vals]).tolist()
                )
            rec = {
                "epoch": epoch,
                "train_loss": tloss,
                "val_loss": vloss,
                "acc": vacc,
                "macro_f1": vf1,
                "precision": vp,
                "recall": vr,
            }
            self.history.append(rec)
            if verbose:
                print(
                    " ".join(
                        f"{k}:{v}" if isinstance(v, int) else f"{k}:{v:.4f}"
                        for k, v in rec.items()
                    )
                )
            if cfg.restore_best and vloss < best_val:
                best_val = vloss
                best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
            if stopper(vloss):
                break  # the params of the stopping epoch are kept
        self.train_time = time.perf_counter() - start
        if best_params is not None:
            model.load_state_dict(best_params)
        return {"epochs_run": len(self.history), "train_time": self.train_time}

    def evaluate(self, idx: torch.Tensor, prefix: str = "test") -> Dict[str, float]:
        if self.model is None:
            raise ValueError("fit() first")
        self.model.eval()
        with torch.no_grad():
            loss, acc, f1, p, r = _eval_metrics(
                self.model(self.graph, self.x), self.y, idx, self.num_classes
            ).tolist()
        return {
            f"{prefix}_loss": loss,
            "acc": acc,
            "macro_f1": f1,
            "precision": p,
            "recall": r,
        }

    def test(self) -> Dict[str, float]:
        out = self.evaluate(self.test_idx, prefix="test")
        out["train_time"] = self.train_time
        out["model_param"] = self.model_param
        return out
