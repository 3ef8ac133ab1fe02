"""Full-batch semi-supervised training of any model family.

Port of ``textgcn_tpu/train/trainer.py`` (``TrainConfig``, ``EarlyStopping``,
``train_val_split``, ``_progress_metadata``, ``Trainer.fit / evaluate / test
/ save / load / save_training_state``, the model families' graph check):

- Adam with the reference's settings (lr 0.02, betas 0.9/0.999, eps 1e-8);
- cross-entropy on the train nodes' logits only (semi-supervised masking);
- early stopping on val loss with the reference's patience semantics; on a
  stop the params of the stopping epoch are kept, or with ``restore_best``
  those of the epoch with the lowest val loss;
- init and dropout draw from one ``torch.Generator`` seeded with
  ``cfg.seed``; the train/val split is the JAX package's numpy split, so it
  is identical for a given seed;
- checkpoints (:mod:`textgcn_tpu_torch.train.checkpoint`): :meth:`Trainer.save`
  writes the params for evaluation, :meth:`Trainer.save_training_state`
  everything ``fit(resume_from=...)`` needs to continue a run bit for bit:
  the live params, Adam's state, the progress counters and the dropout
  generator's state (the counterpart of the JAX trainer drawing every
  epoch's key up front). A checkpoint records the model family and the node
  order of its layout; loading it into another family, or, where layer 1 is
  node-indexed (identity features), under another node order, is refused
  (the JAX package evaluates misaligned rows without a word).

The epoch loop is a plain Python loop. The JAX trainer runs blocks of
``epoch_block`` epochs in one ``lax.scan`` to spread the round-trips of a
remote TPU, and its results are bit-identical across block sizes. The port
takes ``TrainConfig.epoch_block`` (and ``cli train --epoch_block``) with the
same default and no effect on the run: its results are the same bits for
every block size. A CUDA graph of a block of train steps may later make it
the captured block (ROADMAP A.3).
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
from textgcn_tpu_torch.ops.split import fingerprint
from textgcn_tpu_torch.ops.streamed_sorted import SortedStreamGraph
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
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
    # epochs a block (1 = one at a time): the JAX trainer's lax.scan block,
    # accepted with no effect on the run (the results are bit-identical
    # across block sizes there and here)
    epoch_block: int = 10
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


def _progress_metadata(
    epoch: int,
    best_val: float,
    stopper_best: float,
    stopper_counter: int,
    stopped: int,
    seed: int,
) -> Dict[str, Any]:
    """Training-progress counters, the JAX checkpoint schema's keys."""
    return {
        "epoch": int(epoch),
        "best_val": float(best_val),
        "stopper_best": float(stopper_best),
        "stopper_counter": int(stopper_counter),
        "stopped": int(stopped),
        "seed": int(seed),
    }


def node_order(perm: Optional[np.ndarray]) -> int:
    """The node order of a layout, as a checkpoint records it: 0 for the
    artifact's own ids, else the fingerprint of the relabeling ``perm``."""
    return 0 if perm is None else fingerprint(perm)


def model_class(model: str, graph) -> type:
    """The module class of family ``model`` for ``graph``; raises for an
    unknown family, a GAT on a container that has no attention layout, or a
    host-streamed graph (which trains through the streamed steps only)."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; choose one of {sorted(MODELS)}")
    if isinstance(graph, SortedStreamGraph):
        raise NotImplementedError(
            "the graph exceeds the resident budget, so --spmm auto chose the "
            "host-streamed format; training it through the Trainer is not "
            "ported yet (ROADMAP A.12: the streamed steps of the families). "
            "Choose a resident --spmm, or train through train/streamed.py"
        )
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
        perm: Optional[np.ndarray] = None,
    ):
        """``perm`` is the relabeling the graph's layout applied to the
        artifact's node ids (``PreparedData.perm``; None when it kept them),
        recorded in checkpoints."""
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
        self.node_order = node_order(perm)
        self._live: Optional[Dict[str, Any]] = None

    def _layout_metadata(self) -> Dict[str, Any]:
        """What a checkpoint records of the run's layout and family."""
        return {
            "model": self.cfg.model,
            "n_hidden": self.cfg.n_hidden,
            "node_order": self.node_order,
        }

    def _check_layout(self, path: str, md: Dict[str, Any]) -> None:
        """Refuse a checkpoint of another family, or of another node order
        where layer 1 is node-indexed (identity features: its rows are
        nodes, so a relabeled layout would read other nodes' rows)."""
        if md.get("model") != self.cfg.model:
            raise ValueError(
                f"checkpoint {path} holds a {md.get('model')!r} model; this run "
                f"is --model {self.cfg.model}"
            )
        if self.x is None and md.get("node_order") != self.node_order:
            raise ValueError(
                f"checkpoint {path} was saved on a layout with another node "
                "order (--spmm hybrid, or an auto that picked it, relabels the "
                "nodes) and layer 1 of identity features is node-indexed: load "
                "it with the --spmm it was saved with"
            )

    def _new_model(self, generator: Optional[torch.Generator],
                   n_hidden: Optional[int] = None) -> torch.nn.Module:
        """The family's module for this graph (``n_hidden`` wide, the
        config's by default), its params drawn from ``generator`` (shapes
        only when None)."""
        cfg = self.cfg
        n_feat = self.graph.n_nodes if self.x is None else self.x.shape[1]
        model = model_class(cfg.model, self.graph)(
            n_feat, n_hidden or cfg.n_hidden, self.num_classes, cfg.dropout,
            device=self.device, generator=generator,
        )
        self.model_param = sum(p.numel() for p in model.parameters())
        return model

    def fit(
        self,
        verbose: bool = True,
        params: Optional[Params] = None,
        resume_from: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Train to ``max_epoch`` or an early stop.

        ``params``: starting parameters (the flat dict of the family's
        ``*_init``, e.g. :func:`textgcn_tpu_torch.models.gcn.gcn_init`); by
        default they are drawn from the generator seeded with ``cfg.seed``.

        ``resume_from``: a directory written by :meth:`save_training_state`.
        The params, Adam's state, the epoch and early-stop counters and the
        dropout generator's state are restored (the init draws are skipped)
        and training continues at the saved epoch, so an interrupted run
        resumed here gives an uninterrupted run's bits on the same device.
        Refused under ``restore_best`` (its snapshot is not part of the
        live state) and for a run that stopped early, as in JAX.
        """
        cfg = self.cfg
        tr, va = train_val_split(self.train_idx_all, cfg.val_ratio, cfg.seed)
        train_idx = torch.tensor(tr, dtype=torch.int64, device=self.device)
        val_idx = torch.tensor(va, dtype=torch.int64, device=self.device)

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        stopper = EarlyStopping(cfg.early_stopping)
        best_val, best_params = float("inf"), None
        start_epoch, state = 0, None
        if resume_from is not None:
            if cfg.restore_best:
                raise ValueError(
                    "resume_from tracks the live training state; restore_best "
                    "snapshots are not part of it"
                )
            state = restore_checkpoint(resume_from)
            md = state["metadata"]
            if md["stopped"]:
                raise ValueError(
                    f"checkpoint {resume_from} is from an early-stopped run; "
                    "there is nothing to resume"
                )
            self._check_layout(resume_from, md)
            params = state["params"]
            start_epoch = md["epoch"]
            best_val = md["best_val"]
            stopper.best_score = None if np.isinf(md["stopper_best"]) else md["stopper_best"]
            stopper.counter = md["stopper_counter"]
            gen.set_state(state["generator"])
        model = self._new_model(None if params is not None else gen)
        if params is not None:
            model.load_state_dict(params)
        self.model = model
        opt = torch.optim.Adam(
            model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8
        )
        if state is not None:
            opt.load_state_dict(state["opt_state"])

        stopped = False
        epoch = start_epoch
        start = time.perf_counter()
        while epoch < cfg.max_epoch and not stopped:
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
            epoch += 1
            if vloss < best_val:
                best_val = vloss
                if cfg.restore_best:
                    best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
            # on a stop the params of the stopping epoch are kept
            stopped = stopper(vloss)
        self.train_time = time.perf_counter() - start
        # the live state for save_training_state: under restore_best the
        # model then holds the best epoch's params, which must not be saved
        # beside the last epoch's Adam moments
        self._live = {
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "opt_state": opt.state_dict(),
            "generator": gen.get_state(),
            "metadata": _progress_metadata(
                epoch, best_val,
                float("inf") if stopper.best_score is None else stopper.best_score,
                stopper.counter, int(stopped), cfg.seed,
            ),
        }
        if best_params is not None:
            model.load_state_dict(best_params)
        return {"epochs_run": len(self.history), "train_time": self.train_time}

    def save_training_state(self, path: str) -> str:
        """Resumable checkpoint: the live params, Adam's state, the progress
        counters and the dropout generator's state, with the layout's
        metadata; returns its path. Unlike :meth:`save` (params only, for
        evaluation), ``fit(resume_from=path)`` continues from it."""
        if self._live is None:
            raise ValueError("fit() first")
        live = self._live
        return save_checkpoint(
            path, live["params"], opt_state=live["opt_state"],
            metadata={**live["metadata"], **self._layout_metadata()},
            generator=live["generator"],
        )

    def save(self, path: str) -> str:
        """Checkpoint of the trained params (the best epoch's under
        ``restore_best``) with the run's metadata; returns its path."""
        if self.model is None:
            raise ValueError("fit() first")
        return save_checkpoint(
            path, self.model.state_dict(),
            metadata={"epochs_run": len(self.history), "seed": self.cfg.seed,
                      **self._layout_metadata()},
        )

    def load(self, path: str) -> None:
        """Restore params from a checkpoint of :meth:`save` or
        :meth:`save_training_state` (at the checkpoint's hidden width), for
        :meth:`evaluate`; refuses one of another family or, on identity
        features, another node order."""
        state = restore_checkpoint(path)
        md = state.get("metadata", {})
        self._check_layout(path, md)
        # the checkpoint's width, as the JAX package restores any params
        model = self._new_model(None, md.get("n_hidden"))
        model.load_state_dict(state["params"])
        self.model = model

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
