"""Full-batch training of every family with the rows sharded over a
process group.

Port of ``textgcn_tpu/parallel/trainer.py`` (``SHARDED_MODELS``,
``ShardedTrainer``, ``masks_for_split``, ``metrics_from_confusion``) onto
``torch.distributed``. Every rank of the group builds one
``ShardedTrainer`` with its own ``rank`` and calls the same methods in the
same order; each step's collectives pair up across ranks.

- ``partition`` is ``"halo"`` (the JAX default: feature blocks travel a
  ring, :mod:`~textgcn_tpu_torch.parallel.halo`) or ``"allgather"`` (every
  rank gathers all feature rows). ``kernel`` is ``"segment"`` (the JAX
  default: plain PyTorch sums), ``"onehot"`` (K2 per rank, or per ring
  step on the halo buckets; :mod:`~textgcn_tpu_torch.parallel.mesh_kernels`)
  or ``"hybrid"`` (K1 and K2 per rank, allgather only). ``config.model`` is
  any family of :data:`SHARDED_MODELS`: every family but GAT runs on every
  (kernel, partition); GAT runs its segment softmax on either partition and
  the attention kernels on ``onehot``/``allgather``
  (:mod:`~textgcn_tpu_torch.parallel.mesh_attention`). The gates are the
  JAX trainer's (:func:`check_sharded`).
- ``kernel="hybrid"`` degree-sorts the graph (features, labels and splits
  are permuted alike, as the JAX trainer does); the other kernels keep the
  node order.
- The loss is the global masked mean: each rank sums ``nll`` over its train
  rows and divides by the global train count; the gradients of the
  replicated parameters are summed over the ranks before Adam steps. With
  identity features the rows of layer 1's node tables (the leaves of the
  family's layer-1 group that take the input width: two for SAGE) are the
  rank's own parameters.
- Validation and test metrics come from a ``[C, C]`` confusion matrix summed
  over the ranks, with the val loss in the same all-reduce; every rank reads
  the same val loss, so every rank stops on the same epoch.
- Init and dropout are drawn, in the single-device port ``Trainer``'s
  order, for all ``n_nodes`` rows from a generator seeded with ``cfg.seed``;
  each rank keeps its rows. A run therefore does not depend on the number
  of ranks, and follows the single-device run of the same kernel up to the
  order of float sums.

Not ported yet: sharded checkpoints (ROADMAP A.11c) and the
``epoch_block`` scan.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from textgcn_tpu_torch.graph.format import permute_rows
from textgcn_tpu_torch.graph.reorder import degree_sort_permutation
from textgcn_tpu_torch.models.appnp import appnp_init
from textgcn_tpu_torch.models.family import params_from_jax
from textgcn_tpu_torch.models.gat import gat_init
from textgcn_tpu_torch.models.gcn import Params, gcn_init
from textgcn_tpu_torch.models.gcnii import gcnii_init
from textgcn_tpu_torch.models.gin import gin_init
from textgcn_tpu_torch.models.sage import sage_init
from textgcn_tpu_torch.models.sgc import sgc_init
from textgcn_tpu_torch.parallel.distributed import all_reduce_sum
from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph
from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather, MeshOneHotAllGather, MeshOneHotHalo,
)
from textgcn_tpu_torch.parallel.partition import ShardCOO, shard_rows
from textgcn_tpu_torch.parallel.sharded import (
    sharded_appnp_forward, sharded_gat_forward, sharded_gcn_forward, sharded_gcnii_forward,
    sharded_gin_forward, sharded_sage_forward, sharded_sgc_forward,
)
from textgcn_tpu_torch.train.prepare import permute_rows_1d_docs
from textgcn_tpu_torch.train.trainer import EarlyStopping, TrainConfig, train_val_split

# family -> (init, sharded forward, layer-1 key), JAX's registry: under
# identity features the layer-1 group's node tables are rank-local. sgc_pre
# is not in it: its precompute removes the graph from training
SHARDED_MODELS = {
    "gcn": (gcn_init, sharded_gcn_forward, "gc1"),
    "gat": (gat_init, sharded_gat_forward, "gat1"),
    "sage": (sage_init, sharded_sage_forward, "sage1"),
    "sgc": (sgc_init, sharded_sgc_forward, "lin"),
    "appnp": (appnp_init, sharded_appnp_forward, "fc1"),
    "gin": (gin_init, sharded_gin_forward, "gin1"),
    "gcnii": (gcnii_init, sharded_gcnii_forward, "fc_in"),
}
SHARDED_KERNELS = ("segment", "onehot", "hybrid")
SHARDED_PARTITIONS = ("halo", "allgather")
# --spmm choices a sharded run takes (JAX's train/run.py gate)
SHARDED_SPMM = ("auto", "segment", "onehot", "hybrid")
# (kernel, partition) -> the rank's layout
_LAYOUTS = {
    ("segment", "allgather"): ShardCOO,
    ("segment", "halo"): HaloPartitionedGraph,
    ("onehot", "allgather"): MeshOneHotAllGather,
    ("onehot", "halo"): MeshOneHotHalo,
    ("hybrid", "allgather"): MeshHybridAllGather,
}


def sharded_kernel(spmm: str) -> str:
    """The mesh kernel that ``--spmm`` names under ``--shards`` (JAX's
    ``train/run.py``): ``onehot`` and ``hybrid`` themselves, ``auto`` and
    ``segment`` the plain segment sums; other formats raise."""
    if spmm not in SHARDED_SPMM:
        raise ValueError(
            "with --shards, the sharded path accepts --spmm auto|segment "
            "(plain per-shard aggregation), onehot (K2 per shard, or per halo "
            "ring step), or hybrid (degree-sorted per-shard BSR tiles + "
            "one-hot residual; needs --partition allgather); other "
            f"single-device formats don't partition (got {spmm!r})"
        )
    return spmm if spmm in ("onehot", "hybrid") else "segment"


def check_sharded(model: str, kernel: str, partition: str) -> None:
    """Raise for a sharded configuration that does not run, with the JAX
    package's gates and messages (``train/run.py``, ``ShardedTrainer``): a
    family outside :data:`SHARDED_MODELS` (``sgc_pre``), GAT on ``hybrid``,
    GAT's attention kernels off the all-gather partition, ``hybrid`` off
    it."""
    if model not in SHARDED_MODELS:
        raise ValueError(
            f"sharded training supports the {', '.join(sorted(SHARDED_MODELS))} "
            "families (sgc_pre's precompute removes the graph from training — "
            f"use --model sgc with --shards), got {model!r}"
        )
    if kernel not in SHARDED_KERNELS:
        raise ValueError(f"unknown mesh kernel: {kernel}")
    if partition not in SHARDED_PARTITIONS:
        raise ValueError(f"unknown partition strategy: {partition}")
    if model == "gat" and kernel not in ("segment", "onehot"):
        raise ValueError(
            "sharded GAT runs on kernel='segment' (COO edge stream; allgather "
            "or halo partition) or kernel='onehot' (the attention kernels, "
            "allgather partition); the hybrid BSR leg has no attention form"
        )
    if model == "gat" and kernel == "onehot" and partition != "allgather":
        raise ValueError(
            "sharded GAT with kernel='onehot' needs the allgather partition: "
            "row-partitioning keeps every softmax row's edges on its owner "
            "shard, which is what makes the attention kernels purely local; "
            "the halo ring's online softmax stays on kernel='segment'"
        )
    if kernel == "hybrid" and partition != "allgather":
        raise ValueError(
            "kernel='hybrid' runs on the allgather partition (the halo ring "
            "stays one-hot: P^2 BSR buckets would multiply zero-tile padding)"
        )


def masks_for_split(n_pad: int, idx: np.ndarray, dtype=np.float32) -> np.ndarray:
    m = np.zeros((n_pad,), dtype=dtype)
    m[np.asarray(idx)] = 1.0
    return m


def confusion(logits: torch.Tensor, y: torch.Tensor, w: torch.Tensor, num_classes: int):
    """Masked ``[C, C]`` confusion matrix: ``conf[t, p]`` = weight of the
    rows with target ``t`` predicted ``p``."""
    conf = torch.zeros(num_classes * num_classes, dtype=torch.float32, device=logits.device)
    return conf.index_add_(0, y * num_classes + logits.argmax(dim=1), w).reshape(
        num_classes, num_classes
    )


def metrics_from_confusion(conf: np.ndarray) -> Dict[str, float]:
    """Accuracy and the reference's macro P/R/F1 convention (F1 of the macro
    averages, 0 for an empty class) from a ``[C, C]`` confusion matrix."""
    conf = np.asarray(conf, dtype=np.float64)
    total = conf.sum()
    tp = np.diag(conf)
    fp = conf.sum(axis=0) - tp
    fn = conf.sum(axis=1) - tp
    prec = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1.0), 0.0)
    rec = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1.0), 0.0)
    p, r = float(prec.mean()), float(rec.mean())
    f1 = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return {
        "acc": float(tp.sum() / max(total, 1.0)),
        "macro_f1": f1,
        "precision": p,
        "recall": r,
    }


def node_tables(model: str) -> tuple:
    """The keys of family ``model``'s node tables under identity features:
    the leaves of its layer-1 group whose shape follows the input width
    (``gc1.w``; SAGE's ``sage1.w_self`` and ``sage1.w_neigh``; ...), found by
    drawing the family at two input widths."""
    init, _, layer1 = SHARDED_MODELS[model]
    a, b = (init(torch.Generator(), n, 8, 2, device="cpu") for n in (1, 2))
    return tuple(k for k in a if k.startswith(layer1 + ".") and a[k].shape != b[k].shape)


def _rank_rows(t: torch.Tensor, shard: int, rps: int) -> torch.Tensor:
    """Rank ``shard``'s ``[rps, ·]`` rows of a node table (zero past its end)."""
    local = t.new_zeros((rps, *t.shape[1:]))
    part = t[shard * rps : (shard + 1) * rps]
    local[: len(part)] = part
    return local


def local_params(full: Params, model: str, identity: bool, shard: int, rps: int) -> Params:
    """A rank's parameters from the whole model's (any node tables' row
    count: ``n_nodes`` or JAX's ``n_pad``): with identity features its rows
    of each of the family's node tables, every other leaf replicated."""
    tables = node_tables(model) if identity else ()
    return {
        k: (_rank_rows(v.detach(), shard, rps) if k in tables else v.detach().clone())
        for k, v in full.items()
    }


def shard_params_from_jax(
    params_np: dict, shard: int, rows_per_shard: int, identity: bool, *, model: str = "gcn",
    device,
) -> Params:
    """The JAX ``ShardedTrainer``'s parameters of family ``model`` (its
    pytree of host arrays; with identity features the node tables are
    ``[n_pad, ·]``) → rank ``shard``'s flat f32 parameter dict."""
    return local_params(params_from_jax(params_np, device=device), model, identity, shard,
                        rows_per_shard)


class ShardedTrainer:
    """Trains family ``config.model`` full-batch as rank ``rank`` of
    ``n_shards``.

    ``graph`` is the whole graph as a
    :class:`~textgcn_tpu_torch.graph.structs.SparseGraph` (any device; its
    host COO is read once), ``features`` the host ``[N, F]`` array or None
    for identity features. ``group`` is the process group (default: the
    default group); ``device`` is this rank's. ``partition`` and ``kernel``
    choose the rank's layout, with the JAX trainer's defaults (``halo``,
    ``segment``) and gates (:func:`check_sharded`).
    """

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
        n_shards: int,
        rank: int,
        device,
        group=None,
        partition: str = "halo",
        kernel: str = "segment",
    ):
        check_sharded(config.model, kernel, partition)
        if config.restore_best:
            raise NotImplementedError("restore_best is not ported to the sharded trainer")
        self.device = torch.device(device)
        self.group = group
        self.rank = int(rank)
        row, col, val = graph.coo_numpy()
        n = graph.n_nodes
        if kernel == "hybrid":
            # the single-device hybrid's degree sort: P Â Pᵀ (P x) = P (Â x)
            perm = degree_sort_permutation(row, col, n)
            row, col = perm[row], perm[col]
            if features is not None:
                features = permute_rows(np.asarray(features, dtype=np.float32), perm)
            target = permute_rows_1d_docs(np.asarray(target), perm)
            train_idx, test_idx = perm[np.asarray(train_idx)], perm[np.asarray(test_idx)]
        layout = (MeshAttentionAllGather if (config.model, kernel) == ("gat", "onehot")
                  else _LAYOUTS[kernel, partition])
        self.graph = layout.from_coo(
            row, col, val, n, n_shards, rank, device=self.device
        )
        self.rps, self.n_pad = self.graph.rows_per_shard, self.graph.n_pad
        self.n_nodes = n
        self.cfg = config
        self.num_classes = int(num_classes)
        self.y = self._local(np.asarray(target).astype(np.int64))
        self.x = None if features is None else self._local(np.asarray(features, np.float32))
        self.train_idx_all = np.asarray(train_idx)
        self.test_idx = np.asarray(test_idx)
        self.history: List[Dict[str, float]] = []
        self.params: Optional[Params] = None
        self.train_time = 0.0
        self.model_param = 0

    def _local(self, a: np.ndarray) -> torch.Tensor:
        """This rank's rows of a node-indexed host array, on its device."""
        return torch.from_numpy(shard_rows(a, self.rank, self.rps)).to(self.device)

    def _mask(self, idx: np.ndarray) -> torch.Tensor:
        return self._local(masks_for_split(self.n_pad, idx))

    def _forward(self, train: bool, generator=None) -> torch.Tensor:
        return SHARDED_MODELS[self.cfg.model][1](
            self.params, self.graph, self.x, group=self.group,
            dropout=self.cfg.dropout, train=train, generator=generator,
        )

    def _eval_sums(self, logits, mask) -> torch.Tensor:
        """This rank's [nll sum, confusion...] over the rows of ``mask``."""
        nll = F.cross_entropy(logits, self.y, reduction="none")
        conf = confusion(logits, self.y, mask, self.num_classes)
        return torch.cat([(nll * mask).sum()[None], conf.flatten()])

    def fit(self, verbose: bool = True, params: Optional[Params] = None) -> Dict[str, Any]:
        """Train to ``max_epoch`` or an early stop (every rank together).

        ``params``: this rank's starting parameters (e.g.
        :func:`shard_params_from_jax`); by default the whole model is drawn
        from the generator seeded with ``cfg.seed``, as the single-device
        ``Trainer`` draws it, and the rank keeps its rows.
        """
        cfg, C = self.cfg, self.num_classes
        tr, va = train_val_split(self.train_idx_all, cfg.val_ratio, cfg.seed)
        tmask, vmask = self._mask(tr), self._mask(va)
        identity = self.x is None
        n_feat = self.n_nodes if identity else self.x.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        init = SHARDED_MODELS[cfg.model][0]
        if params is None:
            full = init(gen, n_feat, cfg.n_hidden, C, device=self.device)
            params = local_params(full, cfg.model, identity, self.rank, self.rps)
            del full
        self.params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        tables = node_tables(cfg.model) if identity else ()
        # the single-device count: each node table has n_nodes rows
        self.model_param = sum(
            self.n_nodes * v.shape[1] if k in tables else v.numel()
            for k, v in self.params.items()
        )
        # every rank holds and updates the same copy of these
        replicated = [k for k in self.params if k not in tables]
        opt = torch.optim.Adam(self.params.values(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        stopper = EarlyStopping(cfg.early_stopping)

        start = time.perf_counter()
        for epoch in range(cfg.max_epoch):
            logits = self._forward(True, gen)
            nll = F.cross_entropy(logits, self.y, reduction="none")
            loss = (nll * tmask).sum() / len(tr)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            grads = all_reduce_sum(
                torch.cat([self.params[k].grad.flatten() for k in replicated]), self.group
            )
            for k, g in zip(replicated, grads.split([self.params[k].numel() for k in replicated])):
                self.params[k].grad.copy_(g.view_as(self.params[k]))
            opt.step()

            with torch.no_grad():
                sums = all_reduce_sum(
                    torch.cat([loss.detach()[None], self._eval_sums(self._forward(False), vmask)]),
                    self.group,
                ).tolist()
            rec = {
                "epoch": epoch,
                "train_loss": sums[0],
                "val_loss": sums[1] / len(va),
                **metrics_from_confusion(np.asarray(sums[2:]).reshape(C, C)),
            }
            self.history.append(rec)
            if verbose:
                print(
                    " ".join(
                        f"{k}:{v}" if isinstance(v, int) else f"{k}:{v:.4f}"
                        for k, v in rec.items()
                    )
                )
            if stopper(rec["val_loss"]):
                break  # the params of the stopping epoch are kept
        self.train_time = time.perf_counter() - start
        return {"epochs_run": len(self.history), "train_time": self.train_time}

    def evaluate(self, idx: np.ndarray, prefix: str = "test") -> Dict[str, float]:
        if self.params is None:
            raise ValueError("fit() first")
        with torch.no_grad():
            sums = all_reduce_sum(
                self._eval_sums(self._forward(False), self._mask(idx)), self.group
            ).tolist()
        out = {f"{prefix}_loss": sums[0] / len(idx)}
        out.update(metrics_from_confusion(np.asarray(sums[1:]).reshape(self.num_classes, -1)))
        return out

    def test(self) -> Dict[str, float]:
        out = self.evaluate(self.test_idx, prefix="test")
        out["train_time"] = self.train_time
        out["model_param"] = self.model_param
        return out
