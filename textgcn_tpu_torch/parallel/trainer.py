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
- Checkpoints (``save``, ``save_training_state``, ``load``,
  ``fit(resume_from=)``; JAX's ``_tables_to_canonical`` and ``_place``):
  every rank calls them together. A node table and its Adam moments are
  gathered over the ranks and stored as ``[n_nodes, ·]`` in the artifact's
  own node order (padding stripped, the hybrid's degree sort undone), the
  other parameters as they are; rank 0 writes the file, in the schema of
  the single-device ``Trainer`` (node order 0), so either trainer loads or
  resumes the other's checkpoint at any rank count. On resume the
  canonical rows are put back in this trainer's order and split over the
  ranks; the padding rows are zero, as the init leaves them and as an
  uninterrupted run keeps them (they get no gradient). ``restore_best`` is
  refused (the JAX sharded trainer ignores it without a word).

Not ported: the ``epoch_block`` scan (A.3's CUDA graph is its counterpart).
"""
from __future__ import annotations

import os
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
from textgcn_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum
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
from textgcn_tpu_torch.ops.split import fingerprint
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from textgcn_tpu_torch.train.prepare import permute_rows_1d_docs
from textgcn_tpu_torch.train.trainer import (  # noqa: F401 (node_tables: the sharded API)
    EarlyStopping, TrainConfig, _progress_metadata, adam_by_name, adam_state_dict, check_family,
    layout_refused, node_tables, relabel, stopped_refused, train_val_split, unlabel,
)

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


def check_sharded_config(config: TrainConfig) -> None:
    """Raise for a setting of ``config`` the sharded trainer refuses:
    ``restore_best`` (the JAX sharded trainer ignores it without a word)."""
    if config.restore_best:
        raise NotImplementedError(
            "restore_best is not ported to the sharded trainer (the JAX sharded "
            "trainer ignores it)"
        )


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
        check_sharded_config(config)
        self.device = torch.device(device)
        self.group = group
        self.rank = int(rank)
        self.n_shards, self.partition, self.kernel = int(n_shards), partition, kernel
        # kept for the degree sort that a single-card hybrid checkpoint's
        # node order names, computed only when such a checkpoint is read
        self.host_graph = graph
        row, col, val = graph.coo_numpy()
        n = graph.n_nodes
        self.perm = None
        if kernel == "hybrid":
            # the single-device hybrid's degree sort: P Â Pᵀ (P x) = P (Â x)
            perm = self.perm = degree_sort_permutation(row, col, n)
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
        self._live: Optional[Dict[str, Any]] = None

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

    def _tables(self) -> tuple:
        return node_tables(self.cfg.model) if self.x is None else ()

    def _set_params(self, params: Params) -> None:
        """This rank's parameters (on its device, requiring grad) and the
        single-device parameter count (each node table has n_nodes rows)."""
        tables = self._tables()
        self.params = {k: v.detach().to(self.device).clone().requires_grad_(True)
                       for k, v in params.items()}
        self.model_param = sum(
            self.n_nodes * v.shape[1] if k in tables else v.numel()
            for k, v in self.params.items()
        )

    def _from_checkpoint(self, path: str, md: Dict[str, Any], tensors: Params) -> Params:
        """A checkpoint's node tables ([n_nodes, ·], of node order 0 or of
        this graph's degree sort) in this trainer's order, split to this
        rank's rows; the other tensors as they are. Refuses another family
        or another node order."""
        check_family(path, md, self.cfg.model)
        tables = self._tables()
        sort = None
        if tables and md.get("node_order") != 0:
            # a single-card hybrid's order: this graph's degree sort, undone
            sort = self.perm
            if sort is None:
                row, col, _ = self.host_graph.coo_numpy()
                sort = degree_sort_permutation(row, col, self.n_nodes)
            if md.get("node_order") != fingerprint(sort):
                raise layout_refused(path)
        full = {}
        for k, v in tensors.items():
            if k in tables:
                if sort is not None:
                    v = unlabel(v, sort)
                if self.perm is not None:
                    v = relabel(v, self.perm)
            full[k] = v
        return local_params(full, self.cfg.model, bool(tables), self.rank, self.rps)

    def fit(
        self,
        verbose: bool = True,
        params: Optional[Params] = None,
        resume_from: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Train to ``max_epoch`` or an early stop (every rank together).

        ``params``: this rank's starting parameters (e.g.
        :func:`shard_params_from_jax`); by default the whole model is drawn
        from the generator seeded with ``cfg.seed``, as the single-device
        ``Trainer`` draws it, and the rank keeps its rows.

        ``resume_from``: a checkpoint of :meth:`save_training_state` of
        either trainer, at any rank count. The params, Adam's state (this
        rank's rows of each node table's moments), the epoch and early-stop
        counters and the dropout generator's state are restored (the init
        draws are skipped), and training continues at the saved epoch: on
        the same ranks and layout, with an uninterrupted run's bits. A run
        that stopped early is refused, as in JAX.
        """
        cfg, C = self.cfg, self.num_classes
        tr, va = train_val_split(self.train_idx_all, cfg.val_ratio, cfg.seed)
        tmask, vmask = self._mask(tr), self._mask(va)
        identity = self.x is None
        n_feat = self.n_nodes if identity else self.x.shape[1]
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        stopper = EarlyStopping(cfg.early_stopping)
        best_val, start_epoch, state = float("inf"), 0, None
        if resume_from is not None:
            state = restore_checkpoint(resume_from)
            md = state["metadata"]
            if md["stopped"]:
                raise stopped_refused(resume_from)
            params = self._from_checkpoint(resume_from, md, state["params"])
            saved = adam_by_name(state["opt_state"], list(state["params"]))
            moments = {
                k: {m: v for m, v in s.items() if m not in ("exp_avg", "exp_avg_sq")}
                for k, s in saved.items()
            }
            for m in ("exp_avg", "exp_avg_sq"):
                local = self._from_checkpoint(
                    resume_from, md, {k: s[m] for k, s in saved.items()})
                for k, v in local.items():
                    moments[k][m] = v
            start_epoch = md["epoch"]
            best_val = md["best_val"]
            stopper.best_score = None if np.isinf(md["stopper_best"]) else md["stopper_best"]
            stopper.counter = md["stopper_counter"]
            gen.set_state(state["generator"])
        elif params is None:
            init = SHARDED_MODELS[cfg.model][0]
            full = init(gen, n_feat, cfg.n_hidden, C, device=self.device)
            params = local_params(full, cfg.model, identity, self.rank, self.rps)
            del full
        self._set_params(params)
        tables = self._tables()
        # every rank holds and updates the same copy of these
        replicated = [k for k in self.params if k not in tables]
        opt = torch.optim.Adam(self.params.values(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
        if state is not None:
            opt.load_state_dict(adam_state_dict(
                moments, list(self.params), state["opt_state"]["param_groups"][0]))

        stopped = False
        epoch = start_epoch
        start = time.perf_counter()
        while epoch < cfg.max_epoch and not stopped:
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
            epoch += 1
            best_val = min(best_val, rec["val_loss"])
            # on a stop the params of the stopping epoch are kept
            stopped = stopper(rec["val_loss"])
        self.train_time = time.perf_counter() - start
        self._live = {
            "opt": opt,
            "generator": gen.get_state(),
            "metadata": _progress_metadata(
                epoch, best_val,
                float("inf") if stopper.best_score is None else stopper.best_score,
                stopper.counter, int(stopped), cfg.seed,
            ),
        }
        return {"epochs_run": len(self.history), "train_time": self.train_time}

    # -- checkpoints: every rank calls these together ----------------------

    def _canonical(self, local: Params) -> Params:
        """Host copies of this rank's tensors by parameter name: each node
        table gathered over the ranks, its padding stripped and its
        relabeling undone ([n_nodes, ·], node order 0)."""
        tables = self._tables()
        out = {}
        for k, v in local.items():
            v = v.detach()
            if k in tables:
                v = all_gather_rows(v, self.group)[: self.n_nodes]
                if self.perm is not None:
                    v = unlabel(v, self.perm)
            out[k] = v.cpu()
        return out

    def _metadata(self) -> Dict[str, Any]:
        """What a checkpoint records of the run's layout: the single-device
        ``Trainer``'s keys (node order 0: canonical tables) and the mesh."""
        return {"model": self.cfg.model, "n_hidden": self.cfg.n_hidden, "node_order": 0,
                "n_shards": self.n_shards, "partition": self.partition, "kernel": self.kernel}

    def _write(self, path: str, params: Params, **state) -> str:
        """Rank 0 writes the checkpoint; every rank waits until it is
        written and returns its absolute path. The wait reads the result of
        an all-reduce that rank 0 joins only after its write, so the host
        blocks on NCCL as on gloo (an NCCL collective alone only queues work
        on the card)."""
        if self.rank == 0:
            save_checkpoint(path, params, **state)
        all_reduce_sum(torch.zeros(1, device=self.device), self.group).item()
        return os.path.abspath(path)

    def save(self, path: str) -> str:
        """Checkpoint of the trained params for evaluation (either trainer's
        ``load``, any rank count), with the run's metadata; returns its
        path."""
        if self.params is None:
            raise ValueError("fit() first")
        return self._write(path, self._canonical(self.params), metadata={
            "epochs_run": len(self.history), "seed": self.cfg.seed, **self._metadata()})

    def save_training_state(self, path: str) -> str:
        """Resumable checkpoint: the live params, Adam's state, the progress
        counters and the dropout generator's state, in the single-device
        ``Trainer``'s schema (Adam's state in the order of the params);
        either trainer's ``fit(resume_from=)`` continues it at any rank
        count. Returns its path."""
        if self._live is None:
            raise ValueError("fit() first")
        opt = self._live["opt"]
        names = list(self.params)
        moments = {m: self._canonical({k: opt.state[self.params[k]][m] for k in names})
                   for m in ("exp_avg", "exp_avg_sq")}
        by_name = {k: {**opt.state[self.params[k]], **{m: moments[m][k] for m in moments}}
                   for k in names}
        opt_state = adam_state_dict(by_name, names, opt.state_dict()["param_groups"][0])
        return self._write(
            path, self._canonical(self.params), opt_state=opt_state,
            metadata={**self._live["metadata"], **self._metadata()},
            generator=self._live["generator"],
        )

    def load(self, path: str) -> None:
        """Restore params from a checkpoint of either trainer (``save`` or
        ``save_training_state``, any rank count), for :meth:`evaluate`.
        With identity features the checkpoint's node order must be 0 or
        this graph's degree sort (a single-card hybrid's), which is undone;
        another order, or another family, is refused."""
        state = restore_checkpoint(path)
        self._set_params(self._from_checkpoint(path, state.get("metadata", {}), state["params"]))

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
