"""Start the ranks of a sharded run on one machine and train on them.

No JAX counterpart: there one process drives every device of a mesh. Here
each device has its own rank. :func:`spawn_ranks` runs rank 0 in the calling
process and spawns ranks 1..N-1 (``torch.multiprocessing``, ``spawn``), all
joined through a ``file://`` store in a temporary directory; every rank
leaves its process group when its work ends. A spawned child imports this
module and the port, nothing else of its parent. The children are joined
with a time limit and terminated past it, so a rank that fails cannot leave
the others waiting for ever: a collective that waits longer than
``timeout_s`` raises in every rank.

:func:`run_sharded_seeds` trains one or more seeds of
:class:`~textgcn_tpu_torch.parallel.trainer.ShardedTrainer` on such ranks
from host data the caller prepared once (numpy arrays, sent to each child),
or resumes one from a checkpoint, and saves the best run's checkpoints on
request; :func:`run_sharded_experiment` (the port of JAX's, in
``textgcn_tpu/parallel/trainer.py``) its summary over seeds.
:func:`run_joined` trains the same way on ranks that an outside launcher
started and joined (``torchrun``, ``srun``, ``mpirun``; one machine or
several), after the join the same code as a spawned rank's.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.ops import _build
from textgcn_tpu_torch.parallel import distributed
from textgcn_tpu_torch.parallel.trainer import ShardedTrainer, shard_params_from_jax
from textgcn_tpu_torch.train.trainer import TrainConfig


def _on_group(fn, device, args):
    """``fn(rank, world, device, *args)`` on this rank of the joined default
    group: the one code after the join, for spawned and launcher-started
    ranks alike."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return fn(dist.get_rank(), dist.get_world_size(), device, *args)


def _rank_main(rank, world, backend, device, init_method, timeout_s, fn, args):
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)  # before the join: NCCL binds the current GPU
    cfg = distributed.DistributedConfig(init_method, world, rank)
    distributed.init_process_group(cfg, backend, timeout_s)
    try:
        return _on_group(fn, device, args)
    finally:
        dist.destroy_process_group()


def _child(i, world, backend, devices, init_method, timeout_s, fn, args):
    rank = i + 1
    if torch.device(devices[rank]).type == "cpu":
        # CPU ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _rank_main(rank, world, backend, devices[rank], init_method, timeout_s, fn, args)


def spawn_ranks(
    fn: Callable,
    world: int,
    args: Sequence = (),
    *,
    backend: str,
    devices: Sequence,
    timeout_s: float = 600.0,
) -> Any:
    """Run ``fn(rank, world, device, *args)`` on ``world`` ranks, rank ``r``
    on ``devices[r]``, each inside an initialized default process group;
    return rank 0's result.

    ``fn`` must be importable by name (a module-level function) and ``args``
    picklable. If any rank raises, this raises once every child has ended or
    been terminated; a child still running ``timeout_s`` after rank 0
    returned is terminated and reported.
    """
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {list(devices)}")
    store_dir = tempfile.mkdtemp(prefix="textgcn_store_")
    init_method = "file://" + os.path.join(store_dir, "store")
    ctx = None
    try:
        if world > 1:
            ctx = mp.start_processes(
                _child,
                args=(world, backend, [str(d) for d in devices], init_method, timeout_s, fn, args),
                nprocs=world - 1,
                join=False,
                start_method="spawn",
            )
        result = _rank_main(0, world, backend, devices[0], init_method, timeout_s, fn, args)
        if ctx is not None:
            deadline = time.monotonic() + timeout_s
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"a rank did not end {timeout_s} s after rank 0")
        return result
    finally:
        if ctx is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
        shutil.rmtree(store_dir, ignore_errors=True)


@dataclasses.dataclass
class HostData:
    """The whole graph and its labels as host arrays, made once by the
    caller and sent to every rank."""

    row: np.ndarray
    col: np.ndarray
    val: np.ndarray
    n_nodes: int
    features: Optional[np.ndarray]
    target: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray
    n_classes: int

    @staticmethod
    def from_prepared(pre) -> "HostData":
        """From a :class:`~textgcn_tpu_torch.train.prepare.PreparedData`
        whose graph is still the unconverted ``SparseGraph``."""
        if not isinstance(pre.graph, SparseGraph):
            raise TypeError(
                f"sharded training starts from the SparseGraph, got {type(pre.graph).__name__}"
            )
        row, col, val = pre.graph.coo_numpy()
        lab = pre.labels
        return HostData(
            row, col, val, pre.graph.n_nodes, pre.features, np.asarray(lab.target),
            np.asarray(lab.train_idx), np.asarray(lab.test_idx), lab.n_classes,
        )

    def graph(self) -> SparseGraph:
        """The host COO as a CPU ``SparseGraph`` (unpadded)."""
        e = len(self.row)
        return SparseGraph(
            torch.from_numpy(self.row.astype(np.int64)), torch.from_numpy(self.col.astype(np.int64)),
            torch.from_numpy(self.val.astype(np.float32)), self.n_nodes, e,
        )


def _train_seeds(rank, world, device, data: HostData, seeds, config, kernel, partition,
                 verbose, params_np, save_model=None, save_state=None, resume_from=None):
    """Each seed on this rank (or the one run that ``resume_from`` continues).
    Every rank reads the same all-reduced test accuracy, so every rank keeps
    the same best run; after the last seed all ranks save it together."""
    runs, best, best_acc = [], None, -1.0
    for seed in seeds:
        trainer = ShardedTrainer(
            data.graph(), data.features, data.target, data.train_idx, data.test_idx,
            data.n_classes, config=dataclasses.replace(config, seed=seed),
            n_shards=world, rank=rank, device=device, partition=partition, kernel=kernel,
        )
        params = None
        if params_np is not None:
            params = shard_params_from_jax(
                params_np, rank, trainer.rps, data.features is None, model=config.model,
                device=device,
            )
        trainer.fit(verbose=verbose and rank == 0, params=params, resume_from=resume_from)
        test = trainer.test()
        runs.append({
            "seed": seed,
            "test": test,
            "epochs_run": len(trainer.history),
            "history": trainer.history,
        })
        if (save_model or save_state) and test["acc"] > best_acc:
            best, best_acc = trainer, test["acc"]
        del trainer
    out = {"runs": runs}
    if save_model:
        out["checkpoint"] = best.save(save_model)
    if save_state:
        out["resumable_checkpoint"] = best.save_training_state(save_state)
    return out if rank == 0 else None


def run_sharded_seeds(
    data: HostData,
    seeds: List[int],
    config: TrainConfig,
    n_shards: int,
    *,
    kernel: str = "hybrid",
    partition: str = "allgather",
    backend: str,
    devices: Sequence,
    verbose: bool = False,
    params_np: Optional[dict] = None,
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    resume_from: Optional[str] = None,
    timeout_s: float = 600.0,
) -> Dict[str, Any]:
    """Train each seed on ``n_shards`` ranks (rank ``r`` on ``devices[r]``)
    and return rank 0's ``{"runs": [...]}``, each run ``{"seed", "test",
    "epochs_run", "history"}`` as
    :func:`~textgcn_tpu_torch.train.run.run_experiment` reports them.

    ``params_np``: the JAX ``ShardedTrainer``'s starting parameters of the
    family ``config.model``
    (:func:`~textgcn_tpu_torch.parallel.trainer.shard_params_from_jax`).
    ``save_model`` / ``save_state``: directories for the best run's
    checkpoint and resumable state (all ranks save together), reported
    under ``"checkpoint"`` and ``"resumable_checkpoint"``.
    ``resume_from``: a resumable checkpoint of either trainer; ``seeds`` is
    then its one seed."""
    if any(torch.device(d).type == "cuda" for d in devices):
        _build.build()  # one nvcc run here, not one per rank at its first launch
    paths = [None if p is None else os.path.abspath(p) for p in (save_model, save_state,
                                                                 resume_from)]
    return spawn_ranks(
        _train_seeds, n_shards,
        (data, list(seeds), config, kernel, partition, verbose, params_np, *paths),
        backend=backend, devices=devices, timeout_s=timeout_s,
    )


def run_joined(
    data: HostData,
    seeds: List[int],
    config: TrainConfig,
    *,
    kernel: str,
    partition: str,
    device,
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    resume_from: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """:func:`run_sharded_seeds` on a group that is already joined (by
    :func:`~textgcn_tpu_torch.parallel.distributed.init_distributed`, in a
    rank that ``torchrun``, ``srun`` or ``mpirun`` started): every rank of
    the default group calls it with the same arguments and its own
    ``device``; rank and world size are the group's. Spawns nothing and
    leaves the group joined. Returns rank 0's ``{"runs", ...}``, None on
    the other ranks.

    Rank 0 writes ``save_model`` / ``save_state``, and every rank reads
    ``resume_from``: across machines these paths must lie on a file system
    that every machine shares."""
    if not dist.is_initialized():
        raise RuntimeError("run_joined needs a joined process group: call init_distributed() first")
    paths = [None if p is None else os.path.abspath(p) for p in (save_model, save_state,
                                                                 resume_from)]
    return _on_group(
        _train_seeds, device, (data, list(seeds), config, kernel, partition, False, None, *paths),
    )


def run_sharded_experiment(
    graph: SparseGraph,
    features: Optional[np.ndarray],
    target: np.ndarray,
    train_idx: np.ndarray,
    test_idx: np.ndarray,
    num_classes: int,
    seeds: List[int],
    config: TrainConfig = TrainConfig(),
    n_shards: Optional[int] = None,
    partition: str = "halo",
    kernel: str = "segment",
    verbose: bool = False,
    *,
    backend: Optional[str] = None,
    devices: Optional[Sequence] = None,
) -> Dict[str, Any]:
    """Multi-seed sharded runs, the mesh analogue of ``run_experiment``
    (JAX's arguments and keys: ``partition``, ``kernel``, ``n_shards``,
    ``test_accuracy`` {mean, max, min}, ``runs`` of ``{"seed", "test",
    "epochs"}``). ``devices``: one per rank (default: ``cuda:0 ..
    cuda:{n_shards-1}``, ``n_shards`` by default every visible GPU);
    ``backend``: NCCL on CUDA devices, gloo on the CPU by default."""
    if devices is None:
        n_shards = n_shards or torch.cuda.device_count()
        devices = [f"cuda:{r}" for r in range(n_shards)]
    n_shards = n_shards or len(devices)
    if backend is None:
        backend = "nccl" if torch.device(devices[0]).type == "cuda" else "gloo"
    row, col, val = graph.coo_numpy()
    data = HostData(row, col, val, graph.n_nodes, features, np.asarray(target),
                    np.asarray(train_idx), np.asarray(test_idx), int(num_classes))
    runs = run_sharded_seeds(data, seeds, config, n_shards, kernel=kernel, partition=partition,
                             backend=backend, devices=devices, verbose=verbose)["runs"]
    accs = [r["test"]["acc"] for r in runs]
    return {
        "partition": partition,
        "kernel": kernel,
        "n_shards": n_shards,
        "test_accuracy": {
            "mean": float(np.mean(accs)),
            "max": float(np.max(accs)),
            "min": float(np.min(accs)),
        },
        "runs": [{"seed": r["seed"], "test": r["test"], "epochs": r["epochs_run"]} for r in runs],
    }
