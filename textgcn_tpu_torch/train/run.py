"""Multi-seed training runner, resume and checkpoint evaluation, and their
human/machine reports.

Port of ``textgcn_tpu/train/run.py`` (``run_experiment`` on the topic or
doc-word graph, on one device for every model family with GAT's own
layouts and ``sgc_pre``'s precompute, and sharded over ``n_shards`` devices
for every family but ``sgc_pre``; ``resume_training``, ``evaluate_checkpoint``,
``generate_seeds``, ``aggregate``, ``write_reports``). The three entry
points share one preparation (:func:`_prepare_for_training`: the checks,
the data, the graph format, the precompute), so a resumed or evaluated run
cannot drift from a fresh one. The reports keep the JAX package's schema:
``{ds}_{family}_training_results.json`` (with full per-epoch histories and
hyperparameters, and ``"sharding"`` for a sharded run) and ``.txt``. The
summary also names the device it ran on.
"""
from __future__ import annotations

import dataclasses
import json
import os
import random
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from textgcn_tpu_torch.graph.format import DENSE_MAX_NODES, MachineModel, gat_auto_format
from textgcn_tpu_torch.models.sgc import sgc_precompute
from textgcn_tpu_torch.parallel.launch import HostData, run_sharded_seeds
from textgcn_tpu_torch.parallel.trainer import check_sharded, check_sharded_config, sharded_kernel
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint
from textgcn_tpu_torch.train.prepare import (
    PreparedData,
    apply_attention_format,
    apply_dense_attention_format,
    apply_spmm_format,
    prepare_docword_data,
    prepare_topic_data,
)
from textgcn_tpu_torch.train.trainer import TrainConfig, Trainer
from textgcn_tpu_torch.utils.profiling import device_memory

# --spmm spellings GAT takes: onehot / hybrid = the attention-kernel layout
# without / with the degree sort, dense = the dense log-adjacency, auto =
# dense while its priced peak fits (graph.format.gat_auto_format), else
# hybrid, segment = the plain PyTorch oracle
GAT_FORMATS = ("auto", "segment", "dense", "onehot", "hybrid")


def apply_gat_format(pre: PreparedData, fmt: str, mm: Optional[MachineModel] = None) -> PreparedData:
    """Convert ``pre.graph`` to the GAT layout that ``fmt`` names (``auto``
    priced with ``mm``, the H100 defaults when None)."""
    if fmt == "auto":
        fmt = gat_auto_format(pre.graph.n_nodes, mm, dense_max_nodes=DENSE_MAX_NODES)
    if fmt in ("onehot", "hybrid"):
        return apply_attention_format(pre, degree_sort=fmt == "hybrid")
    if fmt == "dense":
        return apply_dense_attention_format(pre)
    if fmt != "segment":
        raise ValueError(f"GAT takes --spmm {' | '.join(GAT_FORMATS)}, got {fmt!r}")
    return pre


def generate_seeds(nums: int, master_seed: Optional[int] = None) -> List[int]:
    rng = random.Random(master_seed)
    return rng.sample(range(0, 100000), nums)


def aggregate(values: List[float]) -> Dict[str, float]:
    return {
        "mean": float(np.mean(values)),
        "max": float(np.max(values)),
        "min": float(np.min(values)),
    }


def check_graph_family(graph_family: str) -> None:
    """``graph_family`` names the reports (``{ds}_{graph_family}_training_results``):
    as in JAX, ``docword`` reads the doc-word graph and any other name the
    topic graph (``bench.py`` names its GAT pass ``topic_gat``). Refuses a
    name that cannot be part of a file name."""
    if not graph_family or any(s and s in graph_family for s in (os.sep, os.altsep)):
        raise ValueError(f"graph family {graph_family!r} cannot name a report file")


def prepare_data(dataset: str, graph_family: str, data_root: str, *, device) -> PreparedData:
    """The graph family's prepared data on ``device``: the doc-word graph
    for ``docword``, else the topic graph (a stale theta cache is
    re-inferred there)."""
    if graph_family == "docword":
        return prepare_docword_data(dataset, data_root=data_root, device=device)
    return prepare_topic_data(dataset, data_root=data_root, device=device)


def apply_sgc_precompute(pre: PreparedData, *, device) -> PreparedData:
    """``sgc_pre``'s features: Â^K X propagated once before training,
    through the graph's format on ``device``, where the graph lives."""
    if pre.features is None:
        raise ValueError(
            "sgc_pre needs dense node features to precompute Â^K X; "
            "identity-feature (docword) graphs have none — use --model "
            "sgc instead"
        )
    x = torch.tensor(pre.features, dtype=torch.float32, device=device)
    with torch.no_grad():
        feats = sgc_precompute(pre.graph, x).cpu().numpy()
    return dataclasses.replace(pre, features=feats)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _prepare_for_training(
    dataset: str,
    graph_family: str,
    data_root: str,
    config: TrainConfig,
    pre_data: Optional[PreparedData],
    *,
    device: torch.device,
    n_shards: Optional[int] = None,
    partition: str = "halo",
) -> PreparedData:
    """The one preparation under :func:`run_experiment`,
    :func:`resume_training` and :func:`evaluate_checkpoint`: the sharded and
    graph-family checks (before any data is read), the data, and, for one
    device, the family's graph format and ``sgc_pre``'s precompute. A
    sharded run gets the unformatted data: each rank builds its shard."""
    if n_shards is not None:
        check_sharded(config.model, sharded_kernel(config.spmm), partition)
        check_sharded_config(config)
    check_graph_family(graph_family)
    if pre_data is None:
        pre_data = prepare_data(dataset, graph_family, data_root, device=device)
    if n_shards is not None:
        return pre_data
    if config.model == "gat":
        pre_data = apply_gat_format(pre_data, config.spmm)
    else:
        pre_data = apply_spmm_format(pre_data, config.spmm)
    if config.model == "sgc_pre":
        pre_data = apply_sgc_precompute(pre_data, device=device)
    return pre_data


def _sharding(n_shards: int, partition: str, config: TrainConfig) -> Dict[str, Any]:
    return {"n_shards": n_shards, "partition": partition, "kernel": sharded_kernel(config.spmm)}


def _run_sharded(pre: PreparedData, seeds, config: TrainConfig, n_shards: int, partition: str,
                 device: torch.device, verbose: bool, **kw) -> Dict[str, Any]:
    """The seeds on ``n_shards`` ranks: rank ``r`` on ``cuda:r`` (NCCL) for a
    CUDA ``device``, else on CPU processes (gloo). The data was prepared
    once; each rank builds its own shard from the host arrays."""
    cuda = device.type == "cuda"
    return run_sharded_seeds(
        HostData.from_prepared(pre), seeds, config, n_shards,
        kernel=sharded_kernel(config.spmm), partition=partition,
        backend="nccl" if cuda else "gloo",
        devices=[f"cuda:{r}" for r in range(n_shards)] if cuda else ["cpu"] * n_shards,
        verbose=verbose, **kw,
    )


def _make_trainer(pre: PreparedData, cfg: TrainConfig, device: torch.device) -> Trainer:
    """The one construction site of a single-device Trainer."""
    return Trainer(
        pre.graph,
        pre.features,
        pre.labels.target,
        pre.labels.train_idx,
        pre.labels.test_idx,
        pre.labels.n_classes,
        config=cfg,
        device=device,
        perm=pre.perm,
    )


def run_experiment(
    dataset: str,
    times: int = 1,
    graph_family: str = "topic",
    data_root: str = "data",
    output_dir: str = "results",
    config: TrainConfig = TrainConfig(),
    seeds: Optional[List[int]] = None,
    pre_data: Optional[PreparedData] = None,
    verbose: bool = True,
    n_shards: Optional[int] = None,
    partition: str = "halo",
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    *,
    device,
) -> Dict[str, Any]:
    """Train ``times`` seeds on ``dataset`` on ``device``; write reports;
    return the summary.

    ``save_model``: a checkpoint directory for the best-accuracy run's
    params (:meth:`Trainer.save`); ``save_state``: one for its resumable
    state (:meth:`Trainer.save_training_state`, continued by
    :func:`resume_training`). A sharded run's ranks save its best run
    together, in the same schema (node order 0), so either trainer loads or
    resumes it.

    ``n_shards``: train row-sharded over that many ranks
    (:mod:`textgcn_tpu_torch.parallel`), rank ``r`` on ``cuda:r`` with NCCL
    for a CUDA ``device``, or on CPU processes with gloo for the CPU. Rank 0
    runs in this process. ``partition`` is ``halo`` (the JAX default) or
    ``allgather``; the kernel is what ``config.spmm`` names under
    ``--shards`` (:func:`~textgcn_tpu_torch.parallel.trainer.sharded_kernel`:
    ``auto`` is ``segment``, as in JAX), for any family of
    :data:`~textgcn_tpu_torch.parallel.trainer.SHARDED_MODELS`; see
    :func:`~textgcn_tpu_torch.parallel.trainer.check_sharded` for what runs.
    """
    device = torch.device(device)
    pre_data = _prepare_for_training(
        dataset, graph_family, data_root, config, pre_data,
        device=device, n_shards=n_shards, partition=partition,
    )
    seeds = seeds or generate_seeds(times)
    if n_shards is not None:
        out = _run_sharded(pre_data, seeds, config, n_shards, partition, device, verbose,
                           save_model=save_model, save_state=save_state)
        runs = out.pop("runs")
        if verbose:
            for path in out.values():
                print(f"saved the best run's checkpoint to {path}")
        return _summarize(dataset, graph_family, output_dir, config, runs, device,
                          _sharding(n_shards, partition, config), extra=out)

    runs: List[Dict[str, Any]] = []
    best_acc, best = -1.0, None
    for i, seed in enumerate(seeds):
        trainer = _make_trainer(pre_data, dataclasses.replace(config, seed=seed), device)
        trainer.fit(verbose=verbose)
        test_desc = trainer.test()
        if verbose:
            print(f"[run {i + 1}/{len(seeds)} seed={seed}] {test_desc}")
        if test_desc["acc"] > best_acc:
            best_acc, best = test_desc["acc"], trainer
        runs.append(
            {
                "seed": seed,
                "test": test_desc,
                "epochs_run": len(trainer.history),
                "history": trainer.history,
            }
        )
    extra = {}
    if save_model:
        extra["checkpoint"] = best.save(save_model)
        if verbose:
            print(f"saved best-run checkpoint (acc={best_acc:.4f}) to {extra['checkpoint']}")
    if save_state:
        extra["resumable_checkpoint"] = best.save_training_state(save_state)
        if verbose:
            print(f"saved resumable training state to {extra['resumable_checkpoint']}")
    return _summarize(dataset, graph_family, output_dir, config, runs, device, extra=extra)


def resume_training(
    dataset: str,
    resume_dir: str,
    graph_family: str = "topic",
    data_root: str = "data",
    output_dir: str = "results",
    config: TrainConfig = TrainConfig(),
    pre_data: Optional[PreparedData] = None,
    verbose: bool = True,
    save_model: Optional[str] = None,
    save_state: Optional[str] = None,
    n_shards: Optional[int] = None,
    partition: str = "halo",
    *,
    device,
) -> Dict[str, Any]:
    """Continue an interrupted single-seed run from a resumable checkpoint
    (``save_training_state``, ``cli train --save_state``). The seed is read
    from the checkpoint, so the train/val split and the dropout draws go on
    as they were; the resumed run gives the uninterrupted run's bits on the
    same device and layout. Preparation and the trainer are
    :func:`run_experiment`'s. ``save_model`` / ``save_state`` save the
    resumed run as there. With ``n_shards`` the run resumes on that many
    ranks (``partition`` as in :func:`run_experiment`): a checkpoint of
    either trainer, at any rank count, resumes on one card or sharded."""
    device = torch.device(device)
    saved_seed = int(restore_checkpoint(resume_dir)["metadata"]["seed"])
    config = dataclasses.replace(config, seed=saved_seed)
    pre_data = _prepare_for_training(
        dataset, graph_family, data_root, config, pre_data,
        device=device, n_shards=n_shards, partition=partition,
    )
    extra = {"resumed_from": resume_dir}
    if n_shards is not None:
        out = _run_sharded(pre_data, [saved_seed], config, n_shards, partition, device, verbose,
                           save_model=save_model, save_state=save_state,
                           resume_from=resume_dir)
        (run,) = out.pop("runs")
        if verbose:
            print(f"[resumed seed={saved_seed}] {run['test']}")
        return _summarize(dataset, graph_family, output_dir, config, [run], device,
                          _sharding(n_shards, partition, config), extra={**extra, **out})
    trainer = _make_trainer(pre_data, config, device)
    trainer.fit(verbose=verbose, resume_from=resume_dir)
    test_desc = trainer.test()
    if verbose:
        print(f"[resumed seed={saved_seed}] {test_desc}")
    run = {
        "seed": saved_seed,
        "test": test_desc,
        "epochs_run": len(trainer.history),
        "history": trainer.history,
    }
    if save_model:
        extra["checkpoint"] = trainer.save(save_model)
    if save_state:
        extra["resumable_checkpoint"] = trainer.save_training_state(save_state)
    return _summarize(dataset, graph_family, output_dir, config, [run], device, extra=extra)


def evaluate_checkpoint(
    dataset: str,
    checkpoint_path: str,
    graph_family: str = "topic",
    data_root: str = "data",
    pre_data: Optional[PreparedData] = None,
    spmm: str = "auto",
    model: str = "gcn",
    *,
    device,
) -> Dict[str, float]:
    """Restore params from a checkpoint of either trainer and evaluate them
    on the test split on one device (the ``--load_model`` path, with or
    without ``--shards``, as in JAX), on the layout ``spmm`` gives; a
    checkpoint of another family, or of another node order than the
    layout's or the artifact's on identity features, is refused."""
    device = torch.device(device)
    config = TrainConfig(model=model, spmm=spmm)
    pre_data = _prepare_for_training(
        dataset, graph_family, data_root, config, pre_data, device=device
    )
    trainer = _make_trainer(pre_data, config, device)
    trainer.load(checkpoint_path)
    return trainer.evaluate(trainer.test_idx, prefix="test")


def _summarize(dataset, graph_family, output_dir, config, runs, device, sharding=None,
               extra=None):
    """The run summary (JAX schema), written as the reports and returned;
    ``extra`` adds keys (the checkpoints' paths, ``resumed_from``)."""
    accs = [r["test"]["acc"] for r in runs]
    f1s = [r["test"]["macro_f1"] for r in runs]
    summary = {
        "device_memory": device_memory(device),
        "device": {"type": device.type, "name": device_name(device)},
        "dataset": dataset,
        "graph_family": graph_family,
        "times": len(runs),
        "hyperparameters": dataclasses.asdict(config),
        "test_accuracy": aggregate(accs),
        "test_macro_f1": aggregate(f1s),
        "model_param": runs[0]["test"]["model_param"],
        "train_time": aggregate([r["test"]["train_time"] for r in runs]),
        "runs": runs,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if sharding is not None:
        summary["sharding"] = sharding
    summary.update(extra or {})
    write_reports(summary, output_dir)
    return summary


def write_reports(summary: Dict[str, Any], output_dir: str) -> None:
    os.makedirs(output_dir, exist_ok=True)
    ds = summary["dataset"]
    fam = summary["graph_family"]
    json_path = os.path.join(output_dir, f"{ds}_{fam}_training_results.json")
    with open(json_path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)

    txt_path = os.path.join(output_dir, f"{ds}_{fam}_training_results.txt")
    with open(txt_path, "w", encoding="utf-8") as f:
        model = summary["hyperparameters"]["model"].upper()
        f.write(f"{fam} {model} training results — {ds}\n")
        f.write("=" * 60 + "\n")
        f.write(f"generated: {summary['timestamp']}\n")
        f.write(f"device: {summary['device']['name']}\n")
        f.write(f"runs: {summary['times']}\n\n")
        f.write("Hyperparameters:\n")
        for k, v in summary["hyperparameters"].items():
            f.write(f"  {k}: {v}\n")
        f.write(f"\nModel parameters: {summary['model_param']}\n\n")
        for metric in ("test_accuracy", "test_macro_f1"):
            agg = summary[metric]
            f.write(
                f"{metric}: mean={agg['mean']:.4f} "
                f"max={agg['max']:.4f} min={agg['min']:.4f}\n"
            )
        f.write("\nPer-run results:\n")
        for r in summary["runs"]:
            t = r["test"]
            f.write(
                f"  seed={r['seed']} acc={t['acc']:.4f} "
                f"macro_f1={t['macro_f1']:.4f} epochs={r['epochs_run']} "
                f"train_time={t['train_time']:.1f}s\n"
            )
