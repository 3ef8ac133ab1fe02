"""Multi-seed training runner and its human/machine reports.

Port of ``textgcn_tpu/train/run.py`` (``run_experiment`` on the topic or
doc-word graph, on one device for every model family with GAT's own
layouts and ``sgc_pre``'s precompute, and sharded over ``n_shards`` devices
for the GCN; ``generate_seeds``, ``aggregate``, ``write_reports``). The reports keep
the JAX package's schema: ``{ds}_{family}_training_results.json`` (with full
per-epoch histories and hyperparameters, and ``"sharding"`` for a sharded
run) and ``.txt``. The summary also names the device it ran on.
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

from textgcn_tpu_torch.graph.format import DENSE_MAX_NODES
from textgcn_tpu_torch.models.sgc import sgc_precompute
from textgcn_tpu_torch.parallel.launch import HostData, run_sharded_seeds
from textgcn_tpu_torch.parallel.trainer import check_sharded
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
# dense up to DENSE_MAX_NODES, segment = the plain PyTorch oracle
GAT_FORMATS = ("auto", "segment", "dense", "onehot", "hybrid")


def check_model_format(model: str, spmm: str) -> None:
    """Raise for a pairing of model family and graph format that the port
    does not run yet (before any data is read)."""
    if model != "gat" and spmm == "onehot":
        raise NotImplementedError(
            f"--spmm onehot for --model {model} is not ported yet (ROADMAP A.4: "
            "a bare residual CSR through K2); choose hybrid, segment, dense or auto"
        )


def apply_gat_format(pre: PreparedData, fmt: str) -> PreparedData:
    """Convert ``pre.graph`` to the GAT layout that ``fmt`` names."""
    if fmt in ("onehot", "hybrid"):
        return apply_attention_format(pre, degree_sort=fmt == "hybrid")
    if fmt == "auto":
        if pre.graph.n_nodes > DENSE_MAX_NODES:
            raise NotImplementedError(
                f"GAT --spmm auto above {DENSE_MAX_NODES} nodes needs the GPU "
                "cost model (ROADMAP A.4); choose --spmm hybrid, onehot, "
                "segment or dense"
            )
        fmt = "dense"
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
    if graph_family not in ("topic", "docword"):
        raise ValueError(f"unknown graph family {graph_family!r}: topic or docword")


def prepare_data(dataset: str, graph_family: str, data_root: str, *, device) -> PreparedData:
    """The graph family's prepared data on ``device`` (for the topic graph,
    a stale theta cache is re-inferred there)."""
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
    *,
    device,
) -> Dict[str, Any]:
    """Train ``times`` seeds on ``dataset`` on ``device``; write reports;
    return the summary.

    ``n_shards``: train row-sharded over that many ranks
    (:mod:`textgcn_tpu_torch.parallel`), rank ``r`` on ``cuda:r`` with NCCL
    for a CUDA ``device``, or on CPU processes with gloo for the CPU. Rank 0
    runs in this process. The kernel is ``config.spmm``; see
    :func:`~textgcn_tpu_torch.parallel.trainer.check_sharded` for what runs.
    """
    device = torch.device(device)
    if n_shards is not None:
        check_sharded(config.model, config.spmm, partition)
    check_model_format(config.model, config.spmm)
    check_graph_family(graph_family)
    if pre_data is None:
        pre_data = prepare_data(dataset, graph_family, data_root, device=device)
    if n_shards is not None:
        # prepared once; each rank builds its own shard from the host arrays
        seeds = seeds or generate_seeds(times)
        cuda = device.type == "cuda"
        runs = run_sharded_seeds(
            HostData.from_prepared(pre_data), seeds, config, n_shards,
            kernel=config.spmm, partition=partition,
            backend="nccl" if cuda else "gloo",
            devices=[f"cuda:{r}" for r in range(n_shards)] if cuda else ["cpu"] * n_shards,
            verbose=verbose,
        )
        sharding = {"n_shards": n_shards, "partition": partition, "kernel": config.spmm}
        return _summarize(dataset, graph_family, output_dir, config, runs, device, sharding)
    if config.model == "gat":
        pre_data = apply_gat_format(pre_data, config.spmm)
    else:
        pre_data = apply_spmm_format(pre_data, config.spmm)
    if config.model == "sgc_pre":
        pre_data = apply_sgc_precompute(pre_data, device=device)
    seeds = seeds or generate_seeds(times)

    runs: List[Dict[str, Any]] = []
    for i, seed in enumerate(seeds):
        cfg = dataclasses.replace(config, seed=seed)
        trainer = Trainer(
            pre_data.graph,
            pre_data.features,
            pre_data.labels.target,
            pre_data.labels.train_idx,
            pre_data.labels.test_idx,
            pre_data.labels.n_classes,
            config=cfg,
            device=device,
        )
        trainer.fit(verbose=verbose)
        test_desc = trainer.test()
        if verbose:
            print(f"[run {i + 1}/{len(seeds)} seed={seed}] {test_desc}")
        runs.append(
            {
                "seed": seed,
                "test": test_desc,
                "epochs_run": len(trainer.history),
                "history": trainer.history,
            }
        )

    return _summarize(dataset, graph_family, output_dir, config, runs, device)


def _summarize(dataset, graph_family, output_dir, config, runs, device, sharding=None):
    """The run summary (JAX schema), written as the reports and returned."""
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
