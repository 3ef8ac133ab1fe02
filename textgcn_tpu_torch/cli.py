"""Command-line entry point: ``python -m textgcn_tpu_torch.cli train ...``.

Port of the ``train`` subcommand of ``textgcn_tpu/cli.py``: every model
family of the JAX registry on the topic graph (``--graph topic``, the
default, as in the JAX package) or the doc-word graph (``--graph
docword``); the GCN also sharded over ``--shards N`` GPUs. ``--seeds``
names the runs' seeds outright. It trains on CUDA devices and raises when
there are too few: the port never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import sys

import torch

from textgcn_tpu_torch.graph.format import DENSE_MAX_NODES, SPMM_FORMATS
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.parallel.trainer import check_sharded
from textgcn_tpu_torch.train.run import (
    check_model_format, generate_seeds, run_experiment,
)
from textgcn_tpu_torch.train.trainer import TrainConfig


def cmd_train(args) -> int:
    if args.shards is not None:
        check_sharded(args.model, args.spmm, args.partition)
        if args.spmm != "hybrid":
            raise NotImplementedError(
                f"--shards with --spmm {args.spmm}: the CLI shards the hybrid "
                "kernels only (the segment oracle runs through the library; "
                "ROADMAP A.11 has the one-hot mesh kernel)"
            )
    check_model_format(args.model, args.spmm)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "textgcn_tpu_torch trains on a CUDA device and none is available"
        )
    if args.shards is not None and torch.cuda.device_count() < args.shards:
        raise RuntimeError(
            f"--shards {args.shards} needs {args.shards} CUDA devices (one rank "
            f"each) but {torch.cuda.device_count()} are visible"
        )
    cfg = TrainConfig(
        n_hidden=args.nhid,
        lr=args.lr,
        dropout=args.dropout,
        max_epoch=args.max_epoch,
        early_stopping=args.early_stopping,
        val_ratio=args.val_ratio,
        spmm=args.spmm,
        model=args.model,
    )
    summary = run_experiment(
        args.dataset,
        times=args.times,
        graph_family=args.graph,
        data_root=args.data_root,
        output_dir=args.output_dir,
        config=cfg,
        seeds=args.seeds or generate_seeds(args.times, args.seed),
        verbose=not args.quiet,
        n_shards=args.shards,
        partition=args.partition,
        device="cuda",
    )
    acc = summary["test_accuracy"]
    print(
        f"{args.dataset}: acc mean={acc['mean']:.4f} "
        f"max={acc['max']:.4f} min={acc['min']:.4f}"
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="textgcn_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a model family on a built graph (CUDA)")
    p.add_argument("--dataset", required=True)
    p.add_argument(
        "--graph", default="topic", choices=["topic", "docword"],
        help="graph family: topic (TopicGCN's document-topic graph, dense "
        "features) or docword (classic TextGCN doc-word graph, identity "
        "features)",
    )
    p.add_argument("--times", type=int, default=1)
    p.add_argument("--data_root", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--nhid", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--early_stopping", type=int, default=10)
    p.add_argument("--val_ratio", type=float, default=0.1)
    p.add_argument(
        "--seed", type=int, default=None,
        help="master seed for the runs' seeds (default: fresh random seeds)",
    )
    p.add_argument(
        "--seeds", type=int, nargs="+", default=None, metavar="SEED",
        help="the runs' seeds themselves, one run each (overrides --times "
        "and --seed)",
    )
    p.add_argument(
        "--model", default="gcn", choices=sorted(MODELS),
        help="model family: gcn (2-layer Kipf-Welling GCN), gat (2-layer "
        "graph attention network), sgc (linear A^2XW classifier), sgc_pre "
        "(SGC with A^2X propagated once before training; dense features "
        "only), appnp (MLP + 10-step personalized-PageRank propagation), "
        "sage (GraphSAGE mean aggregator: separate self/neighbour "
        "transforms), gin ((1+eps)h + Ah through an MLP, learnable eps) or "
        "gcnii (8 layers with initial residual and identity mapping)",
    )
    p.add_argument(
        "--spmm",
        default="auto",
        choices=[*SPMM_FORMATS, "onehot"],
        help="graph format. Every family but GAT: segment = gather + "
        "index_add_ (plain PyTorch, the oracle); dense = one [N, N] matmul; "
        "hybrid = degree sort, then 128x128 tiles holding >= 24 edges run on "
        "the tile kernel and the other edges on the residual kernel "
        "(relabels nodes); onehot is not ported for them yet and raises. "
        "GAT: segment = plain PyTorch segment softmax (the oracle); dense = "
        "the [N, N] bf16 log-adjacency; onehot = the attention kernels over "
        "a CSR; hybrid = the same after the degree sort (relabels nodes). "
        "All: auto = dense "
        f"up to {DENSE_MAX_NODES} nodes, and above that an error until the "
        "port has GPU cost constants",
    )
    p.add_argument(
        "--shards", type=int, default=None, metavar="N",
        help="train the GCN row-sharded over N GPUs, one rank each (rank 0 "
        "in this process, NCCL); needs N visible devices, --spmm hybrid and "
        "--partition allgather",
    )
    p.add_argument(
        "--partition", default="halo", choices=["halo", "allgather"],
        help="sharded aggregation layout: allgather = every rank gathers all "
        "feature rows, then runs its rows' tiles (K1) and residual (K2); halo "
        "(the JAX package's default, a feature ring) is not ported yet and "
        "raises",
    )
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(fn=cmd_train)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
