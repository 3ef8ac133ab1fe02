"""Command-line entry point: ``python -m textgcn_tpu_torch.cli <command>``.

Port of ``textgcn_tpu/cli.py``, with its flags and defaults:

  clean          clean a raw corpus into clean_corpus/{ds}.txt (host)
  build-graph    fit the topic model on the GPU, build and save the
                 doc-topic-topic graph
  build-docword  build and save the classic TextGCN doc-word graph (host)
  train          train a model family on a built graph (GPU)
  inspect        topic inspection report (GPU: theta by the E-step)
  experiment     YAML-driven build → train → inspect in one process (GPU)

``train`` runs every model family of the JAX registry on the topic graph
(``--graph topic``, the default, as in the JAX package) or the doc-word
graph (``--graph docword``), in every ``--spmm`` format of the JAX CLI; the
GCN also sharded over ``--shards N`` GPUs. ``--seeds`` names the runs'
seeds outright. ``--save_model`` / ``--load_model`` save the best run's
params and evaluate a saved checkpoint; ``--save_state`` / ``--resume``
save the best run's resumable state and continue it bit for bit. The
device work runs on CUDA and raises when there is no CUDA device: the port
never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import torch

from textgcn_tpu_torch.graph.format import DENSE_MAX_NODES, SPMM_FORMATS
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.parallel.trainer import check_sharded
from textgcn_tpu_torch.topics.model import LDA_BACKENDS
from textgcn_tpu_torch.train.run import (
    check_sharded_checkpoints, evaluate_checkpoint, generate_seeds, resume_training,
    run_experiment,
)
from textgcn_tpu_torch.train.trainer import TrainConfig
from textgcn_tpu_torch.utils.profiling import trace


def require_cuda(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"textgcn_tpu_torch {what} on a CUDA device and none is available")


def _add_build_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", required=True)
    p.add_argument("--num_topics", type=int, default=50)
    p.add_argument("--doc_topic_threshold", type=float, default=0.02)
    p.add_argument("--topic_topic_threshold", type=float, default=0.3)
    p.add_argument("--min_df", type=int, default=2)
    p.add_argument("--max_df", type=float, default=0.95)
    p.add_argument("--no_word2vec", action="store_true")
    p.add_argument(
        "--lda_backend", default="jax", choices=LDA_BACKENDS,
        help="jax: batch VB-EM on the GPU (the port of the JAX package's); "
        "sklearn: sklearn's LatentDirichletAllocation on the host, where "
        "sklearn is installed",
    )
    p.add_argument("--lda_max_iter", type=int, default=60)
    p.add_argument("--data_root", default="data")


def cmd_clean(args) -> int:
    from textgcn_tpu_torch.text.clean import CorpusProcess

    CorpusProcess(args.dataset, data_root=args.data_root)
    return 0


def cmd_build_graph(args) -> int:
    from textgcn_tpu_torch.graph.build_topic import TopicGraphBuilder

    require_cuda("fits the topic model")
    b = TopicGraphBuilder(
        args.dataset,
        num_topics=args.num_topics,
        doc_topic_threshold=args.doc_topic_threshold,
        topic_topic_threshold=args.topic_topic_threshold,
        min_df=args.min_df,
        max_df=args.max_df,
        use_word2vec=not args.no_word2vec,
        lda_backend=args.lda_backend,
        lda_max_iter=args.lda_max_iter,
        data_root=args.data_root,
        device="cuda",
    )
    g = b.build()
    b.save()
    print(f"built {args.dataset}: {g.n_nodes} nodes, {g.n_edges} edges")
    return 0


def cmd_build_docword(args) -> int:
    from textgcn_tpu_torch.graph.build_textgcn import TextGCNGraphBuilder

    b = TextGCNGraphBuilder(args.dataset, window_size=args.window, data_root=args.data_root)
    g = b.build()
    b.save()
    print(
        f"built {args.dataset} doc-word graph: {g.n_nodes} nodes "
        f"({g.num_docs} docs + {g.num_words} words), {len(g.src)} edges"
    )
    return 0


def cmd_inspect(args) -> int:
    from textgcn_tpu_torch.inspect.topics import inspect_topics

    require_cuda("infers theta")
    inspect_topics(
        args.dataset,
        data_root=args.data_root,
        top_n_words=args.top_n_words,
        top_n_docs=args.top_n_docs,
        heatmap=not args.no_heatmap,
        output_dir=args.output_dir,
        device="cuda",
    )
    return 0


def cmd_experiment(args) -> int:
    from textgcn_tpu_torch.runner import run_experiment_config

    require_cuda("runs an experiment")
    return run_experiment_config(args.config, device="cuda")


def cmd_train(args) -> int:
    check_sharded_checkpoints(
        args.shards, save_model=args.save_model, save_state=args.save_state,
        resume=args.resume, load_model=args.load_model,
    )
    if args.shards is not None:
        check_sharded(args.model, args.spmm, args.partition)
        if args.spmm != "hybrid":
            raise NotImplementedError(
                f"--shards with --spmm {args.spmm}: the CLI shards the hybrid "
                "kernels only (the segment oracle runs through the library; "
                "ROADMAP A.11 has the one-hot mesh kernel)"
            )
    require_cuda("trains")
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
        epoch_block=args.epoch_block,
        spmm=args.spmm,
        model=args.model,
    )
    common = dict(graph_family=args.graph, data_root=args.data_root, device="cuda")
    if args.resume:
        summary = resume_training(
            args.dataset, args.resume, output_dir=args.output_dir, config=cfg,
            verbose=not args.quiet, save_model=args.save_model,
            save_state=args.save_state, **common,
        )
        print(f"{args.dataset} (resumed): acc={summary['test_accuracy']['mean']:.4f}")
        return 0
    if args.load_model:
        out = evaluate_checkpoint(
            args.dataset, args.load_model, spmm=args.spmm, model=args.model, **common
        )
        print(
            f"{args.dataset} (checkpoint {args.load_model}): "
            f"acc={out['acc']:.4f} macro_f1={out['macro_f1']:.4f}"
        )
        return 0
    trace_ctx = contextlib.nullcontext()
    if args.trace:
        trace_ctx = trace(args.trace)
        print(f"writing a torch.profiler trace to {args.trace}")
    with trace_ctx:
        summary = run_experiment(
            args.dataset,
            times=args.times,
            output_dir=args.output_dir,
            config=cfg,
            seeds=args.seeds or generate_seeds(args.times, args.seed),
            verbose=not args.quiet,
            n_shards=args.shards,
            partition=args.partition,
            save_model=args.save_model,
            save_state=args.save_state,
            **common,
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

    p = sub.add_parser("clean", help="clean a raw corpus (host)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_root", default="data")
    p.set_defaults(fn=cmd_clean)

    p = sub.add_parser("build-graph", help="build the topic graph's artifacts (CUDA)")
    _add_build_args(p)
    p.set_defaults(fn=cmd_build_graph)

    p = sub.add_parser("build-docword", help="build the classic TextGCN doc-word graph (host)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--window", type=int, default=20)
    p.add_argument("--data_root", default="data")
    p.set_defaults(fn=cmd_build_docword)

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
        "--epoch_block",
        type=int,
        default=10,
        help="epochs per block, the JAX package's compiled lax.scan block (1 = "
        "dispatch per epoch); accepted with no effect here: results are "
        "bit-identical across block sizes",
    )
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
        choices=list(SPMM_FORMATS),
        help="graph format. Every family but GAT: segment = gather + "
        "a scatter-add (plain PyTorch, the oracle; the same bits every run, "
        "also on CUDA); dense = one [N, N] matmul; "
        "bsr = the whole graph as 128x128 f32 tiles on the tile kernel's f32 "
        "mode (f32-exact; for graphs whose edges cluster); onehot = the whole "
        "graph as one CSR on the residual kernel (bf16 features, f32 sums); "
        "hybrid = degree sort, then tiles holding >= 24 edges run on the "
        "tile kernel and the other edges on the residual kernel (relabels "
        f"nodes); auto = dense up to {DENSE_MAX_NODES} nodes, above that the "
        "format the H100 cost model prices cheapest (hybrid among them). "
        "GAT: segment = plain PyTorch segment softmax (the oracle); dense = "
        "the [N, N] bf16 log-adjacency; onehot = the attention kernels over "
        "a CSR; hybrid = the same after the degree sort (relabels nodes); "
        "auto = dense while its priced peak memory fits, else hybrid; bsr "
        "raises. A checkpoint of identity features (docword) loads only "
        "under the node order it was saved with: use the same --spmm",
    )
    p.add_argument(
        "--save_model", default=None,
        help="directory to save the best run's params (a checkpoint)",
    )
    p.add_argument(
        "--load_model", default=None,
        help="restore a checkpoint and evaluate it on the test split (skips "
        "training)",
    )
    p.add_argument(
        "--save_state", default=None, metavar="DIR",
        help="after training, save the best run's resumable state (params, "
        "Adam's state, the epoch and early-stop counters, the dropout "
        "generator) to DIR",
    )
    p.add_argument(
        "--resume", default=None, metavar="DIR",
        help="continue a run from a --save_state checkpoint (its seed and "
        "dropout draws are restored from it; the resumed run gives an "
        "uninterrupted run's bits)",
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
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="profile the training run with torch.profiler (CPU and CUDA) "
        "and write a Chrome trace to DIR/trace.json (open it in Perfetto)",
    )
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("inspect", help="topic inspection report (CUDA)")
    p.add_argument("--dataset", required=True)
    p.add_argument("--data_root", default="data")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--top_n_words", type=int, default=10)
    p.add_argument("--top_n_docs", type=int, default=5)
    p.add_argument("--no_heatmap", action="store_true")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("experiment", help="YAML-driven build, train, inspect (CUDA)")
    p.add_argument("--config", required=True)
    p.set_defaults(fn=cmd_experiment)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
