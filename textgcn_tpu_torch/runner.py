"""YAML-driven experiment orchestrator: build → train → inspect in one
process.

Port of ``textgcn_tpu/runner.py``. The stages share one process and one
device; each stage's output is teed into ``experiments/<ds>/logs/<stage>.log``
(``experiments/<ds>_docword/`` for the doc-word family) under the current
directory, where the config is copied as ``config_used.yaml``, the reports
go to ``results/`` and the stage times to ``logs/stage_times.txt``. The
build writes its artifacts under the config's ``data_root``.

YAML schema (:class:`~textgcn_tpu_torch.utils.config.ExperimentConfig`)::

  dataset: R8
  graph: topic        # topic (TopicGCN) | docword (classic TextGCN)
  build:
    num_topics: 50
    doc_topic_threshold: 0.02
    topic_topic_threshold: 0.3
    min_df: 2
    max_df: 0.95
    use_word2vec: true
  train:
    times: 1
  inspect:
    top_n_words: 10
    top_n_docs: 5
    heatmap: true
"""
from __future__ import annotations

import os
import shutil
import sys
import time
from contextlib import contextmanager
from typing import Any, Dict

import yaml


@contextmanager
def _stage_log(log_dir: str, stage: str):
    """Tee stdout into ``{log_dir}/{stage}.log`` for the block, and note
    the stage's seconds at the end of the log."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{stage}.log")
    orig = sys.stdout
    with open(path, "w", encoding="utf-8") as f:

        class Tee:
            def write(self, s):
                orig.write(s)
                f.write(s)

            def flush(self):
                orig.flush()
                f.flush()

        sys.stdout = Tee()
        t0 = time.time()
        try:
            yield
        finally:
            sys.stdout = orig
            f.write(f"\n[stage {stage} took {time.time() - t0:.1f}s]\n")


def load_config(path: str) -> Dict[str, Any]:
    """The YAML at ``path`` as plain data, unchecked (JAX's ``load_config``;
    :func:`run_experiment_config` reads it through ``ExperimentConfig``)."""
    with open(path, encoding="utf-8") as f:
        return yaml.safe_load(f)


def run_experiment_config(config_path: str, *, device) -> int:
    """Run the experiment that the YAML at ``config_path`` describes, its
    device stages on ``device``; returns 0."""
    from textgcn_tpu_torch.utils.config import ExperimentConfig
    from textgcn_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    # unknown keys fail before any stage runs
    cfg = ExperimentConfig.from_yaml(config_path)
    dataset = cfg.dataset
    family = cfg.graph
    exp_dir = os.path.join("experiments", dataset if family == "topic" else f"{dataset}_{family}")
    log_dir = os.path.join(exp_dir, "logs")
    res_dir = os.path.join(exp_dir, "results")
    os.makedirs(res_dir, exist_ok=True)
    shutil.copy(config_path, os.path.join(exp_dir, "config_used.yaml"))
    data_root = cfg.data_root

    with _stage_log(log_dir, "build"), timer.stage("build"):
        if family == "docword":
            from textgcn_tpu_torch.graph.build_textgcn import TextGCNGraphBuilder

            builder = TextGCNGraphBuilder(dataset, window_size=cfg.build.window, data_root=data_root)
        else:
            from textgcn_tpu_torch.graph.build_topic import TopicGraphBuilder

            builder = TopicGraphBuilder(
                dataset,
                num_topics=cfg.build.num_topics,
                doc_topic_threshold=cfg.build.doc_topic_threshold,
                topic_topic_threshold=cfg.build.topic_topic_threshold,
                min_df=cfg.build.min_df,
                max_df=cfg.build.max_df,
                use_word2vec=cfg.build.use_word2vec,
                lda_backend=cfg.build.lda_backend,
                lda_max_iter=cfg.build.lda_max_iter,
                data_root=data_root,
                device=device,
            )
        builder.build()
        builder.save()

    with _stage_log(log_dir, "train"), timer.stage("train"):
        from textgcn_tpu_torch.train.run import run_experiment

        pre = None
        if family == "docword":
            from textgcn_tpu_torch.train.prepare import prepare_docword_data

            pre = prepare_docword_data(dataset, data_root=data_root, device=device)
        summary = run_experiment(
            dataset,
            times=cfg.train.times,
            graph_family=family,
            data_root=data_root,
            output_dir=res_dir,
            config=cfg.train.to_train_config(),
            pre_data=pre,
            n_shards=cfg.train.shards,
            partition=cfg.train.partition,
            device=device,
        )
        acc = summary["test_accuracy"]
        print(f"test accuracy: mean={acc['mean']:.4f} max={acc['max']:.4f}")

    # topic inspection applies to the topic family only
    if cfg.inspect.enabled and family == "topic":
        with _stage_log(log_dir, "inspect"), timer.stage("inspect"):
            from textgcn_tpu_torch.inspect.topics import inspect_topics

            inspect_topics(
                dataset,
                data_root=data_root,
                top_n_words=cfg.inspect.top_n_words,
                top_n_docs=cfg.inspect.top_n_docs,
                heatmap=cfg.inspect.heatmap,
                output_dir=res_dir,
                device=device,
            )

    report = timer.report()
    print(report)
    with open(os.path.join(log_dir, "stage_times.txt"), "w", encoding="utf-8") as f:
        f.write(report + "\n")
    return 0
