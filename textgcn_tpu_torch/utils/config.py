"""Typed experiment configuration.

Port of ``textgcn_tpu/utils/config.py``: one dataclass for each section of
an experiment's YAML (``build``, ``train``, ``inspect``) under
:class:`ExperimentConfig`, which refuses unknown keys at every level before
any stage runs. Written into the experiment's directory as
``config_used.yaml``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import yaml

from textgcn_tpu_torch.train.trainer import TrainConfig


@dataclasses.dataclass
class BuildConfig:
    num_topics: int = 50
    doc_topic_threshold: float = 0.02
    topic_topic_threshold: float = 0.3
    min_df: int = 2
    max_df: float = 0.95
    use_word2vec: bool = True
    # jax: the batch VB-EM (the port's topics/lda.py, on the device);
    # sklearn: sklearn's LatentDirichletAllocation on the host
    lda_backend: str = "jax"
    lda_max_iter: int = 60
    # docword family only: PMI co-occurrence window size
    window: int = 20


@dataclasses.dataclass
class TrainSection:
    """The ``train`` section.

    ``epoch_block`` goes to ``TrainConfig.epoch_block``, which has no effect
    on the run: in the JAX package it sets how many epochs one compiled
    ``lax.scan`` block dispatches, which changes dispatch only (its results
    are bit-identical across block sizes). The port's counterpart would be a
    CUDA graph of the train step (ROADMAP A.3). ``shards`` / ``partition`` train the GCN row-sharded, as
    ``cli train --shards`` does (``halo`` raises until it is ported).
    """

    times: int = 1
    nhid: int = 200
    lr: float = 0.02
    dropout: float = 0.5
    max_epoch: int = 200
    early_stopping: int = 10
    val_ratio: float = 0.1
    epoch_block: int = 10
    # graph format (textgcn_tpu_torch.graph.format.SPMM_FORMATS, onehot for GAT)
    spmm: str = "auto"
    # model family (textgcn_tpu_torch.models.MODELS)
    model: str = "gcn"
    shards: Optional[int] = None
    partition: str = "halo"

    def to_train_config(self) -> TrainConfig:
        """The one mapping from the YAML schema to the trainer's
        ``TrainConfig``."""
        return TrainConfig(
            n_hidden=self.nhid,
            lr=self.lr,
            dropout=self.dropout,
            max_epoch=self.max_epoch,
            early_stopping=self.early_stopping,
            val_ratio=self.val_ratio,
            epoch_block=self.epoch_block,
            spmm=self.spmm,
            model=self.model,
        )


@dataclasses.dataclass
class InspectConfig:
    enabled: bool = True
    top_n_words: int = 10
    top_n_docs: int = 5
    heatmap: bool = True


@dataclasses.dataclass
class ExperimentConfig:
    dataset: str = "R8"
    data_root: str = "data"
    # graph family: "topic" (TopicGCN doc-topic-topic) | "docword" (classic
    # TextGCN TF-IDF + PMI)
    graph: str = "topic"
    build: BuildConfig = dataclasses.field(default_factory=BuildConfig)
    train: TrainSection = dataclasses.field(default_factory=TrainSection)
    inspect: InspectConfig = dataclasses.field(default_factory=InspectConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "ExperimentConfig":
        def fill(cls, sub: Optional[Dict[str, Any]]):
            sub = sub or {}
            unknown = set(sub) - {f.name for f in dataclasses.fields(cls)}
            if unknown:
                raise ValueError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
            return cls(**sub)

        known_top = {"dataset", "data_root", "graph", "build", "train", "inspect"}
        unknown_top = set(d) - known_top
        if unknown_top:
            raise ValueError(f"unknown ExperimentConfig keys: {sorted(unknown_top)}")
        return ExperimentConfig(
            dataset=d.get("dataset", "R8"),
            data_root=d.get("data_root", "data"),
            graph=d.get("graph", "topic"),
            build=fill(BuildConfig, d.get("build")),
            train=fill(TrainSection, d.get("train")),
            inspect=fill(InspectConfig, d.get("inspect")),
        )

    @staticmethod
    def from_yaml(path: str) -> "ExperimentConfig":
        with open(path, encoding="utf-8") as f:
            return ExperimentConfig.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)
