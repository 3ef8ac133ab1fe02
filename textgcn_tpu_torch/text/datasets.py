"""Dataset label/split files.

Port of ``textgcn_tpu/text/datasets.py`` (pure Python and numpy, so the code
is the same). File format: ``index\\t{split}\\t{label}`` per line; split tags in
:data:`TRAIN_TAGS` mark training docs. Class ids follow the **sorted** unique
labels, so they do not depend on the hash seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

TRAIN_TAGS = {"train", "training", "20news-bydate-train"}


@dataclasses.dataclass
class DatasetLabels:
    target: np.ndarray  # [D] int64 class ids
    label_names: List[str]  # id -> name
    train_idx: np.ndarray  # doc indices with a train split tag
    test_idx: np.ndarray

    @property
    def n_classes(self) -> int:
        return len(self.label_names)

    @property
    def n_docs(self) -> int:
        return len(self.target)


def load_labels(path: str) -> DatasetLabels:
    splits: List[str] = []
    labels: List[str] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if len(parts) < 3:
                raise ValueError(f"bad label line in {path!r}: {line!r}")
            splits.append(parts[1])
            labels.append(parts[2])
    names = sorted(set(labels))
    label2id: Dict[str, int] = {l: i for i, l in enumerate(names)}
    target = np.asarray([label2id[l] for l in labels], dtype=np.int64)
    is_train = np.asarray([s in TRAIN_TAGS for s in splits], dtype=bool)
    idx = np.arange(len(labels))
    return DatasetLabels(
        target=target,
        label_names=names,
        train_idx=idx[is_train],
        test_idx=idx[~is_train],
    )
