"""Weighted edgelist reader.

Port of ``read_weighted_edgelist`` from ``textgcn_tpu/graph/build_topic.py``,
its pure-Python path (the JAX package's optional C++ parser in ``native/``
is test-pinned identical to it). The rest of that module, the topic-graph
construction, comes with the topic pipeline.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def read_weighted_edgelist(
    path: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read "u v w" lines into COO arrays (undirected edges listed once);
    a line without a weight gets weight 1."""
    src, dst, w = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            w.append(float(parts[2]) if len(parts) > 2 else 1.0)
    return (
        np.asarray(src, dtype=np.int64),
        np.asarray(dst, dtype=np.int64),
        np.asarray(w, dtype=np.float64),
    )
