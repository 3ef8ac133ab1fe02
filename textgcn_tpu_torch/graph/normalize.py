"""Adjacency normalization on the host: Â = D̃^{-1/2} (A + I) D̃^{-1/2}.

Port of the numpy functions of ``textgcn_tpu/graph/normalize.py``
(``coalesce_coo``, ``max_symmetrize_coo``, ``add_self_loops_coo``,
``sym_normalize_coo``). Self-loops are added before the degrees are taken,
and D^{-1/2} maps inf to 0. The jitted ``sym_normalize_vals`` of the JAX
module serves the distributed path and comes with it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def coalesce_coo(
    row: np.ndarray, col: np.ndarray, val: np.ndarray, n: int, reduce: str = "sum"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge duplicate (row, col) entries; sort by (row, col)."""
    key = row.astype(np.int64) * n + col.astype(np.int64)
    order = np.argsort(key, kind="stable")
    key, row, col, val = key[order], row[order], col[order], val[order]
    uniq, start = np.unique(key, return_index=True)
    if reduce == "sum":
        merged = np.add.reduceat(val, start) if len(val) else val
    elif reduce == "max":
        merged = np.maximum.reduceat(val, start) if len(val) else val
    else:
        raise ValueError(f"unknown reduce: {reduce}")
    return (uniq // n).astype(np.int64), (uniq % n).astype(np.int64), merged


def max_symmetrize_coo(
    row: np.ndarray, col: np.ndarray, val: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A := elementwise_max(A, Aᵀ) on COO arrays."""
    r = np.concatenate([row, col])
    c = np.concatenate([col, row])
    v = np.concatenate([val, val])
    return coalesce_coo(r, c, v, n, reduce="max")


def add_self_loops_coo(
    row: np.ndarray, col: np.ndarray, val: np.ndarray, n: int, weight: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A + weight*I, summing into any existing diagonal entries."""
    loops = np.arange(n, dtype=np.int64)
    r = np.concatenate([row, loops])
    c = np.concatenate([col, loops])
    v = np.concatenate(
        [val, np.full(n, weight, dtype=val.dtype if len(val) else np.float64)]
    )
    return coalesce_coo(r, c, v, n, reduce="sum")


def sym_normalize_coo(
    row: np.ndarray,
    col: np.ndarray,
    val: np.ndarray,
    n: int,
    add_self_loops: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return COO of D̃^{-1/2} (A + I) D̃^{-1/2} (degrees include self-loops)."""
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    val = np.asarray(val, dtype=np.float64)
    if add_self_loops:
        row, col, val = add_self_loops_coo(row, col, val, n)
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, row, val)
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[~np.isfinite(dinv)] = 0.0
    nval = val * dinv[row] * dinv[col]
    return row, col, nval
