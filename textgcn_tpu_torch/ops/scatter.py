"""Rows added at indices, the same bits on every call.

The port's one scatter-add for the segment sums (``--spmm segment``'s SpMM
and its transpose, GAT's segment softmax and aggregation, the sharded
segment oracle) and Word2Vec's updates. The JAX package's counterparts are
``jax.ops.segment_sum`` and ``.at[].add``, which XLA gives the same bits
run to run.

Each device takes its deterministic PyTorch op, with no global switch: on
CUDA ``index_put_(accumulate=True)``, which sorts the indices (stably) and
sums each index's rows in that order (``index_add_`` there adds floats with
atomics, so two runs differ in their last bits and a resumed run leaves the
straight one); on the CPU ``index_add_``, which adds the rows in order
(``index_put_`` there accumulates in parallel).
"""
from __future__ import annotations

import torch


def add_rows_(w: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``w[idx[i]] += rows[i]`` for every i, in place, duplicates summed;
    returns ``w``. Not differentiable (the in-place form)."""
    if w.is_cuda:
        return w.index_put_((idx,), rows, accumulate=True)
    return w.index_add_(0, idx, rows)


def add_rows(n: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """A new ``[n, *rows.shape[1:]]`` tensor of ``rows[i]`` summed at
    ``idx[i]`` (zero where no index lands): :func:`add_rows_` out of place,
    differentiable in ``rows`` (its gradient is the gather ``g[idx]``)."""
    out = rows.new_zeros((n, *rows.shape[1:]))
    if rows.is_cuda:
        return out.index_put((idx,), rows, accumulate=True)
    return out.index_add(0, idx, rows)
