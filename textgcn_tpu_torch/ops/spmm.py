"""SpMM: sparse adjacency x dense features, the framework's hot op.

Port of ``textgcn_tpu/ops/spmm.py`` (the dispatcher, the dense path and the
segment-sum oracle):

- :func:`spmm_coo_segment`: gather, scale, and a scatter-add
  (:func:`~textgcn_tpu_torch.ops.scatter.add_rows_`: the same bits every
  call, also on CUDA); differentiable in ``x`` with the transpose pass as
  its backward. The correctness oracle and the ``--spmm segment`` path.
  Plain PyTorch, as the JAX version is plain XLA.
- :func:`spmm_dense`: one ``torch.matmul`` (the JAX package leaves it to XLA).
- :func:`spmm` dispatches on the container type; ``HybridGraph`` goes to
  :func:`textgcn_tpu_torch.graph.reorder.spmm_hybrid` and its two kernels,
  a bare ``BlockSparseGraph`` (``--spmm bsr``) to K1 (its f32 mode for f32
  tiles), a ``CSRGraph`` (``--spmm onehot``) to K2 from zero, a
  host-resident ``SortedStreamGraph`` to its chunk stream through K2.
"""
from __future__ import annotations

import torch

from textgcn_tpu_torch.graph.reorder import (
    CSRGraph, HybridGraph, spmm_bsr, spmm_csr, spmm_hybrid,
)
from textgcn_tpu_torch.graph.structs import BlockSparseGraph, DenseGraph, SparseGraph
from textgcn_tpu_torch.ops.scatter import add_rows_
from textgcn_tpu_torch.ops.streamed_sorted import SortedStreamGraph


def _spmm_coo(row, col, val, x, n_nodes):
    # phantom row n_nodes: padded col gathers zeros, padded row lands in a
    # dropped segment
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    gathered = xp[col] * val[:, None].to(x.dtype)
    return add_rows_(x.new_zeros((n_nodes + 1, x.shape[1])), row, gathered)[:n_nodes]


class _SpmmCooSegment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, col, val, x, n_nodes):
        ctx.save_for_backward(row, col, val)
        ctx.n_nodes = n_nodes
        return _spmm_coo(row, col, val, x, n_nodes)

    @staticmethod
    def backward(ctx, g):
        row, col, val = ctx.saved_tensors
        # d/dx (A @ x) applied to g is Aᵀ @ g: swap row and col
        return None, None, None, _spmm_coo(col, row, val, g, ctx.n_nodes), None


def spmm_coo_segment(row, col, val, x, n_nodes: int):
    """``A @ x`` for a padded COO ``A`` (padding ``row == col == n_nodes``).

    Differentiable in ``x``: the backward is the transpose SpMM ``Aᵀ @ g``, so
    autograd never keeps the [E, F] gather product. ``val`` is a constant.
    """
    return _SpmmCooSegment.apply(row, col, val, x, n_nodes)


def spmm_dense(a_dense: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a_dense, x)


def spmm(graph, x: torch.Tensor) -> torch.Tensor:
    """Â @ x, dispatched on the container type (``DenseGraph``,
    ``SparseGraph``, ``HybridGraph``, ``BlockSparseGraph``, ``CSRGraph``:
    differentiable in ``x``, the last three for a symmetric graph;
    ``SortedStreamGraph``: a forward pass streamed from the host, not
    differentiable; training streams through
    :func:`textgcn_tpu_torch.ops.streamed_sorted.spmm_streamed_sorted_sym`)."""
    if isinstance(graph, SortedStreamGraph):
        return graph.spmm(x)
    if isinstance(graph, DenseGraph):
        return spmm_dense(graph.a, x)
    if isinstance(graph, HybridGraph):
        return spmm_hybrid(graph, x)
    if isinstance(graph, BlockSparseGraph):
        return spmm_bsr(graph, x)
    if isinstance(graph, CSRGraph):
        return spmm_csr(graph, x)
    if isinstance(graph, SparseGraph):
        return spmm_coo_segment(graph.row, graph.col, graph.val, x, graph.n_nodes)
    raise TypeError(f"no SpMM for graph container {type(graph).__name__}")
