"""SpMM: sparse adjacency x dense features, the framework's hot op.

Port of ``textgcn_tpu/ops/spmm.py`` (the dispatcher, the dense path and the
segment-sum oracle):

- :func:`spmm_coo_segment`: gather, scale, and a scatter-add
  (:func:`~textgcn_tpu_torch.ops.scatter.add_rows_`: the same bits every
  call, also on CUDA); differentiable in ``x`` with the transpose pass as
  its backward. The correctness oracle and the ``--spmm segment`` path.
  Plain PyTorch, as the JAX version is plain XLA.
- :func:`spmm_coo_segment_ew`: the same sum, also differentiable in the
  edge values (learnable edge weights): dval is the sampled product
  ``g[row] . x[col]`` (the JAX package's XLA ``sddmm``), plain PyTorch too.
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


def _sddmm_coo(row, col, g, x):
    """``g[row[e]] . x[col[e]]`` for every edge, in f32; a padding index
    (``n_nodes``) reads a zero row, as JAX's ``sddmm`` gathers with a fill."""
    gp = torch.cat([g, g.new_zeros((1, g.shape[1]))])
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    return (gp[row].float() * xp[col].float()).sum(dim=1)


class _SpmmCooSegmentEw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row, col, val, x, n_nodes):
        ctx.save_for_backward(row, col, val, x)
        ctx.n_nodes = n_nodes
        return _spmm_coo(row, col, val, x, n_nodes)

    @staticmethod
    def backward(ctx, g):
        row, col, val, x = ctx.saved_tensors
        dval = dx = None
        if ctx.needs_input_grad[2]:
            dval = _sddmm_coo(row, col, g, x).to(val.dtype)
        if ctx.needs_input_grad[3]:
            dx = _spmm_coo(col, row, val, g, ctx.n_nodes)
        return None, None, dval, dx, None


def spmm_coo_segment_ew(row, col, val, x, n_nodes: int):
    """:func:`spmm_coo_segment` that is also differentiable in ``val``
    (port of the JAX ``spmm_coo_segment_ew``, for learnable edge weights).

    The backward keeps ``x`` and pays one sampled product more: ``dval[e] =
    g[row[e]] . x[col[e]]`` (f32, cast to ``val``'s type; 0 for a padding
    edge) and ``dx = Aᵀ @ g``, the transpose pass."""
    return _SpmmCooSegmentEw.apply(row, col, val, x, n_nodes)


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
