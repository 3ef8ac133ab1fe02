"""Row-sharded GCN over a process group.

Port of the GCN part of ``textgcn_tpu/parallel/sharded.py``
(``spmm_sharded``, ``sharded_gcn_forward``). Each rank holds its
``rows_per_shard`` rows of the features, activations and logits; dense
transforms run locally with replicated weights; the sparse aggregation
brings the other ranks' rows to each rank (all at once, or a block at a
time around a ring) and reduces onto the local ones. :func:`sharded_spmm`
dispatches on the rank's layout:

- a :class:`~textgcn_tpu_torch.parallel.partition.ShardCOO` (``kernel=
  "segment"``, ``partition="allgather"``) goes through :func:`spmm_sharded`:
  plain PyTorch gather and scatter-add (the same bits every call,
  :mod:`textgcn_tpu_torch.ops.scatter`), also the oracle. Its backward is
  the true transpose (every rank scatters ``A_pᵀ g_p`` over all rows, one
  all-reduce), so it also checks the symmetric shortcut of the kernels'
  backward;
- a :class:`~textgcn_tpu_torch.parallel.halo.HaloPartitionedGraph`
  (``segment`` on ``halo``, the JAX CLI's default) goes through
  :func:`~textgcn_tpu_torch.parallel.halo.spmm_halo`, the feature ring with
  the same plain sums and a true-transpose reverse ring as its backward;
- the hand-kernel layouts (``onehot`` on either partition, ``hybrid`` on
  ``allgather``) go through
  :func:`~textgcn_tpu_torch.parallel.mesh_kernels.spmm_mesh_onehot`.

The JAX package gets the cross-shard gradient sums from ``shard_map``'s
autodiff; here the trainer all-reduces the replicated parameters' gradients
(:mod:`textgcn_tpu_torch.parallel.trainer`).
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.gcn import Params
from textgcn_tpu_torch.ops.scatter import add_rows_
from textgcn_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum
from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph, spmm_halo
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather, MeshOneHotAllGather, MeshOneHotHalo, spmm_mesh_onehot,
)
from textgcn_tpu_torch.parallel.partition import ShardCOO


def _local_spmm(s: ShardCOO, x_full: torch.Tensor) -> torch.Tensor:
    out = x_full.new_zeros((s.rows_per_shard, x_full.shape[1]))
    return add_rows_(out, s.row, x_full[s.col] * s.val[:, None].to(x_full.dtype))


class _SpmmSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, x_local, group):
        ctx.s, ctx.group = s, group
        return _local_spmm(s, all_gather_rows(x_local, group))

    @staticmethod
    def backward(ctx, g):
        s = ctx.s
        part = g.new_zeros((s.n_pad, g.shape[1]))
        add_rows_(part, s.col, g[s.row] * s.val[:, None].to(g.dtype))
        all_reduce_sum(part, ctx.group)
        r0 = s.shard * s.rows_per_shard
        return None, part[r0 : r0 + s.rows_per_shard], None


def spmm_sharded(s: ShardCOO, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``A @ x`` with ``x`` row-sharded over ``group``
    (``x_local`` is ``[rows_per_shard, F]``), in plain PyTorch;
    differentiable in ``x_local`` for any ``A``."""
    return _SpmmSharded.apply(s, x_local, group)


def sharded_spmm(graph, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Dispatch on the shard container: the plain segment reduce for a
    :class:`ShardCOO`, the plain segment ring for a
    :class:`HaloPartitionedGraph`, the hand kernels for the one-hot and
    hybrid layouts."""
    if isinstance(graph, (MeshOneHotAllGather, MeshOneHotHalo, MeshHybridAllGather)):
        return spmm_mesh_onehot(graph, x_local, group)
    if isinstance(graph, HaloPartitionedGraph):
        return spmm_halo(graph, x_local, group)
    if isinstance(graph, ShardCOO):
        return spmm_sharded(graph, x_local, group)
    raise TypeError(f"no sharded SpMM for {type(graph).__name__}")


def dropout_rows(
    h: torch.Tensor, rate: float, n_nodes: int, r0: int, generator: torch.Generator
) -> torch.Tensor:
    """Inverted dropout on this rank's rows ``[r0, r0 + len(h))`` of an
    ``[n_nodes, H]`` activation: the mask is drawn for all ``n_nodes`` rows
    from ``generator`` (as the single-device GCN draws it) and the rank keeps
    its own, so the run does not depend on the number of ranks. Rows past
    ``n_nodes`` (padding) are dropped."""
    keep = 1.0 - rate
    u = torch.rand((n_nodes, h.shape[1]), generator=generator, device=h.device)[r0 : r0 + len(h)]
    mask = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    mask[: len(u)] = u < keep
    return torch.where(mask, h / keep, 0.0)


def sharded_gcn_forward(
    params: Params,
    graph,
    x_local: Optional[torch.Tensor],
    *,
    group=None,
    dropout: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """This rank's logits ``[rows_per_shard, C]``.

    ``x_local=None`` selects identity features: layer 1's support ``I @ W1``
    is ``W1`` itself, so ``params["gc1.w"]`` is this rank's
    ``[rows_per_shard, H]`` rows of the node table, and their gradient stays
    local. With features, ``gc1.w`` is the replicated ``[F, H]`` weight.
    """
    if x_local is None:
        support = params["gc1.w"]
    else:
        support = x_local @ params["gc1.w"]
    h = torch.relu(sharded_spmm(graph, support, group) + params["gc1.b"])
    if train and dropout > 0.0:
        h = dropout_rows(
            h, dropout, graph.n_nodes, graph.shard * graph.rows_per_shard, generator
        )
    return sharded_spmm(graph, h @ params["gc2.w"], group) + params["gc2.b"]
