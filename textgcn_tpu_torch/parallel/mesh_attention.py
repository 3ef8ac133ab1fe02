"""Sharded GAT attention on the hand kernels: route B.3.

Port of ``textgcn_tpu/parallel/mesh_attention.py``
(``MeshAttentionAllGather``, ``mesh_gat_attention``). The all-gather
partition keeps every edge of a softmax row on the row's rank, so the
attention of a rank's rows needs no statistics of another rank: each rank
holds one rectangular :class:`~textgcn_tpu_torch.ops.attention.AttentionGraph`
(its local rows ``[0, rps)`` against the global columns ``[0, n_pad)`` of
the all-gathered features) and runs the single-card attention op on it,
:func:`~textgcn_tpu_torch.ops.attention.gat_attention`: ``attn_stats`` (B5)
and ``attn_agg`` (B7) forward; ``sddmm`` (B8), ``rowsum`` (B9) and K2 as dx
over the transpose CSR (B3) backward. The transpose CSR has ``n_pad`` rows,
so dx and ded land in the full column space, and the all-gather's backward
(:func:`~textgcn_tpu_torch.parallel.distributed.all_gather_rows_ad`) sums
them over the ranks onto their owners.

A row's edges stay on one rank in (row, col) order and its split depends
only on its length, so the ranks' forward outputs put together are the
single-card ``gat_attention`` on the whole (unsorted) attention graph bit
for bit.

Not carried over: the JAX module pads every rank's plans to common chunk
counts (``_pad_attention_graph``) and rebuilds them per rank
(``_local_ag``), so that ``P`` shards stack into one ``shard_map`` program;
here each rank builds and holds only its own graph.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from textgcn_tpu_torch.ops.attention import AttentionGraph, gat_attention
from textgcn_tpu_torch.parallel.distributed import all_gather_rows_ad
from textgcn_tpu_torch.parallel.partition import shard_geometry


@dataclasses.dataclass(frozen=True)
class MeshAttentionAllGather:
    """Rank ``shard``'s rows against all ``n_pad`` columns as one
    rectangular :class:`AttentionGraph` (``ag``: ``n_nodes = rps``,
    ``n_cols = n_pad``, with ``split`` and ``split_t``)."""

    ag: AttentionGraph
    n_nodes: int
    n_edges: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *, device
    ) -> "MeshAttentionAllGather":
        """Build rank ``shard``'s graph on ``device`` from the host COO of
        the whole graph (coalesced)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        rps, n_pad = shard_geometry(n_nodes, n_shards)
        mine = row // rps == shard
        return MeshAttentionAllGather(
            ag=AttentionGraph.from_coo(
                row[mine] - shard * rps, col[mine], np.asarray(val)[mine], rps, n_pad,
                device=device,
            ),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_pad=int(n_pad),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
        )


def mesh_gat_attention(
    mg: MeshAttentionAllGather, a_src: torch.Tensor, a_dst: torch.Tensor,
    h_local: torch.Tensor, group=None, negative_slope: float = 0.2,
) -> torch.Tensor:
    """This rank's rows of the GAT attention and aggregation, ``h_local``
    ``[rps, F]`` row-sharded over ``group``: ``es = h_local @ a_src``, the
    all-gather of ``h``, ``ed = h_full @ a_dst``, then ``gat_attention`` on
    the rank's graph. Differentiable in ``a_src``, ``a_dst`` and
    ``h_local``; the gradients of the replicated ``a_src`` and ``a_dst`` are
    this rank's parts, which the trainer sums over the ranks. Every rank of
    the group calls it together."""
    h_full = all_gather_rows_ad(h_local, group)
    es, ed = h_local @ a_src, h_full @ a_dst
    return gat_attention(mg.ag, es, ed, h_full, negative_slope)
