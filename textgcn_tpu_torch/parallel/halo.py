"""Ring halo-exchange sharded SpMM: the feature blocks travel, the rows stay.

Port of ``textgcn_tpu/parallel/halo.py`` (``HaloPartitionedGraph``,
``partition_rows_halo``, ``spmm_halo``), the JAX CLI's default sharded
layout. The all-gather path (:mod:`~textgcn_tpu_torch.parallel.sharded`)
holds all ``n_pad`` feature rows on every rank; here a rank holds its own
``rows_per_shard`` rows and one visiting block at a time, so its memory is
``O(N / P · F)``.

Edge layout: bucket ``(p, q)`` holds owner ``p``'s edges whose column lives
on rank ``q``, with **local** row ids (on ``p``) and **local** column ids
(on ``q``), in the graph's (row, col) order. The JAX layout stacks all
``P²`` buckets, padded to one size, into one ``shard_map`` program; on
``torch.distributed`` rank ``p`` holds only its own ``P`` buckets, unpadded.

:func:`spmm_halo` is the ring with the plain segment sum (kernel
``segment``): at step ``s`` rank ``p`` holds block ``(p + s) mod P`` and
adds bucket ``(p, q)``'s products onto its accumulator, then passes the
block to rank ``p - 1`` (JAX's ring ``[(i, (i - 1) % P)]``). The buckets
are added in the JAX order, from the rank's own block on. Its backward is
the true transpose, a reverse ring: a partial cotangent block travels to
rank ``p + 1`` at each step and every rank adds ``A_{p,q}ᵀ g_p`` onto the
block it holds, so that block ``q`` ends on rank ``q`` after ``P`` adds.
The one-hot form of the same ring (K2 a bucket, symmetric backward) is
:class:`~textgcn_tpu_torch.parallel.mesh_kernels.MeshOneHotHalo`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from textgcn_tpu_torch.ops.scatter import add_rows_
from textgcn_tpu_torch.parallel.distributed import ring_shift
from textgcn_tpu_torch.parallel.partition import shard_geometry


def halo_buckets(row, col, n_nodes: int, n_shards: int, shard: int):
    """``(rows_per_shard, n_pad, [idx_q for q in range(P)])``: the edge
    indices of each bucket ``(shard, q)`` of a host COO, in input order
    (the JAX partition's stable sort by bucket)."""
    rps, n_pad = shard_geometry(n_nodes, n_shards)
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    mine = np.flatnonzero(row // rps == shard)
    q_of = col[mine] // rps
    order = np.argsort(q_of, kind="stable")
    offs = np.concatenate([[0], np.cumsum(np.bincount(q_of, minlength=n_shards))])
    return rps, n_pad, [mine[order[offs[q]: offs[q + 1]]] for q in range(n_shards)]


@dataclasses.dataclass(frozen=True)
class HaloPartitionedGraph:
    """Rank ``shard``'s buckets ``(shard, q)`` for ``q = 0 .. P-1``.

    ``row[q]``: [E_q] int64 local row ids (on ``shard``); ``col[q]``: [E_q]
    int64 local col ids (on ``q``); ``val[q]``: [E_q] float32.
    """

    row: Tuple[torch.Tensor, ...]
    col: Tuple[torch.Tensor, ...]
    val: Tuple[torch.Tensor, ...]
    n_nodes: int
    n_edges: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *, device
    ) -> "HaloPartitionedGraph":
        """Rank ``shard``'s buckets of a host COO graph, on ``device``."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val)
        rps, n_pad, idx = halo_buckets(row, col, n_nodes, n_shards, shard)

        def t(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

        return HaloPartitionedGraph(
            row=tuple(t(row[i] - shard * rps) for i in idx),
            col=tuple(t(col[i] - q * rps) for q, i in enumerate(idx)),
            val=tuple(t(val[i], np.float32) for i in idx),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_pad=int(n_pad),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
        )


def partition_rows_halo(g, n_shards: int) -> List[HaloPartitionedGraph]:
    """Every rank's buckets of a
    :class:`~textgcn_tpu_torch.graph.structs.SparseGraph`, on its device
    (rank ``p`` builds only ``HaloPartitionedGraph.from_coo(..., shard=p)``)."""
    row, col, val = g.coo_numpy()
    return [
        HaloPartitionedGraph.from_coo(row, col, val, g.n_nodes, n_shards, p, device=g.val.device)
        for p in range(n_shards)
    ]


class _SpmmHalo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hg, x_local, group):
        ctx.hg, ctx.group = hg, group
        p, n = hg.shard, hg.n_shards
        acc, h = x_local.new_zeros((hg.rows_per_shard, x_local.shape[1])), x_local
        for s in range(n):
            q = (p + s) % n  # whose block this rank holds at step s
            add_rows_(acc, hg.row[q], h[hg.col[q]] * hg.val[q][:, None].to(h.dtype))
            if s < n - 1:
                h = ring_shift(h, -1, group)
        return acc

    @staticmethod
    def backward(ctx, g):
        hg, group = ctx.hg, ctx.group
        p, n = hg.shard, hg.n_shards
        # at step s this rank holds the partial cotangent of block
        # (p - s - 1) mod P, which then moves on to rank p + 1: at the last
        # step the partial of its own block arrives, complete
        part = g.new_zeros((hg.rows_per_shard, g.shape[1]))
        for s in range(n):
            q = (p - s - 1) % n
            add_rows_(part, hg.col[q], g[hg.row[q]] * hg.val[q][:, None].to(g.dtype))
            if s < n - 1:
                part = ring_shift(part, 1, group)
        return None, part, None


def spmm_halo(hg: HaloPartitionedGraph, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``A @ x`` with ``x`` row-sharded over ``group``
    (``x_local`` is ``[rows_per_shard, F]``), through the feature ring with
    the plain segment sum (the same bits every call,
    :mod:`textgcn_tpu_torch.ops.scatter`). Every rank of the group calls it
    together. Differentiable in ``x_local`` for any ``A``: the backward is
    the reverse ring of the transpose."""
    return _SpmmHalo.apply(hg, x_local, group)
