"""One rank's share of the sharded hybrid SpMM: the tile leg on K1 (B10)
and the residual leg on K2, after an all-gather of the features.

Port of the all-gather hybrid of ``textgcn_tpu/parallel/mesh_kernels.py``
(``MeshHybridAllGather``, ``_bsr_leg_apply``, ``_allgather_hybrid_impl``
and the symmetric VJP of ``spmm_mesh_onehot``). The split is the JAX
package's: ``tile_fill_threshold_split`` on the degree-sorted global pattern
at ``n_pad`` (``min_nnz=24``), with the hybrid geometry (``rows_per_shard``
a multiple of 128). Rank ``p`` keeps

- its dense tiles as a rectangular :class:`BlockSparseGraph`: its local
  block-rows against all ``n_pad / 128`` global block-columns, flat bf16
  128x128 tiles. The tile leg is K1 (``csrc/bsr_spmm.cu``) through
  :func:`~textgcn_tpu_torch.ops.bsr_spmm.bsr_leg`, the port of
  ``_bsr_leg_apply`` (B10): K1 reads ``x`` through the block-columns and
  writes ``out`` through the block-rows, so a rectangular block needs no
  other kernel;
- its residual edges as a row-sorted CSR with local rows and global columns,
  which K2 (``csrc/row_reduce.cu``) adds onto the tile leg's output in place.

TPU layouts that are not carried over, because each exists so that ``P``
shards stack into one ``shard_map`` program, and on ``torch.distributed``
each rank holds only its own tensors: the grouped tile stack and its one
group size for all shards; padding every shard to the largest tile count
with zero groups; the coverage tile of an empty block-row (K1 writes zeros
for a block-row without tiles); the residual's ``OneHotPlan`` with
``_pad_plan_chunks`` and ``_choose_mesh_k``.

The degree sort piles the hubs onto rank 0, which then holds the most tiles
and sets the pace of every pass; the JAX package partitions the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from textgcn_tpu_torch.graph.reorder import (
    ResidualCSR,
    feature_table,
    tile_and_residual,
    tile_fill_threshold_split,
)
from textgcn_tpu_torch.graph.structs import BlockSparseGraph
from textgcn_tpu_torch.ops.bsr_spmm import TILE, bsr_leg, bsr_spmm_plain
from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
from textgcn_tpu_torch.parallel.distributed import all_gather_rows
from textgcn_tpu_torch.parallel.partition import shard_geometry


@dataclasses.dataclass(frozen=True)
class MeshHybridAllGather:
    """Rank ``shard``'s hybrid layout: tiles of its ``rows_per_shard`` rows
    against all ``n_pad`` columns, plus its residual CSR (``rest``, None when
    every one of its edges landed in a tile). ``symmetric`` is the whole
    matrix's (Âᵀ = Â), which the backward relies on."""

    bsr: BlockSparseGraph
    rest: Optional[ResidualCSR]
    n_nodes: int
    n_edges: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int
    symmetric: bool
    bsr_edges: int  # edges in tiles, over all shards

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *,
        min_nnz: int = 24, symmetric: bool = True, store_bf16: bool = True,
        device,
    ) -> "MeshHybridAllGather":
        """Build rank ``shard``'s share on ``device`` from the (degree-sorted)
        host COO of the whole graph. ``store_bf16=False`` keeps f32 tiles
        (the plain path; on the card K1's f32 mode, counted on
        ``bsr_spmm_f32``)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        rps, n_pad = shard_geometry(n_nodes, n_shards, row_align=TILE)
        dense = tile_fill_threshold_split(row, col, n_pad, bm=TILE, bn=TILE, min_nnz=min_nnz)
        mine = row // rps == shard
        r0 = shard * rps
        d, rr = dense & mine, ~dense & mine
        bsr = BlockSparseGraph.from_coo(
            row[d] - r0, col[d], val[d], rps, bm=TILE, bn=TILE,
            dtype=torch.bfloat16 if store_bf16 else torch.float32,
            max_block_bytes=2 << 30, n_cols=n_pad, device=device,
        )
        rest = None
        if rr.any():
            rest = ResidualCSR.from_coo(row[rr] - r0, col[rr], val[rr], rps, device=device)
        return MeshHybridAllGather(
            bsr=bsr,
            rest=rest,
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_pad=int(n_pad),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
            symmetric=bool(symmetric),
            bsr_edges=int(dense.sum()),
        )


def shard_hybrid_pass(
    mh: MeshHybridAllGather, x_full: torch.Tensor, tile=bsr_leg, reduce=row_reduce
) -> torch.Tensor:
    """Rank ``mh.shard``'s rows of ``Â @ x`` (no autograd): ``x_full`` is the
    all-gathered ``[n_pad, F]`` table. Pads it to the kernels' table
    (:func:`~textgcn_tpu_torch.graph.reorder.feature_table`), runs the tile
    leg (K1) into a fresh ``[rows_per_shard, F']`` f32 output and the
    residual leg (K2) onto it in place, and slices the columns."""
    xp = feature_table(x_full, mh.n_pad, mh.bsr.blocks.dtype)
    return tile_and_residual(mh.bsr, mh.rest, xp, tile, reduce)[:, : x_full.shape[1]]


def shard_hybrid_pass_plain(mh: MeshHybridAllGather, x_full: torch.Tensor) -> torch.Tensor:
    """:func:`shard_hybrid_pass` through the kernels' plain versions, on any
    device."""
    return shard_hybrid_pass(mh, x_full, tile=bsr_spmm_plain, reduce=row_reduce_plain)


class _SpmmMeshHybrid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mh, x_local, group):
        ctx.mh, ctx.group = mh, group
        return shard_hybrid_pass(mh, all_gather_rows(x_local, group))

    @staticmethod
    def backward(ctx, g):
        if not ctx.mh.symmetric:
            raise NotImplementedError("spmm_mesh_hybrid backward needs a symmetric adjacency")
        # Âᵀ g = Â g: the same all-gather and pass on the cotangent, and no
        # reduce-scatter (the symmetric VJP of the JAX package's mesh kernels)
        return None, shard_hybrid_pass(ctx.mh, all_gather_rows(g, ctx.group)), None


def spmm_mesh_hybrid(mh: MeshHybridAllGather, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``Â @ x`` with ``x`` row-sharded over ``group``:
    ``x_local`` is ``[rows_per_shard, F]``. Every rank of the group calls it
    together (it all-gathers ``x``). Differentiable in ``x_local``: the
    backward all-gathers the cotangent and runs the same pass, which needs
    ``mh.symmetric``."""
    return _SpmmMeshHybrid.apply(mh, x_local, group)
