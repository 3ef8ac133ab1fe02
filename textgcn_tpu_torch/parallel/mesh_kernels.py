"""One rank's share of the sharded SpMM on the hand kernels: the one-hot
layouts on K2 (B.1, B.2) and the hybrid's tile leg on K1 (B10) with its
residual on K2.

Port of ``textgcn_tpu/parallel/mesh_kernels.py``: ``MeshOneHotAllGather``,
``MeshOneHotHalo``, ``MeshHybridAllGather``, their passes
(``_allgather_impl``, ``_halo_impl``, ``_bsr_leg_apply``,
``_allgather_hybrid_impl``) and ``spmm_mesh_onehot`` with its symmetric VJP.
Every layout uses the JAX package's row geometry, so features, masks and
parameter tables line up row for row with its ``ShardedTrainer``:

- :class:`MeshOneHotAllGather` (B.1): rank ``p``'s rows against all
  ``n_pad`` columns as one row-sorted CSR (``ResidualCSR``, with its
  ``RowSplit``). The pass all-gathers the features and runs K2
  (``csrc/row_reduce.cu``) from zero, B3's role. A row's edges stay on one
  rank and its segments depend only on its length, so the ranks' rows put
  together are the single-device ``--spmm onehot`` pass bit for bit.
- :class:`MeshOneHotHalo` (B.2): rank ``p``'s ``P`` bucket CSRs, bucket
  ``q`` its rows against rank ``q``'s columns in ``q``'s local ids, each
  with its own ``RowSplit`` (tied to it by its fingerprint; None for an
  empty bucket, which launches nothing). The features travel the ring of
  :mod:`~textgcn_tpu_torch.parallel.halo` as the bf16 table K2 reads, and
  at each step K2 adds that step's bucket onto the rank's f32 accumulator
  in place, with a base (B2's role, as the residual leg uses it).
- :class:`MeshHybridAllGather` (B10): the degree-sorted pattern's dense
  tiles as a rectangular :class:`BlockSparseGraph` (its local block-rows
  against all ``n_pad / 128`` global block-columns, flat bf16 128x128
  tiles) and the other edges as a row-sorted CSR. The split is the JAX
  package's, ``tile_fill_threshold_split`` on the degree-sorted global
  pattern at ``n_pad`` (``min_nnz=24``), with ``rows_per_shard`` a multiple
  of 128. The tile leg is K1 (``csrc/bsr_spmm.cu``) through
  :func:`~textgcn_tpu_torch.ops.bsr_spmm.bsr_leg`, the port of
  ``_bsr_leg_apply``: K1 reads ``x`` through the block-columns and writes
  ``out`` through the block-rows, so a rectangular block needs no other
  kernel; K2 adds the residual onto its output in place.

Each layout's backward is the same pass on the cotangent (Âᵀ = Â for the
sym-normalized adjacencies trained here), as JAX's ``_mesh_onehot_bwd``,
and a layout built with ``symmetric=False`` refuses it.

TPU layouts that are not carried over, because each exists so that ``P``
shards stack into one ``shard_map`` program, and on ``torch.distributed``
each rank holds only its own tensors: the ``OneHotPlan`` with
``_pad_plan_chunks`` and ``_choose_mesh_k``; the grouped tile stack and its
one group size for all shards; padding every shard to the largest tile
count with zero groups; the coverage tile of an empty block-row (K1 writes
zeros for a block-row without tiles).

The degree sort piles the hubs onto rank 0, which then holds the most tiles
and sets the pace of every hybrid pass; the JAX package partitions the same
way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

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
from textgcn_tpu_torch.parallel.distributed import all_gather_rows, ring_shift
from textgcn_tpu_torch.parallel.halo import halo_buckets
from textgcn_tpu_torch.parallel.partition import shard_geometry


@dataclasses.dataclass(frozen=True)
class MeshOneHotAllGather:
    """Rank ``shard``'s rows against all ``n_pad`` columns as one row-sorted
    CSR (local rows, global columns) with its :class:`RowSplit`.
    ``symmetric`` is the whole matrix's (Âᵀ = Â), which the backward relies
    on."""

    csr: ResidualCSR
    n_nodes: int
    n_edges: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int
    symmetric: bool

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *, symmetric: bool = True,
        device,
    ) -> "MeshOneHotAllGather":
        """Build rank ``shard``'s share on ``device`` from the host COO of
        the whole graph."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        rps, n_pad = shard_geometry(n_nodes, n_shards)
        mine = row // rps == shard
        return MeshOneHotAllGather(
            csr=ResidualCSR.from_coo(
                row[mine] - shard * rps, col[mine], np.asarray(val)[mine], rps, device=device
            ),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_pad=int(n_pad),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
            symmetric=bool(symmetric),
        )


@dataclasses.dataclass(frozen=True)
class MeshOneHotHalo:
    """Rank ``shard``'s bucket CSRs: ``buckets[q]`` holds its rows' edges
    whose column lives on rank ``q`` (local rows, ``q``'s local columns),
    with its own :class:`RowSplit`, or None when it has no edge."""

    buckets: Tuple[Optional[ResidualCSR], ...]
    n_nodes: int
    n_edges: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int
    symmetric: bool

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *, symmetric: bool = True,
        device,
    ) -> "MeshOneHotHalo":
        """Build rank ``shard``'s buckets on ``device`` from the host COO of
        the whole graph (the buckets of
        :class:`~textgcn_tpu_torch.parallel.halo.HaloPartitionedGraph`)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val)
        rps, n_pad, idx = halo_buckets(row, col, n_nodes, n_shards, shard)
        buckets = tuple(
            ResidualCSR.from_coo(row[i] - shard * rps, col[i] - q * rps, val[i], rps, device=device)
            if len(i) else None
            for q, i in enumerate(idx)
        )
        return MeshOneHotHalo(
            buckets=buckets,
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_pad=int(n_pad),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
            symmetric=bool(symmetric),
        )


def shard_onehot_pass(
    mg: MeshOneHotAllGather, x_full: torch.Tensor, reduce=row_reduce
) -> torch.Tensor:
    """Rank ``mg.shard``'s rows of ``Â @ x`` (no autograd) from the
    all-gathered ``[n_pad, F]`` table: ``x_full`` padded to K2's bf16 table
    (:func:`~textgcn_tpu_torch.graph.reorder.feature_table`) and the rank's
    CSR reduced from zero by ``reduce`` (K2; its plain version to
    compare)."""
    c = mg.csr
    xp = feature_table(x_full, mg.n_pad, torch.bfloat16)
    return reduce(c.row_ptr, c.col, c.val, xp, split=c.split)[:, : x_full.shape[1]]


def allgather_onehot_pass(mg: MeshOneHotAllGather, x_local: torch.Tensor, group=None):
    """:func:`shard_onehot_pass` on the all-gather of ``x_local``
    ``[rows_per_shard, F]``. Every rank of the group calls it together."""
    return shard_onehot_pass(mg, all_gather_rows(x_local, group))


def halo_onehot_pass(
    mg: MeshOneHotHalo, x_local: torch.Tensor, group=None, reduce=row_reduce
) -> torch.Tensor:
    """Rank ``mg.shard``'s rows of ``Â @ x`` (no autograd) through the ring:
    at step ``s`` the rank holds block ``q = (shard + s) mod P`` (as K2's
    bf16 table) and ``reduce`` adds bucket ``q`` onto the f32 accumulator in
    place; then the block moves on to rank ``shard - 1``. The buckets are
    added in the JAX ring's order. Every rank of the group calls it
    together."""
    p, n = mg.shard, mg.n_shards
    h = feature_table(x_local, mg.rows_per_shard, torch.bfloat16)
    acc = torch.zeros((mg.rows_per_shard, h.shape[1]), dtype=torch.float32, device=h.device)
    for s in range(n):
        b = mg.buckets[(p + s) % n]
        if b is not None:
            reduce(b.row_ptr, b.col, b.val, h, base=acc, split=b.split)
        if s < n - 1:
            h = ring_shift(h, -1, group)
    return acc[:, : x_local.shape[1]]


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


def hybrid_rank_pass(mh: MeshHybridAllGather, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Rank ``mh.shard``'s rows of ``Â @ x`` (no autograd): all-gather
    ``x_local``, then :func:`shard_hybrid_pass`. Every rank of the group
    calls it together."""
    return shard_hybrid_pass(mh, all_gather_rows(x_local, group))


class _SymmetricMeshPass(torch.autograd.Function):
    """``pass_fn(layout, x_local, group)``, differentiable in ``x_local``:
    for Âᵀ = Â the backward is the same pass (and collectives) on the
    cotangent, with no reduce-scatter (the symmetric VJP of the JAX
    package's mesh kernels)."""

    @staticmethod
    def forward(ctx, pass_fn, mg, x_local, group):
        ctx.pass_fn, ctx.mg, ctx.group = pass_fn, mg, group
        return pass_fn(mg, x_local, group)

    @staticmethod
    def backward(ctx, g):
        if not ctx.mg.symmetric:
            raise NotImplementedError(
                f"the backward of {ctx.pass_fn.__name__} needs a symmetric adjacency"
            )
        return None, None, ctx.pass_fn(ctx.mg, g.contiguous(), ctx.group), None


_PASSES = {
    MeshOneHotAllGather: allgather_onehot_pass,
    MeshOneHotHalo: halo_onehot_pass,
    MeshHybridAllGather: hybrid_rank_pass,
}


def spmm_mesh_onehot(mg, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``Â @ x`` with ``x`` row-sharded over ``group``
    (``x_local`` is ``[rows_per_shard, F]``) on the hand kernels,
    dispatched on the layout's type as the JAX function is:
    :class:`MeshOneHotAllGather` (K2 from zero after an all-gather),
    :class:`MeshOneHotHalo` (K2 onto the accumulator at each ring step) or
    :class:`MeshHybridAllGather` (K1 and K2). Every rank of the group calls
    it together. Differentiable in ``x_local``: the backward runs the same
    pass on the cotangent, which needs ``mg.symmetric``."""
    if type(mg) not in _PASSES:
        raise TypeError(f"no mesh kernel for {type(mg).__name__}")
    return _SymmetricMeshPass.apply(_PASSES[type(mg)], mg, x_local, group)


def spmm_mesh_hybrid(mh: MeshHybridAllGather, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``Â @ x`` with ``x`` row-sharded over ``group``:
    ``x_local`` is ``[rows_per_shard, F]``. Every rank of the group calls it
    together (it all-gathers ``x``). Differentiable in ``x_local``: the
    backward all-gathers the cotangent and runs the same pass, which needs
    ``mh.symmetric``."""
    return spmm_mesh_onehot(mh, x_local, group)
