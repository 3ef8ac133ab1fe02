"""Row partition of a graph over the ranks of a process group.

Port of ``textgcn_tpu/parallel/partition.py`` (``partition_rows``,
``pad_features``) and of the shard geometry of
``textgcn_tpu/parallel/mesh_kernels.py`` (``_shard_geometry`` and the hybrid
layout's 128-row alignment):

- nodes are padded to ``n_shards × rows_per_shard`` and split into
  contiguous row blocks; rank ``p`` owns rows ``[p·rps, (p+1)·rps)``;
- each shard keeps its rows' edges with **local row ids** and **global col
  ids**, so it aggregates from the all-gathered ``[n_pad, F]`` features.

The geometry is the JAX package's exactly, so features, masks and parameter
tables line up row for row with its ``ShardedTrainer``. The JAX module pads
every shard's edge list to the longest one with phantom edges (row ``rps``,
col ``n_pad``, value 0), because ``P`` shards stack into one ``shard_map``
program; on ``torch.distributed`` each rank holds only its own tensors, so a
:class:`ShardCOO` keeps its edges unpadded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def shard_geometry(n_nodes: int, n_shards: int, row_align: int = 8) -> Tuple[int, int]:
    """``(rows_per_shard, n_pad)``: ``ceil(n / P)`` rounded up to 8 rows and
    then to ``row_align`` (128 for the hybrid layout, whose local block-rows
    tile by 128), and ``n_pad = rps · P``."""
    rps = round_up(round_up(max(1, -(-n_nodes // n_shards)), 8), row_align)
    return rps, rps * n_shards


def pad_features(x: np.ndarray, n_pad: int) -> np.ndarray:
    """Zero-pad node features to the partitioned node count."""
    out = np.zeros((n_pad, x.shape[1]), dtype=np.asarray(x).dtype)
    out[: x.shape[0]] = x
    return out


def shard_rows(a: np.ndarray, shard: int, rows_per_shard: int) -> np.ndarray:
    """Rank ``shard``'s rows of a node-indexed array padded past its end with
    zeros: ``a`` may hold fewer rows than ``n_pad``."""
    out = np.zeros((rows_per_shard, *a.shape[1:]), dtype=a.dtype)
    part = a[shard * rows_per_shard : (shard + 1) * rows_per_shard]
    out[: len(part)] = part
    return out


@dataclasses.dataclass(frozen=True)
class ShardCOO:
    """One shard's edges: local rows, global columns, sorted by (row, col).

    row: [E_p] int64 local row ids; col: [E_p] int64 global col ids;
    val: [E_p] float32.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n_nodes: int
    n_pad: int
    rows_per_shard: int
    n_shards: int
    shard: int
    symmetric: bool = True

    @staticmethod
    def from_coo(
        row, col, val, n_nodes: int, n_shards: int, shard: int, *,
        rows_per_shard: int = None, symmetric: bool = True, device,
    ) -> "ShardCOO":
        """Shard ``shard``'s edges of a host COO graph. ``rows_per_shard``
        imposes a geometry (it must cover the nodes); by default it is
        :func:`shard_geometry`'s."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val)
        rps = rows_per_shard or shard_geometry(n_nodes, n_shards)[0]
        if rps * n_shards < n_nodes:
            raise ValueError(f"{n_shards} shards of {rps} rows do not cover {n_nodes} nodes")
        sel = np.nonzero(row // rps == shard)[0]
        r, c = row[sel] - shard * rps, col[sel]
        order = np.lexsort((c, r))
        return ShardCOO(
            row=torch.from_numpy(r[order]).to(device),
            col=torch.from_numpy(c[order]).to(device),
            val=torch.from_numpy(val[sel][order].astype(np.float32)).to(device),
            n_nodes=int(n_nodes),
            n_pad=int(rps * n_shards),
            rows_per_shard=int(rps),
            n_shards=int(n_shards),
            shard=int(shard),
            symmetric=bool(symmetric),
        )


def partition_rows(g, n_shards: int) -> List[ShardCOO]:
    """Every shard of a :class:`~textgcn_tpu_torch.graph.structs.SparseGraph`,
    on its device: the layout of the plain segment path, whose rank ``p``
    builds only ``ShardCOO.from_coo(..., shard=p)``."""
    row, col, val = g.coo_numpy()
    return [
        ShardCOO.from_coo(row, col, val, g.n_nodes, n_shards, p, device=g.val.device)
        for p in range(n_shards)
    ]
