"""Graph containers as tensors on a device.

Port of ``textgcn_tpu/graph/structs.py`` (``SparseGraph``, ``DenseGraph``,
``BlockSparseGraph.from_coo``). The containers are frozen dataclasses of
tensors placed on the ``device`` given to their constructor; the host-side
construction is the JAX module's numpy code, so the layouts are equal.

- :class:`SparseGraph`: row-sorted COO with padding at the end. Padding
  entries have ``row = col = n_nodes`` (a phantom node) and ``val = 0``, so
  they add nothing to a segment sum and alias no real node.
- :class:`BlockSparseGraph`: dense ``bm x bn`` tiles sorted by block-row,
  plus ``tile_ptr``, a CSR over tiles that the CUDA tile kernel reads
  (:mod:`textgcn_tpu_torch.ops.bsr_spmm`). In a square matrix every
  block-row holds at least one tile: an empty one gets an explicit zero
  tile, as in the JAX container. A rectangular block (one shard's rows
  against all columns) gets none: the kernel writes zeros for a block-row
  without tiles. ``split`` is the tile kernel's split table of the
  block-rows longer than its T tiles, built here once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from textgcn_tpu_torch.ops.bsr_spmm import tile_split
from textgcn_tpu_torch.ops.split import TileSplit, record


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Row-sorted padded COO sparse matrix (square, ``n_nodes`` x ``n_nodes``).

    Attributes:
      row:      [E_pad] int64, ascending; padding entries equal ``n_nodes``.
      col:      [E_pad] int64; padding entries equal ``n_nodes``.
      val:      [E_pad] float32; padding entries are 0.
      n_nodes:  true number of nodes.
      n_edges:  number of real (non-padding) entries.
    """

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n_nodes: int
    n_edges: int

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        n_nodes: int,
        pad_to_multiple: int = 1024,
        *,
        device,
    ) -> "SparseGraph":
        """Build from host COO arrays; sorts by (row, col) and pads."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        order = np.lexsort((col, row))
        row, col, val = row[order], col[order], val[order]
        e = row.shape[0]
        e_pad = max(_round_up(max(e, 1), pad_to_multiple), pad_to_multiple)
        prow = np.full((e_pad,), n_nodes, dtype=np.int64)
        pcol = np.full((e_pad,), n_nodes, dtype=np.int64)
        pval = np.zeros((e_pad,), dtype=np.float64)
        prow[:e] = row
        pcol[:e] = col
        pval[:e] = val
        return SparseGraph(
            row=torch.from_numpy(prow).to(device),
            col=torch.from_numpy(pcol).to(device),
            val=torch.from_numpy(pval).to(device=device, dtype=torch.float32),
            n_nodes=int(n_nodes),
            n_edges=int(e),
        )

    def coo_numpy(self):
        """The real (unpadded) ``(row, col, val)`` as host numpy arrays."""
        e = self.n_edges
        return (
            self.row[:e].cpu().numpy(),
            self.col[:e].cpu().numpy(),
            self.val[:e].cpu().numpy(),
        )


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """Dense [N, N] f32 adjacency: one matmul per SpMM, for small graphs.

    Built on the graph's own device by a scatter-add from the padded COO.
    """

    a: torch.Tensor  # [n, n] float32
    n_nodes: int

    @staticmethod
    def from_sparse_graph(g: SparseGraph) -> "DenseGraph":
        n = int(g.n_nodes)
        # padded entries carry row == col == n: they land in the phantom rim
        d = torch.zeros((n + 1, n + 1), dtype=torch.float32, device=g.val.device)
        d.index_put_((g.row, g.col), g.val.float(), accumulate=True)
        return DenseGraph(a=d[:n, :n].contiguous(), n_nodes=n)


@dataclasses.dataclass(frozen=True)
class BlockSparseGraph:
    """BSR-style block-sparse matrix.

    Attributes:
      blocks:       [nnzb, bm, bn] dense tiles (bf16 or f32).
      block_rows:   [nnzb] int32 block-row of each tile, ascending.
      block_cols:   [nnzb] int32 block-column of each tile.
      tile_ptr:     [n_block_rows + 1] int32; the tiles of block-row ``i`` are
                    ``tile_ptr[i] .. tile_ptr[i+1]-1``.
      n_nodes:      true node count, or row count of a rectangular block
                    (<= n_block_rows * bm).
      n_edges:      number of real scalar nonzeros.
      bm, bn:       tile shape.
      n_block_rows: number of block-rows (padded node count / bm).
      symmetric:    the caller asserts Âᵀ = Â (values too).
      split:        the :class:`~textgcn_tpu_torch.ops.split.TileSplit` of
                    the block-rows longer than the tile kernel's T tiles
                    (None when there are none), whose fingerprint is
                    recorded on ``tile_ptr``.
    """

    blocks: torch.Tensor
    block_rows: torch.Tensor
    block_cols: torch.Tensor
    tile_ptr: torch.Tensor
    n_nodes: int
    n_edges: int
    bm: int
    bn: int
    n_block_rows: int
    symmetric: bool = False
    split: Optional[TileSplit] = None

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        n_nodes: int,
        bm: int = 128,
        bn: int = 128,
        dtype=torch.float32,
        max_block_bytes: int = 2 << 30,
        symmetric: bool = False,
        *,
        n_cols: int = None,
        device,
    ) -> "BlockSparseGraph":
        """Tile a COO matrix into dense (bm, bn) blocks, keeping nonzero
        tiles sorted by (block_row, block_col).

        ``n_cols`` makes the matrix rectangular, ``n_nodes`` rows by
        ``n_cols`` columns (one shard's rows against every column), with no
        coverage tiles; every ``col`` must fall below it, since the tile
        kernel reads its feature table through the block-columns unchecked.
        ``max_block_bytes`` guards against uniformly sparse graphs, whose
        tile stack would explode; use the segment SpMM for those.
        """
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        square = n_cols is None
        if square:
            n_pad = _round_up(max(n_nodes, 1), max(bm, bn))
            n_block_rows = n_pad // bm
            n_block_cols = n_pad // bn
        else:
            if len(col) and (int(col.max()) >= n_cols or int(row.max()) >= n_nodes):
                raise ValueError(
                    f"an edge falls outside the {n_nodes} x {n_cols} block"
                )
            n_block_rows = -(-max(n_nodes, 1) // bm)
            n_block_cols = -(-max(n_cols, 1) // bn)

        bkey = (row // bm) * n_block_cols + (col // bn)
        order = np.argsort(bkey, kind="stable")
        row, col, val, bkey = row[order], col[order], val[order], bkey[order]

        uniq_keys = np.unique(bkey)
        # square: an explicit zero tile on the diagonal of every empty block-row
        present = np.zeros(n_block_rows, dtype=bool)
        if len(uniq_keys):
            present[(uniq_keys // n_block_cols).astype(np.int64)] = True
        missing = np.nonzero(~present)[0] if square else ()
        if len(missing):
            extra = missing * n_block_cols + np.minimum(missing, n_block_cols - 1)
            uniq_keys = np.sort(np.concatenate([uniq_keys, extra]))
        nnzb = max(len(uniq_keys), 1) if square else len(uniq_keys)
        itemsize = torch.empty((), dtype=dtype).element_size()
        if nnzb * bm * bn * itemsize > max_block_bytes:
            raise ValueError(
                f"BSR blocks would take {nnzb * bm * bn * itemsize / 1e9:.1f}"
                f" GB ({nnzb} tiles of {bm}x{bn}); the graph is too uniformly"
                " sparse for block format — use the segment-sum SpMM"
                " (SparseGraph) or raise max_block_bytes"
            )
        blocks = np.zeros((nnzb, bm, bn), dtype=np.float32)
        block_rows = np.zeros((nnzb,), dtype=np.int32)
        block_cols = np.zeros((nnzb,), dtype=np.int32)
        if len(uniq_keys):
            block_rows[: len(uniq_keys)] = uniq_keys // n_block_cols
            block_cols[: len(uniq_keys)] = uniq_keys % n_block_cols
            block_of_edge = np.searchsorted(uniq_keys, bkey)
            lr = row - block_rows[block_of_edge].astype(np.int64) * bm
            lc = col - block_cols[block_of_edge].astype(np.int64) * bn
            np.add.at(blocks, (block_of_edge, lr, lc), val)
        tile_ptr = np.searchsorted(
            block_rows, np.arange(n_block_rows + 1), side="left"
        ).astype(np.int32)
        split = tile_split(tile_ptr, device=device)
        return BlockSparseGraph(
            blocks=torch.from_numpy(blocks).to(device=device, dtype=dtype),
            block_rows=torch.from_numpy(block_rows).to(device),
            block_cols=torch.from_numpy(block_cols).to(device),
            tile_ptr=record(torch.from_numpy(tile_ptr).to(device), split),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            bm=int(bm),
            bn=int(bn),
            n_block_rows=int(n_block_rows),
            symmetric=bool(symmetric),
            split=split,
        )
