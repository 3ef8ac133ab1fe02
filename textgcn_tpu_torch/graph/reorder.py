"""Degree-sort reordering and the hybrid tile + residual SpMM layout.

Port of ``textgcn_tpu/graph/reorder.py``. A degree sort relabels nodes so
that the edges of a power-law graph concentrate into dense 128x128 tiles.
:class:`HybridGraph` sends tiles holding at least ``min_nnz`` edges to the
tile kernel K1 (:mod:`textgcn_tpu_torch.ops.bsr_spmm`) and keeps the other
edges as a row-sorted CSR for the residual kernel K2
(:mod:`textgcn_tpu_torch.ops.row_reduce`), which adds them onto K1's output.
Occupancy thresholding keeps the split symmetric for a symmetric pattern, so
for a sym-normalized Â the backward of :func:`spmm_hybrid` is the same pass.

The same module holds the two bare layouts that need no degree sort: a whole
graph as one row-sorted CSR through K2 from zero (:class:`CSRGraph`, the
port's ``OneHotGraph`` of ``textgcn_tpu/ops/pallas_onehot.py``, ``--spmm
onehot``) and a whole graph as a tile stack through K1
(:func:`spmm_bsr`, ``--spmm bsr``: f32 tiles on K1's f32 mode). Their
backward is the same pass too.

The TPU layouts of the JAX module are not carried over: the grouped
(K-packed) tile stack, the residual's ``OneHotPlan`` windows and superchunks,
and the alignment of the padded rows to the plan's window grid.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from textgcn_tpu_torch.graph.structs import BlockSparseGraph
from textgcn_tpu_torch.ops.bsr_spmm import F_ALIGN, TILE, bsr_spmm, bsr_spmm_f32
from textgcn_tpu_torch.ops.row_reduce import RowSplit, row_reduce, row_split
from textgcn_tpu_torch.ops.split import record
from textgcn_tpu_torch.utils import profiling


def degree_sort_permutation(
    row: np.ndarray, col: np.ndarray, n_nodes: int
) -> np.ndarray:
    """``perm[old_id] = new_id`` with highest-degree nodes first.

    Degree counts both endpoints; ties break by old id.
    """
    deg = np.bincount(np.asarray(row), minlength=n_nodes) + np.bincount(
        np.asarray(col), minlength=n_nodes
    )
    order = np.argsort(-deg, kind="stable")  # old ids, hubs first
    perm = np.empty(n_nodes, dtype=np.int64)
    perm[order] = np.arange(n_nodes, dtype=np.int64)
    return perm


def permute_coo(row, col, val, perm):
    """Relabel a COO pattern: returns (perm[row], perm[col], val)."""
    perm = np.asarray(perm)
    return perm[np.asarray(row)], perm[np.asarray(col)], np.asarray(val)


def tile_fill_threshold_split(
    row: np.ndarray,
    col: np.ndarray,
    n_nodes: int,
    bm: int = 128,
    bn: int = 128,
    min_nnz: int = 24,
    max_block_bytes: int = 2 << 30,
):
    """Boolean edge mask selecting the tile (BSR) part.

    A tile goes to the BSR part when it holds >= tau nonzeros, where
    tau >= ``min_nnz`` is raised, if needed, until the selected tiles' dense
    storage, priced at f32, fits ``max_block_bytes``. ``min_nnz=24`` is the JAX package's
    value, tuned on a TPU; it has not been re-swept on the GPU.
    """
    row = np.asarray(row, dtype=np.int64)
    col = np.asarray(col, dtype=np.int64)
    n_bcols = -(-max(n_nodes, 1) // bn)
    key = (row // bm) * n_bcols + (col // bn)
    _, inv, counts = np.unique(key, return_inverse=True, return_counts=True)

    budget_tiles = max(1, max_block_bytes // (bm * bn * 4))
    tau = min_nnz
    if int((counts >= tau).sum()) > budget_tiles:
        # raise tau to the budget_tiles-th largest occupancy
        tau = int(np.sort(counts)[::-1][budget_tiles - 1]) + 1
    return (counts >= tau)[inv]


@dataclasses.dataclass(frozen=True)
class ResidualCSR:
    """The residual edges as a row-sorted CSR for the K2 kernel.

    ``row_ptr`` [n_nodes + 1] int32, ``col`` [E] int32, ``val`` [E] f32;
    ``split`` the segments of its rows longer than K2's S (None when it has
    none), built once here.
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    n_edges: int
    split: Optional[RowSplit] = None

    @staticmethod
    def from_coo(row, col, val, n_nodes: int, *, device) -> "ResidualCSR":
        row = np.asarray(row, dtype=np.int64)
        order = np.lexsort((np.asarray(col), row))
        row_ptr = np.searchsorted(row[order], np.arange(n_nodes + 1)).astype(np.int32)
        split = row_split(row_ptr, device=device)
        return ResidualCSR(
            row_ptr=record(torch.from_numpy(row_ptr).to(device), split),
            col=torch.from_numpy(np.asarray(col)[order].astype(np.int32)).to(device),
            val=torch.from_numpy(np.asarray(val)[order].astype(np.float32)).to(device),
            n_edges=int(len(row)),
            split=split,
        )


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """A whole graph as one row-sorted CSR for K2 from zero (``--spmm
    onehot``; the port's counterpart of the JAX package's ``OneHotGraph``,
    whose one-hot plan is a TPU layout). ``csr`` carries the CSR and its
    :class:`RowSplit` at K2's S, built once here. A symmetric graph needs
    no transpose: its backward is the same pass, as JAX's ``OneHotGraph``
    aliases ``bwd`` to ``fwd``."""

    csr: ResidualCSR
    n_nodes: int
    n_edges: int
    symmetric: bool

    @staticmethod
    def from_coo(row, col, val, n_nodes: int, symmetric: bool = False, *, device) -> "CSRGraph":
        return CSRGraph(
            csr=ResidualCSR.from_coo(row, col, val, n_nodes, device=device),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            symmetric=bool(symmetric),
        )


@dataclasses.dataclass(frozen=True)
class HybridGraph:
    """Dense-tile BSR part (flat 128x128 tiles) + residual CSR.

    ``rest`` is None when every edge landed in a dense tile.
    """

    bsr: BlockSparseGraph
    rest: Optional[ResidualCSR]
    n_nodes: int
    n_edges: int
    symmetric: bool

    @staticmethod
    def from_coo(
        row: np.ndarray,
        col: np.ndarray,
        val: np.ndarray,
        n_nodes: int,
        symmetric: bool = False,
        min_nnz: int = 24,
        store_bf16: bool = True,
        *,
        device,
    ) -> "HybridGraph":
        """Build the hybrid layout on ``device``.

        ``store_bf16`` stores the tile stack in bf16 (the tensor-core
        kernel's input type; the pass then also reads features in bf16).
        ``False`` keeps f32 tiles for an f32-exact tile leg (K1's f32 mode
        on the card); the residual leg still reads bf16 features.
        """
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val, dtype=np.float64)
        dense = tile_fill_threshold_split(
            row, col, n_nodes, bm=TILE, bn=TILE, min_nnz=min_nnz
        )
        bsr = BlockSparseGraph.from_coo(
            row[dense], col[dense], val[dense], n_nodes, bm=TILE, bn=TILE,
            dtype=torch.bfloat16 if store_bf16 else torch.float32,
            # the split's budget plus the coverage tiles of empty block-rows
            max_block_bytes=(2 << 30) + (64 << 20),
            symmetric=symmetric, device=device,
        )
        rest = None
        if not dense.all():
            rest = ResidualCSR.from_coo(
                row[~dense], col[~dense], val[~dense], n_nodes, device=device
            )
        return HybridGraph(
            bsr=bsr,
            rest=rest,
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            symmetric=bool(symmetric),
        )

    @property
    def dense_fraction(self) -> float:
        return self.bsr.n_edges / max(self.n_edges, 1)


def reorder_and_build(
    row, col, val, n_nodes, symmetric: bool = False, perm=None, *, device, **kwargs
):
    """Degree-sort, then build the hybrid layout on the permuted pattern.

    Returns ``(perm, hybrid)`` with ``perm[old] = new``. The caller applies
    the same permutation to features, labels and splits:
    ``P Â Pᵀ (P x) = P (Â x)``.
    """
    if perm is None:
        perm = degree_sort_permutation(row, col, n_nodes)
    r2, c2, v2 = permute_coo(row, col, val, perm)
    return perm, HybridGraph.from_coo(
        r2, c2, v2, n_nodes, symmetric=symmetric, device=device, **kwargs
    )


def feature_table(x: torch.Tensor, n_rows: int, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the kernels' padded feature table: [n_rows, F'] in ``dtype``
    (F' = F rounded up to the kernels' 16-column step), zero past x's rows
    and columns. ``x`` itself when it already has that shape and type."""
    f = x.shape[1]
    fp = -(-f // F_ALIGN) * F_ALIGN
    if tuple(x.shape) == (n_rows, fp) and x.dtype == dtype and x.is_contiguous():
        return x
    xp = x.new_zeros((n_rows, fp), dtype=dtype)
    xp[: x.shape[0], :f] = x
    return xp


def tile_and_residual(bsr: BlockSparseGraph, rest, xp: torch.Tensor, tile=bsr_spmm,
                      reduce=row_reduce) -> torch.Tensor:
    """The two legs on one padded table: ``tile`` (K1, with the tiles'
    split table) into a fresh f32 output, then ``reduce`` (K2) adds the
    residual onto that output in place. The residual leg always reads bf16
    features."""
    out = tile(bsr.blocks, bsr.tile_ptr, bsr.block_cols, xp, split=bsr.split)
    if rest is not None:
        xq = xp if xp.dtype == torch.bfloat16 else xp.to(torch.bfloat16)
        reduce(rest.row_ptr, rest.col, rest.val, xq, base=out, split=rest.split)
    return out


def hybrid_pass(h: HybridGraph, x: torch.Tensor) -> torch.Tensor:
    """One hybrid pass ``Â @ x`` (no autograd).

    Builds one padded feature table [n_pad, F'] in the tile stack's type
    (:func:`feature_table`), runs both legs on it
    (:func:`tile_and_residual`) and slices once. While the span recorder is
    on (:func:`~textgcn_tpu_torch.utils.profiling.record_spans`) the pass is
    a ``hybrid.pass`` span with the attributes ``width`` (F'), ``tiles``,
    ``residual_edges`` and ``launches`` (the change of K1's and K2's launch
    counters), holding the legs' ``k1.launch`` and ``k2.launch`` spans.
    """
    on = profiling.spans_on
    if on:
        span, launches = profiling.begin("hybrid.pass"), _launches()
    bsr = h.bsr
    xp = feature_table(x, bsr.n_block_rows * bsr.bm, bsr.blocks.dtype)
    out = tile_and_residual(bsr, h.rest, xp)[: h.n_nodes, : x.shape[1]]
    if on:
        profiling.end(span, width=xp.shape[1], tiles=bsr.nnzb,
                      residual_edges=0 if h.rest is None else h.rest.n_edges,
                      launches=_launches() - launches)
    return out


def _launches() -> int:
    """K1's launches (either mode) and K2's, as their wrappers count them."""
    return bsr_spmm.launches + bsr_spmm_f32.launches + row_reduce.launches


def csr_pass(g: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """One pass ``Â @ x`` over the bare CSR (no autograd): K2 from zero on
    x as a bf16 table padded to K2's column step (as the JAX package's
    one-hot kernel gathers bf16), f32 out."""
    c = g.csr
    xp = feature_table(x, g.n_nodes, torch.bfloat16)
    return row_reduce(c.row_ptr, c.col, c.val, xp, split=c.split)[:, : x.shape[1]]


def bsr_pass(b: BlockSparseGraph, x: torch.Tensor) -> torch.Tensor:
    """One pass ``Â @ x`` over a bare tile stack (no autograd): K1 on x as a
    padded table in the tiles' type (f32 tiles: K1's f32 mode, products
    and sums in f32, as the JAX package's ``spmm_bsr(bf16=False)``)."""
    xp = feature_table(x, b.n_block_rows * b.bm, b.blocks.dtype)
    out = bsr_spmm(b.blocks, b.tile_ptr, b.block_cols, xp, split=b.split)
    return out[: b.n_nodes, : x.shape[1]]


class _SymmetricPass(torch.autograd.Function):
    """``pass_fn(graph, x)``, differentiable in ``x``: for Âᵀ = Â the
    backward ``Âᵀ @ g`` is the same pass on the cotangent."""

    @staticmethod
    def forward(ctx, pass_fn, graph, x):
        ctx.pass_fn, ctx.graph = pass_fn, graph
        return pass_fn(graph, x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.graph.symmetric:
            raise NotImplementedError(
                f"the backward of {ctx.pass_fn.__name__} needs a symmetric adjacency"
            )
        return None, None, ctx.pass_fn(ctx.graph, g)


def spmm_hybrid(h: HybridGraph, x: torch.Tensor) -> torch.Tensor:
    """``Â @ x`` over the hybrid layout, differentiable in ``x``.

    The backward needs ``h.symmetric`` (Âᵀ = Â), which holds for the
    sym-normalized adjacencies this package trains on.
    """
    return _SymmetricPass.apply(hybrid_pass, h, x)


def spmm_csr(g: CSRGraph, x: torch.Tensor) -> torch.Tensor:
    """``Â @ x`` over the bare CSR (K2 from zero, B3's role), differentiable
    in ``x`` for a symmetric ``g`` (JAX: ``spmm_onehot`` on an
    ``OneHotGraph``)."""
    return _SymmetricPass.apply(csr_pass, g, x)


def spmm_bsr(b: BlockSparseGraph, x: torch.Tensor) -> torch.Tensor:
    """``Â @ x`` over a bare tile stack, differentiable in ``x`` for a
    symmetric stack (JAX: ``spmm_bsr_ad(graph, graph, x)``, whose backward
    is the same pass on a symmetric graph)."""
    return _SymmetricPass.apply(bsr_pass, b, x)
