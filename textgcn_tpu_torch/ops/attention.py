"""GAT attention over a CSR: the attention graph, its four CUDA kernels with
their plain PyTorch versions, and the two differentiable attention ops.

Port of ``textgcn_tpu/ops/pallas_attention.py``. The kernels are
hand-written CUDA for Hopper (``sm_90a``) in ``csrc/``:

==================  ===========================  ==============================
wrapper             kernel                       replaces (Pallas)
==================  ===========================  ==============================
``stats_logits``    ``csrc/attn_stats.cu``       ``_stats_logits_kernel`` (B5)
``softmax_stats``   the same kernel, B6 mode     ``_stats_kernel`` (B6)
``attn_agg``        ``csrc/attn_agg.cu``         ``_attn_agg_kernel`` (B7)
``sddmm``           ``csrc/sddmm.cu``            ``_sddmm_kernel`` (B8)
``rowsum``          ``csrc/rowsum.cu``           ``_rowsum_kernel`` (B9)
==================  ===========================  ==============================

Each source carries its note (what bounds it on the card, what its design
does about that). On a degree-sorted graph a kernel that gives each row
one warp waits for the hub row (R8's: 9,589 edges) while the rest of the
card idles. So each row-wise kernel splits a CSR's rows longer than K2's S
into row-local segments with that CSR's split table (``split``), as K2
does: ``stats_logits``, ``softmax_stats``, ``attn_agg`` and ``rowsum`` over
the forward CSR take the forward table (``AttentionGraph.split``), and
``rowsum`` over the transpose CSR (ded) takes the transpose table
(``split_t``); ``sddmm`` is edge-parallel and needs none. A segment's warp
writes a partial (a feature row, an f32 sum, or a softmax pair (max, sum
of exp(x - max))), and a second small launch combines a long row's
partials in segment order: no atomics, so two launches give the same bits.
``dx`` of both ops goes through K2
(:func:`textgcn_tpu_torch.ops.row_reduce.row_reduce`) over the transpose
CSR, with the transpose table, as the JAX package sends it through the
one-hot kernel (``_onehot_kernel``) over the transpose plan. Each table's
fingerprint is recorded on its ``row_ptr``
(:mod:`~textgcn_tpu_torch.ops.split`), so the two, whose counts are equal
for a square graph, cannot be swapped.

Layout. The TPU's ``OneHotPlan`` (windows, k-chunks, superchunks, phantom
slots, 128-lane replicated stats) is not carried over. An
:class:`AttentionGraph` is a forward CSR sorted by (row, col) with
``log(val)`` per edge, computed once (JAX recomputes it per call), and a
transpose CSR with ``perm_t``, the forward position of each transpose edge
(the counterpart of ``slot_perm``). Per-edge arrays are in forward-CSR
order; per-row statistics are one float per row.

Every wrapper runs its plain version for CPU tensors only; for CUDA tensors
it launches its kernel (building the library on first use) or raises, and
adds one to its ``.launches`` where it launches, all through
:func:`~textgcn_tpu_torch.ops._build.check` and
:func:`~textgcn_tpu_torch.ops._build.launch`.

Besides the two attention ops, two more differentiable ops of the JAX
module take per-edge values in forward-CSR order (JAX: in plan slots):
:func:`edge_logit_base` (``es[row] + ed[col]``, with des and ded from
:func:`rowsum` over the forward and the transpose CSR) and
:func:`spmm_onehot_ew` (``A @ x`` with learnable edge values: K2 from zero
forward and, over the transpose CSR, for dx; :func:`sddmm` for dval).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from textgcn_tpu_torch.ops import _build
from textgcn_tpu_torch.ops.row_reduce import SEGMENT_EDGES, RowSplit, row_reduce, row_split
from textgcn_tpu_torch.ops.split import check_split, record, split_args

_NEG = -1e30  # finite -inf stand-in: keeps max/exp arithmetic NaN-free
VEC = 8  # bf16 columns per 16-byte load: feature widths are multiples of it
_LOG2E = 1.4426950408889634


def det_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp(x)`` that gives the same bits in every process.

    On the CPU the first float32 ``torch.exp`` of a process that runs on
    several threads returns some elements up to ~1e-4 relative off (seen
    with PyTorch 2.13's MKL build: about 1 process in 7 on a 40k-element
    call; later calls, and one-thread runs, are exact). ``exp2`` does not
    share that path. The extra rounding of ``x * log2(e)`` costs ~|x|·2^-24
    relative, far below every tolerance these values meet.

    On the CPU an element's f32 ``exp2`` also depends on where it falls:
    the vector loop and its scalar tail differ in the last bit, and where a
    tail falls depends on the tensor's length and on the threads. So the
    CPU takes it in f64 and rounds once to f32, which gives an element the
    same bits wherever it lies (the same edges of a row alone or in the
    whole graph, as on the card, whose ``exp2`` is elementwise).
    """
    if x.device.type == "cpu":
        return torch.exp2(x.double() * _LOG2E).to(x.dtype)
    return torch.exp2(x * _LOG2E)


def check_coalesced(row: np.ndarray, col: np.ndarray, n_cols: int) -> None:
    """Raise if a (row, col) pair occurs twice: log(val) and the dense
    log-adjacency keep one value per pair, where a segment sum adds them."""
    key = np.asarray(row, dtype=np.int64) * int(n_cols) + np.asarray(col, dtype=np.int64)
    if len(np.unique(key)) != len(key):
        raise ValueError(
            "attention graphs need coalesced edges: duplicate (row, col) "
            "pairs found; sum them first"
        )


@dataclasses.dataclass(frozen=True)
class AttentionGraph:
    """Forward and transpose CSR of a graph for kernel-path attention.

    Attributes (int32 unless noted, on one device):
      row_ptr:   [n_nodes + 1] forward CSR, edges sorted by (row, col).
      col:       [E] column of each forward edge.
      logval:    [E] f32, log(val) of each forward edge.
      row:       [E] row of each forward edge (the counterpart of JAX's
                 ``row_slot``: per-row statistics gathered to edges).
      row_ptr_t: [n_cols + 1] transpose CSR, sorted by (col, row).
      col_t:     [E] forward row of each transpose edge.
      perm_t:    [E] forward position of each transpose edge.
      edge_pos:  [E] forward position of each input edge, in input order
                 (the counterpart of ``fwd_dst``).
      split:     the forward CSR's :class:`RowSplit` (the segments of its
                 rows longer than K2's S, for ``stats_logits``,
                 ``softmax_stats``, ``attn_agg`` and ``rowsum`` over it), or
                 None.
      split_t:   the transpose CSR's :class:`RowSplit` (for K2 as dx and
                 ``rowsum`` over it), or None when it has none.
    ``n_nodes`` is the row space (softmax rows, outputs, es) and ``n_cols``
    the column space (x, ed); they are equal for a square graph. Each
    table's fingerprint is recorded on its ``row_ptr`` / ``row_ptr_t``.
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    logval: torch.Tensor
    row: torch.Tensor
    row_ptr_t: torch.Tensor
    col_t: torch.Tensor
    perm_t: torch.Tensor
    edge_pos: torch.Tensor
    n_nodes: int
    n_edges: int
    n_cols: int
    split: Optional[RowSplit] = None
    split_t: Optional[RowSplit] = None

    @staticmethod
    def from_coo(row, col, val, n_nodes: int, n_cols: int = None, *, device):
        """Build from host COO arrays (any order, coalesced)."""
        row = np.asarray(row, dtype=np.int64)
        col = np.asarray(col, dtype=np.int64)
        val = np.asarray(val)
        n_cols = int(n_nodes if n_cols is None else n_cols)
        check_coalesced(row, col, n_cols)
        order = np.lexsort((col, row))
        edge_pos = np.empty(len(row), dtype=np.int64)
        edge_pos[order] = np.arange(len(row))
        r, c = row[order], col[order]
        perm_t = np.lexsort((r, c))

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(device)

        # log in f32, as JAX takes it of the f32 plan values; val 0 gives a
        # -inf logit, which drops the edge from the softmax
        with np.errstate(divide="ignore"):
            logval = np.log(val[order].astype(np.float32))
        row_ptr = np.searchsorted(r, np.arange(n_nodes + 1))
        row_ptr_t = np.searchsorted(c[perm_t], np.arange(n_cols + 1))
        split = row_split(row_ptr, device=device)
        split_t = row_split(row_ptr_t, device=device)
        return AttentionGraph(
            row_ptr=record(t(row_ptr), split),
            col=t(c),
            logval=torch.from_numpy(logval).to(device),
            row=t(r),
            row_ptr_t=record(t(row_ptr_t), split_t),
            col_t=t(r[perm_t]),
            perm_t=t(perm_t),
            edge_pos=t(edge_pos),
            n_nodes=int(n_nodes),
            n_edges=int(len(row)),
            n_cols=n_cols,
            split=split,
            split_t=split_t,
        )

    @staticmethod
    def from_sparse_graph(g) -> "AttentionGraph":
        """Build from a :class:`~textgcn_tpu_torch.graph.structs.SparseGraph`
        on its device (its padding dropped)."""
        row, col, val = g.coo_numpy()
        return AttentionGraph.from_coo(row, col, val, g.n_nodes, device=g.val.device)

    def to(self, device) -> "AttentionGraph":
        """This graph on ``device``: every tensor and both split tables
        moved, and each table's fingerprint recorded on its moved
        ``row_ptr``."""
        split = None if self.split is None else self.split.to(device)
        split_t = None if self.split_t is None else self.split_t.to(device)
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        moved["row_ptr"] = record(moved["row_ptr"], split)
        moved["row_ptr_t"] = record(moved["row_ptr_t"], split_t)
        return dataclasses.replace(self, **moved, split=split, split_t=split_t)

    @property
    def max_degree(self) -> int:
        """Edges of the longest forward row (the hub row)."""
        return int(torch.diff(self.row_ptr).max()) if self.n_nodes else 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (any float inputs, any device)
# ---------------------------------------------------------------------------


def _rows(row_ptr):
    n = row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), torch.diff(row_ptr.long())
    )


def _shift(mx):
    """The softmax shift of each row: its max, or 0 while it is the sentinel."""
    return torch.where(mx > _NEG / 2, mx, 0.0)


def softmax_stats_plain(row_ptr, logits):
    """Plain PyTorch version of :func:`softmax_stats`."""
    rows = _rows(row_ptr)
    n = row_ptr.numel() - 1
    lg = logits.float()
    mx = torch.full((n,), _NEG, dtype=torch.float32, device=lg.device)
    mx.scatter_reduce_(0, rows, lg, "amax")
    sm = torch.zeros(n, dtype=torch.float32, device=lg.device)
    sm.index_add_(0, rows, det_exp(lg - _shift(mx)[rows]))
    return mx, sm


def stats_logits_plain(row_ptr, col, logval, es, ed, slope):
    """Plain PyTorch version of :func:`stats_logits`."""
    base = es.float()[_rows(row_ptr)] + ed.float()[col.long()]
    logits = torch.where(base >= 0, base, slope * base) + logval
    return (logits, *softmax_stats_plain(row_ptr, logits))


def attn_agg_plain(row_ptr, col, logits, mx, sm, x, split=None):
    """Plain PyTorch version of :func:`attn_agg` (any float ``x``; ``split``
    is accepted and ignored)."""
    rows = _rows(row_ptr)
    inv = 1.0 / torch.clamp(sm, min=1e-30)
    w = det_exp(logits - _shift(mx)[rows]) * inv[rows]
    out = torch.zeros(
        row_ptr.numel() - 1, x.shape[1], dtype=torch.float32, device=x.device
    )
    return out.index_add_(0, rows, w[:, None] * x[col.long()].float())


def sddmm_plain(row_ptr, col, g, x, row=None):
    """Plain PyTorch version of :func:`sddmm` (any float ``g`` and ``x``;
    ``row`` is accepted and ignored)."""
    return (g[_rows(row_ptr)].float() * x[col.long()].float()).sum(dim=1)


def rowsum_plain(row_ptr, v):
    """Plain PyTorch version of :func:`rowsum`."""
    out = torch.zeros(row_ptr.numel() - 1, dtype=torch.float32, device=v.device)
    return out.index_add_(0, _rows(row_ptr), v.float())


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _features(name, x, n_rows=None):
    """Check a bf16 feature table the kernels read as 16-byte vectors."""
    if x.dim() != 2 or x.shape[1] % VEC or x.data_ptr() % 16:
        raise ValueError(
            f"{name}: features must be a 16-byte aligned [N, F] table with F "
            f"a multiple of {VEC}, got {tuple(x.shape)}"
        )
    if n_rows is not None and x.shape[0] < n_rows:
        raise ValueError(f"{name}: features need >= {n_rows} rows, got {x.shape[0]}")


def stats_logits(row_ptr, col, logval, es, ed, slope: float, split=None):
    """Per-edge GAT logits ``leaky(es[row] + ed[col], slope) + logval`` over
    the forward CSR, with each row's softmax max and sum over them.

    Returns ``(logits [E], mx [n_rows], sm [n_rows])``, f32. A row with no
    edges has ``mx = -1e30`` and ``sm = 0``. ``split`` is the forward CSR's
    :class:`RowSplit` (``AttentionGraph.split``; None when no row is longer
    than S); a table of another CSR is refused, on the CPU too, with no
    device sync. On CPU tensors this runs :func:`stats_logits_plain`; on
    CUDA tensors it launches ``csrc/attn_stats.cu`` or raises.
    """
    check_split("stats_logits", row_ptr, col.numel(), split, RowSplit, SEGMENT_EDGES)
    if es.device.type == "cpu":
        return stats_logits_plain(row_ptr, col, logval, es, ed, slope)
    i32, f32 = torch.int32, torch.float32
    _build.check("stats_logits", es.device, ("row_ptr", row_ptr, i32), ("col", col, i32),
                 ("logval", logval, f32), ("es", es, f32), ("ed", ed, f32))
    n_rows = row_ptr.numel() - 1
    if es.numel() < n_rows or col.numel() != logval.numel():
        raise ValueError("stats_logits: es needs a value per row and logval one per edge")
    logits = torch.empty_like(logval)
    mx = torch.empty(n_rows, dtype=f32, device=es.device)
    sm = torch.empty_like(mx)
    table, partial, n_seg, n_long = split_args("stats_logits", split, es.device, 2)
    _build.launch("stats_logits", stats_logits, "textgcn_attn_stats", es.device,
                  row_ptr, col, logval, es, ed, logits, mx, sm, table, partial, n_rows,
                  float(slope), 1, n_seg, n_long)
    return logits, mx, sm


def softmax_stats(row_ptr, logits, split=None):
    """Each row's softmax max and sum over given per-edge ``logits`` (the
    kernel of :func:`stats_logits` without building them). Returns
    ``(mx, sm)``, [n_rows] f32 each. ``split`` is the forward CSR's
    :class:`RowSplit`, checked as in :func:`stats_logits`."""
    check_split("softmax_stats", row_ptr, logits.numel(), split, RowSplit, SEGMENT_EDGES)
    if logits.device.type == "cpu":
        return softmax_stats_plain(row_ptr, logits)
    _build.check("softmax_stats", logits.device, ("row_ptr", row_ptr, torch.int32),
                 ("logits", logits, torch.float32))
    n_rows = row_ptr.numel() - 1
    mx = torch.empty(n_rows, dtype=torch.float32, device=logits.device)
    sm = torch.empty_like(mx)
    table, partial, n_seg, n_long = split_args("softmax_stats", split, logits.device, 2)
    _build.launch("softmax_stats", softmax_stats, "textgcn_attn_stats", logits.device,
                  row_ptr, None, None, None, None, logits, mx, sm, table, partial, n_rows,
                  0.0, 0, n_seg, n_long)
    return mx, sm


def attn_agg(row_ptr, col, logits, mx, sm, x, split=None):
    """``out[r] = sum_e exp(logits[e] - shift_r) / max(sm[r], 1e-30) *
    x[col[e]]`` over the forward CSR (``shift_r`` = ``mx[r]``, or 0 at the
    sentinel). ``x`` is [N, F] bf16 with F a multiple of 8; returns a new
    [n_rows, F] f32 tensor. The weights stay f32 (the TPU rounds them to
    bf16). ``split`` is the forward CSR's :class:`RowSplit`
    (``AttentionGraph.split``; None when no row is longer than S); a table
    of another CSR (other counts, or another ``row_ptr`` fingerprint, such
    as the transpose CSR's ``split_t``) is refused, with no device sync. On
    CPU tensors this runs :func:`attn_agg_plain`; on CUDA tensors it
    launches ``csrc/attn_agg.cu`` or raises.
    """
    check_split("attn_agg", row_ptr, col.numel(), split, RowSplit, SEGMENT_EDGES)
    if x.device.type == "cpu":
        return attn_agg_plain(row_ptr, col, logits, mx, sm, x)
    i32, f32 = torch.int32, torch.float32
    _build.check("attn_agg", x.device, ("row_ptr", row_ptr, i32), ("col", col, i32),
                 ("logits", logits, f32), ("mx", mx, f32), ("sm", sm, f32),
                 ("x", x, torch.bfloat16))
    _features("attn_agg", x)
    n_rows, f = row_ptr.numel() - 1, x.shape[1]
    out = torch.empty(n_rows, f, dtype=f32, device=x.device)
    table, partial, n_seg, n_long = split_args("attn_agg", split, x.device, f)
    _build.launch("attn_agg", attn_agg, "textgcn_attn_agg", x.device,
                  row_ptr, col, logits, mx, sm, x, out, table, partial, n_rows, f // VEC,
                  n_seg, n_long)
    return out


def sddmm(row_ptr, col, g, x, row):
    """``u[e] = g[row_e] . x[col_e]`` for every edge of the forward CSR, in
    forward-CSR order. ``g`` [>= n_rows, F] and ``x`` [N, F] are bf16 with F
    a multiple of 8; returns [E] f32. ``row`` [E] int32 is each edge's row,
    ``row_ptr`` expanded (``AttentionGraph.row``), which the edge-parallel
    kernel reads (it does not check that the two agree). On CPU tensors this
    runs :func:`sddmm_plain`; on CUDA tensors it launches ``csrc/sddmm.cu``
    or raises.
    """
    if x.device.type == "cpu":
        return sddmm_plain(row_ptr, col, g, x)
    i32, bf16 = torch.int32, torch.bfloat16
    _build.check("sddmm", x.device, ("row_ptr", row_ptr, i32), ("col", col, i32),
                 ("row", row, i32), ("g", g, bf16), ("x", x, bf16))
    n_rows, n_edges = row_ptr.numel() - 1, col.numel()
    _features("sddmm", g, n_rows)
    _features("sddmm", x)
    if g.shape[1] != x.shape[1]:
        raise ValueError(f"sddmm: g is {tuple(g.shape)} and x {tuple(x.shape)}")
    if row.numel() != n_edges:
        raise ValueError(f"sddmm: row has {row.numel()} entries for {n_edges} edges")
    u = torch.empty(n_edges, dtype=torch.float32, device=x.device)
    _build.launch("sddmm", sddmm, "textgcn_sddmm", x.device,
                  row, col, g, x, u, n_edges, x.shape[1] // VEC)
    return u


def rowsum(row_ptr, v, split=None):
    """``out[r] = sum_{e in row r} v[e]`` over a CSR; returns [n_rows] f32.
    ``split`` is that CSR's :class:`RowSplit` (``AttentionGraph.split`` for
    the forward CSR, ``split_t`` for the transpose; None when no row is
    longer than S); a table of another CSR is refused, on the CPU too, with
    no device sync. On CPU tensors this runs :func:`rowsum_plain`; on CUDA
    tensors it launches ``csrc/rowsum.cu`` or raises."""
    check_split("rowsum", row_ptr, v.numel(), split, RowSplit, SEGMENT_EDGES)
    if v.device.type == "cpu":
        return rowsum_plain(row_ptr, v)
    _build.check("rowsum", v.device, ("row_ptr", row_ptr, torch.int32),
                 ("v", v, torch.float32))
    n_rows = row_ptr.numel() - 1
    out = torch.empty(n_rows, dtype=torch.float32, device=v.device)
    table, partial, n_seg, n_long = split_args("rowsum", split, v.device, 1)
    _build.launch("rowsum", rowsum, "textgcn_rowsum", v.device,
                  row_ptr, v, out, table, partial, n_rows, n_seg, n_long)
    return out


stats_logits.launches = 0
softmax_stats.launches = 0
attn_agg.launches = 0
sddmm.launches = 0
rowsum.launches = 0


# ---------------------------------------------------------------------------
# differentiable attention ops
# ---------------------------------------------------------------------------


def features_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernels read it: a contiguous bf16 [N, F'] table, F
    padded with zero columns to F' = the next multiple of 8."""
    f = x.shape[1]
    fp = -(-f // VEC) * VEC
    if fp == f:
        return x.to(torch.bfloat16).contiguous()
    out = x.new_zeros((x.shape[0], fp), dtype=torch.bfloat16)
    out[:, :f] = x
    return out


def edge_weights(ag: AttentionGraph, logits, mx, sm):
    """Per-edge softmax weights [E] from the row statistics, 0 for a -inf
    logit (the backward's counterpart of the weights :func:`attn_agg` forms
    in registers)."""
    st = torch.stack([mx, sm], dim=1).index_select(0, ag.row)
    w = det_exp(logits - _shift(st[:, 0])) / torch.clamp(st[:, 1], min=1e-30)
    return torch.where(logits > _NEG / 2, w, 0.0)


def _softmax_backward(ag: AttentionGraph, wt, g16, x16):
    """``dlogits = wt * (u - S_row)`` with ``u = g[row] . x[col]`` (SDDMM)
    and ``S_row = sum_row wt * u`` (rowsum), and ``dx = Aᵀ_wt @ g`` (K2 over
    the transpose CSR with the weights moved there)."""
    u = sddmm(ag.row_ptr, ag.col, g16, x16, ag.row)
    s_row = rowsum(ag.row_ptr, wt * u, split=ag.split)
    dlog = wt * (u - s_row.index_select(0, ag.row))
    dx = row_reduce(
        ag.row_ptr_t, ag.col_t, wt.index_select(0, ag.perm_t), g16, split=ag.split_t
    )
    return dlog, dx


class _GatAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ag, es, ed, x, slope):
        logits, mx, sm = stats_logits(
            ag.row_ptr, ag.col, ag.logval, es.contiguous(), ed.contiguous(), slope,
            split=ag.split,
        )
        x16 = features_bf16(x)
        out = attn_agg(ag.row_ptr, ag.col, logits, mx, sm, x16, split=ag.split)
        ctx.ag, ctx.slope = ag, slope
        ctx.save_for_backward(logits, mx, sm, x16, es, ed)
        return out[:, : x.shape[1]]

    @staticmethod
    def backward(ctx, g):
        ag, slope = ctx.ag, ctx.slope
        logits, mx, sm, x16, es, ed = ctx.saved_tensors
        f = g.shape[1]
        wt = edge_weights(ag, logits, mx, sm)
        dlog, dx = _softmax_backward(ag, wt, features_bf16(g), x16)
        # leaky' from the sign of the pre-activation es[row] + ed[col] (the
        # same f32 sum as the forward kernel's). JAX reads it from logit -
        # log(val), which is 0 where |leaky(base)| is below half an ulp of
        # log(val), and then takes slope 1 for a negative base
        base = es.index_select(0, ag.row) + ed.index_select(0, ag.col)
        dbase = dlog * torch.where(base >= 0, 1.0, slope)
        des = rowsum(ag.row_ptr, dbase, split=ag.split)
        ded = rowsum(ag.row_ptr_t, dbase.index_select(0, ag.perm_t), split=ag.split_t)
        return None, des, ded, dx[:, :f], None


def gat_attention(ag: AttentionGraph, es, ed, x, slope: float = 0.2):
    """The sparse side of a GAT layer as one op, differentiable in (es, ed,
    x): ``out[r] = sum_e softmax_r(leaky(es[r] + ed[col_e]) + log(val_e)) *
    x[col_e]``. ``es`` [n_nodes] and ``ed`` [n_cols] f32, ``x`` [n_cols, F].

    Forward: :func:`stats_logits`, then :func:`attn_agg` on bf16 features.
    Backward (JAX ``_gat_bwd``): :func:`sddmm` and :func:`rowsum` for the
    softmax, :func:`rowsum` for des (forward CSR) and ded (transpose CSR),
    K2 over the transpose CSR for dx.
    """
    if es.numel() != ag.n_nodes or ed.numel() != ag.n_cols or x.shape[0] != ag.n_cols:
        raise ValueError(
            f"gat_attention: es [{ag.n_nodes}], ed [{ag.n_cols}] and x "
            f"[{ag.n_cols}, F] expected, got {tuple(es.shape)}, "
            f"{tuple(ed.shape)}, {tuple(x.shape)}"
        )
    return _GatAttention.apply(ag, es, ed, x, float(slope))


class _AttentionSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ag, logits, x):
        logits = logits.contiguous()
        mx, sm = softmax_stats(ag.row_ptr, logits, split=ag.split)
        x16 = features_bf16(x)
        out = attn_agg(ag.row_ptr, ag.col, logits, mx, sm, x16, split=ag.split)
        ctx.ag = ag
        ctx.save_for_backward(logits, mx, sm, x16)
        return out[:, : x.shape[1]]

    @staticmethod
    def backward(ctx, g):
        logits, mx, sm, x16 = ctx.saved_tensors
        wt = edge_weights(ctx.ag, logits, mx, sm)
        dlog, dx = _softmax_backward(ctx.ag, wt, features_bf16(g), x16)
        return None, dlog, dx[:, : g.shape[1]]


def attention_spmm(ag: AttentionGraph, logits, x):
    """Softmax-weighted aggregation over the forward CSR, differentiable in
    ``logits`` ([E] f32 in forward-CSR order; -inf drops an edge) and ``x``
    [n_cols, F]. Forward: :func:`softmax_stats` + :func:`attn_agg`; backward
    (JAX ``_attn_bwd``): K2 over the transpose CSR for dx, :func:`sddmm` and
    :func:`rowsum` for dlogits."""
    return _AttentionSpmm.apply(ag, logits, x)


class _EdgeLogitBase(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ag, es, ed):
        ctx.ag = ag
        return es.float().index_select(0, ag.row) + ed.float().index_select(0, ag.col)

    @staticmethod
    def backward(ctx, g):
        ag = ctx.ag
        g = g.float().contiguous()
        des = rowsum(ag.row_ptr, g, split=ag.split)
        ded = rowsum(ag.row_ptr_t, g.index_select(0, ag.perm_t), split=ag.split_t)
        return None, des, ded


def edge_logit_base(ag: AttentionGraph, es, ed):
    """``es[row_e] + ed[col_e]`` for every edge of the forward CSR ([E] f32,
    forward-CSR order), differentiable in ``es`` [n_nodes] and ``ed``
    [n_cols] with a backward free of scatters, as the JAX function's: des
    is :func:`rowsum` of the cotangent over the forward CSR (with
    ``ag.split``), ded :func:`rowsum` over the transpose CSR of the
    cotangent moved there by ``perm_t`` (with ``ag.split_t``)."""
    if es.numel() != ag.n_nodes or ed.numel() != ag.n_cols:
        raise ValueError(
            f"edge_logit_base: es [{ag.n_nodes}] and ed [{ag.n_cols}] expected, "
            f"got {tuple(es.shape)} and {tuple(ed.shape)}"
        )
    return _EdgeLogitBase.apply(ag, es, ed)


class _SpmmOnehotEw(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ag, val, x):
        val = val.float().contiguous()
        x16 = features_bf16(x)
        ctx.ag = ag
        ctx.save_for_backward(val, x16)
        return row_reduce(ag.row_ptr, ag.col, val, x16, split=ag.split)[:, : x.shape[1]]

    @staticmethod
    def backward(ctx, g):
        ag = ctx.ag
        val, x16 = ctx.saved_tensors
        f = g.shape[1]
        g16 = features_bf16(g)
        dx = row_reduce(
            ag.row_ptr_t, ag.col_t, val.index_select(0, ag.perm_t), g16, split=ag.split_t
        )
        dval = sddmm(ag.row_ptr, ag.col, g16, x16, ag.row)
        return None, dval, dx[:, :f]


def spmm_onehot_ew(ag: AttentionGraph, val, x):
    """``A @ x`` with learnable edge values ``val`` ([E] f32, forward-CSR
    order), differentiable in ``val`` and ``x`` [n_cols, F]: the port of the
    JAX ``spmm_onehot_ew``. Forward: K2 from zero over the forward CSR
    (``ag.split``) on bf16 features; dx: K2 over the transpose CSR with
    ``val[perm_t]`` (``ag.split_t``); dval: :func:`sddmm` of the bf16
    cotangent and features. Returns [n_nodes, F] f32."""
    if val.numel() != ag.n_edges or x.shape[0] != ag.n_cols:
        raise ValueError(
            f"spmm_onehot_ew: val [{ag.n_edges}] and x [{ag.n_cols}, F] expected, "
            f"got {tuple(val.shape)} and {tuple(x.shape)}"
        )
    return _SpmmOnehotEw.apply(ag, val, x)
