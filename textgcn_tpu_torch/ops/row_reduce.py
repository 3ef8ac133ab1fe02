"""K2: row-sorted edges reduced onto output rows (the hybrid format's
residual leg, GAT's dx over the transpose CSR, the streamed chunk add).

Ports ``textgcn_tpu/ops/pallas_onehot.py``. The kernel is
``csrc/row_reduce.cu``, a hand-written CUDA kernel for Hopper (``sm_90a``).

Source note:

- Replaces the Pallas kernels ``_onehot_kernel_base`` (windows start from a
  base: the hybrid's fused ``bsr_out + rest_out``) and ``_onehot_kernel``
  (windows start from zero) of ``textgcn_tpu/ops/pallas_onehot.py``. The
  TPU reduces row-sorted edge products with one-hot matmuls because it has no
  fast scatter; the port keeps the edges as a CSR and sums each row directly.
  The ``OneHotPlan`` padding (k-chunks, windows, superchunks, phantom slots)
  is a TPU layout and is not carried over.
- Bound on the card: the gathers of feature rows, one bf16 row of F values
  per edge; the sum itself is a few FMAs per byte. At R8's sizes the table
  sits in L2 and the L2 gather rate bounds the pass; at the streamed sizes
  the random reads from HBM do.
- The hub rows: no warp walks more than :data:`SEGMENT_EDGES` (S) edges. A
  row longer than S is cut into row-local segments (boundaries at multiples
  of S from its first edge) listed in a :class:`RowSplit`, which
  :func:`row_split` builds once where the CSR is built
  (``ResidualCSR.from_coo``, ``AttentionGraph.from_coo``, ``csr_stream``)
  and which the CSR's container keeps. Each segment's warp writes an f32
  partial row; a second small launch adds a long row's partials onto its
  base in segment order. A CSR with no row longer than S has no table
  (``split=None``) and costs one launch. A table records the fingerprint
  of the ``row_ptr`` it was built from, and the wrapper refuses it with
  another CSR, even one with the same counts
  (:mod:`~textgcn_tpu_torch.ops.split`). Sums take a fixed order and no
  atomics: two launches give the same bits, and a row the same bits in any
  CSR that holds it. Without a table every row is walked by one warp
  whatever its length (right, but not balanced).
- One walk over the edges for F <= 256: each lane keeps its columns in f32
  registers and reads 16-byte bf16 vectors (F % 8 == 0, F > 16 and 16-byte
  aligned ``x`` and ``base``; 4-byte vectors of 2 columns otherwise: the
  kernel chooses), with several gathers in flight; narrow rows (F = 8, 16:
  F/2 lanes an edge) give a warp's 32/(F/2) lane groups different edges and
  sum the groups with shuffles in a fixed order. The gather of ``x`` and the
  scale by ``val`` happen in registers (the TPU version has XLA write the
  [E, F] bf16 product stream to memory first), and each output row is read
  and written once.
- ``base`` is updated IN PLACE and returned. JAX never aliases; the port
  does, so that on the hybrid path the tile leg's output is the residual
  leg's accumulator and the two legs' sum costs no extra pass.
- Runs of chunks (no TPU counterpart: the JAX stream is one jitted scan).
  A streamed pass reduces row-sorted chunks onto disjoint row ranges of
  one accumulator, one call a chunk, and a call costs the host more than
  the kernel takes. :func:`reduce_run` checks chunks that stay on the card
  once and lists them in a small device table (:class:`ReduceRun`); then
  :func:`row_reduce_run` reduces all of them in one launch, each row with
  the bits of its chunk's own call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch

from textgcn_tpu_torch.ops import _build
from textgcn_tpu_torch.ops.split import RowSplit, build_split, check_split
from textgcn_tpu_torch.utils import profiling

# S: the most edges one warp walks; the kernel's compile-time constant
# (csrc/row_reduce.cu kSegEdges), which a RowSplit table must be built for
SEGMENT_EDGES = 512


def row_split(row_ptr, device=None) -> Optional[RowSplit]:
    """The :class:`RowSplit` of a CSR's ``row_ptr`` (numpy or tensor; a
    device tensor is copied to the host once) at S, on ``device`` (row_ptr's
    by default), or None when no row has more than S edges. Build it once
    with the CSR, never per launch, and :func:`~textgcn_tpu_torch.ops.split.record`
    its fingerprint on the CSR's ``row_ptr`` tensor (done here when
    ``row_ptr`` is one)."""
    return build_split(row_ptr, SEGMENT_EDGES, RowSplit, device)


def row_reduce_plain(row_ptr, col, val, x, base=None, split=None):
    """Plain PyTorch version of :func:`row_reduce` (any float ``x``;
    ``split`` is accepted and ignored)."""
    n_rows = row_ptr.numel() - 1
    out = base
    if out is None:
        out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), torch.diff(row_ptr.long())
    )
    return out.index_add_(0, rows, val.float()[:, None] * x[col.long()].float())


def _check(row_ptr, col, val, x, out, split):
    dev = x.device
    tensors = [("row_ptr", row_ptr), ("col", col), ("val", val), ("out", out)]
    if split is not None:
        tensors.append(("split", split.table))
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"row_reduce: {name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"row_reduce: {name} must be contiguous")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("row_reduce: row_ptr and col must be int32")
    if val.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("row_reduce: val and base must be float32")
    if col.numel() != val.numel():
        raise ValueError("row_reduce: col and val must have one entry per edge")
    _check_x_base("row_reduce", x, out, row_ptr.numel() - 1)


def _check_x_base(name, x, out, n_rows):
    """The kernel's terms for ``x`` and ``base`` (``out``) of ``n_rows``
    output rows."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel gathers bf16 x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] % 2:
        raise ValueError(f"{name}: x must be contiguous [N, F] with F even")
    if x.data_ptr() % 4 or out.data_ptr() % 8:
        raise ValueError(f"{name}: x must be 4-byte and base 8-byte aligned")
    if out.dim() != 2 or out.shape[1] != x.shape[1] or out.shape[0] < n_rows:
        raise ValueError(
            f"{name}: base must be [>= {n_rows}, {x.shape[1]}], got {tuple(out.shape)}"
        )


def row_reduce(row_ptr, col, val, x, base=None, split=None):
    """``out[r] = base[r] + sum_{e in row r} val[e] * x[col[e]]`` over a
    row-sorted CSR (``row_ptr`` [n_rows + 1], ``col`` and ``val`` [E]).

    With ``base`` ([>= n_rows, F] f32) the sum is added onto it in place and
    ``base`` is returned; without, a new [n_rows, F] f32 tensor is. Every
    ``col`` is a row of ``x`` (``ResidualCSR.from_coo`` builds it so; the
    kernel does not check). ``split`` is the CSR's :class:`RowSplit` from
    :func:`row_split` (None when no row is longer than S); a table whose
    row or edge count, or whose ``row_ptr`` fingerprint, differs from this
    CSR's is refused (host integers, no device sync).

    On CPU tensors this runs :func:`row_reduce_plain`; on CUDA tensors it
    launches the kernel (building it on first use) or raises, and counts
    the launch in ``row_reduce.launches``; while the span recorder is on
    (:func:`~textgcn_tpu_torch.utils.profiling.record_spans`) a launch, from
    the checks to the launch's error check, is a ``k2.launch`` span.
    """
    t0 = profiling.spans_on and time.time_ns()
    check_split("row_reduce", row_ptr, col.numel(), split, RowSplit, SEGMENT_EDGES)
    if x.device.type == "cpu":
        return row_reduce_plain(row_ptr, col, val, x, base)
    if x.device.type != "cuda":
        raise ValueError(f"row_reduce: no kernel for device {x.device}")
    n_rows, f = row_ptr.numel() - 1, x.shape[1]
    has_base = base is not None
    out = base if has_base else torch.empty(n_rows, f, dtype=torch.float32, device=x.device)
    _check(row_ptr, col, val, x, out, split)
    if split is None:
        table, partial, n_seg, n_long = None, None, 0, 0
    else:
        table, n_seg, n_long = split.table, split.n_seg, split.n_long
        partial = torch.empty(n_seg, f, dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.textgcn_row_reduce(
            row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
            out.data_ptr(), None if table is None else table.data_ptr(),
            None if partial is None else partial.data_ptr(), n_rows, f,
            int(has_base), n_seg, n_long,
            torch.cuda.current_stream().cuda_stream,
        )
    row_reduce.launches += 1
    _build.check_launch("row_reduce", err)
    if t0:
        profiling.leaf("k2.launch", t0)
    return out


row_reduce.launches = 0
# chunks reduced inside run launches (:func:`row_reduce_run`), each of
# which counts one in ``row_reduce.launches``
row_reduce.batched_chunks = 0


@dataclasses.dataclass(frozen=True)
class ReduceRun:
    """Row-sorted CSRs over ascending, disjoint row ranges of one
    accumulator, none with a split table, that :func:`row_reduce_run`
    reduces in one launch. Built once by :func:`reduce_run`.

    ``csrs`` holds each CSR's ``(row_ptr, col, val, r0)``: row ``i`` of one
    is output row ``r0 + i``. ``table`` lists them on their CUDA device for
    the kernel: one int64 row a CSR (the three tensors' device addresses,
    ``r0``), then the CSRs' row counts summed before each ([n + 1]); None on
    the CPU. The run keeps the tensors it points at alive. Unpickled in
    another process, it builds its table anew there."""

    csrs: Tuple[tuple, ...]
    table: Optional[torch.Tensor]
    n_rows: int  # rows of all the CSRs: warps of the launch
    r_end: int  # past the last CSR's rows
    device: torch.device

    @property
    def n_chunks(self) -> int:
        return len(self.csrs)

    def __reduce__(self):
        return reduce_run, (self.csrs,)


def reduce_run(csrs) -> ReduceRun:
    """The :class:`ReduceRun` of ``csrs``, ``(row_ptr, col, val, r0)`` each
    (no split table), with the checks that :func:`row_reduce` makes of a
    CSR on every call made here once: one device, contiguous 1-D int32
    ``row_ptr`` and ``col`` and f32 ``val``, as many ``val`` as ``col``, and
    row ranges that ascend without overlap (host integers)."""
    csrs = tuple((row_ptr, col, val, int(r0)) for row_ptr, col, val, r0 in csrs)
    if not csrs:
        raise ValueError("reduce_run: a run needs at least one CSR")
    dev = csrs[0][1].device
    rows_before, end = [0], 0
    for row_ptr, col, val, r0 in csrs:
        for name, t in (("row_ptr", row_ptr), ("col", col), ("val", val)):
            if t.device != dev:
                raise ValueError(f"reduce_run: a {name} is on {t.device}, the first col on {dev}")
            if t.dim() != 1 or not t.is_contiguous():
                raise ValueError(f"reduce_run: {name} must be contiguous and 1-D")
        if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
            raise TypeError("reduce_run: row_ptr and col must be int32")
        if val.dtype != torch.float32:
            raise TypeError("reduce_run: val must be float32")
        if col.numel() != val.numel():
            raise ValueError("reduce_run: col and val must have one entry per edge")
        if row_ptr.numel() < 1:
            raise ValueError("reduce_run: row_ptr must hold rows + 1 offsets")
        if r0 < end:
            raise ValueError(
                f"reduce_run: rows from {r0} overlap or precede the rows before, which end at "
                f"{end}; one launch has no order between two warps on a row"
            )
        rows = row_ptr.numel() - 1
        end = r0 + rows
        rows_before.append(rows_before[-1] + rows)
    if rows_before[-1] >= 2**31:
        raise ValueError(f"reduce_run: {rows_before[-1]} rows do not fit the kernel's int")
    table = None
    if dev.type == "cuda":
        flat = [v for rp, col, val, r0 in csrs
                for v in (rp.data_ptr(), col.data_ptr(), val.data_ptr(), r0)]
        table = torch.tensor(flat + rows_before, dtype=torch.int64).to(dev)
    return ReduceRun(csrs, table, rows_before[-1], end, dev)


def row_reduce_run_plain(run: ReduceRun, x, base):
    """Plain PyTorch version of :func:`row_reduce_run`: :func:`row_reduce_plain`
    on each CSR's rows of ``base``, in order."""
    for row_ptr, col, val, r0 in run.csrs:
        row_reduce_plain(row_ptr, col, val, x, base[r0 : r0 + row_ptr.numel() - 1])
    return base


def row_reduce_run(run: ReduceRun, x, base):
    """:func:`row_reduce` of every CSR of ``run`` onto its rows of ``base``
    ([>= run.r_end, F] f32, in place; returned): ``base[r0 + i] += sum_{e in
    row i} val[e] * x[col[e]]``, each row with the bits of the CSR's own
    call, in one launch.

    The CSRs were checked when the run was built (:func:`reduce_run`); a
    call checks ``x`` and ``base`` only. On CPU tensors this runs
    :func:`row_reduce_run_plain`; on CUDA tensors it launches the kernel
    (``row_reduce_kernel_run``) or raises, counts one launch in
    ``row_reduce.launches`` and the run's CSRs in
    ``row_reduce.batched_chunks``; while the span recorder is on the launch
    is a ``k2.launch`` span, as a call of :func:`row_reduce` is.
    """
    t0 = profiling.spans_on and time.time_ns()
    if x.device != run.device:
        raise ValueError(f"row_reduce_run: x is on {x.device}, the run on {run.device}")
    if x.device.type == "cpu":
        return row_reduce_run_plain(run, x, base)
    if x.device.type != "cuda":
        raise ValueError(f"row_reduce_run: no kernel for device {x.device}")
    if base.device != x.device or base.dtype != torch.float32 or not base.is_contiguous():
        raise ValueError("row_reduce_run: base must be contiguous f32 on x's device")
    _check_x_base("row_reduce_run", x, base, run.r_end)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.textgcn_row_reduce_run(
            run.table.data_ptr(), run.n_chunks, run.n_rows, x.data_ptr(), base.data_ptr(),
            x.shape[1], torch.cuda.current_stream().cuda_stream,
        )
    row_reduce.launches += 1
    row_reduce.batched_chunks += run.n_chunks
    _build.check_launch("row_reduce_run", err)
    if t0:
        profiling.leaf("k2.launch", t0)
    return base
