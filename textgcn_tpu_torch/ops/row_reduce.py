"""K2: row-sorted residual edges reduced onto output rows (the hybrid
format's residual leg).

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
- Bound on the card: the random reads of feature rows, one bf16 row of F
  values per edge; the sum itself is a few FMAs per byte.
- Design against that bound: the gather of ``x`` and the scale by ``val``
  happen inside the kernel, in registers (the TPU version has XLA write the
  [E, F] bf16 product stream to memory first), one warp reads each feature
  row with coalesced 4-byte loads, and each output row is read and written
  once.
- ``base`` is updated IN PLACE and returned. JAX never aliases; the port
  does, so that on the hybrid path the tile leg's output is the residual
  leg's accumulator and the two legs' sum costs no extra pass.
"""
from __future__ import annotations

import torch

from textgcn_tpu_torch.ops import _build


def row_reduce_plain(row_ptr, col, val, x, base=None):
    """Plain PyTorch version of :func:`row_reduce` (any float ``x``)."""
    n_rows = row_ptr.numel() - 1
    out = base
    if out is None:
        out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), torch.diff(row_ptr.long())
    )
    return out.index_add_(0, rows, val.float()[:, None] * x[col.long()].float())


def _check(row_ptr, col, val, x, out):
    dev = x.device
    for name, t in (("row_ptr", row_ptr), ("col", col), ("val", val), ("out", out)):
        if t.device != dev:
            raise ValueError(f"row_reduce: {name} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"row_reduce: {name} must be contiguous")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError("row_reduce: row_ptr and col must be int32")
    if val.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError("row_reduce: val and base must be float32")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"row_reduce: the CUDA kernel gathers bf16 x, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.shape[1] % 2:
        raise ValueError("row_reduce: x must be contiguous [N, F] with F even")
    if col.numel() != val.numel():
        raise ValueError("row_reduce: col and val must have one entry per edge")
    if out.dim() != 2 or out.shape[1] != x.shape[1] or out.shape[0] < row_ptr.numel() - 1:
        raise ValueError(
            f"row_reduce: base must be [>= {row_ptr.numel() - 1}, {x.shape[1]}],"
            f" got {tuple(out.shape)}"
        )


def row_reduce(row_ptr, col, val, x, base=None):
    """``out[r] = base[r] + sum_{e in row r} val[e] * x[col[e]]`` over a
    row-sorted CSR (``row_ptr`` [n_rows + 1], ``col`` and ``val`` [E]).

    With ``base`` ([>= n_rows, F] f32) the sum is added onto it in place and
    ``base`` is returned; without, a new [n_rows, F] f32 tensor is. Every
    ``col`` is a row of ``x`` (``ResidualCSR.from_coo`` builds it so; the
    kernel does not check).

    On CPU tensors this runs :func:`row_reduce_plain`; on CUDA tensors it
    launches the kernel (building it on first use) or raises.
    """
    if x.device.type == "cpu":
        return row_reduce_plain(row_ptr, col, val, x, base)
    if x.device.type != "cuda":
        raise ValueError(f"row_reduce: no kernel for device {x.device}")
    n_rows = row_ptr.numel() - 1
    out = base
    if out is None:
        out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    _check(row_ptr, col, val, x, out)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.textgcn_row_reduce(
            row_ptr.data_ptr(), col.data_ptr(), val.data_ptr(), x.data_ptr(),
            out.data_ptr(), n_rows, x.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    row_reduce.launches += 1
    _build.check_launch("row_reduce", err)
    return out


row_reduce.launches = 0
