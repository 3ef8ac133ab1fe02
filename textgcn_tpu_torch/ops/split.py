"""Split tables: the segments of the long rows of a CSR, and the fingerprint
that ties a table to the CSR it was built from.

No JAX counterpart: the TPU kernels walk fixed chunks of a padded plan, one
grid step after another, so a long row costs them steps, not imbalance. On
the card a row walked by one warp (K2, ``attn_agg``) or a block-row walked
by one block (K1) makes the whole call wait for it, so each of those kernels
cuts its long rows into segments of at most a fixed length, ``seg_len`` (S
edges for K2 and ``attn_agg``, T tiles for K1), writes a partial sum per
segment and adds a long row's partials in segment order in a second pass
(``csrc/row_split.cuh``).

A table lists those segments (:class:`RowSplit`; :class:`TileSplit` for K1,
whose rows are block-rows and whose items are tiles). It is built once, on
the host, where the CSR is built, and carried by the CSR's container. A
kernel trusts its table, so a table of another CSR would give wrong sums
without an error. Each table therefore records ``fingerprint``, a hash of
the pointer array (``row_ptr``, ``tile_ptr``) it was built from, and the
container records the same fingerprint on its pointer tensor
(:func:`record`). A wrapper refuses a table whose fingerprint differs from
its pointer tensor's (:func:`check_split`). That reads two host integers,
with no device sync; only a device pointer tensor that no container
recorded (one a caller built by hand) is copied to the host once, on its
first check, and the result kept on the tensor. :func:`split_args` turns a
checked table into the four arguments the kernels' C entry points take.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional

import numpy as np
import torch

from textgcn_tpu_torch.ops import _build

_TAG = "_textgcn_csr_fingerprint"  # (tensor version, fingerprint) on a tensor


def fingerprint(ptr) -> int:
    """A 64-bit hash of a CSR pointer array's values (numpy or CPU tensor;
    the dtype does not matter)."""
    a = np.ascontiguousarray(np.asarray(ptr), dtype=np.int64)
    return int.from_bytes(hashlib.blake2b(a.tobytes(), digest_size=8).digest(), "little")


def record(ptr: torch.Tensor, split) -> torch.Tensor:
    """Record ``split``'s fingerprint on ``ptr``, the pointer tensor that
    ``split`` was built from, and return ``ptr`` (nothing when ``split`` is
    None). A container calls it where it builds both from one host array,
    and again on each copy of the tensor that it makes (``.to``)."""
    if split is not None:
        setattr(ptr, _TAG, (ptr._version, split.fingerprint))
    return ptr


def fingerprint_of(ptr: torch.Tensor) -> int:
    """``ptr``'s recorded fingerprint; else computed from its values (one
    copy to the host for a device tensor), and recorded. An in-place change
    to ``ptr`` voids the record."""
    tag = getattr(ptr, _TAG, None)
    if tag is not None and tag[0] == ptr._version:
        return tag[1]
    fp = fingerprint(ptr.detach().cpu().numpy())
    setattr(ptr, _TAG, (ptr._version, fp))
    return fp


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The segments of a CSR's rows longer than ``seg_len``.

    ``table`` is one int32 tensor holding, back to back, ``seg_row``
    [n_seg] (each segment's row), ``seg_e0`` [n_seg] (its first edge; it
    ends ``seg_len`` edges later or at its row's end) and ``long_ptr``
    [n_long + 1] (long row i owns segments ``long_ptr[i] .. long_ptr[i+1] -
    1``, in order). Segments run in row order, a row's in edge order.
    ``n_rows`` and ``n_edges`` are the CSR's counts and ``fingerprint`` the
    hash of its ``row_ptr`` (:func:`fingerprint`), which the kernels'
    wrappers check against the CSR they are given.
    """

    table: torch.Tensor
    n_seg: int
    n_long: int
    n_rows: int
    n_edges: int
    fingerprint: int
    seg_len: int

    @property
    def seg_row(self) -> torch.Tensor:
        return self.table[: self.n_seg]

    @property
    def seg_e0(self) -> torch.Tensor:
        return self.table[self.n_seg : 2 * self.n_seg]

    @property
    def long_ptr(self) -> torch.Tensor:
        return self.table[2 * self.n_seg :]

    @property
    def nbytes(self) -> int:
        return self.table.numel() * self.table.element_size()

    def to(self, device, non_blocking: bool = False):
        return dataclasses.replace(self, table=self.table.to(device, non_blocking=non_blocking))

    def pin_memory(self):
        return dataclasses.replace(self, table=self.table.pin_memory())


class TileSplit(RowSplit):
    """A :class:`RowSplit` over a tile stack's ``tile_ptr``: its rows are
    block-rows and its edges tiles (``seg_e0`` is a segment's first tile),
    cut at K1's T."""

    @property
    def n_block_rows(self) -> int:
        return self.n_rows

    @property
    def n_tiles(self) -> int:
        return self.n_edges


def build_split(ptr, seg_len: int, cls=RowSplit, device=None) -> Optional[RowSplit]:
    """The ``cls`` table of the pointer array ``ptr`` (numpy or tensor; a
    device tensor is copied to the host once, and its fingerprint recorded)
    at ``seg_len``, on ``device`` (ptr's by default), or None when no row
    has more than ``seg_len`` items. Build it once with the CSR, never per
    launch."""
    tensor = ptr if isinstance(ptr, torch.Tensor) else None
    if tensor is not None:
        device = tensor.device if device is None else device
        ptr = tensor.detach().cpu().numpy()
    rp = np.asarray(ptr, dtype=np.int64)
    deg = np.diff(rp)
    long_rows = np.flatnonzero(deg > seg_len)
    if len(long_rows) == 0:
        return None
    n_segs = -(-deg[long_rows] // seg_len)
    long_ptr = np.concatenate([[0], np.cumsum(n_segs)])
    seg_row = np.repeat(long_rows, n_segs)
    k = np.arange(long_ptr[-1]) - np.repeat(long_ptr[:-1], n_segs)
    seg_e0 = rp[seg_row] + k * seg_len
    table = np.concatenate([seg_row, seg_e0, long_ptr]).astype(np.int32)
    split = cls(
        torch.from_numpy(table).to("cpu" if device is None else device),
        int(long_ptr[-1]), int(len(long_rows)), len(rp) - 1, int(rp[-1]),
        fingerprint(rp), int(seg_len),
    )
    if tensor is not None:
        record(tensor, split)
    return split


def check_split(name: str, ptr: torch.Tensor, n_items: int, split, cls, seg_len: int) -> None:
    """Refuse a ``split`` that is not a ``cls`` table at ``seg_len`` of the
    CSR with pointer tensor ``ptr`` and ``n_items`` edges (tiles): its
    counts first, then its fingerprint against ``ptr``'s
    (:func:`fingerprint_of`; host integers, no sync for a recorded
    ``ptr``)."""
    if split is None:
        return
    if type(split) is not cls or split.seg_len != seg_len:
        raise ValueError(
            f"{name}: the split table must be a {cls.__name__} cut at {seg_len}, "
            f"got a {type(split).__name__} cut at {getattr(split, 'seg_len', None)}"
        )
    if split.n_rows != ptr.numel() - 1 or split.n_edges != n_items:
        raise ValueError(
            f"{name}: the split table is of a CSR of {split.n_rows} rows and "
            f"{split.n_edges} edges, given {ptr.numel() - 1} rows and "
            f"{n_items} edges"
        )
    if split.fingerprint != fingerprint_of(ptr):
        raise ValueError(
            f"{name}: the split table was built from another CSR with the same "
            f"counts ({split.n_rows} rows, {split.n_edges} edges): its row "
            "pointer's fingerprint differs"
        )


def split_args(name: str, split, device: torch.device, *width):
    """``(table, partial, n_seg, n_long)`` for a kernel's C entry point on
    ``device``: ``(None, None, 0, 0)`` without a table; else the table
    (refused unless a contiguous int32 tensor on ``device``, naming the
    wrapper ``name``) and a new [n_seg, *width] f32 tensor for the
    segments' partials."""
    if split is None:
        return None, None, 0, 0
    _build.check(name, device, ("split", split.table, torch.int32))
    partial = torch.empty((split.n_seg, *width), dtype=torch.float32, device=device)
    return split.table, partial, split.n_seg, split.n_long
