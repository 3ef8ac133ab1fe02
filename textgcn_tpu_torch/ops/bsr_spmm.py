"""K1: block-sparse tile stack @ dense features (the hybrid format's tile leg).

Ports ``textgcn_tpu/ops/pallas_spmm.py``. The kernel is
``csrc/bsr_spmm.cu``, a hand-written CUDA kernel for Hopper (``sm_90a``).

Source note:

- Replaces the Pallas kernels ``_make_grouped_kernel`` (grouped, G tiles per
  grid step) and ``_bsr_kernel`` (flat, G=1) of
  ``textgcn_tpu/ops/pallas_spmm.py``. The port keeps only the flat layout: the
  TPU's K-packing (``pack_groups`` / ``choose_group``) exists to cut Pallas
  grid-step overhead, which a CUDA block's tile loop does not pay. As
  :func:`bsr_leg` the same kernel also replaces ``_bsr_leg_apply`` of
  ``textgcn_tpu/parallel/mesh_kernels.py`` (B10): one shard's block-rows
  against all block-columns, a rectangular matrix.
- Bound on the card: at F=8 the tile bytes (on R8 doc-word ~6k tiles,
  194 MB per pass) and the serial walk over the hub block-rows; at F=200
  each 32 KiB tile carries 2*128*128*208 flops, about 208 flops per byte,
  near the card's bf16 ridge (~295), so the tensor cores and the bytes moved
  into the SMs both count.
- Design against that bound: one block per (half block-row, 64-column
  feature chunk) owns its output rows and loops over its block-row's tiles
  (no atomics, one write of the output); a tile's loads go out together as
  16-byte vectors and the next tile's are in flight during the current
  tile's MMAs (WMMA fragments, f32 accumulation). Up to 8 blocks share a
  block-row, so the hub block-rows of a degree-sorted graph (several times
  the mean tile count) spread over several SMs; the chunks of a block-row
  are grid neighbours and read each tile close together, mostly from L2.
  Splitting long block-rows with a deterministic second-pass reduction is
  left to a later change (see PERF.md).
"""
from __future__ import annotations

import torch

from textgcn_tpu_torch.ops import _build

TILE = 128
F_ALIGN = 16  # the kernel's feature width must be a multiple of this


def bsr_spmm_plain(tiles, tile_ptr, tile_col, x):
    """Plain PyTorch version of :func:`bsr_spmm` (any tile shape or dtype).

    Multiplies each tile with its feature rows in f32 (bf16 inputs are exact
    in f32) and sums the products into their block-rows. The matrix may be
    rectangular: ``x`` has one 128-row block per block-column.
    """
    n_block_rows = tile_ptr.numel() - 1
    _, bm, bn = tiles.shape
    f = x.shape[1]
    rows = torch.repeat_interleave(
        torch.arange(n_block_rows, device=x.device), torch.diff(tile_ptr.long())
    )
    xb = x.float().reshape(-1, bn, f)[tile_col.long()]
    prod = torch.bmm(tiles.float(), xb)
    out = torch.zeros(n_block_rows, bm, f, dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, prod)
    return out.reshape(n_block_rows * bm, f)


def _check(name, tiles, tile_ptr, tile_col, x):
    dev = x.device
    for key, t in (("tiles", tiles), ("tile_ptr", tile_ptr), ("tile_col", tile_col)):
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if tiles.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(
            f"{name}: the CUDA kernel takes bf16 tiles and bf16 features "
            f"(got {tiles.dtype} and {x.dtype}); build the graph with "
            "store_bf16=True"
        )
    if tile_ptr.dtype != torch.int32 or tile_col.dtype != torch.int32:
        raise TypeError(f"{name}: tile_ptr and tile_col must be int32")
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (TILE, TILE):
        raise ValueError(f"{name}: tiles must be [T, {TILE}, {TILE}]")
    if tile_col.numel() != tiles.shape[0] or tile_ptr.numel() < 2:
        raise ValueError(f"{name}: tile_col must have one entry per tile")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D tensor")
    if x.shape[0] % TILE or x.shape[1] % F_ALIGN:
        raise ValueError(
            f"{name}: x must be [multiple of {TILE}, multiple of {F_ALIGN}], "
            f"got {tuple(x.shape)}"
        )


def _run(wrapper, tiles, tile_ptr, tile_col, x):
    """The plain version for a CPU ``x``; else K1's launch, counted on
    ``wrapper``."""
    name = wrapper.__name__
    if x.device.type == "cpu":
        return bsr_spmm_plain(tiles, tile_ptr, tile_col, x)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    _check(name, tiles, tile_ptr, tile_col, x)
    n_block_rows = tile_ptr.numel() - 1
    out = torch.empty(
        (n_block_rows * TILE, x.shape[1]), dtype=torch.float32, device=x.device
    )
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.textgcn_bsr_spmm(
            tiles.data_ptr(), tile_ptr.data_ptr(), tile_col.data_ptr(),
            x.data_ptr(), out.data_ptr(), n_block_rows, x.shape[1],
            torch.cuda.current_stream().cuda_stream,
        )
    wrapper.launches += 1
    _build.check_launch(name, err)
    return out


def bsr_spmm(tiles, tile_ptr, tile_col, x):
    """``out[br*128 + i] = sum_t tiles[t, i, :] @ x[tile_col[t]*128 : +128]``
    over the tiles ``t`` of block-row ``br`` (``tile_ptr`` is a CSR over the
    block-row-sorted tiles). Returns a new [n_block_rows*128, F] f32 tensor,
    zero in a block-row without tiles. The matrix may be rectangular: ``x``
    has as many rows as the matrix has columns, and every ``tile_col`` is
    below ``x.shape[0] / 128`` (``BlockSparseGraph.from_coo`` checks that
    when it builds the tiles; the kernel does not).

    On CPU tensors this runs :func:`bsr_spmm_plain`; on CUDA tensors it
    launches the kernel (building it on first use) or raises.
    """
    return _run(bsr_spmm, tiles, tile_ptr, tile_col, x)


def bsr_leg(tiles, tile_ptr, tile_col, x):
    """:func:`bsr_spmm` as the tile leg of one shard of the sharded hybrid
    (B10, ``textgcn_tpu/parallel/mesh_kernels.py`` ``_bsr_leg_apply``): the
    shard's block-rows against the all-gathered feature table, so the matrix
    is [rows_per_shard, n_pad]. The same kernel; its launches are counted
    here, apart from :func:`bsr_spmm`'s, so a run can show that the sharded
    path went through it.
    """
    return _run(bsr_leg, tiles, tile_ptr, tile_col, x)


bsr_spmm.launches = 0
bsr_leg.launches = 0
