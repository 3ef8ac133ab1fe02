"""K1: block-sparse tile stack @ dense features (the hybrid format's tile
leg, and the whole graph under ``--spmm bsr``).

Ports ``textgcn_tpu/ops/pallas_spmm.py``. The kernels are hand-written CUDA
for Hopper (``sm_90a``): ``csrc/bsr_spmm.cu`` for bf16 tiles and features
(the tensor cores), ``csrc/bsr_spmm_f32.cu`` for f32 tiles and features (K1's
f32 mode, on the tensor cores in 3xTF32). :func:`bsr_spmm` takes either pair and refuses
a mix, as the JAX package's f32 path refuses bf16 tiles.

Source note:

- Replaces the Pallas kernels ``_make_grouped_kernel`` (grouped, G tiles per
  grid step) and ``_bsr_kernel`` (flat, G=1) of
  ``textgcn_tpu/ops/pallas_spmm.py``. The port keeps only the flat layout: the
  TPU's K-packing (``pack_groups`` / ``choose_group``) exists to cut Pallas
  grid-step overhead, which a CUDA block's tile loop does not pay. As
  :func:`bsr_leg` the same kernel also replaces ``_bsr_leg_apply`` of
  ``textgcn_tpu/parallel/mesh_kernels.py`` (B10): one shard's block-rows
  against all block-columns, a rectangular matrix.
- Bound on the card: the bytes. A 32 KiB tile carries 2*128*128*F'
  flops, about 208 a byte at F'=208, below the bf16 ridge (~295): each tile
  read once (R8 doc-word: 5,925 tiles, 194 MB a pass) and its 128-row slab
  of features brought into the SM once. At F'=16 the tile bytes are nearly
  the whole cost. The degree sort makes the block-rows uneven (R8: up to
  120 tiles, mean 49), so a block that walks a whole block-row sets the
  pace of the call.
- Design against that bound: no block walks more than :data:`SEGMENT_TILES`
  (T) tiles. A block-row of more than T tiles is cut into block-row-local
  segments (boundaries at multiples of T from its first tile) listed in a
  :class:`~textgcn_tpu_torch.ops.split.TileSplit`, which :func:`tile_split`
  builds once where the tile stack is built (``BlockSparseGraph.from_coo``,
  so also the hybrid's and each shard's tiles) and which the container keeps
  (``BlockSparseGraph.split``). Each segment's block writes an f32 partial;
  a second small launch adds a long block-row's partials in segment order.
  No atomics and a fixed order: two launches give the same bits, and a
  block-row the same bits in any stack that holds it (the shards' legs put
  together equal the single-device pass). One block covers all 128 rows and
  all F' columns of its block-row, so each tile and each feature slab is
  read once; ``cp.async`` streams them into a ring of stages in shared
  memory while the tensor cores (``mma.sync``, bf16 in, f32 accumulate)
  work on the stage before. A table records the fingerprint of the
  ``tile_ptr`` it was built from, and the wrapper refuses it with another
  stack, even one with the same counts.
- What bounds it now: at F'=208 a block's tile costs ~3.8 us (the MMA and
  ``ldmatrix`` issue of 8 warps an SM), so the call is ~3.5x its byte
  bound; ``wgmma`` from shared memory is the next step (PERF.md, ROADMAP).
- The f32 mode (:func:`bsr_spmm_f32`) replaces ``_bsr_kernel`` on f32
  blocks (``spmm_bsr(bf16=False)``, the JAX package's ``--spmm bsr``, f32
  products with f32 accumulation). It runs on the tensor cores in 3xTF32
  (``wgmma``): each operand is split into a TF32 big part and a TF32
  remainder, and big*big + big*small + small*big of each 32-deep stage is
  summed from zero into a partial that an f32 add joins to the accumulator
  (the tensor cores' own accumulation truncates, which over a block-row's
  thousands of steps drifted far past plain f32 on the card). The dropped
  small*small is 2^-22 of a product, so the result stays f32-accurate; one
  TF32 product (about 3 decimal digits) would not, and is not used. Bound:
  three TF32 products at 495 TFLOP/s (0.458 ms on R8 doc-word's 11,091
  unsorted tiles at F'=208), or the tile bytes at small F' (0.218 ms at
  16). A producer warpgroup streams each tile chunk and its rows of x into
  a ring in shared memory and splits the operand the consumers read from
  there; two consumer warpgroups split theirs in registers and run the
  products. The kernel keeps K1's work items, its split table at the same
  T and its second pass (no atomics, two launches bit-equal); when a call
  has fewer work items than the card has SMs (R8 topic), each item is also
  cut into row slabs, so short stacks fill the card. Its launches count on
  :func:`bsr_spmm_f32`, whichever wrapper was called.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from textgcn_tpu_torch.ops import _build
from textgcn_tpu_torch.ops.split import TileSplit, build_split, check_split, split_args
from textgcn_tpu_torch.utils import profiling

TILE = 128
F_ALIGN = 16  # the kernel's feature width must be a multiple of this
F_MAX = 256  # the widest feature table the kernel holds in registers
# T: the most tiles one block walks; the kernel's compile-time constant
# (csrc/bsr_spmm.cu kSegTiles), which a TileSplit table must be built for
SEGMENT_TILES = 16


def tile_split(tile_ptr, device=None) -> Optional[TileSplit]:
    """The :class:`~textgcn_tpu_torch.ops.split.TileSplit` of a tile stack's
    ``tile_ptr`` (numpy or tensor) at T, on ``device`` (tile_ptr's by
    default), or None when no block-row has more than T tiles. Build it once
    with the tile stack, never per launch."""
    return build_split(tile_ptr, SEGMENT_TILES, TileSplit, device)


def bsr_spmm_plain(tiles, tile_ptr, tile_col, x, split=None):
    """Plain PyTorch version of :func:`bsr_spmm` and :func:`bsr_spmm_f32`
    (any tile shape or dtype; ``split`` is accepted and ignored).

    Multiplies each tile with its feature rows in f32 (bf16 inputs are exact
    in f32), or in f64 when the tiles or ``x`` are f64 (the f32 mode's
    oracle), and sums the products into their block-rows. The matrix may be
    rectangular: ``x`` has one 128-row block per block-column.
    """
    n_block_rows = tile_ptr.numel() - 1
    _, bm, bn = tiles.shape
    f = x.shape[1]
    dt = torch.promote_types(torch.promote_types(tiles.dtype, x.dtype), torch.float32)
    rows = torch.repeat_interleave(
        torch.arange(n_block_rows, device=x.device), torch.diff(tile_ptr.long())
    )
    xb = x.to(dt).reshape(-1, bn, f)[tile_col.long()]
    prod = torch.bmm(tiles.to(dt), xb)
    out = torch.zeros(n_block_rows, bm, f, dtype=dt, device=x.device)
    out.index_add_(0, rows, prod)
    return out.reshape(n_block_rows * bm, f)


def _check_tiles(name, tiles, tile_ptr, tile_col, x):
    """K1's own terms for its tiles and features (the seam checks devices,
    layouts and the pointers' dtype)."""
    if tiles.dtype != x.dtype or tiles.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: the CUDA kernels take bf16 tiles with bf16 features or "
            f"f32 tiles with f32 features, got {tiles.dtype} and {x.dtype}"
        )
    if tiles.dim() != 3 or tuple(tiles.shape[1:]) != (TILE, TILE):
        raise ValueError(f"{name}: tiles must be [T, {TILE}, {TILE}]")
    if tile_col.numel() != tiles.shape[0] or tile_ptr.numel() < 2:
        raise ValueError(f"{name}: tile_col must have one entry per tile")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous 2-D tensor")
    if x.shape[0] % TILE or x.shape[1] % F_ALIGN or x.shape[1] > F_MAX:
        raise ValueError(
            f"{name}: x must be [multiple of {TILE}, multiple of {F_ALIGN} up "
            f"to {F_MAX}], got {tuple(x.shape)}"
        )
    if x.data_ptr() % 16 or tiles.data_ptr() % 16:
        raise ValueError(f"{name}: tiles and x must be 16-byte aligned")


def _run(wrapper, tiles, tile_ptr, tile_col, x, split):
    """The plain version for a CPU ``x``; else K1's launches, counted on
    ``wrapper`` for bf16 tiles and on :func:`bsr_spmm_f32` for f32 tiles.
    While the span recorder is on
    (:func:`~textgcn_tpu_torch.utils.profiling.record_spans`) a launch, from
    the checks to the launch's error check, is a ``k1.launch`` span."""
    t0 = profiling.spans_on and time.time_ns()
    name = wrapper.__name__
    check_split(name, tile_ptr, tile_col.numel(), split, TileSplit, SEGMENT_TILES)
    if x.device.type == "cpu":
        return bsr_spmm_plain(tiles, tile_ptr, tile_col, x)
    _build.check(name, x.device, ("tiles", tiles, None), ("tile_ptr", tile_ptr, torch.int32),
                 ("tile_col", tile_col, torch.int32))
    _check_tiles(name, tiles, tile_ptr, tile_col, x)
    f32 = tiles.dtype == torch.float32
    n_block_rows, f = tile_ptr.numel() - 1, x.shape[1]
    out = torch.empty((n_block_rows * TILE, f), dtype=torch.float32, device=x.device)
    table, partial, n_seg, n_long = split_args(name, split, x.device, TILE, f)
    _build.launch(name, bsr_spmm_f32 if f32 else wrapper,
                  "textgcn_bsr_spmm_f32" if f32 else "textgcn_bsr_spmm", x.device,
                  tiles, tile_ptr, tile_col, x, out, table, partial, n_block_rows, f,
                  n_seg, n_long, span="k1.launch", t0=t0)
    return out


def bsr_spmm(tiles, tile_ptr, tile_col, x, split=None):
    """``out[br*128 + i] = sum_t tiles[t, i, :] @ x[tile_col[t]*128 : +128]``
    over the tiles ``t`` of block-row ``br`` (``tile_ptr`` is a CSR over the
    block-row-sorted tiles). Returns a new [n_block_rows*128, F] f32 tensor,
    zero in a block-row without tiles. The matrix may be rectangular: ``x``
    has as many rows as the matrix has columns, and every ``tile_col`` is
    below ``x.shape[0] / 128`` (``BlockSparseGraph.from_coo`` checks that
    when it builds the tiles; the kernel does not). ``split`` is the stack's
    :class:`~textgcn_tpu_torch.ops.split.TileSplit` (``BlockSparseGraph.split``,
    None when no block-row is longer than T); a table of another tile stack
    (other counts, or another ``tile_ptr`` fingerprint) is refused, with no
    device sync.

    Tiles and ``x`` are both bf16 (the tensor-core kernel) or both f32
    (K1's f32 mode, :func:`bsr_spmm_f32`); a mix is refused. On CPU tensors
    this runs :func:`bsr_spmm_plain`; on CUDA tensors it launches the kernel
    (building it on first use) or raises.
    """
    return _run(bsr_spmm, tiles, tile_ptr, tile_col, x, split)


def bsr_spmm_f32(tiles, tile_ptr, tile_col, x, split=None):
    """:func:`bsr_spmm` on f32 tiles and f32 features: K1's f32 mode (B4,
    ``textgcn_tpu/ops/pallas_spmm.py`` ``_bsr_kernel`` on f32 blocks), f32
    accurate in 3xTF32 on the tensor cores. Its launches are counted here,
    also when :func:`bsr_spmm` dispatches to it."""
    if x.device.type == "cuda" and tiles.dtype != torch.float32:
        raise TypeError(f"bsr_spmm_f32: takes f32 tiles, got {tiles.dtype}")
    return _run(bsr_spmm_f32, tiles, tile_ptr, tile_col, x, split)


def bsr_leg(tiles, tile_ptr, tile_col, x, split=None):
    """:func:`bsr_spmm` as the tile leg of one shard of the sharded hybrid
    (B10, ``textgcn_tpu/parallel/mesh_kernels.py`` ``_bsr_leg_apply``): the
    shard's block-rows against the all-gathered feature table, so the matrix
    is [rows_per_shard, n_pad]. The same kernel; its launches are counted
    here, apart from :func:`bsr_spmm`'s, so a run can show that the sharded
    path went through it.
    """
    return _run(bsr_leg, tiles, tile_ptr, tile_col, x, split)


bsr_spmm.launches = 0
bsr_spmm_f32.launches = 0
bsr_leg.launches = 0
