"""The yardstick: the card's peaks, and the bytes and operations that a step
and its kernels need, counted from the cell's shapes.

Counts never come from what a kernel does: each input is read once and
each output written once, at the dtypes the configuration states, so the
same work reads the same whatever implements it. A time bound is the larger
of the bytes over the memory rate and the operations over the peak of the
unit that does them.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

HBM_BYTES_PER_S = 3.35e12
PEAK_F32 = 67e12  # FP32 outside the tensor cores
PEAK_BF16 = 989e12  # tensor cores; bf16 x bf16 products are exact in f32

# the host link of the SXM part: PCIe Gen5 x16, 128 GB/s in both directions
PCIE_BYTES_PER_S = 64e9

I32, F32, BF16, I64 = 4, 4, 2, 8


@dataclasses.dataclass(frozen=True)
class Op:
    """One piece of work: ``n_bytes`` moved, ``n_ops`` done at ``peak``."""

    name: str
    n_bytes: float
    n_ops: float
    peak: float = PEAK_F32

    @property
    def seconds(self) -> float:
        return max(self.n_bytes / HBM_BYTES_PER_S, self.n_ops / self.peak)


def seconds(ops: Iterable[Op]) -> float:
    """The least time a list of work takes, one piece after another."""
    return sum(op.seconds for op in ops)


def chunk_bytes(shape) -> int:
    """Bytes of one chunk's CSR (a :class:`gpubench.traffic.ChunkShape`):
    ``row_ptr`` [G + 1] int32, ``col`` int32 and ``val`` f32 per edge."""
    return (shape.rows + 1) * I32 + shape.edges * (I32 + F32)


def chunks_bytes(graph, idx: Iterable[int]) -> int:
    """Bytes of the CSRs of ``graph``'s chunks ``idx``."""
    return sum(chunk_bytes(graph.chunk_shape(j)) for j in idx)


def k2_chunk(shape, width: int, base: bool = True) -> Op:
    """K2 on one chunk at ``width`` columns: the chunk once, the distinct
    bf16 rows of ``x`` it gathers, the f32 output rows written (and read
    first, with a base); ``2 E F`` operations at the f32 peak."""
    n_bytes = (chunk_bytes(shape) + shape.gathered * width * BF16
               + (2 if base else 1) * shape.rows * width * F32)
    return Op("k2", n_bytes, 2.0 * shape.edges * width, PEAK_F32)


def k2_pass(graph, width: int, base: bool = False) -> Op:
    """One streamed pass (every chunk once) at ``width`` columns, onto an
    accumulator that starts at zero: each chunk covers its own rows once,
    so no base is read."""
    ops = [k2_chunk(graph.chunk_shape(j), width, base) for j in range(graph.n_chunks)]
    return Op(f"pass F={width}", sum(op.n_bytes for op in ops), sum(op.n_ops for op in ops),
              PEAK_F32)


def k2_pass_seconds(graph, width: int) -> float:
    """K2's bound over one pass, chunk by chunk (each chunk's bytes or
    operations, the larger), with no base read: the same count as
    :func:`k2_pass` in a step's work."""
    return sum(k2_chunk(graph.chunk_shape(j), width, base=False).seconds
               for j in range(graph.n_chunks))


def device_chunks(graph, device_share: float) -> int:
    """The chunks a cell keeps on the card: ``floor(share * n_chunks)``."""
    return int(math.floor(device_share * graph.n_chunks))


def host_feed(graph, device_share: float, passes: int) -> Op:
    """The chunks that live on the host, copied in on each of ``passes``
    passes over the host link."""
    fed = range(device_chunks(graph, device_share), graph.n_chunks)
    return Op("host feed", passes * chunks_bytes(graph, fed), 0.0, PEAK_F32)


def least_step_seconds(device_ops: Iterable[Op], feed: Op) -> float:
    """The least time of a step whose device work is ``device_ops`` and
    whose chunks from the host are ``feed``: the two can overlap, so the
    larger of the two."""
    return max(seconds(device_ops), feed.n_bytes / PCIE_BYTES_PER_S)


def matmul(name: str, rows: int, k: int, n: int, in_bytes: float, out_bytes: float,
           peak: float) -> Op:
    """A [rows, k] x [k, n] product whose operands and result move
    ``in_bytes`` and ``out_bytes`` (the small weight is not counted)."""
    return Op(name, in_bytes + out_bytes, 2.0 * rows * k * n, peak)


def elementwise(name: str, n_bytes: float, n_ops: float = 0.0) -> Op:
    return Op(name, n_bytes, n_ops, PEAK_F32)
