"""The benchmark's graph: the symmetric window lattice, generated on the card.

A frozen copy of ``lattice_config``, ``_pairing`` and ``make_lattice_stream``
of ``textgcn_tpu_torch/ops/streamed_sorted.py`` at commit
c34b5f480ed41e230787aec2c36eb63c346c232d, in plain torch and numpy: the
same draws give the same chunks, bit for bit. It lives here so that the
yardstick cannot move with the program. Three things differ from the
original: a chunk is a plain :class:`Chunk` of tensors (the program's
runner wraps it in the program's own type), the lattice states its chunks'
shape (``chunk_shape``, for the yardstick) and is made through ``make``
like any generator of ``gpubench/traffic/``, and nothing of the program is
imported.

The graph has ``n_chunks`` row blocks of ``G = w_sc * w`` rows. A seeded
involution pairs the blocks. Block pair (a, b) carries a [w_sc, w_sc,
cell_e] lattice of edge cells drawn from a generator seeded by (seed,
min(a, b), max(a, b)), so both partners draw the same: cell (u, v) holds
``cell_e`` edges from rows of a's window u to columns of b's window v, at
uniform local positions, with values uniform in [0, 1). The lower-numbered
block emits the lattice as drawn and its partner emits the transpose; a
self-paired block symmetrises its own lattice in place. So the matrix is
exactly symmetric. Each chunk is row-sorted (a stable sort on the local
row) into a CSR over its G rows.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from gpubench.traffic import Chunk, ChunkShape

# the configuration keys a CPU test puts in place (``gpubench.traffic.small``):
# 16 chunks of 128 rows, degree 16, row sums ~1/2
SMALL = {"graph": {"kind": "lattice", "n_nodes": 2048, "degree": 16, "w": 32, "w_sc": 4},
         "edge_scale": 1 / 16}


def lattice_config(n: int, deg: int, w: int = 512, w_sc: int = 32) -> Tuple[int, int, int, int]:
    """``(n_chunks, w_sc, w, cell_e)`` of the lattice for an ~n-node,
    ~deg-degree graph (``benchmarks/synthetic_large.py``'s dims). Rows per
    chunk ``w_sc * w``; mean degree ``w_sc * cell_e / w``."""
    g_rows = w_sc * w
    n_chunks = max(1, round(n / g_rows))
    cell_e = max(2, (deg * w) // w_sc // 2 * 2)
    return n_chunks, w_sc, w, cell_e


def _pairing(n_chunks: int, seed: int) -> np.ndarray:
    """A seeded involution over the chunks: consecutive entries of a random
    permutation pair up; with an odd count the last one pairs with itself."""
    perm = np.random.default_rng(seed).permutation(n_chunks)
    invol = np.empty(n_chunks, dtype=np.int64)
    for i in range(0, n_chunks - 1, 2):
        invol[perm[i]] = perm[i + 1]
        invol[perm[i + 1]] = perm[i]
    if n_chunks % 2:
        invol[perm[-1]] = perm[-1]
    return invol


@dataclasses.dataclass(frozen=True)
class Lattice:
    """The lattice as a re-iterable source of :class:`Chunk`; each chunk is
    generated on ``device`` when it is asked for."""

    n_chunks: int
    w_sc: int
    w: int
    cell_e: int
    seed: int
    device: torch.device
    partner: np.ndarray  # [n_chunks] the involution

    @property
    def rows_per_chunk(self) -> int:
        return self.w_sc * self.w

    @property
    def n_rows(self) -> int:
        return self.n_chunks * self.rows_per_chunk

    @property
    def chunk_edges(self) -> int:
        return self.w_sc * self.w_sc * self.cell_e

    @property
    def n_edges(self) -> int:
        return self.n_chunks * self.chunk_edges

    def gathered_rows(self) -> float:
        """Distinct columns one chunk gathers: each of its ``w_sc`` column
        windows takes ``w_sc * cell_e`` columns uniformly from ``w`` rows,
        so it reads ``w (1 - (1 - 1/w)^(w_sc cell_e))`` of them."""
        per_window = self.w * (1.0 - (1.0 - 1.0 / self.w) ** (self.w_sc * self.cell_e))
        return self.w_sc * per_window

    def chunk_shape(self, j: int) -> ChunkShape:
        """Every chunk has the same shape."""
        return ChunkShape(self.rows_per_chunk, self.chunk_edges, self.gathered_rows())

    def __len__(self) -> int:
        return self.n_chunks

    def __iter__(self):
        for j in range(self.n_chunks):
            yield self.chunk(j)

    def _cells(self, a: int, b: int):
        """The [w_sc, w_sc, cell_e] lattice of block pair {a, b}: local rows,
        local cols, values; both blocks of the pair draw the same."""
        key = np.random.SeedSequence([self.seed, min(a, b), max(a, b)]).generate_state(1)[0]
        gen = torch.Generator(device=self.device).manual_seed(int(key))
        shape = (self.w_sc, self.w_sc, self.cell_e)
        kw = dict(generator=gen, device=self.device)
        lrow = torch.randint(0, self.w, shape, dtype=torch.int32, **kw)
        lcol = torch.randint(0, self.w, shape, dtype=torch.int32, **kw)
        val = torch.rand(shape, dtype=torch.float32, **kw)
        return lrow, lcol, val

    def chunk(self, j: int) -> Chunk:
        """Chunk ``j``: rows ``[j*G, (j+1)*G)``, row-sorted."""
        pj = int(self.partner[j])
        lrow, lcol, val = self._cells(j, pj)
        # the mirror of cell (v, u) placed at (u, v): rows <-> cols
        m_lrow, m_lcol, m_val = (t.transpose(0, 1) for t in (lcol, lrow, val))
        if pj == j:
            # self pair: upper cells as drawn, lower cells mirrored, diagonal
            # cells half drawn and half mirrored
            u = torch.arange(self.w_sc, device=self.device)
            upper = (u[:, None] < u[None, :])[:, :, None]
            lower = (u[:, None] > u[None, :])[:, :, None]
            half = self.cell_e // 2

            def sym(drawn, mirror, d_lo, d_hi):
                diag = torch.cat([d_lo[..., :half], d_hi[..., :half]], dim=-1)
                return torch.where(upper, drawn, torch.where(lower, mirror, diag))

            o_lrow = sym(lrow, m_lrow, lrow, lcol)
            o_lcol = sym(lcol, m_lcol, lcol, lrow)
            o_val = sym(val, m_val, val, val)
        elif j > pj:
            # the higher-numbered block of a pair emits the transpose
            o_lrow, o_lcol, o_val = m_lrow, m_lcol, m_val
        else:
            o_lrow, o_lcol, o_val = lrow, lcol, val
        win = torch.arange(self.w_sc, device=self.device, dtype=torch.int32)
        g_rows = self.rows_per_chunk
        local_row = (o_lrow + win[:, None, None] * self.w).reshape(-1)
        col = (o_lcol + win[None, :, None] * self.w + pj * g_rows).reshape(-1)
        order = torch.sort(local_row, stable=True).indices
        counts = torch.bincount(local_row, minlength=g_rows)
        row_ptr = torch.zeros(g_rows + 1, dtype=torch.int32, device=self.device)
        row_ptr[1:] = torch.cumsum(counts, 0)
        return Chunk(row_ptr, col[order], o_val.reshape(-1)[order], j * g_rows)


def make_lattice(n: int, deg: int, seed: int, *, device, w: int = 512, w_sc: int = 32) -> Lattice:
    """The lattice of :func:`lattice_config` ``(n, deg, w, w_sc)`` drawn from
    ``seed`` (any non-negative integer) on ``device``."""
    n_chunks, w_sc, w, cell_e = lattice_config(n, deg, w, w_sc)
    if cell_e % 2:
        raise ValueError("cell_e must be even")
    return Lattice(n_chunks, w_sc, w, cell_e, int(seed), torch.device(device),
                   _pairing(n_chunks, int(seed)))


def make(graph_cfg: dict, seed: int, device) -> Lattice:
    """The generator's entry (``gpubench.traffic.make``): ``graph_cfg``
    holds ``n_nodes``, ``degree``, ``w`` and ``w_sc``."""
    g = graph_cfg
    return make_lattice(g["n_nodes"], g["degree"], seed, device=device, w=g["w"], w_sc=g["w_sc"])
