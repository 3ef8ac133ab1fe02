"""The benchmark's graph for TextGCN: R8's doc-word graph, read from the
committed artifact rather than drawn.

Yao, Mao & Luo (arXiv:1809.05679) build one graph over a corpus's documents
and words: TF-IDF edges from a document to its words, PMI edges between
words. ``data/graph/<dataset>_docword.txt`` holds them as "u v w" lines,
each undirected edge once, documents ``[0, D)`` then words ``[D, D + W)``
(``D`` the non-empty lines of ``data/text_dataset/<dataset>.txt``, ``W``
those of ``data/graph/<dataset>_docword_vocab.txt``). This module makes

    Â = D̃^-1/2 (max(A, Aᵀ) + I) D̃^-1/2

from it in plain numpy, the program's recipe (``normalize_edges`` of the
port: max-symmetrize, add self-loops summing into any diagonal, degrees
over the result, symmetric scaling), in float64, then

- stores each value at float32 and rounds it to bfloat16, as the port's
  graph holds it and as its tile stack stores it, so that the program and
  the reference multiply by one matrix;
- numbers the nodes in the order of the port's degree sort (degree over
  both endpoints, descending, ties by id), so that the sort the program
  applies before its hybrid layout is the identity and its dropout masks,
  drawn over its node order, fall on the reference's rows;
- hands it out as row-sorted chunks of ``rows_per_chunk`` rows, like the
  lattice's, with each chunk's shape counted from the data.

The seed changes nothing: the graph is the dataset. The graph config may
keep only the first ``docs`` documents and ``words`` words (the edges among
them, renumbered, then normalized as above): ``SMALL`` does, for the CPU
tests. Nothing of the program is imported.
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from gpubench.traffic import Chunk, ChunkShape

DATA = Path(__file__).resolve().parents[2] / "data"
# the configuration keys a CPU test puts in place (``gpubench.traffic.small``):
# 1,024 nodes of R8's graph, with dense tiles and a residual in the port's
# hybrid layout
SMALL = {"graph": {"kind": "r8docword", "dataset": "R8", "docs": 256, "words": 768,
                   "rows_per_chunk": 256},
         "edge_scale": 1.0, "val_rows": 48}


def count_lines(path: Path) -> int:
    with open(path, encoding="utf-8") as f:
        return sum(1 for line in f if line.strip())


@functools.lru_cache(maxsize=2)
def read_corpus(dataset: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]:
    """``(src, dst, w, n_docs, n_words)`` of the committed artifact."""
    edges = np.loadtxt(DATA / "graph" / f"{dataset}_docword.txt", dtype=np.float64, ndmin=2)
    n_docs = count_lines(DATA / "text_dataset" / f"{dataset}.txt")
    n_words = count_lines(DATA / "graph" / f"{dataset}_docword_vocab.txt")
    return (edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64), edges[:, 2],
            n_docs, n_words)


def subgraph(src, dst, w, n_docs: int, docs: int, words: int):
    """The edges among the first ``docs`` documents and ``words`` words,
    renumbered: documents ``[0, docs)``, words ``[docs, docs + words)``."""
    def new_id(u):
        return np.where(u < n_docs, u, u - n_docs + docs)

    def kept(u):
        return np.where(u < n_docs, u < docs, u - n_docs < words)

    keep = kept(src) & kept(dst)
    return new_id(src[keep]), new_id(dst[keep]), w[keep]


def coalesce(row, col, val, n: int, reduce):
    """Duplicate ``(row, col)`` entries merged by ``reduce`` (a ufunc),
    sorted by row then column."""
    key = row * n + col
    order = np.argsort(key, kind="stable")
    key, val = key[order], val[order]
    first = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    return key[first] // n, key[first] % n, reduce.reduceat(val, first)


def normalize(src, dst, w, n: int):
    """``D̃^-1/2 (max(A, Aᵀ) + I) D̃^-1/2`` as COO, float64."""
    r, c, v = coalesce(np.r_[src, dst], np.r_[dst, src], np.r_[w, w], n, np.maximum)
    loops = np.arange(n, dtype=np.int64)
    r, c, v = coalesce(np.r_[r, loops], np.r_[c, loops], np.r_[v, np.ones(n)], n, np.add)
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, r, v)
    with np.errstate(divide="ignore"):
        dinv = np.power(deg, -0.5)
    dinv[~np.isfinite(dinv)] = 0.0
    return r, c, v * dinv[r] * dinv[c]


def degree_order(row, col, n: int) -> np.ndarray:
    """``perm[old] = new``: degree over both endpoints, descending, ties by
    old id (the port's degree sort)."""
    deg = np.bincount(row, minlength=n) + np.bincount(col, minlength=n)
    perm = np.empty(n, dtype=np.int64)
    perm[np.argsort(-deg, kind="stable")] = np.arange(n, dtype=np.int64)
    return perm


def as_bf16(v: np.ndarray) -> np.ndarray:
    """float64 values stored at float32, then rounded to bfloat16, held in
    float32."""
    t = torch.from_numpy(v.astype(np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


@dataclasses.dataclass(frozen=True)
class DocWordGraph:
    """Â as one row-sorted CSR on the host, handed out in chunks of
    ``rows_per_chunk`` rows on ``device``."""

    row_ptr: np.ndarray  # [n + 1] int64
    col: np.ndarray  # [E] int32
    val: np.ndarray  # [E] float32, bf16-exact
    rows_per_chunk: int
    n_docs: int
    device: torch.device

    @property
    def n_rows(self) -> int:
        return self.row_ptr.size - 1

    @property
    def n_edges(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def n_chunks(self) -> int:
        return -(-self.n_rows // self.rows_per_chunk)

    def _rows(self, j: int) -> Tuple[int, int]:
        r0 = j * self.rows_per_chunk
        return r0, min(r0 + self.rows_per_chunk, self.n_rows)

    def chunk(self, j: int) -> Chunk:
        r0, r1 = self._rows(j)
        a, b = int(self.row_ptr[r0]), int(self.row_ptr[r1])
        ptr = (self.row_ptr[r0:r1 + 1] - a).astype(np.int32)
        return Chunk(torch.from_numpy(ptr).to(self.device),
                     torch.from_numpy(self.col[a:b].copy()).to(self.device),
                     torch.from_numpy(self.val[a:b].copy()).to(self.device), r0)

    def chunk_shape(self, j: int) -> ChunkShape:
        r0, r1 = self._rows(j)
        a, b = int(self.row_ptr[r0]), int(self.row_ptr[r1])
        return ChunkShape(r1 - r0, b - a, float(np.unique(self.col[a:b]).size))


def build(dataset: str, rows_per_chunk: int, docs: Optional[int] = None,
          words: Optional[int] = None, device="cpu") -> DocWordGraph:
    src, dst, w, n_docs, n_words = read_corpus(dataset)
    docs = n_docs if docs is None else docs
    words = n_words if words is None else words
    if (docs, words) != (n_docs, n_words):
        src, dst, w = subgraph(src, dst, w, n_docs, docs, words)
    n = docs + words
    r, c, v = normalize(src, dst, w, n)
    perm = degree_order(r, c, n)
    r, c = perm[r], perm[c]
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], as_bf16(v[order])
    row_ptr = np.searchsorted(r, np.arange(n + 1))
    return DocWordGraph(row_ptr, c.astype(np.int32), v, int(rows_per_chunk), docs,
                        torch.device(device))


def make(graph_cfg: dict, seed: int, device) -> DocWordGraph:
    """The graph of ``graph_cfg``; ``seed`` is not read."""
    return build(graph_cfg["dataset"], graph_cfg["rows_per_chunk"], graph_cfg.get("docs"),
                 graph_cfg.get("words"), device)
