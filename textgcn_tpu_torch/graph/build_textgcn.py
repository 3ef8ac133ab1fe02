"""Classic TextGCN document–word graph construction (Yao et al. 2019).

Port of ``textgcn_tpu/graph/build_textgcn.py`` (host work: Python, numpy and
scipy; it needs no device):

- nodes: documents ``[0, D)``, words ``[D, D+W)`` (the sorted set of the
  corpus's tokens);
- doc→word edges weighted TF-IDF (tf = raw count, idf = log(D / df));
- word–word edges weighted positive PMI over sliding windows of width 20:
  the co-occurrence counts come from the native graph core's window counter
  (:mod:`textgcn_tpu_torch.native`) when a C++ compiler exists, as in the JAX
  package, else from the sparse product ``Mᵀ M`` of the binary window-word
  incidence matrix (its scipy path). Both give the same pairs and weights;
  the native pairs come in (i, j) order, the scipy ones in the product's;
- artifacts: ``{ds}_docword.txt`` ("u v w" lines) and
  ``{ds}_docword_vocab.txt`` (one word a line).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp

from textgcn_tpu_torch import native
from textgcn_tpu_torch.graph.build_topic import write_weighted_edgelist
from textgcn_tpu_torch.topics.model import load_documents_from_file


@dataclass
class DocWordGraph:
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_docs: int
    num_words: int
    vocab: List[str]
    n_doc_word_edges: int
    n_word_word_edges: int

    @property
    def n_nodes(self) -> int:
        return self.num_docs + self.num_words


def build_vocab(documents: Sequence[str]) -> List[str]:
    seen = set()
    for doc in documents:
        seen.update(doc.split())
    return sorted(seen)


def doc_word_tfidf(
    documents: Sequence[str], vocab: List[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """TF-IDF COO triplets (doc_idx, word_idx, tfidf)."""
    w2i = {w: i for i, w in enumerate(vocab)}
    rows, cols, counts = [], [], []
    for d, doc in enumerate(documents):
        local = {}
        for w in doc.split():
            i = w2i.get(w)
            if i is not None:
                local[i] = local.get(i, 0) + 1
        rows.extend([d] * len(local))
        cols.extend(local.keys())
        counts.extend(local.values())
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.float64)
    df = np.bincount(cols, minlength=len(vocab)).astype(np.float64)
    idf = np.log(len(documents) / np.maximum(df, 1.0))
    return rows, cols, counts * idf[cols]


def window_word_incidence(
    documents: Sequence[str], vocab: List[str], window_size: int = 20
) -> sp.csr_matrix:
    """Binary [n_windows, V] incidence: word appears in a sliding window (a
    document no longer than the window is one window)."""
    w2i = {w: i for i, w in enumerate(vocab)}
    indptr = [0]
    indices: List[int] = []
    for doc in documents:
        ids = [w2i[w] for w in doc.split() if w in w2i]
        if len(ids) <= window_size:
            windows = [ids] if ids else []
        else:
            windows = [ids[j : j + window_size] for j in range(len(ids) - window_size + 1)]
        for win in windows:
            indices.extend(sorted(set(win)))
            indptr.append(len(indices))
    data = np.ones(len(indices), dtype=np.float64)
    return sp.csr_matrix(
        (data, np.asarray(indices, dtype=np.int64), np.asarray(indptr, dtype=np.int64)),
        shape=(len(indptr) - 1, len(vocab)),
    )


def word_word_pmi(
    documents: Sequence[str], vocab: List[str], window_size: int = 20
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Positive-PMI word pairs (i < j): log(p_ij / (p_i p_j)) > 0."""
    if native.available():
        native.log_path("word_word_pmi", True)
        w2i = {w: i for i, w in enumerate(vocab)}
        tokens: List[int] = []
        offsets = [0]
        for doc in documents:
            tokens.extend(w2i[w] for w in doc.split() if w in w2i)
            offsets.append(len(tokens))
        i, j, cij, occ, n_windows = native.window_cooccurrence(
            np.asarray(tokens, dtype=np.int32), np.asarray(offsets, dtype=np.int64),
            len(vocab), window_size,
        )
        occ = occ.astype(np.float64)
    else:
        native.log_path("word_word_pmi", False)
        inc = window_word_incidence(documents, vocab, window_size)
        n_windows = inc.shape[0]
        occ = np.asarray(inc.sum(axis=0)).ravel()  # windows holding word i
        co = (inc.T @ inc).tocoo()  # co-occurrence counts (diagonal included)
        mask = co.row < co.col
        i, j, cij = co.row[mask], co.col[mask], co.data[mask]
    if n_windows == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0)
    pmi = np.log(cij * n_windows / (occ[i] * occ[j]))
    keep = pmi > 0
    return i[keep].astype(np.int64), j[keep].astype(np.int64), pmi[keep]


class TextGCNGraphBuilder:
    """Builds the doc-word graph of identity-feature TextGCN."""

    def __init__(
        self,
        dataset: str,
        window_size: int = 20,
        data_root: str = "data",
        verbose: bool = True,
    ):
        self.dataset = dataset
        self.window_size = window_size
        self.data_root = data_root
        self.verbose = verbose
        self.graph: Optional[DocWordGraph] = None

    def build(self, documents: Optional[Sequence[str]] = None) -> DocWordGraph:
        if documents is None:
            documents = load_documents_from_file(
                os.path.join(self.data_root, "text_dataset", "clean_corpus", f"{self.dataset}.txt")
            )
        vocab = build_vocab(documents)
        num_docs = len(documents)
        dr, dc, dw = doc_word_tfidf(documents, vocab)
        wi, wj, ww = word_word_pmi(documents, vocab, self.window_size)
        if self.verbose:
            print(f"vocab: {len(vocab)}")
            print(f"doc-word edges: {len(dr)}")
            print(f"word-word edges: {len(wi)}")
        self.graph = DocWordGraph(
            src=np.concatenate([dr, num_docs + wi]),
            dst=np.concatenate([num_docs + dc, num_docs + wj]),
            weight=np.concatenate([dw, ww]),
            num_docs=num_docs,
            num_words=len(vocab),
            vocab=vocab,
            n_doc_word_edges=len(dr),
            n_word_word_edges=len(wi),
        )
        return self.graph

    def save(self, out_dir: Optional[str] = None) -> None:
        if self.graph is None:
            raise ValueError("build() first")
        out_dir = out_dir or os.path.join(self.data_root, "graph")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.dataset}_docword.txt")
        write_weighted_edgelist(self.graph, path)
        with open(os.path.join(out_dir, f"{self.dataset}_docword_vocab.txt"), "w",
                  encoding="utf-8") as f:
            f.write("\n".join(self.graph.vocab) + "\n")
        if self.verbose:
            print(f"saved {path}")
