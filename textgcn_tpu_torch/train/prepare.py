"""Prepared training data: graph artifact → tensors on a device.

Port of ``textgcn_tpu/train/prepare.py`` (``PreparedData``,
``load_graph_edges``, ``prepare_docword_data``, ``prepare_topic_data``,
``normalize_rows_l2``, ``build_topic_features``, ``apply_spmm_format``,
``apply_attention_format``, ``apply_dense_attention_format``,
``permute_rows_1d_docs``): read the weighted edgelist, max-symmetrize
(A := max(A, Aᵀ)), sym-normalize with self-loops (:func:`normalize_edges`:
the native graph core where a C++ compiler exists), pack into a
:class:`SparseGraph`, and read labels and splits. The topic graph's node
features come from the build stage's topic model: document rows are theta
(the cached one, or the LDA E-step's on the caller's device), topic rows the
topic embeddings, L2-normalized row by row. The feature code is the JAX
package's numpy code, so the same theta gives the same bits.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from textgcn_tpu_torch import native
from textgcn_tpu_torch.graph.build_topic import read_weighted_edgelist
from textgcn_tpu_torch.graph.format import convert_graph, permute_rows
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.reorder import degree_sort_permutation
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models.gat import DenseAttentionGraph
from textgcn_tpu_torch.ops.attention import AttentionGraph
from textgcn_tpu_torch.text.datasets import DatasetLabels, load_labels
from textgcn_tpu_torch.topics.model import TopicModel, load_documents_from_file


@dataclasses.dataclass
class PreparedData:
    graph: object  # SparseGraph or any spmm-dispatchable container
    features: Optional[np.ndarray]  # [N, F] float32 dense; None = identity
    labels: DatasetLabels
    n_feat: int
    num_docs: int
    num_topics: int
    # node relabeling applied by apply_spmm_format (perm[old] = new); None
    # while node ids are the artifact's own
    perm: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.graph.n_nodes


def apply_spmm_format(pre: PreparedData, fmt: str = "auto") -> PreparedData:
    """Convert ``pre.graph`` to the requested SpMM format
    (:func:`textgcn_tpu_torch.graph.format.convert_graph`: ``segment``,
    ``dense``, ``bsr``, ``onehot``, ``hybrid``, or ``auto`` priced by the
    H100 cost model).

    Only ``hybrid``, or an ``auto`` that picks it, relabels nodes (degree
    sort); features, labels and split indices are permuted with it, so
    training is unchanged: ``P Â Pᵀ (P x) = P (Â x)``. No-op when the graph
    is already converted.
    """
    if not isinstance(pre.graph, SparseGraph) or fmt == "segment":
        return pre
    graph, perm = convert_graph(pre.graph, fmt, symmetric=True)
    return _relabeled(pre, graph, perm)


def apply_attention_format(pre: PreparedData, degree_sort: bool = False) -> PreparedData:
    """Convert ``pre.graph`` to the attention-kernel layout
    (:class:`textgcn_tpu_torch.ops.attention.AttentionGraph`) that GAT's
    kernels run on.

    ``degree_sort=True`` (the ``--spmm hybrid`` spelling) first applies the
    degree-sort relabeling of the hybrid format, with features, labels and
    split indices permuted alike. No-op when the graph is already converted.
    """
    if not isinstance(pre.graph, SparseGraph):
        return pre
    g = pre.graph
    row, col, val = g.coo_numpy()
    perm = None
    if degree_sort:
        perm = degree_sort_permutation(row, col, g.n_nodes)
        row, col = perm[row], perm[col]
    ag = AttentionGraph.from_coo(row, col, val, g.n_nodes, device=g.val.device)
    return _relabeled(pre, ag, perm)


def apply_dense_attention_format(pre: PreparedData) -> PreparedData:
    """Convert ``pre.graph`` to the dense bf16 log-adjacency
    (:class:`textgcn_tpu_torch.models.gat.DenseAttentionGraph`), GAT's
    layout for small graphs. No-op when the graph is already converted."""
    if not isinstance(pre.graph, SparseGraph):
        return pre
    return dataclasses.replace(
        pre, graph=DenseAttentionGraph.from_sparse_graph(pre.graph)
    )


def _relabeled(pre: PreparedData, graph, perm: Optional[np.ndarray]) -> PreparedData:
    """``pre`` with ``graph``, and with features, labels and split indices
    relabeled by ``perm`` (``perm[old] = new``) unless it is None."""
    if perm is None:
        return dataclasses.replace(pre, graph=graph)
    labels = pre.labels
    new_labels = dataclasses.replace(
        labels,
        target=permute_rows_1d_docs(labels.target, perm),
        train_idx=perm[labels.train_idx],
        test_idx=perm[labels.test_idx],
    )
    features = None if pre.features is None else permute_rows(pre.features, perm)
    return dataclasses.replace(
        pre, graph=graph, features=features, labels=new_labels, perm=perm
    )


def permute_rows_1d_docs(target: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Relabel per-doc labels to permuted node ids.

    Doc ``d`` sits at node ``perm[d]`` after the permutation, anywhere in
    [0, N), so the target vector grows to N entries; non-doc nodes get label
    0 (the train and test indices only point at doc nodes).
    """
    n = len(perm)
    out = np.zeros((n,), dtype=np.asarray(target).dtype)
    out[perm[: len(target)]] = target
    return out


def normalize_edges(src, dst, w, n_nodes: int):
    """An edgelist's COO → the COO of D̃^{-1/2} (max(A, Aᵀ) + I) D̃^{-1/2}: in
    the native graph core when a C++ compiler exists (as the JAX package
    does), else in numpy. The native core appends missing self-loops after
    the edges and sums the degrees in that order, so its float64 values can
    differ from numpy's in the last bit; once :meth:`SparseGraph.from_coo`
    sorts them and casts them to float32, the graphs are the same."""
    if native.available():
        native.log_path("normalize_edges", True)
        r, c, v = native.coalesce(src, dst, w, n_nodes, reduce="max", symmetrize=True)
        return native.sym_normalize(r, c, v, n_nodes)
    native.log_path("normalize_edges", False)
    r, c, v = max_symmetrize_coo(src, dst, w, n_nodes)
    return sym_normalize_coo(r, c, v, n_nodes)


def load_graph_edges(
    edgelist_path: str, n_nodes: int, pad_to_multiple: int = 4096, *, device
) -> SparseGraph:
    """Edgelist → max-symmetrized, normalized SparseGraph on ``device``."""
    src, dst, w = read_weighted_edgelist(edgelist_path)
    r, c, v = normalize_edges(src, dst, w, n_nodes)
    return SparseGraph.from_coo(
        r, c, v, n_nodes, pad_to_multiple=pad_to_multiple, device=device
    )


def prepare_docword_data(
    dataset: str,
    data_root: str = "data",
    graph_dir: Optional[str] = None,
    *,
    device,
) -> PreparedData:
    """Classic TextGCN doc-word graph → identity-feature training inputs.

    Features are the identity (X = I_N, never built: ``gcn_forward(x=None)``);
    nodes are docs [0, D) then words [D, D+W).
    """
    graph_dir = graph_dir or os.path.join(data_root, "graph")
    base = os.path.join(graph_dir, f"{dataset}_docword")
    labels = load_labels(os.path.join(data_root, "text_dataset", f"{dataset}.txt"))
    with open(base + "_vocab.txt", encoding="utf-8") as f:
        n_words = sum(1 for line in f if line.strip())
    n_nodes = labels.n_docs + n_words
    graph = load_graph_edges(base + ".txt", n_nodes, device=device)
    return PreparedData(
        graph=graph,
        features=None,
        labels=labels,
        n_feat=n_nodes,
        num_docs=labels.n_docs,
        num_topics=0,
    )


def normalize_rows_l2(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.maximum(norms, 1e-12)


def build_topic_features(
    doc_topic_dist: np.ndarray, topic_embeddings: np.ndarray
) -> np.ndarray:
    """Doc rows = theta (sum-normalized); topic rows = embeddings; pad to
    max(K, E); L2-normalize rows."""
    num_docs, num_topics = doc_topic_dist.shape
    emb_dim = topic_embeddings.shape[1]
    n_feat = max(num_topics, emb_dim)
    feats = np.zeros((num_docs + num_topics, n_feat), dtype=np.float32)
    theta = doc_topic_dist / (doc_topic_dist.sum(axis=1, keepdims=True) + 1e-8)
    feats[:num_docs, :num_topics] = theta
    feats[num_docs:, : min(emb_dim, n_feat)] = topic_embeddings[:, : min(emb_dim, n_feat)]
    return normalize_rows_l2(feats).astype(np.float32)


def cached_theta(base: str, n_docs: int, n_topics: int) -> Optional[np.ndarray]:
    """The build stage's theta cache ``{base}_theta.npy`` if it is not older
    than the model pickle ``{base}_model.pkl`` and has shape [n_docs,
    n_topics], in its saved dtype; else None."""
    path = base + "_theta.npy"
    if not os.path.exists(path) or os.path.getmtime(path) < os.path.getmtime(
        base + "_model.pkl"
    ):
        return None
    theta = np.load(path)
    # the saved dtype (float32 from the E-step) is kept: casting up would
    # change the features' bits against the uncached path
    return theta if theta.shape == (n_docs, n_topics) else None


def prepare_topic_data(
    dataset: str,
    data_root: str = "data",
    graph_dir: Optional[str] = None,
    num_topics: Optional[int] = None,
    *,
    device,
) -> PreparedData:
    """TopicGCN's document-topic graph → dense-feature training inputs on
    ``device``.

    Nodes are docs [0, D) then topics [D, D+K). theta comes from the cache
    (:func:`cached_theta`) or, when that is stale or missing, from the LDA
    E-step over the clean corpus on ``device``, and is then cached (a
    read-only artifact directory is left as it is).
    """
    graph_dir = graph_dir or os.path.join(data_root, "graph")
    base = os.path.join(graph_dir, f"{dataset}_topic")
    labels = load_labels(os.path.join(data_root, "text_dataset", f"{dataset}.txt"))
    tm = TopicModel(num_topics=num_topics or 50)
    tm.load(base + "_model.pkl")
    theta = cached_theta(base, labels.n_docs, tm.num_topics)
    if theta is None:
        docs = load_documents_from_file(
            os.path.join(data_root, "text_dataset", "clean_corpus", f"{dataset}.txt")
        )
        theta = tm.get_document_topic_distribution(docs, device=device)
        try:
            np.save(base + "_theta.npy", theta)
        except OSError:
            pass  # read-only artifact dir: recompute next time
    if tm.topic_embeddings is None:
        tm.get_topic_embeddings(top_n=20)
    features = build_topic_features(theta, tm.topic_embeddings)

    num_docs, k = theta.shape
    if num_docs != labels.n_docs:
        raise ValueError(f"corpus has {num_docs} docs but label file has {labels.n_docs}")
    graph = load_graph_edges(base + ".txt", num_docs + k, device=device)
    return PreparedData(
        graph=graph,
        features=features,
        labels=labels,
        n_feat=features.shape[1],
        num_docs=num_docs,
        num_topics=k,
    )
