"""Document–topic–topic graph construction (TopicGCN graphs) and the
weighted edgelist format.

Port of ``textgcn_tpu/graph/build_topic.py``. The topic model is fitted on a
device (LDA and Word2Vec, :mod:`textgcn_tpu_torch.topics`); the edges are
numpy on the host:

- node ids: documents ``[0, D)``, topics ``[D, D+K)``;
- doc–topic edge (d, D+k, theta_dk) kept when ``theta_dk >=
  doc_topic_threshold``;
- topic–topic edge (D+i, D+j, cos_sim) for i<j kept when ``cos_sim >
  topic_topic_threshold``;
- artifacts: ``{ds}_topic.txt`` weighted edgelist ("u v w" lines),
  ``{ds}_topic_model.pkl``, ``{ds}_topic_theta.npy`` (theta, so that
  training need not infer it again) and ``{ds}_topic_nodes.csv`` /
  ``{ds}_topic_edges.csv`` for ontology tools.

``read_weighted_edgelist`` parses in the native graph core
(:mod:`textgcn_tpu_torch.native`) when a C++ compiler exists, as the JAX
package does, else in the JAX package's pure-Python loop. The two give the
same arrays on "u v w" and "u v" lines (weight 1) and both skip a line of one
field; as in JAX, the native parser skips a line whose node ids are not
integers, where the loop raises. Unlike JAX's native parser, the port's stops
every field at the line end, so a "u v" line never takes the next line's
first field as its weight.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from textgcn_tpu_torch import native
from textgcn_tpu_torch.topics.model import TopicModel, load_documents_from_file
from textgcn_tpu_torch.utils.logging import graph_stats
from textgcn_tpu_torch.utils.profiling import StageTimer


def cosine_similarity_matrix(x: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.maximum(norms, 1e-12)
    return xn @ xn.T


@dataclass
class TopicGraph:
    """Host-side topic graph: COO edge arrays and their counts."""

    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    num_docs: int
    num_topics: int
    n_doc_topic_edges: int
    n_topic_topic_edges: int

    @property
    def n_nodes(self) -> int:
        return self.num_docs + self.num_topics

    @property
    def n_edges(self) -> int:
        return len(self.src)


def build_doc_topic_edges(
    doc_topic_dist: np.ndarray, threshold: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Edges (doc d) -- (topic node D+k) where theta_dk >= threshold."""
    num_docs = doc_topic_dist.shape[0]
    d, k = np.nonzero(doc_topic_dist >= threshold)
    return (
        d.astype(np.int64),
        (num_docs + k).astype(np.int64),
        doc_topic_dist[d, k].astype(np.float64),
    )


def build_topic_topic_edges(
    topic_embeddings: np.ndarray, threshold: float, num_docs: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Upper-triangle (i<j) edges where cosine similarity > threshold."""
    sim = cosine_similarity_matrix(np.asarray(topic_embeddings, np.float64))
    i, j = np.nonzero(np.triu(sim > threshold, k=1))
    return (num_docs + i).astype(np.int64), (num_docs + j).astype(np.int64), sim[i, j]


class TopicGraphBuilder:
    """Fits the topic model on ``device`` and assembles the
    doc–topic–topic graph. ``timer`` holds the last build's seconds by
    stage: vectorize, lda fit, word2vec, theta, graph.

    ``lda_max_iter`` defaults to the JAX package's 60 (not the reference's
    20): on R8 the per-word bound still climbs past iteration 20, the
    windowed stop test does not fire before 60, and the JAX package measured
    a higher test accuracy at 60 than at 20 or at an earlier exit.
    """

    def __init__(
        self,
        dataset: str,
        num_topics: int = 50,
        doc_topic_threshold: float = 0.02,
        topic_topic_threshold: float = 0.3,
        min_df: int = 2,
        max_df: float = 0.95,
        use_word2vec: bool = True,
        lda_backend: str = "jax",
        lda_max_iter: int = 60,
        data_root: str = "data",
        verbose: bool = True,
        *,
        device,
    ):
        self.dataset = dataset
        self.num_topics = num_topics
        self.doc_topic_threshold = doc_topic_threshold
        self.topic_topic_threshold = topic_topic_threshold
        self.min_df = min_df
        self.max_df = max_df
        self.use_word2vec = use_word2vec
        self.lda_backend = lda_backend
        self.lda_max_iter = lda_max_iter
        self.data_root = data_root
        self.verbose = verbose
        self.device = device
        self.topic_model: Optional[TopicModel] = None
        self.graph: Optional[TopicGraph] = None
        self._theta: Optional[np.ndarray] = None
        self.timer = StageTimer()

    def load_documents(self) -> List[str]:
        path = os.path.join(self.data_root, "text_dataset", "clean_corpus", f"{self.dataset}.txt")
        return load_documents_from_file(path)

    def build(self, documents: Optional[Sequence[str]] = None) -> TopicGraph:
        if documents is None:
            documents = self.load_documents()
        self.timer = StageTimer()
        tm = TopicModel(
            num_topics=self.num_topics,
            lda_backend=self.lda_backend,
            max_iter=self.lda_max_iter,
        )
        if self.verbose:
            print(f"==> Fitting LDA ({self.lda_backend}) K={self.num_topics}")
        tm.fit(documents, min_df=self.min_df, max_df=self.max_df, device=self.device,
               timer=self.timer)
        if self.use_word2vec:
            if self.verbose:
                print("==> Training Word2Vec topic embeddings")
            with self.timer.stage("word2vec"):
                tm.fit_word2vec(documents, vector_size=100, device=self.device)
        tm.get_topic_embeddings(top_n=20)
        with self.timer.stage("theta"):
            theta = tm.get_document_topic_distribution(documents, device=self.device)
        self.topic_model = tm
        self._theta = theta
        with self.timer.stage("graph"):
            self.graph = self.build_from_arrays(theta, tm.topic_embeddings)
        if self.verbose:
            print(self.timer.report())
        return self.graph

    def build_from_arrays(
        self, doc_topic_dist: np.ndarray, topic_embeddings: np.ndarray
    ) -> TopicGraph:
        num_docs, num_topics = doc_topic_dist.shape
        s1, d1, w1 = build_doc_topic_edges(doc_topic_dist, self.doc_topic_threshold)
        s2, d2, w2 = build_topic_topic_edges(
            topic_embeddings, self.topic_topic_threshold, num_docs
        )
        if self.verbose:
            print(f"Document-topic edges: {len(s1)}")
            print(f"Topic-topic edges: {len(s2)}")
            print(graph_stats(num_docs + num_topics, len(s1) + len(s2)))
        return TopicGraph(
            src=np.concatenate([s1, s2]),
            dst=np.concatenate([d1, d2]),
            weight=np.concatenate([w1, w2]),
            num_docs=num_docs,
            num_topics=num_topics,
            n_doc_topic_edges=len(s1),
            n_topic_topic_edges=len(s2),
        )

    def save(self, out_dir: Optional[str] = None) -> None:
        """Write the artifacts under ``out_dir`` (default
        ``{data_root}/graph``): the edgelist, the model pickle, theta, the
        CSVs, in that order, so theta is never older than the pickle and
        training takes it instead of inferring it again."""
        if self.graph is None:
            raise ValueError("build() first")
        out_dir = out_dir or os.path.join(self.data_root, "graph")
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.join(out_dir, f"{self.dataset}_topic")
        write_weighted_edgelist(self.graph, base + ".txt")
        if self.topic_model is not None:
            self.topic_model.save(base + "_model.pkl")
        if self._theta is not None:
            np.save(base + "_theta.npy", self._theta)
        export_protege_csvs(self.graph, self.topic_model, base)
        if self.verbose:
            print(f"Saved graph artifacts under {out_dir}")


def write_weighted_edgelist(graph, path: str) -> None:
    """"u v w" lines, one an edge (networkx ``write_weighted_edgelist``)."""
    with open(path, "w", encoding="utf-8") as f:
        for s, d, w in zip(graph.src, graph.dst, graph.weight):
            f.write(f"{int(s)} {int(d)} {float(w)}\n")


def read_weighted_edgelist(
    path: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read "u v w" lines into COO arrays (undirected edges listed once);
    a line without a weight gets weight 1."""
    if native.available():
        native.log_path("read_weighted_edgelist", True)
        return native.parse_edgelist(path)
    native.log_path("read_weighted_edgelist", False)
    src, dst, w = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            w.append(float(parts[2]) if len(parts) > 2 else 1.0)
    return (
        np.asarray(src, dtype=np.int64),
        np.asarray(dst, dtype=np.int64),
        np.asarray(w, dtype=np.float64),
    )


def export_protege_csvs(
    graph: TopicGraph, topic_model: Optional[TopicModel], base: str
) -> None:
    """Node and edge CSVs for ontology tools (Protégé)."""
    with open(base + "_nodes.csv", "w", encoding="utf-8") as f:
        f.write("node_id,node_type,label\n")
        for d in range(graph.num_docs):
            f.write(f"{d},document,doc_{d}\n")
        top_words = (
            topic_model.get_topic_word_distribution(top_n=3)
            if topic_model is not None and topic_model.topic_word_distribution is not None
            else None
        )
        for k in range(graph.num_topics):
            label = "_".join(w for w, _ in top_words[k]) if top_words else f"topic_{k}"
            f.write(f"{graph.num_docs + k},topic,{label}\n")
    with open(base + "_edges.csv", "w", encoding="utf-8") as f:
        f.write("source,target,weight,edge_type\n")
        for idx, (s, d, w) in enumerate(zip(graph.src, graph.dst, graph.weight)):
            etype = "doc_topic" if idx < graph.n_doc_topic_edges else "topic_topic"
            f.write(f"{int(s)},{int(d)},{float(w)},{etype}\n")
