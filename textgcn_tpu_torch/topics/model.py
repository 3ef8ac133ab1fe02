"""The topic model: LDA + Word2Vec + topic embeddings + persistence.

Port of ``textgcn_tpu/topics/model.py``:

  fit(documents, device=)            — vocabulary + LDA (VB-EM on the device)
  fit_word2vec(documents, device=)   — CBOW embeddings for topic vectors
  get_topic_embeddings(top_n=20)     — phi-weighted mean of top-word vectors
  get_document_topic_distribution()  — theta via the LDA E-step on a device
  get_topic_word_distribution(top_n) — top words per topic
  save(path) / load(path)            — versioned pickle of numpy arrays

The pickle is the JAX package's: a plain dict of numpy arrays, lists and
scalars with the same keys and ``FORMAT_VERSION``, so either package reads
the other's. ``lda_backend="jax"`` names the batch VB-EM of
:mod:`textgcn_tpu_torch.topics.lda` (the port's counterpart of the JAX
package's); ``"sklearn"`` fits sklearn's ``LatentDirichletAllocation`` on the
host and raises ``ImportError`` where sklearn is not installed.
"""
from __future__ import annotations

import contextlib
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from textgcn_tpu_torch.topics.lda import LDA
from textgcn_tpu_torch.topics.vectorize import CountVectorizer
from textgcn_tpu_torch.topics.word2vec import Word2Vec

LDA_BACKENDS = ("jax", "sklearn")


def load_documents_from_file(filepath: str) -> List[str]:
    """One document per line, space-separated tokens; blank lines skipped."""
    docs = []
    with open(filepath, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                docs.append(line)
    return docs


def _joined(documents: Sequence) -> List[str]:
    return [d if isinstance(d, str) else " ".join(d) for d in documents]


class TopicModel:
    FORMAT_VERSION = 1

    def __init__(
        self,
        num_topics: int = 50,
        random_state: int = 42,
        max_iter: int = 20,
        lda_backend: str = "jax",
    ):
        if lda_backend not in LDA_BACKENDS:
            raise ValueError(f"lda_backend {lda_backend!r}: one of {LDA_BACKENDS}")
        self.num_topics = int(num_topics)
        self.random_state = int(random_state)
        self.max_iter = int(max_iter)
        self.lda_backend = lda_backend
        self.vectorizer: Optional[CountVectorizer] = None
        self.lda: Optional[object] = None
        self.vocabulary_: Optional[np.ndarray] = None
        self.topic_word_distribution: Optional[np.ndarray] = None  # [K, V] phi
        self.topic_embeddings: Optional[np.ndarray] = None  # [K, E]
        self.word2vec_model: Optional[Word2Vec] = None
        self.training_documents: Optional[List[str]] = None

    # -- fitting ---------------------------------------------------------
    def fit(
        self,
        documents: Sequence[str],
        min_df: int = 2,
        max_df: float = 0.95,
        *,
        device,
        timer=None,
    ) -> "TopicModel":
        """The vocabulary (host) and the LDA fit (on ``device``; sklearn's
        on the host). A :class:`~textgcn_tpu_torch.utils.profiling.StageTimer`
        given as ``timer`` gets the stages "vectorize" and "lda fit"."""
        def stage(name):
            return contextlib.nullcontext() if timer is None else timer.stage(name)

        documents = _joined(documents)
        self.vectorizer = CountVectorizer(min_df=min_df, max_df=max_df)
        with stage("vectorize"):
            dtm = self.vectorizer.fit_transform(documents)
        self.vocabulary_ = self.vectorizer.get_feature_names_out()
        with stage("lda fit"):
            self._fit_lda(dtm, device)
        comps = self.lda.components_
        self.topic_word_distribution = comps / comps.sum(axis=1, keepdims=True)
        self.training_documents = documents
        return self

    def _fit_lda(self, dtm, device) -> None:
        if self.lda_backend == "sklearn":
            from sklearn.decomposition import LatentDirichletAllocation

            self.lda = LatentDirichletAllocation(
                n_components=self.num_topics,
                random_state=self.random_state,
                max_iter=self.max_iter,
                learning_method="batch",
            )
            self.lda.fit(dtm)
        else:
            self.lda = LDA(
                n_components=self.num_topics,
                max_iter=self.max_iter,
                random_state=self.random_state,
            )
            self.lda.fit(dtm, device=device)

    def fit_word2vec(
        self,
        documents: Sequence[str],
        vector_size: int = 100,
        window: int = 5,
        min_count: int = 2,
        epochs: int = 10,
        *,
        device,
    ) -> "TopicModel":
        self.word2vec_model = Word2Vec(
            vector_size=vector_size,
            window=window,
            min_count=min_count,
            epochs=epochs,
            seed=self.random_state,
        )
        self.word2vec_model.fit(list(documents), device=device)
        return self

    # -- persistence -----------------------------------------------------
    def save(self, filepath: str) -> None:
        w2v = self.word2vec_model
        data = {
            "format_version": self.FORMAT_VERSION,
            "num_topics": self.num_topics,
            "random_state": self.random_state,
            "max_iter": self.max_iter,
            "lda_backend": self.lda_backend,
            "vocabulary": None if self.vocabulary_ is None else list(map(str, self.vocabulary_)),
            "lda_components": None if self.lda is None else np.asarray(self.lda.components_),
            "topic_word_distribution": self.topic_word_distribution,
            "topic_embeddings": self.topic_embeddings,
            "w2v_vectors": None if w2v is None else w2v.vectors,
            "w2v_index_to_key": None if w2v is None else w2v.index_to_key,
            "w2v_vector_size": None if w2v is None else w2v.vector_size,
            "vectorizer_min_df": None if self.vectorizer is None else self.vectorizer.min_df,
            "vectorizer_max_df": None if self.vectorizer is None else self.vectorizer.max_df,
        }
        with open(filepath, "wb") as f:
            pickle.dump(data, f)

    def load(self, filepath: str) -> "TopicModel":
        """Read the build stage's pickle. The pickle is unpickled, so load
        only a file this program's build stage wrote."""
        with open(filepath, "rb") as f:
            data = pickle.load(f)
        version = data.get("format_version")
        if version != self.FORMAT_VERSION:
            raise ValueError(
                f"{filepath}: topic model format_version {version!r}, this "
                f"code reads {self.FORMAT_VERSION}"
            )
        self.num_topics = data["num_topics"]
        self.random_state = data["random_state"]
        self.max_iter = data.get("max_iter", 20)
        self.lda_backend = data.get("lda_backend", "jax")
        self.topic_word_distribution = data["topic_word_distribution"]
        self.topic_embeddings = data["topic_embeddings"]
        if data["vocabulary"] is not None:
            self.vocabulary_ = np.asarray(data["vocabulary"], dtype=object)
            self.vectorizer = CountVectorizer(
                {t: i for i, t in enumerate(data["vocabulary"])},
                min_df=data.get("vectorizer_min_df") or 2,
                max_df=data.get("vectorizer_max_df") or 0.95,
            )
        if data["lda_components"] is not None:
            self.lda = LDA(
                n_components=self.num_topics,
                max_iter=self.max_iter,
                random_state=self.random_state,
            )
            self.lda.components_ = np.asarray(data["lda_components"])
        if data["w2v_vectors"] is not None:
            w2v = Word2Vec(vector_size=data["w2v_vector_size"])
            w2v.vectors = np.asarray(data["w2v_vectors"])
            w2v.index_to_key = list(data["w2v_index_to_key"])
            w2v.vocab = {w: i for i, w in enumerate(w2v.index_to_key)}
            self.word2vec_model = w2v
        return self

    # -- queries ---------------------------------------------------------
    def get_document_topic_distribution(
        self, documents: Optional[Sequence[str]] = None, *, device
    ) -> np.ndarray:
        """theta [D, K] of ``documents`` (strings or token lists; default:
        the documents ``fit`` saw) through the E-step on ``device``
        (sklearn's transform on the host)."""
        if self.lda is None:
            raise ValueError("the topic model has no LDA components")
        if documents is None:
            documents = self.training_documents
        dtm = self.vectorizer.transform(_joined(documents))
        if isinstance(self.lda, LDA):
            return np.asarray(self.lda.transform(dtm, device=device))
        return np.asarray(self.lda.transform(dtm))

    def get_topic_word_distribution(self, top_n: int = 20) -> Dict[int, List[Tuple[str, float]]]:
        if self.topic_word_distribution is None:
            raise ValueError("the topic model has no topic-word distribution")
        out = {}
        phi = self.topic_word_distribution
        for k in range(self.num_topics):
            top = np.argsort(-phi[k])[:top_n]
            out[k] = [(str(self.vocabulary_[i]), float(phi[k, i])) for i in top]
        return out

    def get_topic_embeddings(self, top_n: int = 20) -> np.ndarray:
        """Topic embedding = mean of the phi-weighted vectors of the topic's
        top-N words; a normal draw when none of them has a vector; the phi
        row itself when there are no word vectors."""
        topic_words = self.get_topic_word_distribution(top_n=top_n)
        rng = np.random.RandomState(self.random_state)
        embs = []
        for k in range(self.num_topics):
            if self.word2vec_model is not None:
                vecs = [
                    self.word2vec_model[w] * p
                    for w, p in topic_words[k]
                    if w in self.word2vec_model
                ]
                emb = (
                    np.mean(vecs, axis=0)
                    if vecs
                    else rng.randn(self.word2vec_model.vector_size)
                )
            else:
                emb = self.topic_word_distribution[k]
            embs.append(np.asarray(emb, dtype=np.float32))
        self.topic_embeddings = np.stack(embs)
        return self.topic_embeddings
