"""The topic model of a built topic graph: load it, infer theta, embed topics.

Port of the inference side of ``textgcn_tpu/topics/model.py``:
``load_documents_from_file``, ``TopicModel.load`` (the build stage's
versioned pickle, a plain dict of numpy arrays, lists and scalars),
``get_document_topic_distribution`` (theta through the LDA E-step, on a
device), ``get_topic_word_distribution`` and ``get_topic_embeddings``.
Fitting and ``save`` are not ported: the build stage writes the pickle.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from textgcn_tpu_torch.topics.lda import LDA
from textgcn_tpu_torch.topics.vectorize import CountVectorizer
from textgcn_tpu_torch.topics.word2vec import Word2Vec


def load_documents_from_file(filepath: str) -> List[str]:
    """One document per line, space-separated tokens; blank lines skipped."""
    docs = []
    with open(filepath, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                docs.append(line)
    return docs


class TopicModel:
    FORMAT_VERSION = 1

    def __init__(self, num_topics: int = 50, random_state: int = 42):
        self.num_topics = int(num_topics)
        self.random_state = int(random_state)
        self.vectorizer: Optional[CountVectorizer] = None
        self.lda: Optional[LDA] = None
        self.vocabulary_: Optional[np.ndarray] = None
        self.topic_word_distribution: Optional[np.ndarray] = None  # [K, V] phi
        self.topic_embeddings: Optional[np.ndarray] = None  # [K, E]
        self.word2vec_model: Optional[Word2Vec] = None

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
        self.topic_word_distribution = data["topic_word_distribution"]
        self.topic_embeddings = data["topic_embeddings"]
        if data["vocabulary"] is not None:
            self.vocabulary_ = np.asarray(data["vocabulary"], dtype=object)
            self.vectorizer = CountVectorizer({t: i for i, t in enumerate(data["vocabulary"])})
        if data["lda_components"] is not None:
            self.lda = LDA(n_components=self.num_topics, random_state=self.random_state)
            self.lda.components_ = np.asarray(data["lda_components"])
        if data["w2v_vectors"] is not None:
            w2v = Word2Vec(vector_size=data["w2v_vector_size"])
            w2v.vectors = np.asarray(data["w2v_vectors"])
            w2v.index_to_key = list(data["w2v_index_to_key"])
            w2v.vocab = {w: i for i, w in enumerate(w2v.index_to_key)}
            self.word2vec_model = w2v
        return self

    def get_document_topic_distribution(
        self, documents: Sequence[str], *, device
    ) -> np.ndarray:
        """theta [D, K] of ``documents`` (strings or token lists) through the
        E-step on ``device``."""
        if self.lda is None:
            raise ValueError("the topic model has no LDA components")
        documents = [d if isinstance(d, str) else " ".join(d) for d in documents]
        dtm = self.vectorizer.transform(documents)
        return np.asarray(self.lda.transform(dtm, device=device))

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
