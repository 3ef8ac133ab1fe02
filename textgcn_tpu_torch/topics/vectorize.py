"""Token-count vectorizer (a dependency-free CountVectorizer).

Port of ``textgcn_tpu/topics/vectorize.py`` (host work: pure Python, numpy
and scipy):

- tokens are whitespace-split (``doc.split()``: token pattern ``\\S+``, no
  lowercasing); tokens outside the vocabulary are dropped;
- ``fit`` keeps the tokens whose document frequency lies in ``[min_df,
  max_df * D]`` and sorts them lexicographically (as sklearn does), so the
  topic-word columns line up with the JAX package's;
- ``transform`` gives a CSR matrix of counts with sorted column indices.

A vectorizer is either fitted here or built over a stored vocabulary
(``CountVectorizer(vocabulary)``, as :meth:`TopicModel.load` does).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.sparse as sp


class CountVectorizer:
    def __init__(
        self,
        vocabulary: Optional[Dict[str, int]] = None,
        min_df: int = 2,
        max_df: float = 0.95,
    ):
        self.min_df = int(min_df)
        self.max_df = float(max_df)
        self.vocabulary_: Dict[str, int] = dict(vocabulary or {})  # token -> column

    def fit(self, documents: Sequence[str]) -> "CountVectorizer":
        df: Counter = Counter()
        for doc in documents:
            df.update(set(doc.split()))
        max_count = self.max_df * len(documents)
        terms = sorted(t for t, c in df.items() if self.min_df <= c <= max_count)
        if not terms:
            raise ValueError(
                "empty vocabulary after min_df/max_df pruning "
                f"(min_df={self.min_df}, max_df={self.max_df})"
            )
        self.vocabulary_ = {t: i for i, t in enumerate(terms)}
        return self

    def fit_transform(self, documents: Sequence[str]) -> sp.csr_matrix:
        return self.fit(documents).transform(documents)

    def transform(self, documents: Sequence[str]) -> sp.csr_matrix:
        if not self.vocabulary_:
            raise ValueError("vectorizer has no vocabulary")
        vocab = self.vocabulary_
        indptr = [0]
        indices: List[int] = []
        data: List[int] = []
        for doc in documents:
            counts: Counter = Counter(vocab[t] for t in doc.split() if t in vocab)
            indices.extend(counts.keys())
            data.extend(counts.values())
            indptr.append(len(indices))
        mat = sp.csr_matrix(
            (
                np.asarray(data, dtype=np.float64),
                np.asarray(indices, dtype=np.int64),
                np.asarray(indptr, dtype=np.int64),
            ),
            shape=(len(documents), len(vocab)),
        )
        mat.sort_indices()
        return mat

    def get_feature_names_out(self) -> np.ndarray:
        names = [None] * len(self.vocabulary_)
        for t, i in self.vocabulary_.items():
            names[i] = t
        return np.asarray(names, dtype=object)
