"""Token counts over a stored vocabulary.

Port of ``CountVectorizer.transform`` and ``get_feature_names_out`` of
``textgcn_tpu/topics/vectorize.py``: tokens are whitespace-split
(``doc.split()``), tokens outside the vocabulary are dropped, and the output
is a CSR matrix with sorted column indices. The vocabulary comes from the
build stage's topic model (:meth:`TopicModel.load`); ``fit`` is not ported.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import scipy.sparse as sp


class CountVectorizer:
    def __init__(self, vocabulary: Dict[str, int]):
        self.vocabulary_ = vocabulary  # token -> column

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
