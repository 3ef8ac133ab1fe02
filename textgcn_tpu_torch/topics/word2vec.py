"""Word vectors, the lookup side.

Port of the gensim-like lookup of ``textgcn_tpu/topics/word2vec.py``
(``vectors``, ``index_to_key``, ``vocab``, ``vector_size``, ``in`` and
``[]``), which the topic embeddings need. The vectors come from the build
stage's topic model (:meth:`TopicModel.load`); CBOW training is not ported.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Word2Vec:
    def __init__(self, vector_size: int = 100):
        self.vector_size = vector_size
        self.vocab: Dict[str, int] = {}
        self.index_to_key: List[str] = []
        self.vectors: Optional[np.ndarray] = None

    def __contains__(self, word: str) -> bool:
        return word in self.vocab

    def __getitem__(self, word: str) -> np.ndarray:
        return self.vectors[self.vocab[word]]
