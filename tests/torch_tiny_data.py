"""The tiny synthetic corpus of ``tests/test_runner.py`` with its graphs
built by the JAX package's builders, for the port's tests: the port reads
the artifacts that the JAX build stage writes."""
import os

from textgcn_tpu.graph.build_textgcn import TextGCNGraphBuilder
from textgcn_tpu.graph.build_topic import TopicGraphBuilder

from test_runner import _write_tiny_dataset

N_DOCS, N_TOPICS = 24, 4


def build_tiny(root, docword: bool = False) -> str:
    """Write the corpus under ``root`` and build its topic graph (4 topics;
    and with ``docword`` its doc-word graph); returns the data root."""
    _write_tiny_dataset(str(root))
    data_root = os.path.join(str(root), "data")
    b = TopicGraphBuilder(
        "tiny", num_topics=N_TOPICS, min_df=1, max_df=1.0, lda_max_iter=8,
        data_root=data_root, verbose=False,
    )
    b.build()
    b.save()
    if docword:
        d = TextGCNGraphBuilder("tiny", window_size=5, data_root=data_root, verbose=False)
        d.build()
        d.save()
    return data_root
