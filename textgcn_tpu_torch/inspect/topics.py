"""Topic inspection reports.

Port of ``textgcn_tpu/inspect/topics.py``: the top words of each topic, the
top documents of each topic, statistics of the topic distribution, and a
topic-similarity heatmap where matplotlib is installed (none otherwise),
written as one text report. theta is inferred once, by the
LDA E-step on ``device``, and serves every section.
"""
from __future__ import annotations

import io
import os
from typing import Optional

import numpy as np

from textgcn_tpu_torch.graph.build_topic import cosine_similarity_matrix
from textgcn_tpu_torch.topics.model import TopicModel, load_documents_from_file


def format_topic_words(tm: TopicModel, top_n: int = 10) -> str:
    out = io.StringIO()
    words = tm.get_topic_word_distribution(top_n=top_n)
    for k in range(tm.num_topics):
        ws = ", ".join(f"{w} ({p:.4f})" for w, p in words[k])
        out.write(f"Topic {k}: {ws}\n")
    return out.getvalue()


def format_top_documents(
    tm: TopicModel, documents, theta: np.ndarray, top_n_docs: int = 5, snippet_len: int = 120,
) -> str:
    out = io.StringIO()
    for k in range(tm.num_topics):
        top = np.argsort(-theta[:, k])[:top_n_docs]
        out.write(f"\nTopic {k} — top documents:\n")
        for d in top:
            snippet = documents[d][:snippet_len].replace("\n", " ")
            out.write(f"  doc {d} (theta={theta[d, k]:.4f}): {snippet}\n")
    return out.getvalue()


def format_distribution_stats(theta: np.ndarray) -> str:
    out = io.StringIO()
    dom = theta.argmax(axis=1)
    out.write("Topic distribution statistics\n")
    out.write(f"  documents: {theta.shape[0]}, topics: {theta.shape[1]}\n")
    out.write(f"  mean max-theta: {theta.max(axis=1).mean():.4f}\n")
    ent = -np.sum(theta * np.log(theta + 1e-12), axis=1)
    out.write(f"  mean entropy: {ent.mean():.4f}\n")
    counts = np.bincount(dom, minlength=theta.shape[1])
    out.write("  docs per dominant topic: ")
    out.write(" ".join(f"{k}:{c}" for k, c in enumerate(counts) if c > 0) + "\n")
    return out.getvalue()


def plot_topic_similarity_heatmap(tm: TopicModel, path: str) -> Optional[str]:
    """The topics' cosine-similarity heatmap as a PNG at ``path``; None
    where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    emb = tm.topic_embeddings
    if emb is None:
        emb = tm.get_topic_embeddings()
    sim = cosine_similarity_matrix(np.asarray(emb, np.float64))
    fig, ax = plt.subplots(figsize=(10, 8))
    im = ax.imshow(sim, cmap="viridis", vmin=-1, vmax=1)
    fig.colorbar(im, ax=ax, label="cosine similarity")
    ax.set_title("Topic similarity")
    ax.set_xlabel("topic")
    ax.set_ylabel("topic")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def inspect_topics(
    dataset: str,
    data_root: str = "data",
    top_n_words: int = 10,
    top_n_docs: int = 5,
    heatmap: bool = True,
    output_dir: str = "results",
    *,
    device,
) -> str:
    """Write ``{output_dir}/{dataset}_topic_inspection.txt`` (and the
    heatmap) from the built topic model; returns the report."""
    base = os.path.join(data_root, "graph", f"{dataset}_topic")
    tm = TopicModel().load(base + "_model.pkl")
    docs = load_documents_from_file(
        os.path.join(data_root, "text_dataset", "clean_corpus", f"{dataset}.txt")
    )
    theta = tm.get_document_topic_distribution(docs, device=device)

    os.makedirs(output_dir, exist_ok=True)
    report = io.StringIO()
    report.write(f"Topic inspection — {dataset}\n")
    report.write("=" * 60 + "\n\n")
    report.write(format_topic_words(tm, top_n=top_n_words))
    report.write("\n")
    report.write(format_distribution_stats(theta))
    report.write(format_top_documents(tm, docs, theta, top_n_docs=top_n_docs))

    if heatmap:
        hm = plot_topic_similarity_heatmap(
            tm, os.path.join(output_dir, f"{dataset}_topic_similarity.png")
        )
        if hm:
            report.write(f"\nheatmap: {hm}\n")

    path = os.path.join(output_dir, f"{dataset}_topic_inspection.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(report.getvalue())
    print(f"wrote {path}")
    return report.getvalue()
