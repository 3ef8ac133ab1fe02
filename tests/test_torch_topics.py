"""The topic model's inference side of the PyTorch port
(``textgcn_tpu_torch.topics``) against the JAX package's, on the CPU, from
the committed R8 topic model and clean corpus: the same inputs go through
both, with the tolerance stated in each test."""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from textgcn_tpu.topics import lda as jlda
from textgcn_tpu.topics.model import TopicModel as JTopicModel
from textgcn_tpu.topics.model import load_documents_from_file as j_load_documents

from textgcn_tpu_torch.topics import lda as tlda
from textgcn_tpu_torch.topics.model import TopicModel as TTopicModel
from textgcn_tpu_torch.topics.model import load_documents_from_file as t_load_documents

MODEL = "data/graph/R8_topic_model.pkl"
CORPUS = "data/text_dataset/clean_corpus/R8.txt"


@pytest.fixture(scope="module")
def models():
    return JTopicModel().load(MODEL), TTopicModel().load(MODEL)


@pytest.fixture(scope="module")
def docs():
    d = t_load_documents(CORPUS)
    assert d == j_load_documents(CORPUS) and len(d) == 7674
    return d


def test_count_vectorizer_transform_equals_jax(models, docs):
    """The first 200 docs over the R8 pickle's vocabulary: the same CSR
    (indptr, sorted indices, counts) and feature names."""
    jm, tm = models
    a, b = jm.vectorizer.transform(docs[:200]), tm.vectorizer.transform(docs[:200])
    assert a.shape == b.shape == (200, 7463) and b.has_sorted_indices
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    np.testing.assert_array_equal(
        tm.vectorizer.get_feature_names_out(), jm.vectorizer.get_feature_names_out()
    )


# theta (gamma's rows normalized) from two f32 E-steps: the fixed-point
# iteration carries last-bit differences of digamma and of the matmuls'
# sums from one iteration to the next (elements of gamma drift apart by up
# to 5e-4 relative, 1.4e-5 of a row's mass, measured on R8 chunks at 5-100
# iterations); the smoke holds the whole R8 theta to the same 1e-4
THETA_TOL = 1e-4


@pytest.mark.parametrize(
    "iters,tol", [(5, 0.0), (40, 0.0), (100, 1e-3)], ids=["fixed5", "fixed40", "stopping"]
)
def test_e_step_equals_jax(iters, tol, models, docs):
    """One uint16 chunk of 64 R8 docs (padded to 80 rows) from the same
    gamma0. ``fixed*``: tol 0, so both run the same number of iterations;
    each entry of gamma within ``THETA_TOL`` of its row's sum, the rows
    normalized within ``THETA_TOL``, sstats within 1e-4 of its largest
    entry and the word bound within 1e-4 relative. ``stopping``: the
    defaults; where the chunk-wide change ends within rounding of tol one
    side may take one more iteration, so the gammas are held to that
    iteration's update: a per-row mean of at most tol."""
    jm, tm = models
    x = np.zeros((80, 7463), dtype=np.uint16)
    x[:64] = tm.vectorizer.transform(docs[:64]).toarray()
    gamma0 = np.random.RandomState(3).gamma(100.0, 0.01, (80, 50)).astype(np.float32)
    lam = jm.lda.components_
    alpha = np.float32(1.0 / 50)
    jg, js, jb = jlda._e_step(
        jnp.asarray(x), jnp.asarray(gamma0),
        jlda._dirichlet_expectation_exp(jnp.asarray(lam)), jnp.float32(alpha),
        max_iters=iters, tol=tol,
    )
    tg, ts, tb = tlda._e_step(
        torch.from_numpy(x), torch.from_numpy(gamma0),
        tlda._dirichlet_expectation_exp(torch.from_numpy(lam)), float(alpha),
        max_iters=iters, tol=tol,
    )
    tg, jg = tg.numpy(), np.asarray(jg)
    if tol:
        assert np.abs(tg - jg).mean(axis=-1).max() <= tol
        return
    rows = jg.sum(1, keepdims=True)
    assert (np.abs(tg - jg) <= THETA_TOL * rows).all()
    np.testing.assert_allclose(tg / tg.sum(1, keepdims=True), jg / rows, rtol=0, atol=THETA_TOL)
    js = np.asarray(js)
    np.testing.assert_allclose(ts.numpy(), js, rtol=0, atol=1e-4 * np.abs(js).max())
    np.testing.assert_allclose(float(tb), float(jb), rtol=1e-4)


def test_lda_transform_equals_jax_across_chunks(models, docs):
    """300 docs at ``chunk_size=128``: three chunks, the last one padded, each
    with its own gamma0 draw; theta within ``THETA_TOL``."""
    jm, tm = models
    jm.lda.chunk_size = tm.lda.chunk_size = 128
    try:
        x = tm.vectorizer.transform(docs[:300])
        got = tm.lda.transform(x, device="cpu")
        want = jm.lda.transform(x)
    finally:
        jm.lda.chunk_size = tm.lda.chunk_size = 2048
    assert got.dtype == np.float32 and got.shape == (300, 50)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_TOL)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_topic_model_load_equals_jax(models):
    jm, tm = models
    assert (tm.num_topics, tm.random_state) == (jm.num_topics, jm.random_state)
    for k in ("topic_word_distribution", "topic_embeddings"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k))
    np.testing.assert_array_equal(tm.lda.components_, jm.lda.components_)
    np.testing.assert_array_equal(tm.vocabulary_, jm.vocabulary_)
    assert tm.vectorizer.vocabulary_ == jm.vectorizer.vocabulary_
    w, v = tm.word2vec_model, jm.word2vec_model
    assert w.index_to_key == v.index_to_key and w.vector_size == v.vector_size == 100
    np.testing.assert_array_equal(w.vectors, v.vectors)
    word = w.index_to_key[17]
    assert word in w and "no-such-token" not in w and w.vocab == v.vocab
    np.testing.assert_array_equal(w[word], v[word])
    assert tm.get_topic_word_distribution(5) == jm.get_topic_word_distribution(5)


def test_topic_embeddings_equal_jax_without_stored_ones():
    """With ``topic_embeddings`` dropped, ``get_topic_embeddings(20)``
    recomputes them from phi and the word vectors: equal to JAX's, and to
    the ones the build stage stored (the same computation)."""
    jm, tm = JTopicModel().load(MODEL), TTopicModel().load(MODEL)
    stored = tm.topic_embeddings
    for m in (jm, tm):
        m.topic_embeddings = None
    got, want = tm.get_topic_embeddings(20), jm.get_topic_embeddings(20)
    assert got.shape == (50, 100) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, stored)


def test_topic_model_refuses_an_unknown_format_version(tmp_path):
    with open(MODEL, "rb") as f:
        data = pickle.load(f)
    for version in (2, None):
        data["format_version"] = version
        path = tmp_path / f"v{version}.pkl"
        with open(path, "wb") as f:
            pickle.dump(data, f)
        with pytest.raises(ValueError, match="format_version"):
            TTopicModel().load(str(path))
