"""The build stage of the PyTorch port (``textgcn_tpu_torch``: text
cleaning, the vectorizer's fit, the LDA fit, CBOW training, the topic model's
pickle, the topic and doc-word graph builders, the logging helpers and the
experiment config) against the JAX package's, on the CPU: the same inputs go
through both, with the tolerance stated in each test. Every test that writes
files writes them under a temporary directory."""
import glob
import os
import pickle

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from textgcn_tpu.graph import build_textgcn as jdw
from textgcn_tpu.graph import build_topic as jbt
from textgcn_tpu.text import clean as jclean
from textgcn_tpu.text.stopwords import NLTK_ENGLISH_STOPWORDS as J_STOPWORDS
from textgcn_tpu.topics import word2vec as jw2v
from textgcn_tpu.topics.lda import LDA as JLDA
from textgcn_tpu.topics.model import TopicModel as JTopicModel
from textgcn_tpu.topics.vectorize import CountVectorizer as JCountVectorizer
from textgcn_tpu.utils import config as jconfig
from textgcn_tpu.utils import logging as jlog

from textgcn_tpu_torch.graph import build_textgcn as tdw
from textgcn_tpu_torch.graph import build_topic as tbt
from textgcn_tpu_torch.text import clean as tclean
from textgcn_tpu_torch.text.stopwords import NLTK_ENGLISH_STOPWORDS as T_STOPWORDS
from textgcn_tpu_torch.topics import lda as tlda
from textgcn_tpu_torch.topics import word2vec as tw2v
from textgcn_tpu_torch.topics.model import TopicModel as TTopicModel
from textgcn_tpu_torch.topics.vectorize import CountVectorizer as TCountVectorizer
from textgcn_tpu_torch.train.trainer import TrainConfig
from textgcn_tpu_torch.utils import config as tconfig
from textgcn_tpu_torch.utils import logging as tlog
from textgcn_tpu_torch.utils import profiling as tprof

from test_runner import _write_tiny_dataset

CPU = torch.device("cpu")
R8_CORPUS = "data/text_dataset/clean_corpus/R8.txt"


@pytest.fixture(scope="module")
def tiny_docs(tmp_path_factory):
    """The 24-document two-class corpus of the JAX package's runner tests."""
    root = tmp_path_factory.mktemp("tiny")
    _write_tiny_dataset(str(root))
    with open(root / "data/text_dataset/clean_corpus/tiny.txt", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


@pytest.fixture(scope="module")
def tiny_dtm(tiny_docs):
    return JCountVectorizer(min_df=1, max_df=1.0).fit_transform(tiny_docs)


# -- text cleaning --------------------------------------------------------

def test_stopwords_equal_the_jax_packages():
    assert T_STOPWORDS == J_STOPWORDS and len(T_STOPWORDS) == 179


QUIRKS = [
    "It's the movie I'd seen, and they'll say it wasn't (really) worth it?!",
    "Who cares? (really) -- prices rose 3.5% to $12,000 on 2024-01-02",
    "see https://example.com/a?b=c&d=e and ftp://files.org/x_y for more",
    "The   quick\tbrown fox; jumps: over `the` lazy dog's tail...",
    "don't won't can't shouldn't we've you're he'd she'll",
]


@pytest.mark.parametrize("text", QUIRKS, ids=range(len(QUIRKS)))
def test_string_process_equals_jax(text):
    """Every method on text with stop words, contractions, the literal
    ``\\(`` tokens, numbers and URLs: equal strings."""
    j, t = jclean.StringProcess(), tclean.StringProcess()
    for name in ("clean_str", "replace_num", "replace_urls"):
        assert getattr(t, name)(text) == getattr(j, name)(text)
    c = j.clean_str(text)
    assert t.remove_stopwords(c) == j.remove_stopwords(c)


@pytest.mark.parametrize("dataset", ["R8", "mr"])
def test_clean_corpus_lines_equal_jax(dataset):
    """Raw lines as bytes (latin-1) and as str, with and without the stop
    word and frequency filters (``mr`` skips both): equal documents."""
    raw = [q.encode("latin1") for q in QUIRKS] * 3 + ["caf\xe9 na\xefve r\xe9sum\xe9 caf\xe9"] * 5
    for lines in (raw, [r if isinstance(r, str) else r.decode("latin1") for r in raw]):
        want = jclean.clean_corpus_lines(lines, dataset)
        assert tclean.clean_corpus_lines(lines, dataset) == want


def test_clean_corpus_lines_reproduce_the_committed_mr_clean_corpus():
    """The committed raw mr corpus cleans to the committed clean corpus."""
    with open("data/text_dataset/corpus/mr.txt", "rb") as f:
        cleaned = tclean.clean_corpus_lines(f, dataset="mr")
    with open("data/text_dataset/clean_corpus/mr.txt", encoding="utf-8") as f:
        expect = [ln.rstrip("\n").rstrip(" ") for ln in f]
    assert len(cleaned) == len(expect) == 10662
    assert cleaned == expect


def test_clean_main_writes_the_jax_packages_file(tmp_path):
    """``python -m textgcn_tpu_torch.text.clean`` and the JAX package's
    ``CorpusProcess`` write byte-equal clean corpora."""
    for side in ("jax", "torch"):
        corpus = tmp_path / side / "text_dataset" / "corpus"
        corpus.mkdir(parents=True)
        (corpus / "R8x.txt").write_bytes(("\n".join(QUIRKS * 4) + "\n").encode("latin1"))
    jclean.CorpusProcess("R8x", data_root=str(tmp_path / "jax"))
    assert tclean.main(["--dataset", "R8x", "--data_root", str(tmp_path / "torch")]) == 0
    got, want = (
        (tmp_path / side / "text_dataset" / "clean_corpus" / "R8x.txt").read_bytes()
        for side in ("torch", "jax")
    )
    assert got == want and len(got) > 0


# -- vectorizer ---------------------------------------------------------------

def test_count_vectorizer_fit_transform_on_r8_equals_jax():
    """min_df 2, max_df 0.95 over the R8 clean corpus: the same vocabulary
    (7,463 words, the committed model's) and the same CSR counts."""
    with open(R8_CORPUS, encoding="utf-8") as f:
        docs = [ln.strip() for ln in f if ln.strip()]
    j, t = JCountVectorizer(min_df=2, max_df=0.95), TCountVectorizer(min_df=2, max_df=0.95)
    a, b = j.fit_transform(docs), t.fit_transform(docs)
    assert t.vocabulary_ == j.vocabulary_ and len(t.vocabulary_) == 7463
    assert a.shape == b.shape and b.has_sorted_indices
    for k in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    with pytest.raises(ValueError, match="empty vocabulary"):
        TCountVectorizer(min_df=10**6).fit(docs[:5])


# -- LDA ----------------------------------------------------------------------

def _lda_pair(**kw):
    args = dict(n_components=4, random_state=42, chunk_size=16, **kw)
    return JLDA(**args), tlda.LDA(**args)


def test_lda_fit_at_fixed_sub_iterations_equals_jax(tiny_dtm):
    """``mean_change_tol=0`` and 20 E-step iterations a chunk: every chunk
    runs all 20 on both sides (none reaches a fixed point in 20), for 5 EM
    iterations (two chunks of 16 rows, one padded). lambda and the per-word
    bound trace within 1e-5 relative: two f32 fits whose digamma and matmul
    sums differ in the last bits, carried over 100 E-step iterations."""
    j, t = _lda_pair(max_iter=5, mean_change_tol=0.0, bound_tol=0.0, max_doc_update_iter=20)
    j.fit(tiny_dtm)
    t.fit(tiny_dtm, device=CPU)
    assert j.n_iter_ == t.n_iter_ == 5
    assert t.e_step_iters_ == [20] * 10
    np.testing.assert_allclose(t.components_, j.components_, rtol=1e-5, atol=0)
    np.testing.assert_allclose(t.bound_trace_, j.bound_trace_, rtol=1e-5, atol=0)


def test_lda_fit_with_the_stop_tests_equals_jax(tiny_dtm):
    """The defaults' E-step test and the windowed EM test: the same number
    of EM iterations runs, and lambda within 1e-4 relative (where the
    chunk-wide change ends within rounding of the tol, one side may take
    one more E-step iteration)."""
    j, t = _lda_pair(max_iter=40)
    j.fit(tiny_dtm)
    t.fit(tiny_dtm, device=CPU)
    assert j.n_iter_ == t.n_iter_ < 40
    assert len(t.e_step_iters_) == 2 * t.n_iter_
    np.testing.assert_allclose(t.components_, j.components_, rtol=1e-4, atol=0)
    np.testing.assert_allclose(t.bound_trace_, j.bound_trace_, rtol=1e-5, atol=0)


def test_lda_pinned_and_streamed_chunks_fit_the_same_bits(tiny_dtm):
    """``pin_bytes_limit=0`` uploads the chunks on every EM iteration; the
    fit equals the one with chunks held on the device, bit for bit."""
    a = tlda.LDA(n_components=4, max_iter=6, chunk_size=16)
    b = tlda.LDA(n_components=4, max_iter=6, chunk_size=16, pin_bytes_limit=0)
    assert isinstance(a._device_chunks(tiny_dtm, CPU), list)
    assert isinstance(b._device_chunks(tiny_dtm, CPU), tlda._Stream)
    a.fit(tiny_dtm, device=CPU)
    b.fit(tiny_dtm, device=CPU)
    np.testing.assert_array_equal(a.components_, b.components_)
    assert a.bound_trace_ == b.bound_trace_ and a.e_step_iters_ == b.e_step_iters_


def test_lda_perplexity_and_transform_equal_jax(tiny_dtm):
    """From the same lambda (the JAX fit's): perplexity within 1e-5
    relative and theta within 1e-5 (f32 E-steps from the same draws)."""
    j, t = _lda_pair(max_iter=8)
    j.fit(tiny_dtm)
    t.components_ = j.components_
    assert t.perplexity(tiny_dtm, device=CPU) == pytest.approx(j.perplexity(tiny_dtm), rel=1e-5)
    np.testing.assert_allclose(
        t.transform(tiny_dtm, device=CPU), np.asarray(j.transform(tiny_dtm)), atol=1e-5, rtol=0
    )


def test_lda_runs_in_full_f32_and_restores_the_callers_setting(tiny_dtm):
    seen = []
    real = tlda._e_step

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a, **k)

    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        tlda._e_step = spy
        tlda.LDA(n_components=4, max_iter=2, chunk_size=16).fit(tiny_dtm, device=CPU)
        assert seen and set(seen) == {"highest"}
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        tlda._e_step = real
        torch.set_float32_matmul_precision(was)


# -- Word2Vec -------------------------------------------------------------------

def _w2v_pair(**kw):
    args = dict(vector_size=16, **kw)
    return jw2v.Word2Vec(**args), tw2v.Word2Vec(**args)


def test_w2v_examples_are_bit_equal_to_jax(tiny_docs):
    """The vocabulary, the encoding, and two epochs' examples drawn from one
    ``RandomState`` each: equal arrays, equal streams after."""
    j, t = _w2v_pair(sample=0.05)
    sents = [d.split() for d in tiny_docs]
    for m in (j, t):
        m._build_vocab(sents)
        m._encode(sents)
    assert t.index_to_key == j.index_to_key
    np.testing.assert_array_equal(t._subsample_probs(), j._subsample_probs())
    rj, rt = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        for a, b in zip(t._examples(rt), j._examples(rj)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert rt.randint(1 << 30) == rj.randint(1 << 30)


def test_one_cbow_step_equals_jax():
    """One step on a batch whose centers, contexts and negatives repeat
    indices many times (the scatter-adds must sum them): w_in, w_out and
    the loss within 1e-6."""
    rng = np.random.RandomState(0)
    v, d, b, c, n = 40, 16, 256, 10, 5
    w_in = ((rng.rand(v, d) - 0.5) / d).astype(np.float32)
    w_out = (rng.randn(v, d) * 0.1).astype(np.float32)
    centers = rng.randint(0, 8, b).astype(np.int32)
    ctx = rng.randint(0, v, (b, c)).astype(np.int32)
    mask = (rng.rand(b, c) < 0.7).astype(np.float32)
    mask[:3] = 0.0  # rows without context: the mean's denominator clamps at 1
    neg = rng.randint(0, 6, (b, n)).astype(np.int32)
    lr = np.float32(0.025)
    jin, jout, jloss = jw2v._cbow_step(
        jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(centers), jnp.asarray(ctx),
        jnp.asarray(mask), jnp.asarray(neg), jnp.asarray(lr),
    )
    tin, tout = torch.from_numpy(w_in.copy()), torch.from_numpy(w_out.copy())
    tloss = tw2v._cbow_step(
        tin, tout, torch.from_numpy(centers).long(), torch.from_numpy(ctx).long(),
        torch.from_numpy(mask), torch.from_numpy(neg).long(), float(lr),
    )
    np.testing.assert_allclose(tin.numpy(), np.asarray(jin), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-6)
    assert not np.array_equal(tout.numpy(), w_out)


def test_w2v_fit_equals_jax(tiny_docs):
    """Two epochs on the tiny corpus from the same seed (one padded batch an
    epoch, examples repeated ~13 times in it): the vectors within 1e-5
    (rtol 1e-5): f32 sums of the same products in another order."""
    j, t = _w2v_pair(epochs=2, seed=3)
    j.fit(tiny_docs)
    t.fit(tiny_docs, device=CPU)
    assert t.index_to_key == j.index_to_key and t.steps_ == 2
    np.testing.assert_allclose(t.vectors, j.vectors, rtol=1e-5, atol=1e-5)
    assert [w for w, _ in t.most_similar(t.index_to_key[0], topn=5)] == [
        w for w, _ in j.most_similar(j.index_to_key[0], topn=5)
    ]


def test_w2v_epoch_draws_equal_the_jax_packages_per_step_draws():
    """An epoch's permutation and its negatives drawn in one call equal the
    JAX package's loop (a permutation, then one draw of (B, N) a step, the
    last batch wrapped with ``np.resize``), and the stream continues the
    same after."""
    t = tw2v.Word2Vec(batch_size=64, negative=5)
    noise = np.random.RandomState(1).rand(30)
    noise /= noise.sum()
    for n_ex in (64, 200, 7):
        rj, rt = np.random.RandomState(9), np.random.RandomState(9)
        order = rj.permutation(n_ex)
        sels, negs = [], []
        for lo in range(0, n_ex, 64):
            sel = order[lo:lo + 64]
            sels.append(np.resize(sel, 64) if len(sel) < 64 else sel)
            negs.append(rj.choice(30, size=(64, 5), p=noise).astype(np.int32))
        sel, neg = t._epoch_batches(rt, n_ex, noise)
        np.testing.assert_array_equal(sel, np.concatenate(sels))
        np.testing.assert_array_equal(neg, np.concatenate(negs))
        assert rt.rand() == rj.rand()


# -- the topic model's pickle --------------------------------------------------

def test_topic_model_pickles_read_across_packages(tmp_path, tiny_docs):
    """The port's ``save`` is read by the JAX package's ``load`` and the
    reverse: the same keys, and equal arrays, vocabularies and settings."""
    t = TTopicModel(num_topics=4, max_iter=3).fit(tiny_docs, min_df=1, max_df=1.0, device=CPU)
    t.fit_word2vec(tiny_docs, vector_size=8, epochs=1, device=CPU)
    t.get_topic_embeddings(top_n=5)
    t.save(str(tmp_path / "port.pkl"))
    j = JTopicModel(num_topics=4, max_iter=3).fit(tiny_docs, min_df=1, max_df=1.0)
    j.fit_word2vec(tiny_docs, vector_size=8, epochs=1)
    j.get_topic_embeddings(top_n=5)
    j.save(str(tmp_path / "jax.pkl"))
    with open(tmp_path / "port.pkl", "rb") as f:
        port_keys = set(pickle.load(f))
    with open(tmp_path / "jax.pkl", "rb") as f:
        assert port_keys == set(pickle.load(f))
    for writer, reader_cls in ((t, JTopicModel), (j, TTopicModel)):
        name = "port.pkl" if writer is t else "jax.pkl"
        r = reader_cls().load(str(tmp_path / name))
        assert (r.num_topics, r.random_state, r.max_iter, r.lda_backend) == (4, 42, 3, "jax")
        np.testing.assert_array_equal(r.lda.components_, writer.lda.components_)
        np.testing.assert_array_equal(r.topic_word_distribution, writer.topic_word_distribution)
        np.testing.assert_array_equal(r.topic_embeddings, writer.topic_embeddings)
        np.testing.assert_array_equal(r.word2vec_model.vectors, writer.word2vec_model.vectors)
        assert r.word2vec_model.index_to_key == writer.word2vec_model.index_to_key
        assert r.vectorizer.vocabulary_ == writer.vectorizer.vocabulary_
        assert (r.vectorizer.min_df, r.vectorizer.max_df) == (1, 1.0)


# -- graph builders -------------------------------------------------------------

def test_build_from_arrays_and_artifacts_equal_jax(tmp_path):
    """The same theta and embeddings: equal edges; the edgelist and both
    CSVs byte-equal to the JAX package's files (the model's top words from
    the committed R8 pickle)."""
    rng = np.random.RandomState(0)
    theta = rng.dirichlet(np.full(50, 0.1), size=300).astype(np.float32)
    emb = rng.randn(50, 100).astype(np.float32)
    jb = jbt.TopicGraphBuilder("x", verbose=False)
    tb = tbt.TopicGraphBuilder("x", verbose=False, device=CPU)
    jg, tg = jb.build_from_arrays(theta, emb), tb.build_from_arrays(theta, emb)
    for k in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    assert (tg.n_doc_topic_edges, tg.n_topic_topic_edges) == (jg.n_doc_topic_edges, jg.n_topic_topic_edges)
    assert tg.n_topic_topic_edges > 0 and tg.n_nodes == 350
    model = "data/graph/R8_topic_model.pkl"
    jbt.write_weighted_edgelist(jg, str(tmp_path / "j.txt"))
    tbt.write_weighted_edgelist(tg, str(tmp_path / "t.txt"))
    jbt.export_protege_csvs(jg, JTopicModel().load(model), str(tmp_path / "j"))
    tbt.export_protege_csvs(tg, TTopicModel().load(model), str(tmp_path / "t"))
    for suffix in (".txt", "_nodes.csv", "_edges.csv"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    np.testing.assert_array_equal(
        tbt.read_weighted_edgelist(str(tmp_path / "t.txt"))[2], jg.weight
    )


def _sorted_edges(g):
    order = np.lexsort((g.dst, g.src))
    return g.src[order], g.dst[order], g.weight[order]


@pytest.mark.parametrize("path", ["numpy", "native"])
def test_textgcn_builder_equals_jax(path, tmp_path, tiny_docs, monkeypatch):
    """The doc-word graph of the tiny corpus (window 5), on the port's numpy
    path (forced) and on its native window counter (its default where a C++
    compiler exists). Either way, against the JAX package's native counter:
    the same edge set after a lexsort, the same weights bit for bit (both
    take the same float64 logs of the same integer counts). On the numpy
    path, against JAX's scipy path: equal COO arrays in order, and the saved
    edgelist and vocabulary byte-equal. On the native path, whose pairs come
    in (i, j) order: the same edge counts, the same vocabulary file, and the
    edgelist's lines the same set."""
    from textgcn_tpu import native
    from textgcn_tpu_torch import native as tnative

    if path == "numpy":
        monkeypatch.setattr(tnative, "available", lambda: False)
    elif not tnative.available():
        pytest.skip("no C++ compiler on PATH")
    tb = tdw.TextGCNGraphBuilder("tiny", window_size=5, verbose=False)
    tg = tb.build(tiny_docs)
    assert tg.n_word_word_edges > 0 and tg.vocab == jdw.build_vocab(tiny_docs)
    ng = jdw.TextGCNGraphBuilder("tiny", window_size=5, verbose=False).build(tiny_docs)
    (ts, td, tw), (ns, nd, nw) = _sorted_edges(tg), _sorted_edges(ng)
    np.testing.assert_array_equal(ts, ns)
    np.testing.assert_array_equal(td, nd)
    np.testing.assert_array_equal(tw, nw)
    monkeypatch.setattr(native, "available", lambda: False)
    jb = jdw.TextGCNGraphBuilder("tiny", window_size=5, verbose=False)
    jg = jb.build(tiny_docs)
    assert (tg.n_doc_word_edges, tg.n_word_word_edges) == (jg.n_doc_word_edges, jg.n_word_word_edges)
    jb.save(str(tmp_path / "j"))
    tb.save(str(tmp_path / "t"))
    vocab = "tiny_docword_vocab.txt"
    assert (tmp_path / "t" / vocab).read_bytes() == (tmp_path / "j" / vocab).read_bytes()
    edges = [(tmp_path / d / "tiny_docword.txt").read_text().splitlines() for d in "tj"]
    if path == "native":
        assert sorted(edges[0]) == sorted(edges[1])
        return
    for k in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(tg, k), getattr(jg, k))
    assert edges[0] == edges[1]
    name = "tiny_docword.txt"
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def test_word_word_pmi_equals_the_jax_scipy_path(tiny_docs, monkeypatch):
    """The port's numpy PMI (forced; the native counter is held in
    ``test_textgcn_builder_equals_jax``) is the JAX package's scipy path:
    equal pairs, and weights within 1e-12 relative, at windows wider and
    narrower than the documents."""
    from textgcn_tpu_torch import native as tnative

    monkeypatch.setattr(tnative, "available", lambda: False)
    vocab = jdw.build_vocab(tiny_docs)
    for w in (3, 20):
        inc = jdw.window_word_incidence(tiny_docs, vocab, w)
        got = tdw.word_word_pmi(tiny_docs, vocab, w)
        assert (tdw.window_word_incidence(tiny_docs, vocab, w) != inc).nnz == 0
        co = (inc.T @ inc).tocoo()
        m = co.row < co.col
        occ = np.asarray(inc.sum(axis=0)).ravel()
        pmi = np.log(co.data[m] * inc.shape[0] / (occ[co.row[m]] * occ[co.col[m]]))
        keep = pmi > 0
        np.testing.assert_array_equal(got[0], co.row[m][keep])
        np.testing.assert_array_equal(got[1], co.col[m][keep])
        np.testing.assert_allclose(got[2], pmi[keep], rtol=1e-12, atol=0)


# -- helpers and config ---------------------------------------------------------

def test_logging_helpers_equal_jax():
    rows = [[1, "a", 2.5], [10, "bcd", -1]]
    assert tlog.format_table(["x", "y", "zz"], rows) == jlog.format_table(["x", "y", "zz"], rows)
    assert tlog.graph_stats(7724, 41018) == jlog.graph_stats(7724, 41018)
    assert tlog.graph_stats(10, 20, directed=True) == jlog.graph_stats(10, 20, directed=True)
    a, b = tlog.LogResult(), jlog.LogResult()
    for r in ({"acc": 0.9, "tag": "x"}, {"acc": 0.8, "tag": "y"}):
        a.update(r)
        b.update(r)
    assert a.show_str() == b.show_str() and "acc: mean=0.8500" in a.show_str()


def test_stage_timer_and_trace(tmp_path):
    timer = tprof.StageTimer()
    for _ in range(2):
        with timer.stage("build"):
            pass
    with timer.stage("train"):
        pass
    assert list(timer.times) == ["build", "train"] and "TOTAL" in timer.report()
    with tprof.trace(str(tmp_path / "tr")):
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    assert tprof.device_memory(CPU) == {}


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_YAMLS = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "experiments", "**", "*.yaml"), recursive=True)
)


def test_seven_committed_experiment_yamls():
    assert len(COMMITTED_YAMLS) == 7


@pytest.mark.parametrize("path", COMMITTED_YAMLS)
def test_experiment_config_loads_the_committed_yamls_as_jax(path):
    """Each committed experiment YAML gives the same dict as the JAX
    package's config, and maps onto the port's ``TrainConfig``."""
    path = os.path.join(REPO, path)
    t = tconfig.ExperimentConfig.from_yaml(path)
    assert t.to_dict() == jconfig.ExperimentConfig.from_yaml(path).to_dict()
    tc = t.train.to_train_config()
    assert isinstance(tc, TrainConfig)
    assert (tc.n_hidden, tc.lr, tc.model, tc.spmm) == (t.train.nhid, t.train.lr, t.train.model, t.train.spmm)


def test_experiment_config_round_trips_through_yaml(tmp_path):
    t = tconfig.ExperimentConfig.from_yaml("experiments/r8_gat.yaml")
    t.to_yaml(str(tmp_path / "c.yaml"))
    assert tconfig.ExperimentConfig.from_yaml(str(tmp_path / "c.yaml")) == t
    assert yaml.safe_load((tmp_path / "c.yaml").read_text())["train"]["model"] == "gat"


@pytest.mark.parametrize("section", [None, "build", "train", "inspect"])
def test_experiment_config_refuses_unknown_keys(section):
    d = {"dataset": "R8"}
    if section is None:
        d["bogus"] = 1
    else:
        d[section] = {"bogus": 1}
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="bogus"):
            mod.ExperimentConfig.from_dict(d)
