"""The build stage's device work (the LDA fit and CBOW training) on a CUDA
device against the same fits on the CPU, and repeated fits against each
other.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_build_cuda.py -q --noconftest

Tests marked ``cuda`` skip where there is no GPU; the others run anywhere.
"""
import numpy as np
import pytest
import torch

from textgcn_tpu_torch.topics.lda import LDA
from textgcn_tpu_torch.topics.vectorize import CountVectorizer
from textgcn_tpu_torch.topics.word2vec import Word2Vec

CPU = torch.device("cpu")


def _corpus(n_docs=400, length=20, seed=0):
    """Three topics of 60 words each, with shared words: documents of
    ``length`` words drawn from one or two topics."""
    rng = np.random.RandomState(seed)
    topics = [[f"w{t}_{i}" for i in range(60)] + [f"shared{i}" for i in range(10)] for t in range(3)]
    docs = []
    for _ in range(n_docs):
        pick = rng.choice(3, size=rng.randint(1, 3), replace=False)
        words = [w for t in pick for w in topics[t]]
        docs.append(" ".join(rng.choice(words, size=length)))
    return docs


@pytest.fixture(scope="module")
def docs():
    return _corpus()


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device side of the build")
    return torch.device("cuda")


def _lda(dtm, device, **kw):
    return LDA(n_components=3, max_iter=6, chunk_size=128, **kw).fit(dtm, device=device)


def _w2v(docs, device):
    return Word2Vec(vector_size=32, epochs=2, batch_size=512, seed=3).fit(docs, device=device)


def test_cpu_fits_repeat_bit_for_bit(docs):
    """Two LDA fits and two CBOW fits from the same seeds on the CPU give
    the same bits (the scatter-adds sum duplicates in order)."""
    dtm = CountVectorizer(min_df=1, max_df=1.0).fit_transform(docs)
    a, b = _lda(dtm, CPU), _lda(dtm, CPU)
    np.testing.assert_array_equal(a.components_, b.components_)
    assert a.bound_trace_ == b.bound_trace_
    np.testing.assert_array_equal(_w2v(docs, CPU).vectors, _w2v(docs, CPU).vectors)


@pytest.mark.cuda
def test_lda_fit_on_cuda_matches_cpu(cuda_dev, docs):
    """4 chunks of 128 docs, 6 EM iterations: lambda within 1e-4 relative
    and the bound trace within 1e-5 relative of the CPU fit's (f32 matmuls
    summed in another order; TF32 is off in the fit); two CUDA fits give the
    same bits."""
    dtm = CountVectorizer(min_df=1, max_df=1.0).fit_transform(docs)
    cpu, gpu = _lda(dtm, CPU), _lda(dtm, cuda_dev)
    assert gpu.n_iter_ == cpu.n_iter_
    np.testing.assert_allclose(gpu.components_, cpu.components_, rtol=1e-4, atol=0)
    np.testing.assert_allclose(gpu.bound_trace_, cpu.bound_trace_, rtol=1e-5, atol=0)
    again = _lda(dtm, cuda_dev)
    np.testing.assert_array_equal(again.components_, gpu.components_)
    streamed = _lda(dtm, cuda_dev, pin_bytes_limit=0)
    np.testing.assert_array_equal(streamed.components_, gpu.components_)


@pytest.mark.cuda
def test_cbow_fit_on_cuda_matches_cpu_and_repeats_bit_for_bit(cuda_dev, docs):
    """2 epochs of 10 batches of 512: the vectors within 1e-4 of the CPU
    fit's (rtol 1e-4), and two CUDA fits bit-equal."""
    cpu, gpu = _w2v(docs, CPU), _w2v(docs, cuda_dev)
    assert gpu.steps_ == cpu.steps_ == 20
    np.testing.assert_allclose(gpu.vectors, cpu.vectors, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_w2v(docs, cuda_dev).vectors, gpu.vectors)
