#!/usr/bin/env python3
"""Where the topic build's time goes on the card, and how its LDA fit
compares with the committed build of the JAX package.

    python scripts/profile_build.py [--docs N] [--em N] [--device cuda]

Run from the root of a checkout. Three measurements on the R8 clean corpus
(``data/text_dataset/clean_corpus/R8.txt`` over the committed model's
vocabulary, which the vectorizer's fit gives on it):

1. The LDA E-step on the first chunk (2,048 documents), from the committed
   model's lambda: host-clock ms an iteration over 100 iterations with the
   loop's one read of the change test an iteration (``topics/lda.py``
   ``_e_step``) and without it (the same body, no read), and the device
   time by operator of 20 iterations under ``torch.profiler``.
2. One epoch of CBOW batches (seed 42, as the builder): the device time by
   operator of 20 ``_cbow_step`` calls under ``torch.profiler``, the most
   repeated index of a batch's context and target slots, and the time of
   the context scatter through ``index_put_(accumulate=True)`` (what the
   port runs on CUDA) against ``index_add_`` (float atomics).
3. The LDA fit (``--em`` EM iterations, 60 as the builder) twice: with the
   port's full-f32 products, and with every product's inputs rounded to
   bf16 and summed in f32 (one bf16 pass, as a TPU's default matmul
   precision takes f32 inputs); each against the committed build: the
   per-word bound trace (``results/R8_lda_elbo_trace.json``), phi
   (``data/graph/R8_topic_model.pkl``) and the doc-topic edges at theta >=
   0.02 (``data/graph/R8_topic.txt``).

It writes nothing. It needs a CUDA device unless ``--device cpu`` is given
(with ``--docs`` and ``--em`` cut, for a rehearsal).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from textgcn_tpu_torch.graph.build_topic import read_weighted_edgelist  # noqa: E402
from textgcn_tpu_torch.topics import lda as L  # noqa: E402
from textgcn_tpu_torch.topics import word2vec as W  # noqa: E402
from textgcn_tpu_torch.topics.model import TopicModel, load_documents_from_file  # noqa: E402

CORPUS = "data/text_dataset/clean_corpus/R8.txt"
MODEL = "data/graph/R8_topic_model.pkl"
N_DOCS = 7674


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def profile_table(fn, dev, rows=8):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        sync(dev)
    key = "cuda_time_total" if dev.type == "cuda" else "cpu_time_total"
    return prof.key_averages().table(sort_by=key, row_limit=rows)


def e_step_phase(dtm, lam, dev):
    lda = L.LDA(n_components=lam.shape[0])
    lda.components_ = lam
    with L.full_f32():
        eb = lda._exp_elog_beta(dev)
        x = torch.from_numpy(next(lda._chunks(dtm))[2]).to(dev)
        g0 = lda._gamma0(np.random.RandomState(0), dev)
        alpha = float(lda._priors()[0])

        def no_read():
            xf, g = x.float(), g0
            for _ in range(100):
                eg = L._dirichlet_expectation_exp(g)
                ng = alpha + eg * ((xf / (eg @ eb + 1e-100)) @ eb.T)
                (ng - g).abs().mean(dim=-1).max()
                g = ng

        for name, fn in (
            ("with the read", lambda: L._e_step(x, g0, eb, alpha, max_iters=100, tol=-1.0)),
            ("without it", no_read),
        ):
            for _ in range(2):  # the second run is the one timed
                sync(dev)
                t0 = time.perf_counter()
                fn()
                sync(dev)
            print(f"[e-step] 100 iterations {name}: "
                  f"{(time.perf_counter() - t0) * 10:.4f} ms an iteration", flush=True)
        print("[e-step] 20 iterations by operator:\n" + profile_table(
            lambda: L._e_step(x, g0, eb, alpha, max_iters=20, tol=-1.0), dev), flush=True)


def cbow_phase(docs, dev):
    w = W.Word2Vec(seed=42)
    sents = [d.split() for d in docs]
    w._build_vocab(sents)
    w._encode(sents)
    rng = np.random.RandomState(42)
    centers, ctxs, masks = w._examples(rng)
    noise = w.counts ** w.ns_exponent
    noise = noise / noise.sum()
    sel, neg = w._epoch_batches(rng, len(centers), noise)
    v, b = len(w.vocab), w.batch_size
    gen = torch.Generator(device=dev).manual_seed(0)
    w_in = torch.randn((v, w.vector_size), generator=gen, device=dev) * 0.01
    w_out = torch.zeros((v, w.vector_size), device=dev)
    c = torch.from_numpy(centers[sel].astype(np.int64)).to(dev)
    x = torch.from_numpy(ctxs[sel].astype(np.int64)).to(dev)
    m = torch.from_numpy(masks[sel]).to(dev)
    n = torch.from_numpy(neg.astype(np.int64)).to(dev)
    steps = min(20, len(sel) // b)

    def run(k):
        for i in range(k):
            s = slice(i * b, (i + 1) * b)
            W._cbow_step(w_in, w_out, c[s], x[s], m[s], n[s], 0.02)

    run(min(3, steps))
    ctx = x[:b].reshape(-1)
    real = m[:b].reshape(-1) > 0
    tgt = torch.cat([c[:b, None], n[:b]], dim=1).reshape(-1)
    print(f"[cbow] {len(centers)} examples, {len(sel) // b} steps an epoch; a batch's most "
          f"repeated index: context slots {int(torch.bincount(ctx).max())} of {ctx.numel()} "
          f"({int(torch.bincount(ctx[real]).max())} of {int(real.sum())} real), target slots "
          f"{int(torch.bincount(tgt).max())} of {tgt.numel()}", flush=True)
    print(f"[cbow] {steps} steps by operator:\n" + profile_table(lambda: run(steps), dev), flush=True)
    rows = torch.randn((int(real.sum()), w.vector_size), generator=gen, device=dev)
    for name, fn in (("index_put_(accumulate=True)", lambda t: t.index_put_((ctx[real],), rows, accumulate=True)),
                     ("index_add_", lambda t: t.index_add_(0, ctx[real], rows))):
        fn(w_in)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(20):
            fn(w_in)
        sync(dev)
        print(f"[cbow] the context scatter of a batch ({int(real.sum())} rows) by {name}: "
              f"{(time.perf_counter() - t0) * 50:.4f} ms", flush=True)


def bf16_e_step(x, gamma0, eb, alpha, max_iters=100, tol=1e-3, iters=None):
    """``lda._e_step`` with each product's inputs rounded to bf16."""
    def bf(a):
        return a.to(torch.bfloat16).float()

    x = x.to(torch.float32)
    gamma, n = gamma0, 0
    for n in range(1, max_iters + 1):
        eg = L._dirichlet_expectation_exp(gamma)
        ratio = x / (bf(eg) @ bf(eb) + 1e-100)
        new = alpha + eg * (bf(ratio) @ bf(eb).T)
        change = (new - gamma).abs().mean(dim=-1).max()
        gamma = new
        if not bool(change > tol):
            break
    if iters is not None:
        iters.append(n)
    eg = L._dirichlet_expectation_exp(gamma)
    phinorm = bf(eg) @ bf(eb)
    ratio = x / (phinorm + 1e-100)
    return gamma, bf(eg).T @ bf(ratio), (x * torch.log(phinorm + 1e-100)).sum()


def precision_phase(dtm, committed, em, n_docs, dev):
    with open("results/R8_lda_elbo_trace.json") as fh:
        ref = np.asarray(json.load(fh)["per_word_bound_trace"])
    src, dst, _ = read_weighted_edgelist("data/graph/R8_topic.txt")
    dt = (src < N_DOCS) & (src < n_docs)
    want = set(zip(src[dt].tolist(), dst[dt].tolist()))
    real = L._e_step
    try:
        for name, fn in (("f32 products", real), ("bf16-rounded products", bf16_e_step)):
            L._e_step = fn
            t0 = time.perf_counter()
            lda = L.LDA(n_components=50, max_iter=em).fit(dtm, device=dev)
            theta = lda.transform(dtm, device=dev)
            secs = time.perf_counter() - t0
            tr = np.asarray(lda.bound_trace_)
            phi = lda.components_ / lda.components_.sum(axis=1, keepdims=True)
            d, k = np.nonzero(theta >= 0.02)
            got = set(zip(d.tolist(), (N_DOCS + k).tolist()))
            print(f"[precision] {name}: fit + theta {secs:.1f} s; bound vs the committed trace: "
                  f"max |diff| {np.abs(tr - ref[:len(tr)]).max():.3e} over {len(tr)}, final "
                  f"{tr[-1]:.6f} (committed {ref[len(tr) - 1]:.6f}); phi max |diff| "
                  f"{np.abs(phi - committed.topic_word_distribution).max():.3e}; doc-topic "
                  f"edges {len(got)} (committed {len(want)}), Jaccard "
                  f"{len(got & want) / max(len(got | want), 1):.4f}", flush=True)
    finally:
        L._e_step = real


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--docs", type=int, default=N_DOCS, help="the corpus's first N documents")
    p.add_argument("--em", type=int, default=60, help="EM iterations of the fits in 3")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("profile_build: no CUDA device available", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip()
        print(f"[device] {smi}; torch {torch.__version__}", flush=True)
    docs = load_documents_from_file(CORPUS)[: args.docs]
    committed = TopicModel().load(MODEL)
    # the committed vocabulary: the one the vectorizer's fit gives on the
    # whole corpus, so a cut corpus keeps the committed model's columns
    dtm = committed.vectorizer.transform(docs)
    e_step_phase(dtm, committed.lda.components_, dev)
    cbow_phase(docs, dev)
    precision_phase(dtm, committed, args.em, args.docs, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
