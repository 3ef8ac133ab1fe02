"""The span recorder (``textgcn_tpu_torch/utils/profiling.py``) and its
sites in the streamed step: ``step`` (``train/streamtape.py``), ``pass``,
``chunk.fetch``, ``chunk.feed``, ``chunk.sync``
(``ops/streamed_sorted.py``) and ``k2.launch`` (``ops/row_reduce.py``); and
in the resident epoch: ``step``, ``train``, ``eval``
(``train/trainer.py`` ``Trainer.epoch``), ``hybrid.pass``
(``graph/reorder.py``) and ``k1.launch`` (``ops/bsr_spmm.py``).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. On a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_spans.py -q --noconftest

Tests marked ``cuda`` skip where there is no GPU; the others run anywhere.
On the CPU a pass has no lookahead copies and K2's wrapper runs its plain
version, so the CPU step records ``step``, ``pass`` and ``chunk.fetch``;
the other three names are checked on the card.
"""
import gc
import time
from collections import Counter

import numpy as np
import pytest
import torch

from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.ops.bsr_spmm import bsr_spmm
from textgcn_tpu_torch.ops.row_reduce import row_reduce
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import streamed as st
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.utils import profiling

N_CHUNKS, W_SC, W, CELL_E = 5, 2, 8, 16
# streamed passes a step at init_streamed's depths
PASSES = {"gcn": 4, "sgc": 4, "appnp": 20, "sage": 4, "gin": 4, "gcnii": 16}


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    profiling.record_spans(False)
    yield
    profiling.record_spans(False)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _step(source, family, dev, n):
    """A family's streamed step over ``source`` and its inputs on ``dev``."""
    f, h, c = 6, 4, 3
    gen = torch.Generator(device=dev).manual_seed(0)
    params, opt = st.init_streamed(gen, f, h, c, device=dev, family=family)
    step = st.STREAMED_SEGMENTED_FACTORIES[family](st.make_sorted_stream(source), n, opt)
    x = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randint(0, c, (n,), generator=gen, device=dev)
    mask = torch.ones(n, device=dev)
    return lambda: step(params, x, y, mask)


def _cpu_step(family="gcn"):
    lat = ss.make_lattice_stream(N_CHUNKS, W_SC, W, CELL_E, seed=1, device="cpu")
    src = ss.CachedChunkSource(lat.chunk, len(lat), 1 << 30, "cpu")
    return _step(src, family, torch.device("cpu"), lat.n_rows)


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_recorder_nests_spans_and_numbers_steps():
    assert not profiling.spans_on
    profiling.leaf("lost", time.time_ns())  # off: recorded nowhere
    assert profiling.record_spans(True) == []
    a = profiling.begin("step", step=True)
    b = profiling.begin("pass")
    profiling.leaf("chunk.fetch", time.time_ns())
    profiling.end(b, chunks=1)
    profiling.end(a)
    c = profiling.begin("step", step=True)
    profiling.leaf("k2.launch", time.time_ns())
    profiling.end(c)
    profiling.leaf("outside", time.time_ns())
    open_at_switch = profiling.begin("pass")
    spans = profiling.record_spans(False)
    profiling.end(open_at_switch)  # begun before the switch: left alone
    assert [s.name for s in spans] == [
        "step", "pass", "chunk.fetch", "step", "k2.launch", "outside", "pass"]
    assert [s.parent for s in spans] == [-1, 0, 1, -1, 3, -1, -1]
    s0, s1 = spans[0].step, spans[3].step
    assert s0 >= 0 and s1 > s0
    assert [s.step for s in spans] == [s0, s0, s0, s1, s1, -1, -1]
    assert spans[1].attrs == {"chunks": 1} and spans[2].attrs == {}
    for s in spans[:-1]:
        assert 0 < s.start_ns <= s.end_ns
    assert spans[0].start_ns <= spans[1].start_ns and spans[1].end_ns <= spans[0].end_ns
    assert spans[-1].end_ns == 0
    assert profiling.record_spans(False) == []


def test_recording_adds_nothing_the_collector_tracks():
    """A thousand spans add no object to the cyclic collector's lists: a
    tracked object a span ran the collector every few hundred chunks, and
    its full runs cost a GCN step 10-25 ms on the card."""
    gc.collect()
    gc.disable()
    try:
        profiling.record_spans(True)
        before = len(gc.get_objects())
        for _ in range(1000):
            span = profiling.begin("pass")
            profiling.leaf("chunk.fetch", time.time_ns())
            profiling.end(span, chunks=1)
        after = len(gc.get_objects())
    finally:
        gc.enable()
    assert after - before < 10
    spans = profiling.record_spans(False)
    assert len(spans) == 2000 and spans[-2].attrs == {"chunks": 1}


def test_streamed_step_records_nothing_while_off():
    step = _cpu_step()
    step()
    assert profiling.record_spans(False) == []
    profiling.record_spans(True)
    profiling.record_spans(False)
    step()
    assert profiling.record_spans(False) == []


@pytest.mark.parametrize("family", sorted(PASSES))
def test_streamed_step_spans_nest_in_one_step_each(family):
    """Two steps: each a ``step`` span with its own id, holding the
    family's passes; the cache holds the whole lattice, so each pass takes
    its chunks as one run (``batched`` is every chunk) and holds one
    ``chunk.fetch`` for the run and one that finds the source's end; the
    pass reduces every chunk of the lattice."""
    step = _cpu_step(family)
    step()  # the first pass fills the cache
    profiling.record_spans(True)
    step()
    step()
    spans = profiling.record_spans(False)
    assert set(Counter(s.name for s in spans)) == {"step", "pass", "chunk.fetch"}
    steps = [i for i, s in enumerate(spans) if s.name == "step"]
    assert len(steps) == 2 and len({spans[i].step for i in steps}) == 2
    for i in steps:
        passes = [j for j, s in enumerate(spans) if s.name == "pass" and s.parent == i]
        assert len(passes) == PASSES[family]
        for j in passes:
            p = spans[j]
            assert p.step == spans[i].step
            assert p.attrs == {"chunks": N_CHUNKS, "batched": N_CHUNKS, "launches": 0,
                               "copies": 0}
            kids = _children(spans, j)
            assert [k.name for k in kids] == ["chunk.fetch"] * 2
            assert all(k.step == p.step for k in kids)
            assert all(p.start_ns <= k.start_ns <= k.end_ns <= p.end_ns for k in kids)
    assert {s.parent for s in spans if s.name == "pass"} == set(steps)


@pytest.mark.parametrize("kept", [0, 2, N_CHUNKS])
def test_pass_span_counts_the_chunks_reduced_in_runs(kept):
    """``batched`` is the chunks that the cache keeps (one run of the
    first ``kept``), once the first pass has filled it; ``chunks`` counts
    every chunk either way."""
    lat = ss.make_lattice_stream(N_CHUNKS, W_SC, W, CELL_E, seed=1, device="cpu")
    host = list(lat)
    budget = sum(c.nbytes for c in host[:kept])
    src = ss.CachedChunkSource(host.__getitem__, len(host), budget, "cpu")
    step = _step(src, "gcn", torch.device("cpu"), lat.n_rows)
    profiling.record_spans(True)
    step()
    passes = [s.attrs for s in profiling.record_spans(False) if s.name == "pass"]
    runs = {"batched": kept, "chunks": N_CHUNKS, "launches": 0, "copies": 0}
    assert passes == [{**runs, "batched": 0}] + [runs] * 3


def test_span_clock_is_the_profilers():
    """A span around a torch op holds the op's profiler event: the two
    clocks agree to within ``TOL_NS``. Another clock (``perf_counter``,
    the monotonic clock) would miss by the machine's uptime or the epoch."""
    from torch.profiler import ProfilerActivity, profile

    TOL_NS = 200_000
    a = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.record_spans(True)
        span = profiling.begin("pass")
        torch.mm(a, a)
        profiling.end(span)
        (s,) = profiling.record_spans(False)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(events) == 1
    e0 = events[0].start_ns()
    e1 = e0 + events[0].duration_ns()
    assert s.start_ns - TOL_NS <= e0 <= e1 <= s.end_ns + TOL_NS


@pytest.mark.cuda
def test_cuda_pass_counts_launches_and_copies(cuda_dev):
    """A half-cached source on the card: every pass records the six names
    inside it, ``launches`` equals the change of ``row_reduce.launches``
    (one K2 launch for the run of cached chunks and one a host chunk),
    ``batched`` the chunks of the run (and of ``row_reduce.batched_chunks``),
    ``copies`` the chunks the cache does not keep (each a ``chunk.feed``
    and a ``chunk.sync``, and a host load of the source), and every K2
    launch is a ``k2.launch``."""
    lat = ss.make_lattice_stream(N_CHUNKS, W_SC, W, CELL_E, seed=1, device="cpu")
    host = [c.pin_memory() for c in lat]
    kept = 2
    budget = sum(c.nbytes for c in host[:kept])
    src = ss.CachedChunkSource(host.__getitem__, len(host), budget, cuda_dev)
    step = _step(src, "gcn", cuda_dev, lat.n_rows)
    step()
    torch.cuda.synchronize()
    launches, loads = row_reduce.launches, src.host_loads
    batched = row_reduce.batched_chunks
    profiling.record_spans(True)
    step()
    torch.cuda.synchronize()
    spans = profiling.record_spans(False)
    copies = N_CHUNKS - kept
    names = Counter(s.name for s in spans)
    assert names == {"step": 1, "pass": 4, "chunk.fetch": 4 * (copies + 2),
                     "chunk.feed": 4 * copies, "chunk.sync": 4 * copies,
                     "k2.launch": 4 * (copies + 1)}
    passes = [j for j, s in enumerate(spans) if s.name == "pass"]
    for j in passes:
        assert spans[j].attrs == {"chunks": N_CHUNKS, "batched": kept, "launches": copies + 1,
                                  "copies": copies}
        kids = Counter(k.name for k in _children(spans, j))
        assert kids == {"chunk.fetch": copies + 2, "chunk.feed": copies,
                        "chunk.sync": copies, "k2.launch": copies + 1}
    assert sum(spans[j].attrs["launches"] for j in passes) == row_reduce.launches - launches
    assert sum(spans[j].attrs["batched"] for j in passes) == row_reduce.batched_chunks - batched
    assert sum(spans[j].attrs["copies"] for j in passes) == src.host_loads - loads


HYBRID_ATTRS = {"width", "tiles", "residual_edges", "launches"}


def _powerlaw_hybrid(device, n=700, e=24000, n_class=4, seed=0):
    """A sym-normalized power-law graph with identity features, in the
    hybrid layout: dense hub tiles through K1 and a residual through K2."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -1.0
    p /= p.sum()
    r, c, v = max_symmetrize_coo(rng.choice(n, e, p=p), rng.choice(n, e, p=p), rng.rand(e), n)
    r, c, v = sym_normalize_coo(r, c, v, n)
    labels = DatasetLabels(target=rng.randint(0, n_class, n),
                           label_names=[str(k) for k in range(n_class)],
                           train_idx=np.arange(0, n, 2), test_idx=np.arange(1, n, 2))
    pre = tprepare.PreparedData(graph=SparseGraph.from_coo(r, c, v, n, device=device),
                                features=None, labels=labels, n_feat=n, num_docs=n,
                                num_topics=0)
    return tprepare.apply_spmm_format(pre, "hybrid")


def _epoch_spans(device):
    """One recorded ``Trainer.epoch`` at hidden 200 over the power-law
    graph: the layout, the spans, and the epoch to run again."""
    pre = _powerlaw_hybrid(device)
    g = pre.graph
    assert g.bsr.nnzb > 0 and g.rest is not None and g.rest.n_edges > 0
    cfg = ttrainer.TrainConfig(n_hidden=200, seed=11, spmm="hybrid")
    t = ttrainer.Trainer(g, None, pre.labels.target, pre.labels.train_idx,
                         pre.labels.test_idx, pre.labels.n_classes, config=cfg, device=device,
                         perm=pre.perm)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = ttrainer.model_class(cfg.model, g)(
        pre.n_nodes, cfg.n_hidden, t.num_classes, cfg.dropout, device=device, generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    train_idx = torch.tensor(pre.labels.train_idx, dtype=torch.int64, device=device)
    val_idx = torch.tensor(pre.labels.test_idx, dtype=torch.int64, device=device)

    def epoch():
        return t.epoch(model, opt, gen, train_idx, val_idx)

    epoch()  # builds what the first call builds
    profiling.record_spans(True)
    try:
        epoch()
    finally:
        got = profiling.record_spans(False)
    return g, got, epoch


def test_a_recorded_epoch_holds_a_step_and_six_hybrid_passes():
    """One ``step`` span with a ``train`` span (the four passes of the
    train step) and an ``eval`` span (the eval forward's two); each
    ``hybrid.pass`` carries its width, tiles, residual edges and launches
    (none on the CPU, where the kernels' plain versions run)."""
    g, got, _ = _epoch_spans(torch.device("cpu"))
    assert Counter(s.name for s in got) == {"step": 1, "train": 1, "eval": 1, "hybrid.pass": 6}
    (step,) = [i for i, s in enumerate(got) if s.name == "step"]
    assert all(s.step == got[step].step for s in got)
    kids = {s.name: i for i, s in enumerate(got) if s.parent == step}
    assert set(kids) == {"train", "eval"}
    widths = {k: [s.attrs["width"] for s in got if s.name == "hybrid.pass" and s.parent == i]
              for k, i in kids.items()}
    assert widths == {"train": [208, 16, 16, 208], "eval": [208, 16]}
    for s in got:
        if s.name == "hybrid.pass":
            assert set(s.attrs) == HYBRID_ATTRS
            assert s.attrs["tiles"] == g.bsr.nnzb
            assert s.attrs["residual_edges"] == g.rest.n_edges
            assert s.attrs["launches"] == 0
            assert got[s.parent].start_ns <= s.start_ns <= s.end_ns <= got[s.parent].end_ns


@pytest.mark.cuda
def test_on_the_card_each_pass_launches_k1_and_k2():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc: the CUDA kernels have no CPU mode")
    _, got, epoch = _epoch_spans(torch.device("cuda"))
    passes = [i for i, s in enumerate(got) if s.name == "hybrid.pass"]
    assert len(passes) == 6
    for i in passes:
        assert got[i].attrs["launches"] == 2
        assert sorted(s.name for s in got if s.parent == i) == ["k1.launch", "k2.launch"]
    k1, k2 = bsr_spmm.launches, row_reduce.launches
    epoch()
    assert (bsr_spmm.launches - k1, row_reduce.launches - k2) == (6, 6)
