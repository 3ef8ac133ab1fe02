"""The stream's runs: ``CachedChunkSource.run_plan`` / ``runs``, which
group the cached chunks that one K2 launch can reduce
(``ops/row_reduce.py`` ``reduce_run``), and the pass that walks them
(``ops/streamed_sorted.py`` ``streamed_sorted_add_``). The plan is host
logic; on the CPU a run's chunks go through the plain reduce one by one,
so a pass over runs must equal the per-chunk pass bit for bit. The kernel
is held against the per-chunk calls on the card
(``tests/test_torch_kernels.py``). No JAX import.
"""
import itertools
import pickle

import pytest
import torch

from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.ops.row_reduce import (
    RUN_TILE_ROWS, ReduceRun, reduce_run, row_reduce_plain, run_tile_prefix,
)
from textgcn_tpu_torch.utils import profiling
from torch_stream_chunks import N_ROWS, PLAN, RUNS, SPLIT, UNCACHED, broken_runs

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.record_spans(False)
    yield
    profiling.record_spans(False)


def _source(budget=None, seed=0):
    chunks, fits = broken_runs(seed)
    src = ss.CachedChunkSource(chunks.__getitem__, len(chunks), fits if budget is None else budget,
                               CPU)
    return chunks, src


def _x(f=6, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((N_ROWS, f), generator=gen).to(torch.bfloat16)


def _shape(plan):
    """The plan with each run as the tuple of its chunks' first rows."""
    return [tuple(r0 for *_, r0 in p.csrs) if isinstance(p, ReduceRun) else p for p in plan]


def _pass(chunks, x, reduce=ss.row_reduce):
    """One pass and its ``pass`` span's attributes."""
    profiling.record_spans(True)
    acc = torch.zeros((x.shape[0], x.shape[1]), dtype=torch.float32)
    ss.streamed_sorted_add_(acc, chunks, x, reduce)
    (span,) = [s for s in profiling.record_spans(False) if s.name == "pass"]
    return acc, span.attrs


def test_consecutive_cache_hits_form_one_run():
    lat = ss.make_lattice_stream(5, 2, 8, 16, seed=1, device="cpu")
    src = ss.CachedChunkSource(lat.chunk, len(lat), 1 << 30, CPU)
    list(src)
    (run,) = src.run_plan()
    assert [r0 for *_, r0 in run.csrs] == [c.r0 for c in lat]
    assert run.n_chunks == 5 and run.n_rows == run.r_end == lat.n_rows
    assert run.table is None  # on the CPU the plain reduce needs no device table
    cached = [src._cache[i] for i in range(5)]
    # the run holds the cached chunks themselves: nothing is copied
    for (row_ptr, col, val, _), c in zip(run.csrs, cached):
        assert row_ptr is c.row_ptr and col is c.col and val is c.val


@pytest.mark.parametrize("closer", ["uncached", "split", "overlap"])
def test_a_run_closes_at(closer):
    """A chunk the cache does not keep and a cached chunk with a split
    table each take a call of their own between runs; a chunk whose rows
    overlap the run's starts a new run."""
    chunks, src = _source()
    list(src)
    shape = _shape(src.run_plan())
    want = [tuple(chunks[k].r0 for k in p) if isinstance(p, tuple) else p for p in PLAN]
    assert shape == want
    at = {"uncached": UNCACHED, "split": SPLIT}.get(closer)
    if at is not None:
        i = shape.index(at)
        assert isinstance(shape[i - 1], tuple) and isinstance(shape[i + 1], tuple)
        assert (at in src._cache) == (closer == "split")
    else:
        five, six = chunks[RUNS[2][0]], chunks[RUNS[3][0]]
        assert six.r0 < five.r0 + five.rows
        assert shape[-2:] == [(five.r0,), (six.r0, chunks[7].r0)]


def test_a_zero_budget_gives_no_runs():
    chunks, src = _source(budget=0)
    list(src)
    assert src.run_plan() == list(range(len(chunks)))
    assert src.runs(CPU) is None
    _, attrs = _pass(src, _x())
    assert attrs["batched"] == 0 and attrs["chunks"] == len(chunks)


def test_no_runs_before_a_pass_has_gone_through_every_chunk():
    chunks, src = _source()
    assert src.run_plan() is None and src.runs(CPU) is None
    list(itertools.islice(src, 3))  # a pass cut short: the cache may still grow
    assert src.run_plan() is None
    list(src)
    assert len(src.run_plan()) == len(PLAN)
    assert src.runs(torch.device("meta")) is None  # runs lie on the source's device


@pytest.mark.parametrize("wrap", ["iter", "islice", "list"])
def test_iterators_of_a_source_take_the_per_chunk_path(wrap):
    """Only the source itself offers runs: an iterator over it, the
    ``islice`` of the planted fault and a list of its chunks take a call a
    chunk, with the same result."""
    chunks, src = _source()
    x = _x()
    first, attrs = _pass(src, x)
    assert attrs["batched"] == 0  # the first pass fills the cache
    runs, attrs = _pass(src, x)
    assert attrs["batched"] == sum(len(r) for r in RUNS)
    wrapped = {"iter": lambda: iter(src), "islice": lambda: itertools.islice(src, 0, None),
               "list": lambda: list(src)}[wrap]()
    got, attrs = _pass(wrapped, x)
    assert attrs == {"chunks": len(chunks), "batched": 0, "launches": 0, "copies": 0}
    assert torch.equal(got, first) and torch.equal(runs, first)


def test_host_loads_keep_their_meaning():
    """The first pass loads every chunk, each later one the chunk the cache
    does not keep, whether the pass walks runs or not."""
    chunks, src = _source()
    x = _x()
    for _ in range(3):
        _pass(src, x)
    assert src.host_loads == len(chunks) + 2
    _pass(src, x, reduce=row_reduce_plain)  # no runs: a call a chunk
    assert src.host_loads == len(chunks) + 3
    assert src.cached_bytes == sum(c.nbytes for k, c in enumerate(chunks) if k != UNCACHED)


@pytest.mark.parametrize("budget", ["all", "fits", "none"])
@pytest.mark.parametrize("f", [2, 6, 16])
def test_cpu_pass_over_runs_equals_the_per_chunk_pass(budget, f):
    chunks, fits = broken_runs(seed=3)
    b = {"all": 1 << 30, "fits": fits, "none": 0}[budget]
    src = ss.CachedChunkSource(chunks.__getitem__, len(chunks), b, CPU)
    x = _x(f, seed=4)
    want = ss.spmm_streamed_sorted(chunks, x)
    for _ in range(3):
        assert torch.equal(ss.spmm_streamed_sorted_hostfed(src, x), want)


def _csr(r0=0, rows=3, edges=4, col_dtype=torch.int32, val_dtype=torch.float32):
    row_ptr = torch.tensor([0] + [edges] * rows, dtype=torch.int32)
    return (row_ptr, torch.zeros(edges, dtype=col_dtype), torch.ones(edges, dtype=val_dtype), r0)


@pytest.mark.parametrize("bad, match", [
    ([_csr(0, 3), _csr(2, 3)], "overlap"),
    ([_csr(5, 3), _csr(0, 3)], "precede"),
    ([_csr(col_dtype=torch.int64)], "int32"),
    ([_csr(val_dtype=torch.float64)], "float32"),
    ([(*_csr()[:2], torch.ones(3), 0)], "one entry per edge"),
    ([], "at least one"),
])
def test_reduce_run_checks_its_csrs_once(bad, match):
    with pytest.raises((TypeError, ValueError), match=match):
        reduce_run(bad)


def test_a_run_pickles_by_building_its_table_again():
    run = reduce_run([_csr(0, 3), _csr(3, 2), _csr(9, 1)])
    assert (run.n_rows, run.r_end, run.n_chunks) == (6, 10, 3)
    back = pickle.loads(pickle.dumps(run))
    assert (back.n_rows, back.r_end, back.n_chunks, back.device) == (6, 10, 3, CPU)
    for a, b in zip(run.csrs, back.csrs):
        assert all(torch.equal(s, t) for s, t in zip(a[:3], b[:3])) and a[3] == b[3]


T = RUN_TILE_ROWS


@pytest.mark.parametrize("rows", [
    [0], [1], [T], [T + 1], [3 * T, 0, 1, T + 1, 0],
    [0, 0, 2 * T - 1, 1, 5 * T, T + 1], [16384] * 3,
])
def test_run_tile_prefix_puts_every_row_in_one_tile(rows):
    """The run kernel's tiles, walked as its producer walks them (binary
    search over the prefix for the CSR, then the tile's first row and row
    count): every row of every CSR lies in exactly one tile, and the prefix
    is the tiles summed before each CSR."""
    prefix = run_tile_prefix(rows)
    assert len(prefix) == len(rows) + 1 and prefix[0] == 0
    seen = [[0] * r for r in rows]
    for t in range(prefix[-1]):
        lo, hi = 0, len(rows)  # the kernel's search: prefix[lo] <= t < prefix[lo + 1]
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if prefix[mid] <= t else (lo, mid)
        assert prefix[lo] <= t < prefix[lo + 1]
        i0 = (t - prefix[lo]) * T
        n = min(T, rows[lo] - i0)
        assert n >= 1
        for i in range(i0, i0 + n):
            seen[lo][i] += 1
    assert all(c == 1 for s in seen for c in s)
    for k, r in enumerate(rows):
        assert prefix[k + 1] - prefix[k] == -(-r // T)


def test_a_run_counts_its_tiles():
    rows = [3, 0, T + 1, 2 * T]
    csrs, r0 = [], 0
    for r in rows:
        csrs.append(_csr(r0, r))
        r0 += r
    run = reduce_run(csrs)
    assert run.n_tiles == run_tile_prefix(rows)[-1] == 1 + 0 + 2 + 2
    assert pickle.loads(pickle.dumps(run)).n_tiles == run.n_tiles
