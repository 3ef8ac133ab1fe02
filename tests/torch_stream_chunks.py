"""Host chunks whose cached runs break in every way a run can break, for
the tests of the stream's runs (``tests/test_torch_stream_runs.py`` on the
CPU, ``tests/test_torch_kernels.py`` on the card). No JAX import.

Eight row-sorted chunks over 1,200 rows, a quarter of the rows empty:

====  ===========  =============================================
chunk  rows         why
====  ===========  =============================================
0      0-199        cached
1      200-399      cached: one run with chunk 0
2      400-799      24,000 edges, past what the budget leaves: loaded on every pass
3      800-899      cached: a run alone
4      900-999      a row of 1,500 edges, so a split table: a call of its own
5      1000-1099    cached: a run alone
6      1050-1149    overlaps chunk 5: starts a new run
7      1150-1199    cached: joins chunk 6's run
====  ===========  =============================================

With :data:`BUDGET` of :func:`broken_runs` a :class:`CachedChunkSource`
keeps every chunk but chunk 2. Its plan is four runs (0-1, 3, 5, 6-7) and
two chunks (2 and 4): six K2 launches a pass.
"""
import numpy as np
import torch

from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.ops.row_reduce import row_split

N_ROWS = 1200
BOUNDS = [(0, 200), (200, 400), (400, 800), (800, 900), (900, 1000), (1000, 1100),
          (1050, 1150), (1150, 1200)]
UNCACHED, SPLIT = 2, 4
RUNS = [(0, 1), (3,), (5,), (6, 7)]  # the chunks of each run, in order
PLAN = [RUNS[0], UNCACHED, RUNS[1], SPLIT, RUNS[2], RUNS[3]]


def _chunk(rng, r0, r1, degree, hub=0):
    """Rows [r0, r1) with ``degree``-mean edges, a quarter of them empty,
    and row ``r0 + 10`` of ``hub`` edges when ``hub``."""
    deg = rng.integers(1, 2 * degree, r1 - r0) * (rng.random(r1 - r0) >= 0.25)
    if hub:
        deg[10] = hub
    rp = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.integers(0, N_ROWS, rp[-1]).astype(np.int32)
    val = (rng.random(rp[-1]) / np.sqrt(np.repeat(np.maximum(deg, 1), deg))).astype(np.float32)
    row_ptr = torch.from_numpy(rp)
    return ss.SortedChunk(row_ptr, torch.from_numpy(col), torch.from_numpy(val), r0,
                          row_split(row_ptr))


def broken_runs(seed=0):
    """``(chunks, budget)``: the host chunks of the table above and the
    byte budget that caches all but chunk 2."""
    rng = np.random.default_rng(seed)
    chunks = []
    for k, (r0, r1) in enumerate(BOUNDS):
        degree = 60 if k == UNCACHED else 15
        chunks.append(_chunk(rng, r0, r1, degree, hub=1500 if k == SPLIT else 0))
    assert [c.split is not None for c in chunks] == [k == SPLIT for k in range(len(chunks))]
    budget = sum(c.nbytes for k, c in enumerate(chunks) if k != UNCACHED)
    # in order, chunk 2 does not fit beside chunks 0 and 1, and all the rest do
    assert chunks[0].nbytes + chunks[1].nbytes + chunks[UNCACHED].nbytes > budget
    return chunks, budget
