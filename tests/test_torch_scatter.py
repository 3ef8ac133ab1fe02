"""The port's deterministic scatter-add (``textgcn_tpu_torch/ops/scatter.py``)
and the segment ops moved onto it, on the CPU.

On the CPU the helper is ``index_add_``, as the segment ops were before it:
the results must be the same bits as ``index_add_``'s. Its CUDA branch
(``index_put_(accumulate=True)``, the same bits every call) is held in
``tests/test_torch_kernels.py`` (marked ``cuda``)."""
import numpy as np
import pytest
import torch

from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import gat as tgat
from textgcn_tpu_torch.ops.scatter import add_rows, add_rows_
from textgcn_tpu_torch.ops.spmm import spmm_coo_segment
from textgcn_tpu_torch.topics import word2vec


def _rows(shape, n=50, e=4000, seed=0):
    """``e`` rows of ``shape[1:]`` (or scalars) at indices below ``n``,
    most indices repeated many times."""
    rng = np.random.RandomState(seed)
    idx = torch.from_numpy(rng.zipf(1.3, e) % n)
    rows = torch.from_numpy(rng.randn(e, *shape).astype(np.float32))
    return idx, rows


@pytest.mark.parametrize("shape", [(), (7,), (3, 5)], ids=["scalars", "rows", "blocks"])
def test_add_rows_is_index_add_on_the_cpu(shape):
    """In place and out of place, the bits of ``index_add_``; the out-of-place
    form's gradient is the gather of the cotangent."""
    idx, rows = _rows(shape)
    base = torch.randn(50, *shape)
    want = base.clone().index_add_(0, idx, rows)
    w = base.clone()
    assert add_rows_(w, idx, rows) is w
    assert torch.equal(w, want)
    r = rows.clone().requires_grad_(True)
    got = add_rows(50, idx, r)
    assert torch.equal(got, torch.zeros(50, *shape).index_add_(0, idx, rows))
    cot = torch.randn(got.shape)
    got.backward(cot)
    assert torch.equal(r.grad, cot[idx])


def _coo(n=120, e=3000, seed=1):
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.zipf(1.5, e) % n, np.full(5, n)])  # padding edges
    col = np.concatenate([rng.randint(0, n, e), np.full(5, n)])
    val = np.concatenate([rng.rand(e), np.zeros(5)]).astype(np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return t(row), t(col), t(val), n


def test_spmm_coo_segment_on_the_cpu_keeps_index_add_bits():
    """The segment SpMM and its transpose backward: the bits of the
    gather-scale-``index_add_`` formula it had before the helper."""
    row, col, val, n = _coo()
    x = torch.randn(n, 16, requires_grad=True)

    def old(r, c, v, y):
        yp = torch.cat([y, y.new_zeros((1, y.shape[1]))])
        out = y.new_zeros((n + 1, y.shape[1]))
        return out.index_add_(0, r, yp[c] * v[:, None])[:n]

    got = spmm_coo_segment(row, col, val, x, n)
    assert torch.equal(got, old(row, col, val, x.detach()))
    cot = torch.randn(n, 16)
    got.backward(cot)
    assert torch.equal(x.grad, old(col, row, val, cot))


def test_gat_segment_ops_on_the_cpu_keep_index_add_bits():
    """``segment_softmax`` and ``gat_attention_segment`` (forward and the
    gradients of es, ed, h): the bits of the out-of-place ``index_add``
    they used before the helper."""
    row, col, val, n = _coo(seed=2)
    keep = row < n
    g = SparseGraph.from_coo(row[keep].numpy(), col[keep].numpy(), val[keep].numpy() + 0.1, n,
                             device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    es, ed = torch.randn(n, generator=gen), torch.randn(n, generator=gen)
    h = torch.randn(n, 8, generator=gen)

    def run(add):
        saved = tgat.add_rows
        tgat.add_rows = add
        try:
            p = [t.clone().requires_grad_(True) for t in (es, ed, h)]
            out = tgat.gat_attention_segment(g, *p)
            out.backward(torch.ones_like(out))
            sm = tgat.segment_softmax(torch.randn(g.row.numel(), generator=gen.manual_seed(1)),
                                      g.row, n)
            return [out.detach(), sm] + [t.grad for t in p]
        finally:
            tgat.add_rows = saved

    def index_add(m, idx, rows):
        return rows.new_zeros((m, *rows.shape[1:])).index_add(0, idx, rows)

    for a, b in zip(run(tgat.add_rows), run(index_add)):
        assert torch.equal(a, b)


def test_word2vec_scatter_is_the_shared_helper():
    """Word2Vec's updates go through the one helper (no copy of its own)."""
    assert word2vec.add_rows_ is add_rows_
    assert not hasattr(word2vec, "_add_rows")
