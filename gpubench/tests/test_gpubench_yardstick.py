"""Bytes and operations counted from shapes, against hand-worked counts
and the numbers PERF.md's kernel table already holds for the 10M lattice."""
import numpy as np
import pytest
import torch

from gpubench import yardstick as ys
from gpubench.reference import appnp, gcn
from gpubench.traffic import ChunkShape
from gpubench.traffic.lattice import Lattice, make_lattice


def shape(n_chunks, w_sc, w, cell_e):
    """A lattice's shape without its draws (nothing is drawn until a chunk
    is asked for)."""
    return Lattice(n_chunks, w_sc, w, cell_e, 0, torch.device("cpu"), np.arange(n_chunks))


BIG = shape(610, 32, 512, 800)


def test_tiny_chunk_by_hand():
    # 2 windows of 4 rows, 6 edges a cell: G = 8 rows, 24 edges
    s = shape(1, 2, 4, 6)
    one = s.chunk_shape(0)
    # each window gathers 4 (1 - (3/4)^12) distinct rows
    rows = 2 * 4 * (1 - 0.75 ** 12)
    assert one == ChunkShape(8, 24, pytest.approx(rows, rel=1e-12))
    assert ys.chunk_bytes(one) == 9 * 4 + 24 * 8
    op = ys.k2_chunk(one, 2)
    assert op.n_bytes == pytest.approx(9 * 4 + 24 * 8 + rows * 2 * 2 + 2 * 8 * 2 * 4)
    assert op.n_ops == 2 * 24 * 2
    assert op.seconds == pytest.approx(op.n_bytes / ys.HBM_BYTES_PER_S)
    no_base = ys.k2_chunk(one, 2, base=False)
    assert op.n_bytes - no_base.n_bytes == pytest.approx(8 * 2 * 4)
    # a pass and its bound count no base
    assert ys.k2_pass(s, 2).n_bytes == pytest.approx(no_base.n_bytes)
    assert ys.k2_pass_seconds(s, 2) == pytest.approx(no_base.seconds)


def test_the_10m_lattice():
    # PERF.md section 4: the chunk cache of the 10M lattice
    assert ys.chunks_bytes(BIG, range(BIG.n_chunks)) == 4_037_675_400
    one = BIG.chunk_shape(0)
    # PERF.md section 6, B11: one chunk at F=16 onto a base (as chip_smoke.py
    # times it), bound 0.0028 ms
    op = ys.k2_chunk(one, 16)
    assert round(1e3 * op.seconds, 4) == 0.0028
    assert op.n_bytes == pytest.approx(6_619_140 + 16_384 * 16 * 2 + 2 * 16_384 * 16 * 4, abs=1)
    assert op.n_ops / ys.PEAK_F32 < op.n_bytes / ys.HBM_BYTES_PER_S
    # a streamed pass starts from zero: no base read, 12.8% fewer bytes at
    # F=16 and 7.1% at F=8
    for width, share in ((16, 0.128), (8, 0.071)):
        full, plain = ys.k2_chunk(one, width), ys.k2_chunk(one, width, base=False)
        assert full.n_bytes / plain.n_bytes - 1 == pytest.approx(share, abs=1e-3)
        assert ys.k2_pass_seconds(BIG, width) == pytest.approx(610 * plain.seconds)


def test_generated_lattice_has_the_counted_shape():
    lat = make_lattice(3 * 128, 16, 1, device="cpu", w=32, w_sc=4)
    row_ptr, col, val, _ = lat.chunk(0)
    assert ys.chunk_bytes(lat.chunk_shape(0)) == sum(
        t.numel() * t.element_size() for t in (row_ptr, col, val))
    assert lat.chunk_shape(0)[:2] == (row_ptr.numel() - 1, col.numel())


def test_step_work_gcn_and_appnp():
    cfg = {"n_feat": 128, "n_hidden": 16, "n_class": 8}
    ops = gcn.step_work(cfg, BIG)
    passes = [op for op in ops if op.name.startswith("pass")]
    assert [op.name for op in passes] == ["pass F=16", "pass F=8", "pass F=8", "pass F=16"]
    n = BIG.n_rows
    # x (bf16) is read twice: once for s1, once for dW1
    x_reads = sum(1 for op in ops if op.name in ("s1 = x W1", "dW1 = x^T g"))
    assert x_reads == 2
    total = ys.seconds(ops)
    assert total > 2 * n * 128 * 2 / ys.HBM_BYTES_PER_S
    assert 5e-3 < total < 12e-3
    acfg = {"n_feat": 128, "n_hidden": 64, "n_class": 8, "k": 10}
    aops = appnp.step_work(acfg, BIG)
    assert sum(1 for op in aops if op.name.startswith("pass")) == 20
    assert appnp.pass_widths(acfg) == [8] * 20 and gcn.pass_widths(cfg) == [16, 8, 8, 16]


def test_host_feed_of_the_hostfed_cell():
    assert ys.device_chunks(BIG, 0.5) == 305 and ys.device_chunks(BIG, 1.0) == 610
    feed = ys.host_feed(BIG, 0.5, 4)
    assert feed.n_bytes == 4 * 305 * 6_619_140
    assert ys.host_feed(BIG, 1.0, 4).n_bytes == 0
    device = [ys.Op("a", 3.35e9, 0.0)]
    assert ys.least_step_seconds(device, feed) == pytest.approx(feed.n_bytes / ys.PCIE_BYTES_PER_S)
    assert ys.least_step_seconds(device, ys.host_feed(BIG, 1.0, 4)) == pytest.approx(1e-3)
