"""The cell of the resident runner, ``textgcn-r8-docword.train``, where
the tests of every cell (``test_gpubench_checks.py``) do not reach: its
traffic's ``SMALL`` form, its readers on hand-made spans and a hand-made
trace, and on the card the reference against the program and a traced run
that reads the program's ``hybrid.pass`` and ``k1.launch`` spans and
reports every metric listed for the cell."""
import time

import pytest
import torch

from gpubench import harness, reference, spans, trace, traffic
from gpubench.traffic import r8docword

CELL = "textgcn-r8-docword.train"
SEED = 2**31 + 5309
OWN = ("spmm_roofline", "hybrid_pass_us", "k1_launch_us")


def small_cfg():
    return dict(harness.load_cell(CELL)["config"], **traffic.small("r8docword"))


def test_the_small_form_is_a_subgraph_of_the_same_file():
    g = r8docword.make(traffic.small("r8docword")["graph"], SEED, "cpu")
    assert (g.n_rows, g.n_docs, g.n_chunks) == (1024, 256, 4)
    shapes = [g.chunk_shape(j) for j in range(g.n_chunks)]
    assert sum(s.rows for s in shapes) == g.n_rows
    assert sum(s.edges for s in shapes) == g.n_edges


def test_the_span_readers():
    sp = [("step", 0, 900, -1, 1, {}),
          ("hybrid.pass", 10, 110, 0, 1, {"width": 208}),
          ("k1.launch", 20, 30, 1, 1, {}),
          ("hybrid.pass", 200, 260, 0, 1, {"width": 16}),
          ("k1.launch", 210, 250, 3, 1, {})]
    ctx = harness.Context(spans=spans.Window(sp, [], steps=1, window_s=1e-6))
    assert harness.reader("hybrid_pass_us")(ctx) == pytest.approx(80 / 1e3)
    assert harness.reader("k1_launch_us")(ctx) == pytest.approx(25 / 1e3)
    empty = harness.Context(spans=spans.Window([], [], steps=1, window_s=1e-6))
    for name in OWN:
        assert harness.reader(name)(harness.Context()) is None
        assert harness.reader(name)(empty) is None


def test_spmm_roofline_counts_the_epochs_six_passes_over_k1_and_k2():
    cfg = small_cfg()
    g = traffic.make(cfg["graph"], SEED, "cpu")
    fam = reference.family(cfg["family"])
    events = [("bsr_spmm_kernel<13, 4>", 0.0, 3e-3), ("row_reduce_kernel<8>", 3e-3, 4e-3),
              ("gemm", 4e-3, 9e-3)]
    ctx = harness.Context(config=cfg, graph=g, family=fam,
                          trace=trace.reduce(events, 1e-2, 2, [1.0, 1.0]))
    h, c = cfg["n_hidden"], cfg["n_class"]
    one = sum(fam.spmm_pass(g, w).seconds for w in (h, c, c, h, h, c))
    assert harness.reader("spmm_roofline")(ctx) == pytest.approx(100 * 2 * one / 4e-3)
    # the bound reads Â's values at bfloat16: 10 bytes an edge and a row
    # pointer a row, beside the operand and the output
    assert fam.spmm_pass(g, 1).n_bytes == (g.n_rows + 1) * 4 + g.n_edges * 6 + g.n_rows * 6


@pytest.mark.cuda
def test_the_reference_matches_the_program_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = small_cfg()
    inputs = harness.Inputs(cfg, SEED, "cuda")
    got = harness.check_steps(harness.build_program(cfg, {}, inputs))
    found = harness.gaps(got, harness.reference_readings(cfg, inputs))
    assert all(found[k] <= 1e-3 for k in harness.GAPS), found


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_hybrid_passes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = harness.load_cell(CELL)
    res = harness.run_cell(CELL, SEED, 0.1, True, "cuda", time.perf_counter(),
                           overrides=traffic.small("r8docword"))
    assert res["correct"], res["checks"]
    steps = c["workload"]["trace_steps"]
    assert res["notes"]["spans"]["spans"]["step"] == steps
    # K1 and K2 launch in each of an epoch's six passes
    assert res["notes"]["k1_launches_per_step"] >= 6
    assert res["notes"]["k2_launches_per_step"] == 6
    listed = {m["name"] for m in harness.cell_metrics(c["bench"], CELL, True)}
    assert set(OWN) <= listed
    assert set(res["metrics"]) == listed, listed - set(res["metrics"])
