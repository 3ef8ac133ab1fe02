"""The benchmark's TextGCN cell (``textgcn-r8-docword.train``) on the CPU.

Its traffic (``gpubench/traffic/r8docword.py``) is the port's R8 doc-word
graph, value for value at bfloat16, in the order of the port's degree sort,
so that the sort is the identity. Its runner (``gpubench/programs/resident.py``)
drives ``Trainer.epoch`` on the hybrid layout and agrees with the plain
reference (``gpubench/reference/textgcn.py``) at ``SMALL`` within the cell's
limits; under each of the runner's faults and under the control it does not.
"""
import numpy as np
import pytest
import torch

from gpubench import calibrate, harness, traffic
from gpubench.faults import for_program
from gpubench.traffic import r8docword

from textgcn_tpu_torch.graph import reorder
from textgcn_tpu_torch.train.prepare import load_graph_edges

CELL = "textgcn-r8-docword.train"
SEED = 2**33 + 4243
CPU = torch.device("cpu")
FAULTS = ("residual_left_out", "dropout_left_out", "half_batch")


def small_cfg():
    return dict(harness.load_cell(CELL)["config"], **traffic.small("r8docword"))


def limits():
    return harness.load_cell(CELL)["workload"]["limits"]


@pytest.fixture(scope="module")
def readings():
    rows = calibrate.readings(CELL, SEED, CPU, calibrate.faults_run(CELL), True,
                              overrides=traffic.small("r8docword"))
    return {r["kind"]: r for r in rows}


def test_the_runner_has_its_faults():
    assert calibrate.faults_run(CELL) == FAULTS
    assert set(for_program("resident")) == {"state_unchanged", *FAULTS}


def test_the_program_agrees_with_the_reference_at_small(readings):
    r, lim = readings["program"], limits()
    assert all(r["gaps"][k] <= lim[k] for k in harness.GAPS), r["gaps"]
    assert not r["gaps"]["left_out"]
    # the steps train: the reference's loss falls
    assert r["ref_losses"][-1] < r["ref_losses"][0]


@pytest.mark.parametrize("kind", [*FAULTS, "control"])
def test_each_fault_and_the_control_fail_the_limits(readings, kind):
    gaps, lim = readings[kind]["gaps"], limits()
    assert any(gaps[k] > lim[k] for k in harness.GAPS), gaps


def test_the_runner_runs_the_hybrid_layout():
    cfg = small_cfg()
    prog = harness.build_program(cfg, {}, harness.Inputs(cfg, SEED, CPU))
    assert isinstance(prog.graph, reorder.HybridGraph)
    notes = prog.notes()
    assert notes["tiles"] > 0 and notes["residual_edges"] > 0
    assert set(prog.counters()) == {"k1_launches", "k2_launches"}


def test_the_runner_refuses_a_sort_that_moves_nodes(monkeypatch):
    def reversed_sort(row, col, n_nodes):
        return np.arange(n_nodes)[::-1].copy()

    monkeypatch.setattr(reorder, "degree_sort_permutation", reversed_sort)
    cfg = small_cfg()
    with pytest.raises(RuntimeError, match="not the identity"):
        harness.build_program(cfg, {}, harness.Inputs(cfg, SEED, CPU))


def test_the_traffic_is_the_ports_graph_in_degree_order():
    gcfg = harness.load_cell(CELL)["config"]["graph"]
    g = r8docword.make(gcfg, SEED, CPU)
    n = g.n_rows
    assert (n, g.n_docs) == (15362, 7674)
    port = load_graph_edges(str(r8docword.DATA / "graph" / "R8_docword.txt"), n, device=CPU)
    row, col, val = port.coo_numpy()
    perm = reorder.degree_sort_permutation(row, col, n)
    row, col = perm[row], perm[col]
    order = np.lexsort((col, row))
    row_ptr = np.searchsorted(row[order], np.arange(n + 1))
    bf16 = torch.from_numpy(val[order]).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(g.row_ptr, row_ptr)
    np.testing.assert_array_equal(g.col, col[order])
    np.testing.assert_array_equal(g.val, bf16)
    own_rows = np.repeat(np.arange(n), np.diff(g.row_ptr))
    np.testing.assert_array_equal(reorder.degree_sort_permutation(own_rows, g.col, n),
                                  np.arange(n))
