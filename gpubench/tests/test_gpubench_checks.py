"""``correct`` comes out false where it must. A whole run of each cell is
driven on the CPU at a small size, its traffic kind's ``SMALL`` (the
harness's look for a card is skipped): sound, it is correct; with a fault
of its runner planted under the timed path (``gpubench/faults.py``
``for_program``) or with the control (the reference one precision step
below the configuration's) in the program's place, it is not."""
import time

import pytest

from gpubench import harness, reference, traffic
from gpubench.faults import for_program

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 4242


def small(cell):
    """The configuration keys that run ``cell`` at a test's size."""
    return traffic.small(harness.load_cell(cell)["config"]["graph"]["kind"])


def cell_faults():
    """Each cell with each fault of its runner."""
    return [(cell, fault) for cell in CELLS
            for fault in sorted(for_program(harness.load_cell(cell)["config"]["program"]))]


def run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                            overrides=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"step_ms", "setup_s"}


@pytest.mark.parametrize("cell, fault", cell_faults())
def test_a_planted_fault_is_not_correct(cell, fault):
    program = harness.load_cell(cell)["config"]["program"]
    with for_program(program)[fault]():
        res = run(cell)
    assert not res["correct"], res["checks"]


class Control:
    """The reference at the precision below the configuration's, in the
    program's place."""

    def __init__(self, cfg, workload, inputs, spans=False):
        low = reference.NARROWER[cfg["precision"]["low"]]
        g = inputs.graph
        graph = reference.Graph(inputs.chunks(), g.n_rows, g.n_edges, inputs.device)
        self._t = reference.ReferenceTrainer(cfg, inputs.weights, graph, inputs.x, inputs.y,
                                             inputs.mask, low)
        self.step, self.first_grad, self.snapshot = (
            self._t.step, self._t.first_grad, self._t.snapshot)

    def record_spans(self, on):
        pass

    def program_spans(self, on):
        return []

    def pass_ms(self):
        return []

    def counters(self):
        return {}

    def notes(self):
        return {}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(harness, "build_program", Control)
    res = run(cell)
    assert not res["correct"], res["checks"]
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_calibration_readings(cell):
    import torch

    from gpubench import calibrate

    limits = harness.load_cell(cell)["workload"]["limits"]
    faults = calibrate.faults_run(cell)
    rows = calibrate.readings(cell, SEED, torch.device("cpu"), faults, True, small(cell))
    by_kind = {r["kind"]: r["gaps"] for r in rows}
    assert set(by_kind) == {"program", "control", *faults}
    assert all(by_kind["program"][k] <= limits[k] for k in harness.GAPS)
    for kind in ("control", *faults):
        assert any(by_kind[kind][k] > limits[k] for k in harness.GAPS), (kind, by_kind[kind])
