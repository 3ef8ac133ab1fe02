"""``correct`` comes out false where it must. A whole run of each cell is
driven on the CPU at a small size (the harness's look for a card is
skipped): sound, it is correct; with a fault planted under the timed path
(``gpubench/faults.py``) or with the control (the reference one precision
step below the configuration's) in the program's place, it is not."""
import time

import pytest

from gpubench import harness, reference
from gpubench.faults import FAULTS

SMALL = {"graph": {"kind": "lattice", "n_nodes": 2048, "degree": 16, "w": 32, "w_sc": 4},
         "edge_scale": 1 / 16}
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 4242


def run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"step_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    with FAULTS[fault]():
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
    rows = calibrate.readings(cell, SEED, torch.device("cpu"), calibrate.FAULTS_RUN, True, SMALL)
    by_kind = {r["kind"]: r["gaps"] for r in rows}
    assert set(by_kind) == {"program", "control", *calibrate.FAULTS_RUN}
    assert all(by_kind["program"][k] <= limits[k] for k in harness.GAPS)
    for kind in ("control", *calibrate.FAULTS_RUN):
        assert any(by_kind[kind][k] > limits[k] for k in harness.GAPS), (kind, by_kind[kind])
