"""A cell of a second runner from new files alone. The fixtures under
``gpubench/tests/fixtures/`` are a runner (``programs/fixture_resident.py``:
the port's resident ``gcn_forward`` with identity features on a
``SparseGraph``, with a fault of its own), its reference family, its
configuration (``"features": "identity"``), its workload and its
``BENCHMARK.json`` entries (``entries.json``). The test lays them beside
copies of the benchmark's own files, where the harness looks for each
piece by name, and runs the cell on the CPU: sound it is correct, under
each fault of its runner and under the control it is not, and the
calibration takes it. No file that was there before is written to."""
import hashlib
import json
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import calibrate, harness, programs, reference, traffic
from gpubench.faults import for_program
from gpubench.tests.test_gpubench_checks import Control

FIXTURES = Path(__file__).resolve().parent / "fixtures"
ROOT = harness.ROOT
CELL = "fixture-gcn-identity.train"
MODULES = ("gpubench.programs.fixture_resident", "gpubench.reference.fixture_gcn_identity")
SEED = 2**31 + 6007


def files(root: Path) -> dict:
    """Each file of the benchmark under ``root`` (compiled bytecode aside)
    with its modification time and its bytes' digest."""
    paths = [root / "BENCHMARK.json"]
    paths += [p for p in (root / "gpubench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts]
    return {p: (p.stat().st_mtime_ns, hashlib.sha256(p.read_bytes()).hexdigest()) for p in paths}


@pytest.fixture
def new_cell(tmp_path, monkeypatch):
    """The benchmark's files copied under ``tmp_path`` with the fixture's
    added, the harness pointed there, and the fixture's modules on the
    packages' paths; yields the real files' record before the test."""
    before = files(ROOT)
    here = tmp_path / "gpubench"
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(harness.HERE / sub, here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for sub in ("configs", "workloads"):
        for f in (FIXTURES / sub).iterdir():
            shutil.copy(f, here / sub / f.name)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for key, entries in harness.load_json(FIXTURES / "entries.json").items():
        bench[key] = bench[key] + entries
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    for pkg in (programs, reference):
        sub = FIXTURES / pkg.__name__.split(".")[-1]
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(sub)])
    yield before
    for name in MODULES:
        sys.modules.pop(name, None)


def run():
    return harness.run_cell(CELL, SEED, 0.2, False, "cpu", time.perf_counter())


def test_the_new_cell_is_correct(new_cell):
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"step_ms", "setup_s"}
    assert files(ROOT) == new_cell


def test_its_inputs_have_identity_features(new_cell):
    cfg = harness.load_cell(CELL)["config"]
    inputs = harness.Inputs(cfg, SEED, "cpu")
    n = inputs.graph.n_rows
    assert inputs.x is None
    assert tuple(inputs.weights["gc1.w"].shape) == (n, cfg["n_hidden"])
    assert files(ROOT) == new_cell


@pytest.mark.parametrize("fault", ["rows_left_out", "state_unchanged"])
def test_each_fault_of_the_new_runner_is_not_correct(new_cell, fault):
    faults = for_program(harness.load_cell(CELL)["config"]["program"])
    assert set(faults) == {"rows_left_out", "state_unchanged"}
    with faults[fault]():
        res = run()
    assert not res["correct"], res["checks"]
    assert files(ROOT) == new_cell


def test_the_control_is_not_correct_in_the_new_cell(new_cell, monkeypatch):
    monkeypatch.setattr(harness, "build_program", Control)
    res = run()
    assert not res["correct"], res["checks"]
    assert files(ROOT) == new_cell


def test_the_calibration_takes_the_new_cell(new_cell):
    limits = harness.load_cell(CELL)["workload"]["limits"]
    faults = calibrate.faults_run(CELL)
    assert faults == ("rows_left_out",)
    rows = calibrate.readings(CELL, SEED, torch.device("cpu"), faults, True)
    by_kind = {r["kind"]: r["gaps"] for r in rows}
    assert set(by_kind) == {"program", "control", "rows_left_out"}
    assert all(by_kind["program"][k] <= limits[k] for k in harness.GAPS)
    for kind in ("control", "rows_left_out"):
        assert any(by_kind[kind][k] > limits[k] for k in harness.GAPS), (kind, by_kind[kind])
    assert files(ROOT) == new_cell
