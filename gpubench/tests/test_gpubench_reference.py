"""The plain reference against the program's streamed step, on a small
lattice, for every configuration's family; and the import guard: nothing
under gpubench/ imports JAX or the JAX package, and the reference and the
traffic import nothing of the program."""
import ast
from pathlib import Path

import pytest
import torch

from gpubench import harness, traffic

GPUBENCH = Path(harness.__file__).resolve().parent
CONFIGS = sorted(p.stem for p in (GPUBENCH / "configs").glob("*.json"))
# f32 sums in another order and the bf16 roundings they may flip
TOL = 1e-5


def imported_tops(path: Path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_anywhere_and_no_program_in_the_yardstick():
    banned = {"jax", "jaxlib", "flax", "textgcn_tpu"}
    files = sorted(GPUBENCH.rglob("*.py"))
    assert files
    for path in files:
        tops = imported_tops(path)
        assert not tops & banned, (path, tops & banned)
        rel = path.relative_to(GPUBENCH).parts
        if rel[0] in ("reference", "traffic") or rel[-1] == "yardstick.py":
            assert "textgcn_tpu_torch" not in tops, path


def readings_pair(name, device):
    cell = harness.load_cell(f"{name}.cached")
    cfg = dict(cell["config"], **traffic.small(cell["config"]["graph"]["kind"]))
    inputs = harness.Inputs(cfg, 2**31 + 11, device)
    got = harness.check_steps(harness.build_program(cfg, cell["workload"], inputs))
    return got, harness.reference_readings(cfg, inputs)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_program_on_the_cpu(name):
    got, ref = readings_pair(name, "cpu")
    found = harness.gaps(got, ref)
    assert all(found[k] <= TOL for k in harness.GAPS) and not found["left_out"], found
    # the steps train: the reference's loss falls
    assert ref.losses[-1] < ref.losses[0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_matches_the_program_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    got, ref = readings_pair(name, "cuda")
    found = harness.gaps(got, ref)
    assert all(found[k] <= 1e-3 for k in harness.GAPS), found
