"""The pieces of a cell that the harness finds by name: a traffic kind's
``SMALL``, a runner's faults, the ``features`` key of a configuration, and
the second traced window that the span metrics read."""
import time

import pytest
import torch

from gpubench import harness, spans, traffic
from gpubench.faults import for_program

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
SEED = 2**31 + 4242


def small_cfg(cell):
    cfg = harness.load_cell(cell)["config"]
    return dict(cfg, **traffic.small(cfg["graph"]["kind"]))


def test_the_lattice_small_form():
    assert traffic.small("lattice") == {
        "graph": {"kind": "lattice", "n_nodes": 2048, "degree": 16, "w": 32, "w_sc": 4},
        "edge_scale": 1 / 16}


def test_the_streamed_runner_has_its_three_faults():
    assert set(for_program("streamed")) == {"state_unchanged", "half_batch", "chunks_left_out"}


def drawn_as_before(cfg, seed, n):
    """Labels, features and the loss mask drawn as ``Inputs`` drew them
    before identity features existed, in the same order."""
    s = harness.sub_seeds(seed)
    f, c = cfg["n_feat"], cfg["n_class"]
    gen = torch.Generator().manual_seed(s["features"])
    y = torch.randint(0, c, (n,), generator=gen)
    x = torch.randn((n, f), generator=gen, dtype=torch.bfloat16).mul_(0.1)
    x += (torch.arange(f) % c == y[:, None]).to(torch.bfloat16)
    mask = (torch.rand(n, generator=gen) < cfg["train_share"]).float()
    return x, y, mask


@pytest.mark.parametrize("cell", ["gcn-stream-10m.cached", "appnp-stream-10m.cached"])
def test_drawn_features_are_as_before(cell):
    cfg = small_cfg(cell)
    inputs = harness.Inputs(cfg, SEED, "cpu")
    x, y, mask = drawn_as_before(cfg, SEED, inputs.graph.n_rows)
    assert torch.equal(inputs.x, x) and torch.equal(inputs.y, y)
    assert torch.equal(inputs.mask, mask)


def test_identity_features_draw_no_features():
    # an n_feat no array could hold: identity features never read it
    cfg = dict(small_cfg("gcn-stream-10m.cached"), features="identity", n_feat=1 << 40)
    inputs = harness.Inputs(cfg, SEED, "cpu")
    n, h = inputs.graph.n_rows, cfg["n_hidden"]
    assert inputs.x is None
    assert tuple(inputs.weights["gc1.w"].shape) == (n, h)
    drawn = harness.Inputs(small_cfg("gcn-stream-10m.cached"), SEED, "cpu")
    assert torch.equal(inputs.y, drawn.y)
    assert inputs.mask.shape == (n,) and set(inputs.mask.unique().tolist()) <= {0.0, 1.0}


def spy_contexts(monkeypatch):
    """The contexts that the harness hands to its metric readers."""
    seen, orig = [], harness.reader

    def reader(name):
        fn = orig(name)

        def read(ctx):
            seen.append(ctx)
            return fn(ctx)
        return read

    monkeypatch.setattr(harness, "reader", reader)
    return seen


def test_no_spans_on_the_cpu(monkeypatch):
    seen = spy_contexts(monkeypatch)
    cell = "gcn-stream-10m.cached"
    harness.run_cell(cell, SEED, 0.1, False, "cpu", time.perf_counter(),
                     overrides=traffic.small("lattice"))
    assert seen and all(ctx.spans is None for ctx in seen)
    with pytest.raises(RuntimeError):
        harness.run_cell(cell, SEED, 0.1, True, "cpu", time.perf_counter(),
                         overrides=traffic.small("lattice"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_on_the_card_reads_the_programs_spans(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seen = spy_contexts(monkeypatch)
    c = harness.load_cell(cell)
    res = harness.run_cell(cell, SEED, 0.1, True, "cuda", time.perf_counter(),
                           overrides=traffic.small(c["config"]["graph"]["kind"]))
    assert res["correct"], res["checks"]
    w = seen[0].spans
    assert isinstance(w, spans.Window) and w.named(spans.STEP) and w.chunks() > 0
    assert res["notes"]["spans"]["spans"]["step"] == c["workload"]["trace_steps"]
    listed = {m["name"] for m in harness.cell_metrics(c["bench"], cell, True)}
    assert set(res["metrics"]) == listed, listed - set(res["metrics"])
