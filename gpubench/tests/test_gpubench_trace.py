"""The trace's reduction and the metric readers, on hand-made intervals."""
import importlib

import pytest

from gpubench import harness, trace, yardstick
from gpubench.reference import gcn
from gpubench.traffic.lattice import make_lattice

K2 = "row_reduce_kernel<4>"


def summary():
    # two streams; a copy overlaps the second kernel
    ev = [
        (K2, 0.010, 0.020),
        ("Memcpy HtoD (Pinned -> Device)", 0.015, 0.030),
        (K2, 0.025, 0.035),
        ("vectorized_elementwise_kernel<4, add>", 0.050, 0.060),
        (K2, 0.070, 0.080),
    ]
    return trace.reduce(ev, 0.100, 2, [1.0, 0.9])


def test_union_gaps_and_edges():
    s = summary()
    assert s.busy_s == pytest.approx(0.025 + 0.010 + 0.010)
    ew = "vectorized_elementwise_kernel<4, add>"
    assert s.gaps[f"after {K2} before {ew}"][0] == pytest.approx(0.015)
    assert s.gaps[f"after {ew} before {K2}"][0] == pytest.approx(0.010)
    edges = s.gaps["window edges: the first launch and the last wait"][0]
    assert edges == pytest.approx(0.100 - s.busy_s - 0.025)
    assert s.by_name[K2] == (pytest.approx(0.030), 3)
    b = s.breakdown()
    assert b["device_ops"][0] == [K2, pytest.approx(0.030)]
    assert len(b["idle_gaps"]) == 3


def test_short_names():
    assert trace.short("void row_reduce_kernel<8>(int const*, float*)") == "row_reduce_kernel<8>"
    assert trace.short("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    assert trace.short("void (anonymous namespace)::row_reduce_kernel<2>(int const*)") == (
        "row_reduce_kernel<2>")
    assert trace.is_k2("row_reduce_kernel<8>") and not trace.is_k2("Memcpy HtoD")


def test_device_span():
    # from the first kernel's start to the last one's end
    assert summary().span_s == pytest.approx(0.080 - 0.010)
    assert trace.reduce([], 0.1, 2, []).span_s == 0.0


def test_readers():
    lat = make_lattice(4 * 128, 16, 0, device="cpu", w=32, w_sc=4)
    cfg = {"n_feat": 16, "n_hidden": 8, "n_class": 4, "family": "gcn"}
    ctx = harness.Context(config=cfg, graph=lat, family=gcn, trace=summary(),
                          workload={"device_share": 1.0},
                          pass_ms=[1.0, 3.0], steps=2, window_s=0.1)
    read = {m: harness.reader(m) for m in
            ("idle_pct", "dense_ms", "h2d_ms", "pass_ms", "k2_roofline", "step_mfu", "step_ms")}
    assert read["idle_pct"](ctx) == pytest.approx(100 * (1 - 0.045 / 0.100))
    assert read["dense_ms"](ctx) == pytest.approx(1e3 * 0.010 / 2)
    assert read["h2d_ms"](ctx) == pytest.approx(1e3 * 0.015 / 2)
    assert read["pass_ms"](ctx) == pytest.approx(2.0)
    # K2's bound: no base read, as in the step's work
    per_chunk = [yardstick.k2_chunk(lat.chunk_shape(0), w, base=False).seconds
                 for w in (8, 4, 4, 8)]
    bound = 2 * lat.n_chunks * sum(per_chunk)
    assert read["k2_roofline"](ctx) == pytest.approx(100 * bound / 0.030)
    passes = [op for op in gcn.step_work(cfg, lat) if op.name.startswith("pass")]
    assert sum(op.seconds for op in passes) == pytest.approx(bound / 2)
    # the step's work over the device's span of the two steps (0.070 s),
    # not over the host's window (0.100 s)
    least = yardstick.seconds(gcn.step_work(cfg, lat))
    assert read["step_mfu"](ctx) == pytest.approx(100 * least * 2 / 0.070)
    assert read["step_ms"](ctx) is None  # an end-to-end metric: not in a traced run
    empty = harness.Context(config=cfg, graph=lat, family=gcn, workload={"device_share": 1.0},
                            trace=trace.reduce([], 0.1, 2, []))
    assert read["k2_roofline"](empty) is None and read["h2d_ms"](empty) is None
    assert read["step_mfu"](empty) is None


def test_cell_metrics_follow_benchmark_json():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cached = {m["name"] for m in harness.cell_metrics(bench, "gcn-stream-10m.cached", True)}
    hostfed = {m["name"] for m in harness.cell_metrics(bench, "gcn-stream-10m.hostfed", True)}
    assert "h2d_ms" in hostfed and "h2d_ms" not in cached
    e2e = {m["name"] for m in harness.cell_metrics(bench, "gcn-stream-10m.cached", False)}
    assert e2e == {"step_ms", "peak_mem_gib", "setup_s"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]])
def test_each_cell_finds_its_pieces_by_name(cell):
    """A cell's workload, configuration, graph generator, program runner
    and reference family are files found by the names in its data."""
    from gpubench import programs, reference

    c = harness.load_cell(cell)
    cfg = c["config"]
    assert hasattr(programs.runner(cfg["program"]), "build")
    assert hasattr(importlib.import_module(f"gpubench.traffic.{cfg['graph']['kind']}"), "make")
    fam = reference.family(cfg["family"])
    assert all(hasattr(fam, f) for f in ("param_shapes", "loss", "pass_widths", "step_work"))


def test_a_workload_may_draw_another_graph():
    cfg = {"family": "gcn", "graph": {"kind": "lattice", "n_nodes": 10, "degree": 4}}
    wl = {"config": "x", "graph": {"kind": "skewed", "alpha": 2.1}}
    got = harness.cell_config(cfg, wl)
    assert got["graph"] == {"kind": "skewed", "n_nodes": 10, "degree": 4, "alpha": 2.1}
    assert cfg["graph"]["kind"] == "lattice"
    assert harness.cell_config(cfg, {"config": "x"}) == cfg
