"""The span metrics and the second window's record (``gpubench/spans.py``)
on hand-made spans and device operations, in nanoseconds."""
import pytest

from gpubench import harness, reference, spans, traffic

K2 = "row_reduce_kernel<4>"
READERS = ("chunk_host_us", "k2_launch_us", "feed_host_us", "k2_calls", "idle_stream_pct",
           "k2_batched_share")


def window(copies=1, batched=0):
    # busy: [100, 120], [150, 260] (a copy over the second kernel),
    # [300, 330], [400, 450]; idle: (120, 150), (260, 300), (330, 400)
    events = [
        (K2, 100, 120),
        ("Memcpy HtoD", 150, 260),
        (K2, 200, 215),
        (K2, 300, 330),
        ("gemm", 400, 450),
    ]
    sp = [
        ("step", 90, 460, -1, 7, {}),
        ("pass", 95, 340, 0, 7, {"chunks": 3, "batched": batched, "launches": 3 - batched // 2,
                                 "copies": copies}),
        ("chunk.fetch", 96, 98, 1, 7, {}),
        ("k2.launch", 98, 99, 1, 7, {}),
        ("chunk.feed", 130, 140, 1, 7, {}),
        ("k2.launch", 190, 195, 1, 7, {}),
        ("chunk.sync", 280, 285, 1, 7, {}),
        ("k2.launch", 295, 298, 1, 7, {}),
    ]
    return spans.Window(sp, events, steps=1, window_s=400e-9)


def read(w):
    ctx = harness.Context(spans=w)
    return {m: harness.reader(m)(ctx) for m in READERS}


def test_intervals():
    assert spans.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
    assert spans.idle(window().events) == [(120, 150), (260, 300), (330, 400)]
    assert spans.overlap([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert spans.overlap([(0, 10)], []) == 0
    assert spans.idle_inside(window(), "pass") == (30 + 40 + 10, 140)
    assert spans.idle_inside(window(), "step") == (140, 140)


def test_readers():
    got = read(window())
    assert got["chunk_host_us"] == pytest.approx(245 / 3 / 1e3)
    assert got["k2_launch_us"] == pytest.approx((1 + 5 + 3) / 3 / 1e3)
    assert got["feed_host_us"] == pytest.approx((10 + 5) / 1e3)
    assert got["k2_calls"] == 3
    assert got["idle_stream_pct"] == pytest.approx(100 * 80 / 140)
    assert got["k2_batched_share"] == 0.0
    # two of the three chunks reduced in one run launch
    assert read(window(batched=2))["k2_batched_share"] == pytest.approx(100 * 2 / 3)


def test_readers_find_nothing_without_a_window():
    # the harness's own context has no spans: each reader leaves its metric out
    assert all(v is None for v in read(None).values())
    ctx = harness.Context(config={}, trace=None)
    assert all(harness.reader(m)(ctx) is None for m in READERS)
    # no host copies: no feed time a copy
    assert read(window(copies=0))["feed_host_us"] is None
    # no pass spans (a runner whose passes record none): no share inside them
    w = window()
    w.spans = [s for s in w.spans if s[0] != "pass"]
    assert read(w)["idle_stream_pct"] is None and read(w)["k2_batched_share"] is None


def test_k2_calls_count_only_the_window_steps():
    w = window()
    # a pass outside any step (a forward-only call) is not a step's
    w.spans.append(("pass", 470, 480, -1, -1, {"chunks": 2, "batched": 0, "launches": 2,
                                              "copies": 0}))
    w.spans.append(("step", 490, 500, -1, 8, {}))
    assert read(w)["k2_calls"] == pytest.approx(3 / 2)


def test_record():
    r = spans.record(window())
    assert r["ms_per_step"] == pytest.approx(400e-6)
    assert r["idle_share"] == pytest.approx(1 - (20 + 110 + 30 + 50) / 400)
    assert r["idle_ms_per_step"] == pytest.approx(140e-6)
    assert r["idle_outside_steps_share"] == 0.0
    assert r["idle_ms_per_step_inside"]["pass"] == pytest.approx(80e-6)
    inside = r["idle_ms_per_step_inside"]
    assert inside["chunk.feed"] == pytest.approx(10e-6)
    assert inside["chunk.sync"] == pytest.approx(5e-6)
    assert inside["k2.launch"] == pytest.approx(3e-6)
    # self time a chunk: the step less its pass, the pass less its children
    assert r["self_us_per_chunk"]["step"] == pytest.approx((370 - 245) / 3 / 1e3)
    assert r["self_us_per_chunk"]["pass"] == pytest.approx((245 - 26) / 3 / 1e3)
    assert r["self_us_per_chunk"]["k2.launch"] == pytest.approx(9 / 3 / 1e3)
    d = r["launch_delay_us"]
    assert spans.launch_delays_ns(window()) == [2, 10, 5]
    assert d["early"] == 0 and d["paired"] == 3 and d["min"] == pytest.approx(2e-3)
    assert r["spans"] == {"step": 1, "pass": 1, "chunk.fetch": 1, "chunk.feed": 1,
                          "chunk.sync": 1, "k2.launch": 3}


def test_a_kernel_before_its_launch_is_counted_early():
    w = window()
    w.spans[5] = ("k2.launch", 205, 206, 1, 7, {})
    assert spans.launch_delays_ns(w) == [2, -5, 5]
    assert spans.record(w)["launch_delay_us"]["early"] == 1


def test_the_program_records_a_window_the_readers_read():
    """A cell's program on the CPU at a small size, two steps with the
    program's recorder on: a ``step`` span each, holding the family's
    passes over every chunk. (The CPU has no K2 launches and no copies.)"""
    c = harness.load_cell("gcn-stream-10m.hostfed")
    cfg = dict(c["config"], **traffic.small(c["config"]["graph"]["kind"]))
    inputs = harness.Inputs(cfg, 2**31 + 17, "cpu")
    prog = harness.build_program(cfg, c["workload"], inputs)
    prog.step()
    prog.program_spans(True)
    prog.step()
    prog.step()
    w = spans.Window(prog.program_spans(False), [], steps=2, window_s=1.0)
    passes = len(reference.family(cfg["family"]).pass_widths(cfg))
    assert w.chunks() == 2 * passes * inputs.graph.n_chunks
    got = read(w)
    assert got["chunk_host_us"] > 0 and got["k2_calls"] == 0
    assert got["feed_host_us"] is None and got["idle_stream_pct"] is None
    assert 0 <= got["k2_batched_share"] <= 100
    assert spans.record(w)["spans"]["step"] == 2


def test_align_takes_out_the_device_clocks_offset_and_drift():
    """Device timestamps 5 us late at the first anchor burst and drifting
    500 ppm: two bursts of host-bracketed anchor kernels bring them back to
    within the brackets' width, and the anchors leave the events."""
    def dev(t):  # the profiler's stamp of host time t
        return int(t + 5_000 + 5e-4 * (t - 1_000_000))

    head, tail, events = [], [], []
    for i in range(4):  # bursts at 1 ms and 2 s: kernels 2 us inside 10 us brackets
        for burst, t in ((head, 1_000_000 + 10_000 * i), (tail, 2_000_000_000 + 10_000 * i)):
            burst.append((t, t + 10_000))
            events.append(("at::cuda::spin_kernel", dev(t + 2_000), dev(t + 3_000)))
    true = [(K2, 500_000_000, 500_010_000), ("gemm", 1_500_000_000, 1_500_100_000)]
    events += [(n, dev(a), dev(b)) for n, a, b in true]
    got, clock = spans.align(events, head, tail)
    assert [n for n, _, _ in got] == [K2, "gemm"]
    for (_, a, b), (_, ta, tb) in zip(got, true):
        assert abs(a - ta) <= 4_500 and abs(b - tb) <= 4_500
    assert clock["aligned"] and clock["drift_ppm"] == pytest.approx(-500, rel=0.01)
    # without both bursts the events stay as stamped
    kept, c = spans.align(events, head, [])
    assert not c["aligned"] and len(kept) == 2
