"""The program's own spans beside the device's activity: a second traced
window of the same steps with the program's span recorder on, and the
arithmetic that the span metrics (``gpubench/metrics/chunk_host_us.py``,
``k2_launch_us``, ``feed_host_us``, ``k2_calls``, ``idle_stream_pct``,
``k2_batched_share``) read.

A traced run of ``gpubench/run.py`` (``harness.run_cell``) takes this
window after its first one (``trace.profile``, which the device-trace
metrics read): as many steps again under a CUDA-only profile with the
runner's ``program_spans`` on. Its context's ``spans`` is the
:class:`Window`, and its notes carry :func:`record`.

The recorder is the program's
``textgcn_tpu_torch.utils.profiling.record_spans``; its spans are tuples
``(name, start_ns, end_ns, parent, step, attrs)`` on ``time.time_ns()``'s
clock, the epoch of the profiler's events. The profiler converts device
timestamps from the TSC-based approximate clock, and on a host whose TSC is
not invariant they drift against ``time.time_ns()`` by up to a millisecond
over a window; so the window brackets a burst of anchor kernels with the
host's clock before and after its steps and puts the device's operations on
the host's clock from them (:func:`align`) before a span and an operation
are compared.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Sequence, Tuple

from gpubench.trace import short

Interval = Tuple[int, int]
# the program's span names
STEP, PASS, FETCH, FEED, SYNC, LAUNCH = (
    "step", "pass", "chunk.fetch", "chunk.feed", "chunk.sync", "k2.launch")
NAMES = (STEP, PASS, FETCH, FEED, SYNC, LAUNCH)
# the kernel each ``k2.launch`` launches first (its split pass, where a
# chunk has long rows, follows it)
K2_FIRST = "row_reduce_kernel"
# the anchor kernel (``torch.cuda._sleep``) and the anchors of a burst
ANCHOR = "spin_kernel"
ANCHORS = 32
ANCHOR_CYCLES = 1000


@dataclasses.dataclass
class Window:
    """The second traced window: the program's spans, the device's
    operations ``(short name, start ns, end ns)`` on the host's clock, the
    steps it ran, its length on the host's clock, and how the device's
    timestamps were brought onto that clock (:func:`align`)."""

    spans: list
    events: List[Tuple[str, int, int]]
    steps: int
    window_s: float
    clock: dict = dataclasses.field(default_factory=dict)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s[0] == name]

    def total_ns(self, name: str) -> int:
        return sum(s[2] - s[1] for s in self.named(name))

    def chunks(self) -> int:
        return sum(s[5]["chunks"] for s in self.named(PASS))


# ---------------------------------------------------------------------------
# Intervals
# ---------------------------------------------------------------------------


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle(events: Sequence[Tuple[str, int, int]]) -> List[Interval]:
    """The device's idle intervals between its first operation's start and
    its last one's end: the gaps of the union of the operations' intervals
    over all streams (``trace.reduce``'s arithmetic)."""
    busy = union([(a, b) for _, a, b in events])
    return [(b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:])]


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """The length that two lists of sorted disjoint intervals share."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(w: Window, name: str) -> Tuple[int, int]:
    """``(idle ns inside spans called name, all idle ns)`` of the window."""
    gaps = idle(w.events)
    inside = overlap(gaps, union([(s[1], s[2]) for s in w.named(name)]))
    return inside, sum(b - a for a, b in gaps)


# ---------------------------------------------------------------------------
# The record
# ---------------------------------------------------------------------------


def self_ns(spans: Sequence) -> Dict[str, int]:
    """Each span name's self time: its spans' time less their children's."""
    kids = [0] * len(spans)
    for s in spans:
        if s[3] >= 0:
            kids[s[3]] += s[2] - s[1]
    out: Dict[str, int] = {}
    for s, k in zip(spans, kids):
        out[s[0]] = out.get(s[0], 0) + (s[2] - s[1]) - k
    return out


def launch_delays_ns(w: Window) -> List[int]:
    """Each ``k2.launch`` span's start to the start of the K2 kernel it
    launched, paired in order: K2 runs on one stream in launch order."""
    launches = sorted(s[1] for s in w.named(LAUNCH))
    kernels = sorted(a for n, a, _ in w.events if n.startswith(K2_FIRST))
    return [k - s for s, k in zip(launches, kernels)]


def record(w: Window) -> dict:
    """What the window's notes say: ms per step and idle share; per span
    name the idle time it covers (ms a step) and its self time a chunk
    (us); the share of idle time inside no ``step`` span; the launch to
    kernel delay (us) as p50 and p99, with the count that starts before its
    launch span (none, on one clock); the window's clock (:func:`align`)."""
    chunks = w.chunks()
    busy = sum(b - a for a, b in union([(a, b) for _, a, b in w.events]))
    selfs = self_ns(w.spans)
    idle_ms, self_us = {}, {}
    for name in NAMES:
        if w.named(name):
            idle_ms[name] = idle_inside(w, name)[0] / 1e6 / w.steps
            self_us[name] = selfs[name] / 1e3 / chunks if chunks else None
    in_steps, all_idle = idle_inside(w, STEP)
    d = launch_delays_ns(w)
    q = statistics.quantiles(d, n=100) if len(d) >= 2 else None
    tenth = -(-len(d) // 10)
    return {
        "ms_per_step": 1e3 * w.window_s / w.steps,
        "idle_share": 1.0 - busy / 1e9 / w.window_s,
        "idle_ms_per_step": all_idle / 1e6 / w.steps,
        "idle_ms_per_step_inside": idle_ms,
        "self_us_per_chunk": self_us,
        "idle_outside_steps_share": 1.0 - in_steps / all_idle if all_idle else None,
        "launch_delay_us": None if q is None else {
            "p50": q[49] / 1e3, "p99": q[98] / 1e3, "min": min(d) / 1e3,
            "early": sum(1 for x in d if x < 0), "paired": len(d),
            # the least delay in each tenth of the window: flat on one clock
            "min_by_tenth": [min(d[i:i + tenth]) / 1e3 for i in range(0, len(d), tenth)],
            "launch_spans": len(w.named(LAUNCH)),
            "k2_kernels": sum(1 for n, _, _ in w.events if n.startswith(K2_FIRST))},
        "spans": {name: len(w.named(name)) for name in NAMES},
        "chunks": chunks,
        "clock": w.clock,
    }


# ---------------------------------------------------------------------------
# The window on the card
# ---------------------------------------------------------------------------


def device_events_ns(prof) -> List[Tuple[str, int, int]]:
    """``(short name, start ns, end ns)`` of every device activity of a
    finished profile, without annotations (``trace.device_events`` in
    whole nanoseconds: float seconds on the epoch keep a quarter of a
    microsecond), and the anchor kernels whatever the length stamped."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        name = short(e.name())
        if e.duration_ns() > 0 or ANCHOR in name:
            out.append((name, e.start_ns(), e.start_ns() + max(0, e.duration_ns())))
    return out


def anchors(n: int = ANCHORS) -> List[Interval]:
    """``n`` host brackets ``(before, after)`` on ``time.time_ns()``, each
    around one tiny kernel (``torch.cuda._sleep``) between two
    synchronizations: that kernel ran inside its bracket."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time_ns()
        torch.cuda._sleep(ANCHOR_CYCLES)
        torch.cuda.synchronize()
        out.append((t0, time.time_ns()))
    return out


def _offset(brackets: Sequence[Interval], kernels: Sequence[Interval]) -> Tuple[float, float]:
    """``(offset, half width)`` in ns that takes the anchor kernels'
    device timestamps into all their host brackets: the middle of the
    intersection of the ranges each bracket allows (of the ranges'
    middles where they share no point, drift or jitter inside the burst)."""
    lo = max(b0 - k0 for (b0, _), (k0, _) in zip(brackets, kernels))
    hi = min(b1 - k1 for (_, b1), (_, k1) in zip(brackets, kernels))
    return (lo + hi) / 2, (hi - lo) / 2


def align(events, head: Sequence[Interval], tail: Sequence[Interval]):
    """The device ``events`` on the host's clock, without the anchor
    kernels, and the clock's record. ``head`` and ``tail`` are the host
    brackets of the anchor bursts before and after the steps
    (:func:`anchors`). The profiler stamps device operations on the
    approximate (TSC-based) clock and converts them to Unix ns; where the
    host's TSC is not invariant, the result drifts against
    ``time.time_ns()`` within a window. Each burst gives the offset at its
    end of the window; between them it is taken as linear in time."""
    marks = sorted((a, b) for n, a, b in events if ANCHOR in n)
    rest = [e for e in events if ANCHOR not in e[0]]
    if len(marks) != len(head) + len(tail) or not head or not tail:
        return rest, {"aligned": False, "anchor_kernels": len(marks),
                      "anchors": len(head) + len(tail)}
    (oa, wa), (ob, wb) = _offset(head, marks[:len(head)]), _offset(tail, marks[len(head):])
    ta, tb = marks[len(head) - 1][0], marks[len(head)][0]
    slope = (ob - oa) / (tb - ta)

    def on_host(t: int) -> int:
        return int(round(t + oa + slope * (t - ta)))

    out = [(n, on_host(a), on_host(b)) for n, a, b in rest]
    return out, {"aligned": True, "offset_us": [oa / 1e3, ob / 1e3],
                 "half_width_us": [wa / 1e3, wb / 1e3], "drift_ppm": 1e6 * slope}


def profile(prog, steps: int, record_spans) -> Window:
    """``steps`` steps of ``prog`` under a CUDA-only profile with the
    program's recorder ``record_spans`` on, set up as ``trace.profile``
    sets up its window (a discarded profile of one step first), with a
    burst of anchor kernels before and after the steps (:func:`align`),
    outside the window's time."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA]
    with torch_profile(activities=acts):
        prog.step()
    torch.cuda.synchronize()
    with torch_profile(activities=acts) as prof:
        head = anchors()
        record_spans(True)
        t0 = time.perf_counter()
        for _ in range(steps):
            prog.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        spans = record_spans(False)
        tail = anchors()
    raw = device_events_ns(prof)
    events, clock = align(raw, head, tail)
    unaligned = Window(spans, [e for e in raw if ANCHOR not in e[0]], steps, window_s)
    clock["early_unaligned"] = sum(1 for d in launch_delays_ns(unaligned) if d < 0)
    return Window(spans, events, steps, window_s, clock)
