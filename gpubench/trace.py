"""The traced window and its reduction to what the metric readers read.

``torch.profiler`` records the device's activity (kernels, copies, sets)
over a fixed number of steady steps, with CUDA activity only: recording the
host's operators as well would slow the host, which paces these steps. A
first, discarded profile of one step starts CUPTI outside the window. The
reduction is plain arithmetic on ``(name, start_s, end_s)`` intervals, so
that it is tested without a card.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Sequence, Tuple

import torch

# the program's K2 kernels (csrc/row_reduce.cu and the split pass of its
# long rows, csrc/row_split.cuh)
K2_KERNELS = ("row_reduce_kernel", "split_sum_kernel")
COPIES = ("Memcpy", "Memset")


def short(name: str) -> str:
    """A kernel's name without ``void``, its namespaces' noise and its
    argument list, at most 80 characters."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:80] or name[:80]


def is_k2(name: str) -> bool:
    return any(k in name for k in K2_KERNELS)


def is_copy(name: str) -> bool:
    return name.startswith(COPIES)


@dataclasses.dataclass
class Summary:
    """A traced window: its steps and host-clock length, the union of the
    device's busy intervals, the device's span (the first operation's
    start to the last one's end), device seconds and counts by operation,
    and the idle gaps by the operations on either side of them."""

    steps: int
    window_s: float
    busy_s: float
    span_s: float
    by_name: Dict[str, Tuple[float, int]]
    gaps: Dict[str, Tuple[float, int]]
    losses: List[float]

    def seconds(self, pick) -> float:
        return sum(s for n, (s, _) in self.by_name.items() if pick(n))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, (s, _) in gaps]}


def reduce(events: Sequence[Tuple[str, float, float]], window_s: float, steps: int,
           losses: List[float]) -> Summary:
    """Reduce device ``events`` (name, start s, end s) of a window of
    ``window_s`` seconds on the host's clock. A gap between busy intervals
    is named by the operation that ended before it and the one that began
    after it: the host's work between the two launches. What the window
    holds outside the first and last operation is the host's start and its
    final wait, "window edges"."""
    by_name: Dict[str, Tuple[float, int]] = {}
    for name, t0, t1 in events:
        s, c = by_name.get(name, (0.0, 0))
        by_name[name] = (s + (t1 - t0), c + 1)
    ivs = sorted(events, key=lambda e: e[1])
    busy, gaps = 0.0, {}
    span = max(e[2] for e in ivs) - ivs[0][1] if ivs else 0.0
    if ivs:
        cur_name, cur0, cur1 = ivs[0]
        for name, t0, t1 in ivs[1:]:
            if t0 > cur1:
                busy += cur1 - cur0
                label = f"after {cur_name} before {name}"
                s, c = gaps.get(label, (0.0, 0))
                gaps[label] = (s + (t0 - cur1), c + 1)
                cur_name, cur0, cur1 = name, t0, t1
            elif t1 > cur1:
                cur_name, cur1 = name, t1
        busy += cur1 - cur0
        edges = window_s - busy - sum(s for s, _ in gaps.values())
        if edges > 0:
            gaps["window edges: the first launch and the last wait"] = (edges, 1)
    return Summary(steps, window_s, busy, span, by_name, gaps, losses)


def device_events(prof) -> List[Tuple[str, float, float]]:
    """``(short name, start s, end s)`` of every device activity of a
    finished profile, without annotations."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation() or e.duration_ns() <= 0:
            continue
        out.append((short(e.name()), e.start_ns() / 1e9, (e.start_ns() + e.duration_ns()) / 1e9))
    return out


def profile(prog, steps: int) -> Summary:
    """``steps`` steps of ``prog`` under the profiler, with its spans
    recorded; the window is timed on the host's clock from after the
    profiler has started to the end of the last step."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CUDA]
    with torch_profile(activities=acts):
        prog.step()
    torch.cuda.synchronize()
    losses = []
    with torch_profile(activities=acts) as prof:
        torch.cuda.synchronize()
        prog.record_spans(True)
        t0 = time.perf_counter()
        for _ in range(steps):
            losses.append(prog.step())
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        prog.record_spans(False)
    return reduce(device_events(prof), window_s, steps, losses)
