"""Profiling and timing utilities.

Port of ``textgcn_tpu/utils/profiling.py``:

- :class:`StageTimer`: named wall-clock scopes with a report (the same
  code);
- :func:`trace`: a ``torch.profiler`` scope over the CPU and the CUDA
  device that writes a Chrome trace (``trace.json``, open it in Perfetto or
  ``chrome://tracing``) into a directory;
- :func:`device_memory`: memory of one CUDA device.

The port's own, with no JAX counterpart: the span recorder
(:func:`record_spans`, :func:`begin`, :func:`end`, :func:`leaf`), the
host's time inside the streamed step and the resident epoch on the
Unix-epoch clock that
``torch.profiler`` stamps its events on, so that a span and the device's
activity of the same window compare directly.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from itertools import count
from typing import Dict, Iterator, List, NamedTuple

import torch


class StageTimer:
    def __init__(self):
        self.times: "OrderedDict[str, float]" = OrderedDict()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'stage':<30} {'seconds':>10} {'share':>7}"]
        for name, t in self.times.items():
            share = t / total if total else 0.0
            lines.append(f"{name:<30} {t:>10.2f} {share:>6.1%}")
        lines.append(f"{'TOTAL':<30} {total:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on the CPU and, where one is visible, the CUDA
    device; on exit write ``{log_dir}/trace.json`` (a Chrome trace)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory(device: torch.device) -> Dict[str, Dict[str, float]]:
    """Memory of a CUDA device in MB, from ``torch.cuda.memory_stats``
    (empty for the CPU)."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {
        str(device): {
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
            "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6,
            "bytes_limit_mb": total / 1e6,
        }
    }


# ---------------------------------------------------------------------------
# The span recorder
# ---------------------------------------------------------------------------
#
# Process-wide and off by default: the streamed step's sites (train/streamtape.py
# ``step``; ops/streamed_sorted.py ``pass``, ``chunk.fetch``, ``chunk.feed``,
# ``chunk.sync``; ops/row_reduce.py ``k2.launch``) and the resident epoch's
# (train/trainer.py ``step``, ``train``, ``eval``; graph/reorder.py
# ``hybrid.pass``; ops/bsr_spmm.py ``k1.launch``) each read ``spans_on`` once
# and, while it is False, enter no context manager, allocate nothing and call
# nothing on the device. A chunk call takes tens of microseconds of host
# time, so a site may cost a fraction of one (``record_function`` costs about
# ten microseconds even with no profiler running). The recorder keeps its
# record in memory and writes nothing. It takes no lock: a step's spans come
# one at a time (autograd's device thread runs the backward's passes while
# the calling thread waits for it).


class Span(NamedTuple):
    """A recorded span. ``start_ns`` and ``end_ns`` are on ``time.time_ns()``'s
    clock (Unix epoch), the epoch of ``torch.profiler``'s events (the
    profiler converts device timestamps from the TSC; where the host's TSC
    is not invariant they drift against this clock over a window, and a
    reader must align them); ``parent`` is the index in the record of the span
    it lies in, and ``step`` the id of the ``step`` span it lies in (-1 for
    none); ``attrs`` are its integer attributes."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    step: int
    attrs: Dict[str, int]


spans_on = False


class _Record:
    """The spans recorded since the last switch, a list a field: ints and
    strings, which the cyclic collector does not track. A tuple a span
    would add a tracked object a span, run the collector every few hundred
    chunks and, through its full runs over the process's objects, tax the
    step it measures by milliseconds."""

    def __init__(self):
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.parents: List[int] = []
        self.steps: List[int] = []
        self.attrs: Dict[int, Dict[str, int]] = {}  # by index, of the spans that have them
        self.open: List[int] = []  # indices of the spans begun and not ended

    def add(self, name: str, start_ns: int, end_ns: int, step: bool = False) -> int:
        """Append a span inside the innermost open one; its index."""
        parent = self.open[-1] if self.open else -1
        self.names.append(name)
        self.starts.append(start_ns)
        self.ends.append(end_ns)
        self.parents.append(parent)
        self.steps.append(next(_step_ids) if step else self.steps[parent] if parent >= 0 else -1)
        return len(self.names) - 1

    def spans(self) -> List[Span]:
        fields = zip(self.names, self.starts, self.ends, self.parents, self.steps)
        return [Span(*f, self.attrs.get(i, {})) for i, f in enumerate(fields)]


_record = _Record()
_step_ids = count()  # ids of ``step`` spans, unique in the process


def record_spans(on: bool) -> List[Span]:
    """Switch the recorder on or off and return what it recorded since it
    was last switched, forgetting it. Switch between steps: a span still
    open at the switch keeps ``end_ns`` 0."""
    global spans_on, _record
    out, _record = _record, _Record()
    spans_on = bool(on)
    return out.spans()


def begin(name: str, step: bool = False) -> int:
    """Open span ``name`` inside the innermost open span and return its
    index for :func:`end`. With ``step`` it opens a new step: it and every
    span inside it carry a new step id."""
    index = _record.add(name, time.time_ns(), 0, step)
    _record.open.append(index)
    return index


def end(index: int, **attrs: int) -> None:
    """Close the innermost open span, which :func:`begin` returned as
    ``index``, with ``attrs``. A span begun before the recorder last
    switched is not in the record and is left alone."""
    t1 = time.time_ns()
    r = _record
    if not r.open or r.open[-1] != index:
        return
    r.open.pop()
    r.ends[index] = t1
    if attrs:
        r.attrs[index] = attrs


def leaf(name: str, start_ns: int) -> None:
    """Record span ``name``, which has no spans inside it and no
    attributes, from ``start_ns`` (a ``time.time_ns()`` the caller took) to
    now, inside the innermost open span."""
    t1 = time.time_ns()
    if spans_on:
        _record.add(name, start_ns, t1)
