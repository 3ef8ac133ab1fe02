"""Profiling and timing utilities.

Port of ``textgcn_tpu/utils/profiling.py``:

- :class:`StageTimer`: named wall-clock scopes with a report (the same
  code);
- :func:`trace`: a ``torch.profiler`` scope over the CPU and the CUDA
  device that writes a Chrome trace (``trace.json``, open it in Perfetto or
  ``chrome://tracing``) into a directory;
- :func:`device_memory` / :func:`device_memory_stats`: memory of one CUDA
  device, or of each visible one.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict
from typing import Dict, Iterator

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


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Memory of each visible CUDA device in MB (empty without one)."""
    out: Dict[str, Dict[str, float]] = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        out.update(device_memory(torch.device("cuda", i)))
    return out
