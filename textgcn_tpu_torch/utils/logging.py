"""Logging and reporting helpers.

Port of ``textgcn_tpu/utils/logging.py`` (pure Python and numpy, so the
code is the same): the ``LogResult`` dict-of-lists aggregator, a small
monospace table formatter and the graph summary table.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np


class LogResult:
    """Accumulates per-run metric dicts into lists."""

    def __init__(self):
        self.result: Dict[str, List[Any]] = defaultdict(list)

    def update(self, result: Dict[str, Any]) -> None:
        for key, value in result.items():
            self.result[key].append(value)

    def show_str(self) -> str:
        lines = []
        for key, values in self.result.items():
            nums = [v for v in values if isinstance(v, (int, float))]
            if nums:
                lines.append(
                    f"{key}: mean={np.mean(nums):.4f} "
                    f"max={np.max(nums):.4f} min={np.min(nums):.4f}"
                )
        return "\n".join(lines)


def format_table(headers: Sequence[str], rows: Sequence[Sequence[Any]]) -> str:
    """Minimal monospace table."""
    cols = [[str(h)] + [str(r[i]) for r in rows] for i, h in enumerate(headers)]
    widths = [max(len(c) for c in col) for col in cols]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    out.append("|" + "|".join(f" {h:<{w}} " for h, w in zip(headers, widths)) + "|")
    out.append(sep)
    for r in rows:
        out.append("|" + "|".join(f" {str(v):<{w}} " for v, w in zip(r, widths)) + "|")
    out.append(sep)
    return "\n".join(out)


def graph_stats(n_nodes: int, n_edges: int, directed: bool = False) -> str:
    """Graph summary table: nodes, edges, average degree, density."""
    density = n_edges / max(n_nodes * (n_nodes - 1), 1)
    if not directed:
        density *= 2
    avg_degree = (1 if directed else 2) * n_edges / max(n_nodes, 1)
    return format_table(
        ["nodes", "edges", "avg_degree", "density"],
        [[n_nodes, n_edges, f"{avg_degree:.2f}", f"{density:.6f}"]],
    )
