"""The benchmark's traffic: the graphs it generates from the seed.

A configuration's ``graph`` names its generator by ``kind``:
``gpubench/traffic/<kind>.py`` gives ``make(graph_cfg, seed, device)``,
which returns a graph with

- ``n_rows``, ``n_edges``, ``n_chunks``;
- ``chunk(j)``: chunk ``j`` as a :class:`Chunk`, the chunks covering the
  rows in order, made on ``device`` from the seed;
- ``chunk_shape(j)``: its :class:`ChunkShape`, from the generator's
  parameters without a draw (what the yardstick counts);

and ``SMALL``: the configuration keys (``graph``, ``edge_scale``) that a
CPU test puts in place to run a cell of this kind at a small size.

A new graph or mix is a new module here and a configuration (or a
workload's ``graph``) that names it; nothing else changes.
"""
from __future__ import annotations

import importlib
from typing import NamedTuple

import torch


class Chunk(NamedTuple):
    """Edges of output rows ``[r0, r0 + G)`` as a row-sorted CSR."""

    row_ptr: torch.Tensor  # [G + 1] int32, local: row_ptr[0] == 0
    col: torch.Tensor  # [E_c] int32, global column
    val: torch.Tensor  # [E_c] float32
    r0: int


class ChunkShape(NamedTuple):
    """What one chunk holds: its rows, its edges, and the distinct columns
    it gathers (expected over the generator's draws)."""

    rows: int
    edges: int
    gathered: float


def generator(kind: str):
    """The generator module ``gpubench/traffic/<kind>.py``."""
    return importlib.import_module(f"gpubench.traffic.{kind}")


def make(graph_cfg: dict, seed: int, device):
    """The graph of ``graph_cfg`` drawn from ``seed`` on ``device``, by the
    generator that its ``kind`` names."""
    return generator(graph_cfg["kind"]).make(graph_cfg, seed, device)


def small(kind: str) -> dict:
    """The configuration keys that run a graph of ``kind`` at a test's
    size (the generator's ``SMALL``)."""
    return generator(kind).SMALL
