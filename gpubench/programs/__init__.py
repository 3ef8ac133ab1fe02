"""The runners of the program under test, one module a way of running it.

A configuration names its runner by ``program``:
``gpubench/programs/<program>.py`` gives ``build(cfg, workload, inputs,
spans)``, which builds the program's training step over the benchmark's
inputs (:class:`gpubench.harness.Inputs`) and returns an object with

- ``step() -> float``: one step of the window's own call, ended by the
  loss's ``.item()``;
- ``first_grad()``: step 1's gradient of each parameter as the optimizer
  got it, worked out from the optimizer's state (None for a leaf it has
  no state of);
- ``snapshot()``: each parameter now, in float32;
- ``record_spans(on)`` and ``pass_ms()``: the spans it records while on
  (``spans`` true), in milliseconds;
- ``program_spans(on) -> list``: the program's own span recorder switched
  on or off, returning what it recorded since it was last switched (the
  spans of ``gpubench/spans.py``; an empty list where the program records
  none);
- ``counters()``: the program's own counters now, by name;
- ``notes()``: what the run prints about the program's set-up.

The module also gives ``FAULTS``: name to a context manager that plants
that fault in the path this runner drives (``gpubench/faults.py`` adds
``state_unchanged``, which holds for every runner).

A runner may import the program; the reference and the traffic may not.
"""
from __future__ import annotations

import importlib


def runner(name: str):
    """The runner module ``gpubench/programs/<name>.py``."""
    return importlib.import_module(f"gpubench.programs.{name}")
