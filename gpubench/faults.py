"""Faults planted in the program's timed path, for the calibration of the
limits (``gpubench/calibrate.py``) and the tests that see ``correct`` come
out false. Each is a context manager that patches the program while it is
open; none is used by a benchmark run.

``state_unchanged`` patches torch's Adam and so holds for every runner;
the faults of one runner's path are its module's ``FAULTS``
(``gpubench/programs/<runner>.py``), found by the runner's name.
"""
from __future__ import annotations

import contextlib

import torch

from gpubench import programs


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns the parameters unchanged."""
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


def for_program(name: str) -> dict:
    """The faults of runner ``name``: ``state_unchanged`` and the runner's
    own ``FAULTS``, by name."""
    return {"state_unchanged": state_unchanged, **programs.runner(name).FAULTS}
