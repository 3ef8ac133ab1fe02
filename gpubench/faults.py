"""Faults planted in the program's timed path, for the calibration of the
limits (``gpubench/calibrate.py``) and the tests that see ``correct`` come
out false. Each is a context manager that patches the program while it is
open; none is used by a benchmark run."""
from __future__ import annotations

import contextlib
import itertools

import torch


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns the parameters unchanged."""
    orig = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = orig


@contextlib.contextmanager
def half_batch():
    """The loss leaves out the second half of the rows and takes the mean
    over the rest."""
    from textgcn_tpu_torch.train import streamed as st

    orig = st._masked_ce

    def half(logits, y, mask, count=None):
        h = logits.shape[0] // 2
        return orig(logits[:h], y[:h], mask[:h], count)

    st._masked_ce = half
    try:
        yield
    finally:
        st._masked_ce = orig


@contextlib.contextmanager
def chunks_left_out():
    """Every streamed pass reduces every other chunk only."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss

    orig = ss.streamed_sorted_add_

    def skip(acc, chunks, x, reduce=ss.row_reduce):
        return orig(acc, itertools.islice(chunks, 0, None, 2), x, reduce)

    ss.streamed_sorted_add_ = skip
    try:
        yield
    finally:
        ss.streamed_sorted_add_ = orig


FAULTS = {
    "state_unchanged": state_unchanged,
    "half_batch": half_batch,
    "chunks_left_out": chunks_left_out,
}
