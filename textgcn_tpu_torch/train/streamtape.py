"""StreamTape: the symmetric edge-stream node of every beyond-memory train
step, and the generic step around a model's ``build`` function.

Port of ``textgcn_tpu/train/streamtape.py``. The JAX tape is an eager
reverse-mode engine of its own: jitted dense pieces differentiated by
``jax.vjp``, stream nodes with a hand-written VJP, and cotangent
accumulation for fan-out. PyTorch's autograd is that engine already, so the
port keeps only what autograd does not give:

- **the stream node** (:meth:`StreamTape.stream_node`, over
  :func:`textgcn_tpu_torch.ops.streamed_sorted.stream_node`, the
  ``autograd.Function`` that ``spmm_streamed_sorted_sym`` also uses), which
  applies a symmetric streamed operator ``stream(v) -> Â v`` (f32) with
  the exact cast discipline of the JAX ``stream_node``
  (``streamtape.py:90-112``): forward ``stream(v.to(sd))``, backward
  ``stream(g.to(sd)).to(sd).to(v.dtype)``, ``sd`` the stream dtype;
- :func:`make_tape_step`: forward through ``build``, ``loss.backward()``,
  then the optimizer's step; with the two hooks of the sharded steps
  (:mod:`textgcn_tpu_torch.parallel.streamed`): ``count``, the loss's
  denominator of a mask (the global train count, where a rank sees only its
  rows; default ``mask.sum()``), and ``grad_sync``, run on the parameters
  between the backward and the optimizer's step (the all-reduce of the
  replicated gradients; default none). The defaults leave a step as it was.

Freeing contract. Autograd saves references, not copies: a tensor a
backward needs is kept alive by the graph and not duplicated, and each
saved tensor is released once the node that saved it has run its backward.
So the JAX workarounds for ``jax.vjp``'s residual copies (``StreamTape.custom``
nodes that read wide arrays from a closure) and the explicit
``g.delete()`` of the f32 cotangent before the transpose pass
(``streamtape.py:108``) have no counterpart. The stream node saves nothing
at all; the port frees nothing by hand and relies on no aliasing rule.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from textgcn_tpu_torch.ops.streamed_sorted import stream_node
from textgcn_tpu_torch.utils import profiling


class StreamTape:
    """Holds one train step's stream, stream dtype and loss denominator
    (``count(mask)``, None for ``mask.sum()``) for ``build``."""

    def __init__(self, stream: Callable, stream_dtype=torch.bfloat16,
                 count: Optional[Callable] = None):
        self.stream = stream
        self.sd = stream_dtype
        self.count = count

    def stream_node(self, v: torch.Tensor) -> torch.Tensor:
        """``Â v`` (f32), differentiable in ``v`` through the same stream."""
        return stream_node(v, self.stream, self.sd)


def make_tape_step(
    build: Callable, stream: Callable, optimizer, stream_dtype=torch.bfloat16,
    count: Optional[Callable] = None, grad_sync: Optional[Callable] = None,
):
    """A train step from a model ``build`` function.

    ``build(tape, params, x, y, mask) -> loss`` composes the model from
    tensor code and ``tape.stream_node`` calls, and divides the loss by
    ``tape.count(mask)`` where that is set. The returned
    ``step(params, x, y, mask) -> loss`` (detached) clears the gradients,
    runs the forward, ``loss.backward()``, ``grad_sync(params)`` where that
    is set, and ``optimizer.step()``; after it each parameter's ``.grad``
    holds this step's gradient. While the span recorder is on
    (:func:`~textgcn_tpu_torch.utils.profiling.record_spans`) the step is a
    ``step`` span, whose id every span inside it carries.
    """

    def step(params, x, y, mask):
        span = profiling.begin("step", step=True) if profiling.spans_on else None
        optimizer.zero_grad(set_to_none=True)
        loss = build(StreamTape(stream, stream_dtype, count), params, x, y, mask)
        loss.backward()
        if grad_sync is not None:
            grad_sync(params)
        optimizer.step()
        if span is not None:
            profiling.end(span)
        return loss.detach()

    return step
