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
  then the optimizer's step.

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

from typing import Callable

import torch

from textgcn_tpu_torch.ops.streamed_sorted import stream_node


class StreamTape:
    """Holds one train step's stream and stream dtype for ``build``."""

    def __init__(self, stream: Callable, stream_dtype=torch.bfloat16):
        self.stream = stream
        self.sd = stream_dtype

    def stream_node(self, v: torch.Tensor) -> torch.Tensor:
        """``Â v`` (f32), differentiable in ``v`` through the same stream."""
        return stream_node(v, self.stream, self.sd)


def make_tape_step(
    build: Callable, stream: Callable, optimizer, stream_dtype=torch.bfloat16
):
    """A train step from a model ``build`` function.

    ``build(tape, params, x, y, mask) -> loss`` composes the model from
    tensor code and ``tape.stream_node`` calls. The returned
    ``step(params, x, y, mask) -> loss`` (detached) clears the gradients,
    runs the forward, ``loss.backward()`` and ``optimizer.step()``; after it
    each parameter's ``.grad`` holds this step's gradient.
    """

    def step(params, x, y, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = build(StreamTape(stream, stream_dtype), params, x, y, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
