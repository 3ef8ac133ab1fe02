"""Beyond-memory training: the two-layer GCN's train step (forward,
backward, Adam) over a symmetric edge stream that is never resident.

Port of the GCN part of ``textgcn_tpu/train/streamed.py``. Both
aggregations go through a stream node (:mod:`textgcn_tpu_torch.train.streamtape`)
over a sorted chunk source (:mod:`textgcn_tpu_torch.ops.streamed_sorted`), so
neither direction holds the edge list or an [E, F] residual. Features stay
bf16 at scale; sums are f32. The model is ``models/gcn.py``'s math with
masked cross-entropy and Adam, without dropout and without a val split (the
JAX streamed step's conventions).

Dtypes at each point, as in the JAX ``make_streamed_train_step_segmented``:
``s1 = x W1`` in the stream dtype ``sd`` (an f32 product, cast once),
``a1 = Â s1`` f32, ``s2 = relu(a1 + b1) W2`` in ``sd``, ``a2 = Â s2`` f32,
the loss f32. ``dW1 = xᵀ g`` is an f32 product of the bf16 operands, as the
JAX hand-written backward computes it.

Not ported: the monolithic ``make_streamed_train_step`` /
``streamed_gcn_forward`` and ``symmetrize_edge_fn`` (XLA's whole-step
compile over the unsorted stream); the pre-tape hand steps; the
``_make_padded_stream`` 128-lane pad (a TPU gather-granule fix; an odd
width pads one column inside ``spmm_streamed_sorted``); the other streamed
families (SGC, APPNP, SAGE, GIN, GCNII; ROADMAP A.10).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from textgcn_tpu_torch.models.gcn import gcn_init
from textgcn_tpu_torch.ops.row_reduce import row_reduce
from textgcn_tpu_torch.ops.streamed_sorted import spmm_streamed_sorted_hostfed
from textgcn_tpu_torch.train.streamtape import make_tape_step

# rows per block of an f32 product of bf16 operands (a [1M, 128] f32 block
# is 512 MB; the bf16 table itself is never copied whole)
_MM_ROWS = 1 << 20


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 products and sums for any float operands (JAX's
    ``preferred_element_type=float32``): bf16 operands are widened a block
    of rows at a time."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    return torch.cat([blk.float() @ b.float() for blk in a.split(_MM_ROWS)])


def _mm_t_f32(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``aᵀ @ g`` in f32 for any float operands, summed over row blocks."""
    if a.dtype == torch.float32 and g.dtype == torch.float32:
        return a.T @ g
    out = None
    for ab, gb in zip(a.split(_MM_ROWS), g.split(_MM_ROWS)):
        part = ab.float().T @ gb.float()
        out = part if out is None else out.add_(part)
    return out


class _Project(torch.autograd.Function):
    """``(x @ w.to(x.dtype)).to(sd)`` with an f32 product, differentiable in
    ``w``: ``dw = xᵀ g.to(x.dtype)`` in f32 (the JAX ``dense1`` and
    ``dense1_bwd``). ``x`` is saved by reference."""

    @staticmethod
    def forward(ctx, x, w, sd):
        ctx.save_for_backward(x)
        return _mm_f32(x, w.to(x.dtype)).to(sd)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return None, _mm_t_f32(x, g.to(x.dtype)), None


def _masked_ce(logits, y, mask):
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None].long())[:, 0]
    return (nll * mask).sum() / mask.sum()


def make_sorted_stream(chunks, reduce=row_reduce):
    """The stream ``v -> Â v`` (f32) of the train step over a re-iterable
    sorted chunk source (see ``_make_padded_stream`` in the JAX package; no
    lane padding here). Chunks on v's device are reduced where they lie;
    host chunks are copied in one ahead of the reduce
    (:func:`spmm_streamed_sorted_hostfed`), so a :class:`CachedChunkSource`
    whose budget is below the graph's chunk bytes trains a graph that does
    not fit on the device."""
    return partial(spmm_streamed_sorted_hostfed, chunks, reduce=reduce)


def make_streamed_train_step_segmented(
    stream, n_nodes: int, optimizer, stream_dtype=torch.bfloat16
):
    """The streamed GCN train step on a :class:`StreamTape`.

    ``stream(v [n_nodes, F]) -> Â v [n_nodes, F] f32`` is a symmetric
    operator (:func:`make_sorted_stream`); ``optimizer`` holds the
    parameters (:func:`init_streamed`). Returns ``step(params, x, y, mask)
    -> loss``: ``params`` the flat ``gcn_init`` dict, ``x`` [n_nodes, F]
    (bf16 at scale), ``y`` int labels, ``mask`` f32 weights of the loss.
    Four streamed passes per step: two forward, two in the backward.
    """
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        if x.shape[0] != n_nodes:
            raise ValueError(f"x has {x.shape[0]} rows, the stream {n_nodes}")
        s1 = _Project.apply(x, params["gc1.w"], sd)
        a1 = tape.stream_node(s1)
        s2 = (torch.relu(a1 + params["gc1.b"]) @ params["gc2.w"]).to(sd)
        a2 = tape.stream_node(s2)
        return _masked_ce(a2 + params["gc2.b"], y, mask)

    return make_tape_step(build, stream, optimizer, sd)


def init_streamed(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int,
    *, device, lr: float = 0.02,
) -> Tuple[Dict[str, torch.Tensor], torch.optim.Optimizer]:
    """``(params, optimizer)`` for the streamed step: ``gcn_init``'s
    parameters (requiring grad) and Adam with the trainer's settings."""
    params = gcn_init(generator, n_feat, n_hidden, n_class, device=device)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return params, opt
