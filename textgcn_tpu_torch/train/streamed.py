"""Beyond-memory training: the train steps (forward, backward, Adam) of the
six non-GAT families over a symmetric edge stream that is never resident.

Port of ``textgcn_tpu/train/streamed.py``: the tape-built segmented steps of
the GCN, SGC, APPNP, GraphSAGE, GIN and GCNII
(:data:`STREAMED_SEGMENTED_FACTORIES`, the JAX registry's keys). Every
aggregation goes through a stream node
(:mod:`textgcn_tpu_torch.train.streamtape`) over a sorted chunk source
(:mod:`textgcn_tpu_torch.ops.streamed_sorted`), so neither direction holds
the edge list or an [E, F] residual. Features stay bf16 at scale; sums are
f32. The models are ``models/*.py``'s math with masked cross-entropy and
Adam, without dropout and without a val split (the JAX streamed steps'
conventions).

Each step follows its JAX function's dtypes and gradients. The pieces that
read the wide ``x`` ([10M, 128] bf16 at the baseline scale config) are
``autograd.Function`` pieces that save ``x`` by reference and widen it a
block of rows at a time (:func:`_mm_f32`, :func:`_mm_t_f32`), so its f32 copy never
becomes an autograd residual: the counterpart of the JAX ``tape.custom``
nodes. The narrow pieces are plain autograd, whose casts give the JAX
``jax.vjp`` pieces' cotangent dtypes (a bf16 value's cotangent is bf16, and
fan-out cotangents meet in their value's dtype).

GCN dtypes, as in the JAX ``make_streamed_train_step_segmented``:
``s1 = x W1`` in the stream dtype ``sd`` (an f32 product, cast once),
``a1 = Â s1`` f32, ``s2 = relu(a1 + b1) W2`` in ``sd``, ``a2 = Â s2`` f32,
the loss f32. ``dW1 = xᵀ g`` is an f32 product of the bf16 operands, as the
JAX hand-written backward computes it.

Not ported: the monolithic ``make_streamed_{,sgc_,appnp_}train_step`` and
``streamed_{gcn,sgc,appnp}_forward``, and ``symmetrize_edge_fn`` (XLA's
whole-step compile over the unsorted stream); the pre-tape hand steps; the
``_make_padded_stream`` 128-lane pad (a TPU gather-granule fix; an odd
width pads one column inside ``spmm_streamed_sorted``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.models.appnp import DEFAULT_ALPHA as APPNP_ALPHA, DEFAULT_K as APPNP_K
from textgcn_tpu_torch.models.gcnii import (
    DEFAULT_ALPHA as GCNII_ALPHA, DEFAULT_K as GCNII_K, DEFAULT_LAMBDA as GCNII_LAMBDA,
    gcnii_betas,
)
from textgcn_tpu_torch.models.sgc import DEFAULT_K as SGC_K
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


class _ReluLayer(torch.autograd.Function):
    """``relu(x @ w' + extra + b)`` with an f32 product of ``x`` and ``w' =
    w.to(x.dtype)`` (``cast_w``) or of ``x`` widened to f32 and ``w`` as it
    is; ``extra`` (an f32 [N, H] term) may be None. Differentiable in ``w``,
    ``b`` and ``extra``: ``dpre = g`` where the output is positive, ``dw =
    xᵀ dpre.to(x.dtype)`` in f32, ``db = Σ dpre``, ``dextra = dpre`` (the
    JAX ``_mlp_bwd_impl``'s first layer, ``_layer1_bwd_impl``,
    ``_fc_in_bwd_impl``). ``x`` is saved by reference, and the [N, H]
    output, which its consumers keep alive anyway, in place of ``pre``."""

    @staticmethod
    def forward(ctx, x, w, b, extra, cast_w):
        pre = _mm_f32(x, w.to(x.dtype) if cast_w else w)
        if extra is not None:
            pre = pre + extra
        out = torch.relu(pre + b)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        dpre = torch.where(out > 0, g, 0.0)
        dextra = dpre if ctx.needs_input_grad[3] else None
        return None, _mm_t_f32(x, dpre.to(x.dtype)), dpre.sum(0), dextra, None


def _masked_ce(logits, y, mask, count=None):
    """The masked mean of the cross-entropy: ``count(mask)`` is the
    denominator where it is given (a sharded step's global count), else
    ``mask.sum()``."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None].long())[:, 0]
    return (nll * mask).sum() / (mask.sum() if count is None else count(mask))


def _check_rows(x, n_nodes):
    if x.shape[0] != n_nodes:
        raise ValueError(f"x has {x.shape[0]} rows, the stream {n_nodes}")


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
    stream, n_nodes: int, optimizer, stream_dtype=torch.bfloat16, **hooks
):
    """The streamed GCN train step on a :class:`StreamTape`.

    ``stream(v [n_nodes, F]) -> Â v [n_nodes, F] f32`` is a symmetric
    operator (:func:`make_sorted_stream`); ``optimizer`` holds the
    parameters (:func:`init_streamed`). Returns ``step(params, x, y, mask)
    -> loss``: ``params`` the flat ``gcn_init`` dict, ``x`` [n_nodes, F]
    (bf16 at scale), ``y`` int labels, ``mask`` f32 weights of the loss.
    Four streamed passes per step: two forward, two in the backward. The
    other families' steps take and return the same, with their family's
    parameters. ``hooks`` (``count``, ``grad_sync``) go to
    :func:`~textgcn_tpu_torch.train.streamtape.make_tape_step`: the sharded
    steps' global denominator and gradient all-reduce; none by default.
    """
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        s1 = _Project.apply(x, params["gc1.w"], sd)
        a1 = tape.stream_node(s1)
        s2 = (torch.relu(a1 + params["gc1.b"]) @ params["gc2.w"]).to(sd)
        a2 = tape.stream_node(s2)
        return _masked_ce(a2 + params["gc2.b"], y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


def make_streamed_sgc_train_step_segmented(
    stream, n_nodes: int, optimizer, k: int = SGC_K, stream_dtype=torch.bfloat16, **hooks
):
    """The streamed SGC step (the JAX ``make_streamed_sgc_train_step_segmented``):
    ``z = (x W).to(sd)`` through :class:`_Project`, ``k`` chained stream
    nodes, ``masked_ce(z + b)``. ``2k`` streamed passes per step at width C."""
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        z = _Project.apply(x, params["lin.w"], sd)
        for _ in range(k):
            z = tape.stream_node(z)
        return _masked_ce(z + params["lin.b"], y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


def make_streamed_appnp_train_step_segmented(
    stream, n_nodes: int, optimizer, alpha: float = APPNP_ALPHA, k: int = APPNP_K,
    stream_dtype=torch.bfloat16, **hooks,
):
    """The streamed APPNP step (the JAX ``make_streamed_appnp_train_step_segmented``):
    the MLP ``h = relu(x W1 + b1) W2 + b2`` (f32; its first layer a
    :class:`_ReluLayer`, so ``dW1 = xᵀ dpre.to(x.dtype)``), then ``k`` times
    ``z = (1-α)·Â z + α·h``; ``h`` fans out into every iteration and its
    cotangents add up in f32. ``2k`` streamed passes per step at width C."""
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        h1 = _ReluLayer.apply(x, params["fc1.w"], params["fc1.b"], None, True)
        h = h1 @ params["fc2.w"] + params["fc2.b"]
        z = h
        for _ in range(k):
            z = (1.0 - alpha) * tape.stream_node(z) + alpha * h
        return _masked_ce(z, y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


def make_streamed_sage_train_step_segmented(
    stream, n_nodes: int, optimizer, stream_dtype=torch.bfloat16, **hooks
):
    """The streamed GraphSAGE step (the JAX
    ``make_streamed_sage_train_step_segmented``): ``n1 = Â (x Wn1).to(sd)``,
    ``h = relu(x Ws1 + n1 + b1)`` (a :class:`_ReluLayer`: ``dn1 = dpre`` in
    f32), ``n2 = Â (h Wn2).to(sd)``, ``masked_ce(h Ws2 + n2 + b2)``; ``h``
    fans out to both legs of layer 2. Four streamed passes per step, at
    widths H and C."""
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        n1 = tape.stream_node(_Project.apply(x, params["sage1.w_neigh"], sd))
        h = _ReluLayer.apply(x, params["sage1.w_self"], params["sage1.b"], n1, True)
        n2 = tape.stream_node((h @ params["sage2.w_neigh"]).to(sd))
        logits = h @ params["sage2.w_self"] + n2 + params["sage2.b"]
        return _masked_ce(logits, y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


def make_streamed_gin_train_step_segmented(
    stream, n_nodes: int, optimizer, stream_dtype=torch.bfloat16, **hooks
):
    """The streamed GIN step (the JAX ``make_streamed_gin_train_step_segmented``),
    with the reassociated aggregation ``(1+ε)(v W) + Â (v W)`` so that every
    pass runs at width H or C: ``s1 = (x W1).to(sd)``, ``a1 = Â s1``, ``s2 =
    (relu(relu((1+ε1) s1 + a1 + b1) W2 + b2) Whead).to(sd)``, ``a2 = Â s2``,
    ``masked_ce((1+ε2) s2 + a2 + b)``. Autograd gives the JAX ``_mid_bwd_impl``'s
    casts: ``dε1 = Σ dz1·s1``, ``s1``'s cotangent ``((1+ε1) dz1)`` rounded to
    bf16 where it meets the stream node's, ``a1``'s in f32; ``s2``'s two
    cotangents meet in bf16. ``s1`` is kept for the backward (the JAX step
    recomputes it from ``x`` to save 0.3 GB on a 16 GB chip; the values are
    the same). Four streamed passes per step."""
    sd = stream_dtype

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        s1 = _Project.apply(x, params["gin1.w1"], sd)
        a1 = tape.stream_node(s1)
        z1 = (1.0 + params["gin1.eps"]) * s1.float() + a1 + params["gin1.b1"]
        h2 = torch.relu(torch.relu(z1) @ params["gin1.w2"] + params["gin1.b2"])
        s2 = (h2 @ params["gin2.w"]).to(sd)
        a2 = tape.stream_node(s2)
        logits = (1.0 + params["gin2.eps"]) * s2.float() + a2 + params["gin2.b"]
        return _masked_ce(logits, y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


def make_streamed_gcnii_train_step_segmented(
    stream, n_nodes: int, optimizer, k: int = GCNII_K, alpha: float = GCNII_ALPHA,
    lam: float = GCNII_LAMBDA, stream_dtype=torch.bfloat16, **hooks,
):
    """The streamed GCNII step (the JAX ``make_streamed_gcnii_train_step_segmented``):
    ``h0 = relu(x W + b)`` with ``x`` widened to f32 and ``W`` not cast (the
    JAX ``fc_in`` promotes ``x``; its backward still rounds ``dpre`` to
    ``x.dtype`` for ``dW``), then ``k`` layers ``s = (1-α)·Â h + α·h0``, ``h
    = relu((1-β_l) s + β_l s W_l)`` with ``W_l = deep.w[l]`` and ``β_l =
    log(λ/l + 1)``, then ``masked_ce(h Wout + bout)``; ``h0`` fans out into
    every layer. ``2k`` streamed passes per step at width H."""
    sd = stream_dtype
    betas = [float(b) for b in gcnii_betas(k, lam)]

    def build(tape, params, x, y, mask):
        _check_rows(x, n_nodes)
        h0 = _ReluLayer.apply(x, params["fc_in.w"], params["fc_in.b"], None, False)
        h = h0
        for l, beta in enumerate(betas):
            s = (1.0 - alpha) * tape.stream_node(h) + alpha * h0
            h = torch.relu((1.0 - beta) * s + beta * (s @ params["deep.w"][l]))
        return _masked_ce(h @ params["fc_out.w"] + params["fc_out.b"], y, mask, tape.count)

    return make_tape_step(build, stream, optimizer, sd, **hooks)


# family name -> streamed step factory, the JAX registry's keys
STREAMED_SEGMENTED_FACTORIES = {
    "gcn": make_streamed_train_step_segmented,
    "sgc": make_streamed_sgc_train_step_segmented,
    "appnp": make_streamed_appnp_train_step_segmented,
    "sage": make_streamed_sage_train_step_segmented,
    "gin": make_streamed_gin_train_step_segmented,
    "gcnii": make_streamed_gcnii_train_step_segmented,
}


def init_streamed(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int,
    *, device, lr: float = 0.02, family: str = "gcn",
) -> Tuple[Dict[str, torch.Tensor], torch.optim.Optimizer]:
    """``(params, optimizer)`` for the streamed step of ``family`` (a key of
    :data:`STREAMED_SEGMENTED_FACTORIES`): the family's ``*_init``
    parameters with its defaults (requiring grad) and Adam with the
    trainer's settings."""
    if family not in STREAMED_SEGMENTED_FACTORIES:
        raise ValueError(
            f"no streamed step for {family!r}; choose one of "
            f"{sorted(STREAMED_SEGMENTED_FACTORIES)}"
        )
    params = MODELS[family].init_params(generator, n_feat, n_hidden, n_class, device=device)
    for p in params.values():
        p.requires_grad_(True)
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return params, opt
