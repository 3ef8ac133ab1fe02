"""TextGCN (Yao, Mao & Luo, arXiv:1809.05679): the 2-layer GCN
``Z = Â drop(relu(Â X W1 + b1)) W2 + b2`` with identity features, X = I_N,
so that ``X W1`` is ``W1`` itself, of shape [n_nodes, hidden]; inverted
dropout between the layers; the masked mean cross-entropy; Adam.

Each ``Â`` reads its operand stored at the configuration's ``low`` dtype
and sums in float32; in the backward the cotangent is stored at ``low``
on its way into ``Âᵀ`` and the product comes out in float32 (the port's
hybrid pass casts its operand inside the pass, outside autograd).
``relu(.) W2`` is float32. The dropout mask is
``torch.rand(h.shape, generator=g) < 1 - p`` on the device, from one
generator seeded with ``dropout_seed`` and kept on the ``Ops`` object the
trainer passes, so each reference or control run draws from the seed.

An epoch of the program is a train step and an eval forward with the
validation metrics read back: ``pass_widths`` are the train step's passes,
``eval_pass_widths`` the eval forward's, and ``step_work`` the epoch's
work. A pass's least bytes (``spmm_pass``) read Â's values at bfloat16, the
dtype the configuration states for them.
"""
from __future__ import annotations

import math

import torch

from gpubench import yardstick as ys
from gpubench.reference import _Propagate, _Round, masked_ce


def param_shapes(cfg):
    n, h, c = cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
    return {"gc1.w": (n, h), "gc1.b": (h,), "gc2.w": (h, c), "gc2.b": (c,)}


def propagate(ops, v):
    """``Â v`` with ``v`` stored at ``low``; ``Âᵀ`` takes the cotangent
    stored at ``low`` and hands back its product as it is."""
    return _Propagate.apply(_Round.apply(v, ops.low, None), ops.graph, ops.low)


def dropout(ops, h, cfg):
    p = cfg["dropout"]
    if p <= 0.0:
        return h
    gen = getattr(ops, "dropout_generator", None)
    if gen is None:
        gen = torch.Generator(device=h.device).manual_seed(cfg["dropout_seed"])
        ops.dropout_generator = gen
    keep = 1.0 - p
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def loss(params, x, y, mask, ops, cfg):
    s1 = params["gc1.w"] if x is None else ops.product(x, params["gc1.w"])
    h = dropout(ops, torch.relu(propagate(ops, s1) + params["gc1.b"]), cfg)
    a2 = propagate(ops, h @ params["gc2.w"])
    return masked_ce(a2 + params["gc2.b"], y, mask)


def pass_widths(cfg):
    """The train step's passes: two forward, their two transposes."""
    h, c = cfg["n_hidden"], cfg["n_class"]
    return [h, c, c, h]


def eval_pass_widths(cfg):
    """The eval forward's passes."""
    return [cfg["n_hidden"], cfg["n_class"]]


def spmm_pass(graph, width: int) -> ys.Op:
    """One pass ``Â x`` at ``width`` columns, whatever layout runs it:
    Â's CSR once (int32 row pointers and columns, bfloat16 values), each
    bfloat16 row of ``x`` once, each float32 output row written once;
    ``2 E F`` products, exact in float32 from bfloat16 operands, at the
    tensor cores' peak."""
    n, e = graph.n_rows, graph.n_edges
    n_bytes = (n + 1) * ys.I32 + e * (ys.I32 + ys.BF16) + n * width * (ys.BF16 + ys.F32)
    return ys.Op(f"pass F={width}", n_bytes, 2.0 * e * width, ys.PEAK_BF16)


def step_work(cfg, graph):
    """An epoch's work, each op reading its inputs once and writing its
    outputs once: the train step (forward with the dropout mask, loss,
    backward, Adam over every parameter), then the eval forward and the
    validation metrics."""
    n, h, c = graph.n_rows, cfg["n_hidden"], cfg["n_class"]
    v = cfg["val_rows"]
    B, F, I = ys.BF16, ys.F32, ys.I64
    n_params = sum(math.prod(s) for s in param_shapes(dict(cfg, n_feat=n)).values())
    return [
        spmm_pass(graph, h),
        ys.elementwise("b1, relu, dropout mask and its use", n * h * (F + 1 + F), 4 * n * h),
        ys.matmul("s2 = h W2", n, h, c, n * h * F, n * c * B, ys.PEAK_F32),
        spmm_pass(graph, c),
        ys.elementwise("masked cross-entropy and its gradient",
                       n * c * F + n * I + n * F + n * c * B, 8 * n * c),
        spmm_pass(graph, c),
        ys.Op("dW2, g W2^T, dropout and relu'", n * c * F + n * h * (F + 1) + n * h * B,
              4.0 * n * h * c, ys.PEAK_F32),
        spmm_pass(graph, h),
        # parameter, gradient and both moments read; parameter and moments written
        ys.elementwise("Adam", n_params * 7 * F, 12 * n_params),
        spmm_pass(graph, h),
        ys.elementwise("eval b1 and relu", n * h * 2 * F, n * h),
        ys.matmul("eval s2 = h W2", n, h, c, n * h * F, n * c * B, ys.PEAK_F32),
        spmm_pass(graph, c),
        ys.elementwise("validation loss, accuracy and macro F1", v * (c * F + I), 16 * v * c),
    ]
