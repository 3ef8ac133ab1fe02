"""The 2-layer GCN of Kipf & Welling (arXiv:1609.02907, eq. 9) as the
streamed step trains it: ``Z = Â relu(Â X W1 + b1) W2 + b2``, the masked
mean cross-entropy, Adam; no dropout, no weight decay.

Each ``Â`` is a stream node: its operand stored at the configuration's
``low`` dtype, summed in float32 (``Ops.propagate``). ``X W1`` is a float32
product of ``X`` and ``W1`` rounded to the features' dtype, stored at
``low`` before ``Â`` (``Ops.product``); ``relu(.) W2`` is float32.
"""
from __future__ import annotations

import torch

from gpubench import yardstick as ys
from gpubench.reference import masked_ce


def param_shapes(cfg):
    f, h, c = cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
    return {"gc1.w": (f, h), "gc1.b": (h,), "gc2.w": (h, c), "gc2.b": (c,)}


def loss(params, x, y, mask, ops, cfg):
    a1 = ops.propagate(ops.product(x, params["gc1.w"]))
    a2 = ops.propagate(torch.relu(a1 + params["gc1.b"]) @ params["gc2.w"])
    return masked_ce(a2 + params["gc2.b"], y, mask)


def pass_widths(cfg):
    """The width of each streamed pass of one step: two forward, their two
    transposes in the backward."""
    h, c = cfg["n_hidden"], cfg["n_class"]
    return [h, c, c, h]


def step_work(cfg, graph):
    """The step's work, each op reading its inputs once and writing its
    outputs once; pass outputs are float32, stream operands bfloat16."""
    n, f, h, c = graph.n_rows, cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
    B, F, I = ys.BF16, ys.F32, ys.I64
    return [
        ys.matmul("s1 = x W1", n, f, h, n * f * B, n * h * B, ys.PEAK_BF16),
        ys.k2_pass(graph, h, base=False),
        ys.matmul("s2 = relu(a1 + b1) W2", n, h, c, n * h * F, n * c * B, ys.PEAK_F32),
        ys.k2_pass(graph, c, base=False),
        ys.elementwise("masked cross-entropy and its gradient",
                       n * c * F + n * I + n * F + n * c * B, 8 * n * c),
        ys.k2_pass(graph, c, base=False),
        ys.Op("dW2, relu', g W2^T", n * c * F + n * h * F + n * h * B, 4.0 * n * h * c,
              ys.PEAK_F32),
        ys.k2_pass(graph, h, base=False),
        ys.matmul("dW1 = x^T g", n, f, h, n * f * B + n * h * F, 0, ys.PEAK_BF16),
    ]
