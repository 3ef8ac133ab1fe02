"""APPNP (Gasteiger et al., arXiv:1810.05997, eq. 3–4) as the streamed step
trains it: ``H = relu(X W1 + b1) W2 + b2``, ``Z_0 = H``, then ``K`` times
``Z = (1 - α) Â Z + α H``; the masked mean cross-entropy of ``Z_K``, Adam;
no dropout, no weight decay.

Each ``Â`` is a stream node (operand and cotangent stored at the
configuration's ``low`` dtype, float32 sums); ``X W1`` is a float32 product
of ``X`` and ``W1`` rounded to the features' dtype, whose weight gradient
takes the cotangent rounded to it too; the rest is float32.
"""
from __future__ import annotations

import torch

from gpubench import yardstick as ys
from gpubench.reference import masked_ce


def param_shapes(cfg):
    f, h, c = cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
    return {"fc1.w": (f, h), "fc1.b": (h,), "fc2.w": (h, c), "fc2.b": (c,)}


def loss(params, x, y, mask, ops, cfg):
    alpha, k = cfg["alpha"], cfg["k"]
    h1 = torch.relu(ops.product(x, params["fc1.w"]) + params["fc1.b"])
    h = h1 @ params["fc2.w"] + params["fc2.b"]
    z = h
    for _ in range(k):
        z = (1.0 - alpha) * ops.propagate(z) + alpha * h
    return masked_ce(z, y, mask)


def pass_widths(cfg):
    """``K`` forward passes and their ``K`` transposes, all at width C."""
    return [cfg["n_class"]] * (2 * cfg["k"])


def step_work(cfg, graph):
    """The step's work, each op reading its inputs once and writing its
    outputs once; pass outputs are float32, stream operands bfloat16."""
    n, f, h, c, k = graph.n_rows, cfg["n_feat"], cfg["n_hidden"], cfg["n_class"], cfg["k"]
    B, F, I = ys.BF16, ys.F32, ys.I64
    ops = [
        ys.matmul("h1 = relu(x W1 + b1)", n, f, h, n * f * B, n * h * F, ys.PEAK_BF16),
        ys.matmul("h = h1 W2 + b2", n, h, c, n * h * F, n * c * F, ys.PEAK_F32),
    ]
    for i in range(k):
        ops += [
            ys.elementwise(f"z{i} stored bf16", n * c * (F + B)),
            ys.k2_pass(graph, c, base=False),
            ys.elementwise(f"z{i + 1} = (1-a) Az + a h", 3 * n * c * F, 3 * n * c),
        ]
    ops.append(ys.elementwise("masked cross-entropy and its gradient",
                              n * c * F + n * I + n * F + n * c * F, 8 * n * c))
    for i in range(k):
        ops += [
            ys.elementwise(f"g{i} stored bf16", n * c * (F + B), n * c),
            ys.k2_pass(graph, c, base=False),
            ys.elementwise(f"g_h += a g{i}", 3 * n * c * F, 2 * n * c),
        ]
    ops += [
        ys.Op("dW2, relu', g W2^T", n * c * F + n * h * F + n * h * B, 4.0 * n * h * c,
              ys.PEAK_F32),
        ys.matmul("dW1 = x^T g", n, f, h, n * f * B + n * h * B, 0, ys.PEAK_BF16),
    ]
    return ops
