"""GIN (Graph Isomorphism Network), full-batch.

Port of ``textgcn_tpu/models/gin.py``. A layer aggregates before its
transform::

    h' = MLP((1 + eps) h + Â h)

with a learnable scalar ``eps`` per layer, 0 at init. Layer 1's MLP is
Linear → ReLU → Linear, followed by ReLU and dropout; layer 2 maps to the
class logits with one linear. The aggregation runs on the layer's input, so
layer 1's SpMM is at the raw feature width. ``x=None`` selects identity
features: layer 1 then aggregates its first weight table,
``(1 + eps) W + Â W``. Parameters: ``{"gin1.eps", "gin1.w1", "gin1.b1",
"gin1.w2", "gin1.b2", "gin2.eps", "gin2.w", "gin2.b"}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.spmm import spmm


def gin_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    mlp1a = init_layer(generator, n_feat, n_hidden, device)
    mlp1b = init_layer(generator, n_hidden, n_hidden, device)
    head = init_layer(generator, n_hidden, n_class, device)
    zero = torch.zeros((), device=device)
    return {
        "gin1.eps": zero.clone(), "gin1.w1": mlp1a["w"], "gin1.b1": mlp1a["b"],
        "gin1.w2": mlp1b["w"], "gin1.b2": mlp1b["b"],
        "gin2.eps": zero.clone(), "gin2.w": head["w"], "gin2.b": head["b"],
    }


def gin_core(params: Params, agg, x: Optional[torch.Tensor], drop) -> torch.Tensor:
    """The two layers over any aggregation ``agg`` (Â ·) with ``drop``
    between them: the single-device and the sharded forward's one
    definition."""

    def aggregate(eps, h, w):
        # ((1 + eps) h + Â h) @ w, or the identity-feature table form
        if h is None:
            return (1.0 + eps) * w + agg(w)
        return ((1.0 + eps) * h + agg(h)) @ w

    h = torch.relu(aggregate(params["gin1.eps"], x, params["gin1.w1"]) + params["gin1.b1"])
    h = drop(torch.relu(h @ params["gin1.w2"] + params["gin1.b2"]))
    return aggregate(params["gin2.eps"], h, params["gin2.w"]) + params["gin2.b"]


def gin_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits for all nodes: gin2(dropout(MLP-layer(x)))."""
    return gin_core(
        params, lambda s: spmm(graph, s), x, lambda h: _dropout(h, dropout, train, generator)
    )


class GIN(FamilyModule):
    init_params = staticmethod(gin_init)
    forward_params = staticmethod(gin_forward)
