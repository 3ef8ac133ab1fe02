"""Two-layer Kipf–Welling GCN.

Port of ``textgcn_tpu/models/gcn.py``: ``H' = Â (H W) + b``, two layers with
ReLU and inverted dropout between, logits for all nodes. Weights keep the
JAX layout ``w: [n_in, n_out]`` and its init U(-1/√fan_out, 1/√fan_out) for
both ``w`` and ``b``, so :func:`params_from_jax` is a copy.

Parameters are a flat dict ``{"gc1.w", "gc1.b", "gc2.w", "gc2.b"}`` of
tensors (:func:`graph_conv`, one layer, takes JAX's ``{"w", "b"}``): the
functional :func:`gcn_forward` takes it, and it is the
``state_dict`` of the :class:`GCN` module
(:class:`~textgcn_tpu_torch.models.family.FamilyModule`).

:func:`gcn_edge_init` and :func:`gcn_edge_forward` are the JAX module's
learnable-edge GCN: the same two layers with each edge of Â scaled by
``exp(edge_logit)``, trained with the weights through
:func:`~textgcn_tpu_torch.ops.spmm.spmm_coo_segment_ew`. As in JAX they are
library functions, outside the family registry and the CLI.
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.ops.attention import det_exp
from textgcn_tpu_torch.ops.spmm import spmm, spmm_coo_segment_ew

LAYERS = ("gc1", "gc2")


def gcn_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    """Fresh parameters drawn from ``generator`` (on ``device``)."""
    params = {}
    for name, (n_in, n_out) in zip(LAYERS, ((n_feat, n_hidden), (n_hidden, n_class))):
        for k, v in init_layer(generator, n_in, n_out, device).items():
            params[f"{name}.{k}"] = v
    return params


def _conv(w, b, agg, x: Optional[torch.Tensor]) -> torch.Tensor:
    """Â (x W) + b over the aggregation ``agg``; ``x=None`` is the identity."""
    return agg(w if x is None else x @ w) + b


def graph_conv(params: Params, graph, x: torch.Tensor) -> torch.Tensor:
    """One graph convolution, Â (x W) + b, with one layer's ``{"w", "b"}``
    (JAX's ``graph_conv``)."""
    return _conv(params["w"], params["b"], lambda s: spmm(graph, s), x)


def gcn_core(params: Params, agg, x: Optional[torch.Tensor], drop) -> torch.Tensor:
    """The two layers over any aggregation: ``agg(s)`` is Â s and ``drop(h)``
    the dropout between the layers. The single-device forward passes
    ``spmm(graph, ·)``, the sharded one (``parallel/sharded.py``) its rank's
    aggregation and row dropout: one definition for both."""
    h = drop(torch.relu(_conv(params["gc1.w"], params["gc1.b"], agg, x)))
    return _conv(params["gc2.w"], params["gc2.b"], agg, h)


def gcn_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits for all nodes: gc2(dropout(relu(gc1(x)))).

    ``x=None`` selects identity features (classic TextGCN: X = I_N): layer 1
    is then ``Â @ W1 + b1`` with W1 of shape [n_nodes, n_hidden], and the
    N x N identity is never built. Dropout draws its mask from ``generator``.
    """
    return gcn_core(
        params, lambda s: spmm(graph, s), x, lambda h: _dropout(h, dropout, train, generator)
    )


def gcn_edge_init(
    generator: torch.Generator, graph, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    """:func:`gcn_init` plus ``edge_logit``, a learnable log-scale for each
    entry of the graph's padded COO, at 0 (scale 1: the fixed-Â model at
    init)."""
    params = gcn_init(generator, n_feat, n_hidden, n_class, device=device)
    params["edge_logit"] = torch.zeros(graph.row.shape, dtype=torch.float32, device=device)
    return params


def gcn_edge_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """:func:`gcn_forward` with learnable edge weights: both layers
    aggregate over Â's values times ``exp(params["edge_logit"])``, and the
    logits are differentiable in ``edge_logit`` through the sampled product
    of :func:`~textgcn_tpu_torch.ops.spmm.spmm_coo_segment_ew`. Needs a
    :class:`SparseGraph` (the segment path), as in JAX: other layouts hold
    their values in tiles or CSRs whose order is not the COO's."""
    if not isinstance(graph, SparseGraph):
        raise TypeError(
            "learnable edge weights need a SparseGraph (COO segment path); "
            f"got {type(graph).__name__}"
        )
    val = graph.val * det_exp(params["edge_logit"])

    def agg(support):
        return spmm_coo_segment_ew(graph.row, graph.col, val, support, graph.n_nodes)

    return gcn_core(params, agg, x, lambda h: _dropout(h, dropout, train, generator))


class GCN(FamilyModule):
    """The two-layer GCN as a module; its ``state_dict`` is the flat
    parameter dict of :func:`gcn_forward`."""

    init_params = staticmethod(gcn_init)
    forward_params = staticmethod(gcn_forward)
