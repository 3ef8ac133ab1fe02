"""GraphSAGE (mean aggregator), full-batch.

Port of ``textgcn_tpu/models/sage.py``. A layer keeps a self transform
apart from the neighbour aggregation::

    h' = x W_self + Â (x W_neigh) + b

projecting before it aggregates (Â (x W) = (Â x) W: the SpMM runs at the
output width). Two layers, ReLU and dropout between. ``x=None`` selects
identity features: both weights are then [n_nodes, H] node tables.
Parameters: ``{"sage1.w_self", "sage1.w_neigh", "sage1.b", "sage2.*"}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.spmm import spmm


def sage_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    """Per layer a self and a neighbour layer drawn in that order; the bias
    is the self layer's (the neighbour layer's is drawn and dropped, as in
    the JAX package)."""
    params = {}
    for name, (n_in, n_out) in (("sage1", (n_feat, n_hidden)), ("sage2", (n_hidden, n_class))):
        own = init_layer(generator, n_in, n_out, device)
        neigh = init_layer(generator, n_in, n_out, device)
        params.update({
            f"{name}.w_self": own["w"], f"{name}.w_neigh": neigh["w"], f"{name}.b": own["b"],
        })
    return params


def sage_core(params: Params, agg, x: Optional[torch.Tensor], drop) -> torch.Tensor:
    """The two layers over any aggregation ``agg`` (Â ·) with ``drop``
    between them: the single-device and the sharded forward's one
    definition."""

    def layer(name, h):
        w_self, w_neigh = params[f"{name}.w_self"], params[f"{name}.w_neigh"]
        if h is None:
            return w_self + agg(w_neigh) + params[f"{name}.b"]
        return h @ w_self + agg(h @ w_neigh) + params[f"{name}.b"]

    return layer("sage2", drop(torch.relu(layer("sage1", x))))


def sage_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits for all nodes: sage2(dropout(relu(sage1(x))))."""
    return sage_core(
        params, lambda s: spmm(graph, s), x, lambda h: _dropout(h, dropout, train, generator)
    )


class SAGE(FamilyModule):
    init_params = staticmethod(sage_init)
    forward_params = staticmethod(sage_forward)
