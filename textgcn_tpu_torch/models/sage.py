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


def _sage_layer(params: Params, name: str, graph, x: Optional[torch.Tensor]) -> torch.Tensor:
    w_self, w_neigh = params[f"{name}.w_self"], params[f"{name}.w_neigh"]
    if x is None:
        return w_self + spmm(graph, w_neigh) + params[f"{name}.b"]
    return x @ w_self + spmm(graph, x @ w_neigh) + params[f"{name}.b"]


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
    h = _dropout(torch.relu(_sage_layer(params, "sage1", graph, x)), dropout, train, generator)
    return _sage_layer(params, "sage2", graph, h)


class SAGE(FamilyModule):
    init_params = staticmethod(sage_init)
    forward_params = staticmethod(sage_forward)
