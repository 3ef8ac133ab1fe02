"""Simple Graph Convolution (SGC): ``logits = Â^K X W + b``.

Port of ``textgcn_tpu/models/sgc.py``. The recomputing form
(:func:`sgc_forward`) projects first and propagates the [N, C] product
(Â^K (X W) = (Â^K X) W) through ``spmm(graph, ·)``, so every format runs it.
:func:`sgc_precompute` hoists Â^K X out of training; ``sgc_pre`` then trains
the linear head alone (:func:`sgc_pre_forward`), with no sparse op in the
step. SGC has no hidden layer and no dropout: ``n_hidden`` and the dropout
arguments are taken for the registry's signature and ignored. Parameters:
``{"lin.w", "lin.b"}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.spmm import spmm

# propagation depth: the receptive field of the 2-layer GCN
DEFAULT_K = 2


def sgc_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    del n_hidden
    return {f"lin.{k}": v for k, v in init_layer(generator, n_feat, n_class, device).items()}


def sgc_core(params: Params, agg, x: Optional[torch.Tensor], k: int = DEFAULT_K) -> torch.Tensor:
    """Â^k (X W) + b over any aggregation ``agg`` (Â ·): the single-device
    and the sharded forward's one definition."""
    h = params["lin.w"] if x is None else x @ params["lin.w"]
    for _ in range(k):
        h = agg(h)
    return h + params["lin.b"]


def sgc_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    k: int = DEFAULT_K,
) -> torch.Tensor:
    """Logits for all nodes: Â^k (X W) + b. ``x=None`` selects identity
    features: W is then the [n_nodes, n_class] node table."""
    del dropout, train, generator
    return sgc_core(params, lambda s: spmm(graph, s), x, k)


def sgc_precompute(graph, x: torch.Tensor, k: int = DEFAULT_K) -> torch.Tensor:
    """Â^k X, for a dense classifier trained on it (``sgc_pre``)."""
    h = x.to(torch.float32)
    for _ in range(k):
        h = spmm(graph, h)
    return h


def sgc_pre_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """A linear layer over features already propagated by
    :func:`sgc_precompute`; ``graph`` is ignored."""
    del graph
    if x is None:
        raise ValueError(
            "sgc_pre needs precomputed dense features (sgc_precompute); "
            "identity features carry no propagation"
        )
    return sgc_forward(params, None, x, k=0)


class SGC(FamilyModule):
    init_params = staticmethod(sgc_init)
    forward_params = staticmethod(sgc_forward)


class SGCPre(FamilyModule):
    init_params = staticmethod(sgc_init)
    forward_params = staticmethod(sgc_pre_forward)
