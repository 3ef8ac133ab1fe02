"""APPNP: predict with an MLP, then propagate with personalized PageRank.

Port of ``textgcn_tpu/models/appnp.py``::

    H = fc2(dropout(relu(fc1(X))));  Z_0 = H;
    Z_{t+1} = (1 - α) Â Z_t + α H;   logits = Z_K

with α = 0.1 and K = 10 power steps, each one ``spmm(graph, ·)`` at the
class width. ``x=None`` selects identity features: fc1's weight is then
the [n_nodes, n_hidden] node table. Parameters: ``{"fc1.w", "fc1.b",
"fc2.w", "fc2.b"}``.
"""
from __future__ import annotations

from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.spmm import spmm

DEFAULT_ALPHA = 0.1
DEFAULT_K = 10


def appnp_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    params = {}
    for name, (n_in, n_out) in (("fc1", (n_feat, n_hidden)), ("fc2", (n_hidden, n_class))):
        for k, v in init_layer(generator, n_in, n_out, device).items():
            params[f"{name}.{k}"] = v
    return params


def appnp_core(
    params: Params, agg, x: Optional[torch.Tensor], drop,
    alpha: float = DEFAULT_ALPHA, k: int = DEFAULT_K,
) -> torch.Tensor:
    """The MLP and the K PPR steps over any aggregation ``agg`` (Â ·), with
    ``drop`` after fc1: the single-device and the sharded forward's one
    definition."""
    h = params["fc1.w"] if x is None else x @ params["fc1.w"]
    h = drop(torch.relu(h + params["fc1.b"]))
    h = h @ params["fc2.w"] + params["fc2.b"]
    z = h
    for _ in range(k):
        z = (1.0 - alpha) * agg(z) + alpha * h
    return z


def appnp_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    alpha: float = DEFAULT_ALPHA,
    k: int = DEFAULT_K,
) -> torch.Tensor:
    """Logits for all nodes: the MLP's predictions after K PPR steps."""
    return appnp_core(
        params, lambda s: spmm(graph, s), x, lambda h: _dropout(h, dropout, train, generator),
        alpha, k,
    )


class APPNP(FamilyModule):
    init_params = staticmethod(appnp_init)
    forward_params = staticmethod(appnp_forward)
