"""GCNII: a deep GCN with initial residual and identity mapping.

Port of ``textgcn_tpu/models/gcnii.py``::

    h_0 = relu(X W_in + b_in)
    s_l = (1 - α) Â h_{l-1} + α h_0                    (initial residual)
    h_l = relu((1 - β_l) s_l + β_l (s_l W_l))          (identity mapping)
    logits = dropout(h_K) W_out + b_out,    β_l = log(λ / l + 1)

with K = 8, α = 0.1, λ = 0.5, one ``spmm(graph, ·)`` a layer at the hidden
width. The K deep weights stay stacked as one [K, H, H] parameter, as the
JAX package scans them, so the parameter names match its pytree:
``{"fc_in.w", "fc_in.b", "deep.w", "fc_out.w", "fc_out.b"}``. ``x=None``
selects identity features: W_in is then the [n_nodes, H] node table.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, Params, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.spmm import spmm

DEFAULT_ALPHA = 0.1
DEFAULT_LAMBDA = 0.5
DEFAULT_K = 8


def gcnii_betas(k: int = DEFAULT_K, lam: float = DEFAULT_LAMBDA, *, device="cpu") -> torch.Tensor:
    """The per-layer identity-mapping strengths β_l = log(λ / l + 1), f32."""
    l = torch.arange(1, k + 1, dtype=torch.float32, device=device)
    return torch.log(lam / l + 1.0)


def gcnii_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device,
    k: int = DEFAULT_K,
) -> Params:
    """fc_in, then the K deep [H, H] maps (U(±1/√H), as every layer), then
    fc_out."""
    fc_in = init_layer(generator, n_feat, n_hidden, device)
    s = 1.0 / math.sqrt(n_hidden)
    deep = torch.empty((k, n_hidden, n_hidden), device=device).uniform_(-s, s, generator=generator)
    fc_out = init_layer(generator, n_hidden, n_class, device)
    return {
        "fc_in.w": fc_in["w"], "fc_in.b": fc_in["b"], "deep.w": deep,
        "fc_out.w": fc_out["w"], "fc_out.b": fc_out["b"],
    }


def gcnii_core(
    params: Params, agg, x: Optional[torch.Tensor], drop,
    alpha: float = DEFAULT_ALPHA, lam: float = DEFAULT_LAMBDA,
) -> torch.Tensor:
    """The K initial-residual layers over any aggregation ``agg`` (Â ·),
    with ``drop`` before fc_out: the single-device and the sharded
    forward's one recurrence (JAX ``gcnii_core``)."""
    h0 = params["fc_in.w"] if x is None else x @ params["fc_in.w"]
    h0 = torch.relu(h0 + params["fc_in.b"])
    deep = params["deep.w"]
    betas = gcnii_betas(deep.shape[0], lam, device=deep.device)
    h = h0
    for w, beta in zip(deep, betas):
        s = (1.0 - alpha) * agg(h) + alpha * h0
        h = torch.relu((1.0 - beta) * s + beta * (s @ w))
    return drop(h) @ params["fc_out.w"] + params["fc_out.b"]


def gcnii_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    alpha: float = DEFAULT_ALPHA,
    lam: float = DEFAULT_LAMBDA,
) -> torch.Tensor:
    """Logits for all nodes through K initial-residual layers."""
    return gcnii_core(
        params, lambda s: spmm(graph, s), x, lambda h: _dropout(h, dropout, train, generator),
        alpha, lam,
    )


class GCNII(FamilyModule):
    init_params = staticmethod(gcnii_init)
    forward_params = staticmethod(gcnii_forward)
