"""Two-layer Kipf–Welling GCN.

Port of ``textgcn_tpu/models/gcn.py``: ``H' = Â (H W) + b``, two layers with
ReLU and inverted dropout between, logits for all nodes. Weights keep the
JAX layout ``w: [n_in, n_out]`` and its init U(-1/√fan_out, 1/√fan_out) for
both ``w`` and ``b``, so :func:`params_from_jax` is a copy.

Parameters are a flat dict ``{"gc1.w", "gc1.b", "gc2.w", "gc2.b"}`` of
tensors: the functional :func:`gcn_forward` takes it, and it is the
``state_dict`` of the :class:`GCN` module.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from textgcn_tpu_torch.ops.spmm import spmm

Params = Dict[str, torch.Tensor]
LAYERS = ("gc1", "gc2")


def _init_layer(generator, n_in: int, n_out: int, device) -> Params:
    s = 1.0 / math.sqrt(n_out)
    w = torch.empty((n_in, n_out), device=device).uniform_(-s, s, generator=generator)
    b = torch.empty((n_out,), device=device).uniform_(-s, s, generator=generator)
    return {"w": w, "b": b}


def gcn_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    """Fresh parameters drawn from ``generator`` (on ``device``)."""
    params = {}
    for name, (n_in, n_out) in zip(LAYERS, ((n_feat, n_hidden), (n_hidden, n_class))):
        for k, v in _init_layer(generator, n_in, n_out, device).items():
            params[f"{name}.{k}"] = v
    return params


def params_from_jax(params_np: dict, *, device) -> Params:
    """The JAX pytree ``{"gc1": {"w", "b"}, "gc2": {...}}`` of numpy arrays →
    the port's flat f32 parameter dict on ``device``."""
    return {
        f"{layer}.{k}": torch.tensor(
            np.asarray(params_np[layer][k]), dtype=torch.float32, device=device
        )
        for layer in LAYERS
        for k in ("w", "b")
    }


def graph_conv(w: torch.Tensor, b: torch.Tensor, graph, x: torch.Tensor) -> torch.Tensor:
    """One graph convolution: Â (x W) + b."""
    return spmm(graph, x @ w) + b


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
    if x is None:
        h = spmm(graph, params["gc1.w"]) + params["gc1.b"]
    else:
        h = graph_conv(params["gc1.w"], params["gc1.b"], graph, x)
    h = torch.relu(h)
    if train and dropout > 0.0:
        keep = 1.0 - dropout
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
        h = torch.where(mask, h / keep, 0.0)
    return graph_conv(params["gc2.w"], params["gc2.b"], graph, h)


class GraphConv(nn.Module):
    def __init__(self, n_in: int, n_out: int, *, device):
        super().__init__()
        self.w = nn.Parameter(torch.empty((n_in, n_out), device=device))
        self.b = nn.Parameter(torch.empty((n_out,), device=device))


class GCN(nn.Module):
    """The two-layer GCN as a module; its ``state_dict`` is the flat
    parameter dict of :func:`gcn_forward`."""

    def __init__(
        self,
        n_feat: int,
        n_hidden: int,
        n_class: int,
        dropout: float = 0.5,
        *,
        device,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.gc1 = GraphConv(n_feat, n_hidden, device=device)
        self.gc2 = GraphConv(n_hidden, n_class, device=device)
        if generator is not None:
            with torch.no_grad():
                self.load_state_dict(
                    gcn_init(generator, n_feat, n_hidden, n_class, device=device)
                )

    def forward(self, graph, x=None, generator: Optional[torch.Generator] = None):
        return gcn_forward(
            dict(self.named_parameters()),
            graph,
            x,
            dropout=self.dropout,
            train=self.training,
            generator=generator,
        )
