"""What the model families share: the layer init, dropout, the JAX
parameter copy and the module that holds a family's parameters.

The JAX package's families share ``_init_layer`` of
``textgcn_tpu/models/gcn.py`` and write their dropout inline; their
registry (``textgcn_tpu/models/__init__.py``) pairs an init with a forward.

Every family is a pair of functions on a flat parameter dict
``{"layer.leaf": tensor}`` (its keys are the JAX pytree's paths):
``init(generator, n_feat, n_hidden, n_class, *, device)`` and
``forward(params, graph, x, *, dropout, train, generator)``.
:class:`FamilyModule` holds that dict as the module's parameters, so its
``state_dict`` is the dict, and calls the forward.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

Params = Dict[str, torch.Tensor]


def init_layer(generator, n_in: int, n_out: int, device) -> Params:
    """``w`` [n_in, n_out] and ``b`` [n_out], both U(-1/√n_out, 1/√n_out),
    drawn in that order (the JAX package's init law)."""
    s = 1.0 / math.sqrt(n_out)
    w = torch.empty((n_in, n_out), device=device).uniform_(-s, s, generator=generator)
    b = torch.empty((n_out,), device=device).uniform_(-s, s, generator=generator)
    return {"w": w, "b": b}


def dropout(h: torch.Tensor, p: float, train: bool, generator) -> torch.Tensor:
    """Inverted dropout with a mask drawn from ``generator`` (a no-op unless
    ``train`` and ``p > 0``)."""
    if not train or p <= 0.0:
        return h
    keep = 1.0 - p
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, 0.0)


def params_from_jax(params_np: dict, *, device) -> Params:
    """A JAX family's pytree ``{"layer": {"leaf": array}}`` of numpy arrays
    → the port's flat f32 parameter dict on ``device``. A top-level array
    (the learnable-edge GCN's ``edge_logit``) keeps its name."""
    out = {}
    for layer, leaves in params_np.items():
        if not isinstance(leaves, dict):
            leaves = {None: leaves}
        for leaf, v in leaves.items():
            key = layer if leaf is None else f"{layer}.{leaf}"
            out[key] = torch.tensor(np.asarray(v), dtype=torch.float32, device=device)
    return out


class FamilyModule(nn.Module):
    """A family as a module. A subclass sets ``init_params`` and
    ``forward_params`` (as ``staticmethod``); the module's parameters are
    ``init_params``'s dict, drawn from ``generator`` (without one, the caller
    loads its own with ``load_state_dict``)."""

    init_params = None
    forward_params = None

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
        if generator is None:  # shapes only: the caller loads the values
            generator = torch.Generator(device=device)
        params = self.init_params(generator, n_feat, n_hidden, n_class, device=device)
        for key, value in params.items():
            layer, leaf = key.split(".")
            if layer not in self._modules:
                self.add_module(layer, nn.Module())
            self._modules[layer].register_parameter(leaf, nn.Parameter(value))

    def forward(self, graph, x=None, generator: Optional[torch.Generator] = None):
        return self.forward_params(
            dict(self.named_parameters()),
            graph,
            x,
            dropout=self.dropout,
            train=self.training,
            generator=generator,
        )
