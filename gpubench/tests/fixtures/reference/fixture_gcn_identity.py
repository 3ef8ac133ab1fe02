"""The reference family of the tests' second runner
(``gpubench/tests/fixtures/programs/fixture_resident.py``): the 2-layer GCN
``Z = Â relu(Â X W1 + b1) W2 + b2`` with identity features, X = I_N, so
that ``X W1`` is ``W1`` itself, of shape [n_nodes, hidden]; the masked mean
cross-entropy, Adam, no dropout. Only what an untraced run reads:
``param_shapes`` and ``loss``. Found as
``gpubench.reference.fixture_gcn_identity`` once the test puts this
directory on that package's path.
"""
from __future__ import annotations

import torch

from gpubench.reference import masked_ce


def param_shapes(cfg):
    n, h, c = cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
    return {"gc1.w": (n, h), "gc1.b": (h,), "gc2.w": (h, c), "gc2.b": (c,)}


def loss(params, x, y, mask, ops, cfg):
    s1 = params["gc1.w"] if x is None else ops.product(x, params["gc1.w"])
    a1 = ops.propagate(s1)
    a2 = ops.propagate(torch.relu(a1 + params["gc1.b"]) @ params["gc2.w"])
    return masked_ce(a2 + params["gc2.b"], y, mask)

