"""Two-layer graph attention network (GAT).

Port of ``textgcn_tpu/models/gat.py``. A layer projects ``h = x W``, scores
each edge with ``leaky(a_src·h_row + a_dst·h_col) + log(val)`` (the
adjacency weight folded in as a log makes the softmax a weighted one, and an
edge with val 0 drops out), takes the softmax over each row's edges and
aggregates ``h`` with it, then adds ``b``. ``x=None`` selects identity
features: layer 1's ``h`` is the weight table itself.

The sparse side runs on one of three layouts, chosen by the graph container
(:func:`gat_forward`):

- :class:`~textgcn_tpu_torch.graph.structs.SparseGraph`: the segment
  layout in plain PyTorch (gather, segment softmax, scatter-add: the same
  bits every call, :mod:`textgcn_tpu_torch.ops.scatter`); the oracle, and
  ``--spmm segment``.
- :class:`DenseAttentionGraph`: the dense bf16 log-adjacency in plain
  PyTorch, with ``torch.matmul`` for the [N, N] @ [N, F] product that the
  JAX package leaves to XLA.
- :class:`~textgcn_tpu_torch.ops.attention.AttentionGraph`: the kernel
  path, :func:`~textgcn_tpu_torch.ops.attention.gat_attention` and its CUDA
  kernels.

Weights keep the JAX layout (``w: [n_in, n_out]``), so
:func:`params_from_jax` is a copy. Parameters are the flat dict
``{"gat1.w", "gat1.b", "gat1.a_src", "gat1.a_dst", "gat2.*"}``, which is
also the ``state_dict`` of :class:`GAT`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models.family import (  # noqa: F401 (params_from_jax)
    FamilyModule, dropout as _dropout, init_layer, params_from_jax,
)
from textgcn_tpu_torch.ops.attention import AttentionGraph, check_coalesced, det_exp, gat_attention
from textgcn_tpu_torch.ops.scatter import add_rows

Params = Dict[str, torch.Tensor]
LAYERS = ("gat1", "gat2")
KEYS = ("w", "b", "a_src", "a_dst")

_NEG = -1e30  # finite -inf stand-in (NaN-free max/exp arithmetic)


@dataclasses.dataclass(frozen=True)
class DenseAttentionGraph:
    """Dense log-adjacency for attention on small graphs: ``loga`` [N, N]
    bf16 holds ``log(val)`` on the pattern and the finite ``-1e30`` off it,
    whose softmax weight underflows to exactly 0."""

    loga: torch.Tensor
    n_nodes: int

    @staticmethod
    def from_sparse_graph(g: SparseGraph) -> "DenseAttentionGraph":
        """Built on ``g``'s device by a scatter from its COO. Duplicate
        (row, col) edges raise: the table keeps one value per pair where the
        segment layout would add them."""
        n = int(g.n_nodes)
        row, col, _ = g.coo_numpy()
        check_coalesced(row, col, n)
        # padding entries (row == col == n, val 0) land in the phantom rim
        d = torch.full((n + 1, n + 1), _NEG, dtype=torch.float32, device=g.val.device)
        d[g.row, g.col] = torch.clamp(torch.log(g.val.float()), min=_NEG)
        return DenseAttentionGraph(loga=d[:n, :n].to(torch.bfloat16), n_nodes=n)


def _layer_init(generator, n_in: int, n_out: int, device) -> Params:
    p = init_layer(generator, n_in, n_out, device)  # w, b: U(±1/√n_out)
    s = 1.0 / math.sqrt(n_out)
    for k in ("a_src", "a_dst"):
        p[k] = torch.empty((n_out,), device=device).uniform_(-s, s, generator=generator)
    return p


def gat_init(
    generator: torch.Generator, n_feat: int, n_hidden: int, n_class: int, *, device
) -> Params:
    """Fresh parameters drawn from ``generator`` (on ``device``): per layer
    ``w``, ``b``, ``a_src``, ``a_dst`` in that order, each U(±1/√n_out)."""
    params = {}
    for name, (n_in, n_out) in zip(LAYERS, ((n_feat, n_hidden), (n_hidden, n_class))):
        for k, v in _layer_init(generator, n_in, n_out, device).items():
            params[f"{name}.{k}"] = v
    return params


def segment_softmax(logits: torch.Tensor, row: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Softmax of per-edge ``logits`` over the edges sharing a row.

    ``row`` may hold the phantom id ``n_nodes`` (padding), a segment of its
    own. A segment whose logits are all -inf gives 0, not NaN. The max shift
    is taken without gradient: the softmax does not depend on it.
    """
    with torch.no_grad():
        mx = torch.full((n_nodes + 1,), -math.inf, dtype=logits.dtype, device=logits.device)
        mx.scatter_reduce_(0, row, logits, "amax")
        shift = torch.where(torch.isfinite(mx), mx, 0.0)[row]
    expd = torch.where(torch.isfinite(logits), det_exp(logits - shift), 0.0)
    denom = add_rows(n_nodes + 1, row, expd)
    return expd / torch.clamp(denom[row], min=1e-30)


def gat_attention_segment(
    graph: SparseGraph, es, ed, h, negative_slope: float = 0.2
) -> torch.Tensor:
    """The sparse side of a GAT layer on the padded COO, in plain PyTorch
    (differentiable through autograd): the oracle of
    :func:`~textgcn_tpu_torch.ops.attention.gat_attention`."""
    n = graph.n_nodes
    gs = torch.cat([es, es.new_zeros(1)])[graph.row]
    gd = torch.cat([ed, ed.new_zeros(1)])[graph.col]
    # padding edges have val 0: log -> -inf -> weight 0
    e = F.leaky_relu(gs + gd, negative_slope) + torch.log(graph.val)
    att = segment_softmax(e, graph.row, n)
    hp = torch.cat([h, h.new_zeros((1, h.shape[1]))])
    out = add_rows(n + 1, graph.row, att[:, None] * hp[graph.col])
    return out[:n]


def _project(p: Params, x: Optional[torch.Tensor]):
    h = p["w"] if x is None else x @ p["w"]
    return h, h @ p["a_src"], h @ p["a_dst"]


def gat_layer(p: Params, graph: SparseGraph, x, *, negative_slope: float = 0.2):
    """One attention layer on the segment layout."""
    h, es, ed = _project(p, x)
    return gat_attention_segment(graph, es, ed, h, negative_slope) + p["b"]


def gat_layer_dense(p: Params, dg: DenseAttentionGraph, x, *, negative_slope: float = 0.2):
    """One attention layer on the dense layout: a rank-1 broadcast plus the
    log-adjacency, a row softmax, and one product with weights and features
    rounded to bf16 and summed in f32 (as the JAX layer's bf16 MXU dot)."""
    h, es, ed = _project(p, x)
    logit = F.leaky_relu(es[:, None] + ed[None, :], negative_slope) + dg.loga.float()
    m = torch.amax(logit, dim=1, keepdim=True)
    e = torch.where(logit > _NEG / 2, det_exp(logit - torch.where(m > _NEG / 2, m, 0.0)), 0.0)
    att = (e / torch.clamp(e.sum(dim=1, keepdim=True), min=1e-30)).to(torch.bfloat16)
    return torch.matmul(att.float(), h.to(torch.bfloat16).float()) + p["b"]


def gat_layer_onehot(p: Params, ag: AttentionGraph, x, *, negative_slope: float = 0.2):
    """One attention layer on the kernel path (``gat_attention``)."""
    h, es, ed = _project(p, x)
    return gat_attention(ag, es, ed, h, negative_slope) + p["b"]


def _layer(params: Params, name: str) -> Params:
    return {k: params[f"{name}.{k}"] for k in KEYS}


def gat_forward(
    params: Params,
    graph,
    x: Optional[torch.Tensor],
    *,
    dropout: float = 0.5,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Logits for all nodes: gat2(dropout(relu(gat1(x)))), on the layout of
    ``graph``'s type. Dropout draws its mask from ``generator``."""
    if isinstance(graph, AttentionGraph):
        layer = gat_layer_onehot
    elif isinstance(graph, DenseAttentionGraph):
        layer = gat_layer_dense
    elif isinstance(graph, SparseGraph):
        layer = gat_layer
    else:
        raise TypeError(
            "GAT needs a SparseGraph (segment layout), an AttentionGraph "
            "(kernel layout) or a DenseAttentionGraph (dense layout); got "
            f"{type(graph).__name__}"
        )
    h = _dropout(torch.relu(layer(_layer(params, "gat1"), graph, x)), dropout, train, generator)
    return layer(_layer(params, "gat2"), graph, h)


class GAT(FamilyModule):
    """The two-layer GAT as a module; its ``state_dict`` is the flat
    parameter dict of :func:`gat_forward`."""

    init_params = staticmethod(gat_init)
    forward_params = staticmethod(gat_forward)
