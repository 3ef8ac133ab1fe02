"""Row-sharded model families over a process group.

Port of ``textgcn_tpu/parallel/sharded.py`` (``spmm_sharded`` and the
sharded forwards of GCN, SAGE, SGC, APPNP, GIN, GCNII and GAT). Each rank holds its
``rows_per_shard`` rows of the features, activations and logits; dense
transforms run locally with replicated weights; the sparse aggregation
brings the other ranks' rows to each rank (all at once, or a block at a
time around a ring) and reduces onto the local ones. :func:`sharded_spmm`
dispatches on the rank's layout:

- a :class:`~textgcn_tpu_torch.parallel.partition.ShardCOO` (``kernel=
  "segment"``, ``partition="allgather"``) goes through :func:`spmm_sharded`:
  plain PyTorch gather and scatter-add (the same bits every call,
  :mod:`textgcn_tpu_torch.ops.scatter`), also the oracle. Its backward is
  the true transpose (every rank scatters ``A_pᵀ g_p`` over all rows, one
  all-reduce), so it also checks the symmetric shortcut of the kernels'
  backward;
- a :class:`~textgcn_tpu_torch.parallel.halo.HaloPartitionedGraph`
  (``segment`` on ``halo``, the JAX CLI's default) goes through
  :func:`~textgcn_tpu_torch.parallel.halo.spmm_halo`, the feature ring with
  the same plain sums and a true-transpose reverse ring as its backward;
- the hand-kernel layouts (``onehot`` on either partition, ``hybrid`` on
  ``allgather``) go through
  :func:`~textgcn_tpu_torch.parallel.mesh_kernels.spmm_mesh_onehot`.

Every family but GAT aggregates through :func:`sharded_spmm` alone, so it
runs on every layout: its forward is the family's one definition
(``*_core`` of its model module) given this rank's aggregation and row
dropout (:func:`dropout_rows`). GAT's attention needs the edges' scores, so
it has a form per layout (:func:`sharded_gat_forward`): the local segment
softmax after an all-gather (``ShardCOO``), the online softmax over the halo
ring (``HaloPartitionedGraph``), and the attention kernels on each rank's
rectangular attention graph
(:class:`~textgcn_tpu_torch.parallel.mesh_attention.MeshAttentionAllGather`).

The JAX package gets the cross-shard gradient sums from ``shard_map``'s
autodiff; here the trainer all-reduces the replicated parameters' gradients
(:mod:`textgcn_tpu_torch.parallel.trainer`), and the collectives inside
GAT's layers are autograd ops whose backward is their transpose
(:func:`~textgcn_tpu_torch.parallel.distributed.all_gather_rows_ad`,
:func:`~textgcn_tpu_torch.parallel.distributed.ring_shift_ad`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from textgcn_tpu_torch.models.appnp import DEFAULT_ALPHA as APPNP_ALPHA, DEFAULT_K as APPNP_K
from textgcn_tpu_torch.models.appnp import appnp_core
from textgcn_tpu_torch.models.gat import KEYS as GAT_KEYS, segment_softmax
from textgcn_tpu_torch.models.gcn import Params, gcn_core
from textgcn_tpu_torch.models.gcnii import DEFAULT_ALPHA as GCNII_ALPHA, DEFAULT_LAMBDA
from textgcn_tpu_torch.models.gcnii import gcnii_core
from textgcn_tpu_torch.models.gin import gin_core
from textgcn_tpu_torch.models.sage import sage_core
from textgcn_tpu_torch.models.sgc import DEFAULT_K as SGC_K, sgc_core
from textgcn_tpu_torch.ops.attention import det_exp
from textgcn_tpu_torch.ops.scatter import add_rows, add_rows_
from textgcn_tpu_torch.parallel.distributed import (
    all_gather_rows, all_gather_rows_ad, all_reduce_sum, ring_shift_ad,
)
from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph, spmm_halo
from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather, mesh_gat_attention
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather, MeshOneHotAllGather, MeshOneHotHalo, spmm_mesh_onehot,
)
from textgcn_tpu_torch.parallel.partition import ShardCOO


def _local_spmm(s: ShardCOO, x_full: torch.Tensor) -> torch.Tensor:
    out = x_full.new_zeros((s.rows_per_shard, x_full.shape[1]))
    return add_rows_(out, s.row, x_full[s.col] * s.val[:, None].to(x_full.dtype))


class _SpmmSharded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, x_local, group):
        ctx.s, ctx.group = s, group
        return _local_spmm(s, all_gather_rows(x_local, group))

    @staticmethod
    def backward(ctx, g):
        s = ctx.s
        part = g.new_zeros((s.n_pad, g.shape[1]))
        add_rows_(part, s.col, g[s.row] * s.val[:, None].to(g.dtype))
        all_reduce_sum(part, ctx.group)
        r0 = s.shard * s.rows_per_shard
        return None, part[r0 : r0 + s.rows_per_shard], None


def spmm_sharded(s: ShardCOO, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's rows of ``A @ x`` with ``x`` row-sharded over ``group``
    (``x_local`` is ``[rows_per_shard, F]``), in plain PyTorch;
    differentiable in ``x_local`` for any ``A``."""
    return _SpmmSharded.apply(s, x_local, group)


def sharded_spmm(graph, x_local: torch.Tensor, group=None) -> torch.Tensor:
    """Dispatch on the shard container: the plain segment reduce for a
    :class:`ShardCOO`, the plain segment ring for a
    :class:`HaloPartitionedGraph`, the hand kernels for the one-hot and
    hybrid layouts."""
    if isinstance(graph, (MeshOneHotAllGather, MeshOneHotHalo, MeshHybridAllGather)):
        return spmm_mesh_onehot(graph, x_local, group)
    if isinstance(graph, HaloPartitionedGraph):
        return spmm_halo(graph, x_local, group)
    if isinstance(graph, ShardCOO):
        return spmm_sharded(graph, x_local, group)
    raise TypeError(f"no sharded SpMM for {type(graph).__name__}")


def dropout_rows(
    h: torch.Tensor, rate: float, n_nodes: int, r0: int, generator: torch.Generator
) -> torch.Tensor:
    """Inverted dropout on this rank's rows ``[r0, r0 + len(h))`` of an
    ``[n_nodes, H]`` activation: the mask is drawn for all ``n_nodes`` rows
    from ``generator`` (as the single-device GCN draws it) and the rank keeps
    its own, so the run does not depend on the number of ranks. Rows past
    ``n_nodes`` (padding) are dropped."""
    keep = 1.0 - rate
    u = torch.rand((n_nodes, h.shape[1]), generator=generator, device=h.device)[r0 : r0 + len(h)]
    mask = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    mask[: len(u)] = u < keep
    return torch.where(mask, h / keep, 0.0)


def _rank_ops(graph, group, dropout: float, train: bool, generator):
    """``(agg, drop)`` of this rank: ``agg(s)`` is its rows of Â s
    (:func:`sharded_spmm`), ``drop(h)`` the dropout of its rows of an
    ``[n_nodes, H]`` activation (:func:`dropout_rows`; a no-op unless
    ``train`` and ``dropout > 0``)."""

    def agg(s):
        return sharded_spmm(graph, s, group)

    def drop(h):
        if not train or dropout <= 0.0:
            return h
        return dropout_rows(
            h, dropout, graph.n_nodes, graph.shard * graph.rows_per_shard, generator
        )

    return agg, drop


def sharded_gcn_forward(
    params: Params,
    graph,
    x_local: Optional[torch.Tensor],
    *,
    group=None,
    dropout: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """This rank's logits ``[rows_per_shard, C]``.

    ``x_local=None`` selects identity features: layer 1's support ``I @ W1``
    is ``W1`` itself, so ``params["gc1.w"]`` is this rank's
    ``[rows_per_shard, H]`` rows of the node table, and their gradient stays
    local. With features, ``gc1.w`` is the replicated ``[F, H]`` weight. The
    other families' forwards take the same arguments, and their layer-1
    node tables are rank-local alike.
    """
    agg, drop = _rank_ops(graph, group, dropout, train, generator)
    return gcn_core(params, agg, x_local, drop)


def sharded_sage_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                         generator=None):
    """This rank's GraphSAGE logits: the self leg is local, the neighbour
    leg one :func:`sharded_spmm`; with identity features both
    ``sage1.w_self`` and ``sage1.w_neigh`` are rank-local node tables."""
    agg, drop = _rank_ops(graph, group, dropout, train, generator)
    return sage_core(params, agg, x_local, drop)


def sharded_sgc_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                        generator=None, k: int = SGC_K):
    """This rank's SGC logits: Â^k (X W) + b as ``k`` sharded SpMMs at the
    class width (SGC has no dropout); with identity features ``lin.w`` is
    the rank-local ``[rps, C]`` node table."""
    del dropout, train, generator
    agg, _ = _rank_ops(graph, group, 0.0, False, None)
    return sgc_core(params, agg, x_local, k)


def sharded_appnp_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                          generator=None, alpha: float = APPNP_ALPHA, k: int = APPNP_K):
    """This rank's APPNP logits: the MLP is local, each PPR step one
    :func:`sharded_spmm` at the class width; with identity features
    ``fc1.w`` is the rank-local node table."""
    agg, drop = _rank_ops(graph, group, dropout, train, generator)
    return appnp_core(params, agg, x_local, drop, alpha, k)


def sharded_gin_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                        generator=None):
    """This rank's GIN logits: the (1 + eps) self term is local, the
    neighbour term one :func:`sharded_spmm`; with identity features
    ``gin1.w1`` is the rank-local node table."""
    agg, drop = _rank_ops(graph, group, dropout, train, generator)
    return gin_core(params, agg, x_local, drop)


def sharded_gcnii_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                          generator=None, alpha: float = GCNII_ALPHA,
                          lam: float = DEFAULT_LAMBDA):
    """This rank's GCNII logits: one :func:`sharded_spmm` a layer, the
    anchor ``h0`` stays rank-local (the recurrence is the single-device
    ``gcnii_core``); with identity features ``fc_in.w`` is the rank-local
    node table."""
    agg, drop = _rank_ops(graph, group, dropout, train, generator)
    return gcnii_core(params, agg, x_local, drop, alpha, lam)


def _gat_attention_agg(a_src, a_dst, s: ShardCOO, h_local, group=None, slope: float = 0.2):
    """GAT attention and aggregation of this rank's rows on the all-gather
    segment layout (JAX ``_gat_attention_agg``): every edge of a row lies on
    the row's rank, so the softmax is local; the only collective is the
    differentiable all-gather of the projected rows."""
    rps = s.rows_per_shard
    h_full = all_gather_rows_ad(h_local, group)
    es, ed = h_local @ a_src, h_full @ a_dst
    e = F.leaky_relu(es[s.row] + ed[s.col], slope) + torch.log(s.val)
    att = segment_softmax(e, s.row, rps)
    return add_rows(rps, s.row, att[:, None] * h_full[s.col])


def _gat_halo_attention_agg(a_src, a_dst, hg: HaloPartitionedGraph, h_local, group=None,
                            slope: float = 0.2):
    """GAT attention and aggregation of this rank's rows over the halo ring
    with an online softmax (JAX ``_gat_halo_attention_agg``): at step ``s``
    the rank holds block ``q = (p + s) mod P``, scores bucket ``(p, q)``
    against it, rescales its running max ``m``, sum ``l`` and weighted sum
    ``acc`` by ``exp(m - m_new)``, adds the bucket's terms, and passes the
    block on to rank ``p - 1`` (JAX's ring ``[(i, (i - 1) % P)]``) through
    the differentiable shift. After ``P`` steps ``acc / l`` is the softmax
    aggregation; a row with no edge gives 0. The running max is taken
    without gradient: the result does not depend on it."""
    p, n, rps = hg.shard, hg.n_shards, hg.rows_per_shard
    es = h_local @ a_src
    m = torch.full((rps,), -math.inf, dtype=es.dtype, device=es.device)
    l = es.new_zeros(rps)
    acc = es.new_zeros((rps, h_local.shape[1]))
    hh = h_local
    for step in range(n):
        q = (p + step) % n
        r, c, v = hg.row[q], hg.col[q], hg.val[q]
        e = F.leaky_relu(es[r] + (hh @ a_dst)[c], slope) + torch.log(v)
        with torch.no_grad():
            m_new = m.scatter_reduce(0, r, e, "amax")
            # rows untouched so far keep m = -inf: their l and acc are 0
            scale = torch.where(torch.isinf(m), 0.0, det_exp(m - m_new))
            shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
        w = torch.where(torch.isfinite(e), det_exp(e - shift[r]), 0.0)
        l = l * scale + add_rows(rps, r, w)
        acc = acc * scale[:, None] + add_rows(rps, r, w[:, None] * hh[c])
        m = m_new
        if step < n - 1:
            hh = ring_shift_ad(hh, -1, group)
    return acc / torch.clamp(l, min=1e-30)[:, None]


def sharded_gat_forward(params, graph, x_local, *, group=None, dropout=0.0, train=False,
                        generator=None, negative_slope: float = 0.2):
    """This rank's GAT logits, the attention's form chosen by the layout
    (JAX ``sharded_gat_forward``): a :class:`ShardCOO` takes the local
    segment softmax after an all-gather, a :class:`HaloPartitionedGraph`
    the online softmax over the ring, a :class:`MeshAttentionAllGather` the
    attention kernels on the rank's rectangular attention graph (route
    B.3). With identity features ``gat1.w`` is the rank's ``[rps, H]`` rows
    of the node table."""
    if isinstance(graph, MeshAttentionAllGather):
        def attention(p, h):
            return mesh_gat_attention(graph, p["a_src"], p["a_dst"], h, group, negative_slope)
    elif isinstance(graph, HaloPartitionedGraph):
        def attention(p, h):
            return _gat_halo_attention_agg(p["a_src"], p["a_dst"], graph, h, group, negative_slope)
    elif isinstance(graph, ShardCOO):
        def attention(p, h):
            return _gat_attention_agg(p["a_src"], p["a_dst"], graph, h, group, negative_slope)
    else:
        raise TypeError(
            "sharded GAT needs the allgather ShardCOO (segment), the halo "
            "HaloPartitionedGraph (segment) or MeshAttentionAllGather (attention "
            f"kernels), got {type(graph).__name__}"
        )

    def layer(name, h_in):
        p = {k: params[f"{name}.{k}"] for k in GAT_KEYS}
        support = p["w"] if h_in is None else h_in @ p["w"]
        return attention(p, support) + p["b"]

    _, drop = _rank_ops(graph, group, dropout, train, generator)
    return layer("gat2", drop(torch.relu(layer("gat1", x_local))))
