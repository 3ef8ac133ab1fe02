"""Graph-format / SpMM-kernel selection.

Port of ``textgcn_tpu/graph/format.py`` for the formats the port has. Every
format computes the same ``Â @ x``; which container to build is a speed
choice:

==========  ==============================================================
format      kernel
==========  ==============================================================
segment     gather + ``index_add_`` (plain PyTorch); the oracle.
dense       one [N, N] @ [N, F] matmul; for graphs up to 10k nodes.
hybrid      degree-sort permutation, then tiles with >= 24 edges go to the
            tile kernel K1 and the other edges to the residual kernel K2.
streamed    host-resident row-range chunks of a row-sorted CSR (at most
            ``CHUNK_EDGES`` edges each), streamed through K2 with a one-chunk
            transfer lookahead (``SortedStreamGraph``): forward passes
            only. Not in ``SPMM_FORMATS``, so the CLI does not offer it;
            training streams through ``spmm_streamed_sorted_sym``.
auto        dense up to ``DENSE_MAX_NODES`` nodes. Above, the JAX package
            prices formats with TPU constants; the port has no GPU
            constants yet and raises (ROADMAP A: the H100 machine model).
==========  ==============================================================

``hybrid`` relabels nodes (P Â Pᵀ), so :func:`convert_graph` returns the
permutation alongside the container; callers apply it to features, labels
and split indices (``perm[old] = new``). The other formats return None.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from textgcn_tpu_torch.graph.reorder import reorder_and_build
from textgcn_tpu_torch.graph.structs import DenseGraph, SparseGraph
from textgcn_tpu_torch.ops.streamed_sorted import SortedStreamGraph

SPMM_FORMATS = ("auto", "segment", "dense", "hybrid")

# Up to this node count the dense [N, N] f32 table is at most 0.4 GB.
DENSE_MAX_NODES = 10_000


def convert_graph(
    g: SparseGraph,
    fmt: str = "auto",
    *,
    symmetric: bool = True,
    dense_max_nodes: int = DENSE_MAX_NODES,
) -> Tuple[object, Optional[np.ndarray]]:
    """SparseGraph → (graph container, node permutation or None). ``fmt`` is
    one of ``SPMM_FORMATS`` or ``"streamed"``. Containers live on g's
    device, except ``streamed``, whose chunks stay on the host.

    ``symmetric=True`` asserts value-symmetry of the matrix (true for every
    sym-normalized Â); the hybrid backward relies on it.
    """
    if fmt == "streamed":
        row, col, val = g.coo_numpy()
        return SortedStreamGraph.from_coo(row, col, val, g.n_nodes, symmetric=symmetric), None
    if fmt not in SPMM_FORMATS:
        raise ValueError(
            f"unknown spmm format {fmt!r}; choose one of {SPMM_FORMATS} or 'streamed'"
        )
    if fmt == "auto":
        if g.n_nodes > dense_max_nodes:
            raise NotImplementedError(
                f"--spmm auto above {dense_max_nodes} nodes needs the GPU cost "
                "model (ROADMAP A: the H100 MachineModel and auto pricing); "
                "choose --spmm hybrid, segment or dense"
            )
        fmt = "dense"
    if fmt == "segment":
        return g, None
    if fmt == "dense":
        return DenseGraph.from_sparse_graph(g), None
    row, col, val = g.coo_numpy()
    perm, hybrid = reorder_and_build(
        row, col, val, g.n_nodes, symmetric=symmetric, device=g.val.device
    )
    return hybrid, perm


def permute_rows(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Relabel row ``old`` to row ``perm[old]`` (new[perm[i]] = old[i])."""
    out = np.empty_like(x)
    out[perm] = x
    return out
