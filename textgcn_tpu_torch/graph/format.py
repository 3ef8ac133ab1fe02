"""Graph-format / SpMM-kernel selection and the cost model behind ``auto``.

Port of ``textgcn_tpu/graph/format.py``. Every format computes the same
``Â @ x``; which container to build is a speed choice:

==========  ==============================================================
format      kernel
==========  ==============================================================
segment     gather + ``index_add_`` (plain PyTorch); the oracle.
dense       one [N, N] @ [N, F] f32 matmul.
bsr         the whole graph as 128x128 f32 tiles, no degree sort, through
            K1's f32 mode (``BlockSparseGraph``; f32 products and sums).
            For graphs whose edges cluster into tiles.
onehot      the whole graph as one row-sorted CSR through K2 from zero
            (``CSRGraph``; features gathered in bf16, f32 sums).
hybrid      degree-sort permutation, then tiles with >= 24 edges go to the
            tile kernel K1 (bf16) and the other edges to K2.
streamed    host-resident row-range chunks of a row-sorted CSR, streamed
            through K2 (``SortedStreamGraph``): forward passes; the Trainer
            refuses it, as the JAX Trainer cannot train it either, and the
            streamed steps train its chunks
            (``train/streamed.py`` ``STREAMED_SEGMENTED_FACTORIES``, ROADMAP
            A.12). Not in ``SPMM_FORMATS``, so the CLI does not offer it.
auto        dense up to ``DENSE_MAX_NODES`` nodes; above, the cheapest
            estimate of :func:`estimate_format_costs` with the H100's
            measured constants (:class:`MachineModel`): dense, segment,
            onehot and hybrid while the graph fits ``resident_bytes_budget``,
            streamed only beyond it.
==========  ==============================================================

``hybrid`` relabels nodes (P Â Pᵀ), so :func:`convert_graph` returns the
permutation alongside the container; callers apply it to features, labels
and split indices (``perm[old] = new``). The other formats return None.

The cost model prices one pass with the JAX package's formulas (dense:
bytes or f32 flops; segment and onehot: edges over the random-row gather
rate times each kernel's measured efficiency; streamed: unique-row gathers
and the bf16 product stream), except the hybrid's fixed cost: K1 has no
grouped tile packing, so the TPU's per-grid-step term (``tiles / 8`` steps)
becomes the host's fixed cost of the pass's kernel calls. Its constants are
the H100's, measured on the card (:func:`probe_machine`, ``chip_smoke.py``);
the port reads no TPU artifact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from textgcn_tpu_torch.graph.reorder import CSRGraph, degree_sort_permutation, reorder_and_build
from textgcn_tpu_torch.graph.structs import BlockSparseGraph, DenseGraph, SparseGraph
from textgcn_tpu_torch.ops.bsr_spmm import F_ALIGN
from textgcn_tpu_torch.ops.streamed_sorted import SortedStreamGraph

SPMM_FORMATS = ("auto", "segment", "dense", "bsr", "onehot", "hybrid")

# Up to this node count auto takes dense without pricing (the [N, N] f32
# table is at most 0.4 GB), as the JAX package does.
DENSE_MAX_NODES = 10_000

# kernel calls of one hybrid pass: K1, then K2 onto its output
HYBRID_CALLS = 2


@dataclasses.dataclass(frozen=True)
class MachineModel:
    """Per-card constants the ``auto`` cost model prices against.

    The defaults were measured on an NVIDIA H100 80GB HBM3 at a 700.00 W
    power limit by ``chip_smoke.py``'s phases (PERF.md names the run):
    "machine" (:func:`probe_machine`) for the rates and the call cost,
    "auto" for the efficiencies (R8 doc-word's passes at F = 200 against
    the probe's rates), "auto gat" for ``gat_dense_tables``. Remeasure with
    :func:`probe_machine` on another card.
    """

    hbm_gbps: float = 3012.55  # streaming bandwidth (read + write)
    # random 512 B rows of a 512 MB table, 4 reads a row (the oversubscribed
    # pattern of the JAX package's probe)
    gather_rows_per_s: float = 3.3376e9
    # random 512 B rows, each read once (the streamed paths' pattern)
    gather_unique_rows_per_s: float = 3.13942e9
    call_s: float = 21.5683e-6  # the host's fixed cost of one kernel call
    matmul_f32_flops: float = 51.6963e12  # torch.matmul in f32, TF32 off
    # each format's naive estimate over its measured pass (R8 doc-word, F =
    # 200, device time): segment's gather and index_add_; K2 over the whole
    # CSR, above 1 because its bf16 table sits in L2 while the probe's rows
    # come from memory; K1's tiles against their bytes
    eff_segment: float = 0.1127
    eff_onehot: float = 3.817
    eff_hybrid_bsr: float = 0.6781
    dense_bytes_budget: int = 16 << 30  # cap on the [N, N] f32 table(s)
    # device bytes a resident format may claim before auto routes to
    # streaming (80 GB less room for activations and Adam)
    resident_bytes_budget: int = 64 << 30
    # [N, N] f32-sized tables one dense GAT forward + backward holds at its
    # peak: 15.09 measured (torch.cuda.max_memory_allocated over 4 N^2 at R8
    # doc-word, H = 200), rounded up
    gat_dense_tables: float = 16.0


def estimate_format_costs(
    g: SparseGraph, f: int = 200, mm: MachineModel = MachineModel(), min_nnz: int = 24
) -> Dict[str, float]:
    """Estimated seconds per ``Â @ x`` pass of width ``f`` for each format
    eligible on ``g``."""
    costs, _ = _estimate_with_perm(g, f=f, mm=mm, min_nnz=min_nnz)
    return costs


def _estimate_with_perm(
    g: SparseGraph, f: int = 200, mm: MachineModel = MachineModel(), min_nnz: int = 24
) -> Tuple[Dict[str, float], Optional[np.ndarray]]:
    """(costs, the degree-sort permutation or None).

    dense, segment and onehot are closed-form; hybrid prices the graph's own
    degree-sorted 128x128 tile occupancy (one host sort and count, no tile
    built) split at ``min_nnz``: the tiles at the memory rate over K1's
    efficiency plus the pass's kernel calls, the residual at onehot's rate.
    dense is left out when its [N, N] table exceeds ``mm.dense_bytes_budget``.
    Past ``mm.resident_bytes_budget`` only ``streamed`` is eligible.
    """
    n, e = g.n_nodes, g.n_edges
    f_pad = -(-f // F_ALIGN) * F_ALIGN  # the kernels' feature table width
    bw = mm.hbm_gbps * 1e9
    costs: Dict[str, float] = {}
    # resident formats hold the edges (~12 B each) beside [N, f] f32
    # activations; past the budget only streaming is eligible
    if 12 * e + 8 * n * f_pad > mm.resident_bytes_budget:
        costs["streamed"] = e / mm.gather_unique_rows_per_s + (2.0 * e * f_pad * 2) / bw
        return costs, None
    dense_bytes = 4 * n * n
    if dense_bytes <= mm.dense_bytes_budget:
        costs["dense"] = max(
            (dense_bytes + 2 * 4 * n * f_pad) / bw,
            2.0 * n * n * f_pad / mm.matmul_f32_flops,
        )
    costs["segment"] = e / (mm.gather_rows_per_s * mm.eff_segment)
    costs["onehot"] = e / (mm.gather_rows_per_s * mm.eff_onehot)

    row, col, _ = g.coo_numpy()
    perm = degree_sort_permutation(row, col, n)
    r2, c2 = perm[row], perm[col]
    n_bcols = -(-max(n, 1) // 128)
    _, counts = np.unique((r2 // 128) * n_bcols + (c2 // 128), return_counts=True)
    tiles = int((counts >= min_nnz).sum())
    rest = e - int(counts[counts >= min_nnz].sum())
    tile_bytes = 128 * 128 * 2 + 128 * f_pad * 2  # bf16 tile and its x slab
    bsr_bytes = tiles * tile_bytes + (-(-n // 128) * 128) * f_pad * 4
    costs["hybrid"] = (
        bsr_bytes / bw / mm.eff_hybrid_bsr
        + HYBRID_CALLS * mm.call_s
        + rest / (mm.gather_rows_per_s * mm.eff_onehot)
    )
    return costs, perm


def choose_format(g: SparseGraph, f: int = 200, mm: Optional[MachineModel] = None) -> str:
    """The cheapest estimated format for ``g`` (:func:`estimate_format_costs`
    with ``mm``, the H100 defaults when None)."""
    fmt, _ = _choose_with_aux(g, f=f, mm=mm)
    return fmt


def _choose_with_aux(g, f=200, mm=None):
    costs, perm = _estimate_with_perm(g, f=f, mm=mm or MachineModel())
    fmt = min(costs, key=costs.get)
    return fmt, (perm if fmt == "hybrid" else None)


def gat_auto_format(n_nodes: int, mm: Optional[MachineModel] = None,
                    dense_max_nodes: int = DENSE_MAX_NODES) -> str:
    """GAT's ``auto``: ``"dense"`` (the [N, N] log-adjacency) up to
    ``dense_max_nodes`` nodes, and above while the tables one dense GAT
    forward + backward holds at its peak (``mm.gat_dense_tables`` of 4 N²
    bytes) fit ``mm.dense_bytes_budget``; else ``"hybrid"`` (the attention
    kernels after the degree sort). The JAX package prices one [N, N] f32
    table; the dense layer holds several."""
    mm = mm or MachineModel()
    if n_nodes <= dense_max_nodes:
        return "dense"
    peak = mm.gat_dense_tables * 4.0 * n_nodes * n_nodes
    return "dense" if peak <= mm.dense_bytes_budget else "hybrid"


def convert_graph(
    g: SparseGraph,
    fmt: str = "auto",
    *,
    symmetric: bool = True,
    dense_max_nodes: int = DENSE_MAX_NODES,
    f: int = 200,
    mm: Optional[MachineModel] = None,
) -> Tuple[object, Optional[np.ndarray]]:
    """SparseGraph → (graph container, node permutation or None). ``fmt`` is
    one of ``SPMM_FORMATS`` or ``"streamed"``. Containers live on g's
    device, except ``streamed``, whose chunks stay on the host.

    ``symmetric=True`` asserts value-symmetry of the matrix (true for every
    sym-normalized Â); the bsr, onehot and hybrid backward rely on it. ``f``
    is the feature width ``auto`` prices a pass at, ``mm`` its constants.
    """
    if fmt not in (*SPMM_FORMATS, "streamed"):
        raise ValueError(
            f"unknown spmm format {fmt!r}; choose one of {SPMM_FORMATS} or 'streamed'"
        )
    perm_hint = None
    if fmt == "auto":
        if g.n_nodes <= dense_max_nodes:
            fmt = "dense"
        else:
            fmt, perm_hint = _choose_with_aux(g, f=f, mm=mm)
    if fmt == "segment":
        return g, None
    if fmt == "dense":
        return DenseGraph.from_sparse_graph(g), None
    device = g.val.device
    row, col, val = g.coo_numpy()
    if fmt == "streamed":
        return SortedStreamGraph.from_coo(row, col, val, g.n_nodes, symmetric=symmetric), None
    if fmt == "bsr":
        # f32 tiles, no degree sort (the JAX package's convert_graph)
        return BlockSparseGraph.from_coo(
            row, col, val, g.n_nodes, symmetric=symmetric, device=device
        ), None
    if fmt == "onehot":
        return CSRGraph.from_coo(row, col, val, g.n_nodes, symmetric=symmetric, device=device), None
    # hybrid (the cost model's permutation is reused when it computed one)
    perm, hybrid = reorder_and_build(
        row, col, val, g.n_nodes, symmetric=symmetric, perm=perm_hint, device=device
    )
    return hybrid, perm


def probe_machine(device) -> MachineModel:
    """The card's rates, measured here with CUDA events in this process
    (the port's counterpart of ``bench.py`` ``roofline_probe``): the memory
    stream rate (an f32 axpy over 1 GiB, read and written), the random-row
    gather rate of 512 B rows (``embedding_bag`` sums of 4M random rows of a
    [1M, 128] f32 table, 4 reads a row) and of unique rows (a permutation of
    the same 1M rows), the host's fixed cost of one kernel call (K2 on a
    one-edge CSR), and the f32 matmul rate (8192³, TF32 off). The other
    fields keep their defaults. Raises without a CUDA device."""
    from textgcn_tpu_torch.ops.row_reduce import row_reduce

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError(f"probe_machine measures a CUDA device, got {device}")

    def ms(fn, reps=10):
        for _ in range(2):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    gen = torch.Generator(device=device).manual_seed(0)
    n = 1 << 28
    x = torch.rand(n, generator=gen, device=device)
    y = torch.empty_like(x)
    hbm = 2 * 4 * n / (ms(lambda: torch.add(x, 0.25, alpha=1.0000001, out=y)) * 1e-3) / 1e9
    del x, y
    rows, ng, bag = 1 << 20, 1 << 22, 128
    tbl = torch.rand((rows, 128), generator=gen, device=device)
    idx = torch.randint(0, rows, (ng,), generator=gen, device=device)
    uniq = torch.randperm(rows, generator=gen, device=device)
    gather = ng / (ms(lambda: torch.nn.functional.embedding_bag(
        idx.view(-1, bag), tbl, mode="sum")) * 1e-3)
    unique = rows / (ms(lambda: torch.nn.functional.embedding_bag(
        uniq.view(-1, bag), tbl, mode="sum")) * 1e-3)
    del tbl, idx, uniq
    ptr = torch.tensor([0, 1], dtype=torch.int32, device=device)
    one = torch.zeros(1, dtype=torch.int32, device=device)
    val = torch.ones(1, device=device)
    xs = torch.zeros((1, 16), dtype=torch.bfloat16, device=device)
    launches = row_reduce.launches
    call = ms(lambda: row_reduce(ptr, one, val, xs), reps=200) * 1e-3
    row_reduce.launches = launches  # a probe, not a path's launches
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        a = torch.rand((8192, 8192), generator=gen, device=device)
        flops = 2 * 8192 ** 3 / (ms(lambda: torch.matmul(a, a), reps=5) * 1e-3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del a
    torch.cuda.empty_cache()
    return MachineModel(
        hbm_gbps=hbm, gather_rows_per_s=gather, gather_unique_rows_per_s=unique,
        call_s=call, matmul_f32_flops=flops,
    )


def permute_rows(x: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Relabel row ``old`` to row ``perm[old]`` (new[perm[i]] = old[i])."""
    out = np.empty_like(x)
    out[perm] = x
    return out
