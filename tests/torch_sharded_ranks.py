"""Functions that spawned ranks run for ``tests/test_torch_sharded.py``.

A spawned child imports the module of the function it runs; this one
imports torch and the port only, never JAX, so a child stays clear of it.
"""
import numpy as np
import torch

from textgcn_tpu_torch.parallel.distributed import all_gather_rows
from textgcn_tpu_torch.parallel.mesh_kernels import MeshHybridAllGather, spmm_mesh_hybrid
from textgcn_tpu_torch.parallel.partition import ShardCOO, shard_rows
from textgcn_tpu_torch.parallel.sharded import spmm_sharded


def spmm_forward_backward(rank, world, device, row, col, val, n, x, w, min_nnz):
    """On every rank, ``y = A x`` and ``d/dx sum(y * w)`` for the rank's rows,
    through ``spmm_mesh_hybrid`` and through the segment oracle
    ``spmm_sharded`` (same geometry); each gathered over the ranks, as
    [n_pad, F] numpy arrays."""
    mh = MeshHybridAllGather.from_coo(row, col, val, n, world, rank, min_nnz=min_nnz, device=device)
    seg = ShardCOO.from_coo(
        row, col, val, n, world, rank, rows_per_shard=mh.rows_per_shard, device=device
    )
    ws = torch.from_numpy(shard_rows(w, rank, mh.rows_per_shard))
    out = []
    for fn, g in ((spmm_mesh_hybrid, mh), (spmm_sharded, seg)):
        xs = torch.from_numpy(shard_rows(x, rank, mh.rows_per_shard)).requires_grad_(True)
        y = fn(g, xs)
        (y * ws).sum().backward()
        out += [all_gather_rows(y.detach()).numpy(), all_gather_rows(xs.grad).numpy()]
    return [np.asarray(a) for a in out]


def fail_on_rank_1(rank, world, device):
    """Rank 1 raises; the others wait in an all-reduce it never joins."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1))
