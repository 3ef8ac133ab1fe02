"""Functions that spawned ranks run for ``tests/test_torch_sharded.py``,
``tests/test_torch_halo.py``, ``tests/test_torch_sharded_families.py``,
``tests/test_torch_sharded_gat.py``, ``tests/test_torch_sharded_checkpoint.py``
and ``tests/test_torch_streamed_mesh.py``.

A spawned child imports the module of the function it runs; this one
imports torch and the port only, never JAX, so a child stays clear of it.
"""
import contextlib
import dataclasses

import numpy as np
import torch

from textgcn_tpu_torch.parallel.distributed import all_gather_rows, all_reduce_sum
from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph
from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather, MeshOneHotAllGather, MeshOneHotHalo, spmm_mesh_hybrid,
)
from textgcn_tpu_torch.parallel.partition import ShardCOO, shard_rows
from textgcn_tpu_torch.parallel.sharded import sharded_spmm, spmm_sharded
from textgcn_tpu_torch.parallel.trainer import (
    SHARDED_MODELS, ShardedTrainer, local_params, node_tables, shard_params_from_jax,
)

@contextlib.contextmanager
def one_thread():
    """Run the rank's small tensor work on one CPU thread: the ranks of a
    spawn (and the other test workers) share the cores, and more threads
    on tensors this small only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# (kernel, partition) -> layout, with GAT's attention-kernel layout apart
LAYOUTS = {
    ("segment", "allgather"): ShardCOO,
    ("segment", "halo"): HaloPartitionedGraph,
    ("onehot", "allgather"): MeshOneHotAllGather,
    ("onehot", "halo"): MeshOneHotHalo,
    ("hybrid", "allgather"): MeshHybridAllGather,
    ("attention", "allgather"): MeshAttentionAllGather,
}


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


def _fwd_bwd(rank, layout, x, w):
    """``y = A x`` and ``d/dx sum(y * w)`` on this rank's rows through
    ``sharded_spmm``, each gathered over the ranks ([n_pad, F] numpy)."""
    rps = layout.rows_per_shard
    xs = torch.from_numpy(shard_rows(x, rank, rps)).requires_grad_(True)
    y = sharded_spmm(layout, xs)
    (y * torch.from_numpy(shard_rows(w, rank, rps))).sum().backward()
    return all_gather_rows(y.detach()).numpy(), all_gather_rows(xs.grad).numpy()


def halo_and_onehot_passes(rank, world, device, sym, nonsym, x, w):
    """Forward and backward of the three new layouts on the symmetric COO
    ``sym`` = (row, col, val, n): the segment ring (``HaloPartitionedGraph``)
    and the one-hot layouts (``MeshOneHotAllGather``, ``MeshOneHotHalo``);
    then the segment ring on the non-symmetric COO ``nonsym``, and whether
    each one-hot layout built ``symmetric=False`` refuses its backward."""
    out = {}
    for name, cls in (("halo", HaloPartitionedGraph), ("onehot_allgather", MeshOneHotAllGather),
                      ("onehot_halo", MeshOneHotHalo)):
        out[name] = _fwd_bwd(rank, cls.from_coo(*sym, world, rank, device=device), x, w)
    out["halo_nonsym"] = _fwd_bwd(
        rank, HaloPartitionedGraph.from_coo(*nonsym, world, rank, device=device), x, w
    )
    refused = []
    for cls in (MeshOneHotAllGather, MeshOneHotHalo):
        layout = cls.from_coo(*nonsym, world, rank, symmetric=False, device=device)
        try:
            _fwd_bwd(rank, layout, x, w)
            refused.append("no error")
        except NotImplementedError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def family_fwd_bwd(rank, world, device, coo, cases):
    """For each case ``(name, model, kernel, partition, full, x, w)``: this
    rank's parameters from the whole model's numpy dict ``full``
    (``local_params``), the family's sharded forward on the layout of
    ``(kernel, partition)`` (kernel ``attention``: GAT's kernel layout) with
    features ``x`` ([n, F], or None for identity features), and the gradients
    of the masked loss ``sum(logits * w)`` (``w`` [n, C], zero off the mask).
    Rank 0 returns, for each name, the logits [n, C] gathered over the ranks
    and the gradients: each node table's rows gathered, each replicated
    parameter's summed over the ranks."""
    row, col, val, n = coo
    out, layouts = {}, {}
    with one_thread():
        for name, model, kernel, partition, full, x, w in cases:
            if (kernel, partition) not in layouts:
                layouts[kernel, partition] = LAYOUTS[kernel, partition].from_coo(
                    row, col, val, n, world, rank, device=device
                )
            layout = layouts[kernel, partition]
            rps, identity = layout.rows_per_shard, x is None
            params = local_params({k: torch.tensor(v) for k, v in full.items()}, model,
                                  identity, rank, rps)
            params = {k: v.requires_grad_(True) for k, v in params.items()}
            x_local = None if identity else torch.from_numpy(shard_rows(x, rank, rps))
            logits = SHARDED_MODELS[model][1](params, layout, x_local)
            (logits * torch.from_numpy(shard_rows(w, rank, rps))).sum().backward()
            tables = node_tables(model) if identity else ()
            grads = {
                k: (all_gather_rows(p.grad)[:n] if k in tables else all_reduce_sum(p.grad.clone()))
                for k, p in params.items()
            }
            out[name] = (all_gather_rows(logits.detach())[:n].numpy(),
                         {k: g.numpy() for k, g in grads.items()})
    return out if rank == 0 else None


def train_combos(rank, world, device, data, config, combos):
    """``ShardedTrainer`` on this rank for each (model, kernel, partition)
    of ``combos``; rank 0 returns [(history, test), ...]."""
    runs = []
    with one_thread():
        for model, kernel, partition in combos:
            t = ShardedTrainer(
                data.graph(), data.features, data.target, data.train_idx, data.test_idx,
                data.n_classes, config=dataclasses.replace(config, model=model),
                n_shards=world, rank=rank, device=device, kernel=kernel, partition=partition,
            )
            t.fit(verbose=False)
            runs.append((t.history, t.test()))
    return runs if rank == 0 else None


def checkpoint_jobs(rank, world, device, datasets, config, jobs):
    """``ShardedTrainer`` on this rank for each job, a dict: ``name``, the
    data key ``data``, ``kernel``, ``partition``, optional ``config``
    overrides, then ``load`` (a checkpoint to evaluate), or a fit (from
    ``params_np``, the JAX trainer's init, or ``resume_from``) followed by
    ``save_state`` / ``save_model``. Rank 0 returns {name: (history,
    test)}."""
    out = {}
    with one_thread():
        for job in jobs:
            data = datasets[job["data"]]
            cfg = dataclasses.replace(config, **job.get("config", {}))
            t = ShardedTrainer(
                data.graph(), data.features, data.target, data.train_idx, data.test_idx,
                data.n_classes, config=cfg, n_shards=world, rank=rank, device=device,
                kernel=job["kernel"], partition=job["partition"],
            )
            if "load" in job:
                t.load(job["load"])
            else:
                params = None
                if "params_np" in job:
                    params = shard_params_from_jax(job["params_np"], rank, t.rps,
                                                   data.features is None, model=cfg.model,
                                                   device=device)
                t.fit(verbose=False, params=params, resume_from=job.get("resume_from"))
            if "save_state" in job:
                t.save_training_state(job["save_state"])
            if "save_model" in job:
                t.save(job["save_model"])
            out[job["name"]] = (t.history, t.test())
    return out if rank == 0 else None


def streamed_mesh_runs(rank, world, device, coo, x, t, path, max_chunk_edges, cases):
    """The sorted ring on this rank (``parallel/streamed.py``): the buckets
    of the halo partition of ``coo`` = (row, col, val, n) cut at
    ``max_chunk_edges``; ``Â x`` and ``d/dx sum(Â x * t)`` through
    ``spmm_streamed_mesh_sorted`` (gathered [n_pad, F]); the pass from the
    bucket files written under ``path``, bit-equal to the resident one on
    every rank; then for each case ``(name, family, hyper, params, (x, y,
    mask), hooks, steps)`` that many Adam steps (lr 0.02, f32 stream) of the
    sharded step from the flat numpy ``params``: ``hooks`` "both" is
    ``make_streamed_sharded_step_segmented``, "no_count" / "no_sync" the
    single-device factory on the ring without the global denominator / the
    gradient all-reduce. Rank 0 returns everything, each case's (losses,
    parameters after the steps)."""
    from functools import partial

    from textgcn_tpu_torch.parallel import streamed as ps
    from textgcn_tpu_torch.train.streamed import STREAMED_SEGMENTED_FACTORIES

    row, col, val, n = coo
    out = {}
    with one_thread():
        hg = HaloPartitionedGraph.from_coo(row, col, val, n, world, rank, device=device)
        rps = hg.rows_per_shard
        buckets = ps.halo_sorted_bucket_stream(hg, max_chunk_edges)
        xs = torch.from_numpy(shard_rows(x, rank, rps)).requires_grad_(True)
        y = ps.spmm_streamed_mesh_sorted(buckets, xs)
        (y * torch.from_numpy(shard_rows(t, rank, rps))).sum().backward()
        out["pass"] = all_gather_rows(y.detach()).numpy()
        out["grad"] = all_gather_rows(xs.grad).numpy()
        out["chunks"] = all_gather_rows(torch.tensor([[len(b) for b in buckets.chunks]])).tolist()
        ps.save_halo_sorted_buckets(hg, path, max_chunk_edges)
        torch.distributed.barrier()
        source, n_chunks, n_shards, rps_f = ps.mesh_sorted_chunks_from_dir(path, rank)
        with torch.no_grad():
            resident = ps.spmm_streamed_mesh_sorted_hostfed(buckets, xs.detach())
            from_files = ps.spmm_streamed_mesh_sorted_hostfed(source, xs.detach())
        same = (torch.equal(resident, from_files) and (n_shards, rps_f) == (world, rps)
                and n_chunks == [len(b) for b in buckets.chunks])
        out["files_equal"] = all_gather_rows(torch.tensor([[int(same)]])).flatten().tolist()
        for name, family, hyper, params_np, (fx, fy, fmask), hooks, steps in cases:
            params = {k: torch.tensor(v).requires_grad_(True) for k, v in params_np.items()}
            opt = torch.optim.Adam(params.values(), lr=0.02)
            xl, yl, ml = ps.shard_streamed_inputs(fx, fy, fmask, rank, rps, device=device)
            kw = dict(stream_dtype=torch.float32, **hyper)
            if hooks == "both":
                step = ps.make_streamed_sharded_step_segmented(family, buckets, rps, opt, **kw)
            else:
                # the single-device factory on the ring, one hook left out
                hook = ({"grad_sync": partial(ps.grad_all_reduce, group=None)}
                        if hooks == "no_count" else {"count": ps._GlobalCount(None)})
                inner = STREAMED_SEGMENTED_FACTORIES[family](
                    ps.mesh_stream(buckets), rps, opt, **hook, **kw)

                def step(p, a, b, c, inner=inner):
                    return all_reduce_sum(inner(p, a, b, c).clone())
            losses = [float(step(params, xl, yl.long(), ml)) for _ in range(steps)]
            out[name] = (losses, {k: v.detach().numpy() for k, v in params.items()})
    return out if rank == 0 else None
