"""The sharded hybrid GCN of the PyTorch port (``textgcn_tpu_torch.parallel``)
against the JAX package's mesh path, on the CPU.

JAX runs on its 8 virtual CPU devices with the Pallas kernels in interpret
mode, as its own tests run them; the port's kernel wrappers run their plain
PyTorch versions on CPU tensors. Multi-rank tests start gloo ranks through
the port's launcher (rank 0 in this process, the others spawned; a
``file://`` store, 60 s collective time limit, children joined with a time
limit and terminated past it), and each spawned rank runs a function of
``tests/torch_sharded_ranks.py``, which does not import JAX.
"""
import dataclasses
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from textgcn_tpu.graph.normalize import sym_normalize_coo as j_sym_normalize
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models.gcn import gcn_init as j_gcn_init
from textgcn_tpu.parallel import distributed as jdistributed
from textgcn_tpu.parallel import mesh_kernels as jmesh
from textgcn_tpu.parallel import trainer as jptrainer
from textgcn_tpu.parallel.partition import pad_features as j_pad_features
from textgcn_tpu.parallel.partition import partition_rows as j_partition_rows
from textgcn_tpu.parallel.sharded import make_mesh
from textgcn_tpu.train.trainer import TrainConfig as JTrainConfig

import torch_sharded_ranks
from test_mesh_kernels import _data as _mesh_data
from test_torch_train import N_CLASSES, _prepared

from textgcn_tpu_torch import cli
from textgcn_tpu_torch.graph import reorder as treorder
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.ops.bsr_spmm import TILE, bsr_leg
from textgcn_tpu_torch.parallel import distributed, launch, partition
from textgcn_tpu_torch.parallel import trainer as ptrainer
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshHybridAllGather,
    shard_hybrid_pass,
    shard_hybrid_pass_plain,
)
from textgcn_tpu_torch.train import metrics as tmetrics
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.train.run import run_experiment

CPU = torch.device("cpu")
# every collective of a spawned test raises after this long, so a rank
# that dies cannot hang the suite
TIMEOUT_S = 60.0


def _gloo(fn, world, args):
    return launch.spawn_ranks(
        fn, world, args, backend="gloo", devices=["cpu"] * world, timeout_s=TIMEOUT_S
    )


def _hub_graph():
    """The graph of the JAX package's ``test_mesh_hybrid_matches_scipy``:
    hub edges among the first 120 nodes (dense tiles) plus uniform edges
    (the residual), sym-normalized, n=700."""
    rng = np.random.RandomState(0)
    n = 700
    rc = np.vstack([rng.randint(0, 120, (4000, 2)), rng.randint(0, n, (3000, 2))])
    row = np.r_[rc[:, 0], rc[:, 1]]
    col = np.r_[rc[:, 1], rc[:, 0]]
    r, c, v = j_sym_normalize(row, col, np.ones_like(row, dtype=np.float64), n)
    return r, c, v, n, rng


@pytest.mark.parametrize("n,p", [(15362, 4), (15362, 1), (700, 8), (33, 4), (5, 8)])
def test_shard_geometry_equals_jax(n, p):
    assert partition.shard_geometry(n, p) == jmesh._shard_geometry(n, p)
    rps, n_pad = jmesh._shard_geometry(n, p)
    want = (jmesh._round_up(rps, 128), jmesh._round_up(rps, 128) * p)
    assert partition.shard_geometry(n, p, row_align=TILE) == want
    if (n, p) == (15362, 4):  # R8 doc-word at P = 4
        assert want == (3968, 15872)


def test_partition_rows_equals_jax():
    r, c, v, n, _ = _hub_graph()
    pg = j_partition_rows(JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256), 8)
    shards = partition.partition_rows(SparseGraph.from_coo(r, c, v, n, device=CPU), 8)
    for p, s in enumerate(shards):
        k = len(s.row)
        assert (s.rows_per_shard, s.n_pad) == (pg.rows_per_shard, pg.n_pad)
        np.testing.assert_array_equal(s.row.numpy(), np.asarray(pg.row[p][:k]))
        np.testing.assert_array_equal(s.col.numpy(), np.asarray(pg.col[p][:k]))
        np.testing.assert_array_equal(s.val.numpy(), np.asarray(pg.val[p][:k]))
        assert (np.asarray(pg.row[p][k:]) == pg.rows_per_shard).all()  # JAX's phantoms
    x = np.arange(12.0).reshape(6, 2)
    np.testing.assert_array_equal(partition.pad_features(x, 8), j_pad_features(x, 8))


def _residual_edges(mh):
    """(local row, col, val) of a shard's residual CSR (empty when None)."""
    if mh.rest is None:
        return [], [], []
    rows = np.repeat(np.arange(mh.rows_per_shard), np.diff(mh.rest.row_ptr.numpy()))
    return rows.tolist(), mh.rest.col.numpy().tolist(), mh.rest.val.numpy().tolist()


def _jax_shard_residual(oh, p):
    """(local row, col, val) of shard ``p``'s one-hot residual plan, phantom
    slots dropped."""
    lrow = np.asarray(oh.lrow[p])
    rows = (np.asarray(oh.wloc[p])[:, None] * oh.w + lrow).reshape(-1)
    real = lrow.reshape(-1) < oh.w
    return rows[real], np.asarray(oh.col[p])[real], np.asarray(oh.val[p])[real]


def test_bsr_leg_per_shard_matches_jax_interpret():
    """B10: each shard's tile leg, JAX ``_bsr_leg_apply`` in interpret mode
    (grouped tiles) against K1's plain version on the port's rectangular
    block of the same shard. Tol 1e-5: the same bf16 products summed in f32.
    The residual legs hold the same edges."""
    r, c, v, n, rng = _hub_graph()
    f = 20
    mg = jmesh.MeshHybridAllGather.from_graph(
        JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256), 8, min_nnz=200, k=128, w=8
    )
    x = rng.randn(mg.n_pad, f).astype(np.float32)
    x[n:] = 0
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 128 - f))).astype(jnp.bfloat16)
    leg = mg.bsr
    for p in range(8):
        mh = MeshHybridAllGather.from_coo(r, c, v, n, 8, p, min_nnz=200, device=CPU)
        assert (mh.rows_per_shard, mh.n_pad, mh.bsr_edges) == (
            mg.rows_per_shard, mg.n_pad, mg.bsr_edges
        )
        want = np.asarray(
            jmesh._bsr_leg_apply(leg, leg.rows[p], leg.cols[p], leg.blocks[p], xp, True)
        )[: mg.rows_per_shard, :f]
        b = mh.bsr
        xt = treorder.feature_table(torch.from_numpy(x), mh.n_pad, torch.bfloat16)
        got = bsr_leg(b.blocks, b.tile_ptr, b.block_cols, xt)[:, :f]
        assert got.shape == (mh.rows_per_shard, f)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        got_e = sorted(zip(*_residual_edges(mh)))
        want_e = sorted(zip(*(a.tolist() for a in _jax_shard_residual(mg.onehot, p))))
        assert [g[:2] for g in got_e] == [w_[:2] for w_ in want_e]
        np.testing.assert_allclose([g[2] for g in got_e], [w_[2] for w_ in want_e], rtol=1e-6)


def _powerlaw(n=700, e=24000, seed=0):
    """A degree-sorted sym-normalized power-law graph with both legs."""
    from test_torch_hybrid import _normalized_powerlaw

    r, c, v, n = _normalized_powerlaw(n=n, e=e, seed=seed)
    perm = treorder.degree_sort_permutation(r, c, n)
    return perm[r], perm[c], v, n


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_shards_put_together_equal_the_single_device_hybrid(n_shards):
    """Every shard count selects the single-device hybrid's tiles and
    residual edges, and the shard passes stacked equal its pass row for row
    (the same tiles and residual rows summed in the same order; f32 tiles)."""
    r, c, v, n = _powerlaw()
    h = treorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, store_bf16=False, device=CPU)
    x = torch.from_numpy(np.random.RandomState(1).randn(n, 24).astype(np.float32))
    want = treorder.hybrid_pass(h, x)
    keys, tiles, res, outs = [], [], [], []
    for p in range(n_shards):
        mh = MeshHybridAllGather.from_coo(r, c, v, n, n_shards, p, store_bf16=False, device=CPU)
        b, lbr = mh.bsr, mh.rows_per_shard // TILE
        assert b.n_block_rows == lbr and mh.bsr_edges == h.bsr.n_edges
        keys += list((b.block_rows.numpy() + p * lbr) * 10_000 + b.block_cols.numpy())
        tiles.append(b.blocks.numpy())
        rr, rc, _ = _residual_edges(mh)
        res += [(a + p * mh.rows_per_shard, b_) for a, b_ in zip(rr, rc)]
        x_full = torch.zeros((mh.n_pad, 24))
        x_full[:n] = x
        out = shard_hybrid_pass(mh, x_full)
        assert torch.equal(out, shard_hybrid_pass_plain(mh, x_full))
        outs.append(out)
    hb = h.bsr
    real = hb.blocks.abs().sum(dim=(1, 2)).numpy() > 0  # drop coverage tiles
    want_keys = hb.block_rows.numpy()[real] * 10_000 + hb.block_cols.numpy()[real]
    assert keys == list(want_keys)
    np.testing.assert_array_equal(np.concatenate(tiles), hb.blocks.numpy()[real])
    hr = np.repeat(np.arange(n), np.diff(h.rest.row_ptr.numpy()))
    assert res == list(zip(hr.tolist(), h.rest.col.numpy().tolist()))
    got = torch.cat(outs)
    assert torch.equal(got[:n], want) and not got[n:].any()


def test_spmm_mesh_hybrid_matches_jax_forward_and_backward():
    """``spmm_mesh_hybrid`` on 4 gloo ranks against JAX ``spmm_mesh_onehot``
    on a ``MeshHybridAllGather`` (4 devices), forward and backward, at 2e-2:
    JAX rounds residual products to bf16, the port does not. The port's
    segment oracle (whose backward is the true transpose, one all-reduce)
    agrees with the hybrid to bf16 tolerance and with scipy to 1e-5."""
    r, c, v, n, rng = _hub_graph()
    f = 20
    g = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    mg = jmesh.MeshHybridAllGather.from_graph(g, 4, min_nnz=200, k=128, w=8)
    assert mg.onehot is not None and 0 < mg.dense_fraction < 1
    x = np.zeros((mg.n_pad, f), np.float32)
    x[:n] = rng.randn(n, f)
    w = np.zeros((mg.n_pad, f), np.float32)
    w[:n] = rng.randn(n, f)
    mesh = make_mesh(4)
    xs = jax.device_put(x, NamedSharding(mesh, P("nodes", None)))
    y_j = np.asarray(jmesh.spmm_mesh_onehot(mg, xs, mesh, True))
    dx_j = np.asarray(
        jax.jit(jax.grad(lambda a: jnp.sum(jmesh.spmm_mesh_onehot(mg, a, mesh, True) * w)))(xs)
    )
    y, dx, y_seg, dx_seg = _gloo(
        torch_sharded_ranks.spmm_forward_backward, 4, (r, c, v, n, x, w, 200)
    )
    np.testing.assert_allclose(y, y_j, rtol=0, atol=2e-2)
    np.testing.assert_allclose(dx, dx_j, rtol=0, atol=2e-2)
    a = sp.coo_matrix((v, (r, c)), shape=(mg.n_pad,) * 2).tocsr()
    np.testing.assert_allclose(y_seg, a @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx_seg, a.T @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y, y_seg, rtol=0, atol=2e-2)
    np.testing.assert_allclose(dx, dx_seg, rtol=0, atol=2e-2)


def test_spmm_mesh_hybrid_on_a_group_of_one_is_the_hybrid_pass(tmp_path):
    """With one rank the all-gathers are the identity: forward and backward
    equal the single-device hybrid pass."""
    r, c, v, n = _powerlaw(n=300, e=6000, seed=3)
    h = treorder.HybridGraph.from_coo(r, c, v, n, symmetric=True, device=CPU)
    mh = MeshHybridAllGather.from_coo(r, c, v, n, 1, 0, device=CPU)
    x = torch.from_numpy(np.random.RandomState(2).randn(mh.n_pad, 8).astype(np.float32))
    x[n:] = 0
    cfg = distributed.DistributedConfig(f"file://{tmp_path}/store", 1, 0)
    distributed.init_process_group(cfg, "gloo", TIMEOUT_S)
    try:
        from textgcn_tpu_torch.parallel.mesh_kernels import spmm_mesh_hybrid

        xs = x.clone().requires_grad_(True)
        y = spmm_mesh_hybrid(mh, xs)
        y.backward(x)
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(y.detach()[:n], treorder.hybrid_pass(h, x[:n]))
    assert torch.equal(xs.grad[:n], treorder.hybrid_pass(h, x[:n]))


def _jax_init(seed, n_in, hidden, classes):
    """The JAX trainers' init: split PRNGKey(seed), init from the second key."""
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, j_gcn_init(init_key, n_in, hidden, classes))


def test_sharded_trainer_matches_jax_sharded_trainer():
    """4 gloo ranks against JAX ``ShardedTrainer(kernel="hybrid",
    n_shards=4)`` from JAX's own init (``shard_params_from_jax``), dropout 0,
    dense features: the first-epoch loss within 5e-3 and test accuracy
    within 0.1, as the JAX package holds its own hybrid mesh path
    (``tests/test_mesh_kernels.py``); every epoch's losses within 2e-2
    relative (bf16 residual products on the JAX side only)."""
    g, x, target, tr, te, C = _mesh_data(seed=7)
    cfg = dict(n_hidden=16, max_epoch=8, early_stopping=100, dropout=0.0, seed=3)
    jt = jptrainer.ShardedTrainer(
        g, x, target, tr, te, C, config=JTrainConfig(epoch_block=1, **cfg), n_shards=4,
        partition="allgather", kernel="hybrid",
    )
    jt.fit(verbose=False)
    e = g.n_edges
    data = launch.HostData(
        np.asarray(g.row)[:e], np.asarray(g.col)[:e], np.asarray(g.val)[:e], g.n_nodes,
        np.asarray(x, np.float32), target, tr, te, C,
    )
    (run,) = launch.run_sharded_seeds(
        data, [3], ttrainer.TrainConfig(**cfg), 4, backend="gloo", devices=["cpu"] * 4,
        params_np=_jax_init(3, x.shape[1], 16, C), timeout_s=TIMEOUT_S,
    )["runs"]
    hist = run["history"]
    assert len(hist) == len(jt.history) == 8
    assert abs(hist[0]["train_loss"] - jt.history[0]["train_loss"]) < 5e-3
    for a, b in zip(hist, jt.history):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=2e-2)
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=2e-2)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert abs(run["test"]["acc"] - jt.test()["acc"]) < 0.1


def test_sharded_trainer_matches_the_single_device_trainer(tmp_path):
    """``run_experiment(n_shards=4)`` on gloo CPU ranks against the port's
    single-device ``Trainer`` on ``--spmm hybrid``, same seed, dropout 0.5,
    10 epochs, identity features. The init and the dropout masks are drawn
    for all nodes from the same generator, so only the order of float sums
    differs (per-rank partial sums of the loss and of the replicated
    gradients, all-reduced): per-epoch losses within 1e-4 relative. The
    report carries the ``sharding`` key."""
    pt, _ = _prepared()
    cfg = ttrainer.TrainConfig(n_hidden=16, max_epoch=10, early_stopping=100, spmm="hybrid")
    summary = run_experiment(
        "toy", graph_family="docword", config=cfg, seeds=[7], pre_data=pt, verbose=False,
        n_shards=4, partition="allgather", output_dir=str(tmp_path), device="cpu",
    )
    assert summary["sharding"] == {"n_shards": 4, "partition": "allgather", "kernel": "hybrid"}
    ph = tprepare.apply_spmm_format(pt, "hybrid")
    single = ttrainer.Trainer(
        ph.graph, None, ph.labels.target, ph.labels.train_idx, ph.labels.test_idx,
        N_CLASSES, config=dataclasses.replace(cfg, seed=7), device=CPU,
    )
    single.fit(verbose=False)
    run = summary["runs"][0]
    assert len(run["history"]) == len(single.history) == 10
    for a, b in zip(run["history"], single.history):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        assert a["acc"] == pytest.approx(b["acc"])
    test = single.test()
    for k in ("test_loss", "acc", "macro_f1"):
        np.testing.assert_allclose(run["test"][k], test[k], rtol=1e-4, err_msg=k)
    assert run["test"]["model_param"] == test["model_param"]
    assert summary["runs"][0]["history"][-1]["train_loss"] < run["history"][0]["train_loss"]


def test_sharded_segment_kernel_trains_like_the_hybrid():
    """``kernel="segment"`` (plain PyTorch per rank, true-transpose
    backward) on 2 gloo ranks against the single-device segment trainer,
    dropout 0.5: the same numbers up to the order of f32 sums (1e-4)."""
    pt, _ = _prepared(seed=2)
    cfg = ttrainer.TrainConfig(n_hidden=8, max_epoch=6, early_stopping=100)
    (run,) = launch.run_sharded_seeds(
        launch.HostData.from_prepared(pt), [5], cfg, 2, kernel="segment",
        backend="gloo", devices=["cpu"] * 2, timeout_s=TIMEOUT_S,
    )["runs"]
    single = ttrainer.Trainer(
        pt.graph, None, pt.labels.target, pt.labels.train_idx, pt.labels.test_idx,
        N_CLASSES, config=dataclasses.replace(cfg, seed=5), device=CPU,
    )
    single.fit(verbose=False)
    for a, b in zip(run["history"], single.history):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)


def test_spawn_ranks_raises_when_a_rank_fails():
    """A rank that raises fails the run instead of hanging it: rank 0 leaves
    the collective it waits in (peer gone, or the time limit) and the
    launcher ends every child."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError):
        launch.spawn_ranks(
            torch_sharded_ranks.fail_on_rank_1, 2, (), backend="gloo",
            devices=["cpu"] * 2, timeout_s=10.0,
        )
    assert time.monotonic() - t0 < 60


def test_metrics_from_confusion_equals_jax_and_the_logit_metrics():
    rng = np.random.RandomState(0)
    logits = torch.from_numpy(rng.randn(300, 6).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 6, 300))
    y[y == 5] = 4  # an empty class
    w = torch.from_numpy((rng.rand(300) < 0.6).astype(np.float32))
    conf = ptrainer.confusion(logits, y, w, 6).numpy()
    got = ptrainer.metrics_from_confusion(conf)
    assert got == pytest.approx(jptrainer.metrics_from_confusion(conf))
    sel = w.bool()
    f1, p, r = tmetrics.macro_f1(logits[sel], y[sel], 6)
    want = {"acc": tmetrics.accuracy(logits[sel], y[sel]), "macro_f1": f1, "precision": p, "recall": r}
    assert got == pytest.approx({k: float(v) for k, v in want.items()}, rel=1e-6)


def test_distributed_config_from_env():
    env = {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "2"}
    assert distributed.DistributedConfig.from_env(env) == distributed.DistributedConfig(
        "tcp://10.0.0.1:29500", 4, 2
    )
    for env in (
        {"OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "3"},
        {"SLURM_NTASKS": "2", "SLURM_PROCID": "1"},
        {},
    ):
        got, want = distributed.DistributedConfig.from_env(env), jdistributed.DistributedConfig.from_env(env)
        assert (got.world_size, got.rank) == (want.num_processes, want.process_id)
    with pytest.raises(ValueError, match="incomplete"):
        distributed.init_process_group(distributed.DistributedConfig(), "gloo")


def test_cli_refuses_unported_sharding_and_too_few_gpus(monkeypatch):
    """``train --shards`` refuses, before the GPU check, what the JAX
    package's gates refuse, with ValueError: GAT on ``hybrid`` (the tile leg
    has no attention form), GAT's attention kernels on the halo partition,
    ``sgc_pre`` (its precompute removes the graph from training), ``--spmm
    bsr`` or ``dense`` (they do not partition) and ``hybrid`` on ``halo``.
    What passes the gates, every family on the JAX defaults (halo, ``--spmm
    auto`` = segment) among them, needs N GPUs."""
    base = ["train", "--dataset", "R8", "--graph", "docword", "--shards", "4"]
    for flags, match in (
        (["--partition", "allgather", "--spmm", "hybrid", "--model", "gat"], "no attention form"),
        (["--partition", "halo", "--spmm", "onehot", "--model", "gat"],
         "needs the allgather partition"),
        (["--model", "sgc_pre"], "sgc_pre's precompute"),
        (["--spmm", "bsr"], "don't partition"),
        (["--partition", "allgather", "--spmm", "dense"], "don't partition"),
        (["--partition", "halo", "--spmm", "hybrid"], "allgather partition"),
    ):
        with pytest.raises(ValueError, match=match):
            cli.main(base + flags)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for flags in (
        [],
        ["--model", "sage"],
        ["--model", "gat"],
        ["--partition", "allgather", "--spmm", "onehot", "--model", "gat"],
        ["--partition", "allgather", "--spmm", "hybrid"],
        ["--partition", "halo", "--spmm", "onehot"],
        ["--partition", "allgather", "--spmm", "segment"],
    ):
        with pytest.raises(RuntimeError, match="needs 4 CUDA devices"):
            cli.main(base + flags)
