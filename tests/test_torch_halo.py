"""The halo partition and the one-hot mesh layouts of the PyTorch port
(``textgcn_tpu_torch/parallel/halo.py``, ``parallel/mesh_kernels.py``)
against the JAX package's, on the CPU.

JAX runs its mesh functions on 4 of the 8 virtual CPU devices that
``tests/conftest.py`` sets up, with the Pallas kernels in interpret mode.
The port runs 4 gloo ranks through its launcher (rank 0 in this process,
the others spawned, each running a function of
``tests/torch_sharded_ranks.py``, which does not import JAX); its kernel
wrappers run their plain PyTorch versions on CPU tensors. One spawn feeds
the pass tests (a module fixture) and one the trainer tests, so the file
spawns twice.

The graphs have a hub row longer than K2's S whose edges to rank 0's
columns alone exceed S, so the all-gather CSR and a halo bucket both carry
split tables.
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from textgcn_tpu.graph.normalize import sym_normalize_coo as j_sym_normalize
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.parallel import halo as jhalo
from textgcn_tpu.parallel import mesh_kernels as jmesh
from textgcn_tpu.parallel.sharded import make_mesh

import torch_sharded_ranks
from test_torch_train import N_CLASSES, _prepared

from textgcn_tpu_torch.graph.reorder import CSRGraph, csr_pass
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.ops.row_reduce import row_reduce
from textgcn_tpu_torch.parallel import launch
from textgcn_tpu_torch.parallel.halo import partition_rows_halo
from textgcn_tpu_torch.parallel.mesh_kernels import (
    MeshOneHotAllGather, MeshOneHotHalo, shard_onehot_pass,
)
from textgcn_tpu_torch.parallel.partition import ShardCOO
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
WORLD = 4
F = 12
# every collective of a spawned test raises after this long, so a rank
# that dies cannot hang the suite
TIMEOUT_S = 60.0


def _gloo(fn, world, args):
    return launch.spawn_ranks(
        fn, world, args, backend="gloo", devices=["cpu"] * world, timeout_s=TIMEOUT_S
    )


def _sym_graph(n=2400, seed=0):
    """A sym-normalized graph of n = 2,400 nodes (600 rows a rank at P = 4):
    random edges, and hub node 0 tied to nodes 0..599 and 300 others, so
    row 0 has ~900 edges and 600 of them in bucket (0, 0)."""
    rng = np.random.RandomState(seed)
    a, b = rng.randint(0, n, 6000), rng.randint(0, n, 6000)
    hub = np.r_[np.arange(600), rng.randint(600, n, 300)]
    a, b = np.r_[a, np.zeros(len(hub), np.int64)], np.r_[b, hub]
    r, c, v = j_sym_normalize(np.r_[a, b], np.r_[b, a], np.ones(2 * len(a)), n)
    return r, c, v, n


def _nonsym_graph(n=2400, seed=1):
    """A directed graph with the same hub row (no hub column), row-normalized
    (a random walk: not symmetric)."""
    rng = np.random.RandomState(seed)
    r = np.r_[rng.randint(0, n, 8000), np.zeros(900, np.int64)]
    c = np.r_[rng.randint(0, n, 8000), np.arange(600), rng.randint(600, n, 300)]
    key = np.unique(r * n + c)
    r, c = key // n, key % n
    deg = np.bincount(r, minlength=n)
    v = rng.rand(len(r)) / deg[r]
    return r, c, v, n


def _padded(n_pad, n, rng):
    a = np.zeros((n_pad, F), np.float32)
    a[:n] = rng.randn(n, F)
    return a


@pytest.fixture(scope="module")
def passes():
    """The port's passes on 4 gloo ranks (one spawn) and the inputs."""
    sym, nonsym = _sym_graph(), _nonsym_graph()
    n_pad = partition_rows_halo(SparseGraph.from_coo(*sym, device=CPU), WORLD)[0].n_pad
    rng = np.random.RandomState(2)
    x, w = _padded(n_pad, sym[3], rng), _padded(n_pad, sym[3], rng)
    out = _gloo(torch_sharded_ranks.halo_and_onehot_passes, WORLD, (sym, nonsym, x, w))
    return sym, nonsym, x, w, out


def _jax_fwd_bwd(fn, x, w):
    """``fn(xs)`` and ``d/dx sum(fn(xs) * w)`` with ``x`` row-sharded over a
    4-device mesh."""
    mesh = make_mesh(WORLD)
    xs = jax.device_put(x, NamedSharding(mesh, P("nodes", None)))
    y = np.asarray(fn(xs, mesh))
    dx = np.asarray(jax.jit(jax.grad(lambda a: jnp.sum(fn(a, mesh) * w)))(xs))
    return y, dx


def _matrix(graph, n_pad):
    r, c, v, _ = graph
    return sp.coo_matrix((v, (r, c)), shape=(n_pad, n_pad)).tocsr()


def _jax_buckets(hg, p, q):
    """(local row, local col, val) of JAX's bucket (p, q), padding dropped
    (phantom slots carry row = rps)."""
    real = np.asarray(hg.row[p, q]) < hg.rows_per_shard
    return tuple(np.asarray(a[p, q])[real] for a in (hg.row, hg.col, hg.val))


def _csr_edges(c):
    """(row, col, val) of a ResidualCSR in CSR order."""
    rows = np.repeat(np.arange(c.row_ptr.numel() - 1), np.diff(c.row_ptr.numpy()))
    return rows, c.col.numpy(), c.val.numpy()


def _jax_plan_edges(plan_mesh, p, q=None):
    """Sorted (row, col) pairs and their values of a JAX one-hot mesh plan
    (shard p, or bucket (p, q)), phantom slots dropped."""
    sel = (p,) if q is None else (p, q)
    lrow = np.asarray(plan_mesh.lrow[sel])
    rows = (np.asarray(plan_mesh.wloc[sel])[:, None] * plan_mesh.w + lrow).reshape(-1)
    real = lrow.reshape(-1) < plan_mesh.w
    col, val = np.asarray(plan_mesh.col[sel])[real], np.asarray(plan_mesh.val[sel])[real]
    order = np.lexsort((col, rows[real]))
    return rows[real][order], col[order], val[order]


def test_partition_rows_halo_and_the_onehot_layouts_equal_jax():
    """Each rank's bucket (p, q) equals JAX ``partition_rows_halo``'s with
    its padding removed, edge for edge and in order (local rows and
    columns, values); ``MeshOneHotHalo``'s bucket CSRs and
    ``MeshOneHotAllGather``'s CSR hold the edges of JAX's one-hot plans of
    the same bucket or shard (values to f32: JAX's plans keep f32); the
    geometry is JAX's. The hub's bucket (0, 0) and rank 0's all-gather CSR
    carry split tables; the halo buckets' tables are tied to their own CSR
    (another bucket's is refused)."""
    r, c, v, n = _sym_graph()
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    jhg = jhalo.partition_rows_halo(jg, WORLD)
    joh = jmesh.MeshOneHotHalo.from_graph(jg, WORLD)
    jag = jmesh.MeshOneHotAllGather.from_graph(jg, WORLD)
    tg = SparseGraph.from_coo(r, c, v, n, device=CPU)
    for p, hg in enumerate(partition_rows_halo(tg, WORLD)):
        assert (hg.rows_per_shard, hg.n_pad) == (jhg.rows_per_shard, jhg.n_pad)
        assert (hg.rows_per_shard, hg.n_pad) == (joh.rows_per_shard, joh.n_pad)
        mh = MeshOneHotHalo.from_coo(r, c, v, n, WORLD, p, device=CPU)
        for q in range(WORLD):
            want = _jax_buckets(jhg, p, q)
            np.testing.assert_array_equal(hg.row[q].numpy(), want[0])
            np.testing.assert_array_equal(hg.col[q].numpy(), want[1])
            np.testing.assert_array_equal(hg.val[q].numpy(), want[2])
            jr, jc, jv = _jax_plan_edges(joh, p, q)
            tr, tc, tv = _csr_edges(mh.buckets[q])
            np.testing.assert_array_equal(tr, jr)
            np.testing.assert_array_equal(tc, jc)
            np.testing.assert_allclose(tv, jv, rtol=1e-7)
        ma = MeshOneHotAllGather.from_coo(r, c, v, n, WORLD, p, device=CPU)
        assert ma.rows_per_shard == jag.rows_per_shard and ma.n_pad == jag.n_pad
        jr, jc, jv = _jax_plan_edges(jag, p)
        tr, tc, tv = _csr_edges(ma.csr)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_allclose(tv, jv, rtol=1e-7)
        if p == 0:
            assert ma.csr.split is not None and mh.buckets[0].split is not None
            b0, b1 = mh.buckets[0], mh.buckets[1]
            x = torch.zeros((hg.rows_per_shard, 16), dtype=torch.bfloat16)
            with pytest.raises(ValueError, match="split table"):
                row_reduce(b1.row_ptr, b1.col, b1.val, x, split=b0.split)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_allgather_onehot_shards_put_together_equal_the_single_device_onehot(n_shards):
    """Every rank's ``shard_onehot_pass`` on the gathered table, stacked,
    gives the single-device ``--spmm onehot`` pass (``CSRGraph``) bit for
    bit: each row's edges stay on one rank, in the same order, and its
    segments depend only on its length."""
    r, c, v, n = _sym_graph(seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(n, 20).astype(np.float32))
    want = csr_pass(CSRGraph.from_coo(r, c, v, n, symmetric=True, device=CPU), x)
    outs = []
    for p in range(n_shards):
        mg = MeshOneHotAllGather.from_coo(r, c, v, n, n_shards, p, device=CPU)
        x_full = torch.zeros((mg.n_pad, 20))
        x_full[:n] = x
        outs.append(shard_onehot_pass(mg, x_full))
    got = torch.cat(outs)
    assert torch.equal(got[:n], want) and not got[n:].any()


def test_spmm_halo_matches_jax(passes):
    """The segment ring on 4 gloo ranks (``spmm_halo`` through
    ``sharded_spmm``) against JAX ``spmm_halo`` on 4 devices, forward and
    the gradient (JAX's autodiff through ``ppermute`` and ``segment_sum``;
    the port's reverse ring): f32 on both sides, the same buckets added in
    the same ring order, sums within a bucket in another order: rtol 1e-5,
    atol 1e-6. Both equal scipy's f64 ``A x`` and ``Aᵀ w`` to 1e-5."""
    sym, _, x, w, out = passes
    jhg = jhalo.partition_rows_halo(JSparseGraph.from_coo(*sym, pad_to_multiple=256), WORLD)
    y_j, dx_j = _jax_fwd_bwd(lambda a, mesh: jhalo.spmm_halo(jhg, a, mesh), x, w)
    y, dx = out["halo"]
    np.testing.assert_allclose(y, y_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, dx_j, rtol=1e-5, atol=1e-6)
    a = _matrix(sym, jhg.n_pad)
    np.testing.assert_allclose(y, a @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, a.T @ w, rtol=1e-5, atol=1e-5)


def test_halo_segment_backward_is_the_true_transpose_on_a_nonsymmetric_matrix(passes):
    """On a row-normalized directed graph (Aᵀ ≠ A) the segment ring's
    gradient is ``Aᵀ w``, as ``jax.vjp`` of JAX ``spmm_halo`` gives it:
    rtol 1e-5, atol 1e-6 (f32 sums in another order), and scipy's f64 to
    1e-5; it differs from ``A w`` (the symmetric shortcut would be
    wrong)."""
    _, nonsym, x, w, out = passes
    jhg = jhalo.partition_rows_halo(JSparseGraph.from_coo(*nonsym, pad_to_multiple=256), WORLD)
    mesh = make_mesh(WORLD)
    xs = jax.device_put(x, NamedSharding(mesh, P("nodes", None)))
    y_j, vjp = jax.vjp(lambda a: jhalo.spmm_halo(jhg, a, mesh), xs)
    (dx_j,) = vjp(jnp.asarray(w))
    y, dx = out["halo_nonsym"]
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-5, atol=1e-6)
    a = _matrix(nonsym, jhg.n_pad)
    np.testing.assert_allclose(dx, a.T @ w, rtol=1e-5, atol=1e-5)
    assert np.abs(a.T @ w - a @ w).max() > 0.1


def _onehot_checks(layout_j, name, passes):
    """A one-hot layout's forward and (symmetric) backward on the ranks
    against JAX ``spmm_mesh_onehot`` in interpret mode and against an f64
    sum over the bf16-rounded features (or cotangent)."""
    sym, _, x, w, out = passes
    y_j, dx_j = _jax_fwd_bwd(
        lambda a, mesh: jmesh.spmm_mesh_onehot(layout_j, a, mesh, True), x, w
    )
    a = abs(_matrix(sym, layout_j.n_pad))
    for got, want_j, feats in ((out[name][0], y_j, x), (out[name][1], dx_j, w)):
        f16 = torch.from_numpy(feats).bfloat16().double().numpy()
        want, mag = a @ f16, a @ np.abs(f16)
        # the port: f32 val times bf16 features, f32 sums (K2's plain
        # version): 1e-5 of the terms' magnitudes
        assert np.all(np.abs(got - want) <= 1e-5 * (1 + mag))
        # JAX also rounds each product to bf16: 2e-2 of the same, the JAX
        # package's bf16 tolerance
        assert np.all(np.abs(got - want_j) <= 2e-2 * (1 + mag))


def test_spmm_mesh_onehot_allgather_matches_jax(passes):
    """``MeshOneHotAllGather`` (K2 from zero after the all-gather) on 4
    ranks against JAX's layout of the same name, forward and backward
    (both the symmetric shortcut)."""
    jg = JSparseGraph.from_coo(*passes[0], pad_to_multiple=256)
    _onehot_checks(jmesh.MeshOneHotAllGather.from_graph(jg, WORLD), "onehot_allgather", passes)


def test_spmm_mesh_onehot_halo_matches_jax(passes):
    """``MeshOneHotHalo`` (K2 onto the accumulator at each ring step) on 4
    ranks against JAX's layout of the same name, forward and backward."""
    jg = JSparseGraph.from_coo(*passes[0], pad_to_multiple=256)
    _onehot_checks(jmesh.MeshOneHotHalo.from_graph(jg, WORLD), "onehot_halo", passes)


def test_onehot_layouts_refuse_a_nonsymmetric_backward(passes):
    """A one-hot layout built ``symmetric=False`` runs its forward and
    refuses its backward (the same pass on the cotangent would be Â g, not
    Âᵀ g), as JAX's ``_mesh_onehot_bwd`` does."""
    refused = passes[4]["refused"]
    assert len(refused) == 2
    assert all("needs a symmetric adjacency" in msg for msg in refused), refused


@pytest.fixture(scope="module")
def trained():
    """3 gloo ranks train the toy doc-word graph under halo-segment,
    halo-onehot and allgather-onehot (one spawn), dropout 0.5, 8 epochs."""
    pt, _ = _prepared(seed=5)
    cfg = ttrainer.TrainConfig(n_hidden=16, max_epoch=8, early_stopping=100, seed=11)
    combos = [("segment", "halo"), ("onehot", "halo"), ("onehot", "allgather")]
    runs = _gloo(
        torch_sharded_ranks.train_combos, 3,
        (launch.HostData.from_prepared(pt), cfg, [("gcn", *c) for c in combos]),
    )
    return pt, cfg, dict(zip(combos, runs))


@pytest.mark.parametrize("kernel,partition", [
    ("segment", "halo"), ("onehot", "halo"), ("onehot", "allgather"),
])
def test_sharded_trainer_follows_the_single_device_trainer(trained, kernel, partition):
    """``ShardedTrainer(kernel, partition)`` on 3 ranks against the port's
    single-device ``Trainer`` on the same kernel (``--spmm segment``, or the
    ``CSRGraph`` of ``--spmm onehot``), same seed, dropout 0.5: the init and
    the dropout masks are drawn for all nodes from one generator, so only
    the order of f32 sums differs (per-rank partial sums of the loss and of
    the replicated gradients; the ring's buckets added one at a time):
    per-epoch losses within 1e-4 relative, equal accuracies."""
    pt, cfg, runs = trained
    hist, test = runs[kernel, partition]
    pre = pt if kernel == "segment" else tprepare.apply_spmm_format(pt, "onehot")
    if kernel == "onehot":
        assert isinstance(pre.graph, CSRGraph)
    single = ttrainer.Trainer(
        pre.graph, None, pre.labels.target, pre.labels.train_idx, pre.labels.test_idx,
        N_CLASSES, config=cfg, device=CPU,
    )
    single.fit(verbose=False)
    assert len(hist) == len(single.history) == cfg.max_epoch
    for a, b in zip(hist, single.history):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
        assert a["acc"] == pytest.approx(b["acc"])
    want = single.test()
    for k in ("test_loss", "acc", "macro_f1"):
        np.testing.assert_allclose(test[k], want[k], rtol=1e-4, err_msg=k)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_sharded_trainer_defaults_and_layouts_are_jax_s():
    """The trainer's defaults are the JAX trainer's (halo, segment), and
    each (kernel, partition) builds its layout: the segment ring's buckets,
    ``ShardCOO``, and the two one-hot layouts."""
    import inspect

    from textgcn_tpu.parallel.trainer import ShardedTrainer as JShardedTrainer
    from textgcn_tpu_torch.parallel import trainer as ptrainer
    from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph

    for name in ("partition", "kernel"):
        assert (inspect.signature(ptrainer.ShardedTrainer).parameters[name].default
                == inspect.signature(JShardedTrainer).parameters[name].default)
    pt, _ = _prepared(seed=6)
    lab = pt.labels
    want = {
        ("segment", "halo"): HaloPartitionedGraph, ("segment", "allgather"): ShardCOO,
        ("onehot", "halo"): MeshOneHotHalo, ("onehot", "allgather"): MeshOneHotAllGather,
    }
    for (kernel, partition), cls in want.items():
        t = ptrainer.ShardedTrainer(
            pt.graph, None, lab.target, lab.train_idx, lab.test_idx, N_CLASSES,
            n_shards=2, rank=1, device=CPU, kernel=kernel, partition=partition,
        )
        assert type(t.graph) is cls and t.graph.shard == 1
    with pytest.raises(ValueError, match="allgather partition"):
        ptrainer.ShardedTrainer(
            pt.graph, None, lab.target, lab.train_idx, lab.test_idx, N_CLASSES,
            n_shards=2, rank=0, device=CPU, kernel="hybrid", partition="halo",
        )
