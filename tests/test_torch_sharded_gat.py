"""Sharded GAT of the PyTorch port (``parallel/sharded.py``
``sharded_gat_forward``, ``parallel/mesh_attention.py``) against the JAX
package's, on the CPU.

JAX runs ``sharded_gat_forward`` on 4 of the 8 virtual CPU devices that
``tests/conftest.py`` sets up, the kernel layout through
``mesh_gat_attention`` with the Pallas kernels in interpret mode. The port
runs 4 gloo ranks through its launcher (each spawned rank runs a function
of ``tests/torch_sharded_ranks.py``, which does not import JAX); its kernel
wrappers run their plain PyTorch versions on CPU tensors. Both sides start
from the same parameters, drawn by JAX's ``gat_init``. One spawn feeds the
pass tests (a module fixture) and one the trainer tests.

Tolerances. On the two segment layouts both sides compute in f32, sums in
another order: rtol 1e-4, atol 1e-5 of the largest entry. On the kernel
layout JAX rounds the aggregation weights and each product to bf16, the
port only the features: 2e-2 of the largest entry, the JAX package's bf16
tolerance (as ``tests/test_torch_gat.py`` holds the single-card kernel
layout); the port is also held against its own single-card kernel layout,
which rounds the same inputs alike: rtol 1e-3, atol 1e-4 of the largest
entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models.gat import gat_init as j_gat_init
from textgcn_tpu.parallel import halo as jhalo
from textgcn_tpu.parallel import mesh_attention as jmesh_attention
from textgcn_tpu.parallel import sharded as jsharded
from textgcn_tpu.parallel.partition import pad_features as j_pad_features
from textgcn_tpu.parallel.partition import partition_rows as j_partition_rows
from textgcn_tpu.parallel.sharded import make_mesh

import torch_sharded_ranks
from test_torch_train import N_CLASSES, _prepared

from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.models.gat import gat_forward
from textgcn_tpu_torch.ops.attention import AttentionGraph, gat_attention
from textgcn_tpu_torch.parallel import launch
from textgcn_tpu_torch.parallel import trainer as ptrainer
from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
WORLD = 4
F, H, C = 12, 16, 4
LAYOUTS = (("segment", "allgather"), ("segment", "halo"), ("attention", "allgather"))
F32_RTOL, F32_ATOL = 1e-4, 1e-5
BF16_TOL = 2e-2
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
# every collective of a spawned test raises after this long, so a rank
# that dies cannot hang the suite
TIMEOUT_S = 60.0


def _gloo(fn, world, args):
    return launch.spawn_ranks(
        fn, world, args, backend="gloo", devices=["cpu"] * world, timeout_s=TIMEOUT_S
    )


def _graph(n=600, seed=0):
    """Sym-normalized, coalesced, self-loops: power-law rows and columns
    (hub rows and columns on rank 0), so the ranks' graphs differ in size."""
    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1) ** -0.8
    p /= p.sum()
    e = 5000
    r, c, v = max_symmetrize_coo(rng.choice(n, e, p=p), rng.randint(0, n, e), rng.rand(e) + 0.1, n)
    r, c, v = sym_normalize_coo(r, c, v, n)
    return r, c, v, n


def _jax_params(n_feat, seed=3):
    tree = j_gat_init(jax.random.PRNGKey(seed), n_feat, H, C)
    return {f"{layer}.{leaf}": np.asarray(a, np.float32)
            for layer, leaves in tree.items() for leaf, a in leaves.items()}


def _close(got, want, rtol, atol_rel, what):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(1.0, float(np.abs(want).max())), err_msg=what
    )


def test_rank_attention_graphs_hold_the_jax_plans_edges():
    """Each rank's rectangular ``AttentionGraph`` (local rows, global
    columns) holds the edges of JAX ``MeshAttentionAllGather``'s forward
    plan of that shard, and its transpose CSR those of the backward plan
    (global rows, local columns), padding removed; log(val) is the log of
    JAX's f32 plan values. The geometry is JAX's."""
    r, c, v, n = _graph()
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    jm = jmesh_attention.MeshAttentionAllGather.from_graph(jg, WORLD, w=8, k=128)

    def plan_edges(col, val, lrow, wloc, p):
        lr = np.asarray(lrow[p])
        rows = (np.asarray(wloc[p])[:, None] * jm.w + lr).reshape(-1)
        real = lr.reshape(-1) < jm.w
        cc, vv = np.asarray(col[p])[real], np.asarray(val[p])[real]
        o = np.lexsort((cc, rows[real]))
        return rows[real][o], cc[o], vv[o]

    for p in range(WORLD):
        mg = MeshAttentionAllGather.from_coo(r, c, v, n, WORLD, p, device=CPU)
        ag = mg.ag
        assert (mg.rows_per_shard, mg.n_pad) == (jm.rows_per_shard, jm.n_pad)
        assert (ag.n_nodes, ag.n_cols) == (jm.rows_per_shard, jm.n_pad)
        jr, jc, jv = plan_edges(jm.fwd_col, jm.fwd_val, jm.fwd_lrow, jm.fwd_wloc, p)
        np.testing.assert_array_equal(ag.row.numpy(), jr)
        np.testing.assert_array_equal(ag.col.numpy(), jc)
        np.testing.assert_allclose(ag.logval.numpy(), np.log(jv), rtol=1e-6)
        # the transpose CSR: rows are global columns, its cols the local rows
        t_rows = np.repeat(np.arange(ag.n_cols), np.diff(ag.row_ptr_t.numpy()))
        jr, jc, _ = plan_edges(jm.bwd_col, jm.bwd_val, jm.bwd_lrow, jm.bwd_wloc, p)
        np.testing.assert_array_equal(t_rows, jr)
        np.testing.assert_array_equal(ag.col_t.numpy(), jc)


def test_kernel_layout_shards_put_together_equal_the_single_card_op():
    """``gat_attention`` on every rank's rectangular graph (its rows of es,
    all of ed and of the features), stacked over the ranks, equals
    ``gat_attention`` on the whole graph's ``AttentionGraph`` bit for bit:
    a row's edges stay on one rank in the same order."""
    r, c, v, n = _graph(seed=5)
    rng = np.random.RandomState(6)
    whole = AttentionGraph.from_coo(r, c, v, n, device=CPU)
    mgs = [MeshAttentionAllGather.from_coo(r, c, v, n, WORLD, p, device=CPU) for p in range(WORLD)]
    n_pad, rps = mgs[0].n_pad, mgs[0].rows_per_shard
    h = torch.zeros((n_pad, 20))
    h[:n] = torch.from_numpy(rng.randn(n, 20).astype(np.float32))
    es, ed = h @ torch.randn(20), h @ torch.randn(20)
    want = gat_attention(whole, es[:n], ed[:n], h[:n])
    got = torch.cat([gat_attention(m.ag, es[p * rps:(p + 1) * rps], ed, h)
                     for p, m in enumerate(mgs)])
    assert torch.equal(got[:n], want) and not got[n:].any()


@pytest.fixture(scope="module")
def passes():
    """GAT on its three layouts, with identity features and with features,
    forward and the gradients of a masked loss, on 4 gloo ranks (one
    spawn)."""
    coo = _graph()
    n = coo[3]
    rng = np.random.RandomState(1)
    x = rng.randn(n, F).astype(np.float32)
    w = (rng.randn(n, C) * (rng.rand(n, 1) < 0.5)).astype(np.float32)
    inputs = {True: (_jax_params(n), None, w), False: (_jax_params(F), x, w)}
    cases = [((identity, kernel, partition), "gat", kernel, partition, *inputs[identity])
             for identity in inputs for kernel, partition in LAYOUTS]
    return coo, inputs, _gloo(torch_sharded_ranks.family_fwd_bwd, WORLD, (coo, cases))


def _jax_fwd_bwd(kernel, partition, coo, params, x, w):
    """JAX ``sharded_gat_forward`` on 4 devices: the logits [n, C] and the
    gradients of ``sum(logits * w)``, the node table cut to n rows."""
    r, c, v, n = coo
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    if kernel == "attention":
        pg = jmesh_attention.MeshAttentionAllGather.from_graph(jg, WORLD, w=8, k=128)
    else:
        pg = (j_partition_rows if partition == "allgather" else jhalo.partition_rows_halo)(jg, WORLD)
    mesh = make_mesh(WORLD)
    tree = {}
    for key, a in params.items():
        layer, leaf = key.split(".")
        table = x is None and key == "gat1.w"
        tree.setdefault(layer, {})[leaf] = jnp.asarray(j_pad_features(a, pg.n_pad) if table else a)
    xs = None if x is None else jax.device_put(
        j_pad_features(x, pg.n_pad), NamedSharding(mesh, P("nodes", None)))
    wp = jnp.asarray(j_pad_features(w, pg.n_pad))

    def loss(p, g):
        logits = jsharded.sharded_gat_forward(p, g, xs, mesh)
        return jnp.sum(logits * wp), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree, pg)
    flat = {f"{layer}.{leaf}": np.asarray(a) for layer, leaves in grads.items()
            for leaf, a in leaves.items()}
    if x is None:
        flat["gat1.w"] = flat["gat1.w"][:n]
    return np.asarray(logits)[:n], flat


@pytest.mark.parametrize("identity", [True, False], ids=["identity", "features"])
@pytest.mark.parametrize("kernel,partition", LAYOUTS)
def test_sharded_gat_matches_jax(passes, identity, kernel, partition):
    """``sharded_gat_forward`` on 4 ranks against JAX's on the same layout
    (the all-gather segment softmax, the halo ring's online softmax, the
    attention kernels on each rank's plan), from the same parameters: the
    logits and the gradient of every parameter, ``a_src``, ``a_dst`` and
    the layer-1 table (rows gathered) included. f32 layouts at rtol 1e-4,
    atol 1e-5 of the largest entry; the kernel layout at 2e-2."""
    coo, inputs, out = passes
    logits, grads = out[identity, kernel, partition]
    want_logits, want_grads = _jax_fwd_bwd(kernel, partition, coo, *inputs[identity])
    rtol, atol = (BF16_TOL, BF16_TOL) if kernel == "attention" else (F32_RTOL, F32_ATOL)
    _close(logits, want_logits, rtol, atol, "logits")
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        _close(g, want_grads[k], rtol, atol, k)


@pytest.mark.parametrize("identity", [True, False], ids=["identity", "features"])
def test_kernel_layout_matches_the_single_card_kernel_layout(passes, identity):
    """The kernel layout on 4 ranks against the port's single-card GAT on
    the whole graph's ``AttentionGraph`` (the same kernels' plain versions,
    the same bf16 features): logits and every gradient within rtol 1e-3,
    atol 1e-4 of the largest entry. The backward sums each rank's dx and
    ded onto their owners (the all-gather's transpose): without that sum the
    layer-1 gradients would miss the other ranks' parts."""
    coo, inputs, out = passes
    r, c, v, n = coo
    params, x, w = inputs[identity]
    p = {k: torch.tensor(a, requires_grad=True) for k, a in params.items()}
    ag = AttentionGraph.from_coo(r, c, v, n, device=CPU)
    want = gat_forward(p, ag, None if x is None else torch.tensor(x))
    (want * torch.tensor(w)).sum().backward()
    logits, grads = out[identity, "attention", "allgather"]
    _close(logits, want.detach().numpy(), KERNEL_RTOL, KERNEL_ATOL, "logits")
    for k, t in p.items():
        _close(grads[k], t.grad.numpy(), KERNEL_RTOL, KERNEL_ATOL, k)


@pytest.mark.parametrize("identity", [True, False], ids=["identity", "features"])
def test_halo_online_softmax_matches_the_allgather_softmax(passes, identity):
    """The online softmax over the ring (a bucket a step, the running max
    rescaling ``l`` and ``acc``) against the all-gather layout's segment
    softmax of each row at once: logits and every gradient within 1e-5 of
    the largest entry."""
    _, _, out = passes
    a, b = out[identity, "segment", "halo"], out[identity, "segment", "allgather"]
    _close(a[0], b[0], 0.0, 1e-5, "logits")
    for k in a[1]:
        _close(a[1][k], b[1][k], 0.0, 1e-5, k)


TRAIN_LAYOUTS = (("segment", "halo"), ("segment", "allgather"), ("onehot", "allgather"))


@pytest.fixture(scope="module")
def trained():
    """3 gloo ranks train GAT on the toy doc-word graph (identity features)
    on each of its layouts (one spawn), dropout 0.5, 4 epochs."""
    pt, _ = _prepared(seed=8)
    cfg = ttrainer.TrainConfig(n_hidden=16, max_epoch=4, early_stopping=100, seed=21,
                               model="gat")
    combos = [("gat", k, p) for k, p in TRAIN_LAYOUTS]
    runs = _gloo(torch_sharded_ranks.train_combos, 3,
                 (launch.HostData.from_prepared(pt), cfg, combos))
    return pt, cfg, dict(zip(TRAIN_LAYOUTS, runs))


@pytest.mark.parametrize("kernel,partition", TRAIN_LAYOUTS)
def test_sharded_gat_trainer_follows_the_single_card_trainer(trained, kernel, partition):
    """``ShardedTrainer(model="gat")`` on 3 ranks against the port's
    single-card GAT ``Trainer`` on the segment layout (``SparseGraph``) or
    the kernel layout (``AttentionGraph`` in the node order), same seed,
    dropout 0.5: per-epoch losses within 1e-4 relative (sums in another
    order), equal accuracies, the single-card parameter count."""
    pt, cfg, runs = trained
    hist, test = runs[kernel, partition]
    pre = pt if kernel == "segment" else tprepare.apply_attention_format(pt, degree_sort=False)
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
    assert test["model_param"] == want["model_param"]


def test_sharded_trainer_builds_gat_layouts_and_refuses_jax_s_gates():
    """GAT's layouts: ``ShardCOO`` on segment/allgather, the halo buckets on
    segment/halo, ``MeshAttentionAllGather`` on onehot/allgather; JAX's
    gates: GAT on hybrid, GAT's kernels on halo and ``sgc_pre`` raise
    ValueError."""
    from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph
    from textgcn_tpu_torch.parallel.partition import ShardCOO

    pt, _ = _prepared(seed=9)
    lab = pt.labels

    def build(model, kernel, partition):
        return ptrainer.ShardedTrainer(
            pt.graph, None, lab.target, lab.train_idx, lab.test_idx, N_CLASSES,
            config=ttrainer.TrainConfig(model=model), n_shards=2, rank=1, device=CPU,
            kernel=kernel, partition=partition,
        )

    for (kernel, partition), cls in {
        ("segment", "allgather"): ShardCOO, ("segment", "halo"): HaloPartitionedGraph,
        ("onehot", "allgather"): MeshAttentionAllGather,
    }.items():
        t = build("gat", kernel, partition)
        assert type(t.graph) is cls and t.graph.shard == 1
    for args, match in (
        (("gat", "hybrid", "allgather"), "no attention form"),
        (("gat", "onehot", "halo"), "needs the allgather partition"),
        (("sgc_pre", "segment", "halo"), "sgc_pre's precompute"),
    ):
        with pytest.raises(ValueError, match=match):
            build(*args)
    with pytest.raises(ValueError, match="no attention form"):
        ptrainer.check_sharded("gat", "hybrid", "allgather")
