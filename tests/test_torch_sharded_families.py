"""SAGE, SGC, APPNP, GIN and GCNII sharded (``textgcn_tpu_torch/parallel``)
against the JAX package's ``sharded_<family>_forward``, on the CPU.

JAX runs on 4 of the 8 virtual CPU devices that ``tests/conftest.py`` sets
up. The port runs 4 gloo ranks through its launcher (rank 0 in this
process, the others spawned, each running a function of
``tests/torch_sharded_ranks.py``, which does not import JAX); its kernel
wrappers run their plain PyTorch versions on CPU tensors. Both sides start
from the same parameters, drawn by JAX's inits. One spawn feeds the pass
tests (a module fixture) and one the trainer tests.

Tolerances. Under ``segment`` both sides compute in f32 and differ only in
the order of sums (per-rank partial sums, the ring's buckets one at a time,
GCNII's 8 and APPNP's 10 propagations): rtol 1e-4 and atol 1e-5 of the
largest entry. Under ``onehot`` and ``hybrid`` the kernels read bf16
features (K1 also bf16 tiles), which JAX rounds further (each product to
bf16), so these layouts are held against the port's single-device forward
on the same format (``--spmm onehot``'s ``CSRGraph``, ``--spmm hybrid``'s
``HybridGraph``), which rounds the same inputs alike; the test graph is
degree-sorted already, so the hybrid keeps its node order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.parallel import halo as jhalo
from textgcn_tpu.parallel import trainer as jptrainer
from textgcn_tpu.parallel.partition import pad_features as j_pad_features
from textgcn_tpu.parallel.partition import partition_rows as j_partition_rows
from textgcn_tpu.parallel.sharded import make_mesh

import torch_sharded_ranks
from test_torch_train import N_CLASSES, _prepared

from textgcn_tpu_torch.graph.format import convert_graph
from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo
from textgcn_tpu_torch.graph.reorder import degree_sort_permutation
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.parallel import launch
from textgcn_tpu_torch.parallel import trainer as ptrainer
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
WORLD = 4
F, H, C = 12, 16, 4
FAMILIES = ("sage", "sgc", "appnp", "gin", "gcnii")
SEGMENT = (("segment", "allgather"), ("segment", "halo"))
KERNELS = (("onehot", "allgather"), ("onehot", "halo"), ("hybrid", "allgather"))
# f32 on both sides, sums in another order
F32_RTOL, F32_ATOL = 1e-4, 1e-5
# the kernel layouts against the single-device forward on the same format
KERNEL_RTOL, KERNEL_ATOL = 1e-3, 1e-4
# every collective of a spawned test raises after this long, so a rank
# that dies cannot hang the suite
TIMEOUT_S = 60.0


def _gloo(fn, world, args):
    return launch.spawn_ranks(
        fn, world, args, backend="gloo", devices=["cpu"] * world, timeout_s=TIMEOUT_S
    )


def _graph(n=700, seed=0):
    """Sym-normalized, coalesced, degree-sorted: dense pairs among 120 nodes
    (the hybrid layout's tiles) and uniform pairs (its residual)."""
    rng = np.random.RandomState(seed)
    rc = np.vstack([rng.randint(0, 120, (2500, 2)), rng.randint(0, n, (2500, 2))])
    r, c, v = max_symmetrize_coo(rc[:, 0], rc[:, 1], rng.rand(len(rc)) + 0.1, n)
    keep = r != c
    r, c, v = sym_normalize_coo(r[keep], c[keep], v[keep], n)
    perm = degree_sort_permutation(r, c, n)
    return perm[r], perm[c], v, n


def _jax_params(model, n_feat, seed):
    """JAX's init of ``model`` as a flat ``{"layer.leaf": array}`` of f32."""
    init = jptrainer.SHARDED_MODELS[model][0]
    tree = init(jax.random.PRNGKey(seed), n_feat, H, C)
    return {f"{layer}.{leaf}": np.asarray(v, np.float32)
            for layer, leaves in tree.items() for leaf, v in leaves.items()}


def _cases():
    """The inputs: per (family, features) the JAX-drawn parameters, the
    features (None: identity) and the masked loss's weights."""
    coo = _graph()
    n = coo[3]
    rng = np.random.RandomState(1)
    x = rng.randn(n, F).astype(np.float32)
    w = (rng.randn(n, C) * (rng.rand(n, 1) < 0.5)).astype(np.float32)
    inputs = {}
    for i, model in enumerate(FAMILIES):
        for identity in (True, False):
            inputs[model, identity] = (
                _jax_params(model, n if identity else F, 10 + i), None if identity else x, w
            )
    return coo, inputs


@pytest.fixture(scope="module")
def passes():
    """Every family on every layout, with identity features and with
    features, on 4 gloo ranks (one spawn)."""
    coo, inputs = _cases()
    cases = [
        ((model, identity, kernel, partition), model, kernel, partition, *inputs[model, identity])
        for (model, identity) in inputs for kernel, partition in SEGMENT + KERNELS
    ]
    return coo, inputs, _gloo(torch_sharded_ranks.family_fwd_bwd, WORLD, (coo, cases))


def _jax_fwd_bwd(model, partition, coo, params, x, w):
    """JAX ``sharded_<model>_forward`` on 4 devices: the logits [n, C] and
    the gradients of ``sum(logits * w)``, node tables cut to n rows."""
    r, c, v, n = coo
    jg = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=256)
    pg = (j_partition_rows if partition == "allgather" else jhalo.partition_rows_halo)(jg, WORLD)
    mesh = make_mesh(WORLD)
    tables = ptrainer.node_tables(model) if x is None else ()
    tree = {}
    for key, a in params.items():
        layer, leaf = key.split(".")
        tree.setdefault(layer, {})[leaf] = jnp.asarray(
            j_pad_features(a, pg.n_pad) if key in tables else a)
    xs = None if x is None else jax.device_put(
        j_pad_features(x, pg.n_pad), NamedSharding(mesh, P("nodes", None)))
    wp = jnp.asarray(j_pad_features(w, pg.n_pad))
    fwd = jptrainer.SHARDED_MODELS[model][1]

    def loss(p, g):
        logits = fwd(p, g, xs, mesh)
        return jnp.sum(logits * wp), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(tree, pg)
    flat = {f"{layer}.{leaf}": np.asarray(a) for layer, leaves in grads.items()
            for leaf, a in leaves.items()}
    return np.asarray(logits)[:n], {k: a[:n] if k in tables else a for k, a in flat.items()}


def _single_fwd_bwd(model, graph, params, x, w):
    """The port's single-device forward of ``model`` on ``graph``: the
    logits and the gradients of ``sum(logits * w)``."""
    p = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    logits = MODELS[model].forward_params(p, graph, None if x is None else torch.tensor(x))
    (logits * torch.tensor(w)).sum().backward()
    return logits.detach().numpy(), {k: t.grad.numpy() for k, t in p.items()}


def _close(got, want, rtol, atol_rel, what):
    np.testing.assert_allclose(
        got, want, rtol=rtol, atol=atol_rel * max(1.0, float(np.abs(want).max())), err_msg=what
    )


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("identity", [True, False], ids=["identity", "features"])
@pytest.mark.parametrize("partition", ["allgather", "halo"])
def test_segment_forward_and_gradients_match_jax(passes, model, identity, partition):
    """The family's sharded forward on ``segment`` (``ShardCOO`` or the halo
    ring) against JAX's on the same partition, from the same parameters:
    the logits and the gradient of every parameter (each node table's rows
    gathered, each replicated parameter's summed over the ranks) within
    rtol 1e-4, atol 1e-5 of the largest entry."""
    coo, inputs, out = passes
    logits, grads = out[model, identity, "segment", partition]
    want_logits, want_grads = _jax_fwd_bwd(model, partition, coo, *inputs[model, identity])
    _close(logits, want_logits, F32_RTOL, F32_ATOL, "logits")
    assert set(grads) == set(want_grads)
    for k, g in grads.items():
        _close(g, want_grads[k], F32_RTOL, F32_ATOL, k)


@pytest.mark.parametrize("model", FAMILIES)
@pytest.mark.parametrize("identity", [True, False], ids=["identity", "features"])
@pytest.mark.parametrize("kernel,partition", KERNELS)
def test_kernel_layouts_match_the_single_device_format(passes, model, identity, kernel,
                                                        partition):
    """The family on ``onehot`` (either partition) and ``hybrid`` against
    the port's single-device forward on the same format (the single-device
    formats are held against JAX in ``tests/test_torch_families.py``): the
    logits and every gradient within rtol 1e-3, atol 1e-4 of the largest
    entry. Both round the same f32 inputs to bf16; the ranks' partial sums,
    the ring's order and the rows' own matmuls move the f32 values by
    last bits, and so, rarely, a bf16 rounding by 2^-8."""
    coo, inputs, out = passes
    r, c, v, n = coo
    graph, perm = convert_graph(SparseGraph.from_coo(r, c, v, n, device=CPU), kernel)
    assert perm is None or np.array_equal(perm, np.arange(n))
    logits, grads = out[model, identity, kernel, partition]
    want_logits, want_grads = _single_fwd_bwd(model, graph, *inputs[model, identity])
    _close(logits, want_logits, KERNEL_RTOL, KERNEL_ATOL, "logits")
    for k, g in grads.items():
        _close(g, want_grads[k], KERNEL_RTOL, KERNEL_ATOL, k)


def test_halo_and_allgather_segment_runs_agree(passes):
    """The two segment partitions of the port agree with each other in f32
    (the ring adds a bucket at a time): rtol 1e-4, atol 1e-5 of the largest
    entry, for every family and both feature modes."""
    _, inputs, out = passes
    for model, identity in inputs:
        a, b = out[model, identity, "segment", "halo"], out[model, identity, "segment", "allgather"]
        _close(a[0], b[0], F32_RTOL, F32_ATOL, f"{model} logits")
        for k in a[1]:
            _close(a[1][k], b[1][k], F32_RTOL, F32_ATOL, f"{model} {k}")


# the five (kernel, partition) combinations, one a family
TRAIN_COMBOS = (("sage", "segment", "halo"), ("sgc", "segment", "allgather"),
                ("appnp", "onehot", "halo"), ("gin", "onehot", "allgather"),
                ("gcnii", "hybrid", "allgather"))


@pytest.fixture(scope="module")
def trained():
    """3 gloo ranks train the toy doc-word graph (identity features), each
    family on its (kernel, partition) of TRAIN_COMBOS (one spawn), dropout
    0.5, 4 epochs."""
    pt, _ = _prepared(seed=4)
    cfg = ttrainer.TrainConfig(n_hidden=16, max_epoch=4, early_stopping=100, seed=13)
    runs = _gloo(torch_sharded_ranks.train_combos, 3,
                 (launch.HostData.from_prepared(pt), cfg, list(TRAIN_COMBOS)))
    return pt, cfg, dict(zip(TRAIN_COMBOS, runs))


@pytest.mark.parametrize("model,kernel,partition", TRAIN_COMBOS)
def test_sharded_trainer_follows_the_single_device_trainer(trained, model, kernel, partition):
    """``ShardedTrainer`` of each family on 3 ranks against the port's
    single-device ``Trainer`` of that family on the same kernel (``segment``,
    the ``CSRGraph`` of ``--spmm onehot``, the degree-sorted
    ``HybridGraph``), same seed, dropout 0.5: the init and the dropout masks
    are drawn for all nodes from one generator, so only the order of f32
    sums differs: per-epoch losses within 1e-4 relative, equal accuracies;
    the parameter count is the single-device one."""
    import dataclasses

    pt, cfg, runs = trained
    hist, test = runs[model, kernel, partition]
    pre = pt if kernel == "segment" else tprepare.apply_spmm_format(pt, kernel)
    single = ttrainer.Trainer(
        pre.graph, None, pre.labels.target, pre.labels.train_idx, pre.labels.test_idx,
        N_CLASSES, config=dataclasses.replace(cfg, model=model), device=CPU,
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


def test_registry_and_node_tables_are_jax_s():
    """The port's ``SHARDED_MODELS`` has JAX's families and layer-1 keys,
    and with identity features exactly the layer-1 leaves that JAX's
    trainer row-shards (its ``[n_pad, ·]`` leaves) are rank-local."""
    assert set(ptrainer.SHARDED_MODELS) == set(jptrainer.SHARDED_MODELS)
    n_pad = 64
    for model, (init, _, layer1) in jptrainer.SHARDED_MODELS.items():
        assert ptrainer.SHARDED_MODELS[model][2] == layer1
        tree = init(jax.random.PRNGKey(0), n_pad, H, C)
        want = {f"{layer1}.{k}" for k, v in tree[layer1].items()
                if v.ndim == 2 and v.shape[0] == n_pad}
        assert set(ptrainer.node_tables(model)) == want, model
