"""Streaming on the ranks (``textgcn_tpu_torch/parallel/streamed.py``, route
B.4) against the JAX package's sorted mesh stream
(``textgcn_tpu/parallel/streamed.py``), on the CPU.

Both sides get the JAX tests' ``_sym_graph`` (n = 64, e = 400, both
directions; ``tests/test_streamed_mesh_sorted.py``) and the same inputs,
made with numpy from a seed. JAX runs on 4 of the 8 virtual CPU devices,
Pallas in interpret mode; the port runs 4 gloo ranks in one spawn (a
module fixture; ``tests/torch_sharded_ranks.py`` ``streamed_mesh_runs``),
where K2's wrapper runs its plain version. The port's buckets are cut at 16
edges a chunk, so that a bucket holds several chunks.

Tolerances, the JAX package's own for its sorted ring: the pass 1e-5, its
gradient 1e-4 (f32 sums in another order); a step's losses and parameters
after 3 Adam steps 1e-4. The bucket files' pass equals the resident pass
bit for bit, and at P = 1 the ring equals the single-card stream bit for
bit (one bucket, the same chunks).
"""
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import textgcn_tpu.models as jax_models
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.parallel import streamed as jps
from textgcn_tpu.parallel.halo import partition_rows_halo as j_partition_rows_halo
from textgcn_tpu.parallel.sharded import make_mesh

import torch_sharded_ranks

from textgcn_tpu_torch.models.family import params_from_jax
from textgcn_tpu_torch.ops import streamed_sorted as ss
from textgcn_tpu_torch.parallel import launch
from textgcn_tpu_torch.parallel import streamed as ps
from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph
from textgcn_tpu_torch.train import streamed as st

WORLD, K, W = 4, 128, 8
CHUNK = 16
F, H, C = 12, 6, 3
STEPS = 3
PASS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-4, 1e-4
# the families' knobs (APPNP and GCNII at depth 3, as the JAX streamed tests)
FAMILY_HYPER = {
    "gcn": {}, "sgc": {}, "appnp": {"k": 3}, "sage": {}, "gin": {}, "gcnii": {"k": 3},
}


def _sym_graph(n=64, e=400, seed=3):
    """The JAX test graph: ``e`` random pairs in both directions."""
    rng = np.random.RandomState(seed)
    row, col, val = rng.randint(0, n, e), rng.randint(0, n, e), rng.rand(e)
    return np.r_[row, col], np.r_[col, row], np.r_[val, val], n


def _jax_stream(coo):
    r, c, v, n = coo
    g = JSparseGraph.from_coo(r, c, v, n, pad_to_multiple=8)
    hg = j_partition_rows_halo(g, WORLD, pad_edges_to_multiple=8)
    edge_fn, n_chunks, spec, edge_args = jps.halo_sorted_bucket_stream(hg, k=K, w=W)
    return hg, edge_fn, (hg.rows_per_shard, WORLD, n_chunks), spec, edge_args


def _inputs(n_pad, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_pad, F).astype(np.float32)
    y = rng.randint(0, C, n_pad).astype(np.int32)
    mask = (rng.rand(n_pad) < 0.5).astype(np.float32)
    return x, y, mask


def _jax_params(family):
    init = jax_models.MODELS[family][0]
    hyper = FAMILY_HYPER[family] if family == "gcnii" else {}
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), F, H, C, **hyper))


def _flat(params_np):
    return {k: v.numpy() for k, v in params_from_jax(params_np, device="cpu").items()}


def _cases(inputs):
    cases = [(f, f, FAMILY_HYPER[f], _flat(_jax_params(f)), inputs, "both", STEPS)
             for f in FAMILY_HYPER]
    gcn = _flat(_jax_params("gcn"))
    cases += [(f"gcn_{h}", "gcn", {}, gcn, inputs, h, STEPS) for h in ("no_count", "no_sync")]
    return cases


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """The port's runs on 4 gloo ranks (one spawn) and their inputs."""
    coo = _sym_graph()
    n_pad = HaloPartitionedGraph.from_coo(*coo, WORLD, 0, device="cpu").n_pad
    rng = np.random.RandomState(5)
    x = rng.randn(n_pad, 128).astype(np.float32)
    t = rng.randn(n_pad, 128).astype(np.float32)
    inputs = _inputs(n_pad, 12)
    out = launch.spawn_ranks(
        torch_sharded_ranks.streamed_mesh_runs, WORLD,
        (coo, x, t, str(tmp_path_factory.mktemp("buckets")), CHUNK, _cases(inputs)),
        backend="gloo", devices=["cpu"] * WORLD, timeout_s=120.0,
    )
    return coo, n_pad, x, t, inputs, out


def test_the_mesh_pass_and_its_gradient_match_jax(ring):
    coo, n_pad, x, t, _, out = ring
    _, edge_fn, dims, spec, edge_args = _jax_stream(coo)
    mesh = make_mesh(WORLD)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("nodes", None)))

    def f(v):
        return jps.spmm_streamed_mesh_sorted(edge_fn, v, mesh, dims, spec, edge_args, True)

    want = np.asarray(f(xs))
    np.testing.assert_allclose(out["pass"], want, rtol=PASS_TOL, atol=PASS_TOL)
    g = np.asarray(jax.grad(lambda v: jnp.sum(f(v) * t))(xs))
    np.testing.assert_allclose(out["grad"], g, rtol=GRAD_TOL, atol=GRAD_TOL)
    # and both against the dense product
    r, c, v, _ = coo
    a = sp.coo_matrix((v.astype(np.float64), (r, c)), shape=(n_pad, n_pad)).tocsr()
    np.testing.assert_allclose(out["pass"], a @ x, rtol=PASS_TOL, atol=PASS_TOL)


def test_buckets_hold_several_chunks_and_the_files_give_the_same_bits(ring):
    out = ring[-1]
    assert out["files_equal"] == [1] * WORLD
    counts = np.asarray(out["chunks"])
    assert counts.shape == (WORLD, WORLD) and counts.max() > 1 and (counts >= 0).all()


_JAX_STEPS = {}


def _jax_steps(family, coo, inputs):
    """JAX's ``make_streamed_sharded_step_segmented(..., sorted_spec=)`` from
    the same init, 3 Adam steps; its sorted ring in interpret mode. Each
    family's run is made once."""
    if family not in _JAX_STEPS:
        orig = jps.spmm_streamed_mesh_sorted_multi
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jps, "spmm_streamed_mesh_sorted_multi",
                       lambda *a, **k: orig(*a, **{**k, "interpret": True}))
            _JAX_STEPS[family] = _jax_run_steps(family, coo, inputs)
    return _JAX_STEPS[family]


def _jax_run_steps(family, coo, inputs):
    _, edge_fn, dims, spec, edge_args = _jax_stream(coo)
    mesh = make_mesh(WORLD)
    opt = optax.adam(0.02)
    step = jps.make_streamed_sharded_step_segmented(
        family, edge_fn, mesh, dims, edge_args, chunks_per_dispatch=1, sorted_spec=spec,
        optimizer=opt, stream_dtype=jnp.float32, **FAMILY_HYPER[family],
    )
    params = jax.tree_util.tree_map(jnp.asarray, _jax_params(family))
    state = opt.init(params)
    xs, ys, ms = jps.shard_streamed_inputs(mesh, *inputs)
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, xs, ys, ms)
        losses.append(float(loss))
    return losses, _flat(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("family", list(FAMILY_HYPER))
def test_sharded_step_matches_jax(ring, family):
    """3 Adam steps of each family's sharded step (f32 stream) from JAX's
    init: losses and every parameter within 1e-4 of JAX's."""
    coo, _, _, _, inputs, out = ring
    losses, params = out[family]
    j_losses, j_params = _jax_steps(family, coo, inputs)
    np.testing.assert_allclose(losses, j_losses, rtol=STEP_TOL)
    assert set(params) == set(j_params)
    for k in params:
        np.testing.assert_allclose(params[k], j_params[k], rtol=STEP_TOL, atol=STEP_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("hooks", ["no_count", "no_sync"])
def test_the_jax_check_fails_without_a_hook(ring, hooks):
    """At P = 4 the step without the global denominator (each rank divides
    by its own train count) or without the gradient all-reduce (the
    replicated weights drift apart) misses JAX's by more than the
    tolerance: the check above sees both faults."""
    coo, _, _, _, inputs, out = ring
    losses, params = out[f"gcn_{hooks}"]
    j_losses, j_params = _jax_steps("gcn", coo, inputs)
    loss_gap = np.max(np.abs(np.asarray(losses) - j_losses) / np.abs(j_losses))
    param_gap = max(np.max(np.abs(params[k] - j_params[k])) for k in params)
    assert loss_gap > STEP_TOL or param_gap > 10 * STEP_TOL


def _one_rank(rank, world, device, coo, x, y, mask):
    """A group of one: the ring's pass and one sharded GCN step against the
    single-card stream over the whole CSR (bf16 features and stream)."""
    row, col, val, n = coo
    hg = HaloPartitionedGraph.from_coo(row, col, val, n, 1, 0, device=device)
    buckets = ps.halo_sorted_bucket_stream(hg, CHUNK)
    chunks = ss.csr_stream(*ss._coo_to_csr(row, col, val, n), CHUNK)
    xb = torch.from_numpy(x).bfloat16()
    ring_pass = ps.spmm_streamed_mesh_sorted_hostfed(buckets, xb)
    single = ss.spmm_streamed_sorted(chunks, xb)
    losses, grads = [], []
    for mesh in (True, False):
        params, opt = st.init_streamed(torch.Generator().manual_seed(0), F, H, C, device=device)
        if mesh:
            step = ps.make_streamed_sharded_train_step_segmented(buckets, n, opt)
        else:
            step = st.make_streamed_train_step_segmented(st.make_sorted_stream(chunks), n, opt)
        losses.append(step(params, xb[:, :F].contiguous(), torch.from_numpy(y).long(),
                           torch.from_numpy(mask)))
        grads.append({k: p.grad for k, p in params.items()})
    return ring_pass, single, losses, grads


def test_at_one_rank_the_ring_is_the_single_card_stream():
    coo = _sym_graph(seed=9)
    n = coo[3]
    rng = np.random.RandomState(4)
    x = rng.randn(n, 128).astype(np.float32)
    _, y, mask = _inputs(n, 6)
    ring_pass, single, losses, grads = launch.spawn_ranks(
        _one_rank, 1, (coo, x, y, mask), backend="gloo", devices=["cpu"], timeout_s=60.0)
    assert torch.equal(ring_pass, single)
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[1])


def test_shard_streamed_inputs_are_the_rank_rows():
    x, y, mask = _inputs(10, 1)
    xl, yl, ml = ps.shard_streamed_inputs(x, y, mask, 2, 4, device="cpu")
    assert xl.shape == (4, F) and torch.equal(xl[:2], torch.from_numpy(x[8:]))
    assert not xl[2:].any() and not ml[2:].any() and torch.equal(yl[:2], torch.from_numpy(y[8:]))
