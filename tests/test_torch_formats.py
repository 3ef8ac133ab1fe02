"""``--spmm bsr`` and ``--spmm onehot`` of the PyTorch port against the JAX
package, on the CPU: the bare f32 tile stack (K1's f32 mode, whose plain
version runs here) against JAX ``spmm_bsr_ad(bf16=False)``, the bare CSR
(K2 from zero) against JAX ``spmm_onehot``, both in Pallas interpret mode;
then every family but GAT over both formats, and the trainer's first
epochs, against JAX's.

Tolerances: bsr is f32 products and f32 sums in both packages, so 1e-5
relative (the order of the sums differs). onehot gathers bf16 features in
both, and the JAX kernel also rounds each edge weight and product to bf16;
on a graph with power-of-two weights every product is exact in both, so
the sums differ only in their order: 1e-5 of the largest output for the
op (as tests/test_torch_row_split.py holds K2 against ``spmm_onehot``).
The families over onehot at 2e-3 of the largest entry (bsr: 1e-4): each
propagation rounds its input to bf16 in both packages, and a sum-order
difference that crosses a rounding boundary moves an element by 2^-8 of
itself, which GCNII's eight propagations carry to ~3e-4 of its largest
gradient (with other weights a ReLU whose input is within a bf16 rounding
of 0 can also flip between the packages and move a gradient by a whole
term). The trainer's epochs over onehot, on the tiny topic graph's
normalized weights, at 2e-2 (bf16)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textgcn_tpu import models as jmodels
from textgcn_tpu.graph.format import convert_graph as j_convert
from textgcn_tpu.graph.structs import BlockSparseGraph as JBlockSparseGraph
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.ops.pallas_onehot import OneHotGraph, spmm_onehot
from textgcn_tpu.ops.spmm import spmm_bsr_ad
from textgcn_tpu.text.datasets import DatasetLabels as JLabels
from textgcn_tpu.train import prepare as jprepare
from textgcn_tpu.train import trainer as jtrainer

from test_torch_families import FAMILIES, _close, _graph, _jax_init
from torch_tiny_data import build_tiny

from textgcn_tpu_torch.graph.format import convert_graph
from textgcn_tpu_torch.graph.reorder import CSRGraph
from textgcn_tpu_torch.graph.structs import BlockSparseGraph, SparseGraph
from textgcn_tpu_torch.models import MODELS
from textgcn_tpu_torch.models.family import params_from_jax
from textgcn_tpu_torch.ops import bsr_spmm as tbsr
from textgcn_tpu_torch.ops.row_reduce import SEGMENT_EDGES
from textgcn_tpu_torch.ops.spmm import spmm
from textgcn_tpu_torch.text.datasets import DatasetLabels
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import trainer as ttrainer

CPU = torch.device("cpu")
FORMATS = ("bsr", "onehot")
TOL = {"bsr": 1e-4, "onehot": 2e-3}
H = 16


def _hub_graph(n=2200, hub_deg=700, seed=0, pow2=False):
    """A symmetric graph with 4 hubs of ``hub_deg`` neighbours spread over
    every block-column (block-rows of 18 tiles, rows longer than K2's S)
    and 3,000 uniform edges; values sym-normalized, or powers of two
    symmetric in (row, col)."""
    rng = np.random.RandomState(seed)
    hubs = rng.choice(n, 4, replace=False)
    src = np.r_[np.repeat(hubs, hub_deg), rng.randint(0, n, 3000)]
    dst = np.r_[rng.randint(0, n, 4 * hub_deg), rng.randint(0, n, 3000)]
    keep = src != dst
    key = np.unique(np.c_[np.minimum(src, dst), np.maximum(src, dst)][keep], axis=0)
    r = np.r_[key[:, 0], key[:, 1], np.arange(n)]
    c = np.r_[key[:, 1], key[:, 0], np.arange(n)]
    if pow2:
        k = np.r_[key[:, 0] + key[:, 1], key[:, 0] + key[:, 1], np.arange(n)] % 5
        v = 2.0 ** -(k + 1)
    else:
        deg = np.bincount(r, minlength=n).astype(np.float64)
        v = 1.0 / np.sqrt(deg[r] * deg[c])
    return r, c, v, n


def test_bsr_tile_stack_equals_jax_bit_for_bit():
    """``convert_graph(g, "bsr")``: f32 tiles with no degree sort and no
    permutation, blocks, block-rows and block-columns equal to JAX's; its
    split table covers the block-rows longer than T = 16 tiles."""
    r, c, v, n = _hub_graph()
    g = SparseGraph.from_coo(r, c, v, n, device=CPU)
    b, perm = convert_graph(g, "bsr")
    jb, jperm = j_convert(JSparseGraph.from_coo(r, c, v, n), "bsr")
    assert perm is None and jperm is None
    assert isinstance(b, BlockSparseGraph) and isinstance(jb, JBlockSparseGraph)
    assert b.blocks.dtype == torch.float32 and b.symmetric
    np.testing.assert_array_equal(b.blocks.numpy(), np.asarray(jb.blocks))
    np.testing.assert_array_equal(b.block_rows.numpy(), np.asarray(jb.block_rows))
    np.testing.assert_array_equal(b.block_cols.numpy(), np.asarray(jb.block_cols))
    assert int(torch.diff(b.tile_ptr.long()).max()) > tbsr.SEGMENT_TILES
    assert b.split is not None and b.split.n_long >= 1


def test_spmm_bsr_forward_and_gradient_match_jax():
    """``spmm`` over the bare f32 stack (K1's plain f32 version) and its
    autograd backward (the same pass: Â is symmetric) against JAX
    ``spmm_bsr_ad(g, g, x, bf16=False)`` in interpret mode, rtol 1e-5."""
    r, c, v, n = _hub_graph(seed=1)
    b, _ = convert_graph(SparseGraph.from_coo(r, c, v, n, device=CPU), "bsr")
    jb = JBlockSparseGraph.from_coo(r, c, v, n, symmetric=True)
    rng = np.random.RandomState(2)
    x = rng.randn(n, 24).astype(np.float32)
    cot = rng.randn(n, 24).astype(np.float32)
    want, vjp = jax.vjp(lambda z: spmm_bsr_ad(jb, jb, z, True, False), jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = spmm(b, xt)
    got.backward(torch.from_numpy(cot))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want)[:n], rtol=1e-5, atol=1e-5 * scale)
    scale = float(np.abs(np.asarray(want_dx)).max())
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx)[:n], rtol=1e-5, atol=1e-5 * scale)


def test_tile_kernel_check_refuses_mixed_types():
    """The CUDA wrapper's check takes bf16 tiles with bf16 features or f32
    with f32 and refuses a mix (as JAX's f32 path refuses bf16 tiles)."""
    ptr = torch.tensor([0, 1], dtype=torch.int32)
    col = torch.zeros(1, dtype=torch.int32)
    for tiles_dtype, x_dtype in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
                                 (torch.float16, torch.float16)):
        tiles = torch.zeros((1, 128, 128), dtype=tiles_dtype)
        x = torch.zeros((128, 16), dtype=x_dtype)
        with pytest.raises(TypeError, match="bf16 tiles with bf16 features or f32"):
            tbsr._check_tiles("bsr_spmm", tiles, ptr, col, x)
    for dtype in (torch.float32, torch.bfloat16):
        tbsr._check_tiles("bsr_spmm", torch.zeros((1, 128, 128), dtype=dtype), ptr, col,
                          torch.zeros((128, 16), dtype=dtype))


def test_spmm_onehot_forward_and_gradient_match_jax():
    """``spmm`` over the bare CSR (``convert_graph(g, "onehot")``: K2 from
    zero with the CSR's RowSplit, its plain version here) and its backward
    against JAX ``spmm_onehot`` on ``OneHotGraph.from_coo(symmetric=True)``
    in interpret mode; power-of-two weights and bf16 features and
    cotangent make every product exact, so 1e-5 of the largest output."""
    r, c, v, n = _hub_graph(seed=3, pow2=True)
    g, perm = convert_graph(SparseGraph.from_coo(r, c, v, n, device=CPU), "onehot")
    assert perm is None and isinstance(g, CSRGraph) and g.symmetric
    assert int(torch.diff(g.csr.row_ptr.long()).max()) > SEGMENT_EDGES
    assert g.csr.split is not None
    jg = OneHotGraph.from_coo(r, c, v, n, symmetric=True)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(n, 20).astype(np.float32)).bfloat16().float()
    cot = torch.from_numpy(rng.randn(n, 20).astype(np.float32)).bfloat16().float()
    want, vjp = jax.vjp(lambda z: spmm_onehot(jg.fwd, jg.bwd, z, True), jnp.asarray(x.numpy()))
    (want_dx,) = vjp(jnp.asarray(cot.numpy()))
    xt = x.clone().requires_grad_(True)
    got = spmm(g, xt)
    got.backward(cot)
    for a, b in ((got.detach().numpy(), np.asarray(want)), (xt.grad.numpy(), np.asarray(want_dx))):
        np.testing.assert_allclose(a, b[:n], rtol=0, atol=1e-5 * float(np.abs(b).max()))


@pytest.fixture(scope="module")
def prepared():
    """Each package's PreparedData of the families' test graph in bsr (its
    normalized weights) and onehot (power-of-two weights, symmetric)."""
    r, c, v, x, target = _graph()
    n, f, n_class = x.shape[0], x.shape[1], int(target.max()) + 1
    idx = np.arange(n)
    common = dict(features=x, n_feat=f, num_docs=n, num_topics=0)
    names = [f"c{i}" for i in range(n_class)]
    out = {}
    for fmt in FORMATS:
        w = v if fmt == "bsr" else 2.0 ** -((r + c) % 5 + 1)
        pt = tprepare.PreparedData(
            graph=SparseGraph.from_coo(r, c, w, n, device=CPU),
            labels=DatasetLabels(target, names, idx[:300], idx[300:]), **common,
        )
        pj = jprepare.PreparedData(
            graph=JSparseGraph.from_coo(r, c, w, n),
            labels=JLabels(target, names, idx[:300], idx[300:]), **common,
        )
        out[fmt] = tprepare.apply_spmm_format(pt, fmt), jprepare.apply_spmm_format(pj, fmt)
    return out


@pytest.mark.parametrize("features", ["identity", "dense"])
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("family", ["gcn", *FAMILIES])
def test_family_forward_and_gradients_match_jax(family, fmt, features, prepared):
    """Each non-GAT family over bsr and onehot: logits of all nodes and the
    gradient of each parameter of ``sum(logits * cot)`` (no dropout) from
    shared parameters; sgc_pre with identity features raises on both
    sides."""
    pt, pj = prepared[fmt]
    assert isinstance(pt.graph, BlockSparseGraph if fmt == "bsr" else CSRGraph)
    assert pt.perm is None
    x = None if features == "identity" else pt.features
    n, n_class = pt.n_nodes, pt.labels.n_classes
    n_feat = n if x is None else x.shape[1]
    params_np = _jax_init(family, n_feat)
    _, j_forward = jmodels.MODELS[family]
    cot = np.random.RandomState(1).randn(n, n_class).astype(np.float32)
    if family == "sgc_pre" and x is None:
        with pytest.raises(ValueError, match="precomputed"):
            MODELS[family].forward_params(params_from_jax(params_np, device=CPU), pt.graph, None)
        return
    xj = None if x is None else jnp.asarray(x)
    want, vjp = jax.vjp(lambda p: j_forward(p, pj.graph, xj, train=False), params_np)
    (want_grads,) = vjp(jnp.asarray(cot))
    model = MODELS[family](n_feat, H, n_class, device=CPU)
    model.load_state_dict(params_from_jax(params_np, device=CPU))
    model.eval()
    got = model(pt.graph, None if x is None else torch.from_numpy(x))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got.detach(), want, TOL[fmt], "logits")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for layer, leaves in want_grads.items():
        for leaf, g in leaves.items():
            _close(grads[f"{layer}.{leaf}"], g, TOL[fmt], f"d {layer}.{leaf}")


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return build_tiny(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("family,fmt", [("gcn", "bsr"), ("gcn", "onehot"), ("appnp", "onehot")])
def test_trainer_matches_jax_trainer_per_epoch(family, fmt, tiny_root):
    """The tiny topic graph in bsr or onehot, 6 epochs at dropout 0 from
    JAX's init: per-epoch train loss, val loss and val acc within 1e-4
    relative (bsr, f32) or 2e-2 (onehot, bf16), and the test accuracy."""
    pt = tprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4, device=CPU)
    pj = jprepare.prepare_topic_data("tiny", data_root=tiny_root, num_topics=4)
    pt, pj = tprepare.apply_spmm_format(pt, fmt), jprepare.apply_spmm_format(pj, fmt)
    kw = dict(n_hidden=H, dropout=0.0, max_epoch=6, early_stopping=100, seed=7, spmm=fmt,
              model=family)
    jt = jtrainer.Trainer(
        pj.graph, pj.features, pj.labels.target, pj.labels.train_idx, pj.labels.test_idx,
        pj.labels.n_classes, config=jtrainer.TrainConfig(epoch_block=6, **kw),
    )
    jt.fit(verbose=False)
    _, init_key = jax.random.split(jax.random.PRNGKey(7))
    init, _ = jmodels.MODELS[family]
    params = jax.tree_util.tree_map(np.asarray, init(init_key, pt.n_feat, H, pt.labels.n_classes))
    tt = ttrainer.Trainer(
        pt.graph, pt.features, pt.labels.target, pt.labels.train_idx, pt.labels.test_idx,
        pt.labels.n_classes, config=ttrainer.TrainConfig(**kw), device=CPU,
    )
    tt.fit(verbose=False, params=params_from_jax(params, device=CPU))
    rtol = 1e-4 if fmt == "bsr" else 2e-2
    assert len(tt.history) == len(jt.history) == 6
    for a, b in zip(tt.history, jt.history):
        for k in ("train_loss", "val_loss", "acc"):
            np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(tt.test()["acc"], jt.test()["acc"], rtol=rtol)
