"""The ``auto`` cost model of the PyTorch port against the JAX package's,
on the CPU: with the JAX package's ``MachineModel()`` constants passed into
the port's fields, the dense, segment, onehot and streamed estimates equal
JAX ``estimate_format_costs`` to 1e-9 relative (at feature widths where the
two packages pad alike: JAX to 128 columns, the port to 16); the hybrid
term, which prices the port's kernel calls in place of the TPU's grid
steps, is held to its formula; ``convert_graph(g, "auto")`` on the
committed mr topic graph; GAT's ``auto``; and the trainer's refusal of the
host-streamed format."""
import dataclasses

import numpy as np
import pytest
import torch

from textgcn_tpu.graph.format import MachineModel as JMachineModel
from textgcn_tpu.graph.format import _estimate_with_perm as j_estimate_with_perm
from textgcn_tpu.graph.format import estimate_format_costs as j_estimate
from textgcn_tpu.graph.reorder import degree_sort_permutation as j_degree_sort
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph

from test_torch_checkpoint import _pre

from textgcn_tpu_torch.graph import format as tformat
from textgcn_tpu_torch.graph.structs import SparseGraph
from textgcn_tpu_torch.models.gat import DenseAttentionGraph
from textgcn_tpu_torch.ops.attention import AttentionGraph
from textgcn_tpu_torch.ops.streamed_sorted import SortedStreamGraph
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.train.prepare import load_graph_edges

CPU = torch.device("cpu")
SHARED = ("dense", "segment", "onehot")


def _powerlaw(n=12_000, e=80_000, seed=0):
    """A power-law pattern above DENSE_MAX_NODES, max-symmetrized and
    sym-normalized."""
    from textgcn_tpu_torch.graph.normalize import max_symmetrize_coo, sym_normalize_coo

    rng = np.random.RandomState(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** -1.0
    p /= p.sum()
    r, c = rng.choice(n, size=e, p=p), rng.choice(n, size=e, p=p)
    r, c, v = max_symmetrize_coo(r, c, rng.rand(e), n)
    return (*sym_normalize_coo(r, c, v, n), n)


def _port_model(j: JMachineModel, **kw) -> tformat.MachineModel:
    """The JAX package's constants in the port's fields (its MXU f32 rate is
    the port's f32 matmul rate)."""
    return tformat.MachineModel(
        hbm_gbps=j.hbm_gbps, gather_rows_per_s=j.gather_rows_per_s,
        gather_unique_rows_per_s=j.gather_unique_rows_per_s, matmul_f32_flops=j.mxu_f32_flops,
        eff_segment=j.eff_segment, eff_onehot=j.eff_onehot, eff_hybrid_bsr=j.eff_hybrid_bsr,
        dense_bytes_budget=j.dense_bytes_budget, resident_bytes_budget=j.resident_bytes_budget,
        **kw,
    )


@pytest.fixture(scope="module")
def graphs():
    r, c, v, n = _powerlaw()
    assert n > tformat.DENSE_MAX_NODES
    return SparseGraph.from_coo(r, c, v, n, device=CPU), JSparseGraph.from_coo(r, c, v, n)


@pytest.mark.parametrize("f", [128, 256])
def test_shared_estimates_equal_jax(f, graphs):
    g, jg = graphs
    jm = JMachineModel()
    got = tformat.estimate_format_costs(g, f=f, mm=_port_model(jm))
    want = j_estimate(jg, f=f, mm=jm)
    assert set(got) == set(want) == {*SHARED, "hybrid"}
    for fmt in SHARED:
        np.testing.assert_allclose(got[fmt], want[fmt], rtol=1e-9, atol=0, err_msg=fmt)


def test_streamed_estimate_equals_jax_over_the_resident_budget(graphs):
    """Past ``resident_bytes_budget`` only the streamed format is eligible,
    at JAX's price."""
    g, jg = graphs
    jm = dataclasses.replace(JMachineModel(), resident_bytes_budget=1 << 20)
    got = tformat.estimate_format_costs(g, f=256, mm=_port_model(jm))
    want = j_estimate(jg, f=256, mm=jm)
    assert set(got) == set(want) == {"streamed"}
    np.testing.assert_allclose(got["streamed"], want["streamed"], rtol=1e-9, atol=0)


def test_hybrid_estimate_follows_its_formula(graphs):
    """The port's hybrid term: the degree-sorted tiles of >= 24 edges at
    the memory rate over K1's efficiency, the pass's kernel calls at the
    host's call cost, the residual at onehot's rate. With the JAX constants
    it is JAX's term with the TPU's grid steps (tiles / 8) exchanged for
    the calls; the permutation is JAX's degree sort."""
    g, jg = graphs
    jm = JMachineModel()
    mm = _port_model(jm, call_s=17e-6)
    costs, perm = tformat._estimate_with_perm(g, f=256, mm=mm)
    row, col, _ = g.coo_numpy()
    np.testing.assert_array_equal(perm, j_degree_sort(row, col, g.n_nodes))
    n_bc = -(-g.n_nodes // 128)
    _, counts = np.unique((perm[row] // 128) * n_bc + perm[col] // 128, return_counts=True)
    tiles, clustered = int((counts >= 24).sum()), int(counts[counts >= 24].sum())
    assert 0 < clustered < g.n_edges
    n_pad = n_bc * 128
    want = ((tiles * (128 * 128 * 2 + 128 * 256 * 2) + n_pad * 256 * 4)
            / (mm.hbm_gbps * 1e9) / mm.eff_hybrid_bsr
            + tformat.HYBRID_CALLS * mm.call_s
            + (g.n_edges - clustered) / (mm.gather_rows_per_s * mm.eff_onehot))
    np.testing.assert_allclose(costs["hybrid"], want, rtol=1e-12)
    jcosts, _ = j_estimate_with_perm(jg, f=256, mm=jm)
    np.testing.assert_allclose(
        costs["hybrid"] - tformat.HYBRID_CALLS * mm.call_s,
        jcosts["hybrid"] - tiles / 8.0 * jm.grid_step_s, rtol=1e-9,
    )


def test_auto_on_the_committed_mr_topic_graph():
    """10,712 nodes, above DENSE_MAX_NODES: ``auto`` prices the formats with
    the committed H100 constants and returns a container (never raises),
    the same choice on two calls; the hybrid pick reuses the cost model's
    permutation."""
    g = load_graph_edges("data/graph/mr_topic.txt", 10_712, device=CPU)
    pick = tformat.choose_format(g)
    assert pick == tformat.choose_format(g)
    assert pick in {"dense", "segment", "onehot", "hybrid"}
    container, perm = tformat.convert_graph(g, "auto")
    assert type(container) is type(tformat.convert_graph(g, pick)[0])
    assert (perm is not None) == (pick == "hybrid")
    costs = tformat.estimate_format_costs(g)
    assert min(costs, key=costs.get) == pick


def test_gat_auto_prices_the_dense_peak(monkeypatch):
    """GAT's auto: dense while ``gat_dense_tables`` [N, N] f32 tables fit
    the budget, the degree-sorted attention layout when they do not; up to
    DENSE_MAX_NODES dense without pricing."""
    mm = tformat.MachineModel()
    n = 15_362
    assert tformat.gat_auto_format(n, mm) == "dense"
    small = dataclasses.replace(mm, dense_bytes_budget=int(mm.gat_dense_tables * 4 * n * n) - 1)
    assert tformat.gat_auto_format(n, small) == "hybrid"
    assert tformat.gat_auto_format(400, small) == "dense"
    pre = _pre(features=False)
    monkeypatch.setattr(trun, "DENSE_MAX_NODES", 100)
    assert isinstance(trun.apply_gat_format(pre, "auto").graph, DenseAttentionGraph)
    tight = dataclasses.replace(mm, dense_bytes_budget=1 << 20)
    out = trun.apply_gat_format(pre, "auto", mm=tight)
    assert isinstance(out.graph, AttentionGraph) and out.perm is not None


def test_trainer_refuses_the_streamed_format_naming_a12():
    """Where the graph exceeds the resident budget, auto picks the
    host-streamed format; the Trainer refuses it before any epoch."""
    pre = _pre()
    tiny = dataclasses.replace(tformat.MachineModel(), resident_bytes_budget=1 << 10)
    g, perm = tformat.convert_graph(pre.graph, "auto", dense_max_nodes=100, mm=tiny)
    assert isinstance(g, SortedStreamGraph) and perm is None
    t = ttrainer.Trainer(g, pre.features, pre.labels.target, pre.labels.train_idx,
                         pre.labels.test_idx, pre.labels.n_classes, device=CPU)
    with pytest.raises(NotImplementedError, match="A.12"):
        t.fit(verbose=False)


def test_probe_machine_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        tformat.probe_machine("cpu")
