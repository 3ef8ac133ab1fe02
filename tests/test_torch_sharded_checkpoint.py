"""Sharded checkpoints of the PyTorch port (``ShardedTrainer.save``,
``save_training_state``, ``load``, ``fit(resume_from=)``; ``run_experiment``
and ``resume_training`` with ``n_shards``; ``run_sharded_experiment``) on the
CPU, against the uninterrupted runs, the single-device ``Trainer`` and the
JAX ``ShardedTrainer``'s checkpoint.

The port's ranks are gloo processes through its launcher (rank 0 in this
process), each running ``tests/torch_sharded_ranks.py`` ``checkpoint_jobs``;
one spawn of 3 ranks and one of 2 feed the tests (a module fixture). JAX
runs on 4 of the 8 virtual CPU devices that ``tests/conftest.py`` sets up,
with Pallas in interpret mode.

Tolerances: a resume on the same ranks and layout is compared for equality
(every op is deterministic on the CPU, the padding rows stay at their
init); a resume across rank counts or trainers follows the uninterrupted
run within 1e-4 relative (f32 sums in another order: per-rank partial sums
all-reduced, a bucket a ring step); JAX's canonical tables are compared at
f32 tolerance (1e-5) on a graph whose every edge lies in a dense tile, so
that neither side rounds a residual product to bf16.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax

from textgcn_tpu.graph.normalize import sym_normalize_coo as j_sym_normalize
from textgcn_tpu.graph.structs import SparseGraph as JSparseGraph
from textgcn_tpu.models.gcn import gcn_init as j_gcn_init
from textgcn_tpu.parallel import trainer as jptrainer
from textgcn_tpu.train.checkpoint import restore_checkpoint as j_restore
from textgcn_tpu.train.trainer import TrainConfig as JTrainConfig

import torch_sharded_ranks
from test_torch_train import N_CLASSES, _prepared

from textgcn_tpu_torch.graph.reorder import degree_sort_permutation
from textgcn_tpu_torch.parallel import launch
from textgcn_tpu_torch.parallel import trainer as ptrainer
from textgcn_tpu_torch.train import prepare as tprepare
from textgcn_tpu_torch.train import run as trun
from textgcn_tpu_torch.train import trainer as ttrainer
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

CPU = torch.device("cpu")
TIMEOUT_S = 60.0
CROSS_RTOL = 1e-4
F32_TOL = 1e-5
CFG = ttrainer.TrainConfig(n_hidden=16, max_epoch=8, early_stopping=100, seed=3)
# the JAX comparison: no dropout (the RNG streams differ), few epochs
JAX_EPOCHS, JAX_SEED = 3, 5


def _gloo(fn, world, args):
    return launch.spawn_ranks(fn, world, args, backend="gloo", devices=["cpu"] * world,
                              timeout_s=TIMEOUT_S)


def _single(pre, **kw):
    return ttrainer.Trainer(
        pre.graph, pre.features, pre.labels.target, pre.labels.train_idx, pre.labels.test_idx,
        N_CLASSES, config=dataclasses.replace(CFG, **kw), device=CPU, perm=pre.perm,
    )


def _dense_tiled(n=256, seed=0):
    """A symmetric graph whose every edge lies in a 128x128 tile of more than
    24 edges after the degree sort (density 0.3), sym-normalized by the JAX
    package, with labels on every node: the hybrid layouts have no residual
    edges."""
    rng = np.random.RandomState(seed)
    a = np.triu(rng.rand(n, n) < 0.3, 1)
    r, c = np.nonzero(a | a.T)
    r, c, v = j_sym_normalize(r, c, np.ones(len(r)), n)
    target = rng.randint(0, N_CLASSES, n)
    return r, c, v, n, target, np.arange(180), np.arange(180, n)


def _jax_run(graph, path):
    """The JAX ``ShardedTrainer`` (hybrid, allgather, 4 devices, identity
    features) from its own init, saved; returns (its init as host arrays,
    its history)."""
    r, c, v, n, target, tr, te = graph
    cfg = JTrainConfig(n_hidden=16, max_epoch=JAX_EPOCHS, early_stopping=100, dropout=0.0,
                       seed=JAX_SEED, epoch_block=1)
    jt = jptrainer.ShardedTrainer(JSparseGraph.from_coo(r, c, v, n), None, target, tr, te,
                                  N_CLASSES, config=cfg, n_shards=4, partition="allgather",
                                  kernel="hybrid")
    jt.fit(verbose=False)
    jt.save(path)
    _, init_key = jax.random.split(jax.random.PRNGKey(JAX_SEED))
    init = jax.tree_util.tree_map(np.asarray, j_gcn_init(init_key, jt.n_pad, 16, N_CLASSES))
    return init, jt.history


@pytest.fixture(scope="module")
def ck(tmp_path_factory):
    """Every run of the file: single-card runs here, then one spawn of 3
    gloo ranks and one of 2."""
    d = tmp_path_factory.mktemp("ckpt")
    pt, _ = _prepared()
    ph = tprepare.apply_spmm_format(pt, "hybrid")
    out = {"pt": pt, "ph": ph, "dir": d}
    # single card: segment straight, and 4 epochs saved; hybrid 4 epochs saved
    s = _single(pt)
    s.fit(verbose=False)
    out["single"] = (s.history, s.test())
    s = _single(pt, max_epoch=4)
    s.fit(verbose=False)
    s.save_training_state(str(d / "single_state"))
    s = _single(ph, max_epoch=4)
    s.fit(verbose=False)
    s.save(str(d / "single_hybrid_model"))
    out["single_hybrid_model"] = s.test()

    dense = _dense_tiled()
    jax_init, out["jax_history"] = _jax_run(dense, str(d / "jax_model"))
    r, c, v, n, target, tr, te = dense
    datasets = {
        "toy": launch.HostData.from_prepared(pt),
        "dense": launch.HostData(r, c, v, n, None, target, tr, te, N_CLASSES),
    }
    out["dense"] = dense
    jobs3 = []
    for kernel, partition in (("segment", "halo"), ("hybrid", "allgather")):
        tag = f"{kernel}_{partition}"
        base = {"data": "toy", "kernel": kernel, "partition": partition}
        jobs3 += [
            {**base, "name": f"straight_{tag}"},
            {**base, "name": f"first_{tag}", "config": {"max_epoch": 4},
             "save_state": str(d / f"state_{tag}"), "save_model": str(d / f"model_{tag}")},
            {**base, "name": f"resumed_{tag}", "resume_from": str(d / f"state_{tag}")},
        ]
    jobs3 += [
        {"data": "toy", "kernel": "segment", "partition": "halo", "name": "from_single",
         "resume_from": str(d / "single_state")},
        {"data": "toy", "kernel": "segment", "partition": "halo", "name": "load_single_hybrid",
         "load": str(d / "single_hybrid_model")},
    ]
    out.update(_gloo(torch_sharded_ranks.checkpoint_jobs, 3, (datasets, CFG, jobs3)))
    jobs2 = [
        {"data": "toy", "kernel": "hybrid", "partition": "allgather", "name": "p2_from_p3",
         "resume_from": str(d / "state_hybrid_allgather")},
        {"data": "dense", "kernel": "hybrid", "partition": "allgather", "name": "jax_init",
         "params_np": jax_init, "save_model": str(d / "port_model"),
         "config": {"max_epoch": JAX_EPOCHS, "dropout": 0.0, "seed": JAX_SEED}},
    ]
    out.update(_gloo(torch_sharded_ranks.checkpoint_jobs, 2, (datasets, CFG, jobs2)))
    return out


def _losses(history):
    return [(h["train_loss"], h["val_loss"]) for h in history]


@pytest.mark.parametrize("tag", ["segment_halo", "hybrid_allgather"])
def test_resume_on_the_same_ranks_gives_the_uninterrupted_bits(ck, tag):
    """3 ranks, identity features, dropout 0.5: 8 epochs straight, or 4
    epochs saved and resumed to 8 (the generator, Adam's moments and the
    counters restored): the histories and test results are equal."""
    straight, test = ck[f"straight_{tag}"]
    first, resumed = ck[f"first_{tag}"][0], ck[f"resumed_{tag}"]
    assert len(straight) == 8 and len(first) == 4
    assert first + resumed[0] == straight
    assert resumed[1]["acc"] == test["acc"] and resumed[1]["test_loss"] == test["test_loss"]


def _follows(history, want, rtol=CROSS_RTOL):
    assert len(history) == len(want)
    np.testing.assert_allclose(_losses(history), _losses(want), rtol=rtol)


def test_a_single_card_state_resumes_on_three_ranks(ck):
    """The single-card segment Trainer's state at epoch 4 resumed on 3 ranks
    under segment/halo follows the single card's uninterrupted epochs 5-8."""
    _follows(ck["from_single"][0], ck["single"][0][4:])


def test_a_three_rank_state_resumes_on_two_ranks_and_on_one_card(ck):
    """The 3-rank hybrid state at epoch 4 resumed at P = 2 and on one card
    (the single-card hybrid layout: the canonical tables and their Adam
    moments relabeled by its degree sort) follows the 3-rank run."""
    want = ck["straight_hybrid_allgather"][0][4:]
    _follows(ck["p2_from_p3"][0], want)
    t = _single(ck["ph"])
    t.fit(verbose=False, resume_from=str(ck["dir"] / "state_hybrid_allgather"))
    _follows(t.history, want)
    # the segment layout keeps the artifact's order: it resumes too
    s = _single(ck["pt"])
    s.fit(verbose=False, resume_from=str(ck["dir"] / "state_hybrid_allgather"))
    assert len(s.history) == 4


def test_a_sharded_checkpoint_loads_on_one_card(ck):
    """The 3-rank hybrid model (epoch 4) evaluated on the single-card
    hybrid layout gives the sharded run's test loss within 1e-4; the
    single-card hybrid model loaded by the sharded segment trainer (its
    degree sort undone) gives the single card's segment evaluation of the
    same params."""
    sharded_test = ck["first_hybrid_allgather"][1]
    t = _single(ck["ph"])
    t.load(str(ck["dir"] / "model_hybrid_allgather"))
    got = t.evaluate(t.test_idx)
    np.testing.assert_allclose(got["test_loss"], sharded_test["test_loss"], rtol=CROSS_RTOL)
    assert got["acc"] == pytest.approx(sharded_test["acc"])

    state = restore_checkpoint(str(ck["dir"] / "single_hybrid_model"))
    params = dict(state["params"])
    params["gc1.w"] = ttrainer.unlabel(params["gc1.w"], ck["ph"].perm)
    save_checkpoint(str(ck["dir"] / "unlabeled"), params,
                    metadata={**state["metadata"], "node_order": 0})
    s = _single(ck["pt"])
    s.load(str(ck["dir"] / "unlabeled"))
    want = s.evaluate(s.test_idx)
    got = ck["load_single_hybrid"][1]
    np.testing.assert_allclose(got["test_loss"], want["test_loss"], rtol=CROSS_RTOL)
    assert got["acc"] == pytest.approx(want["acc"])


def test_canonical_tables_match_the_jax_checkpoint(ck):
    """The port (2 ranks) and JAX ``ShardedTrainer`` (4 devices) under
    hybrid from the same JAX init, dropout 0, 3 epochs, each saved: JAX's
    checkpoint (``restore_checkpoint``) holds the node table in the
    artifact's order with padding stripped, as the port's does; the tables
    and the second layer agree at f32 tolerance."""
    j = j_restore(str(ck["dir"] / "jax_model"))["params"]
    p = restore_checkpoint(str(ck["dir"] / "port_model"))
    n = ck["dense"][3]
    assert p["metadata"]["node_order"] == 0 and p["metadata"]["n_shards"] == 2
    assert p["params"]["gc1.w"].shape == (n, 16) == np.asarray(j["gc1"]["w"]).shape
    for layer, leaf in (("gc1", "w"), ("gc1", "b"), ("gc2", "w"), ("gc2", "b")):
        np.testing.assert_allclose(p["params"][f"{layer}.{leaf}"].numpy(),
                                   np.asarray(j[layer][leaf]), rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"{layer}.{leaf}")
    _follows(ck["jax_init"][0], ck["jax_history"], rtol=F32_TOL)


def test_a_checkpoint_is_in_the_single_device_schema(ck):
    """Adam's state of a sharded checkpoint has the single-device Trainer's
    layout: positions in the order of the params, node-table moments
    [n_nodes, H]; the metadata carries the Trainer's keys and the mesh."""
    state = restore_checkpoint(str(ck["dir"] / "state_hybrid_allgather"))
    names = list(state["params"])
    moments = ttrainer.adam_by_name(state["opt_state"], names)
    for k, v in state["params"].items():
        assert moments[k]["exp_avg"].shape == v.shape
    md = state["metadata"]
    assert (md["model"], md["n_hidden"], md["node_order"], md["n_shards"], md["partition"],
            md["kernel"], md["epoch"]) == ("gcn", 16, 0, 3, "allgather", "hybrid", 4)
    assert state["params"]["gc1.w"].shape[0] == ck["pt"].graph.n_nodes
    # Adam's state is read by name: the same state with its params and
    # positions in the reverse order resumes to the same bits
    back = names[::-1]
    opt = ttrainer.adam_state_dict(moments, back, state["opt_state"]["param_groups"][0])
    save_checkpoint(str(ck["dir"] / "reversed"), {k: state["params"][k] for k in back},
                    opt_state=opt, metadata=md, generator=state["generator"])
    runs = []
    for path in ("state_hybrid_allgather", "reversed"):
        t = _single(ck["ph"])
        t.fit(verbose=False, resume_from=str(ck["dir"] / path))
        runs.append(t.history)
    assert runs[0] == runs[1] and len(runs[0]) == 4


def _trainer(pre, **kw):
    return ptrainer.ShardedTrainer(
        pre.graph, pre.features, pre.labels.target, pre.labels.train_idx, pre.labels.test_idx,
        N_CLASSES, config=dataclasses.replace(CFG, **kw), n_shards=3, rank=0, device=CPU,
        kernel="hybrid", partition="allgather",
    )


def test_refusals(ck, tmp_path):
    """An early-stopped state, ``restore_best`` and a foreign node order are
    refused (before any collective), as is another family."""
    pt = ck["pt"]
    s = _single(pt, early_stopping=1, max_epoch=50)
    s.fit(verbose=False)
    assert len(s.history) < 50
    s.save_training_state(str(tmp_path / "stopped"))
    with pytest.raises(ValueError, match="early-stopped"):
        _trainer(pt).fit(verbose=False, resume_from=str(tmp_path / "stopped"))
    with pytest.raises(NotImplementedError, match="restore_best"):
        _trainer(pt, restore_best=True)
    foreign = dataclasses.replace(ck["ph"], perm=np.random.RandomState(0).permutation(
        pt.graph.n_nodes))
    f = _single(foreign, max_epoch=1)
    f.fit(verbose=False)
    f.save_training_state(str(tmp_path / "foreign"))
    with pytest.raises(ValueError, match="node order"):
        _trainer(pt).load(str(tmp_path / "foreign"))
    with pytest.raises(ValueError, match="node order"):
        _trainer(pt).fit(verbose=False, resume_from=str(tmp_path / "foreign"))
    with pytest.raises(ValueError, match="'gcn' model"):
        _trainer(pt, model="sgc").load(str(ck["dir"] / "model_hybrid_allgather"))
    # the degree sort a single-card hybrid checkpoint names is this graph's
    row, col, _ = pt.graph.coo_numpy()
    assert np.array_equal(degree_sort_permutation(row, col, pt.graph.n_nodes), ck["ph"].perm)


def test_run_experiment_and_resume_training_sharded(ck, tmp_path):
    """``run_experiment(n_shards=2, save_model=, save_state=)`` reports JAX's
    keys; ``resume_training(n_shards=3)`` of its state reports ``sharding``
    and ``resumed_from`` and follows the straight 3-rank run of the same
    seed; the model evaluates on one card with the run's test accuracy."""
    pt = ck["pt"]
    cfg = dataclasses.replace(CFG, max_epoch=4, spmm="hybrid")
    common = dict(graph_family="docword", pre_data=pt, verbose=False, partition="allgather",
                  device=CPU)
    first = trun.run_experiment("toy", config=cfg, seeds=[CFG.seed], n_shards=2,
                                output_dir=str(tmp_path / "a"), save_model=str(tmp_path / "m"),
                                save_state=str(tmp_path / "s"), **common)
    assert first["checkpoint"] == str(tmp_path / "m")
    assert first["resumable_checkpoint"] == str(tmp_path / "s")
    resumed = trun.resume_training("toy", str(tmp_path / "s"), config=dataclasses.replace(
        cfg, max_epoch=8), n_shards=3, output_dir=str(tmp_path / "b"), **common)
    assert resumed["sharding"] == {"n_shards": 3, "partition": "allgather", "kernel": "hybrid"}
    assert resumed["resumed_from"] == str(tmp_path / "s")
    assert resumed["runs"][0]["seed"] == CFG.seed
    _follows(resumed["runs"][0]["history"], ck["straight_hybrid_allgather"][0][4:])
    with open(tmp_path / "b" / "toy_docword_training_results.json", encoding="utf-8") as fh:
        assert json.load(fh)["sharding"]["n_shards"] == 3
    got = trun.evaluate_checkpoint("toy", str(tmp_path / "m"), graph_family="docword",
                                   pre_data=pt, spmm="hybrid", device=CPU)
    assert got["acc"] == pytest.approx(first["runs"][0]["test"]["acc"])


def test_run_sharded_experiment_returns_the_jax_keys(ck):
    """Two seeds on 2 gloo ranks: JAX's keys, one run a seed."""
    pt = ck["pt"]
    lab = pt.labels
    out = launch.run_sharded_experiment(
        pt.graph, None, lab.target, lab.train_idx, lab.test_idx, N_CLASSES, [1, 2],
        dataclasses.replace(CFG, max_epoch=2), n_shards=2, partition="halo",
        devices=["cpu"] * 2,
    )
    assert set(out) == {"partition", "kernel", "n_shards", "test_accuracy", "runs"}
    assert (out["partition"], out["kernel"], out["n_shards"]) == ("halo", "segment", 2)
    assert [r["seed"] for r in out["runs"]] == [1, 2]
    assert all(set(r) == {"seed", "test", "epochs"} and r["epochs"] == 2 for r in out["runs"])
    accs = [r["test"]["acc"] for r in out["runs"]]
    assert out["test_accuracy"] == {"mean": float(np.mean(accs)), "max": max(accs),
                                    "min": min(accs)}
