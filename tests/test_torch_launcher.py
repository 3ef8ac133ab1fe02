"""Ranks that an outside launcher started (``textgcn_tpu_torch.parallel``:
``init_distributed``, ``local_device``, ``process_summary``, ``run_joined``),
on the CPU over gloo, and ``run_experiment``'s report names (C.6).

Two OS processes run ``tests/torch_launcher_worker.py``, which imports no
JAX: once with the launcher's variables set by hand (as the JAX package's
``tests/test_distributed.py`` starts its two processes), once through
``python -m torch.distributed.run --standalone``. Their losses are held bit
for bit against ``run_sharded_seeds`` on 2 spawned ranks, from the same
tiny data (``tests/torch_tiny_data.py``) and seed. Each process is waited
for at most ``WAIT_S``, so a hang fails the test, not the suite."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_tiny_data import build_tiny

from textgcn_tpu_torch.parallel import distributed, launch
from textgcn_tpu_torch.train.checkpoint import restore_checkpoint
from textgcn_tpu_torch.train.prepare import prepare_docword_data, prepare_topic_data
from textgcn_tpu_torch.train.run import run_experiment
from textgcn_tpu_torch.train.trainer import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_launcher_worker.py")
WAIT_S = 120
SEED = 11
CONFIG = dict(n_hidden=8, max_epoch=6, early_stopping=100, spmm="hybrid")
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE", "GROUP_RANK", "ROLE_RANK", "TORCHELASTIC_RUN_ID")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny corpus's data root and its doc-word graph as host arrays in
    an ``.npz`` the workers read, beside the run's spec."""
    root = tmp_path_factory.mktemp("launcher")
    data_root = build_tiny(root, docword=True)
    data = launch.HostData.from_prepared(
        prepare_docword_data("tiny", data_root=data_root, device="cpu")
    )
    np.savez(
        root / "data.npz", row=data.row, col=data.col, val=data.val, n_nodes=data.n_nodes,
        target=data.target, train_idx=data.train_idx, test_idx=data.test_idx,
        n_classes=data.n_classes,
    )
    spec = {"seeds": [SEED], "config": CONFIG, "kernel": "hybrid", "partition": "allgather"}
    (root / "spec.json").write_text(json.dumps(spec))
    return root, data_root, data


@pytest.fixture(scope="module")
def spawned(tiny):
    """The reference: ``run_sharded_seeds`` on 2 spawned gloo ranks."""
    _, _, data = tiny
    return launch.run_sharded_seeds(
        data, [SEED], TrainConfig(**CONFIG), 2, kernel="hybrid", partition="allgather",
        backend="gloo", devices=["cpu"] * 2, timeout_s=60.0,
    )["runs"]


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _wait(procs):
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=WAIT_S)
            outs.append((p.returncode, stdout[-2000:], stderr[-4000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(rc == 0 for rc, _, _ in outs), outs


def _check(out_path, spawned):
    got = json.loads(out_path.read_text())
    n = torch.cuda.device_count()  # both ranks on this machine: global = local
    assert got["summary"] == f"rank 0/2 on cpu (gloo): {n} local / {n} global GPUs"
    (run,), (ref,) = got["runs"], spawned
    assert run["seed"] == ref["seed"] == SEED
    assert len(run["history"]) == len(ref["history"]) == CONFIG["max_epoch"]
    for a, b in zip(run["history"], ref["history"]):
        for k in ("train_loss", "val_loss", "acc"):
            assert a[k] == b[k], (k, a, b)
    for k in ("test_loss", "acc", "macro_f1"):
        assert run["test"][k] == ref["test"][k], k
    return got


def test_ranks_joined_by_hand_set_variables_train_as_spawned_ranks(tiny, spawned, tmp_path):
    """Also the checkpoints: rank 0 writes ``save_model`` and ``save_state``
    of the run (the files a shared file system must hold across machines)."""
    root, _, _ = tiny
    out = tmp_path / "out.json"
    spec = json.loads((root / "spec.json").read_text())
    spec.update(save_model=str(tmp_path / "model"), save_state=str(tmp_path / "state"))
    (tmp_path / "spec.json").write_text(json.dumps(spec))
    port = str(_free_port())
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(root / "data.npz"), str(tmp_path / "spec.json"), str(out)],
            env=_env(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in (0, 1)
    ]
    _wait(procs)
    got = _check(out, spawned)
    assert got["checkpoint"] == spec["save_model"]
    assert got["resumable_checkpoint"] == spec["save_state"]
    model, state = restore_checkpoint(spec["save_model"]), restore_checkpoint(spec["save_state"])
    for ck in (model, state):
        meta = ck["metadata"]
        assert (meta["n_shards"], meta["kernel"], meta["partition"]) == (2, "hybrid", "allgather")
        assert meta["model"] == "gcn" and meta["node_order"] == 0
    assert model["metadata"]["seed"] == SEED
    assert model["metadata"]["epochs_run"] == CONFIG["max_epoch"]
    assert "opt_state" in state and "opt_state" not in model
    for k, v in model["params"].items():
        assert np.array_equal(np.asarray(v), np.asarray(state["params"][k])), k


def test_ranks_started_by_torchrun_train_as_spawned_ranks(tiny, spawned, tmp_path):
    root, _, _ = tiny
    out = tmp_path / "out.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         WORKER, str(root / "data.npz"), str(root / "spec.json"), str(out)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    _wait([proc])
    _check(out, spawned)


def test_init_distributed_is_a_no_op_for_one_process():
    assert not distributed.init_distributed(distributed.DistributedConfig.from_env({}))
    assert not distributed.init_distributed(
        distributed.DistributedConfig.from_env({"WORLD_SIZE": "1", "RANK": "0"})
    )
    assert not dist.is_initialized()
    assert distributed.process_summary() == (
        f"rank 0/1 on {'cuda:0' if torch.cuda.device_count() else 'cpu'} (no group): "
        f"{torch.cuda.device_count()} local / {torch.cuda.device_count()} global GPUs"
    )
    # JAX's rule: more than one process, or an address to meet at
    for env, multi in (
        ({"WORLD_SIZE": "2"}, True), ({"MASTER_ADDR": "h", "MASTER_PORT": "1"}, True),
        ({"SLURM_NTASKS": "1"}, False), ({}, False),
    ):
        assert distributed.DistributedConfig.from_env(env).is_multiprocess is multi


def test_local_device_reads_the_launcher_and_never_guesses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert distributed.local_device({"LOCAL_RANK": "1"}) == torch.device("cuda", 1)
    assert distributed.local_device({"OMPI_COMM_WORLD_LOCAL_RANK": "0"}) == torch.device("cuda", 0)
    assert distributed.local_device({"SLURM_LOCALID": "1", "LOCAL_RANK": "0"}) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="local rank 2 has no GPU"):
        distributed.local_device({"LOCAL_RANK": "2"})
    with pytest.raises(RuntimeError, match="no local rank"):
        distributed.local_device({})
    assert distributed.local_device({}, cpu=True) == torch.device("cpu")


def test_run_joined_needs_a_joined_group(tiny):
    _, _, data = tiny
    with pytest.raises(RuntimeError, match="init_distributed"):
        launch.run_joined(data, [SEED], TrainConfig(**CONFIG), kernel="hybrid",
                          partition="allgather", device="cpu")


def test_topic_gat_names_the_reports_of_the_topic_graph(tiny, tmp_path):
    """C.6, JAX's rule: ``graph_family`` other than ``docword`` reads the
    topic graph and names the reports. With ``pre_data`` (``bench.py``'s GAT
    pass) the dataset name only names them too; without it the topic graph
    is read from the data root. The summary has the keys of the JAX
    package's committed ``R8_topic_gat`` report."""
    _, data_root, _ = tiny
    cfg = TrainConfig(model="gat", spmm="segment", n_hidden=8, max_epoch=3)
    pre = prepare_topic_data("tiny", data_root=data_root, device="cpu")
    out = tmp_path / "with_pre"
    got = run_experiment("R8", seeds=[SEED], graph_family="topic_gat", pre_data=pre,
                         output_dir=str(out), config=cfg, verbose=False, device="cpu")
    with open(os.path.join(REPO, "results", "R8_topic_gat_training_results.json"),
              encoding="utf-8") as f:
        ref = json.load(f)  # written by the JAX package
    written = json.loads((out / "R8_topic_gat_training_results.json").read_text())
    assert (out / "R8_topic_gat_training_results.txt").exists()
    assert set(ref) <= set(written) and set(ref["runs"][0]) <= set(written["runs"][0])
    assert written["graph_family"] == "topic_gat" == got["graph_family"]
    assert written["hyperparameters"]["model"] == "gat"
    again = run_experiment("tiny", seeds=[SEED], graph_family="topic_gat", data_root=data_root,
                           output_dir=str(tmp_path / "read"), config=cfg, verbose=False,
                           device="cpu")
    assert (tmp_path / "read" / "tiny_topic_gat_training_results.txt").exists()
    assert again["runs"][0]["history"] == got["runs"][0]["history"]
