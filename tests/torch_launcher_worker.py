"""One rank of a sharded run that an outside launcher started: ``torchrun``,
or a process with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK`` set by hand. It imports neither JAX nor ``textgcn_tpu``.

    python tests/torch_launcher_worker.py DATA.npz SPEC.json OUT.json

``DATA.npz`` holds a :class:`~textgcn_tpu_torch.parallel.launch.HostData`'s
arrays, ``SPEC.json`` the seeds, ``TrainConfig`` fields, kernel and
partition, and optionally ``save_model`` / ``save_state`` directories. The
rank joins over gloo on the CPU (``init_distributed``), trains through
``run_joined``, and rank 0 writes its result (runs and checkpoint paths)
and its ``process_summary`` line to ``OUT.json``.
"""
import json
import sys

import numpy as np
import torch

from textgcn_tpu_torch.parallel import distributed, launch
from textgcn_tpu_torch.train.trainer import TrainConfig


def main(data_path: str, spec_path: str, out_path: str) -> int:
    z = np.load(data_path)
    data = launch.HostData(
        z["row"], z["col"], z["val"], int(z["n_nodes"]), None, z["target"], z["train_idx"],
        z["test_idx"], int(z["n_classes"]),
    )
    with open(spec_path, encoding="utf-8") as f:
        spec = json.load(f)
    if not distributed.init_distributed(backend="gloo", timeout_s=60.0):
        raise RuntimeError("the launcher's environment names no multi-process job")
    device = distributed.local_device(cpu=True)
    try:
        summary = distributed.process_summary(device)
        out = launch.run_joined(
            data, spec["seeds"], TrainConfig(**spec["config"]), kernel=spec["kernel"],
            partition=spec["partition"], device=device, save_model=spec.get("save_model"),
            save_state=spec.get("save_state"),
        )
    finally:
        torch.distributed.destroy_process_group()
    if out is not None:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump({**out, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
