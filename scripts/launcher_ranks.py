#!/usr/bin/env python3
"""The smoke's "native prep" and "launcher ranks" phases alone.

    python3 scripts/launcher_ranks.py

Run from the root of a checkout on a GPU machine. It prepares R8 doc-word
on the native graph core (against the numpy path), then starts 2 ranks with
``python -m torch.distributed.run --standalone --nproc_per_node 2`` that
join with ``init_distributed`` and train the hybrid/allgather GCN through
``run_joined``, holding their losses bit for bit against 2 spawned ranks:
over gloo on cuda:0, and, on a machine with two GPUs or more, over NCCL with
rank r on ``local_device()`` (cuda:r). Prints the card's name and power
limit first; exits non-zero if a check fails.
"""
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("launcher_ranks: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    pre = chip_smoke.native_prep_phase(torch.device("cuda"))
    print(chip_smoke.launcher_ranks_phase(pre))
    return 0


if __name__ == "__main__":
    sys.exit(main())
