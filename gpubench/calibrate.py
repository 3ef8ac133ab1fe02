"""Readings that the limits of a cell's comparison are set from.

    python3 gpubench/calibrate.py --cells <cell,...> --seeds <n> --first-seed <s> [--out FILE]

For each cell and seed, in one process on the card and at the cell's own
sizes: the program's first steps on that seed (sound runs: the lower
reading), the same with each fault of the cell's runner planted
(:func:`faults_run`) on the first 3 seeds, and the control
(the reference at the precision one step below the configuration's) on
the first 3, each compared with the reference by
``harness.gaps``. One JSON line a reading, on standard output and in
``--out``. Not run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# seeds of the faults and of the control
SPECIAL_SEEDS = 3


def faults_run(cell: str) -> tuple:
    """The faults planted in ``cell``: its runner's own (``FAULTS`` of
    ``gpubench/programs/<runner>.py``); ``state_unchanged`` reads 1 on
    ``delta_gap`` by definition and needs no run."""
    from gpubench import harness, programs

    return tuple(programs.runner(harness.load_cell(cell)["config"]["program"]).FAULTS)


def readings(cell: str, seed: int, dev, faults, control: bool, overrides=None) -> list:
    """One seed's readings of ``cell``: the program's, each of ``faults``'
    and, with ``control``, the control's, as rows of gaps against the
    reference; ``overrides`` replaces configuration keys (tests shrink the
    graph)."""
    import torch

    from gpubench import harness, reference
    from gpubench.faults import for_program

    c = harness.load_cell(cell)
    cfg, wl = dict(c["config"], **(overrides or {})), c["workload"]
    inputs = harness.Inputs(cfg, seed, dev)
    planted = for_program(cfg["program"])
    runs = {}
    for kind in ("program", *faults):
        t0 = time.perf_counter()
        ctx = contextlib.nullcontext() if kind == "program" else planted[kind]()
        with ctx:
            prog = harness.build_program(cfg, wl, inputs)
            runs[kind] = (harness.check_steps(prog), time.perf_counter() - t0)
        del prog
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = harness.reference_readings(cfg, inputs)
    ref_s = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        low = reference.NARROWER[cfg["precision"]["low"]]
        runs["control"] = (harness.reference_readings(cfg, inputs, low), time.perf_counter() - t0)
    out = []
    for kind, (r, secs) in runs.items():
        out.append({"cell": cell, "seed": seed, "kind": kind, "gaps": harness.gaps(r, ref),
                    "losses": r.losses, "ref_losses": ref.losses, "seconds": secs,
                    "ref_seconds": ref_s})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    try:
        for cell in args.cells.split(","):
            faults = faults_run(cell)
            for i in range(args.seeds):
                seed = args.first_seed + 7919 * i
                special = i < SPECIAL_SEEDS
                rows = readings(cell, seed, dev, faults if special else (), special)
                for row in rows:
                    line = json.dumps(row)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
                        out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
