"""Run one cell of the port's benchmark once and print its result.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for
(it exits with an error and prints no result otherwise). ``--trace 0``
measures the cell's end-to-end metrics over a window of ``--seconds``;
``--trace 1`` its per-layer metrics over a profiled window of the cell's
``trace_steps``. Both check the program's first steps against the plain
reference and print, as the last lines of standard error and under
``checks`` at the end of the result, each compared number beside its
limit. The last line of standard output is the result, one JSON object.

Build and kernel caches stay in directories of the checkout at fixed paths:
the program's kernels in ``textgcn_tpu_torch/_build/``, the rest under
``.gpubench_cache/``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHES = (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
          ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"))
sys.path.insert(0, str(ROOT))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def finite(v):
    """``v``, or None where the comparison gave no number (strict JSON)."""
    return v if v == v and abs(v) != float("inf") else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative whole number")

    for var, sub in CACHES:
        os.environ[var] = str(ROOT / ".gpubench_cache" / sub)
    import torch

    from gpubench import harness

    chips = harness.load_cell(args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    banned = harness.banned_modules()
    if banned:
        print(f"gpubench: the process loaded {', '.join(banned)}", file=sys.stderr)
        return 3
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": res["peak_bytes"],
    }
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": res["metrics"], "device": device}
    if args.trace:
        s = res["summary"]
        device.update(busy_s=s.busy_s, window_s=s.window_s)
        out["breakdown"] = s.breakdown()
    out["checks"] = {k: {"value": finite(c["value"]), "limit": c["limit"]}
                     for k, c in res["checks"].items()}
    print(f"gpubench: {args.workload} seed {args.seed} on {card_line()}; "
          f"{json.dumps(res['notes'])}", file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
