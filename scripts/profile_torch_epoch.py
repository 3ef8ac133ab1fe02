#!/usr/bin/env python3
"""Where a steady R8 epoch of the PyTorch port spends its time.

    python scripts/profile_torch_epoch.py [--graph docword|topic] [--model gat]
        [--spmm hybrid] [--epochs 20] [--warmup 10]

Runs on one CUDA GPU (it fails without one). It prepares R8's ``--graph``
(doc-word by default) in the ``--spmm`` layout of ``--model`` (any family)
as ``train/run.py`` does, with ``sgc_pre``'s precompute, and builds the
trainer the CLI runs (``train/trainer.py`` ``Trainer``). One
``fit`` of ``--warmup`` epochs builds the kernels and warms the allocator;
a second ``fit`` of ``--epochs`` epochs runs under ``torch.profiler``
(early stopping off in both, so every epoch runs). ``fit`` draws a fresh
model, so the profiled window also holds the parameter init, once. It
prints the steady ms/epoch (the trainer's own clock), the device's busy and
idle shares (kernel time over wall time; one stream, so kernels do not
overlap) and each kernel's device time per epoch and calls, largest first,
then one JSON line of the same.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import warnings

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from textgcn_tpu_torch.models import MODELS  # noqa: E402
from textgcn_tpu_torch.train.prepare import apply_spmm_format  # noqa: E402
from textgcn_tpu_torch.train.run import (  # noqa: E402
    apply_gat_format, apply_sgc_precompute, prepare_data,
)
from textgcn_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph", choices=("docword", "topic"), default="docword")
    ap.add_argument("--model", choices=sorted(MODELS), default="gat")
    ap.add_argument("--spmm", default="hybrid")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_epoch: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    pre = prepare_data("R8", args.graph, "data", device=dev)
    if args.model == "gat":
        pre = apply_gat_format(pre, args.spmm)
    else:
        pre = apply_spmm_format(pre, args.spmm)
    if args.model == "sgc_pre":
        pre = apply_sgc_precompute(pre, device=dev)
    lab = pre.labels
    trainer = Trainer(
        pre.graph, pre.features, lab.target, lab.train_idx, lab.test_idx,
        lab.n_classes, TrainConfig(model=args.model, spmm=args.spmm, seed=args.seed),
        device=dev,
    )

    def fit(epochs):
        # patience past the last epoch: no early stop
        trainer.cfg = dataclasses.replace(trainer.cfg, max_epoch=epochs, early_stopping=epochs + 1)
        trainer.history = []
        trainer.fit(verbose=False)
        return trainer.train_time

    fit(args.warmup)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    warnings.filterwarnings("ignore", message=".*clears events")
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = 1e3 * fit(args.epochs) / args.epochs
    if len(trainer.history) != args.epochs:
        raise AssertionError(f"fit ran {len(trainer.history)} of {args.epochs} epochs")
    # kernels and copies only: device-side events, without the ranges that
    # annotate them (such as "Optimizer.step#Adam.step", which would count
    # Adam's kernels twice)
    kernels = {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0) or 0
        annotation = getattr(evt, "is_user_annotation", False) or "#" in evt.key
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA and not annotation:
            name = evt.key
            ms, calls = kernels.get(name, (0.0, 0))
            kernels[name] = (ms + dev_us / 1e3 / args.epochs, calls + evt.count)
    busy_ms = sum(ms for ms, _ in kernels.values())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    print(f"{args.model} R8 {args.graph} --spmm {args.spmm}: {wall_ms:.3f} ms/epoch over "
          f"{args.epochs} epochs of Trainer.fit (after a fit of {args.warmup}); "
          f"device busy {busy_ms:.3f} ms/epoch ({100 * busy_ms / wall_ms:.1f}%, idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    if not kernels:
        print("the profiler recorded no device time")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    for name, (ms, calls) in top[:15]:
        print(f"  {ms:8.4f} ms/epoch {100 * ms / max(busy_ms, 1e-9):5.1f}%  "
              f"{calls / args.epochs:5.1f} calls/epoch  {name[:100]}")
    print(json.dumps({
        "model": args.model, "graph": args.graph, "spmm": args.spmm,
        "ms_per_epoch": wall_ms, "device_busy_ms": busy_ms,
        "kernels": [{"name": n, "ms_per_epoch": ms, "calls_per_epoch": c / args.epochs}
                    for n, (ms, c) in top[:15]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
