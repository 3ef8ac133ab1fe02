"""One cell of the benchmark, run once: its inputs from the seed, the
program's train step over them, the measured window, and the comparison
with the plain reference that decides ``correct``.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``gpubench/workloads/<cell>.json`` (the configuration's name, the traffic's
parameters, the limits of the comparison), ``gpubench/configs/<config>.json``
(the sizes, the graph's generator ``graph.kind``, the program's runner
``program``, and ``features``: drawn where absent, ``identity`` for X =
I_N), ``gpubench/traffic/<kind>.py`` (the graph and its ``SMALL`` form for
the CPU tests), ``gpubench/programs/<program>.py`` (the program under test
and its ``FAULTS``),
``gpubench/reference/<family>.py`` (the plain reference and the step's
work) and ``gpubench/metrics/<metric>.py`` (one reader a metric).

The program under test is ``textgcn_tpu_torch``; only the runners under
``gpubench/programs/`` import it, inside the functions that drive it. The
reference and the traffic import none of it.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from gpubench import programs, reference, spans, trace, traffic
from gpubench.traffic import Chunk

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the leaves whose reference gradient is under this share of the median
# leaf's move under Adam by round-off alone: left out of the change
NOUGHT_GRAD = 1e-3
# the comparison's numbers, in the order they are printed
GAPS = ("loss_gap", "grad_gap", "delta_gap")
CHECK_STEPS = 3
# modules that may not be loaded in the process that prints the result
BANNED = ("jax", "jaxlib", "flax", "textgcn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """``{"bench", "entry", "workload", "config"}`` of a cell by name."""
    bench = load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[0]
    wl = load_json(HERE / "workloads" / f"{name}.json")
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"{name}: workload file and BENCHMARK.json disagree")
    cfg = cell_config(load_json(HERE / "configs" / f"{wl['config']}.json"), wl)
    return {"bench": bench, "entry": entry, "workload": wl, "config": cfg}


def cell_config(cfg: dict, wl: dict) -> dict:
    """The configuration as a workload runs it: a mix may draw another
    graph for the same model, its ``graph`` keys over the configuration's."""
    if "graph" not in wl:
        return cfg
    return dict(cfg, graph=dict(cfg["graph"], **wl["graph"]))


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent non-negative 63-bit seeds for the graph, the features
    and the weights, from any non-negative whole number."""
    kids = np.random.SeedSequence(int(seed)).spawn(3)
    vals = [int(k.generate_state(1, np.uint64)[0] >> np.uint64(1)) for k in kids]
    return dict(zip(("graph", "features", "weights"), vals))


class Inputs:
    """What the benchmark hands to both sides: the graph of the
    configuration's generator (its values scaled by ``edge_scale``),
    features, labels, the loss mask, weights. With the configuration's
    ``"features": "identity"`` (X = I_N) ``x`` is None, nothing of [n,
    n_feat] is drawn, and the family's weights are drawn with ``n_feat`` the
    node count."""

    def __init__(self, cfg: dict, seed: int, device):
        s = sub_seeds(seed)
        self.device = torch.device(device)
        self.graph = traffic.make(cfg["graph"], s["graph"], self.device)
        self.scale = float(cfg["edge_scale"])
        n, c = self.graph.n_rows, cfg["n_class"]
        gen = torch.Generator(device=device).manual_seed(s["features"])
        self.y = torch.randint(0, c, (n,), generator=gen, device=device)
        self.x = None
        if cfg.get("features") == "identity":
            cfg = dict(cfg, n_feat=n)
        else:
            # the features carry the label, so that the model can learn
            f = cfg["n_feat"]
            self.x = torch.randn((n, f), generator=gen, device=device,
                                 dtype=torch.bfloat16).mul_(0.1)
            self.x += (torch.arange(f, device=device) % c == self.y[:, None]).to(torch.bfloat16)
        self.mask = (torch.rand(n, generator=gen, device=device) < cfg["train_share"]).float()
        self.weights = draw_weights(reference.family(cfg["family"]).param_shapes(cfg),
                                    s["weights"], device)

    def chunk(self, j: int) -> Chunk:
        ch = self.graph.chunk(j)
        return ch._replace(val=ch.val.mul_(self.scale))

    def chunks(self):
        for j in range(self.graph.n_chunks):
            yield self.chunk(j)


def draw_weights(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Each parameter U(-1/sqrt(n_out), 1/sqrt(n_out)), in ``shapes``'
    order, from one generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in shapes.items():
        s = 1.0 / math.sqrt(shape[-1])
        out[name] = torch.empty(shape, device=device).uniform_(-s, s, generator=gen)
    return out


def build_program(cfg: dict, workload: dict, inputs: Inputs, spans: bool = False):
    """The program's step over ``inputs``, by the configuration's runner
    (``gpubench/programs/<program>.py``)."""
    return programs.runner(cfg["program"]).build(cfg, workload, inputs, spans)


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Readings:
    """Each check step's loss, step 1's gradients, and each parameter's
    change over the check steps."""

    losses: List[float]
    grads: Dict[str, Optional[torch.Tensor]]
    delta: Dict[str, torch.Tensor]


def check_steps(trainer, n: int = CHECK_STEPS) -> Readings:
    """Drive ``trainer`` (the program, the reference or the control)
    through its first ``n`` steps and read them."""
    p0 = trainer.snapshot()
    losses, grads = [], None
    for i in range(n):
        losses.append(trainer.step())
        if i == 0:
            grads = trainer.first_grad()
    p_n = trainer.snapshot()
    return Readings(losses, grads, {k: p_n[k] - p0[k] for k in p0})


def reference_readings(cfg: dict, inputs: Inputs, low: Optional[str] = None) -> Readings:
    """The plain reference's first steps on the same inputs, its graph
    rebuilt from the benchmark's chunks; at ``low`` (the configuration's
    stated narrow dtype by default; the control passes a narrower one)."""
    g = inputs.graph
    graph = reference.Graph(inputs.chunks(), g.n_rows, g.n_edges, inputs.device)
    trainer = reference.ReferenceTrainer(cfg, inputs.weights, graph, inputs.x, inputs.y,
                                         inputs.mask, low or cfg["precision"]["low"])
    out = check_steps(trainer)
    del trainer, graph
    return out


def _norm(t) -> float:
    return math.inf if t is None else float(torch.linalg.vector_norm(t.double()))


def _gap(a: float, b: float, scale: float) -> float:
    g = abs(a - b) / scale if scale > 0 else math.inf
    return g if math.isfinite(g) else math.inf


def gaps(got: Readings, ref: Readings) -> Dict[str, float]:
    """The numbers compared: the worst step's loss gap relative to the
    reference's loss; the worst leaf's gap between the norms of step 1's
    gradients, and between the norms of the parameters' change over the
    check steps, each relative to the larger of that leaf's reference norm
    and the median leaf's. Leaves whose reference gradient is nought to
    rounding are left out of the change (listed under ``left_out``)."""
    loss_gap = max(_gap(a, b, abs(b)) for a, b in zip(got.losses, ref.losses))
    g_ref = {k: _norm(v) for k, v in ref.grads.items()}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(_gap(_norm(got.grads.get(k)), g_ref[k], max(g_ref[k], g_med)) for k in g_ref)
    kept = [k for k in g_ref if g_ref[k] >= NOUGHT_GRAD * g_med]
    d_ref = {k: _norm(ref.delta[k]) for k in kept}
    d_med = statistics.median(d_ref.values())
    delta_gap = max(_gap(_norm(got.delta.get(k)), d_ref[k], max(d_ref[k], d_med)) for k in kept)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap,
            "left_out": sorted(set(g_ref) - set(kept))}


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------


def cell_metrics(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics this cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced (a metric with ``workloads`` where it lists
    the cell, else wherever the end-to-end metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def reader(name: str):
    """``gpubench/metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What the metric readers read: the cell's configuration, workload,
    graph and reference family; the window's record (``window_s``,
    ``steps``, ``step_ends_s``, ``losses``, ``setup_s``, ``peak_bytes``);
    with a trace, ``trace`` (a :class:`gpubench.trace.Summary`),
    ``pass_ms`` and ``spans`` (the second window's
    :class:`gpubench.spans.Window`, with the program's own spans)."""

    def __init__(self, **kw):
        self.trace, self.pass_ms, self.spans = None, [], None
        self.__dict__.update(kw)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, overrides: Optional[dict] = None) -> dict:
    """Run cell ``name`` once and return the result's fields (``metrics``
    by reader, ``checks`` with each compared number and its limit).
    ``overrides`` replaces configuration keys (tests shrink the graph)."""
    cell = load_cell(name)
    cfg = dict(cell["config"], **(overrides or {}))
    wl, dev = cell["workload"], torch.device(device)
    on_cuda = dev.type == "cuda"

    phases = {"imports": time.perf_counter() - t_start}
    inputs = Inputs(cfg, seed, dev)
    prog = build_program(cfg, wl, inputs, spans=traced and on_cuda)
    phases["inputs"] = time.perf_counter() - t_start
    got = check_steps(prog)
    if on_cuda:
        torch.cuda.synchronize(dev)
    counts0 = prog.counters()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    phases["check_steps"] = setup_s
    summary, losses, ends = None, [], []
    if traced:
        if not on_cuda:
            raise RuntimeError("a traced run needs the card")
        summary = trace.profile(prog, wl["trace_steps"])
        steps, window_s, losses = summary.steps, summary.window_s, summary.losses
    else:
        while True:
            losses.append(prog.step())
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if on_cuda:
            torch.cuda.synchronize(dev)
        steps, window_s = len(losses), time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    # a traced run adds the profiler's warm-up step
    per_step = {f"{k}_per_step": (v - counts0[k]) / (steps + int(traced))
                for k, v in prog.counters().items()}
    # a traced run's second window: as many steps again with the program's
    # own spans on (the first one's numbers are read above)
    window = spans.profile(prog, wl["trace_steps"], prog.program_spans) if traced else None
    failed = sum(1 for v in losses if not math.isfinite(v))
    fam = reference.family(cfg["family"])
    ctx = Context(config=cfg, workload=wl, graph=inputs.graph, family=fam, window_s=window_s,
                  steps=steps, step_ends_s=ends, losses=losses, setup_s=setup_s,
                  peak_bytes=peak, trace=summary, pass_ms=prog.pass_ms(), spans=window)
    metrics = {}
    for m in cell_metrics(cell["bench"], name, traced):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    notes = dict(prog.notes(), **per_step)
    if window is not None:
        notes["spans"] = spans.record(window)
    # the program's state goes before the reference runs on the card
    del prog
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_readings(cfg, inputs)
    phases["reference"] = time.perf_counter() - t_ref
    found = gaps(got, ref)
    limits = wl["limits"]
    checks = {k: {"value": found[k], "limit": limits[k]} for k in GAPS}
    correct = failed == 0 and all(found[k] <= limits[k] for k in GAPS)
    g = inputs.graph
    return {
        "correct": correct, "attempted": steps, "failed": failed, "metrics": metrics,
        "peak_bytes": peak, "summary": summary, "checks": checks,
        "notes": dict(notes, n_chunks=g.n_chunks, n_nodes=g.n_rows, n_edges=g.n_edges,
                      losses=got.losses, ref_losses=ref.losses, left_out=found["left_out"],
                      step_s_quartiles=_quartiles(ends), seconds=phases),
    }


def _quartiles(ends: List[float]):
    """Quartiles of the window's step times (None for fewer than 2 steps)."""
    steps = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    return statistics.quantiles(steps, n=4) if len(steps) >= 2 else None


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    import sys

    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))
