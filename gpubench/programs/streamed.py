"""The streamed train step of ``textgcn_tpu_torch``: ``init_streamed``
builds the parameters and Adam, ``STREAMED_SEGMENTED_FACTORIES[family]``
the step over ``make_sorted_stream`` of a ``CachedChunkSource`` of the
benchmark's chunks. The workload's ``device_share`` says which share of
the chunks the cache keeps on the card; the rest sit in page-locked host
memory and are copied in on every pass.

``FAULTS``: the faults planted in this path (``gpubench/faults.py``).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Optional

import torch

from gpubench import yardstick


@contextlib.contextmanager
def half_batch():
    """The loss leaves out the second half of the rows and takes the mean
    over the rest."""
    from textgcn_tpu_torch.train import streamed as st

    orig = st._masked_ce

    def half(logits, y, mask, count=None):
        h = logits.shape[0] // 2
        return orig(logits[:h], y[:h], mask[:h], count)

    st._masked_ce = half
    try:
        yield
    finally:
        st._masked_ce = orig


@contextlib.contextmanager
def chunks_left_out():
    """Every streamed pass reduces every other chunk only."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss

    orig = ss.streamed_sorted_add_

    def skip(acc, chunks, x, reduce=ss.row_reduce):
        return orig(acc, itertools.islice(chunks, 0, None, 2), x, reduce)

    ss.streamed_sorted_add_ = skip
    try:
        yield
    finally:
        ss.streamed_sorted_add_ = orig


FAULTS = {"half_batch": half_batch, "chunks_left_out": chunks_left_out}


def build(cfg: dict, workload: dict, inputs, spans: bool = False) -> "Streamed":
    return Streamed(cfg, workload, inputs, spans)


def chunk_source(inputs, device_share: float):
    """The program's ``CachedChunkSource`` over the graph: the first
    ``floor(share * n_chunks)`` chunks are generated on the device and kept
    there (the budget holds exactly them); the rest sit in page-locked host
    memory and are copied in on every pass."""
    from textgcn_tpu_torch.ops.streamed_sorted import CachedChunkSource, SortedChunk

    g = inputs.graph
    n_dev = yardstick.device_chunks(g, device_share)
    host = host_chunks(inputs, range(n_dev, g.n_chunks))

    def load(i: int):
        return SortedChunk(*inputs.chunk(i)) if i < n_dev else host[i - n_dev]

    budget = yardstick.chunks_bytes(g, range(n_dev))
    return CachedChunkSource(load, g.n_chunks, budget, inputs.device), n_dev


def host_chunks(inputs, idx) -> list:
    """Chunks ``idx`` copied to the host, as views of one page-locked
    buffer per field (plain memory without CUDA)."""
    from textgcn_tpu_torch.ops.streamed_sorted import SortedChunk

    idx = list(idx)
    if not idx:
        return []
    g, pin = inputs.graph, inputs.device.type == "cuda"
    shapes = [g.chunk_shape(j) for j in idx]
    sizes = [[s.rows + 1 for s in shapes], [s.edges for s in shapes], [s.edges for s in shapes]]
    bufs = [torch.empty(sum(k), dtype=d, pin_memory=pin)
            for k, d in zip(sizes, (torch.int32, torch.int32, torch.float32))]
    out, at = [], [0, 0, 0]
    for j in idx:
        ch = inputs.chunk(j)
        views = []
        for f, (b, t) in enumerate(zip(bufs, (ch.row_ptr, ch.col, ch.val))):
            views.append(b[at[f]:at[f] + t.numel()].copy_(t))
            at[f] += t.numel()
        out.append(SortedChunk(*views, ch.r0))
    return out


class PassSpans:
    """The stream handed to the step, with CUDA events around each pass
    while ``on``: the stream layer's span, from the benchmark's side."""

    def __init__(self, stream):
        self.stream, self.on, self.events = stream, False, []

    def __call__(self, v):
        if not self.on:
            return self.stream(v)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.stream(v)
        b.record()
        self.events.append((a, b))
        return out

    def spans_ms(self) -> List[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


class Streamed:
    """The program's step on the benchmark's inputs, with the benchmark's
    weights loaded into the program's parameters and the configuration's
    Adam settings into its optimizer."""

    def __init__(self, cfg: dict, workload: dict, inputs, spans: bool):
        from textgcn_tpu_torch.ops.row_reduce import row_reduce
        from textgcn_tpu_torch.train import streamed as st

        dev = inputs.device
        self.src, self.n_dev = chunk_source(inputs, workload["device_share"])
        stream = st.make_sorted_stream(self.src)
        self.spans = PassSpans(stream) if spans else None
        n, f, h, c = inputs.graph.n_rows, cfg["n_feat"], cfg["n_hidden"], cfg["n_class"]
        opt_cfg = cfg["optimizer"]
        params, opt = st.init_streamed(torch.Generator(device=dev).manual_seed(0), f, h, c,
                                       device=dev, lr=cfg["learning_rate"], family=cfg["family"])
        want = {k: tuple(w.shape) for k, w in inputs.weights.items()}
        have = {k: tuple(p.shape) for k, p in params.items()}
        if want != have:
            raise RuntimeError(f"the program's parameters {have} are not the reference's {want}")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(inputs.weights[k])
        for group in opt.param_groups:
            group.update(lr=cfg["learning_rate"], betas=tuple(opt_cfg["betas"]),
                         eps=opt_cfg["eps"])
        factory = st.STREAMED_SEGMENTED_FACTORIES[cfg["family"]]
        self._step = factory(self.spans or stream, n, opt, **cfg.get("step_kwargs", {}))
        self.params, self.opt = params, opt
        self.x, self.y, self.mask = inputs.x, inputs.y, inputs.mask
        self._row_reduce = row_reduce

    def step(self) -> float:
        return self._step(self.params, self.x, self.y, self.mask).item()

    def first_grad(self) -> Dict[str, Optional[torch.Tensor]]:
        """``exp_avg / (1 - beta1)`` after step 1: the gradient Adam got."""
        out = {}
        for k, p in self.params.items():
            group = next(g for g in self.opt.param_groups if any(q is p for q in g["params"]))
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[k] = None if m is None else m.detach().float() / (1.0 - group["betas"][0])
        return out

    def snapshot(self) -> Dict[str, torch.Tensor]:
        return {k: p.detach().float().clone() for k, p in self.params.items()}

    def record_spans(self, on: bool) -> None:
        if self.spans is not None:
            self.spans.on = on

    def program_spans(self, on: bool) -> list:
        """The program's own span recorder switched ``on`` or off; what it
        recorded since it was last switched."""
        from textgcn_tpu_torch.utils.profiling import record_spans

        return record_spans(on)

    def pass_ms(self) -> List[float]:
        return self.spans.spans_ms() if self.spans is not None else []

    def counters(self) -> Dict[str, int]:
        """K2's launches (``row_reduce.launches``) and the source's loads
        of chunks it does not keep (``host_loads``)."""
        return {"k2_launches": self._row_reduce.launches, "chunk_loads": self.src.host_loads}

    def notes(self) -> dict:
        return {"device_chunks": self.n_dev}
