#!/usr/bin/env python3
"""Sweep the compile-time constants of K2 and ``sddmm`` on one GPU.

    python scripts/sweep_kernels.py

Runs on one CUDA GPU (it fails without one). Builds variants of
``textgcn_tpu_torch/csrc/row_reduce.cu`` (K2) and ``csrc/sddmm.cu`` with a
constant set by ``-D`` (``_build.build(defines, srcs)``, every variant's
``nvcc`` started together) and calls each variant's C entry point directly
on R8 doc-word's degree-sorted attention graph, in the roles the GAT
backward gives them:

- K2 as dx over the transpose CSR (softmax weights, a random bf16
  cotangent): S, the most edges a warp walks (``TEXTGCN_K2_S``: 128, 256,
  512, 1024), with a split table built here at each S; and the load width
  (``TEXTGCN_K2_NARROW_F``: 0 reads 16-byte vectors at F = 8 and 16, a
  large value 4-byte vectors at every F; the default 16 is in the S = 512
  row). The load widths also in B11's role: the first chunk of the
  streamed lattice (10M nodes, degree 50, as ``chip_smoke.py``) added onto
  a random base, no split table;
- ``sddmm`` over the forward CSR: the lanes that share an edge
  (``TEXTGCN_SDDMM_LANES``: 1 to 32; the default lets the kernel choose).

Every variant's output is held against the plain PyTorch version. Each time
is given two ways, as ``chip_smoke.py`` gives them: CUDA events around 20
back-to-back calls (a call) and the same calls captured in a CUDA graph
(device). Prints one line per width and one JSON line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from chip_smoke import (  # noqa: E402
    ATT_TOL, K2_TOL, SEED, SLOPE, STREAM_DEG, STREAM_N, compare, cuda_ms, graph_ms,
)
from textgcn_tpu_torch.ops import _build  # noqa: E402
from textgcn_tpu_torch.ops import streamed_sorted as ss  # noqa: E402
from textgcn_tpu_torch.ops import attention as att  # noqa: E402
from textgcn_tpu_torch.ops.row_reduce import (  # noqa: E402
    SEGMENT_EDGES, row_reduce_plain, row_split,
)
from textgcn_tpu_torch.train.prepare import (  # noqa: E402
    apply_attention_format, prepare_docword_data,
)

K2_S = (128, 256, 512, 1024)
K2_NARROW_F = (0, 1 << 20)
SDDMM_LANES = (1, 2, 4, 8, 16, 32)
WIDTHS = (200, 16, 8)
CHUNK_WIDTHS = (16, 8)


def split_table(row_ptr: np.ndarray, s: int):
    """(table, n_seg, n_long): ``row_split``'s table at S = ``s``."""
    rp = row_ptr.astype(np.int64)
    deg = np.diff(rp)
    long_rows = np.flatnonzero(deg > s)
    n_segs = -(-deg[long_rows] // s)
    long_ptr = np.concatenate([[0], np.cumsum(n_segs)])
    seg_row = np.repeat(long_rows, n_segs)
    k = np.arange(long_ptr[-1]) - np.repeat(long_ptr[:-1], n_segs)
    table = np.concatenate([seg_row, rp[seg_row] + k * s, long_ptr]).astype(np.int32)
    return table, int(long_ptr[-1]), len(long_rows)


def both(fn):
    return {"ms": cuda_ms(fn), "device_ms": graph_ms(fn)}


def _stream():
    """The current stream (a CUDA graph captures on its own)."""
    return torch.cuda.current_stream().cuda_stream


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    csrc = _build.CSRC
    variants = (
        [("k2", f"S={s}", [f"TEXTGCN_K2_S={s}"]) for s in K2_S]
        + [("k2", f"S=512 narrow_f={n}", [f"TEXTGCN_K2_NARROW_F={n}"]) for n in K2_NARROW_F]
        + [("sddmm", f"lanes={n}", [f"TEXTGCN_SDDMM_LANES={n}"]) for n in SDDMM_LANES]
    )
    src = {"k2": csrc / "row_reduce.cu", "sddmm": csrc / "sddmm.cu"}
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(lambda v: _build.build(tuple(v[2]), [src[v[0]]]), variants))
    libs = [_build.open_library(p) for p in paths]

    pre = apply_attention_format(prepare_docword_data("R8", device=dev), degree_sort=True)
    ag = pre.graph
    rp_t = ag.row_ptr_t.cpu().numpy()
    want_table = row_split(rp_t).table.cpu().numpy()
    if not np.array_equal(split_table(rp_t, SEGMENT_EDGES)[0], want_table):
        raise AssertionError("the sweep's split table differs from row_split's")
    tables = {}
    for s in K2_S:
        table, n_seg, n_long = split_table(rp_t, s)
        tables[s] = (torch.from_numpy(table).to(dev), n_seg, n_long)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = ag.n_nodes
    es = torch.randn(n, generator=gen, device=dev)
    ed = torch.randn(n, generator=gen, device=dev)
    logits, mx, sm = att.stats_logits_plain(ag.row_ptr, ag.col, ag.logval, es, ed, SLOPE)
    w_t = att.edge_weights(ag, logits, mx, sm).index_select(0, ag.perm_t)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; R8 attention graph "
          f"{n} rows, {ag.n_edges} edges; transpose CSR segments by S: "
          f"{', '.join(f'{s} {tables[s][1]}' for s in K2_S)}")

    results = []
    for f in WIDTHS:
        x16 = torch.randn((n, f), generator=gen, device=dev).bfloat16()
        g16 = torch.randn((n, f), generator=gen, device=dev).bfloat16()
        dx_want = row_reduce_plain(ag.row_ptr_t, ag.col_t, w_t, g16)
        u_want = att.sddmm_plain(ag.row_ptr, ag.col, g16, x16)
        out = torch.empty(n, f, device=dev)
        line = []
        for (kind, name, defines), lib in zip(variants, libs):
            if kind == "k2":
                s = int(dict(d.split("=") for d in defines).get("TEXTGCN_K2_S", SEGMENT_EDGES))
                if lib.textgcn_row_reduce_segment_edges() != s:
                    raise AssertionError(f"{name}: built for another S")
                table, n_seg, n_long = tables[s]
                partial = torch.empty(n_seg, f, device=dev)

                def call(lib=lib, name=name, table=table, partial=partial, n_seg=n_seg,
                         n_long=n_long):
                    _build.check_launch(name, lib.textgcn_row_reduce(
                        ag.row_ptr_t.data_ptr(), ag.col_t.data_ptr(), w_t.data_ptr(),
                        g16.data_ptr(), out.data_ptr(), table.data_ptr(),
                        partial.data_ptr(), n, f, 0, n_seg, n_long, _stream()))
                    return out

                got, want = call(), dx_want
            else:
                u = torch.empty(ag.n_edges, device=dev)

                def call(lib=lib, name=name, u=u):
                    _build.check_launch(name, lib.textgcn_sddmm(
                        ag.row.data_ptr(), ag.col.data_ptr(), g16.data_ptr(),
                        x16.data_ptr(), u.data_ptr(), ag.n_edges, f // att.VEC, _stream()))
                    return u

                got, want = call(), u_want
            err, _ = compare(got, want, ATT_TOL)
            rec = {"kernel": kind, "variant": name, "f": f, "max_abs_err": err, **both(call)}
            results.append(rec)
            line.append(f"{kind} {name} {rec['ms']:.4f} ({rec['device_ms']:.4f})")
        print(f"F={f}: " + "; ".join(line) + f" ms a call (device); tol {ATT_TOL}*(1+|ref|)")
        del x16, g16, out, dx_want, u_want

    # B11's role: K2 with a base on one lattice chunk, by load width
    lattice = ss.make_lattice_stream(*ss.lattice_config(STREAM_N, STREAM_DEG), seed=SEED,
                                     device=dev)
    chunk = lattice.chunk(0)
    for f in CHUNK_WIDTHS:
        x = torch.randn((lattice.n_rows, f), generator=gen, device=dev).bfloat16()
        base = torch.randn((chunk.rows, f), generator=gen, device=dev)
        want = row_reduce_plain(chunk.row_ptr, chunk.col, chunk.val, x, base.clone())
        line = []
        for (kind, name, defines), lib in zip(variants, libs):
            other_s = defines[0].startswith("TEXTGCN_K2_S=") and name != f"S={SEGMENT_EDGES}"
            if kind != "k2" or other_s:
                continue  # with no split table S is not used
            acc = base.clone()

            def call(lib=lib, name=name, acc=acc):
                _build.check_launch(name, lib.textgcn_row_reduce(
                    chunk.row_ptr.data_ptr(), chunk.col.data_ptr(), chunk.val.data_ptr(),
                    x.data_ptr(), acc.data_ptr(), None, None, chunk.rows, f, 1, 0, 0,
                    _stream()))
                return acc

            err, _ = compare(call(), want, K2_TOL)
            rec = {"kernel": "k2 chunk", "variant": name, "f": f, "max_abs_err": err,
                   **both(call)}
            results.append(rec)
            line.append(f"{name} {rec['ms']:.4f} ({rec['device_ms']:.4f})")
        print(f"B11 chunk ({chunk.rows} rows, {chunk.n_edges} edges) F={f}: "
              + "; ".join(line) + f" ms a call (device); tol {K2_TOL}*(1+|ref|)")
        del x, base, want
    print(json.dumps({"device": smi, "sweep": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
