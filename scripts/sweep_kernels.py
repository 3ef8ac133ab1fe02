#!/usr/bin/env python3
"""Sweep the compile-time constants of K1, K2, ``attn_agg``, ``sddmm``,
``attn_stats`` and ``rowsum`` on one GPU.

    python scripts/sweep_kernels.py [--only k1,attn_agg,k2,sddmm,attn_stats,rowsum]

Runs on one CUDA GPU (it fails without one). Builds variants of
``textgcn_tpu_torch/csrc/bsr_spmm.cu`` (K1), ``csrc/attn_agg.cu``,
``csrc/row_reduce.cu`` (K2) and ``csrc/sddmm.cu`` with a constant set by
``-D`` (``_build.build(defines, srcs)``, every variant's ``nvcc`` started
together) and calls each variant's C entry point directly on R8 doc-word,
with a split table built here for the variant's segment length:

- K1 on the hybrid layout's tile stack (F'=208 and 16) and on the tile
  block of rank 0 of 4 shards (B10's hub rank): T, the most tiles a block
  walks (``TEXTGCN_K1_T``: 8, 16, 32, 64, and no split table), with 4 and
  6 half-tile stages in the ``cp.async`` ring (``TEXTGCN_K1_STAGES``: two
  and three tiles in flight; 6 fit only up to F'=144, so at F'=208 the
  6-stage build runs 4 and is not timed);
- ``attn_agg`` over the forward CSR of the degree-sorted attention graph
  (softmax weights from random logits, F=200 and 8): S, the most edges a
  warp walks (``TEXTGCN_K2_S``: 256, 512, 1024; the same constant as
  K2's);
- ``attn_stats`` over the forward CSR in B5 mode (logits built from random
  es and ed) and B6 mode (given logits), and ``rowsum`` over the forward
  and the transpose CSR (random values): S (``TEXTGCN_K2_S``: 256, 512,
  1024), each with a table built at that S, and at the default S without a
  table (one warp a row);

and, on the attention graph, in the roles the GAT backward gives them:

- K2 as dx over the transpose CSR (softmax weights, a random bf16
  cotangent): S, the most edges a warp walks (``TEXTGCN_K2_S``: 128, 256,
  512, 1024), with a split table built at each S; and the load width
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
(device). Prints one line per width (or mode, or CSR) and one JSON line;
``--only`` runs a subset of the kernels.
"""
from __future__ import annotations

import argparse
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
    ATT_TOL, K1_TOL, K2_TOL, SEED, SHARDS, SLOPE, STREAM_DEG, STREAM_N, compare, cuda_ms,
    graph_ms,
)
from textgcn_tpu_torch.graph.format import convert_graph  # noqa: E402
from textgcn_tpu_torch.ops import _build  # noqa: E402
from textgcn_tpu_torch.ops.bsr_spmm import SEGMENT_TILES, bsr_spmm_plain  # noqa: E402
from textgcn_tpu_torch.ops.split import RowSplit, TileSplit, build_split  # noqa: E402
from textgcn_tpu_torch.parallel.mesh_kernels import MeshHybridAllGather  # noqa: E402
from textgcn_tpu_torch.ops import streamed_sorted as ss  # noqa: E402
from textgcn_tpu_torch.ops import attention as att  # noqa: E402
from textgcn_tpu_torch.ops.row_reduce import SEGMENT_EDGES, row_reduce_plain  # noqa: E402
from textgcn_tpu_torch.train.prepare import (  # noqa: E402
    apply_attention_format, prepare_docword_data,
)

K1_T = (8, 16, 32, 64)
K1_STAGES = (4, 6)
K1_WIDTHS = (208, 16)
AGG_S = (256, 512, 1024)
AGG_WIDTHS = (200, 8)
KINDS = ("k1", "attn_agg", "k2", "sddmm", "attn_stats", "rowsum")
K2_S = (128, 256, 512, 1024)
K2_NARROW_F = (0, 1 << 20)
SDDMM_LANES = (1, 2, 4, 8, 16, 32)
WIDTHS = (200, 16, 8)
CHUNK_WIDTHS = (16, 8)


def both(fn):
    return {"ms": cuda_ms(fn), "device_ms": graph_ms(fn)}


def _stream():
    """The current stream (a CUDA graph captures on its own)."""
    return torch.cuda.current_stream().cuda_stream


def k1_sweep(variants, libs, pre, gen, results):
    """K1 by T and stages on R8's tile stack and on rank 0's shard block."""
    dev = pre.features.device if pre.features is not None else torch.device("cuda")
    h, perm = convert_graph(pre.graph, "hybrid")
    row, col, val = pre.graph.coo_numpy()
    rank0 = MeshHybridAllGather.from_coo(perm[row], perm[col], val, h.n_nodes, SHARDS, 0,
                                         device=h.bsr.blocks.device)
    stacks = {"R8": (h.bsr, h.bsr.n_block_rows * 128), "rank0": (rank0.bsr, rank0.n_pad)}
    for where, (b, n_x) in stacks.items():
        tp = b.tile_ptr.cpu().numpy()
        tables = {t: build_split(tp, t, TileSplit, b.tile_ptr.device) for t in K1_T}
        print(f"K1 {where}: {b.nnzb} tiles in {b.n_block_rows} block-rows (max "
              f"{int(np.diff(tp).max())}); segments by T: "
              f"{', '.join(f'{t} {0 if sp is None else sp.n_seg}' for t, sp in tables.items())}")
        for fp in K1_WIDTHS:
            x = torch.randn((n_x, fp), generator=gen, device=b.blocks.device).bfloat16()
            want = bsr_spmm_plain(b.blocks, b.tile_ptr, b.block_cols, x)
            out = torch.empty_like(want)
            line = []
            for (kind, name, defines), lib in zip(variants, libs):
                if kind != "k1":
                    continue
                d = dict(kv.split("=") for kv in defines)
                t, stages = int(d["TEXTGCN_K1_T"]), int(d["TEXTGCN_K1_STAGES"])
                if stages > 4 and fp > 144:
                    continue  # six stages do not fit: the build runs four
                for sp in ([tables[t]] + ([None] if t == SEGMENT_TILES else [])):
                    label = f"{name}" if sp is not None else f"no split stages={stages}"
                    part = None if sp is None else torch.empty(
                        (sp.n_seg, 128, fp), device=b.blocks.device)

                    def call(lib=lib, sp=sp, part=part, label=label):
                        _build.check_launch(label, lib.textgcn_bsr_spmm(
                            b.blocks.data_ptr(), b.tile_ptr.data_ptr(), b.block_cols.data_ptr(),
                            x.data_ptr(), out.data_ptr(),
                            None if sp is None else sp.table.data_ptr(),
                            None if part is None else part.data_ptr(), b.n_block_rows, fp,
                            0 if sp is None else sp.n_seg, 0 if sp is None else sp.n_long,
                            _stream()))
                        return out

                    err, _ = compare(call(), want, K1_TOL)
                    rec = {"kernel": f"k1 {where}", "variant": label, "f": fp,
                           "max_abs_err": err, **both(call)}
                    results.append(rec)
                    line.append(f"{label} {rec['ms']:.4f} ({rec['device_ms']:.4f})")
            print(f"K1 {where} F'={fp}: " + "; ".join(line)
                  + f" ms a call (device); tol {K1_TOL}*(1+|ref|)")


def agg_sweep(variants, libs, ag, logits, mx, sm, gen, results):
    """attn_agg by S over the forward CSR."""
    rp = ag.row_ptr.cpu().numpy()
    tables = {s: build_split(rp, s, RowSplit, ag.row_ptr.device) for s in AGG_S}
    print(f"attn_agg forward CSR segments by S: "
          f"{', '.join(f'{s} {sp.n_seg}' for s, sp in tables.items())}")
    n = ag.n_nodes
    for f in AGG_WIDTHS:
        x16 = torch.randn((n, f), generator=gen, device=ag.col.device).bfloat16()
        want = att.attn_agg_plain(ag.row_ptr, ag.col, logits, mx, sm, x16)
        out = torch.empty_like(want)
        line = []
        for (kind, name, defines), lib in zip(variants, libs):
            if kind != "attn_agg":
                continue
            sp = tables[int(defines[0].split("=")[1])]
            part = torch.empty((sp.n_seg, f), device=x16.device)

            def call(lib=lib, sp=sp, part=part, name=name):
                _build.check_launch(name, lib.textgcn_attn_agg(
                    ag.row_ptr.data_ptr(), ag.col.data_ptr(), logits.data_ptr(),
                    mx.data_ptr(), sm.data_ptr(), x16.data_ptr(), out.data_ptr(),
                    sp.table.data_ptr(), part.data_ptr(), n, f // att.VEC, sp.n_seg,
                    sp.n_long, _stream()))
                return out

            err, _ = compare(call(), want, ATT_TOL)
            rec = {"kernel": "attn_agg", "variant": name, "f": f, "max_abs_err": err,
                   **both(call)}
            results.append(rec)
            line.append(f"{name} {rec['ms']:.4f} ({rec['device_ms']:.4f})")
        print(f"attn_agg F={f}: " + "; ".join(line)
              + f" ms a call (device); tol {ATT_TOL}*(1+|ref|)")


def _s_variants(variants, libs, kind):
    """(name, S, lib) of each ``kind`` variant, built at S = TEXTGCN_K2_S."""
    return [(name, int(defines[0].split("=")[1]), lib)
            for (k, name, defines), lib in zip(variants, libs) if k == kind]


def _timed(results, kernel, name, mode, call, want, tol):
    """Hold ``call()`` against ``want`` (a tensor or a tuple of them), time
    it, record it and return its line entry."""
    got = call()
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    err = max(compare(a, b, tol)[0] for a, b in zip(got, want))
    rec = {"kernel": kernel, "variant": name, "mode": mode, "max_abs_err": err, **both(call)}
    results.append(rec)
    return f"{name} {rec['ms']:.4f} ({rec['device_ms']:.4f})"


def stats_sweep(variants, libs, ag, es, ed, results):
    """attn_stats by S over the forward CSR, in B5 and B6 mode, and at the
    default S without a table."""
    rp = ag.row_ptr.cpu().numpy()
    n, dev = ag.n_nodes, ag.col.device
    want = att.stats_logits_plain(ag.row_ptr, ag.col, ag.logval, es, ed, SLOPE)
    given = want[0].clone()
    logits, mx, sm = torch.empty_like(given), torch.empty(n, device=dev), torch.empty(n, device=dev)
    runs = []
    for name, s, lib in _s_variants(variants, libs, "attn_stats"):
        sp = build_split(rp, s, RowSplit, dev)
        runs.append((name, lib, sp))
        if s == SEGMENT_EDGES:
            runs.append((f"S={s} no table", lib, None))
    print(f"attn_stats forward CSR segments by S: "
          f"{', '.join(f'{name} {0 if sp is None else sp.n_seg}' for name, _, sp in runs)}")
    for mode in ("B5", "B6"):
        line = []
        for name, lib, sp in runs:
            part = None if sp is None else torch.empty((sp.n_seg, 2), device=dev)

            def call(lib=lib, sp=sp, part=part, name=name, build=mode == "B5"):
                _build.check_launch(name, lib.textgcn_attn_stats(
                    ag.row_ptr.data_ptr(), ag.col.data_ptr(), ag.logval.data_ptr(),
                    es.data_ptr(), ed.data_ptr(),
                    (logits if build else given).data_ptr(), mx.data_ptr(), sm.data_ptr(),
                    None if sp is None else sp.table.data_ptr(),
                    None if part is None else part.data_ptr(), n, SLOPE, int(build),
                    0 if sp is None else sp.n_seg, 0 if sp is None else sp.n_long, _stream()))
                return (logits, mx, sm) if build else (mx, sm)

            line.append(_timed(results, "attn_stats", name, mode, call,
                               want if mode == "B5" else want[1:], ATT_TOL))
        print(f"attn_stats {mode}: " + "; ".join(line)
              + f" ms a call (device); tol {ATT_TOL}*(1+|ref|)")


def rowsum_sweep(variants, libs, ag, gen, results):
    """rowsum by S over the forward and the transpose CSR, and at the
    default S without a table."""
    dev = ag.col.device
    v = torch.randn(ag.n_edges, generator=gen, device=dev)
    out = torch.empty(ag.n_nodes, device=dev)
    for csr, ptr, vals in (("forward", ag.row_ptr, v),
                           ("transpose", ag.row_ptr_t, v.index_select(0, ag.perm_t))):
        rp = ptr.cpu().numpy()
        want = att.rowsum_plain(ptr, vals)
        line = []
        for name, s, lib in _s_variants(variants, libs, "rowsum"):
            sp = build_split(rp, s, RowSplit, dev)
            for sp_, label in ([(sp, name)] + ([(None, f"S={s} no table")]
                                              if s == SEGMENT_EDGES else [])):
                part = None if sp_ is None else torch.empty(sp_.n_seg, device=dev)

                def call(lib=lib, sp=sp_, part=part, name=label):
                    _build.check_launch(name, lib.textgcn_rowsum(
                        ptr.data_ptr(), vals.data_ptr(), out.data_ptr(),
                        None if sp is None else sp.table.data_ptr(),
                        None if part is None else part.data_ptr(), ag.n_nodes,
                        0 if sp is None else sp.n_seg, 0 if sp is None else sp.n_long,
                        _stream()))
                    return out

                line.append(_timed(results, "rowsum", label, csr, call, want, ATT_TOL))
        print(f"rowsum {csr} CSR: " + "; ".join(line)
              + f" ms a call (device); tol {ATT_TOL}*(1+|ref|)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(KINDS),
                    help=f"comma-separated subset of {', '.join(KINDS)}")
    kinds = set(ap.parse_args(argv).only.split(","))
    if not kinds <= set(KINDS):
        raise SystemExit(f"--only takes {', '.join(KINDS)}")
    if not torch.cuda.is_available():
        print("sweep_kernels: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    csrc = _build.CSRC
    variants = (
        [("k1", f"T={t} stages={n}", [f"TEXTGCN_K1_T={t}", f"TEXTGCN_K1_STAGES={n}"])
         for t in K1_T for n in K1_STAGES]
        + [("attn_agg", f"S={s}", [f"TEXTGCN_K2_S={s}"]) for s in AGG_S]
        + [("k2", f"S={s}", [f"TEXTGCN_K2_S={s}"]) for s in K2_S]
        + [("k2", f"S=512 narrow_f={n}", [f"TEXTGCN_K2_NARROW_F={n}"]) for n in K2_NARROW_F]
        + [("sddmm", f"lanes={n}", [f"TEXTGCN_SDDMM_LANES={n}"]) for n in SDDMM_LANES]
        + [("attn_stats", f"S={s}", [f"TEXTGCN_K2_S={s}"]) for s in AGG_S]
        + [("rowsum", f"S={s}", [f"TEXTGCN_K2_S={s}"]) for s in AGG_S]
    )
    variants = [v for v in variants if v[0] in kinds]
    # the entry points of attn_agg, attn_stats and rowsum live beside K2's S
    # query only in a full build: each of their variants links its source
    # with row_reduce.cu for that query
    k2 = csrc / "row_reduce.cu"
    src = {"k1": [csrc / "bsr_spmm.cu"], "attn_agg": [csrc / "attn_agg.cu", k2],
           "k2": [k2], "sddmm": [csrc / "sddmm.cu"],
           "attn_stats": [csrc / "attn_stats.cu", k2], "rowsum": [csrc / "rowsum.cu", k2]}
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = list(pool.map(lambda v: _build.build(tuple(v[2]), src[v[0]]), variants))
    libs = [_build.open_library(p) for p in paths]
    for (kind, name, defines), lib in zip(variants, libs):
        want = dict(d.split("=") for d in defines)
        if kind == "k1" and lib.textgcn_bsr_spmm_segment_tiles() != int(want["TEXTGCN_K1_T"]):
            raise AssertionError(f"{name}: built for another T")
        if kind in ("attn_agg", "attn_stats", "rowsum") and (
                lib.textgcn_row_reduce_segment_edges() != int(want["TEXTGCN_K2_S"])):
            raise AssertionError(f"{name}: built for another S")

    pre = prepare_docword_data("R8", device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    results = []
    if "k1" in kinds:
        k1_sweep(variants, libs, pre, gen, results)
    pre = apply_attention_format(pre, degree_sort=True)
    ag = pre.graph
    rp_t = ag.row_ptr_t.cpu().numpy()
    tables = {}
    for s in K2_S:
        sp = build_split(rp_t, s, RowSplit, dev)
        tables[s] = (sp.table, sp.n_seg, sp.n_long)

    n = ag.n_nodes
    es = torch.randn(n, generator=gen, device=dev)
    ed = torch.randn(n, generator=gen, device=dev)
    logits, mx, sm = att.stats_logits_plain(ag.row_ptr, ag.col, ag.logval, es, ed, SLOPE)
    w_t = att.edge_weights(ag, logits, mx, sm).index_select(0, ag.perm_t)
    print(f"R8 attention graph {n} rows, {ag.n_edges} edges; transpose CSR segments "
          f"by S: {', '.join(f'{s} {tables[s][1]}' for s in K2_S)}")
    if "attn_agg" in kinds:
        agg_sweep(variants, libs, ag, logits, mx, sm, gen, results)
    if "attn_stats" in kinds:
        stats_sweep(variants, libs, ag, es, ed, results)
    if "rowsum" in kinds:
        rowsum_sweep(variants, libs, ag, gen, results)
    if not kinds & {"k2", "sddmm"}:
        print(json.dumps({"device": smi, "sweep": results}))
        return 0

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
