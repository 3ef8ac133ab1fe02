#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``textgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU and
``nvcc``. It builds the CUDA kernels from ``textgcn_tpu_torch/csrc`` and
drives the port's two main paths on R8 doc-word:

- GCN: holds K1 and K2 against their plain PyTorch versions at the hybrid
  path's shapes, the whole hybrid pass (and its backward) against the
  segment-sum oracle, then trains ``train --dataset R8 --graph docword
  --spmm hybrid`` once through the CLI; both kernels must run there and test
  accuracy must reach 0.95.
- GAT: holds the four attention kernels against their plain versions on the
  degree-sorted attention graph, one GAT layer forward and backward on the
  kernels against the plain segment layer under autograd, then trains
  ``train --model gat --spmm hybrid`` once through the CLI; the attention
  kernels and K2 must run there and test accuracy must reach 0.88.

Each phase prints one line; any failure raises and exits non-zero. The last
lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

SEED = 0
ACC_MIN = 0.95  # the JAX package records 96.85% mean over 3 seeds here
# K1 vs plain: the same bf16 products summed in f32, in another order
K1_TOL = 1e-3
# K2 vs plain: f32 sums of a few products per row (fma vs mul + add)
K2_TOL = 1e-4
# hybrid pass vs f32 segment oracle: features and tiles are rounded to bf16
# (relative step 2^-8), as in the JAX package's own hybrid test
HYBRID_TOL = 2e-2
# GAT: the JAX package records test acc 0.8990 on the kernel layout (one run)
# and 91.57% mean over 5 seeds on the dense layout
GAT_ACC_MIN = 0.88
# attention kernels vs plain: the same f32 logits, f32 weights and exact
# bf16 products, summed in f32 in another order (exp-sums of up to a hub
# row's length)
ATT_TOL = 1e-4
# GAT layer on the kernels vs the f32 segment layer: weights and cotangent
# are drawn bf16-representable, so the kernels' bf16 casts are exact and only
# f32 sums in another order remain; the JAX package's bf16 tolerance (2e-2)
# would hide a wrong kernel of that size
GAT_LAYER_TOL = 1e-3
SLOPE = 0.2


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around ``reps``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, want, tol):
    """(max abs error, max error relative to max |want|); raises past
    |got - want| <= tol * (1 + |want|)."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    bound = tol * (1.0 + want.float().abs())
    max_abs = float(diff.max())
    max_rel = max_abs / max(float(want.float().abs().max()), 1e-30)
    if not bool((diff <= bound).all()):
        raise AssertionError(
            f"mismatch: max abs err {max_abs:.3e} beyond tol {tol} * (1 + |ref|)"
        )
    return max_abs, max_rel


def train_via_cli(cli, model, flags, acc_min, counters, need):
    """Train R8 doc-word once through the port's CLI with every launch count
    set to 0 just before; check the run and return the counts (summed over
    each kernel's wrappers) read just after."""
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        rc = cli.main([
            "train", "--dataset", "R8", "--graph", "docword", *flags,
            "--times", "1", "--seed", str(SEED), "--quiet",
            "--output_dir", out_dir,
        ])
        wall = time.perf_counter() - t0
        launches = {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}
        with open(os.path.join(out_dir, "R8_docword_training_results.json")) as fh:
            summary = json.load(fh)
    if rc != 0:
        raise AssertionError(f"cli train returned {rc}")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the {model} path never launched: {launches}")
    run = summary["runs"][0]
    hist = run["history"]
    if not all(
        math.isfinite(r[k]) for r in hist for k in ("train_loss", "val_loss")
    ):
        raise AssertionError("non-finite loss in the training history")
    test = run["test"]
    epochs = run["epochs_run"]
    log(f"train {model}", f"cli train R8 docword {' '.join(flags)} seed "
        f"{run['seed']}: {epochs} epochs, train {test['train_time']:.3f} s = "
        f"{1000 * test['train_time'] / epochs:.3f} ms/epoch, {wall:.1f} s with "
        f"data prep; test acc {test['acc']:.4f}, macro-F1 "
        f"{test['macro_f1']:.4f}; launches {launches}; peak memory "
        f"{json.dumps(summary['device_memory'])}")
    if test["acc"] < acc_min:
        raise AssertionError(f"{model} test accuracy {test['acc']:.4f} < {acc_min}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from textgcn_tpu_torch import cli
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.graph.reorder import hybrid_pass, spmm_hybrid
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.models import gat
    from textgcn_tpu_torch.ops import _build
    from textgcn_tpu_torch.ops import attention as att
    from textgcn_tpu_torch.ops.bsr_spmm import (
        F_ALIGN, bsr_spmm, bsr_spmm_plain,
    )
    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.ops.spmm import spmm_coo_segment
    from textgcn_tpu_torch.train.prepare import (
        apply_attention_format, prepare_docword_data,
    )

    # plain versions and the oracle run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {torch.cuda.device_count()} device(s)")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    info = _build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    log("build", f"nvcc built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s; ptxas: {' | '.join(regs)}")

    # the real R8 doc-word hybrid layout
    t0 = time.perf_counter()
    pre = prepare_docword_data("R8", device=dev)
    h, perm = convert_graph(pre.graph, "hybrid")
    bsr, rest = h.bsr, h.rest
    per_row = torch.diff(bsr.tile_ptr.long())
    log("data", f"R8 doc-word: {h.n_nodes} nodes, {h.n_edges} edges; tiles "
        f"{bsr.nnzb} ({bsr.n_edges} edges, {h.dense_fraction:.4f}), "
        f"{bsr.n_block_rows} block-rows, max {int(per_row.max())} tiles in a "
        f"block-row; residual {rest.n_edges} edges; "
        f"{time.perf_counter() - t0:.1f} s on the host")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_pad = bsr.n_block_rows * bsr.bm
    # kernel name -> [(max abs err, ms, plain ms), ...]; the first entry is
    # the one the JSON record reports times from (F=200, the forward CSR)
    records = {}

    # 3. K1 vs plain
    for f in (200, 8):
        fp = -(-f // F_ALIGN) * F_ALIGN
        xp = torch.zeros((n_pad, fp), dtype=torch.bfloat16, device=dev)
        xp[: h.n_nodes, :f] = torch.randn((h.n_nodes, f), generator=gen, device=dev)
        args = (bsr.blocks, bsr.tile_ptr, bsr.block_cols, xp)
        got, want = bsr_spmm(*args), bsr_spmm_plain(*args)
        err, rel = compare(got, want, K1_TOL)
        ms = cuda_ms(lambda: bsr_spmm(*args))
        plain_ms = cuda_ms(lambda: bsr_spmm_plain(*args))
        log("K1 bsr_spmm", f"F={f} (F'={fp}): max abs err {err:.3e}, rel "
            f"{rel:.3e}, tol {K1_TOL}*(1+|ref|) (same bf16 products, f32 sums "
            f"in another order); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        records.setdefault("bsr_spmm", []).append((err, ms, plain_ms))

        # 4. K2 vs plain on the real residual leg, onto K1's output and from 0
        rargs = (rest.row_ptr, rest.col, rest.val, xp)
        err_b, _ = compare(
            row_reduce(*rargs, base=got.clone()),
            row_reduce_plain(*rargs, base=got.clone()), K2_TOL,
        )
        err_z, rel_z = compare(row_reduce(*rargs), row_reduce_plain(*rargs), K2_TOL)
        base = got.clone()
        ms = cuda_ms(lambda: row_reduce(*rargs, base=base))
        plain_ms = cuda_ms(lambda: row_reduce_plain(*rargs, base=base))
        log("K2 row_reduce", f"F={f}: max abs err {err_b:.3e} with base, "
            f"{err_z:.3e} (rel {rel_z:.3e}) from zero, tol {K2_TOL}*(1+|ref|) "
            f"(f32 sums of a few products per row); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms (with base)")
        records.setdefault("row_reduce", []).append((max(err_b, err_z), ms, plain_ms))

    # 5. full hybrid pass and its backward vs the segment oracle, F=200
    row, col, val = pre.graph.coo_numpy()
    seg = SparseGraph.from_coo(
        perm[row], perm[col], val, h.n_nodes, device=dev
    )
    x = torch.randn((h.n_nodes, 200), generator=gen, device=dev)
    x.requires_grad_(True)
    y = spmm_hybrid(h, x)
    want = spmm_coo_segment(seg.row, seg.col, seg.val, x.detach(), h.n_nodes)
    err, rel = compare(y.detach(), want, HYBRID_TOL)
    cot = torch.randn(y.shape, generator=gen, device=dev)
    y.backward(cot)
    bwd_again = hybrid_pass(h, cot)
    if not torch.equal(x.grad, bwd_again):
        raise AssertionError("autograd backward differs from a pass on the cotangent")
    gerr, _ = compare(
        x.grad, spmm_coo_segment(seg.col, seg.row, seg.val, cot, h.n_nodes),
        HYBRID_TOL,
    )
    ms = cuda_ms(lambda: hybrid_pass(h, x.detach()))
    seg_ms = cuda_ms(
        lambda: spmm_coo_segment(seg.row, seg.col, seg.val, x.detach(), h.n_nodes)
    )
    log("hybrid", f"F=200 pass vs segment oracle: max abs err {err:.3e} (rel "
        f"{rel:.3e}), backward {gerr:.3e}, tol {HYBRID_TOL}*(1+|ref|) (bf16 "
        f"features and tiles); backward == pass on the cotangent; hybrid pass "
        f"{ms:.4f} ms, segment pass {seg_ms:.4f} ms")
    del seg, x, y, want, cot, bwd_again, h, bsr, rest

    # 6. the GCN main path, through the CLI
    counters = {
        "bsr_spmm": (bsr_spmm,), "row_reduce": (row_reduce,),
        "attn_stats": (att.stats_logits, att.softmax_stats),
        "attn_agg": (att.attn_agg,), "sddmm": (att.sddmm,),
        "rowsum": (att.rowsum,),
    }
    launches = train_via_cli(
        cli, "gcn", ["--spmm", "hybrid"], ACC_MIN, counters,
        need=("bsr_spmm", "row_reduce"),
    )

    # 7. the attention kernels vs plain on the degree-sorted R8 attention graph
    t0 = time.perf_counter()
    pre_att = apply_attention_format(pre, degree_sort=True)
    ag = pre_att.graph
    deg = torch.diff(ag.row_ptr)
    log("gat data", f"R8 doc-word attention graph (degree-sorted): "
        f"{ag.n_nodes} rows, {ag.n_edges} edges; hub row {ag.max_degree} "
        f"edges, median row {int(deg.median())}, {int((deg >= 1024).sum())} "
        f"rows >= 1024 edges; {time.perf_counter() - t0:.1f} s on the host")
    n = ag.n_nodes
    es = torch.randn(n, generator=gen, device=dev)
    ed = torch.randn(n, generator=gen, device=dev)
    s_args = (ag.row_ptr, ag.col, ag.logval, es, ed, SLOPE)
    got, want = att.stats_logits(*s_args), att.stats_logits_plain(*s_args)
    err = max(compare(a, b, ATT_TOL)[0] for a, b in zip(got, want))
    ms = cuda_ms(lambda: att.stats_logits(*s_args))
    plain_ms = cuda_ms(lambda: att.stats_logits_plain(*s_args))
    logits, mx, sm = want
    err6 = max(
        compare(a, b, ATT_TOL)[0]
        for a, b in zip(att.softmax_stats(ag.row_ptr, logits), (mx, sm))
    )
    ms6 = cuda_ms(lambda: att.softmax_stats(ag.row_ptr, logits))
    plain6 = cuda_ms(lambda: att.softmax_stats_plain(ag.row_ptr, logits))
    log("B5/B6 attn_stats", f"logits+stats: max abs err {err:.3e}, kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms; stats of given logits: max "
        f"abs err {err6:.3e}, kernel {ms6:.4f} ms, plain {plain6:.4f} ms; tol "
        f"{ATT_TOL}*(1+|ref|) (same f32 logits, exp-sums in another order)")
    records["attn_stats"] = [(err, ms, plain_ms), (err6, ms6, plain6)]
    # the backward's softmax weights, moved to the transpose CSR (dx's val)
    w_t = att.edge_weights(ag, logits, mx, sm).index_select(0, ag.perm_t)
    for f in (200, 8):
        x16 = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
        g16 = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
        a_args = (ag.row_ptr, ag.col, logits, mx, sm, x16)
        err, _ = compare(att.attn_agg(*a_args), att.attn_agg_plain(*a_args), ATT_TOL)
        ms = cuda_ms(lambda: att.attn_agg(*a_args))
        plain_ms = cuda_ms(lambda: att.attn_agg_plain(*a_args))
        records.setdefault("attn_agg", []).append((err, ms, plain_ms))
        d_args = (ag.row_ptr, ag.col, g16, x16)
        err_d, _ = compare(att.sddmm(*d_args), att.sddmm_plain(*d_args), ATT_TOL)
        ms_d = cuda_ms(lambda: att.sddmm(*d_args))
        plain_d = cuda_ms(lambda: att.sddmm_plain(*d_args))
        records.setdefault("sddmm", []).append((err_d, ms_d, plain_d))
        log("B7/B8 attn_agg, sddmm", f"F={f}: attn_agg max abs err {err:.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; sddmm max abs err "
            f"{err_d:.3e}, kernel {ms_d:.4f} ms, plain {plain_d:.4f} ms; tol "
            f"{ATT_TOL}*(1+|ref|) (f32 weights, exact bf16 products, f32 sums "
            f"in another order)")
        # K2 in B3's role: dx = (weighted A)ᵀ @ g over the transpose CSR
        k_args = (ag.row_ptr_t, ag.col_t, w_t, g16)
        err_k, _ = compare(row_reduce(*k_args), row_reduce_plain(*k_args), ATT_TOL)
        ms_k = cuda_ms(lambda: row_reduce(*k_args))
        plain_k = cuda_ms(lambda: row_reduce_plain(*k_args))
        records["row_reduce"].append((err_k, ms_k, plain_k))
        log("K2 row_reduce as dx", f"F={f}, transpose CSR with the softmax "
            f"weights: max abs err {err_k:.3e}, kernel {ms_k:.4f} ms, plain "
            f"{plain_k:.4f} ms; tol {ATT_TOL}*(1+|ref|) (f32 sums in another "
            f"order)")
    v = torch.randn(ag.n_edges, generator=gen, device=dev)
    v_t = v.index_select(0, ag.perm_t)
    for ptr, vals, csr in (
        (ag.row_ptr, v, "forward"), (ag.row_ptr_t, v_t, "transpose"),
    ):
        err, _ = compare(att.rowsum(ptr, vals), att.rowsum_plain(ptr, vals), ATT_TOL)
        ms = cuda_ms(lambda: att.rowsum(ptr, vals))
        plain_ms = cuda_ms(lambda: att.rowsum_plain(ptr, vals))
        records.setdefault("rowsum", []).append((err, ms, plain_ms))
        log("B9 rowsum", f"{csr} CSR: max abs err {err:.3e}, kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms; tol {ATT_TOL}*(1+|ref|) "
            f"(f32 sums in another order)")
    del x16, g16, v, v_t, w_t, logits, mx, sm, got, want

    # 8. one GAT layer, forward and backward, on the kernels vs the segment
    # layer under autograd, F=200 (K2 carries dx over the transpose CSR)
    row, col, val = pre.graph.coo_numpy()
    perm = pre_att.perm
    seg = SparseGraph.from_coo(perm[row], perm[col], val, n, device=dev)
    p = {
        "w": torch.randn((n, 200), generator=gen, device=dev).bfloat16().float(),
        "b": torch.randn(200, generator=gen, device=dev),
        "a_src": torch.randn(200, generator=gen, device=dev) / math.sqrt(200),
        "a_dst": torch.randn(200, generator=gen, device=dev) / math.sqrt(200),
    }
    cot = torch.randn((n, 200), generator=gen, device=dev).bfloat16().float()
    res = []
    for layer, graph in ((gat.gat_layer_onehot, ag), (gat.gat_layer, seg)):
        q = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        out = layer(q, graph, None, negative_slope=SLOPE)
        out.backward(cot)
        res.append([out.detach()] + [q[k].grad for k in ("w", "a_src", "a_dst", "b")])
    errs = [compare(a, b, GAT_LAYER_TOL)[0] for a, b in zip(*res)]

    def fwd_bwd(layer, graph):
        q = {k: t.clone().requires_grad_(True) for k, t in p.items()}
        layer(q, graph, None, negative_slope=SLOPE).backward(cot)

    ms = cuda_ms(lambda: fwd_bwd(gat.gat_layer_onehot, ag), reps=5)
    seg_ms = cuda_ms(lambda: fwd_bwd(gat.gat_layer, seg), reps=5)
    log("gat layer", f"F=200 layer on the kernels vs the segment layer: max "
        f"abs err out {errs[0]:.3e}, dw {errs[1]:.3e}, da_src {errs[2]:.3e}, "
        f"da_dst {errs[3]:.3e}, db {errs[4]:.3e}; tol {GAT_LAYER_TOL}*(1+|ref|) "
        f"(bf16-representable weights and cotangent: exact casts, f32 sums in "
        f"another order); forward+backward {ms:.4f} ms on the kernels, "
        f"{seg_ms:.4f} ms segment")
    del seg, p, cot, res, ag, pre, pre_att

    # 9. the GAT main path, through the CLI
    gat_launches = train_via_cli(
        cli, "gat", ["--model", "gat", "--spmm", "hybrid"], GAT_ACC_MIN,
        counters, need=("row_reduce", "attn_stats", "attn_agg", "sddmm", "rowsum"),
    )

    sources = {
        "bsr_spmm": ("textgcn_tpu_torch/csrc/bsr_spmm.cu",
                     "textgcn_tpu/ops/pallas_spmm.py:143"),
        "row_reduce": ("textgcn_tpu_torch/csrc/row_reduce.cu",
                       "textgcn_tpu/ops/pallas_onehot.py:232"),
        "attn_stats": ("textgcn_tpu_torch/csrc/attn_stats.cu",
                       "textgcn_tpu/ops/pallas_attention.py:94"),
        "attn_agg": ("textgcn_tpu_torch/csrc/attn_agg.cu",
                     "textgcn_tpu/ops/pallas_attention.py:160"),
        "sddmm": ("textgcn_tpu_torch/csrc/sddmm.cu",
                  "textgcn_tpu/ops/pallas_attention.py:185"),
        "rowsum": ("textgcn_tpu_torch/csrc/rowsum.cu",
                   "textgcn_tpu/ops/pallas_attention.py:140"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        _, ms, plain_ms = records[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name] + gat_launches[name],
            "max_abs_err": max(r[0] for r in records[name]),
            "ms": ms, "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
