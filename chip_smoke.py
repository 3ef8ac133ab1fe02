#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``textgcn_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU and
``nvcc``. It builds the CUDA kernels from ``textgcn_tpu_torch/csrc`` and
drives the port's paths: on R8 doc-word, then on R8's topic graph:

- Host preparation ("native prep"): R8 doc-word prepared through the native
  graph core (C++, built with g++ into ``textgcn_tpu_torch/_build``) and
  through the numpy path (forced by the tests' hook), each path's parse,
  normalize and whole preparation timed; the two float32 graphs must be
  bit-equal, and every doc-word phase below runs on the native one.
- GCN: holds K1 (through the tile stack's split table; two launches must
  give the same bits) and K2 against their plain PyTorch versions at the
  hybrid path's shapes, the whole hybrid pass (and its backward) against the
  segment-sum oracle, then trains ``train --dataset R8 --graph docword
  --spmm hybrid`` once through the CLI; both kernels must run there and test
  accuracy must reach 0.95.
- GAT: holds the four attention kernels (``attn_stats`` in both modes) and
  K2 as dx against their plain versions on the degree-sorted attention
  graph (``attn_stats``, ``attn_agg`` and ``rowsum`` over the forward CSR
  through its split table, K2 and ``rowsum`` over the transpose CSR through
  the transpose's, each also timed without a table; two launches of each
  must give the same bits), one GAT layer forward and backward on the
  kernels against the plain segment layer under autograd, drives the
  ``attention_spmm`` op (given logits: ``attn_stats`` in B6 mode, the
  ``softmax_stats`` record) forward and backward against an autograd
  oracle with its launches counted, then trains
  ``train --model gat --spmm hybrid`` once through the CLI; the attention
  kernels and K2 must run there and test accuracy must reach 0.88.
- Streaming (beyond memory), at the JAX package's baseline scale config
  (10M nodes, 500M symmetric edges): generates the lattice stream on the
  card into a chunk cache, holds K2 in its per-chunk role (B11) and a whole
  pass against the plain version and checks the pass's symmetry; for each
  family with a streamed step (GCN, SGC, APPNP, SAGE, GIN, GCNII; F=128,
  H=16, C=8, bf16, the JAX package's depths) holds one step's loss and
  gradients against the same step on the plain version and trains ten
  Adam steps with K2's launches counted (exactly ten times the family's
  passes a step times the chunks); holds a GCN step against one whose
  device cache holds only half the chunks (the rest stream in from pinned
  host memory on every pass), streams the R8 doc-word graph from pinned
  host chunks, and trains R8 doc-word from one seed through the streamed
  GCN step over those chunks and through the resident Trainer: their test
  accuracies must agree within 0.01.
- Sharded GCN (B10): at 4 shards of R8 doc-word, in this process, holds each
  rank's tile leg (K1 on its rectangular block with the block's split
  table, as ``bsr_leg``; two launches must give the same bits) and its
  whole pass (K1, then K2 in place) against the plain versions, and the
  four shards put together must give the single-device hybrid pass's bits;
  trains
  ``train --spmm hybrid --shards 1 --partition allgather`` once through the
  CLI (an NCCL group of one), and 4 ranks on this one card through the
  library (gloo, which carries CUDA tensors; NCCL refuses two ranks on one
  GPU): ``bsr_leg`` and K2 must run on rank 0 and test accuracy must reach
  0.95 in both. "launcher ranks": 2 ranks started by ``python -m
  torch.distributed.run --standalone`` (each joins with
  ``init_distributed`` and trains through ``run_joined``) on cuda:0 over
  gloo train R8 doc-word under hybrid/allgather with losses bit-equal to 2
  spawned ranks, B10 and K2 launched on their rank 0 (over NCCL too where
  the machine has two GPUs). Then the one-hot mesh layouts at 4 ranks of R8 doc-word,
  F=200 ("mesh onehot"): each layout's per-shard rate at P = 1 in this
  process (the JAX bench's ``mesh_kernel_perf`` keys), and on 4 gloo ranks
  on this card each rank's all-gather pass (K2 from zero) and halo pass (K2
  onto the accumulator, a bucket a ring step) against their plain
  versions, two passes bit-equal, K2's launches and ms a pass; the
  all-gather shards put together must give the single-device ``--spmm
  onehot`` pass's bits and the halo shards match it within K2's tolerance.
  "train sharded halo" trains R8 doc-word on 4 gloo ranks under
  halo-segment, halo-onehot and allgather-onehot (test accuracy >= 0.95 in
  each; K2 on rank 0 under the one-hot kernels only), and ``train --shards
  1`` with no ``--partition`` and no ``--spmm`` must report partition halo
  and kernel segment (the JAX defaults) and reach 0.95. Route B.3 ("mesh
  gat"): the attention kernels on each of 4 ranks' rectangular attention
  graphs of R8 doc-word (JAX node order, F=200), in this process: B5, B7,
  B8, B9 and K2 as dx against their plain versions on the inputs
  ``gat_attention`` gives them, two fwd+bwd runs bit-equal, each rank's
  fwd+bwd ms; the ranks' outputs put together bit-equal to the single-card
  op on the whole graph, their dx and ded summed (the all-gather's
  transpose) within ATT_TOL of its gradients.
- Learnable edges ("edge ops", "edge gcn"): ``edge_logit_base`` (``rowsum``
  over both CSRs with their tables) and ``spmm_onehot_ew`` (K2 from zero
  forward and as dx over the transpose CSR, ``sddmm`` for dval) forward
  and backward on the degree-sorted R8 attention graph at F=200, each
  kernel against its plain version on the inputs the op gave it, two runs
  bit-equal, their launches counted; then ten Adam steps of
  ``gcn_edge_forward`` on R8 doc-word at n_hidden 200: the loss must fall
  and ``edge_logit`` move off 0.
- Sharded checkpoints and streaming on the ranks (route B.4). "sharded
  checkpoint": the R8 doc-word GCN on 4 gloo ranks on this card under
  hybrid/allgather, straight and through a saved and resumed state (the
  histories bit-equal, K1 and K2 launched on rank 0); the sharded model
  loaded on one card under --spmm hybrid and onehot (test accuracy within
  LOAD_GAP of the sharded run's); a single-card segment state resumed on
  the ranks under segment/halo (within FAMILY_GAP of the single card).
  "mesh stream ranks": R8 doc-word's halo sorted buckets on 4 gloo ranks,
  F=128 bf16: every B11 launch of a pass against its plain version, two
  passes and the bucket files' pass bit-equal, the stacked pass within
  MESH_TOL of |A||x| of the single card's stream, MESH_STEPS Adam steps of
  the sharded streamed GCN within MESH_LOSS_TOL of the single card's.
  After the streamed families, "mesh stream pass" and "mesh stream train":
  the ring at P = 1 (an NCCL group of one) on the 10M-node lattice at
  F=128, bit-equal to the single-card stream (its seconds a pass, edges/s,
  K2's launches, peak memory), and one step each of the sharded GCN, SGC
  and APPNP bit-equal to the single-card step. In the topic slice,
  "sharded checkpoint cli": ``train --shards 1`` with ``--save_model`` and
  ``--save_state``, then ``--resume`` (its report names ``sharding`` and
  ``resumed_from``) and ``--load_model`` (the saved run's accuracy).

- Topic slice (TopicGCN on R8's topic graph, from copies of the committed
  artifacts in a temporary directory; the checkout's theta cache is read,
  never written): prepares the graph on the card and holds K1 (the topic
  layout has no residual edges for K2) and the hybrid pass against their
  plain versions at the topic widths; runs the port's LDA E-step on the
  card against the committed theta (max abs diff 1e-4) and through
  prepare with no cache; trains GCN and GAT on the JAX package's five
  seeds (GCN mean >= 0.9411, both within 0.005 of the JAX package's
  committed means), the six other families on their committed seeds
  (within 0.01), the GCN on ``--spmm auto`` and every family once on
  ``--spmm hybrid`` (within 0.01 of its segment run at that seed; K1, and
  for GAT its kernels and K2 as dx, must launch). "topic_gat report" (C.6):
  ``run_experiment("R8", graph_family="topic_gat", pre_data=...)`` with the
  GAT on segment must write ``R8_topic_gat_training_results.{json,txt}``.
  Then every family
  sharded, one spawn of 4 gloo ranks on the card at seed 7 ("train sharded
  gat", "train sharded families"): GAT on R8 doc-word under
  onehot/allgather (acc >= 0.88, its kernels launched on rank 0), GAT on
  R8 topic under segment/allgather and segment/halo, and SAGE, SGC, APPNP,
  GIN and GCNII on R8 topic on halo-segment, allgather-segment,
  halo-onehot, allgather-onehot and allgather-hybrid, each within 0.01 of
  its single-card segment run at that seed (K2 under onehot, K1 under
  hybrid, nothing under segment); and ``train --model gat --shards 1
  --partition allgather --spmm onehot`` on R8 topic ("train sharded
  cli"): its report names the sharding, the attention kernels launch,
  within 0.01 of segment.
- Build slice (the build pipeline on the card, each phase in a temporary
  data root holding copies of the label file and the clean corpus): builds
  R8's topic graph with experiments/r8.yaml's settings (LDA fit and
  Word2Vec on the card; stage times, EM and E-step iterations, CBOW steps a
  second, peak memory, and the bound trace, phi and edges against the
  committed JAX build, printed); two same-seed LDA fits and two Word2Vec
  fits must give the same bits; trains the GCN on the built graph through
  the CLI (segment on the bench seeds: mean >= 0.9411 and within 0.01 of
  the JAX package's committed mean; hybrid once, K1 must launch); runs
  ``cli experiment`` on a copy of experiments/r8.yaml from a temporary
  working directory (build, train, inspect, their logs and reports); builds
  mr's doc-word graph on the host (``cli build-docword``), which must equal
  the committed edge set; and checks that nothing under data/,
  experiments/ or results/ of the checkout was written.

- The single-card train with every flag of the JAX CLI: "machine" runs
  ``probe_machine`` beside the committed ``MachineModel``; "bsr f32" holds
  K1's f32 mode (B4's f32 mode, ``bsr_spmm_f32``, 3xTF32 on the tensor
  cores) on the unsorted R8 doc-word tile stack (F' = 208, 16) and, in
  "bsr f32 topic", on R8 topic's (208, 112, 16) against the plain version
  (within F32_TILE_TOL of its largest output) and against an f64 oracle (at
  most F64_ERR_RATIO times the plain f32 version's error), two launches
  bit-equal, its bound counted as three TF32 products; "onehot" holds K2 from zero on
  the whole R8 doc-word CSR; "auto" times every eligible format's pass on
  R8 doc-word, mr topic and mr doc-word and requires the cost model's pick
  within AUTO_SLACK (or AUTO_ABS_MS) of the fastest, and "auto gat" the
  dense GAT's measured peak not above its price; then, through the CLI,
  mr topic on auto (JAX's committed seeds, within 0.01 of its mean), the
  R8 doc-word GCN on auto, bsr and onehot (>= 0.95), the GAT on auto, the
  R8 topic GCN on bsr and onehot on the bench seeds (within 0.01 of
  segment per seed), "checkpoint" (on --spmm hybrid and on --spmm segment:
  a resumed run's losses bit-equal to a straight run's, ``--load_model``
  its test accuracy exactly), "experiment r8_docword", and in the topic
  slice "segment determinism" (two same-seed --spmm segment runs of the
  GCN and of the GAT give bit-equal losses). These phases draw from a generator of their own,
  so the earlier phases' inputs are unchanged.

Every kernel's record also carries its bound on the card (the larger of its
bytes over the memory rate and its operations over the peak rate, from this
run's inputs) and the time of one PyTorch call that computes the same
function, where there is one. K2's record is split by role: ``row_reduce``
(with a base, B2: the residual leg and the halo one-hot buckets) and
``row_reduce_dx`` (from zero, B3: GAT's dx, the ``--spmm onehot`` runs, the
all-gather one-hot shards and ``spmm_onehot_ew``); ``sddmm`` and
``rowsum`` add the learnable-edge ops' launches; B11 is
``sorted_chunk_add``; ``attn_stats`` is B5 and ``softmax_stats`` B6 (one
kernel, two modes, each with its own count). ``ms``, ``plain_ms`` and
``library_ms`` are CUDA events around 20 back-to-back calls (the host's
cost of a call included where it exceeds the kernel, as in K2's short
roles); ``device_ms`` and ``library_device_ms`` are the same calls
captured in a CUDA graph and replayed, device time only (null for
``torch.segment_reduce``, which cannot be captured).

Each phase prints one line; any failure raises and exits non-zero. The last
lines are the kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
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
# streaming: benchmarks/synthetic_large.py lattice_config(10M, 2*25), the
# JAX package's streamed_train_perf (bench.py) config
STREAM_N, STREAM_DEG = 10_000_000, 50
STREAM_F, STREAM_H, STREAM_C, STREAM_STEPS = 128, 16, 8, 10
# streamed passes a step of each family at the JAX package's depths (SGC k =
# 2, APPNP k = 10, GCNII K = 8): one forward and one backward a propagation
STREAM_PASSES = {"gcn": 4, "sgc": 4, "appnp": 20, "sage": 4, "gin": 4, "gcnii": 16}
# the streamed GCN's R8 doc-word test accuracy vs the resident Trainer's from
# the same seed: the seed-noise bar of PERF.md section 2
ACC_SEED_NOISE = 0.01
# <A x, y> vs <x, A y> with positive x, y: f32 row sums of 50 positive terms
# (each within 50 * 2^-24 relative), inner products summed in f64
SYM_TOL = 1e-5
# one train step on K2 vs on the plain reduce: f32 sums in another order,
# re-rounded to bf16 at the stream casts; a flip moves one element by 2^-8
# relative and flips are rare, so the loss agrees to 1e-4 relative and each
# gradient to 1e-3 of its largest entry
STEP_LOSS_TOL, STEP_GRAD_TOL = 1e-4, 1e-3
# sharded GCN: ranks of R8 doc-word
SHARDS = 4
# the topic slice: the JAX package's bench seeds, the reference TopicGCN's
# R8 test accuracy, and the largest gaps of a mean from the JAX package's
# committed mean on the same seeds (GCN and GAT; the other families), which
# also bound a one-seed run on another format against its segment run
BENCH_SEEDS = (7, 42, 1234, 31415, 2718)
REF_TOPIC_ACC = 0.9411
TOPIC_GAP, FAMILY_GAP = 0.005, 0.01
HYBRID_SEED = 7
# "topic_gat report": epochs of its one GAT run
TOPIC_GAT_EPOCHS = 5
NEW_FAMILIES = ("sgc", "sgc_pre", "appnp", "sage", "gin", "gcnii")
# theta on the card vs the JAX E-step's: f32 E-steps, digamma differing in
# the last bits, up to 100 iterations a chunk
THETA_TOL = 1e-4
# the build slice: the committed R8 topic graph's edge counts (the JAX
# package's build), and the largest gap of the GCN's mean on the port's own
# build from the JAX package's committed mean on the same seeds (the two
# builds' LDA and Word2Vec runs differ in f32 rounding, so their graphs
# differ in a few edges); a final per-word bound more than BOUND_FINDING
# below the committed trace's is reported as a finding, not failed
R8_DOC_TOPIC_EDGES, R8_TOPIC_TOPIC_EDGES = 31_818, 1_200
BUILT_GAP = 0.01
BOUND_FINDING = 0.02
# the doc-word build vs the committed mr_docword.txt: the same float64
# formulas, the weights' text written with repr
DOCWORD_RTOL = 1e-12
ARTIFACT_DIRS = ("data", "experiments", "results")
# K1's f32 mode vs plain: the kernel's 3xTF32 products (big*big + big*small
# + small*big of each operand's two TF32 parts, f32 sums) against f32
# products summed in another order, over up to a block-row's 128 * tiles
# terms: within 2e-5 of the largest output. A numpy emulation on graph-like
# rows (tests/test_torch_tf32.py) puts 3xTF32 near plain f32 against the
# f64 product and single-pass TF32 more than 10x beyond this limit
F32_TILE_TOL = 2e-5
# ... and against the f64 oracle (the plain version on f64 inputs), the
# kernel's error at most this many times the plain f32 version's
F64_ERR_RATIO = 4
# auto: the pick's device time within 25% of the fastest measured format's,
# or within 0.02 ms of it (the committed constants are wrong otherwise)
AUTO_SLACK, AUTO_ABS_MS = 0.25, 0.02
# mr's topic graph: experiments/mr.yaml's 50 topics beside its 10,662 docs
MR_TOPICS = 50
# H100 SXM peaks (NVIDIA's data sheet): HBM rate, dense bf16 and TF32
# tensor cores, f32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16, PEAK_TF32, PEAK_F32 = 989e12, 495e12, 67e12


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


def graph_ms(fn, reps=20, replays=5):
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events. The host's
    cost of a call (Python, the wrapper's checks, ctypes) is not in it, as
    it is in :func:`cuda_ms` when a kernel is shorter than its call, and
    neither are host hiccups. ``fn`` must not synchronize with the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def both_ms(fn):
    """(ms a call by :func:`cuda_ms`, device ms by :func:`graph_ms`)."""
    return cuda_ms(fn), graph_ms(fn)


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


def bound(n_bytes, n_ops, peak):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and the operations over ``peak``."""
    t_bytes, t_ops = 1e3 * n_bytes / HBM_BYTES_PER_S, 1e3 * n_ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def rows_read(idx, width, itemsize):
    """Bytes of the distinct rows ``idx`` gathers from a ``width``-wide table
    (what a sparse gather needs, each row read once)."""
    return int(torch.unique(idx).numel()) * width * itemsize


def csr(row_ptr, col, val, shape):
    """An f32 CSR tensor of the same matrix, for the library yardsticks."""
    return torch.sparse_csr_tensor(row_ptr.long(), col.long(), val.float(), size=shape)


def tiles_csr(b, n_cols):
    """The tile stack of a BlockSparseGraph as an f32 CSR tensor
    [n_block_rows*128, n_cols] (its nonzeros only)."""
    nbr, nbc = b.n_block_rows, n_cols // 128
    dense = torch.zeros((nbr * 128, n_cols), device=b.blocks.device)
    dense.view(nbr, 128, nbc, 128).permute(0, 2, 1, 3)[
        b.block_rows.long(), b.block_cols.long()
    ] = b.blocks.float()
    return dense.to_sparse_csr()


def k1_yardsticks(b, xp, n_cols):
    """K1's bound on the card and the time of ``torch.sparse.mm`` on an f32
    CSR of its tiles, for tiles ``b`` against the padded table ``xp``."""
    fp = xp.shape[1]
    n_bytes = (nbytes(b.blocks, b.tile_ptr, b.block_cols)
               + rows_read(b.block_cols, 128 * fp, 2) + b.n_block_rows * 128 * fp * 4)
    bnd = bound(n_bytes, 2 * b.nnzb * 128 * 128 * fp, PEAK_BF16)
    a, xf = tiles_csr(b, n_cols), xp.float()
    return (*bnd, *both_ms(lambda: torch.sparse.mm(a, xf)))


def k2_yardsticks(row_ptr, col, val, x, base=None):
    """K2's bound (the distinct x rows gathered; the output written, and the
    base read first when there is one) and the time of ``torch.sparse.addmm``
    (``torch.sparse.mm`` from zero) on an f32 CSR of the same edges."""
    n_rows, f = row_ptr.numel() - 1, x.shape[1]
    n_bytes = (nbytes(row_ptr, col, val) + rows_read(col, f, x.element_size())
               + (1 if base is None else 2) * n_rows * f * 4)
    bnd = bound(n_bytes, 2 * col.numel() * f, PEAK_F32)
    a, xf = csr(row_ptr, col, val, (n_rows, x.shape[0])), x.float()
    if base is None:
        return (*bnd, *both_ms(lambda: torch.sparse.mm(a, xf)))
    b0 = base[:n_rows]
    return (*bnd, *both_ms(lambda: torch.sparse.addmm(b0, a, xf)))


def wall(fn):
    """(result, seconds) of ``fn()`` on the host clock, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def pinned_copies(chunks):
    """Host copies of device chunks, as views of one page-locked buffer per
    field (three allocations instead of one per chunk and field)."""
    from textgcn_tpu_torch.ops.streamed_sorted import SortedChunk

    fields = ("row_ptr", "col", "val")
    bufs = {
        k: torch.empty(sum(getattr(c, k).numel() for c in chunks),
                       dtype=getattr(chunks[0], k).dtype, pin_memory=True)
        for k in fields
    }
    off = dict.fromkeys(fields, 0)
    out = []
    for c in chunks:
        views = []
        for k in fields:
            t = getattr(c, k)
            views.append(bufs[k][off[k] : off[k] + t.numel()].copy_(t))
            off[k] += t.numel()
        out.append(SortedChunk(*views, c.r0))
    return out


def stream_init(family, dev, opt_cls, lr):
    """A family's streamed parameters at the smoke's widths, drawn from one
    seed, and ``opt_cls`` over them."""
    from textgcn_tpu_torch.train import streamed as st

    params, _ = st.init_streamed(
        torch.Generator(device=dev).manual_seed(SEED + 3), STREAM_F, STREAM_H, STREAM_C,
        device=dev, family=family,
    )
    return params, opt_cls(params.values(), lr=lr)


def stream_train_phase(family, dev, data):
    """One family's streamed step on the cached lattice ``data``: one step's
    loss and gradients on K2 against the same step on the plain reduce (SGD
    with lr 0 keeps the weights), then STREAM_STEPS Adam steps with K2's
    launches counted. Returns (K2's launches in those steps, the K2 step's
    loss, its gradients)."""
    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.train import streamed as st

    src, n_chunks, n, n_edges, x, y, mask = data
    tag = "stream train" if family == "gcn" else f"stream {family}"
    factory = st.STREAMED_SEGMENTED_FACTORIES[family]
    t_phase = time.perf_counter()
    res = []
    for reduce in (row_reduce, row_reduce_plain):
        params, opt = stream_init(family, dev, torch.optim.SGD, 0.0)
        step = factory(st.make_sorted_stream(src, reduce), n, opt)
        loss, step_s = wall(lambda: float(step(params, x, y, mask)))
        res.append((loss, {k: p.grad for k, p in params.items()}, step_s))
    (loss_k, grads_k, _), (loss_p, grads_p, plain_step_s) = res
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {
        k: float((grads_k[k] - grads_p[k]).abs().max() / grads_p[k].abs().max())
        for k in grads_p
    }
    if not (loss_rel <= STEP_LOSS_TOL and max(grad_rel.values()) <= STEP_GRAD_TOL):
        raise AssertionError(f"{tag}: the step on K2 vs plain: loss rel {loss_rel:.3e}, "
                             f"grads {grad_rel}")
    del res, grads_p, params, opt, step

    params, opt = stream_init(family, dev, torch.optim.Adam, 0.02)
    step = factory(st.make_sorted_stream(src), n, opt)
    row_reduce.launches = row_reduce.batched_chunks = 0
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(STREAM_STEPS):
        loss, dt = wall(lambda: float(step(params, x, y, mask)))
        losses.append(loss)
        times.append(dt)
    launches, batched = row_reduce.launches, row_reduce.batched_chunks
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < 0.9 * losses[0]:
        raise AssertionError(f"{tag}: the streamed {family} did not train: losses {losses}")
    # the cache holds every chunk: one K2 launch a pass reduces all of them
    want = STREAM_STEPS * STREAM_PASSES[family]
    if launches != want or batched != want * n_chunks:
        raise AssertionError(f"{tag}: K2 launched {launches} times over {batched} chunks in "
                             f"the streamed run, want {want} over {want * n_chunks}")
    mean_s = sum(times[1:]) / (STREAM_STEPS - 1)
    # the JAX bench's record of its streamed SGC step (bench.py)
    rate = f"; edges_per_s_fwdbwd {4 * n_edges / mean_s:.6e}" if family == "sgc" else ""
    log(tag, f"{family} F={STREAM_F} H={STREAM_H} C={STREAM_C} bf16, "
        f"{STREAM_PASSES[family]} passes a step, on {n} nodes / {n_edges} edges, "
        f"Adam lr 0.02: losses {', '.join(f'{v:.6g}' for v in losses)}; step 1 "
        f"{times[0]:.3f} s, steps 2-{STREAM_STEPS} mean {mean_s:.4f} s/step{rate}; "
        f"K2 launches {launches}; peak memory {peak} bytes allocated (x, labels, "
        f"chunk cache, activations); one step on K2 vs plain: loss rel "
        f"{loss_rel:.3e} (tol {STEP_LOSS_TOL}), grads rel to max "
        f"{', '.join(f'{k} {v:.3e}' for k, v in grad_rel.items())} (tol "
        f"{STEP_GRAD_TOL}); plain step {plain_step_s:.3f} s; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, loss_k, grads_k


def stream_accuracy_phase(dev, r8_graph, labels, sg):
    """R8 doc-word trained twice from one seed for the Trainer's epoch count,
    without dropout, val split or early stop (the streamed step's
    conventions): the streamed GCN step over the pinned host chunks ``sg``
    with identity features as a bf16 table, and the resident Trainer on the
    segment format. Their test accuracies must agree within ACC_SEED_NOISE."""
    from textgcn_tpu_torch.ops.streamed_sorted import spmm_streamed_sorted_hostfed
    from textgcn_tpu_torch.train import streamed as st
    from textgcn_tpu_torch.train.metrics import accuracy
    from textgcn_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    cfg = TrainConfig(dropout=0.0, val_ratio=0.0, early_stopping=TrainConfig.max_epoch + 1,
                      seed=SEED, model="gcn")
    n, n_docs = sg.n_nodes, len(labels.target)
    target = torch.as_tensor(labels.target, device=dev)
    test_idx = torch.as_tensor(labels.test_idx, device=dev)
    y = torch.zeros(n, dtype=torch.int64, device=dev)
    y[:n_docs] = target
    mask = torch.zeros(n, device=dev)
    mask[torch.as_tensor(labels.train_idx, device=dev)] = 1.0
    x = torch.eye(n, dtype=torch.bfloat16, device=dev)
    params, opt = st.init_streamed(
        torch.Generator(device=dev).manual_seed(cfg.seed), n, cfg.n_hidden,
        labels.n_classes, device=dev, lr=cfg.lr,
    )
    stream = st.make_sorted_stream(sg.chunks)
    step = st.make_streamed_train_step_segmented(stream, n, opt)
    (losses, stream_s) = wall(lambda: [step(params, x, y, mask) for _ in range(cfg.max_epoch)])
    with torch.no_grad():
        # the step's forward: s1 and s2 rounded to the stream dtype
        s1 = (x.float() @ params["gc1.w"].bfloat16().float()).bfloat16()
        a1 = spmm_streamed_sorted_hostfed(sg.chunks, s1)
        s2 = (torch.relu(a1 + params["gc1.b"]) @ params["gc2.w"]).bfloat16()
        logits = spmm_streamed_sorted_hostfed(sg.chunks, s2) + params["gc2.b"]
        acc_stream = float(accuracy(logits[test_idx], target[test_idx]))
    del x, s1, a1, s2, logits, params, opt, step

    t = Trainer(r8_graph, None, labels.target, labels.train_idx, labels.test_idx,
                labels.n_classes, config=cfg, device=dev)
    fit = t.fit(verbose=False)
    acc_res = t.evaluate(t.test_idx)["acc"]
    gap = abs(acc_stream - acc_res)
    log("stream accuracy", f"R8 doc-word GCN, seed {cfg.seed}, {cfg.max_epoch} epochs, "
        f"H={cfg.n_hidden}, dropout 0, no val split, no early stop: streamed step over "
        f"{sg.n_chunks} pinned host chunks (bf16 identity features, bf16 stream) test "
        f"acc {acc_stream:.4f} (final train loss {float(losses[-1]):.4f}, {stream_s:.1f} s); "
        f"resident Trainer (segment, f32) test acc {acc_res:.4f} (final train loss "
        f"{t.history[-1]['train_loss']:.4f}, {fit['epochs_run']} epochs, "
        f"{fit['train_time']:.1f} s); gap {gap:.4f} (tol {ACC_SEED_NOISE}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if fit["epochs_run"] != cfg.max_epoch or not gap <= ACC_SEED_NOISE:
        raise AssertionError(f"streamed vs resident R8 accuracy {acc_stream} vs {acc_res} "
                             f"after {fit['epochs_run']} epochs")


def stream_phases(dev, gen, records, yard, r8_graph, r8_labels):
    """The streamed (beyond-memory) slice; returns K2's launches in the
    streamed train runs of the six families, and in the P = 1 ring's pass
    and steps (route B.4)."""
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.parallel.launch import spawn_ranks
    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.ops.spmm import spmm, spmm_coo_segment
    from textgcn_tpu_torch.ops import streamed_sorted as ss
    from textgcn_tpu_torch.train import streamed as st

    # 10. stream data: the lattice generated on the card into a chunk cache
    t_phase = time.perf_counter()
    n_chunks, w_sc, w, cell_e = ss.lattice_config(STREAM_N, STREAM_DEG)
    lattice = ss.make_lattice_stream(n_chunks, w_sc, w, cell_e, seed=SEED, device=dev)
    n = lattice.n_rows
    src = ss.CachedChunkSource(lattice.chunk, n_chunks, 16 << 30, dev)
    chunks, gen_s = wall(lambda: list(src))
    if src.host_loads != n_chunks or sum(c.n_edges for c in chunks) != lattice.n_edges:
        raise AssertionError("lattice: wrong chunk or edge count")
    deg = torch.cat([torch.diff(c.row_ptr) for c in chunks])
    if int(deg.sum()) != lattice.n_edges or deg.numel() != n:
        raise AssertionError("lattice: row_ptr does not cover every row once")
    log("stream data", f"lattice {n_chunks} chunks x {w_sc} windows x {w} rows, "
        f"cell_e {cell_e}: {n} rows, {lattice.n_edges} edges "
        f"({lattice.chunk_edges} per chunk), degree mean {float(deg.float().mean()):.2f} "
        f"(min {int(deg.min())}, max {int(deg.max())}); chunk cache "
        f"{src.cached_bytes} bytes on the card; generated in {gen_s:.3f} s; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    del deg, chunks

    # 11. B11: K2 onto one chunk's row range of an accumulator, vs plain
    t_phase = time.perf_counter()
    chunk = next(iter(src))
    for f in (16, 8):
        x = torch.randn((n, f), generator=gen, device=dev).bfloat16()
        base = torch.randn((n, f), generator=gen, device=dev)
        got = ss.sorted_chunk_add(base.clone(), chunk, x)
        want = ss.sorted_chunk_add(base.clone(), chunk, x, reduce=row_reduce_plain)
        err, rel = compare(got, want, K2_TOL)
        outside = torch.ones(n, dtype=torch.bool, device=dev)
        outside[chunk.r0 : chunk.r0 + chunk.rows] = False
        if not torch.equal(got[outside], base[outside]):
            raise AssertionError("B11 touched rows outside its chunk")
        ms, dev_ms = both_ms(lambda: ss.sorted_chunk_add(base, chunk, x))
        plain_ms = cuda_ms(lambda: ss.sorted_chunk_add(base, chunk, x, reduce=row_reduce_plain))
        records.setdefault("sorted_chunk_add", []).append((err, ms, dev_ms, plain_ms))
        if f == 16:
            yard["sorted_chunk_add"] = k2_yardsticks(
                chunk.row_ptr, chunk.col, chunk.val, x, base[chunk.r0 : chunk.r0 + chunk.rows]
            )
        log("B11 chunk add", f"F={f}, one chunk ({chunk.rows} rows, "
            f"{chunk.n_edges} edges) onto a random base: max abs err {err:.3e} "
            f"(rel {rel:.3e}), tol {K2_TOL}*(1+|ref|) (f32 sums in another "
            f"order); kernel {ms:.4f} ms a call ({dev_ms:.4f} device), plain "
            f"{plain_ms:.4f} ms")
    del x, base, got, want, outside
    log("B11 chunk add", f"phase {time.perf_counter() - t_phase:.1f} s")

    # 12. stream pass: regenerated and cached passes, vs plain; symmetry
    t_phase = time.perf_counter()
    x = torch.randn((n, 16), generator=gen, device=dev).bfloat16()
    regen, regen_s = wall(lambda: ss.spmm_streamed_sorted(lattice, x))
    got, cached_s = wall(lambda: ss.spmm_streamed_sorted(src, x))
    if not torch.equal(regen, got):
        raise AssertionError("a regenerated lattice pass differs from the cached one")
    want, plain_s = wall(lambda: ss.spmm_streamed_sorted(src, x, reduce=row_reduce_plain))
    err, rel = compare(got, want, K2_TOL)
    ms16 = cuda_ms(lambda: ss.spmm_streamed_sorted(src, x), reps=3, warmup=1)
    x8 = torch.randn((n, 8), generator=gen, device=dev).bfloat16()
    ms8 = cuda_ms(lambda: ss.spmm_streamed_sorted(src, x8), reps=3, warmup=1)
    _, plain8_s = wall(lambda: ss.spmm_streamed_sorted(src, x8, reduce=row_reduce_plain))
    del regen, got, want, x8
    xs = torch.rand((n, 16), generator=gen, device=dev).bfloat16()
    ys = torch.rand((n, 16), generator=gen, device=dev).bfloat16()
    lhs = (ss.spmm_streamed_sorted(src, xs).double() * ys.double()).sum()
    rhs = (xs.double() * ss.spmm_streamed_sorted(src, ys).double()).sum()
    sym_rel = float((lhs - rhs).abs() / lhs.abs())
    if not sym_rel <= SYM_TOL:
        raise AssertionError(f"stream pass not symmetric: rel {sym_rel:.3e} > {SYM_TOL}")
    del xs, ys, x
    log("stream pass", f"F=16 pass over {n_chunks} chunks vs plain: max abs err "
        f"{err:.3e} (rel {rel:.3e}), tol {K2_TOL}*(1+|ref|); regenerating pass "
        f"== cached pass; <Ax,y> vs <x,Ay> rel {sym_rel:.3e} (tol {SYM_TOL}); "
        f"pass with generation {1000 * regen_s:.1f} ms, cached pass (host clock) "
        f"{1000 * cached_s:.1f} ms, cached pass {ms16:.3f} ms at F=16 and "
        f"{ms8:.3f} ms at F=8 (CUDA events, 3 reps); plain pass {1000 * plain_s:.1f} "
        f"ms at F=16, {1000 * plain8_s:.1f} ms at F=8 (host clock); phase "
        f"{time.perf_counter() - t_phase:.1f} s")

    # 13. stream train: the segmented GCN step on the cached stream, then
    # each other family's ("stream sgc", ..., "stream gcnii")
    y = torch.randint(0, STREAM_C, (n,), generator=gen, device=dev)
    # the features carry the label, as the JAX package's streamed train test
    x = torch.randn((n, STREAM_F), generator=gen, device=dev, dtype=torch.bfloat16).mul_(0.1)
    x += (torch.arange(STREAM_F, device=dev) % STREAM_C == y[:, None]).to(torch.bfloat16)
    mask = (torch.rand(n, generator=gen, device=dev) < 0.5).float()
    data = (src, n_chunks, n, lattice.n_edges, x, y, mask)
    launches, loss_k, grads_k0 = stream_train_phase("gcn", dev, data)
    singles = {"gcn": (loss_k, grads_k0)}
    host, pin_s = wall(lambda: pinned_copies(list(src)))
    for family in STREAM_PASSES:
        if family != "gcn":
            fam_launches, fam_loss, fam_grads = stream_train_phase(family, dev, data)
            launches += fam_launches
            if family in ("sgc", "appnp"):
                singles[family] = (fam_loss, fam_grads)
    total_bytes = src.cached_bytes

    # 13b. mesh stream pass / train: route B.4 at P = 1 (an NCCL group of one)
    t_phase = time.perf_counter()
    mesh_launches, pass_line, train_line = spawn_ranks(
        mesh_stream_one_rank, 1, (src, x, y, mask, singles), backend="nccl",
        devices=["cuda:0"], timeout_s=600.0)
    log("mesh stream pass", pass_line)
    log("mesh stream train", f"{train_line}; phase {time.perf_counter() - t_phase:.1f} s")
    del src, data, singles

    # 14. stream beyond: the device cache holds half the chunks' bytes, the
    # rest are copied in from pinned host memory on each of the step's passes
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    budget = total_bytes // 2
    part = ss.CachedChunkSource(host.__getitem__, n_chunks, budget, dev)
    params, opt = stream_init("gcn", dev, torch.optim.SGD, 0.0)
    step = st.make_streamed_train_step_segmented(st.make_sorted_stream(part), n, opt)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(2):
        steps.append(wall(lambda: float(step(params, x, y, mask))))
    beyond_peak = torch.cuda.max_memory_allocated()
    (loss_b, first_s), (loss_b2, second_s) = steps
    n_cached = part.cached_bytes // host[0].nbytes  # lattice chunks are equal in size
    want_loads = n_chunks + 7 * (n_chunks - n_cached)
    if part.cached_bytes > budget or part.host_loads != want_loads or n_cached == 0:
        raise AssertionError(f"beyond-memory source: {part.cached_bytes} B cached of "
                             f"{budget}, {part.host_loads} host loads, want {want_loads}")
    loss_rel_b = abs(loss_b - loss_k) / abs(loss_k)
    grad_rel_b = {
        k: float((p.grad - grads_k0[k]).abs().max() / grads_k0[k].abs().max())
        for k, p in params.items()
    }
    if not (loss_b2 == loss_b and loss_rel_b <= STEP_LOSS_TOL
            and max(grad_rel_b.values()) <= STEP_GRAD_TOL):
        raise AssertionError(f"step with host-fed chunks vs resident: loss {loss_b} "
                             f"{loss_b2} vs {loss_k}, grads {grad_rel_b}")
    log("stream beyond", f"one step with the device cache holding {n_cached} of "
        f"{n_chunks} chunks ({part.cached_bytes} of {total_bytes} bytes, budget "
        f"{budget}); {n_chunks - n_cached} chunks copied from pinned host memory "
        f"on each pass, {part.host_loads} host loads over two steps; vs the "
        f"resident step on K2: loss rel {loss_rel_b:.3e} (tol {STEP_LOSS_TOL}), "
        f"grads rel to max {', '.join(f'{k} {v:.3e}' for k, v in grad_rel_b.items())} "
        f"(tol {STEP_GRAD_TOL}); step 1 {first_s:.3f} s, step 2 {second_s:.3f} s; "
        f"peak memory {beyond_peak} bytes allocated; pinned host copies made in "
        f"{pin_s:.3f} s; phase {time.perf_counter() - t_phase:.1f} s")
    del x, y, mask, params, opt, step, part, host, lattice

    # 15. stream hostfed: R8 doc-word from pinned host chunks
    t_phase = time.perf_counter()
    sg, perm = convert_graph(r8_graph, "streamed")
    if perm is not None or sg.n_chunks < 4 or not sg.chunks[0].col.is_pinned():
        raise AssertionError("convert_graph(streamed): not >= 4 pinned host chunks")
    x = torch.randn((sg.n_nodes, 200), generator=gen, device=dev).bfloat16()
    got, host_s = wall(lambda: spmm(sg, x))
    want = spmm_coo_segment(r8_graph.row, r8_graph.col, r8_graph.val, x.float(), sg.n_nodes)
    err, rel = compare(got, want, K2_TOL)
    with tempfile.TemporaryDirectory() as d:
        ss.save_chunks(sg.chunks, d, sg.n_nodes)
        loads = []
        for budget in (1 << 30, 0):
            src = ss.CachedChunkSource(ss.chunk_loader_from_dir(d), sg.n_chunks, budget, dev)
            outs = [ss.spmm_streamed_sorted_hostfed(src, x) for _ in range(2)]
            if not all(torch.equal(o, got) for o in outs):
                raise AssertionError("a cached host-fed pass differs from the pinned one")
            loads.append(src.host_loads)
    if loads != [sg.n_chunks, 2 * sg.n_chunks]:
        raise AssertionError(f"CachedChunkSource host loads {loads}")
    log("stream hostfed", f"R8 doc-word ({sg.n_nodes} nodes, {sg.n_edges} "
        f"edges) in {sg.n_chunks} pinned host chunks, F=200 vs the segment "
        f"oracle: max abs err {err:.3e} (rel {rel:.3e}), tol {K2_TOL}*(1+|ref|); "
        f"host-fed pass {1000 * host_s:.2f} ms (host clock, first); "
        f"CachedChunkSource host loads over two passes {loads[0]} (full "
        f"budget), {loads[1]} (zero budget); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    del x, got, want, src

    # 15b. stream accuracy: the streamed GCN step and the resident Trainer
    stream_accuracy_phase(dev, r8_graph, r8_labels, sg)
    return launches, mesh_launches


def shard_phase(dev, gen, records, yard, h, row, col, val):
    """B10 at SHARDS ranks of R8 doc-word, in this process: each rank's
    share built from the degree-sorted graph; K1 on its rectangular block
    (``bsr_leg``) and its whole pass against the plain versions; the shards
    put together against the single-device hybrid pass ``h``."""
    from textgcn_tpu_torch.graph.reorder import feature_table, hybrid_pass
    from textgcn_tpu_torch.ops.bsr_spmm import bsr_leg, bsr_spmm_plain
    from textgcn_tpu_torch.parallel.mesh_kernels import (
        MeshHybridAllGather, shard_hybrid_pass, shard_hybrid_pass_plain,
    )

    t_phase = time.perf_counter()
    n = h.n_nodes
    shards = [
        MeshHybridAllGather.from_coo(row, col, val, n, SHARDS, p, device=dev)
        for p in range(SHARDS)
    ]
    build_s = time.perf_counter() - t_phase
    m0 = shards[0]
    log("B10 shard legs", f"{SHARDS} shards of {m0.rows_per_shard} rows ({m0.n_pad} "
        f"padded, {m0.n_pad // 128} block-columns): tiles "
        f"{[m.bsr.nnzb for m in shards]} ({m0.bsr_edges} tile edges in all, the "
        f"single-device hybrid's {h.bsr.n_edges}), residual edges "
        f"{[0 if m.rest is None else m.rest.n_edges for m in shards]}; built in "
        f"{build_s:.1f} s on the host")
    for f in (200, 8):
        x = torch.zeros((m0.n_pad, f), device=dev)
        x[:n] = torch.randn((n, f), generator=gen, device=dev)
        xp = feature_table(x, m0.n_pad, torch.bfloat16)
        outs, cells = [], []
        for m in shards:
            b = m.bsr
            args = (b.blocks, b.tile_ptr, b.block_cols, xp)
            leg = bsr_leg(*args, split=b.split)
            if not torch.equal(leg, bsr_leg(*args, split=b.split)):
                raise AssertionError(f"two bsr_leg launches differ on rank {m.shard} at F={f}")
            err, _ = compare(leg, bsr_spmm_plain(*args), K1_TOL)
            ms, dev_ms = both_ms(lambda: bsr_leg(*args, split=b.split))
            plain_ms = cuda_ms(lambda: bsr_spmm_plain(*args))
            yard_m = k1_yardsticks(b, xp, m0.n_pad)
            bound_ms, bound_by, lib_ms = yard_m[:3]
            out = shard_hybrid_pass(m, x)
            perr, _ = compare(out, shard_hybrid_pass_plain(m, x), K1_TOL)
            pass_ms = cuda_ms(lambda: shard_hybrid_pass(m, x))
            outs.append(out)
            records.setdefault("bsr_leg", []).append((max(err, perr), ms, dev_ms, plain_ms))
            yard.setdefault("bsr_leg", yard_m)
            cells.append(f"rank {m.shard}: {b.nnzb} tiles ("
                         f"{0 if b.split is None else b.split.n_seg} segments), two "
                         f"launches bit-equal, K1 {ms:.4f} ms a call "
                         f"({dev_ms:.4f} device; plain "
                         f"{plain_ms:.4f}, bound {bound_ms:.4f} by {bound_by}, "
                         f"torch.sparse.mm {lib_ms:.4f}), pass {pass_ms:.4f} ms, "
                         f"err K1 {err:.3e} pass {perr:.3e}")
        whole = torch.cat(outs)
        want = hybrid_pass(h, x[:n])
        if not torch.equal(whole[:n], want):
            err, _ = compare(whole[:n], want, K1_TOL)
            raise AssertionError(f"the {SHARDS} shards put together differ from the "
                                 f"single-device hybrid pass at F={f} (max abs err {err:.3e})")
        if whole[n:].any():
            raise AssertionError("shard rows past the last node are not zero")
        log("B10 shard legs", f"F={f}: {'; '.join(cells)}; tol {K1_TOL}*(1+|ref|) "
            f"(same bf16 products, f32 sums in another order); the {SHARDS} shards "
            f"put together vs the single-device hybrid pass: bit-equal")
    del shards, outs, whole, want, x, xp
    log("B10 shard legs", f"phase {time.perf_counter() - t_phase:.1f} s")


def attention_spmm_path(att, ag, gen, counters, steps=3):
    """The other attention op's path: ``attention_spmm`` (softmax-weighted
    aggregation of given logits, the op that takes B6), forward and backward
    at F=200 on the degree-sorted R8 attention graph, ``steps`` times with
    every launch count set to 0 just before; the op and its gradients are
    held against an f32 autograd oracle of plain PyTorch ops. Returns the
    counts read just after."""
    dev, n, f = ag.row.device, ag.n_nodes, 200
    rows, cols = ag.row.long(), ag.col.long()
    logits = torch.randn(ag.n_edges, generator=gen, device=dev)
    logits[::50] = -float("inf")  # dropped edges
    # bf16-representable features and cotangent: the kernels' casts are exact
    x = torch.randn((n, f), generator=gen, device=dev).bfloat16().float()
    cot = torch.randn((n, f), generator=gen, device=dev).bfloat16().float()

    def oracle(lg, xx):
        mx = torch.full((n,), -1e30, device=dev).scatter_reduce(0, rows, lg.detach(), "amax")
        w = torch.exp(lg - mx[rows])
        s = torch.zeros(n, device=dev).index_add(0, rows, w)
        w = w / s.clamp_min(1e-30)[rows]
        return torch.zeros((n, f), device=dev).index_add(0, rows, w[:, None] * xx[cols])

    res = []
    for fn in (att.attention_spmm, None):
        lg, xx = logits.clone().requires_grad_(True), x.clone().requires_grad_(True)
        if fn is None:
            out = oracle(lg, xx)
            out.backward(cot)
            res.append((out.detach(), lg.grad, xx.grad))
            continue
        for fns in counters.values():
            for c in fns:
                c.launches = 0
        t0 = time.perf_counter()
        for _ in range(steps):
            lg.grad = xx.grad = None
            out = fn(ag, lg, xx)
            out.backward(cot)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        launches = {k: sum(c.launches for c in fns) for k, fns in counters.items()}
        res.append((out.detach(), lg.grad, xx.grad))
    need = ("softmax_stats", "attn_agg", "sddmm", "rowsum", "row_reduce")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the attention_spmm path never launched: {launches}")
    errs = [compare(a, b, GAT_LAYER_TOL)[0] for a, b in zip(*res)]
    log("attention_spmm", f"F=200 fwd+bwd on the kernels ({steps} steps, "
        f"{step_ms:.3f} ms a step, host clock) vs an f32 autograd oracle: max abs err "
        f"out {errs[0]:.3e}, dlogits {errs[1]:.3e}, dx {errs[2]:.3e}; tol "
        f"{GAT_LAYER_TOL}*(1+|ref|) (bf16-representable x and cotangent, f32 sums in "
        f"another order); launches {launches}")
    return launches


def run_cli(cli, args, counters, graph, dataset="R8"):
    """``cli train --dataset {dataset} *args`` with every launch count set to
    0 just before; returns (the report, the counts read just after, summed
    over each kernel's wrappers, and the wall seconds). Raises unless it
    returns 0 with finite losses in every run."""
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        rc = cli.main(["train", "--dataset", dataset, *args, "--quiet", "--output_dir", out_dir])
        wall_s = time.perf_counter() - t0
        launches = {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}
        with open(os.path.join(out_dir, f"{dataset}_{graph}_training_results.json")) as fh:
            summary = json.load(fh)
    if rc != 0:
        raise AssertionError(f"cli train {' '.join(args)} returned {rc}")
    if not all(
        math.isfinite(r[k]) for run in summary["runs"] for r in run["history"]
        for k in ("train_loss", "val_loss")
    ):
        raise AssertionError(f"non-finite loss in a training history of {' '.join(args)}")
    return summary, launches, wall_s


def train_via_cli(cli, model, flags, acc_min, counters, need, sharding=None):
    """Train R8 doc-word once through the port's CLI with every launch count
    set to 0 just before; check the run (a sharded run's report must carry
    ``sharding``) and return the counts (summed over each kernel's wrappers)
    read just after."""
    summary, launches, wall_s = run_cli(
        cli, ["--graph", "docword", *flags, "--times", "1", "--seed", str(SEED)],
        counters, "docword",
    )
    if summary.get("sharding") != sharding:
        raise AssertionError(f"the run's report has sharding {summary.get('sharding')}, "
                             f"expected {sharding}")
    if need and min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the {model} path never launched: {launches}")
    run = summary["runs"][0]
    test = run["test"]
    epochs = run["epochs_run"]
    log(f"train {model}", f"cli train R8 docword {' '.join(flags)} seed "
        f"{run['seed']}: {epochs} epochs, train {test['train_time']:.3f} s = "
        f"{1000 * test['train_time'] / epochs:.3f} ms/epoch, {wall_s:.1f} s with "
        f"data prep; test acc {test['acc']:.4f}, macro-F1 "
        f"{test['macro_f1']:.4f}; launches {launches}; peak memory "
        f"{json.dumps(summary['device_memory'])}")
    if test["acc"] < acc_min:
        raise AssertionError(f"{model} test accuracy {test['acc']:.4f} < {acc_min}")
    return launches, run


def train_sharded_ranks(pre, counters, run1):
    """SHARDS ranks of the sharded GCN on this one card through the library
    (gloo), the CLI run's seed and settings, every launch count set to 0 just
    before; rank 0 runs in this process, so the counts read just after are
    its own. ``run1`` is the CLI's one-rank run, printed beside it."""
    from textgcn_tpu_torch.parallel.launch import HostData, run_sharded_seeds
    from textgcn_tpu_torch.train.run import generate_seeds
    from textgcn_tpu_torch.train.trainer import TrainConfig

    data = HostData.from_prepared(pre)
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    t0 = time.perf_counter()
    (run,) = run_sharded_seeds(
        data, generate_seeds(1, SEED), TrainConfig(spmm="hybrid"), SHARDS,
        backend="gloo", devices=["cuda:0"] * SHARDS,
    )["runs"]
    wall_s = time.perf_counter() - t0
    launches = {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}
    if min(launches["bsr_leg"], launches["row_reduce"]) < 1:
        raise AssertionError(f"a kernel of the sharded path never launched on rank 0: {launches}")
    hist, test = run["history"], run["test"]
    if not all(math.isfinite(r[k]) for r in hist for k in ("train_loss", "val_loss")):
        raise AssertionError("non-finite loss in the sharded training history")
    common = min(len(hist), len(run1["history"]))
    drift = max(
        abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
        for a, b in zip(hist[:common], run1["history"][:common])
    )
    log("train sharded x4", f"{SHARDS} ranks on cuda:0 (gloo), seed {run['seed']}: "
        f"{len(hist)} epochs, train {test['train_time']:.3f} s = "
        f"{1000 * test['train_time'] / len(hist):.3f} ms/epoch, {wall_s:.1f} s with "
        f"spawn and set-up; test acc {test['acc']:.4f}, macro-F1 {test['macro_f1']:.4f}; "
        f"rank 0 launches {launches}; vs the one-rank CLI run ({run1['epochs_run']} "
        f"epochs, acc {run1['test']['acc']:.4f}): train loss max rel diff {drift:.3e} "
        f"over the first {common} epochs")
    if test["acc"] < ACC_MIN:
        raise AssertionError(f"sharded x{SHARDS} test accuracy {test['acc']:.4f} < {ACC_MIN}")
    return launches


def native_prep_phase(dev):
    """"native prep": R8 doc-word prepared on the native graph core and on
    the port's numpy path (forced by patching ``native.available``, the
    tests' hook), the file read once before either; each path's parse,
    max-symmetrize + normalize and whole ``prepare_docword_data`` timed on
    the host. The two float32 ``SparseGraph``s must be bit-equal (row, col,
    val). Returns the native path's PreparedData."""
    from unittest import mock

    from textgcn_tpu_torch import native
    from textgcn_tpu_torch.graph.build_topic import read_weighted_edgelist
    from textgcn_tpu_torch.train.prepare import normalize_edges, prepare_docword_data

    if not native.available():
        raise AssertionError("no C++ compiler on PATH: the native graph core cannot be built")
    t0 = time.perf_counter()
    lib = native.build()
    build_s = time.perf_counter() - t0
    path = os.path.join(REPO, "data", "graph", "R8_docword.txt")
    with open(path, "rb") as fh:
        size = len(fh.read())
    pres, times = {}, {}
    for name in ("native", "numpy"):
        hook = (contextlib.nullcontext() if name == "native"
                else mock.patch.object(native, "available", lambda: False))
        with hook:
            t0 = time.perf_counter()
            pre = prepare_docword_data("R8", device=dev)
            torch.cuda.synchronize()
            whole = time.perf_counter() - t0
            t0 = time.perf_counter()
            src, dst, w = read_weighted_edgelist(path)
            parse = time.perf_counter() - t0
            t0 = time.perf_counter()
            normalize_edges(src, dst, w, pre.graph.n_nodes)
            norm = time.perf_counter() - t0
        pres[name], times[name] = pre, (parse, norm, whole)
    a, b = pres["native"].graph, pres["numpy"].graph
    same = a.n_edges == b.n_edges and all(
        torch.equal(getattr(a, k), getattr(b, k)) for k in ("row", "col", "val"))
    (pn, nn, wn), (pp, np_, wp) = times["native"], times["numpy"]
    log("native prep", f"R8 doc-word ({size} bytes, {len(src)} lines; {a.n_edges} edges "
        f"after symmetrize + self-loops) on the host: native core {lib.name} built or reused "
        f"in {build_s:.2f} s; native parse {pn:.3f} s, normalize {nn:.3f} s, whole "
        f"prepare_docword_data {wn:.3f} s; numpy path parse {pp:.3f} s, normalize {np_:.3f} s, "
        f"whole {wp:.3f} s; f32 SparseGraphs bit-equal (row, col, val): {same}")
    if not same:
        raise AssertionError("the native and numpy preparations of R8 doc-word differ")
    return pres["native"]


# one rank of "launcher ranks", written into a temporary directory and started
# by ``python -m torch.distributed.run``: argv is the checkout, the backend,
# the output path, the seed and the epochs
LAUNCHER_WORKER = """\
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from textgcn_tpu_torch.ops.bsr_spmm import bsr_leg
from textgcn_tpu_torch.ops.row_reduce import row_reduce
from textgcn_tpu_torch.parallel import distributed, launch
from textgcn_tpu_torch.train.prepare import prepare_docword_data
from textgcn_tpu_torch.train.trainer import TrainConfig

repo, backend, out_path, seed, epochs = sys.argv[1:]
# gloo: both ranks on cuda:0 (NCCL refuses two ranks on one device)
device = torch.device("cuda", 0) if backend == "gloo" else distributed.local_device()
if not distributed.init_distributed(backend=backend):
    raise RuntimeError("no multi-process job in the launcher's environment")
try:
    summary = distributed.process_summary(device)
    pre = prepare_docword_data("R8", data_root=os.path.join(repo, "data"), device="cpu")
    bsr_leg.launches = row_reduce.launches = 0
    out = launch.run_joined(
        launch.HostData.from_prepared(pre), [int(seed)],
        TrainConfig(spmm="hybrid", max_epoch=int(epochs), early_stopping=1000),
        kernel="hybrid", partition="allgather", device=device,
    )
    launches = {"bsr_leg": bsr_leg.launches, "row_reduce": row_reduce.launches}
finally:
    torch.distributed.destroy_process_group()
if out is not None:
    with open(out_path, "w") as fh:
        json.dump({"runs": out["runs"], "launches": launches, "summary": summary}, fh)
"""
LAUNCHER_EPOCHS, LAUNCHER_TIMEOUT_S = 5, 300


def launcher_ranks_phase(pre):
    """"launcher ranks": 2 ranks started by ``python -m torch.distributed.run
    --standalone --nproc_per_node 2`` (a worker script in a temporary
    directory; each rank joins with ``init_distributed`` and trains through
    ``run_joined``), both on cuda:0 over gloo: the R8 doc-word GCN under
    hybrid/allgather for LAUNCHER_EPOCHS epochs at SEED. Every epoch's losses
    must be bit-equal to ``run_sharded_seeds`` on 2 spawned ranks with the
    same seed and settings, and rank 0 must launch B10 and K2. With two GPUs
    or more, the same over NCCL, rank r on ``local_device()``, against the
    spawned NCCL ranks. A nonzero exit or LAUNCHER_TIMEOUT_S fails the run.
    Returns the launcher-started rank 0's launches (summed over the runs)."""
    from textgcn_tpu_torch.parallel.launch import HostData, run_sharded_seeds
    from textgcn_tpu_torch.train.trainer import TrainConfig

    data = HostData.from_prepared(pre)
    cfg = TrainConfig(spmm="hybrid", max_epoch=LAUNCHER_EPOCHS, early_stopping=1000)
    backends = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    total = {"bsr_leg": 0, "row_reduce": 0}
    with tempfile.TemporaryDirectory() as tmp:
        worker = os.path.join(tmp, "launcher_worker.py")
        with open(worker, "w") as fh:
            fh.write(LAUNCHER_WORKER)
        for backend in backends:
            devices = ["cuda:0"] * 2 if backend == "gloo" else ["cuda:0", "cuda:1"]
            t0 = time.perf_counter()
            (ref,) = run_sharded_seeds(data, [SEED], cfg, 2, kernel="hybrid",
                                       partition="allgather", backend=backend,
                                       devices=devices)["runs"]
            spawn_s = time.perf_counter() - t0
            out_path = os.path.join(tmp, f"{backend}.json")
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", "2", worker, REPO, backend, out_path, str(SEED),
                   str(LAUNCHER_EPOCHS)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=LAUNCHER_TIMEOUT_S)
            except subprocess.TimeoutExpired as e:
                raise AssertionError(f"torchrun over {backend} passed {LAUNCHER_TIMEOUT_S} s: "
                                     f"{str(e.stderr)[-2000:]}") from e
            run_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"torchrun over {backend} exited {proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            with open(out_path) as fh:
                got = json.load(fh)
            (run,) = got["runs"]
            check_run(run, f"the launcher-started ranks over {backend}")
            keys = ("train_loss", "val_loss", "acc")
            same = len(run["history"]) == len(ref["history"]) == LAUNCHER_EPOCHS and all(
                a[k] == b[k] for a, b in zip(run["history"], ref["history"]) for k in keys)
            launches = got["launches"]
            log("launcher ranks", f"torchrun --standalone --nproc_per_node 2, {backend} on "
                f"{', '.join(devices)}, R8 doc-word hybrid/allgather, seed {SEED}: "
                f"{got['summary']}; {LAUNCHER_EPOCHS} epochs, train "
                f"{run['test']['train_time']:.3f} s, {run_s:.1f} s with start-up; losses "
                f"bit-equal to run_sharded_seeds on 2 spawned ranks ({spawn_s:.1f} s): {same}; "
                f"test acc {run['test']['acc']:.4f} (spawned {ref['test']['acc']:.4f}); rank 0 "
                f"launches {launches}")
            if not same:
                raise AssertionError(f"the launcher-started ranks over {backend} differ from "
                                     f"the spawned ranks: {run['history']} vs {ref['history']}")
            if min(launches.values()) < 1:
                raise AssertionError(f"a kernel of the sharded path never launched on the "
                                     f"launcher-started rank 0: {launches}")
            for k, v in launches.items():
                total[k] += v
    if len(backends) == 1:
        log("launcher ranks", f"NCCL branch not run: {torch.cuda.device_count()} GPU(s), it "
            f"needs two")
    return total


def topic_gat_report_phase(topic_pre, dev):
    """"topic_gat report" (C.6): ``run_experiment("R8", graph_family=
    "topic_gat", pre_data=<the topic data>)`` with the GAT on --spmm segment,
    one seed, TOPIC_GAT_EPOCHS epochs, into a temporary directory: the name
    names the reports of the topic graph, as in JAX (``bench.py``'s GAT
    pass), so it must write exactly ``R8_topic_gat_training_results.{json,
    txt}``, with finite losses."""
    from textgcn_tpu_torch.train.run import run_experiment
    from textgcn_tpu_torch.train.trainer import TrainConfig

    cfg = TrainConfig(model="gat", spmm="segment", max_epoch=TOPIC_GAT_EPOCHS)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        summary = run_experiment("R8", seeds=[HYBRID_SEED], graph_family="topic_gat",
                                 pre_data=topic_pre, output_dir=out, config=cfg,
                                 verbose=False, device=dev)
        secs = time.perf_counter() - t0
        names = sorted(os.listdir(out))
        with open(os.path.join(out, "R8_topic_gat_training_results.json")) as fh:
            written = json.load(fh)
    want = ["R8_topic_gat_training_results.json", "R8_topic_gat_training_results.txt"]
    (run,) = summary["runs"]
    check_run(run, "the topic_gat run")
    log("topic_gat report", f"run_experiment R8, graph_family topic_gat, pre_data = the topic "
        f"data, GAT segment, seed {HYBRID_SEED}, {run['epochs_run']} epochs in {secs:.1f} s: "
        f"wrote {names}; graph_family {written['graph_family']!r}, test acc "
        f"{run['test']['acc']:.4f}")
    if names != want or written["graph_family"] != "topic_gat":
        raise AssertionError(f"the topic_gat run wrote {names}, expected {want}")


def edge_ops_phase(att, ag, gen, records, counters):
    """The learnable-edge ops on the degree-sorted R8 doc-word attention
    graph at F=200: ``edge_logit_base`` (rowsum over each CSR with its
    table in the backward) and ``spmm_onehot_ew`` (K2 from zero forward and,
    over the transpose CSR, as dx; ``sddmm`` for dval), forward and backward
    with every launch count set to 0 just before; each kernel's output held
    against its plain version on the same inputs, two runs bit-equal.
    Returns the counts read just after."""
    from textgcn_tpu_torch.ops.row_reduce import row_reduce_plain

    dev, n, f = ag.row.device, ag.n_nodes, 200
    es = torch.randn(n, generator=gen, device=dev)
    ed = torch.randn(n, generator=gen, device=dev)
    g_e = torch.randn(ag.n_edges, generator=gen, device=dev)
    # learnable edge values as the learnable-edge GCN gives them: Â's
    # values times exp(edge_logit), the logits drawn near 0
    val = torch.exp(ag.logval + 0.1 * torch.randn(ag.n_edges, generator=gen, device=dev))
    x = torch.randn((n, f), generator=gen, device=dev)
    cot = torch.randn((n, f), generator=gen, device=dev)

    def run():
        a, b = es.clone().requires_grad_(True), ed.clone().requires_grad_(True)
        base = att.edge_logit_base(ag, a, b)
        base.backward(g_e)
        v, xx = val.clone().requires_grad_(True), x.clone().requires_grad_(True)
        out = att.spmm_onehot_ew(ag, v, xx)
        out.backward(cot)
        return base.detach(), a.grad, b.grad, out.detach(), v.grad, xx.grad

    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    t0 = time.perf_counter()
    got = run()
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = {k: sum(fn.launches for fn in fns) for k, fns in counters.items()}
    if min(launches[k] for k in ("rowsum", "row_reduce", "sddmm")) < 1:
        raise AssertionError(f"a kernel of the edge ops never launched: {launches}")
    if not all(map(torch.equal, got, run())):
        raise AssertionError("two runs of the edge ops differ")
    base, des, ded, out, dval, dx = got
    x16, g16 = att.features_bf16(x), att.features_bf16(cot)
    # each kernel against its plain version on the inputs the op gave it
    errs = {
        "base": compare(base, es[ag.row.long()] + ed[ag.col.long()], 0.0)[0],
        "des (rowsum)": compare(des, att.rowsum_plain(ag.row_ptr, g_e), ATT_TOL)[0],
        "ded (rowsum)": compare(
            ded, att.rowsum_plain(ag.row_ptr_t, g_e.index_select(0, ag.perm_t)), ATT_TOL)[0],
        "out (K2)": compare(out, row_reduce_plain(ag.row_ptr, ag.col, val, x16), K2_TOL)[0],
        "dx (K2)": compare(dx, row_reduce_plain(
            ag.row_ptr_t, ag.col_t, val.index_select(0, ag.perm_t), g16), K2_TOL)[0],
        "dval (sddmm)": compare(
            dval, att.sddmm_plain(ag.row_ptr, ag.col, g16, x16), ATT_TOL)[0],
    }
    # errors only: the records' times come from the phases that time them
    for name, err in (("rowsum", max(errs["des (rowsum)"], errs["ded (rowsum)"])),
                      ("row_reduce_dx", max(errs["out (K2)"], errs["dx (K2)"])),
                      ("sddmm", errs["dval (sddmm)"])):
        records.setdefault(name, []).append((err, None, None, None))
    a, v = es.clone().requires_grad_(True), val.clone().requires_grad_(True)
    elb_ms = cuda_ms(lambda: att.edge_logit_base(ag, a, ed).backward(g_e), reps=5)
    ew_ms = cuda_ms(lambda: att.spmm_onehot_ew(ag, v, x).backward(cot), reps=5)
    log("edge ops", f"R8 doc-word attention graph, F={f}: edge_logit_base fwd+bwd "
        f"{elb_ms:.4f} ms, spmm_onehot_ew fwd+bwd {ew_ms:.4f} ms (a call, CUDA events; "
        f"the first run {first_ms:.1f} ms on the host clock); max abs err vs plain "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; tol rowsum and sddmm {ATT_TOL}, K2 {K2_TOL} *(1+|ref|), the base exact; two "
        f"runs bit-equal; launches {launches}")
    return launches


def edge_gcn_phase(graph, labels, dev, steps=10):
    """The learnable-edge GCN (``gcn_edge_forward``, the segment path, no
    hand kernel) on R8 doc-word at the JAX width (n_hidden 200): ``steps``
    Adam steps of the masked cross-entropy from a seeded init; the loss must
    fall and ``edge_logit`` move off 0."""
    import torch.nn.functional as F

    from textgcn_tpu_torch.models.gcn import gcn_edge_forward, gcn_edge_init

    gen = torch.Generator(device=dev).manual_seed(SEED)
    p = gcn_edge_init(gen, graph, graph.n_nodes, 200, labels.n_classes, device=dev)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    opt = torch.optim.Adam(p.values(), lr=0.02)
    tr = torch.as_tensor(np.asarray(labels.train_idx), device=dev)
    y = torch.as_tensor(np.asarray(labels.target), device=dev)[tr]
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        logits = gcn_edge_forward(p, graph, None, train=True, generator=gen)
        loss = F.cross_entropy(logits[tr], y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    step_s = (time.perf_counter() - t0) / steps
    moved = float(p["edge_logit"].detach().abs().max())
    log("edge gcn", f"gcn_edge_forward on R8 doc-word ({graph.n_edges} edges), n_hidden 200, "
        f"{steps} Adam steps (lr 0.02, dropout 0.5): loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
        f"max |edge_logit| {moved:.4e}, {1e3 * step_s:.1f} ms a step (host clock), peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0] and moved > 0):
        raise AssertionError(f"the learnable-edge GCN did not train: {losses}, {moved}")


def mesh_onehot_rank(rank, world, device, row, col, val, n, f, reps):
    """One of SHARDS gloo ranks on the card: its all-gather and halo one-hot
    passes (K2) against the same passes through K2's plain version, two
    passes bit-equal; K2's launches a pass and the pass's ms (CUDA events
    over ``reps`` passes after a barrier; the four ranks share the card and
    gloo stages the ring's blocks through the host). Rank 0 returns every
    rank's numbers and the outputs gathered over the ranks."""
    import torch.distributed as dist

    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.parallel.distributed import all_gather_rows
    from textgcn_tpu_torch.parallel.mesh_kernels import (
        MeshOneHotAllGather, MeshOneHotHalo, allgather_onehot_pass, halo_onehot_pass,
        shard_onehot_pass,
    )

    mag = MeshOneHotAllGather.from_coo(row, col, val, n, world, rank, device=device)
    mhalo = MeshOneHotHalo.from_coo(row, col, val, n, world, rank, device=device)
    rps = mag.rows_per_shard
    gen = torch.Generator(device=device).manual_seed(SEED)
    x_full = torch.zeros((mag.n_pad, f), device=device)
    x_full[:n] = torch.randn((n, f), generator=gen, device=device)
    x_local = x_full[rank * rps:(rank + 1) * rps].contiguous()
    passes = {
        "allgather_onehot": (lambda: allgather_onehot_pass(mag, x_local),
                             lambda: shard_onehot_pass(mag, x_full, reduce=row_reduce_plain)),
        "halo_onehot": (lambda: halo_onehot_pass(mhalo, x_local),
                        lambda: halo_onehot_pass(mhalo, x_local, reduce=row_reduce_plain)),
    }
    res = {}
    for name, (fn, plain) in passes.items():
        before = row_reduce.launches
        y = fn()
        launches = row_reduce.launches - before
        if not torch.equal(y, fn()):
            raise AssertionError(f"rank {rank}: two {name} passes differ")
        err, _ = compare(y, plain(), K2_TOL)
        torch.cuda.synchronize()
        dist.barrier()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        mine = torch.tensor([err, launches, start.elapsed_time(end) / reps], dtype=torch.float64)
        every = all_gather_rows(mine[None]).tolist()
        res[name] = {"per_rank": every, "out": all_gather_rows(y)}
    mine = torch.tensor([[0 if b is None else b.n_edges for b in mhalo.buckets]
                         + [0 if b is None or b.split is None else b.split.n_seg
                            for b in mhalo.buckets]])
    every = all_gather_rows(mine).tolist()
    res["bucket_edges"] = [r[:world] for r in every]
    res["splits"] = [r[world:] for r in every]
    return res if rank == 0 else None


def mesh_onehot_phase(graph, records):
    """B.1 and B.2 on R8 doc-word at F=200 (no degree sort): the per-shard
    rate of each one-hot layout at P = 1 in this process (the JAX bench's
    ``mesh_kernel_perf`` keys ``halo_onehot``, ``allgather_onehot``), then
    SHARDS gloo ranks on this card (rank 0 here): each rank's passes against
    their plain version and K2's launches a pass, the all-gather shards put
    together bit-equal to the single-device ``--spmm onehot`` pass, the halo
    shards within K2_TOL of it (a bucket a step)."""
    from textgcn_tpu_torch.graph.reorder import CSRGraph, csr_pass
    from textgcn_tpu_torch.parallel.launch import spawn_ranks
    from textgcn_tpu_torch.parallel.mesh_kernels import (
        MeshOneHotAllGather, MeshOneHotHalo, halo_onehot_pass, shard_onehot_pass,
    )

    f, dev = 200, graph.val.device
    row, col, val = graph.coo_numpy()
    n, e = graph.n_nodes, graph.n_edges
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, f), generator=gen, device=dev)
    bench = {}
    for key, cls, fn in (("halo_onehot", MeshOneHotHalo, halo_onehot_pass),
                         ("allgather_onehot", MeshOneHotAllGather, shard_onehot_pass)):
        mg = cls.from_coo(row, col, val, n, 1, 0, device=dev)
        ms = cuda_ms(lambda: fn(mg, x))
        bench[key] = {"pass_ms": ms, "edges_per_s_per_shard": e / (ms / 1e3)}
    log("mesh onehot", f"P=1 per-shard rate (the JAX bench's mesh_kernel_perf): "
        f"{json.dumps(bench)}")
    t0 = time.perf_counter()
    res = spawn_ranks(mesh_onehot_rank, SHARDS, (row, col, val, n, f, 20), backend="gloo",
                      devices=["cuda:0"] * SHARDS, timeout_s=600.0)
    wall_s = time.perf_counter() - t0
    # the ranks drew their features from the same seed: x
    single = csr_pass(CSRGraph.from_coo(row, col, val, n, symmetric=True, device=dev), x)
    ag_out, halo_out = res["allgather_onehot"]["out"], res["halo_onehot"]["out"]
    if not torch.equal(ag_out[:n], single) or ag_out[n:].any():
        raise AssertionError("the all-gather one-hot shards put together differ from the "
                             "single-device onehot pass")
    herr, _ = compare(halo_out[:n], single, K2_TOL)
    for name in ("allgather_onehot", "halo_onehot"):
        per = res[name]["per_rank"]
        err = max(r[0] for r in per)
        records.setdefault("row_reduce_dx" if name == "allgather_onehot" else "row_reduce",
                           []).append((err, None, None, None))
        log("mesh onehot", f"{SHARDS} gloo ranks on cuda:0, {name}: per rank max abs err vs "
            f"plain {[f'{r[0]:.3e}' for r in per]} (tol {K2_TOL}*(1+|ref|)), two passes "
            f"bit-equal, K2 launches a pass {[int(r[1]) for r in per]}, pass ms "
            f"{[round(r[2], 4) for r in per]} (CUDA events over 20 passes, the four ranks "
            "sharing the card, gloo staging the ring through the host)")
    log("mesh onehot", f"halo buckets (p, q), a list a rank: edges {res['bucket_edges']}, "
        f"split segments {res['splits']}; the {SHARDS} all-gather shards put together vs the single-device "
        f"onehot pass: bit-equal; halo shards vs it: max abs err {herr:.3e} (tol {K2_TOL}"
        f"*(1+|ref|): a bucket a step); {wall_s:.1f} s with spawn")


def train_jobs_rank(rank, world, device, datasets, seed, jobs):
    """One rank of sharded trainings on the card: for each job ``(data key,
    family, kernel, partition)`` the family on ``datasets[key]`` from
    ``seed``, every launch count set to 0 just before each (rank 0 runs in
    the calling process, so its counts are the smoke's). Rank 0 returns
    [(run, launches, wall s, whether its layout has residual edges), ...]."""
    from textgcn_tpu_torch.ops import attention as att
    from textgcn_tpu_torch.ops.bsr_spmm import bsr_leg, bsr_spmm
    from textgcn_tpu_torch.ops.row_reduce import row_reduce
    from textgcn_tpu_torch.parallel.trainer import ShardedTrainer
    from textgcn_tpu_torch.train.trainer import TrainConfig

    fns = {"row_reduce": row_reduce, "bsr_leg": bsr_leg, "bsr_spmm": bsr_spmm,
           "attn_stats": att.stats_logits, "softmax_stats": att.softmax_stats,
           "attn_agg": att.attn_agg, "rowsum": att.rowsum, "sddmm": att.sddmm}
    out = []
    for key, model, kernel, partition in jobs:
        data = datasets[key]
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        t = ShardedTrainer(
            data.graph(), data.features, data.target, data.train_idx, data.test_idx,
            data.n_classes, config=TrainConfig(seed=seed, model=model), n_shards=world,
            rank=rank, device=device, kernel=kernel, partition=partition,
        )
        t.fit(verbose=False)
        run = {"seed": seed, "test": t.test(), "history": t.history}
        residual = getattr(t.graph, "rest", None) is not None
        out.append((run, {k: fn.launches for k, fn in fns.items()}, time.perf_counter() - t0,
                    residual))
    return out if rank == 0 else None


def check_run(run, what):
    """Raise on a non-finite loss in a run's history."""
    if not all(math.isfinite(r[k]) for r in run["history"] for k in ("train_loss", "val_loss")):
        raise AssertionError(f"non-finite loss under {what}")


def train_sharded_halo_phase(pre):
    """R8 doc-word on SHARDS gloo ranks on this card under halo-segment,
    halo-onehot and allgather-onehot (one spawn, the trainer's defaults, one
    seed): test accuracy >= ACC_MIN in each, K2 launched on rank 0 under the
    one-hot kernels and no hand kernel under segment. Returns the K2
    launches (B2: halo buckets, B3: allgather from zero)."""
    from textgcn_tpu_torch.parallel.launch import HostData, spawn_ranks
    from textgcn_tpu_torch.train.run import generate_seeds

    combos = [("segment", "halo"), ("onehot", "halo"), ("onehot", "allgather")]
    t0 = time.perf_counter()
    results = spawn_ranks(
        train_jobs_rank, SHARDS,
        ({"docword": HostData.from_prepared(pre)}, generate_seeds(1, SEED)[0],
         [("docword", "gcn", *c) for c in combos]),
        backend="gloo", devices=["cuda:0"] * SHARDS, timeout_s=900.0,
    )
    k2 = {"row_reduce": 0, "row_reduce_dx": 0}
    for (kernel, partition), (run, launches, wall_s, _) in zip(combos, results):
        hist, test = run["history"], run["test"]
        check_run(run, f"{kernel} {partition}")
        used = sum(launches.values())
        if (kernel == "onehot") != (launches["row_reduce"] > 0) or used != launches["row_reduce"]:
            raise AssertionError(f"{kernel} {partition} launched {launches} on rank 0")
        if kernel == "onehot":
            k2["row_reduce" if partition == "halo" else "row_reduce_dx"] += launches["row_reduce"]
        log("train sharded halo", f"{SHARDS} ranks on cuda:0 (gloo), kernel {kernel}, partition "
            f"{partition}, seed {run['seed']}: {len(hist)} epochs, train "
            f"{test['train_time']:.3f} s = {1000 * test['train_time'] / len(hist):.3f} ms/epoch "
            f"({wall_s:.1f} s with set-up); test acc {test['acc']:.4f}, macro-F1 "
            f"{test['macro_f1']:.4f}; rank 0 launches {launches}")
        if test["acc"] < ACC_MIN:
            raise AssertionError(f"{kernel} {partition} test accuracy {test['acc']:.4f} < {ACC_MIN}")
    log("train sharded halo", f"{time.perf_counter() - t0:.1f} s with spawn")
    return k2


# the kernels of GAT's attention op (route B.3): B5, B7, B8, B9 and K2 as dx
ATT_NEED = ("attn_stats", "attn_agg", "sddmm", "rowsum", "row_reduce")
# the sharded families on R8 topic: one (kernel, partition) a family, so
# that the five combinations are each covered once
FAMILY_COMBOS = (("sage", "segment", "halo"), ("sgc", "segment", "allgather"),
                 ("appnp", "onehot", "halo"), ("gin", "onehot", "allgather"),
                 ("gcnii", "hybrid", "allgather"))


def mesh_gat_phase(graph, records):
    """B.3 on R8 doc-word at F=200 and SHARDS ranks, in this process and in
    the JAX node order (no degree sort, as the JAX package's kernel-path
    sharded GAT): for each rank's rectangular attention graph,
    ``gat_attention`` forward and backward on the kernels (each kernel's
    launches must rise; two runs give the same bits), and B5, B7, B8, B9
    and K2 as dx held against their plain versions on the inputs the op
    gives them; each rank's fwd+bwd ms (a call) beside its edges and its
    longest row and column. Then the ranks' forward outputs put together
    must equal the single-card op on the whole attention graph bit for bit,
    and the sums of their dx and ded (the all-gather's transpose) and their
    des put together match its gradients within ATT_TOL."""
    from textgcn_tpu_torch.ops import attention as att
    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.parallel.mesh_attention import MeshAttentionAllGather

    f, dev = 200, graph.val.device
    row, col, val = graph.coo_numpy()
    n = graph.n_nodes
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    t0 = time.perf_counter()
    mgs = [MeshAttentionAllGather.from_coo(row, col, val, n, SHARDS, p, device=dev)
           for p in range(SHARDS)]
    build_s = time.perf_counter() - t0
    n_pad, rps = mgs[0].n_pad, mgs[0].rows_per_shard
    h = torch.zeros((n_pad, f), device=dev)
    h[:n] = torch.randn((n, f), generator=gen, device=dev)
    cot = torch.zeros((n_pad, f), device=dev)
    cot[:n] = torch.randn((n, f), generator=gen, device=dev)
    a_src, a_dst = (torch.randn(f, generator=gen, device=dev) / math.sqrt(f) for _ in range(2))
    es_full, ed_full = h @ a_src, h @ a_dst
    fns = {"attn_stats": att.stats_logits, "attn_agg": att.attn_agg, "sddmm": att.sddmm,
           "rowsum": att.rowsum, "row_reduce": row_reduce}

    def fwd_bwd(ag, es, ed, x, g):
        es, ed, x = (t.clone().requires_grad_(True) for t in (es, ed, x))
        out = att.gat_attention(ag, es, ed, x, SLOPE)
        out.backward(g)
        return out.detach(), es.grad, ed.grad, x.grad

    outs, des_all, ded_sum, dx_sum, per_rank = [], [], 0.0, 0.0, []
    for p, mg in enumerate(mgs):
        ag, rows = mg.ag, slice(p * rps, (p + 1) * rps)
        es, g = es_full[rows].contiguous(), cot[rows].contiguous()
        args = (ag, es, ed_full, h, g)
        before = {k: fn.launches for k, fn in fns.items()}
        got = fwd_bwd(*args)
        rose = {k: fn.launches - before[k] for k, fn in fns.items()}
        if min(rose.values()) < 1:
            raise AssertionError(f"rank {p}: a kernel of route B.3 did not launch: {rose}")
        if not all(map(torch.equal, got, fwd_bwd(*args))):
            raise AssertionError(f"rank {p}: two fwd+bwd runs of gat_attention differ")
        # each kernel against its plain version on the inputs the op gives it
        s_args = (ag.row_ptr, ag.col, ag.logval, es, ed_full, SLOPE)
        logits, mx, sm = att.stats_logits(*s_args, split=ag.split)
        err = {"attn_stats": max(compare(a, b, ATT_TOL)[0] for a, b in
                                 zip((logits, mx, sm), att.stats_logits_plain(*s_args)))}
        x16, g16 = att.features_bf16(h), att.features_bf16(g)
        a_args = (ag.row_ptr, ag.col, logits, mx, sm, x16)
        err["attn_agg"] = compare(att.attn_agg(*a_args, split=ag.split),
                                  att.attn_agg_plain(*a_args), ATT_TOL)[0]
        d_args = (ag.row_ptr, ag.col, g16, x16, ag.row)
        u = att.sddmm(*d_args)
        err["sddmm"] = compare(u, att.sddmm_plain(*d_args), ATT_TOL)[0]
        wt = att.edge_weights(ag, logits, mx, sm)
        s_row = att.rowsum(ag.row_ptr, wt * u, split=ag.split)
        err["rowsum"] = compare(s_row, att.rowsum_plain(ag.row_ptr, wt * u), ATT_TOL)[0]
        base = es.index_select(0, ag.row) + ed_full.index_select(0, ag.col)
        dbase = (wt * (u - s_row.index_select(0, ag.row))
                 * torch.where(base >= 0, 1.0, SLOPE)).index_select(0, ag.perm_t)
        err["rowsum"] = max(err["rowsum"], compare(
            att.rowsum(ag.row_ptr_t, dbase, split=ag.split_t),
            att.rowsum_plain(ag.row_ptr_t, dbase), ATT_TOL)[0])
        k_args = (ag.row_ptr_t, ag.col_t, wt.index_select(0, ag.perm_t), g16)
        err["row_reduce"] = compare(row_reduce(*k_args, split=ag.split_t),
                                    row_reduce_plain(*k_args), ATT_TOL)[0]
        for k, e in err.items():
            records.setdefault("row_reduce_dx" if k == "row_reduce" else k, []).append(
                (e, None, None, None))
        ms = cuda_ms(lambda: fwd_bwd(*args), reps=5)
        per_rank.append({
            "rank": p, "edges": ag.n_edges, "longest_row": ag.max_degree,
            "longest_col": int(torch.diff(ag.row_ptr_t).max()),
            "split_segments": [0 if t is None else t.n_seg for t in (ag.split, ag.split_t)],
            "fwd_bwd_ms": ms, "max_abs_err": err, "launches_a_fwd_bwd": rose,
        })
        outs.append(got[0])
        des_all.append(got[1])
        ded_sum = ded_sum + got[2]
        dx_sum = dx_sum + got[3]
    whole = att.AttentionGraph.from_coo(row, col, val, n, device=dev)
    args1 = (whole, es_full[:n].contiguous(), ed_full[:n].contiguous(), h[:n], cot[:n])
    out1, des1, ded1, dx1 = fwd_bwd(*args1)
    stacked = torch.cat(outs)
    if not torch.equal(stacked[:n], out1) or stacked[n:].any():
        raise AssertionError("the ranks' gat_attention outputs put together differ from the "
                             "single-card op's")
    gerr = [compare(torch.cat(des_all)[:n], des1, ATT_TOL)[0],
            compare(ded_sum[:n], ded1, ATT_TOL)[0], compare(dx_sum[:n], dx1, ATT_TOL)[0]]
    single_ms = cuda_ms(lambda: fwd_bwd(*args1), reps=5)
    log("mesh gat", f"R8 doc-word, {SHARDS} ranks' rectangular attention graphs (JAX node "
        f"order, built in {build_s:.1f} s), F={f}, each kernel vs plain within tol "
        f"{ATT_TOL}*(1+|ref|), two fwd+bwd bit-equal; per rank {json.dumps(per_rank)}")
    log("mesh gat", f"the {SHARDS} ranks' outputs put together vs single-card gat_attention "
        f"on the whole graph: bit-equal; des, sum of ded, sum of dx vs its gradients: max "
        f"abs err {gerr[0]:.3e}, {gerr[1]:.3e}, {gerr[2]:.3e} (tol {ATT_TOL}*(1+|ref|)); "
        f"single-card fwd+bwd {single_ms:.4f} ms a call ({whole.n_edges} edges, longest row "
        f"{whole.max_degree})")


def sharded_trainings_phase(docword, topic, seg):
    """"train sharded gat" and "train sharded families": one spawn of SHARDS
    gloo ranks on this card at HYBRID_SEED, every launch count set to 0
    before each training: GAT on R8 doc-word under onehot/allgather (the
    attention kernels on each rank's graph: test accuracy >= GAT_ACC_MIN,
    B5, B7, B8, B9 and K2 launched on rank 0), GAT on R8 topic under
    segment/allgather and segment/halo, and the five families on R8 topic on
    FAMILY_COMBOS; each topic run within FAMILY_GAP of the single-card
    segment run of its family at that seed (``seg``); K2 launched under
    onehot, K1 under hybrid (K2 there where rank 0's layout has residual
    edges), nothing under segment. Returns rank 0's launches by job."""
    from textgcn_tpu_torch.parallel.launch import HostData, spawn_ranks

    jobs = [("docword", "gat", "onehot", "allgather"), ("topic", "gat", "segment", "allgather"),
            ("topic", "gat", "segment", "halo")] + [("topic", *c) for c in FAMILY_COMBOS]
    t0 = time.perf_counter()
    results = spawn_ranks(
        train_jobs_rank, SHARDS,
        ({"docword": HostData.from_prepared(docword), "topic": HostData.from_prepared(topic)},
         HYBRID_SEED, jobs),
        backend="gloo", devices=["cuda:0"] * SHARDS, timeout_s=900.0,
    )
    out = {}
    for (key, model, kernel, partition), (run, launches, wall_s, residual) in zip(jobs, results):
        what = f"{model} on R8 {key}, {kernel}/{partition}"
        check_run(run, what)
        test, hist = run["test"], run["history"]
        used = {k: v for k, v in launches.items() if v}
        if kernel == "segment":
            need = ()
        elif model == "gat":
            need = ATT_NEED
        elif kernel == "hybrid":
            need = ("bsr_leg", "row_reduce") if residual else ("bsr_leg",)
        else:
            need = ("row_reduce",)
        if set(used) != set(need):
            raise AssertionError(f"{what} launched {used} on rank 0, expected {need}")
        text = (f"{SHARDS} ranks on cuda:0 (gloo), {what}, seed {HYBRID_SEED}: {len(hist)} "
                f"epochs, train {test['train_time']:.3f} s = "
                f"{1000 * test['train_time'] / len(hist):.3f} ms/epoch ({wall_s:.1f} s with "
                f"set-up); test acc {test['acc']:.4f}, macro-F1 {test['macro_f1']:.4f}; rank 0 "
                f"launches {used}")
        phase = "train sharded gat" if model == "gat" else "train sharded families"
        if key == "docword":
            log(phase, f"{text} (min {GAT_ACC_MIN})")
            if test["acc"] < GAT_ACC_MIN:
                raise AssertionError(f"{what}: test accuracy {test['acc']:.4f} < {GAT_ACC_MIN}")
        else:
            gap = test["acc"] - seg[model][HYBRID_SEED]
            log(phase, f"{text}; vs single-card segment at this seed {gap:+.4f} (limit "
                f"±{FAMILY_GAP})")
            if abs(gap) > FAMILY_GAP:
                raise AssertionError(f"{what} is {gap:+.4f} off its single-card segment run")
        out[key, model, kernel, partition] = launches
    log("train sharded families", f"{len(jobs)} trainings in one spawn: "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def sharded_cli_phase(cli, counters, root, seg):
    """"train sharded cli": ``cli train --dataset R8 --model gat --shards 1
    --partition allgather --spmm onehot`` on the topic graph (an NCCL group
    of one) at HYBRID_SEED: the report names its sharding, the attention
    kernels launch, and test accuracy lands within FAMILY_GAP of the
    single-card segment GAT at that seed. Returns the launches."""
    summary, launches, wall_s = run_cli(
        cli, ["--data_root", root, "--model", "gat", "--spmm", "onehot", "--shards", "1",
              "--partition", "allgather", "--seeds", str(HYBRID_SEED)], counters, "topic",
    )
    want = {"n_shards": 1, "partition": "allgather", "kernel": "onehot"}
    if summary.get("sharding") != want:
        raise AssertionError(f"the run reports sharding {summary.get('sharding')}, expected {want}")
    if min(launches[k] for k in ATT_NEED) < 1:
        raise AssertionError(f"a kernel of route B.3 never launched in the CLI run: {launches}")
    run = summary["runs"][0]
    gap = run["test"]["acc"] - seg["gat"][HYBRID_SEED]
    log("train sharded cli", f"cli train R8 topic --model gat --shards 1 --partition allgather "
        f"--spmm onehot seed {HYBRID_SEED}: {run['epochs_run']} epochs, "
        f"{1000 * run['test']['train_time'] / run['epochs_run']:.3f} ms/epoch, {wall_s:.1f} s "
        f"with data prep; test acc {run['test']['acc']:.4f}, vs single-card segment {gap:+.4f} "
        f"(limit ±{FAMILY_GAP}); sharding {summary['sharding']}; launches {launches}")
    if abs(gap) > FAMILY_GAP:
        raise AssertionError(f"the sharded CLI GAT is {gap:+.4f} off its single-card segment run")
    return launches


# the sharded checkpoint phases: the epochs of a straight run (cut at half of
# them, saved and resumed), and the largest gap of a single-card load of the
# sharded model to the sharded run's test accuracy (the same params; the
# sums in another order, bf16 features on both kernels' layouts)
CKPT_EPOCHS = 20
LOAD_GAP = 0.002
# the sorted ring of R8 doc-word at SHARDS ranks against the single card's
# stream over the whole CSR: f32 sums of the same bf16 x f32 products in
# another order (a bucket a ring step), within this share of the sum of the
# terms' magnitudes (|A| |x|), and the train steps' losses within this
MESH_TOL, MESH_LOSS_TOL, MESH_STEPS = 1e-5, 1e-3, 20


def checkpoint_rank(rank, world, device, data, seed, jobs):
    """One of SHARDS gloo ranks of "sharded checkpoint": for each job
    ``(name, kernel, partition, max_epoch, resume_from, saves)`` the GCN on
    ``data`` from ``seed`` (no early stop), resumed from ``resume_from``
    where it is set, then saved (``saves``: ("state" | "model", path)), every
    launch count set to 0 before each (rank 0 runs in the smoke's process).
    Rank 0 returns one dict a job."""
    from textgcn_tpu_torch.ops.bsr_spmm import bsr_leg
    from textgcn_tpu_torch.ops.row_reduce import row_reduce
    from textgcn_tpu_torch.parallel.trainer import ShardedTrainer
    from textgcn_tpu_torch.train.trainer import TrainConfig

    out = []
    for name, kernel, partition, max_epoch, resume_from, saves in jobs:
        for fn in (bsr_leg, row_reduce):
            fn.launches = 0
        t0 = time.perf_counter()
        t = ShardedTrainer(
            data.graph(), data.features, data.target, data.train_idx, data.test_idx,
            data.n_classes, config=TrainConfig(seed=seed, max_epoch=max_epoch,
                                               early_stopping=10 * CKPT_EPOCHS),
            n_shards=world, rank=rank, device=device, kernel=kernel, partition=partition,
        )
        t.fit(verbose=False, resume_from=resume_from)
        launches = {"bsr_leg": bsr_leg.launches, "row_reduce": row_reduce.launches}
        for kind, path in saves:
            (t.save_training_state if kind == "state" else t.save)(path)
        out.append({"name": name, "history": t.history, "test": t.test(), "launches": launches,
                    "residual": getattr(t.graph, "rest", None) is not None,
                    "wall_s": time.perf_counter() - t0})
    return out if rank == 0 else None


def sharded_checkpoint_phase(pre, tmp):
    """sharded checkpoint: the R8 doc-word GCN (identity features: the node
    tables are split over the ranks) on SHARDS gloo ranks on this card at
    HYBRID_SEED, dropout on. Under hybrid/allgather a straight run of
    CKPT_EPOCHS epochs, and half of them saved with ``save_training_state``
    and resumed: the histories must be equal bit for bit, and K1 (B10) and
    K2 must launch on rank 0. The straight run's model, loaded into the
    single-card Trainer under --spmm hybrid and under --spmm onehot, must
    give test accuracies within LOAD_GAP of the sharded run's. A single-card
    segment state saved at half the epochs, resumed on the ranks under
    segment/halo, must land within FAMILY_GAP of the uninterrupted
    single-card run. Returns rank 0's launches of the hybrid runs."""
    from textgcn_tpu_torch.parallel.launch import HostData, spawn_ranks
    from textgcn_tpu_torch.train.prepare import apply_spmm_format
    from textgcn_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    dev, half = pre.graph.val.device, CKPT_EPOCHS // 2
    paths = {k: os.path.join(tmp, k) for k in ("model", "state", "single_state")}

    def single(p, max_epoch):
        lab = p.labels
        return Trainer(p.graph, p.features, lab.target, lab.train_idx, lab.test_idx,
                       lab.n_classes, config=TrainConfig(seed=HYBRID_SEED, max_epoch=max_epoch,
                                                         early_stopping=10 * CKPT_EPOCHS),
                       device=dev, perm=p.perm)

    straight1 = single(pre, CKPT_EPOCHS)
    straight1.fit(verbose=False)
    single_acc = straight1.test()["acc"]
    first1 = single(pre, half)
    first1.fit(verbose=False)
    first1.save_training_state(paths["single_state"])
    del straight1, first1
    jobs = [
        ("straight", "hybrid", "allgather", CKPT_EPOCHS, None, [("model", paths["model"])]),
        ("first", "hybrid", "allgather", half, None, [("state", paths["state"])]),
        ("resumed", "hybrid", "allgather", CKPT_EPOCHS, paths["state"], []),
        ("from single", "segment", "halo", CKPT_EPOCHS, paths["single_state"], []),
    ]
    t0 = time.perf_counter()
    runs = {r["name"]: r for r in spawn_ranks(
        checkpoint_rank, SHARDS, (HostData.from_prepared(pre), HYBRID_SEED, jobs),
        backend="gloo", devices=["cuda:0"] * SHARDS, timeout_s=900.0)}
    spawn_s = time.perf_counter() - t0
    straight, first, resumed = (runs[k] for k in ("straight", "first", "resumed"))
    for r in runs.values():
        check_run(r, f"sharded checkpoint {r['name']}")
    bits = first["history"] + resumed["history"] == straight["history"]
    launches = {k: sum(runs[j]["launches"][k] for j in ("straight", "first", "resumed"))
                for k in ("bsr_leg", "row_reduce")}
    need = ("bsr_leg", "row_reduce") if straight["residual"] else ("bsr_leg",)
    loads = {}
    for fmt in ("hybrid", "onehot"):
        t = single(apply_spmm_format(pre, fmt), CKPT_EPOCHS)
        t.load(paths["model"])
        loads[fmt] = t.evaluate(t.test_idx)["acc"]
        del t
    acc = straight["test"]["acc"]
    from_single = runs["from single"]["test"]["acc"]
    log("sharded checkpoint", f"R8 doc-word GCN, {SHARDS} gloo ranks on cuda:0, seed "
        f"{HYBRID_SEED}, hybrid/allgather: straight {CKPT_EPOCHS} epochs "
        f"({straight['wall_s']:.1f} s, test acc {acc:.4f}), {half} epochs + "
        f"save_training_state ({first['wall_s']:.1f} s), resumed to {CKPT_EPOCHS} "
        f"({resumed['wall_s']:.1f} s): histories bit-equal {bits}; rank 0 launches "
        f"{launches}; the sharded model on one card: hybrid acc {loads['hybrid']:.4f}, onehot "
        f"{loads['onehot']:.4f} (limit ±{LOAD_GAP}); a single-card segment state (epoch "
        f"{half}) resumed on the ranks under segment/halo: acc {from_single:.4f} vs the "
        f"single card's {single_acc:.4f} (limit ±{FAMILY_GAP}); {spawn_s:.1f} s with spawn, "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if not bits:
        raise AssertionError("the resumed sharded run differs from the straight run")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the sharded hybrid never launched on rank 0: {launches}")
    if max(abs(a - acc) for a in loads.values()) > LOAD_GAP:
        raise AssertionError(f"the sharded model on one card: {loads} vs {acc}")
    if abs(from_single - single_acc) > FAMILY_GAP:
        raise AssertionError(f"a single-card state resumed sharded: {from_single} vs {single_acc}")
    return launches


def sharded_checkpoint_cli_phase(cli, counters, root, tmp):
    """sharded checkpoint cli: ``cli train --dataset R8 --shards 1`` (an
    NCCL group of one, segment) with ``--save_model A --save_state B`` after
    CKPT_EPOCHS epochs; ``--resume B`` to 1.5 times that, whose report names
    its sharding and ``resumed_from``; ``--load_model A`` (one card) must
    print the saved run's test accuracy."""
    model, state = os.path.join(tmp, "cli_model"), os.path.join(tmp, "cli_state")
    flags = ["--data_root", root, "--shards", "1", "--spmm", "segment", "--early_stopping",
             str(10 * CKPT_EPOCHS)]
    want = {"n_shards": 1, "partition": "halo", "kernel": "segment"}
    saved, _, w1 = run_cli(cli, [*flags, "--seeds", str(HYBRID_SEED), "--max_epoch",
                                 str(CKPT_EPOCHS), "--save_model", model, "--save_state",
                                 state], counters, "topic")
    resumed, _, w2 = run_cli(cli, [*flags, "--max_epoch", str(CKPT_EPOCHS * 3 // 2), "--resume",
                                   state], counters, "topic")
    acc = saved["runs"][0]["test"]["acc"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["train", "--dataset", "R8", *flags, "--load_model", model])
    run = resumed["runs"][0]
    log("sharded checkpoint cli", f"cli train R8 topic --shards 1 --spmm segment seed "
        f"{HYBRID_SEED}: {CKPT_EPOCHS} epochs + --save_model/--save_state ({w1:.1f} s, acc "
        f"{acc:.4f}; report keys checkpoint {saved.get('checkpoint') == model}, "
        f"resumable_checkpoint {saved.get('resumable_checkpoint') == state}); --resume: "
        f"{run['epochs_run']} epochs, seed {run['seed']}, sharding {resumed.get('sharding')}, "
        f"resumed_from {resumed.get('resumed_from') == state} ({w2:.1f} s, acc "
        f"{run['test']['acc']:.4f}); --load_model: {out.getvalue().strip()!r} (rc {rc})")
    if (saved.get("checkpoint") != model or saved.get("resumable_checkpoint") != state
            or saved.get("sharding") != want or resumed.get("sharding") != want
            or resumed.get("resumed_from") != state or run["seed"] != HYBRID_SEED
            or run["epochs_run"] != CKPT_EPOCHS // 2):
        raise AssertionError("the sharded CLI checkpoint runs report something else")
    if rc != 0 or f"acc={acc:.4f}" not in out.getvalue():
        raise AssertionError("--load_model of the sharded checkpoint gives another accuracy")


def mesh_stream_one_rank(rank, world, device, src, x, y, mask, singles):
    """mesh stream pass / mesh stream train, on a group of one (NCCL) in this
    process: the sorted ring over the cached lattice ``src`` (the one bucket
    of P = 1) against the single-card stream bit for bit, its seconds a
    pass, edges/s, K2's launches a pass and peak memory; then one step of
    the sharded GCN, SGC and APPNP from the single-card steps' parameters
    (SGD, lr 0), each loss and gradient bit-equal to ``singles`` (the
    single-card step's on K2). Returns (B11 launches of the ring's passes
    and steps, the two phases' lines)."""
    from textgcn_tpu_torch.ops.row_reduce import row_reduce
    from textgcn_tpu_torch.ops.streamed_sorted import spmm_streamed_sorted_hostfed
    from textgcn_tpu_torch.parallel import streamed as ps

    def source(p, q):
        return src

    n = x.shape[0]
    n_edges = sum(c.n_edges for c in src)
    want = spmm_streamed_sorted_hostfed(src, x)
    torch.cuda.reset_peak_memory_stats()
    row_reduce.launches = 0
    got, pass_s = wall(lambda: ps.spmm_streamed_mesh_sorted_hostfed(source, x))
    per_pass = row_reduce.launches
    peak = torch.cuda.max_memory_allocated()
    if not torch.equal(got, want):
        raise AssertionError("the P = 1 ring differs from the single-card stream")
    del got, want
    ms = cuda_ms(lambda: ps.spmm_streamed_mesh_sorted_hostfed(source, x), reps=3, warmup=1)
    launches = per_pass
    cells = []
    for family in ("gcn", "sgc", "appnp"):
        params, opt = stream_init(family, device, torch.optim.SGD, 0.0)
        step = ps.make_streamed_sharded_step_segmented(family, source, n, opt)
        before = row_reduce.launches
        loss, step_s = wall(lambda: float(step(params, x, y, mask)))
        launches += row_reduce.launches - before
        loss_1, grads_1 = singles[family]
        same = loss == loss_1 and all(torch.equal(p.grad, grads_1[k]) for k, p in params.items())
        if not same:
            raise AssertionError(f"the P = 1 sharded {family} step differs from the single card's")
        cells.append(f"{family} loss {loss!r} and grads bit-equal ({step_s:.3f} s)")
    pass_line = (f"P=1 ring over the cached lattice ({n} rows, {n_edges} edges), "
                 f"F={x.shape[1]} bf16 (the JAX bench's streamed_mesh_scale_perf): bit-equal "
                 f"to the single-card stream; first pass {pass_s:.4f} s (host clock), {ms:.3f} "
                 f"ms a pass (CUDA events, 3 reps), {n_edges / (ms / 1e3):.6e} edges/s; K2 "
                 f"launches a pass {per_pass} (one run of every chunk); peak memory {peak} bytes allocated")
    train_line = (f"P=1 sharded steps (SGD lr 0) from the single-card steps' parameters: "
                  f"{'; '.join(cells)}")
    return launches, pass_line, train_line


def mesh_stream_inputs(device, n, labels, f):
    """R8 doc-word's streamed train inputs, the same on every rank: bf16
    features carrying the label (as the streamed train phases), the
    documents' labels, the train documents' mask."""
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    y = torch.zeros(n, dtype=torch.int64, device=device)
    y[: len(labels.target)] = torch.as_tensor(labels.target, device=device)
    x = torch.randn((n, f), generator=gen, device=device, dtype=torch.bfloat16).mul_(0.1)
    x += (torch.arange(f, device=device) % labels.n_classes == y[:, None]).to(torch.bfloat16)
    mask = torch.zeros(n, device=device)
    mask[torch.as_tensor(labels.train_idx, device=device)] = 1.0
    return x, y, mask


def mesh_stream_params(device, f, n_class):
    from textgcn_tpu_torch.train import streamed as st

    return st.init_streamed(torch.Generator(device=device).manual_seed(SEED + 6), f, STREAM_H,
                            n_class, device=device)


def mesh_stream_rank(rank, world, device, row, col, val, n, labels, f, bucket_dir):
    """One of SHARDS gloo ranks of "mesh stream ranks" (route B.4 on R8
    doc-word): its halo sorted buckets; one pass with every B11 launch held
    against ``row_reduce_plain`` at K2_TOL, two passes bit-equal, the pass
    from the bucket files bit-equal to the resident one, the pass's ms;
    then MESH_STEPS steps of the sharded streamed GCN (Adam) from the shared
    parameters with the launch count set to 0 just before. Rank 0 returns
    every rank's numbers, the pass gathered, its losses and launches."""
    import torch.distributed as dist

    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain
    from textgcn_tpu_torch.parallel import streamed as ps
    from textgcn_tpu_torch.parallel.distributed import all_gather_rows
    from textgcn_tpu_torch.parallel.halo import HaloPartitionedGraph

    hg = HaloPartitionedGraph.from_coo(row, col, val, n, world, rank, device=device)
    rps = hg.rows_per_shard
    buckets = ps.halo_sorted_bucket_stream(hg)
    x, y, mask = ps.shard_streamed_inputs(*mesh_stream_inputs(device, n, labels, f), rank, rps,
                                          device=device)
    errs = []

    def checked(row_ptr, col_, val_, xx, base=None, split=None):
        want = row_reduce_plain(row_ptr, col_, val_, xx, base=base.clone())
        got = row_reduce(row_ptr, col_, val_, xx, base=base, split=split)
        errs.append(compare(got, want, K2_TOL)[0])
        return got

    y_checked = ps.spmm_streamed_mesh_sorted_hostfed(buckets, x, reduce=checked)
    before = row_reduce.launches
    y1 = ps.spmm_streamed_mesh_sorted_hostfed(buckets, x)
    per_pass = row_reduce.launches - before
    same = torch.equal(y1, ps.spmm_streamed_mesh_sorted_hostfed(buckets, x))
    same = same and torch.equal(y1, y_checked)
    ps.save_halo_sorted_buckets(hg, bucket_dir)
    dist.barrier()
    source = ps.mesh_sorted_chunks_from_dir(bucket_dir, rank)[0]
    files = torch.equal(y1, ps.spmm_streamed_mesh_sorted_hostfed(source, x))
    torch.cuda.synchronize()
    dist.barrier()
    ms = cuda_ms(lambda: ps.spmm_streamed_mesh_sorted_hostfed(buckets, x), reps=5, warmup=1)
    params, opt = mesh_stream_params(device, f, labels.n_classes)
    step = ps.make_streamed_sharded_train_step_segmented(buckets, rps, opt)
    row_reduce.launches = 0
    losses, train_s = wall(lambda: [float(step(params, x, y, mask)) for _ in range(MESH_STEPS)])
    train_launches = row_reduce.launches
    mine = torch.tensor([[buckets.n_edges, max(errs), per_pass, ms, int(same), int(files),
                          train_launches, sum(len(b) for b in buckets.chunks)]],
                        dtype=torch.float64, device=device)
    every = all_gather_rows(mine).tolist()
    out = all_gather_rows(y1)
    if rank:
        return None
    return {"per_rank": every, "pass": out, "losses": losses, "train_launches": train_launches,
            "train_s": train_s}


def mesh_stream_ranks_phase(pre, records, tmp):
    """mesh stream ranks: route B.4 on SHARDS gloo ranks on this card, R8
    doc-word's normalized adjacency as halo sorted buckets (no degree sort),
    F=128 bf16 (``mesh_stream_rank``): B11 launched on every rank, each
    launch within K2_TOL of plain, two passes bit-equal and the bucket
    files' pass bit-equal to the resident one; the stacked pass within
    MESH_TOL of |A| |x| of the single card's stream over the whole CSR; the
    sharded streamed GCN's MESH_STEPS losses within MESH_LOSS_TOL of the
    single-card streamed step's from the same parameters. Returns rank 0's
    B11 launches in its training."""
    from textgcn_tpu_torch.ops import streamed_sorted as ss
    from textgcn_tpu_torch.parallel.launch import spawn_ranks
    from textgcn_tpu_torch.train import streamed as st

    t_phase, f = time.perf_counter(), STREAM_F
    dev, n = pre.graph.val.device, pre.graph.n_nodes
    row, col, val = pre.graph.coo_numpy()
    res = spawn_ranks(mesh_stream_rank, SHARDS,
                      (row, col, val, n, pre.labels, f, os.path.join(tmp, "buckets")),
                      backend="gloo", devices=["cuda:0"] * SHARDS, timeout_s=600.0)
    per = res["per_rank"]
    if min(r[2] for r in per) < 1 or not all(r[4] and r[5] for r in per):
        raise AssertionError(f"route B.4 on the ranks: {per}")
    records.setdefault("sorted_chunk_add", []).append((max(r[1] for r in per), None, None, None))
    row_ptr, c, v = (t.to(dev) for t in ss._coo_to_csr(row, col, val, n))
    chunks = ss.csr_stream(row_ptr, c, v)
    x, y, mask = mesh_stream_inputs(dev, n, pre.labels, f)
    single = ss.spmm_streamed_sorted_hostfed(chunks, x)
    mag = ss.spmm_streamed_sorted_hostfed(
        [dataclasses.replace(ch, val=ch.val.abs()) for ch in chunks], x.abs())
    gap = float(((res["pass"][:n] - single).abs() / mag.clamp_min(1e-30)).max())
    if not gap <= MESH_TOL or res["pass"][n:].any():
        raise AssertionError(f"the stacked ring vs the single-card stream: {gap:.3e} of |A||x|")
    params, opt = mesh_stream_params(dev, f, pre.labels.n_classes)
    step = st.make_streamed_train_step_segmented(st.make_sorted_stream(chunks), n, opt)
    want, single_s = wall(lambda: [float(step(params, x, y, mask)) for _ in range(MESH_STEPS)])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], want))
    log("mesh stream ranks", f"R8 doc-word ({n} nodes, {len(row)} edges) as halo sorted "
        f"buckets on {SHARDS} gloo ranks on cuda:0, F={f} bf16; per rank [edges, max abs err "
        f"of its B11 launches vs plain (tol {K2_TOL}*(1+|ref|)), K2 launches a pass, pass ms "
        f"(CUDA events, 5 passes; the ranks share the card, gloo stages the ring through the "
        f"host), two passes bit-equal, files' pass bit-equal, B11 launches in training, "
        f"chunks]: {per}; the stacked pass vs the single card's stream over the whole CSR "
        f"({len(chunks)} chunks): {gap:.3e} of |A||x| (tol {MESH_TOL}); {MESH_STEPS} Adam "
        f"steps of the sharded streamed GCN: losses {res['losses'][0]:.6f} -> "
        f"{res['losses'][-1]:.6f} ({res['train_s']:.2f} s), single card "
        f"{want[0]:.6f} -> {want[-1]:.6f} ({single_s:.2f} s), max rel gap {loss_gap:.3e} (tol "
        f"{MESH_LOSS_TOL}); phase {time.perf_counter() - t_phase:.1f} s")
    if not loss_gap <= MESH_LOSS_TOL or not res["losses"][-1] < res["losses"][0]:
        raise AssertionError(f"the sharded streamed GCN: {res['losses']} vs {want}")
    return res["train_launches"]


def topic_roots(tmp):
    """Two data roots under ``tmp`` with copies of the committed R8 topic
    artifacts (the label files and the clean corpus linked): ``fresh``, whose
    theta cache is written after its model pickle, so prepare takes it as the
    build stage left it (git keeps no mtimes, so a checkout may order the
    committed files either way), and ``stale``, without the cache, so prepare
    runs the E-step. Nothing of the checkout is written."""
    roots = {}
    for name, suffixes in (("fresh", (".txt", "_model.pkl", "_theta.npy")),
                           ("stale", (".txt", "_model.pkl"))):
        root = os.path.join(tmp, name)
        os.makedirs(os.path.join(root, "graph"))
        os.symlink(os.path.join(REPO, "data", "text_dataset"), os.path.join(root, "text_dataset"))
        for suffix in suffixes:
            shutil.copyfile(os.path.join(REPO, "data", "graph", f"R8_topic{suffix}"),
                            os.path.join(root, "graph", f"R8_topic{suffix}"))
        roots[name] = root
    now = time.time()
    os.utime(os.path.join(roots["fresh"], "graph", "R8_topic_model.pkl"), (now - 10, now - 10))
    os.utime(os.path.join(roots["fresh"], "graph", "R8_topic_theta.npy"), (now, now))
    return roots


def topic_data_phase(dev, gen, records, yard, root, gen_formats):
    """16. topic data: the R8 topic graph prepared on the card, its hybrid
    layout, and K1, K2 (where the layout has residual edges) and the hybrid
    pass held against their plain versions at the topic path's widths (F =
    200, 100, 8: F' = 208, 112, 16); then K1's f32 mode on the bare tile
    stack (``--spmm bsr``) at the same widths, its inputs drawn from
    ``gen_formats``. Returns whether there is a residual."""
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.graph.reorder import hybrid_pass, spmm_hybrid
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.ops.bsr_spmm import F_ALIGN, SEGMENT_TILES, bsr_spmm, bsr_spmm_plain
    from textgcn_tpu_torch.ops.row_reduce import SEGMENT_EDGES, row_reduce, row_reduce_plain
    from textgcn_tpu_torch.ops.spmm import spmm_coo_segment
    from textgcn_tpu_torch.train.prepare import cached_theta, prepare_topic_data

    base = os.path.join(root, "graph", "R8_topic")
    theta_from = "the cache" if cached_theta(base, 7674, 50) is not None else "the E-step"
    t0 = time.perf_counter()
    pre = prepare_topic_data("R8", data_root=root, device=dev)
    prep_s = time.perf_counter() - t0
    if (pre.n_nodes, pre.num_docs, pre.num_topics) != (7724, 7674, 50) or pre.features.shape != (7724, 100):
        raise AssertionError(f"R8 topic prepared as {pre.n_nodes} nodes, features {pre.features.shape}")
    t0 = time.perf_counter()
    h, perm = convert_graph(pre.graph, "hybrid")
    bsr, rest = h.bsr, h.rest
    per_row = torch.diff(bsr.tile_ptr.long())
    ksp = bsr.split
    log("topic data", f"R8 topic on the card: {pre.n_nodes} nodes ({pre.num_docs} docs, "
        f"{pre.num_topics} topics), {pre.graph.n_edges} stored edges, features "
        f"{list(pre.features.shape)} {pre.features.dtype}, theta from {theta_from}; "
        f"{prep_s:.2f} s. Hybrid: {bsr.nnzb} tiles ({bsr.n_edges} edges, "
        f"{h.dense_fraction:.4f}) in {bsr.n_block_rows} block-rows, tiles a block-row "
        f"{per_row.tolist()}; K1 T = {SEGMENT_TILES}: {0 if ksp is None else ksp.n_long} "
        f"block-rows longer than T cut into {0 if ksp is None else ksp.n_seg} segments; "
        + ("no residual edges: K2 has no work on this layout" if rest is None else
           f"residual {rest.n_edges} edges, longest row {int(torch.diff(rest.row_ptr).max())}, "
           f"K2 S = {SEGMENT_EDGES} ({0 if rest.split is None else rest.split.n_long} rows "
           f"split)") + f"; {time.perf_counter() - t0:.2f} s for the layout")
    n_pad = bsr.n_block_rows * bsr.bm
    for f in (200, 100, 8):
        fp = -(-f // F_ALIGN) * F_ALIGN
        xp = torch.zeros((n_pad, fp), dtype=torch.bfloat16, device=dev)
        xp[: h.n_nodes, :f] = torch.randn((h.n_nodes, f), generator=gen, device=dev)
        args = (bsr.blocks, bsr.tile_ptr, bsr.block_cols, xp)
        got = bsr_spmm(*args, split=ksp)
        if not torch.equal(got, bsr_spmm(*args, split=ksp)):
            raise AssertionError(f"two K1 launches differ on the topic tiles at F={f}")
        err, _ = compare(got, bsr_spmm_plain(*args), K1_TOL)
        ms, dev_ms = both_ms(lambda: bsr_spmm(*args, split=ksp))
        plain_ms = cuda_ms(lambda: bsr_spmm_plain(*args))
        records["bsr_spmm"].append((err, ms, dev_ms, plain_ms))
        k2 = ""
        if rest is not None:
            rargs = (rest.row_ptr, rest.col, rest.val, xp)
            err_k, _ = compare(row_reduce(*rargs, base=got.clone(), split=rest.split),
                               row_reduce_plain(*rargs, base=got.clone()), K2_TOL)
            ms_k, dev_k = both_ms(lambda: row_reduce(*rargs, base=got, split=rest.split))
            plain_k = cuda_ms(lambda: row_reduce_plain(*rargs, base=got))
            records["row_reduce"].append((err_k, ms_k, dev_k, plain_k))
            k2 = (f"; K2 with base max abs err {err_k:.3e}, {ms_k:.4f} ms a call "
                  f"({dev_k:.4f} device), plain {plain_k:.4f} ms, tol {K2_TOL}*(1+|ref|)")
        log("topic K1/K2", f"F={f} (F'={fp}) on the R8 topic layout: K1 max abs err "
            f"{err:.3e}, tol {K1_TOL}*(1+|ref|), two launches bit-equal, {ms:.4f} ms a call "
            f"({dev_ms:.4f} device), plain {plain_ms:.4f} ms{k2}")
    row, col, val = pre.graph.coo_numpy()
    seg = SparseGraph.from_coo(perm[row], perm[col], val, h.n_nodes, device=dev)
    x = torch.randn((h.n_nodes, 200), generator=gen, device=dev).requires_grad_(True)
    y = spmm_hybrid(h, x)
    err, _ = compare(y.detach(), spmm_coo_segment(seg.row, seg.col, seg.val, x.detach(), h.n_nodes),
                     HYBRID_TOL)
    cot = torch.randn(y.shape, generator=gen, device=dev)
    y.backward(cot)
    if not torch.equal(x.grad, hybrid_pass(h, cot)):
        raise AssertionError("topic hybrid: autograd backward differs from a pass on the cotangent")
    gerr, _ = compare(x.grad, spmm_coo_segment(seg.col, seg.row, seg.val, cot, h.n_nodes), HYBRID_TOL)
    hyb_ms = cuda_ms(lambda: hybrid_pass(h, x.detach()))
    seg_ms = cuda_ms(lambda: spmm_coo_segment(seg.row, seg.col, seg.val, x.detach(), h.n_nodes))
    log("topic hybrid pass", f"F=200 vs the segment oracle: max abs err {err:.3e}, backward "
        f"{gerr:.3e}, tol {HYBRID_TOL}*(1+|ref|); backward == pass on the cotangent; hybrid "
        f"pass {hyb_ms:.4f} ms, segment pass {seg_ms:.4f} ms")
    b, _ = convert_graph(pre.graph, "bsr")
    bsr_f32_phase("bsr f32 topic", b, gen_formats, (200, 100, 8), records, yard)
    return rest is not None


def lda_phase(dev, roots):
    """17. lda e-step: the port's ``LDA.transform`` on the card over the R8
    clean corpus against the committed theta (the JAX package's E-step), and
    prepare's stale-cache path (the E-step inside ``prepare_topic_data``)."""
    from textgcn_tpu_torch.topics import lda as lda_mod
    from textgcn_tpu_torch.topics.model import TopicModel, load_documents_from_file
    from textgcn_tpu_torch.train.prepare import prepare_topic_data

    tm = TopicModel().load(os.path.join(REPO, "data", "graph", "R8_topic_model.pkl"))
    docs = load_documents_from_file(os.path.join(REPO, "data", "text_dataset", "clean_corpus", "R8.txt"))
    seen, e_step = [], lda_mod._e_step

    def traced(x, gamma0, exp_elog_beta, *a, **k):
        seen.append({t.device.type for t in (x, gamma0, exp_elog_beta)})
        return e_step(x, gamma0, exp_elog_beta, *a, **k)

    lda_mod._e_step = traced
    try:
        theta, secs = wall(lambda: tm.get_document_topic_distribution(docs, device=dev))
        stale, stale_s = wall(lambda: prepare_topic_data("R8", data_root=roots["stale"], device=dev))
    finally:
        lda_mod._e_step = e_step
    want = np.load(os.path.join(REPO, "data", "graph", "R8_topic_theta.npy"))
    diff = float(np.abs(theta - want).max())
    fresh = prepare_topic_data("R8", data_root=roots["fresh"], device=dev)
    x_diff = float(np.abs(stale.features - fresh.features).max())
    cache = os.path.join(roots["stale"], "graph", "R8_topic_theta.npy")
    log("lda e-step", f"LDA.transform on the card over {len(docs)} R8 docs "
        f"({len(seen) // 2} chunks of {tm.lda.chunk_size}; E-step tensors on "
        f"{sorted(set().union(*seen))}): {secs:.2f} s with the host's vectorizing; "
        f"theta max abs diff vs the committed (JAX) theta {diff:.3e}, limit {THETA_TOL}; "
        f"prepare with no cache {stale_s:.2f} s (E-step on the card, cache written: "
        f"{os.path.exists(cache)}), its X vs the cached X max abs diff {x_diff:.3e}")
    if not seen or any(d != {"cuda"} for d in seen):
        raise AssertionError(f"an E-step tensor was not on cuda: {seen}")
    if theta.shape != want.shape or diff > THETA_TOL:
        raise AssertionError(f"theta differs from the committed theta by {diff:.3e}")
    if not os.path.exists(cache) or x_diff > THETA_TOL:
        raise AssertionError(f"prepare's E-step path: cache {os.path.exists(cache)}, X diff {x_diff:.3e}")


def committed_report(name):
    """The JAX package's committed report ``results/{name}_training_results.json``."""
    with open(os.path.join(REPO, "results", f"{name}_training_results.json")) as fh:
        return json.load(fh)


def committed(family):
    """The JAX package's committed R8 topic report of ``family``."""
    return committed_report("R8_topic" + {"gcn": "", "sgc_pre": "_sgcpre"}.get(family, f"_{family}"))


def topic_runs(cli, counters, root, family, spmm, seeds):
    """``cli train --dataset R8`` (no ``--graph``: the topic graph) of
    ``family`` on ``spmm`` over ``seeds``; returns (report, launches, {seed:
    acc}, a one-line account)."""
    summary, launches, wall_s = run_cli(
        cli, ["--data_root", root, "--model", family, "--spmm", spmm,
              "--seeds", *map(str, seeds)], counters, "topic",
    )
    if summary["graph_family"] != "topic" or summary["hyperparameters"]["model"] != family:
        raise AssertionError(f"a topic run reports {summary['graph_family']}, {summary['hyperparameters']}")
    accs = {r["seed"]: r["test"]["acc"] for r in summary["runs"]}
    runs = "; ".join(
        f"seed {r['seed']}: acc {r['test']['acc']:.4f}, {r['epochs_run']} epochs, "
        f"{1000 * r['test']['train_time'] / r['epochs_run']:.3f} ms/epoch"
        for r in summary["runs"]
    )
    text = (f"{family} --spmm {spmm}: {runs}; mean acc "
            f"{summary['test_accuracy']['mean']:.4f}; {wall_s:.1f} s with data prep")
    return summary, launches, accs, text


def topic_training_phases(cli, counters, root, residual):
    """18-21. The topic slice through the CLI: GCN and GAT on the bench
    seeds, each new family on its committed seeds (segment), the GCN on
    --spmm auto, every family once on its kernels (--spmm hybrid: K1, and
    K2 where the layout has ``residual`` edges; GAT's kernels and K2 as
    dx), and the GCN on --spmm bsr (K1's f32 mode) and onehot (K2 from
    zero) on the bench seeds, each within FAMILY_GAP of segment at every
    seed. Returns the launches of the hybrid runs (non-GAT, GAT),
    [(launches, K2 record)] of the bsr and onehot runs, and the segment
    runs' accuracies ({family: {seed: acc}})."""
    seg = {}
    for phase, families in (("train topic gcn/gat", ("gcn", "gat")),
                            ("train topic families", NEW_FAMILIES)):
        for family in families:
            ref = committed(family)
            seeds = BENCH_SEEDS if family in ("gcn", "gat") else [r["seed"] for r in ref["runs"]]
            summary, _, seg[family], text = topic_runs(cli, counters, root, family, "segment", seeds)
            mean, ref_mean = summary["test_accuracy"]["mean"], ref["test_accuracy"]["mean"]
            gap = mean - ref_mean
            limit = TOPIC_GAP if family in ("gcn", "gat") else FAMILY_GAP
            log(phase, f"{text}; the JAX package's mean on these seeds {ref_mean:.4f}, "
                f"gap {gap:+.4f} (limit ±{limit})")
            if abs(gap) > limit:
                raise AssertionError(f"{family}: mean acc {mean:.4f} is {gap:+.4f} off the JAX package's")
            if family == "gcn" and mean < REF_TOPIC_ACC:
                raise AssertionError(f"topic GCN mean acc {mean:.4f} < the reference's {REF_TOPIC_ACC}")
    _, _, acc, text = topic_runs(cli, counters, root, "gcn", "auto", [HYBRID_SEED])
    gap = acc[HYBRID_SEED] - seg["gcn"][HYBRID_SEED]
    log("train topic auto", f"{text} (dense); vs segment at this seed {gap:+.4f} (limit ±{FAMILY_GAP})")
    if abs(gap) > FAMILY_GAP:
        raise AssertionError(f"topic GCN on --spmm auto is {gap:+.4f} off its segment run")
    hybrid = {}
    for family in ("gcn", *NEW_FAMILIES, "gat"):
        _, launches, acc, text = topic_runs(cli, counters, root, family, "hybrid", [HYBRID_SEED])
        need = (("row_reduce", "attn_stats", "attn_agg", "sddmm", "rowsum") if family == "gat"
                else ("bsr_spmm", "row_reduce") if residual else ("bsr_spmm",))
        if family != "gat" and not residual and launches["row_reduce"]:
            raise AssertionError(f"K2 ran on a layout without residual edges: {launches}")
        gap = acc[HYBRID_SEED] - seg[family][HYBRID_SEED]
        log("train topic hybrid", f"{text}; vs segment at this seed {gap:+.4f} (limit "
            f"±{FAMILY_GAP}); launches {launches}")
        if min(launches[k] for k in need) < 1:
            raise AssertionError(f"a kernel of the topic {family} path never launched: {launches}")
        if abs(gap) > FAMILY_GAP:
            raise AssertionError(f"topic {family} on --spmm hybrid is {gap:+.4f} off its segment run")
        hybrid[family] = launches
    gat = hybrid.pop("gat")
    formats = []
    for fmt in ("bsr", "onehot"):
        _, launches, acc, text = topic_runs(cli, counters, root, "gcn", fmt, BENCH_SEEDS)
        gaps = [acc[s] - seg["gcn"][s] for s in BENCH_SEEDS]
        log("train topic bsr/onehot", f"{text}; vs segment per seed "
            f"{', '.join(f'{g:+.4f}' for g in gaps)} (limit ±{FAMILY_GAP}); launches {launches}")
        if min(launches[k] for k in kernel_need(fmt)) < 1:
            raise AssertionError(f"a kernel of the topic GCN on {fmt} never launched: {launches}")
        if max(map(abs, gaps)) > FAMILY_GAP:
            raise AssertionError(f"topic GCN on --spmm {fmt} is off its segment runs: {gaps}")
        formats.append((launches, "row_reduce_dx" if fmt == "onehot" else "row_reduce"))
    return {k: sum(v[k] for v in hybrid.values()) for k in gat}, gat, formats, seg


def pad16(f):
    return -(-f // 16) * 16


def bsr_f32_phase(tag, b, gen, widths, records, yard):
    """bsr f32: K1's f32 mode (B4's f32 mode, 3xTF32 on the tensor cores) on
    the bare tile stack ``b`` (no degree sort) against ``bsr_spmm_plain`` at
    the feature widths ``widths`` (F' = ``widths`` rounded up to 16): max abs
    err within F32_TILE_TOL of max |plain|; against the f64 oracle
    (``bsr_spmm_plain`` on f64 inputs) at most F64_ERR_RATIO times the plain
    f32 version's error; two launches bit-equal; a call and device time, the
    plain version's, the bound (three TF32 products' operations, or bytes)
    beside the FFMA bound of one f32 product, and ``torch.sparse.mm`` on the
    f32 CSR of the same matrix."""
    from textgcn_tpu_torch.ops.bsr_spmm import bsr_spmm, bsr_spmm_f32, bsr_spmm_plain

    n_pad = b.n_block_rows * b.bm
    sp = b.split
    n_items = b.n_block_rows + (0 if sp is None else sp.n_seg - sp.n_long)
    log(tag, f"bare f32 tile stack (no degree sort): {b.nnzb} tiles "
        f"({nbytes(b.blocks) / 1e6:.1f} MB) holding {b.n_edges} edges in {b.n_block_rows} "
        f"block-rows, max {int(torch.diff(b.tile_ptr.long()).max())} tiles a block-row; "
        f"T = 16: {0 if sp is None else sp.n_long} block-rows cut into "
        f"{0 if sp is None else sp.n_seg} segments; {n_items} work items on "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    for f in widths:
        fp = pad16(f)
        xp = torch.zeros((n_pad, fp), device=b.blocks.device)
        xp[: b.n_nodes, :f] = torch.randn((b.n_nodes, f), generator=gen, device=xp.device)
        args = (b.blocks, b.tile_ptr, b.block_cols, xp)
        got = bsr_spmm(*args, split=sp)
        if not torch.equal(got, bsr_spmm_f32(*args, split=sp)):
            raise AssertionError(f"{tag}: two f32 launches differ at F'={fp}")
        want = bsr_spmm_plain(*args)
        exact = bsr_spmm_plain(b.blocks.double(), b.tile_ptr, b.block_cols, xp.double())
        torch.cuda.synchronize()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        e64, p64 = (float((t.double() - exact).abs().max()) for t in (got, want))
        del got, want, exact
        if err > F32_TILE_TOL * scale:
            raise AssertionError(f"{tag}: F'={fp} max abs err {err:.3e} > {F32_TILE_TOL} * {scale:.3e}")
        if e64 > F64_ERR_RATIO * p64:
            raise AssertionError(f"{tag}: F'={fp} error against f64 {e64:.3e} > {F64_ERR_RATIO} x "
                                 f"the plain f32 version's {p64:.3e}")
        ms, dev_ms = both_ms(lambda: bsr_spmm_f32(*args, split=sp))
        plain_ms = cuda_ms(lambda: bsr_spmm_plain(*args))
        n_bytes = (nbytes(b.blocks, b.tile_ptr, b.block_cols)
                   + rows_read(b.block_cols, 128 * fp, 4) + n_pad * fp * 4)
        flops = 2 * b.nnzb * 128 * 128 * fp
        bnd = bound(n_bytes, 3 * flops, PEAK_TF32)
        ffma = bound(n_bytes, flops, PEAK_F32)
        a = tiles_csr(b, n_pad)
        lib = both_ms(lambda: torch.sparse.mm(a, xp))
        del a
        records.setdefault("bsr_spmm_f32", []).append((err, ms, dev_ms, plain_ms))
        yard.setdefault("bsr_spmm_f32", (*bnd, *lib))
        log(tag, f"F'={fp}: max abs err {err:.3e} (limit {F32_TILE_TOL} * max|plain| = "
            f"{F32_TILE_TOL * scale:.3e}; 3xTF32 against f32 products, sums in another "
            f"order); against the f64 oracle {e64:.3e}, the plain f32 version's {p64:.3e} "
            f"(x{e64 / max(p64, 1e-30):.2f}, limit x{F64_ERR_RATIO}); two launches bit-equal; "
            f"kernel {ms:.4f} ms a call ({dev_ms:.4f} device), plain {plain_ms:.4f} ms, bound "
            f"{bnd[0]:.4f} ms by {bnd[1]} (3xTF32 at {PEAK_TF32 / 1e12:.0f} TFLOP/s; FFMA "
            f"bound {ffma[0]:.4f} ms by {ffma[1]}), {3 * flops / (dev_ms * 1e9):.1f} TFLOP/s "
            f"of TF32 products; torch.sparse.mm {lib[0]:.4f} ms a call ({lib[1]:.4f} device)")


def onehot_phase(graph, gen, records):
    """onehot: K2 from zero over the whole R8 doc-word graph as one CSR (the
    ``--spmm onehot`` layout, B3's role on a new container) at F' = 208 and
    16 against the plain version: two launches bit-equal, the yardsticks.
    Its entries join ``row_reduce_dx`` (K2 from zero, B3)."""
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.ops.row_reduce import row_reduce, row_reduce_plain

    t0 = time.perf_counter()
    g, _ = convert_graph(graph, "onehot")
    c = g.csr
    deg = torch.diff(c.row_ptr.long())
    log("onehot", f"R8 doc-word as one CSR (no sort): {g.n_nodes} rows, {c.n_edges} edges, "
        f"hub row {int(deg.max())}, median {int(deg.median())}; S = 512: "
        f"{0 if c.split is None else c.split.n_long} rows cut into "
        f"{0 if c.split is None else c.split.n_seg} segments; {time.perf_counter() - t0:.1f} s "
        "on the host")
    for f in (200, 8):
        fp = pad16(f)
        x = torch.randn((g.n_nodes, fp), generator=gen, device=c.val.device).to(torch.bfloat16)
        args = (c.row_ptr, c.col, c.val, x)
        got = row_reduce(*args, split=c.split)
        if not torch.equal(got, row_reduce(*args, split=c.split)):
            raise AssertionError(f"onehot: two K2 launches differ at F'={fp}")
        err, _ = compare(got, row_reduce_plain(*args), K2_TOL)
        del got
        ms, dev_ms = both_ms(lambda: row_reduce(*args, split=c.split))
        plain_ms = cuda_ms(lambda: row_reduce_plain(*args))
        yd = k2_yardsticks(*args)
        records.setdefault("row_reduce_dx", []).append((err, ms, dev_ms, plain_ms))
        log("onehot", f"K2 from zero, F'={fp}: max abs err {err:.3e}, tol {K2_TOL}*(1+|ref|) "
            f"(the same bf16 x, f32 sums in another order); two launches bit-equal; kernel "
            f"{ms:.4f} ms a call ({dev_ms:.4f} device), plain {plain_ms:.4f} ms, bound "
            f"{yd[0]:.4f} ms by {yd[1]}, torch.sparse.mm {yd[2]:.4f} ms a call "
            f"({yd[3]:.4f} device)")


def machine_phase(dev):
    """machine: ``probe_machine`` on this card beside the committed
    ``MachineModel`` defaults."""
    import dataclasses

    from textgcn_tpu_torch.graph.format import MachineModel, probe_machine

    mm, secs = wall(lambda: probe_machine(dev))
    base = MachineModel()
    rows = [f"{k.name} {getattr(mm, k.name):.6g} (committed {getattr(base, k.name):.6g})"
            for k in dataclasses.fields(MachineModel)
            if getattr(mm, k.name) != getattr(base, k.name)]
    log("machine", f"probe_machine in {secs:.1f} s: {'; '.join(rows)}")
    return mm


def auto_graphs(dev, r8):
    """The three graphs ``auto`` is held on: R8 doc-word, mr topic and mr
    doc-word, each as prepared (max-symmetrized, sym-normalized)."""
    from textgcn_tpu_torch.text.datasets import load_labels
    from textgcn_tpu_torch.train.prepare import load_graph_edges, prepare_docword_data

    mr_docs = load_labels(os.path.join(REPO, "data", "text_dataset", "mr.txt")).n_docs
    mr_topic = load_graph_edges(os.path.join(REPO, "data", "graph", "mr_topic.txt"),
                                mr_docs + MR_TOPICS, device=dev)
    return {"R8 doc-word": r8, "mr topic": mr_topic,
            "mr doc-word": prepare_docword_data("mr", device=dev).graph}


def auto_phase(dev, gen, graphs, mm_probe):
    """auto: for each graph, one ``Â @ x`` pass (F = 200) of every format the
    cost model finds eligible, device time (CUDA graph) beside the committed
    model's estimate; the pick's device time must be within AUTO_SLACK of the
    fastest, or AUTO_ABS_MS. Also the constants the measured passes imply
    against the probe's rates. Returns {graph: pick}."""
    from textgcn_tpu_torch.graph.format import (
        HYBRID_CALLS, MachineModel, convert_graph, estimate_format_costs,
    )
    from textgcn_tpu_torch.ops.spmm import spmm

    mm = MachineModel()
    picks = {}
    for name, g in graphs.items():
        costs = estimate_format_costs(g, f=200, mm=mm)
        pick = min(costs, key=costs.get)
        x = torch.randn((g.n_nodes, 200), generator=gen, device=dev)
        meas, built = {}, {}
        for fmt in costs:
            (c, _), build_s = wall(lambda: convert_graph(g, fmt))
            with torch.no_grad():
                meas[fmt] = (*both_ms(lambda: spmm(c, x)),)
            built[fmt] = build_s
            if fmt == "hybrid":
                h = c
            del c
        best = min(v[1] for v in meas.values())
        ok = meas[pick][1] <= (1 + AUTO_SLACK) * best or meas[pick][1] - best <= AUTO_ABS_MS
        text = "; ".join(
            f"{fmt}: estimate {1e3 * costs[fmt]:.4f} ms, measured {meas[fmt][1]:.4f} ms device "
            f"({meas[fmt][0]:.4f} a call; layout {built[fmt]:.1f} s)" for fmt in costs)
        implied = ""
        if "hybrid" in meas:
            e = g.n_edges
            t_seg, t_one = meas["segment"][1] * 1e-3, meas["onehot"][1] * 1e-3
            eff_seg = e / (mm_probe.gather_rows_per_s * t_seg)
            eff_one = e / (mm_probe.gather_rows_per_s * t_one)
            rest = 0 if h.rest is None else h.rest.n_edges
            t_rest = rest / (mm_probe.gather_rows_per_s * eff_one)
            n_pad = h.bsr.n_block_rows * 128
            bsr_bytes = h.bsr.nnzb * (128 * 128 * 2 + 128 * 208 * 2) + n_pad * 208 * 4
            t_k1 = max(meas["hybrid"][1] * 1e-3 - t_rest, 1e-9)
            eff_k1 = bsr_bytes / (mm_probe.hbm_gbps * 1e9) / t_k1
            implied = (f"; against the probe's rates these passes imply eff_segment "
                       f"{eff_seg:.4g}, eff_onehot {eff_one:.4g}, eff_hybrid_bsr {eff_k1:.4g} "
                       f"(committed {mm.eff_segment:.4g}, {mm.eff_onehot:.4g}, "
                       f"{mm.eff_hybrid_bsr:.4g}; hybrid's {HYBRID_CALLS} calls priced at "
                       f"{1e3 * mm.call_s:.4f} ms each)")
            del h
        log("auto", f"{name}: {g.n_nodes} nodes, {g.n_edges} edges, F=200; {text}; auto "
            f"picks {pick} ({meas[pick][1]:.4f} ms, fastest measured {best:.4f} ms; limit "
            f"+{AUTO_SLACK:.0%} or +{AUTO_ABS_MS} ms){implied}")
        if not ok:
            raise AssertionError(f"auto on {name} picks {pick} at {meas[pick][1]:.4f} ms, "
                                 f"the fastest format takes {best:.4f} ms")
        picks[name] = pick
        del x
    torch.cuda.empty_cache()
    return picks


def gat_peak_phase(dev, gen, graphs):
    """auto (GAT): one dense GAT forward + backward (H = 200, dropout on) on
    R8 doc-word; its peak memory above what was held before, beside the
    priced peak (``gat_dense_tables`` [N, N] f32 tables), which must not be
    below it; and what GAT's auto picks on each graph."""
    from textgcn_tpu_torch.graph.format import MachineModel, gat_auto_format
    from textgcn_tpu_torch.models.gat import GAT, DenseAttentionGraph

    mm = MachineModel()
    g = graphs["R8 doc-word"]
    n = g.n_nodes
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dg = DenseAttentionGraph.from_sparse_graph(g)
    model = GAT(n, 200, 8, 0.5, device=dev, generator=gen)
    model(dg, None, generator=gen).square().sum().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del dg, model
    torch.cuda.empty_cache()
    table = 4.0 * n * n
    priced = mm.gat_dense_tables * table
    picks = {name: gat_auto_format(gr.n_nodes, mm) for name, gr in graphs.items()}
    log("auto gat", f"R8 doc-word dense GAT fwd+bwd (N = {n}, H = 200): measured peak "
        f"{peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held before = {peak / table:.3f} "
        f"[N, N] f32 tables; priced {mm.gat_dense_tables} tables = {priced / 1e9:.3f} GB "
        f"(budget {mm.dense_bytes_budget / 2**30:.0f} GiB); GAT auto picks {picks}")
    if priced < peak:
        raise AssertionError(f"GAT's priced dense peak {priced:.3e} B < measured {peak:.3e} B")
    return picks


def fresh_topic_root(tmp, dataset):
    """A data root under ``tmp`` with copies of ``dataset``'s committed topic
    artifacts (the label files and clean corpus linked), its theta cache
    written after the model pickle, so prepare takes the cache."""
    root = os.path.join(tmp, f"{dataset}_topic_root")
    os.makedirs(os.path.join(root, "graph"))
    os.symlink(os.path.join(REPO, "data", "text_dataset"), os.path.join(root, "text_dataset"))
    for suffix in (".txt", "_model.pkl", "_theta.npy"):
        shutil.copyfile(os.path.join(REPO, "data", "graph", f"{dataset}_topic{suffix}"),
                        os.path.join(root, "graph", f"{dataset}_topic{suffix}"))
    now = time.time()
    os.utime(os.path.join(root, "graph", f"{dataset}_topic_model.pkl"), (now - 10, now - 10))
    os.utime(os.path.join(root, "graph", f"{dataset}_topic_theta.npy"), (now, now))
    return root


def kernel_need(fmt, model="gcn"):
    """The kernels a run on ``fmt`` must launch, and the record its K2
    launches belong to (B2 with a base, B3 from zero)."""
    if model == "gat":
        return {"hybrid": ("row_reduce", "attn_stats", "attn_agg", "sddmm", "rowsum"),
                "onehot": ("row_reduce", "attn_stats", "attn_agg", "sddmm", "rowsum")}.get(fmt, ())
    return {"hybrid": ("bsr_spmm", "row_reduce"), "bsr": ("bsr_spmm_f32",),
            "onehot": ("row_reduce",)}.get(fmt, ())


def formats_training_phase(cli, counters, tmp, picks, gat_picks):
    """train auto / bsr / onehot, through cli.main: mr topic (auto) on the
    JAX package's committed seeds, mean within FAMILY_GAP of its 0.5781; R8
    doc-word GCN on auto, bsr and onehot at the smoke's seed, each >=
    ACC_MIN; R8 doc-word GAT on auto on the committed seeds (dense: within
    FAMILY_GAP of 0.9157; the attention hybrid: >= GAT_ACC_MIN). Returns
    [(launches, K2 record)] of the runs."""
    paths = []

    def check(launches, fmt, model, what):
        need = kernel_need(fmt, model)
        if need and min(launches[k] for k in need) < 1:
            raise AssertionError(f"{what}: a kernel of {fmt} never launched: {launches}")
        dx = model == "gat" or fmt == "onehot"
        paths.append((launches, "row_reduce_dx" if dx else "row_reduce"))

    ref = committed_report("mr_topic")
    seeds = [r["seed"] for r in ref["runs"]]
    summary, launches, wall_s = run_cli(
        cli, ["--data_root", fresh_topic_root(tmp, "mr"), "--seeds", *map(str, seeds)],
        counters, "topic", dataset="mr")
    check(launches, picks["mr topic"], "gcn", "mr topic auto")
    mean, want = summary["test_accuracy"]["mean"], ref["test_accuracy"]["mean"]
    accs = ", ".join(f"{r['test']['acc']:.4f}" for r in summary["runs"])
    log("train auto", f"cli train --dataset mr (topic, auto = {picks['mr topic']}) on seeds "
        f"{seeds}: acc {accs}, mean {mean:.4f}; the JAX package's committed mean {want:.4f}, "
        f"gap {mean - want:+.4f} (limit ±{FAMILY_GAP}); {wall_s:.1f} s; launches {launches}")
    if abs(mean - want) > FAMILY_GAP:
        raise AssertionError(f"mr topic auto mean {mean:.4f} is {mean - want:+.4f} off JAX's")
    for fmt, spmm in ((picks["R8 doc-word"], "auto"), ("bsr", "bsr"), ("onehot", "onehot")):
        launches, _ = train_via_cli(cli, f"gcn {spmm}", ["--spmm", spmm], ACC_MIN, counters,
                                    need=kernel_need(fmt))
        check(launches, fmt, "gcn", f"R8 doc-word --spmm {spmm}")
    ref = committed_report("R8_docword")
    seeds = [r["seed"] for r in ref["runs"]]
    summary, launches, wall_s = run_cli(
        cli, ["--graph", "docword", "--model", "gat", "--seeds", *map(str, seeds)],
        counters, "docword")
    pick = gat_picks["R8 doc-word"]
    check(launches, pick, "gat", "R8 doc-word GAT auto")
    mean, want = summary["test_accuracy"]["mean"], ref["test_accuracy"]["mean"]
    accs = ", ".join(f"{r['test']['acc']:.4f}" for r in summary["runs"])
    bar = (f"within ±{FAMILY_GAP} of the JAX package's committed dense mean {want:.4f}"
           if pick == "dense" else f">= {GAT_ACC_MIN} (the attention hybrid's bar)")
    log("train auto", f"cli train --dataset R8 --graph docword --model gat (auto = {pick}) "
        f"on seeds {seeds}: acc {accs}, mean {mean:.4f}; bar: {bar}; {wall_s:.1f} s; "
        f"launches {launches}")
    if (abs(mean - want) > FAMILY_GAP) if pick == "dense" else (mean < GAT_ACC_MIN):
        raise AssertionError(f"R8 doc-word GAT auto mean {mean:.4f} misses its bar")
    return paths


def checkpoint_phase(cli, counters, tmp):
    """checkpoint: R8 doc-word GCN on --spmm hybrid (no atomics: its kernels
    give the same bits run to run) and on --spmm segment (its scatter-add is
    ``index_put_(accumulate=True)`` on the card, the same bits run to run).
    For each, a straight 20-epoch run saved with --save_model; 10 epochs
    saved with --save_state, then --resume to 20: the 20 train losses must
    equal the straight run's bit for bit; the saved params through
    --load_model (and ``evaluate_checkpoint``, the function it calls) must
    give the straight run's test accuracy exactly. Everything is written
    under ``tmp``. Returns [(launches, K2 record)] of the runs."""
    from textgcn_tpu_torch.train.run import evaluate_checkpoint

    paths = []
    for spmm in ("hybrid", "segment"):
        flags = ["--graph", "docword", "--spmm", spmm, "--early_stopping", "1000"]
        model_dir, state_dir = (os.path.join(tmp, f"{d}_{spmm}") for d in ("model", "state"))
        straight, l1, s_wall = run_cli(cli, [*flags, "--seeds", str(SEED), "--max_epoch", "20",
                                             "--save_model", model_dir], counters, "docword")
        first, l2, f_wall = run_cli(cli, [*flags, "--seeds", str(SEED), "--max_epoch", "10",
                                          "--save_state", state_dir], counters, "docword")
        resumed, l3, r_wall = run_cli(cli, [*flags, "--max_epoch", "20", "--resume", state_dir],
                                      counters, "docword")
        need = kernel_need(spmm)
        for launches in (l1, l2, l3):
            if need and min(launches[k] for k in need) < 1:
                raise AssertionError(f"a kernel of the checkpoint runs never launched: {launches}")
        losses = [h["train_loss"] for s in (first, resumed) for h in s["runs"][0]["history"]]
        want = [h["train_loss"] for h in straight["runs"][0]["history"]]
        acc = straight["runs"][0]["test"]["acc"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["train", "--dataset", "R8", "--graph", "docword", "--spmm", spmm,
                           "--load_model", model_dir])
        loaded = evaluate_checkpoint("R8", model_dir, graph_family="docword", spmm=spmm,
                                     device="cuda")["acc"]
        log("checkpoint", f"R8 doc-word GCN {spmm}, seed {SEED}: straight 20 epochs "
            f"({s_wall:.1f} s), 10 epochs + --save_state ({f_wall:.1f} s), --resume to 20 "
            f"({r_wall:.1f} s, seed {resumed['runs'][0]['seed']} from the checkpoint): "
            f"{len(losses)} train losses, bit-equal to the straight run's: {losses == want}; "
            f"--load_model: {out.getvalue().strip()!r} (rc {rc}), evaluate_checkpoint acc "
            f"{loaded!r} vs the run's {acc!r}: equal {loaded == acc}")
        if losses != want or rc != 0 or loaded != acc or f"acc={acc:.4f}" not in out.getvalue():
            raise AssertionError(f"{spmm}: a resumed run or a loaded checkpoint differs from "
                                 "the straight run")
        paths += [(launches, "row_reduce") for launches in (l1, l2, l3)]
    return paths


def segment_determinism_phase(cli, counters, root):
    """segment determinism: two same-seed ``--spmm segment`` runs of 20
    epochs (dropout on) on R8 topic, for the GCN and for the GAT, must give
    bit-equal train and val losses (the scatter-adds are
    ``index_put_(accumulate=True)`` on the card, not ``index_add_``'s
    atomics)."""
    for family in ("gcn", "gat"):
        runs = []
        for _ in range(2):
            summary, _, wall_s = run_cli(
                cli, ["--data_root", root, "--model", family, "--spmm", "segment", "--seeds",
                      str(HYBRID_SEED), "--max_epoch", "20", "--early_stopping", "1000"],
                counters, "topic")
            hist = summary["runs"][0]["history"]
            runs.append(([h["train_loss"] for h in hist], [h["val_loss"] for h in hist], wall_s))
        (t1, v1, w1), (t2, v2, w2) = runs
        log("segment determinism", f"R8 topic {family} --spmm segment, seed {HYBRID_SEED}, "
            f"{len(t1)} epochs twice ({w1:.1f} s, {w2:.1f} s): train losses bit-equal "
            f"{t1 == t2}, val losses bit-equal {v1 == v2}; last train loss {t1[-1]!r}")
        if len(t1) != 20 or t1 != t2 or v1 != v2:
            raise AssertionError(f"two same-seed segment runs of the topic {family} differ")


def artifact_snapshot():
    """{path: (size, mtime_ns)} of every file under the checkout's data/,
    experiments/ and results/."""
    out = {}
    for top in ARTIFACT_DIRS:
        for dirpath, _, files in os.walk(os.path.join(REPO, top)):
            for name in files:
                path = os.path.join(dirpath, name)
                st = os.stat(path)
                out[os.path.relpath(path, REPO)] = (st.st_size, st.st_mtime_ns)
    return out


def corpus_root(tmp, name, dataset):
    """A data root under ``tmp`` holding copies of ``dataset``'s label file
    and clean corpus, and nothing else."""
    root = os.path.join(tmp, name)
    os.makedirs(os.path.join(root, "text_dataset", "clean_corpus"))
    for rel in (f"{dataset}.txt", os.path.join("clean_corpus", f"{dataset}.txt")):
        shutil.copyfile(os.path.join(REPO, "data", "text_dataset", rel),
                        os.path.join(root, "text_dataset", rel))
    return root


def jaccard(src_a, dst_a, src_b, dst_b):
    a = set(zip(src_a.tolist(), dst_a.tolist()))
    b = set(zip(src_b.tolist(), dst_b.tolist()))
    return len(a & b) / max(len(a | b), 1)


def build_phase(dev, root):
    """22. build r8 topic: R8's topic graph built on the card from the
    committed clean corpus into ``root`` with experiments/r8.yaml's build
    settings (the builder's 60 EM iterations), through the builder that
    ``cli build-graph`` and the runner call; measured against the committed
    build of the JAX package (bound trace, phi, edges)."""
    from textgcn_tpu_torch.graph.build_topic import TopicGraphBuilder, read_weighted_edgelist
    from textgcn_tpu_torch.topics.model import TopicModel
    from textgcn_tpu_torch.train.prepare import cached_theta
    from textgcn_tpu_torch.utils.config import ExperimentConfig

    b = ExperimentConfig.from_yaml(os.path.join(REPO, "experiments", "r8.yaml")).build
    builder = TopicGraphBuilder(
        "R8", num_topics=b.num_topics, doc_topic_threshold=b.doc_topic_threshold,
        topic_topic_threshold=b.topic_topic_threshold, min_df=b.min_df, max_df=b.max_df,
        use_word2vec=b.use_word2vec, lda_backend=b.lda_backend, lda_max_iter=b.lda_max_iter,
        data_root=root, verbose=False, device=dev,
    )
    torch.cuda.reset_peak_memory_stats()
    live = torch.cuda.memory_allocated()
    (g, _), build_s = wall(lambda: (builder.build(), builder.save()))
    peak_mb = (torch.cuda.max_memory_allocated() - live) / 1e6
    tm, times = builder.topic_model, builder.timer.times
    lda, w2v = tm.lda, tm.word2vec_model
    with open(os.path.join(REPO, "results", "R8_lda_elbo_trace.json")) as fh:
        ref = json.load(fh)["per_word_bound_trace"][: b.lda_max_iter]
    n = min(len(ref), len(lda.bound_trace_))
    d_bound = max(abs(x - y) for x, y in zip(lda.bound_trace_[:n], ref[:n]))
    final_gap = lda.bound_trace_[-1] - ref[len(lda.bound_trace_) - 1]
    committed = TopicModel().load(os.path.join(REPO, "data", "graph", "R8_topic_model.pkl"))
    if list(tm.vocabulary_) != list(committed.vocabulary_):
        raise AssertionError("the built vocabulary differs from the committed model's")
    d_phi = float(np.abs(tm.topic_word_distribution - committed.topic_word_distribution).max())
    src, dst, _ = read_weighted_edgelist(os.path.join(REPO, "data", "graph", "R8_topic.txt"))
    dt, ndt = src < 7674, g.n_doc_topic_edges
    jac_dt = jaccard(g.src[:ndt], g.dst[:ndt], src[dt], dst[dt])
    jac_tt = jaccard(g.src[ndt:], g.dst[ndt:], src[~dt], dst[~dt])
    theta = builder._theta
    log("build r8 topic", f"TopicGraphBuilder on the card, experiments/r8.yaml's build "
        f"({b.num_topics} topics, lda_max_iter {b.lda_max_iter}): {build_s:.2f} s with the "
        f"save; by stage {json.dumps({k: round(v, 3) for k, v in times.items()})}; LDA "
        f"{lda.n_iter_} EM iterations over {len(lda.e_step_iters_) // max(lda.n_iter_, 1)} "
        f"chunks of {lda.chunk_size} docs x {lda.components_.shape[1]} words, "
        f"{sum(lda.e_step_iters_)} E-step iterations ({sum(lda.e_step_iters_) / times['lda fit']:.0f} "
        f"a second); Word2Vec {w2v.steps_} CBOW steps of {w2v.batch_size} "
        f"({w2v.steps_ / times['word2vec']:.1f} steps/s), {len(w2v)} words; peak device "
        f"memory {peak_mb:.1f} MB above what earlier phases hold. Per-word bound vs the committed trace's first {n}: max "
        f"|diff| {d_bound:.3e}, final {lda.bound_trace_[-1]:.6f} (committed "
        f"{ref[len(lda.bound_trace_) - 1]:.6f}, gap {final_gap:+.6f}); phi vs the committed "
        f"model's max |diff| {d_phi:.3e}; edges: doc-topic {g.n_doc_topic_edges} (committed "
        f"{R8_DOC_TOPIC_EDGES}), topic-topic {g.n_topic_topic_edges} (committed "
        f"{R8_TOPIC_TOPIC_EDGES}), Jaccard vs data/graph/R8_topic.txt {jac_dt:.4f} and "
        f"{jac_tt:.4f}")
    if final_gap < -BOUND_FINDING:
        log("build r8 topic", f"FINDING: the final bound is {-final_gap:.4f} nats/word below "
            f"the committed trace's (more than {BOUND_FINDING})")
    base = os.path.join(root, "graph", "R8_topic")
    if (g.n_nodes, theta.shape) != (7724, (7674, 50)) or not np.isfinite(lda.components_).all():
        raise AssertionError(f"the build gave {g.n_nodes} nodes, theta {theta.shape}")
    if np.abs(theta.sum(axis=1) - 1).max() > 1e-5 or not g.n_doc_topic_edges:
        raise AssertionError("theta rows do not sum to 1, or no doc-topic edge")
    cached = cached_theta(base, 7674, 50)
    if cached is None or not np.array_equal(cached, theta):
        raise AssertionError("training would not take the built theta (mtime rule)")


def determinism_phase(dev, root):
    """23. build determinism: two LDA fits (2 EM iterations) and two
    Word2Vec fits (1 epoch) on the R8 corpus from one seed each must give
    the same bits."""
    from textgcn_tpu_torch.topics.lda import LDA
    from textgcn_tpu_torch.topics.model import load_documents_from_file
    from textgcn_tpu_torch.topics.vectorize import CountVectorizer
    from textgcn_tpu_torch.topics.word2vec import Word2Vec

    docs = load_documents_from_file(os.path.join(root, "text_dataset", "clean_corpus", "R8.txt"))
    dtm = CountVectorizer(min_df=2, max_df=0.95).fit_transform(docs)
    ldas, lda_s = wall(lambda: [LDA(n_components=50, max_iter=2).fit(dtm, device=dev) for _ in range(2)])
    w2vs, w2v_s = wall(lambda: [Word2Vec(epochs=1, seed=42).fit(docs, device=dev) for _ in range(2)])
    same_lda = (np.array_equal(ldas[0].components_, ldas[1].components_)
                and ldas[0].bound_trace_ == ldas[1].bound_trace_)
    same_w2v = np.array_equal(w2vs[0].vectors, w2vs[1].vectors)
    log("build determinism", f"two LDA fits of 2 EM iterations ({lda_s:.2f} s): bit-equal "
        f"{same_lda}; two Word2Vec fits of 1 epoch, {w2vs[0].steps_} steps each ({w2v_s:.2f} s): "
        f"bit-equal {same_w2v}")
    if not (same_lda and same_w2v):
        raise AssertionError("two same-seed fits on the card differ")


def train_built_phase(cli, counters, dev, root):
    """24. train built r8: the GCN on the port's own build through the CLI,
    segment on the bench seeds (mean >= the reference's and within BUILT_GAP
    of the JAX package's committed mean), then once on --spmm hybrid with
    its kernels' launches counted."""
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.train.prepare import prepare_topic_data

    summary, _, _, text = topic_runs(cli, counters, root, "gcn", "segment", BENCH_SEEDS)
    mean, ref = summary["test_accuracy"]["mean"], committed("gcn")["test_accuracy"]["mean"]
    log("train built r8", f"on the port's build: {text}; the JAX package's committed mean "
        f"{ref:.4f}, gap {mean - ref:+.4f} (limit ±{BUILT_GAP}; the reference's {REF_TOPIC_ACC})")
    if mean < REF_TOPIC_ACC or abs(mean - ref) > BUILT_GAP:
        raise AssertionError(f"GCN on the built graph: mean acc {mean:.4f}")
    h, _ = convert_graph(prepare_topic_data("R8", data_root=root, device=dev).graph, "hybrid")
    _, launches, _, text = topic_runs(cli, counters, root, "gcn", "hybrid", [HYBRID_SEED])
    need = ("bsr_spmm",) if h.rest is None else ("bsr_spmm", "row_reduce")
    log("train built r8", f"{text}; {h.bsr.nnzb} tiles, residual edges "
        f"{0 if h.rest is None else h.rest.n_edges}; launches {launches}")
    if min(launches[k] for k in need) < 1:
        raise AssertionError(f"a kernel of the built graph's hybrid path never launched: {launches}")
    return launches


def experiment_phase(cli, tmp, name="r8.yaml"):
    """25. experiment r8: ``cli experiment`` on a copy of experiments/{name}
    (r8.yaml: the topic graph built on the card; r8_docword.yaml: the
    doc-word graph built on the host, trained on --spmm auto) whose
    data_root holds only the label file and the clean corpus, from a
    temporary working directory; its stages must leave their logs,
    config_used.yaml, reports and stage times."""
    import yaml

    stem = name.removesuffix(".yaml")
    root = corpus_root(tmp, f"experiment_data_{stem}", "R8")
    cwd = os.path.join(tmp, f"experiment_cwd_{stem}")
    os.makedirs(cwd)
    with open(os.path.join(REPO, "experiments", name), encoding="utf-8") as fh:
        cfg = yaml.safe_load(fh)
    cfg["data_root"] = root
    family = cfg.get("graph", "topic")
    path = os.path.join(cwd, name)
    with open(path, "w", encoding="utf-8") as fh:
        yaml.safe_dump(cfg, fh)
    here = os.getcwd()
    os.chdir(cwd)
    try:
        rc, secs = wall(lambda: cli.main(["experiment", "--config", path]))
    finally:
        os.chdir(here)
    exp = os.path.join(cwd, "experiments", "R8" if family == "topic" else "R8_docword")
    stages = ("build", "train", "inspect") if family == "topic" else ("build", "train")
    report = os.path.join("results", f"R8_{family}_training_results.json")
    need = [os.path.join("logs", f"{s}.log") for s in stages] + [
        os.path.join("logs", "stage_times.txt"), "config_used.yaml", report,
        *([os.path.join("results", "R8_topic_inspection.txt")] if family == "topic" else []),
    ]
    missing = [p for p in need if not os.path.exists(os.path.join(exp, p))]
    if rc != 0 or missing:
        raise AssertionError(f"cli experiment returned {rc}; missing {missing}")
    with open(os.path.join(exp, "logs", "stage_times.txt"), encoding="utf-8") as fh:
        stages = " | ".join(" ".join(ln.split()) for ln in fh.read().splitlines()[1:])
    with open(os.path.join(exp, report)) as fh:
        acc = json.load(fh)["test_accuracy"]["mean"]
    log(f"experiment {stem}", f"cli experiment --config {name} (data_root a temporary copy): "
        f"{secs:.1f} s; stages (s, share): {stages}; test acc {acc:.4f}; logs, "
        f"config_used.yaml, the reports and stage_times.txt written under the working "
        f"directory")


def docword_phase(cli, tmp):
    """26. build mr docword (host): ``cli build-docword --dataset mr`` into a
    temporary data root, against the committed data/graph/mr_docword.txt as
    a sorted edge set (weights within DOCWORD_RTOL relative)."""
    from textgcn_tpu_torch.graph.build_topic import read_weighted_edgelist

    root = corpus_root(tmp, "mr_data", "mr")
    rc, secs = wall(lambda: cli.main(["build-docword", "--dataset", "mr", "--data_root", root]))
    if rc != 0:
        raise AssertionError(f"cli build-docword returned {rc}")

    def sorted_edges(path):
        src, dst, w = read_weighted_edgelist(path)
        order = np.lexsort((dst, src))
        return src[order], dst[order], w[order]

    got = sorted_edges(os.path.join(root, "graph", "mr_docword.txt"))
    want = sorted_edges(os.path.join(REPO, "data", "graph", "mr_docword.txt"))
    same = len(got[0]) == len(want[0]) and all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
    rel = float(np.max(np.abs(got[2] - want[2]) / np.abs(want[2]))) if same else float("inf")
    with open(os.path.join(root, "graph", "mr_docword_vocab.txt"), "rb") as a, open(
            os.path.join(REPO, "data", "graph", "mr_docword_vocab.txt"), "rb") as b:
        same_vocab = a.read() == b.read()
    log("build mr docword", f"cli build-docword --dataset mr on the host: {secs:.2f} s, "
        f"{len(got[0])} edges (committed {len(want[0])}); same edge set {same}, weights max "
        f"rel diff {rel:.3e} (limit {DOCWORD_RTOL}); vocabulary file byte-equal {same_vocab}")
    if not (same and same_vocab) or rel > DOCWORD_RTOL:
        raise AssertionError("the mr doc-word build differs from the committed graph")


def checkout_phase(before):
    """27. checkout untouched: no file under data/, experiments/ or results/
    was added, removed or rewritten by this run; in a git checkout, also
    ``git status --porcelain`` lists none there."""
    after = artifact_snapshot()
    changed = sorted(k for k in set(before) | set(after) if before.get(k) != after.get(k))
    git = "not a git checkout: git status not asked"
    top = subprocess.run(["git", "-C", REPO, "rev-parse", "--show-toplevel"],
                         capture_output=True, text=True) if shutil.which("git") else None
    if top is not None and top.returncode == 0 and os.path.samefile(top.stdout.strip(), REPO):
        status = subprocess.run(["git", "-C", REPO, "status", "--porcelain", "--", *ARTIFACT_DIRS],
                                capture_output=True, text=True)
        if status.returncode == 0:
            changed += status.stdout.splitlines()
            git = f"git status --porcelain lists {len(status.stdout.splitlines())} there"
        else:
            git = f"git status failed ({status.stderr.strip()[:200]}): the snapshot alone decides"
    log("checkout untouched", f"{len(before)} files under {', '.join(ARTIFACT_DIRS)}: "
        f"{len(changed)} added, removed or rewritten; {git}")
    if changed:
        raise AssertionError(f"the run wrote into the checkout: {changed[:10]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    untouched = artifact_snapshot()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from textgcn_tpu_torch import cli
    from textgcn_tpu_torch.graph.format import convert_graph
    from textgcn_tpu_torch.graph.reorder import hybrid_pass, spmm_hybrid
    from textgcn_tpu_torch.graph.structs import SparseGraph
    from textgcn_tpu_torch.models import gat
    from textgcn_tpu_torch.ops import _build
    from textgcn_tpu_torch.ops import attention as att
    from textgcn_tpu_torch.ops.bsr_spmm import (
        F_ALIGN, SEGMENT_TILES, bsr_leg, bsr_spmm, bsr_spmm_f32, bsr_spmm_plain,
    )
    from textgcn_tpu_torch.ops.row_reduce import (
        SEGMENT_EDGES, row_reduce, row_reduce_plain,
    )
    from textgcn_tpu_torch.ops.spmm import spmm_coo_segment
    from textgcn_tpu_torch.train.prepare import apply_attention_format, prepare_topic_data

    # the library yardsticks build CSR tensors, a beta API that says so
    warnings.filterwarnings("ignore", message="Sparse")
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
    lib = _build.load()
    info = _build.build_info()
    regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    seg_edges = lib.textgcn_row_reduce_segment_edges()
    if seg_edges != SEGMENT_EDGES:
        raise AssertionError(f"K2 built for S = {seg_edges}, its tables for {SEGMENT_EDGES}")
    seg_tiles = lib.textgcn_bsr_spmm_segment_tiles()
    if seg_tiles != SEGMENT_TILES or lib.textgcn_bsr_spmm_f32_segment_tiles() != SEGMENT_TILES:
        raise AssertionError(f"K1 built for T = {seg_tiles} (f32 mode "
                             f"{lib.textgcn_bsr_spmm_f32_segment_tiles()}), its tables for "
                             f"{SEGMENT_TILES}")
    log("build", f"nvcc built {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.1f} s; K2's and attn_agg's S = {seg_edges} "
        f"edges a warp, K1's T = {seg_tiles} tiles a block; "
        f"ptxas: {' | '.join(regs)}")

    # 2b. machine: the cost model's rates measured here
    mm_probe = machine_phase(dev)

    # the real R8 doc-word hybrid layout, from the native graph core
    pre = native_prep_phase(dev)
    t0 = time.perf_counter()
    h, perm = convert_graph(pre.graph, "hybrid")
    bsr, rest = h.bsr, h.rest
    per_row = torch.diff(bsr.tile_ptr.long())
    ksp = bsr.split
    log("data", f"R8 doc-word: {h.n_nodes} nodes, {h.n_edges} edges; tiles "
        f"{bsr.nnzb} ({bsr.n_edges} edges, {h.dense_fraction:.4f}), "
        f"{bsr.n_block_rows} block-rows, max {int(per_row.max())} tiles in a "
        f"block-row, K1 T = {SEGMENT_TILES}: "
        f"{0 if ksp is None else ksp.n_long} block-rows longer than T cut into "
        f"{0 if ksp is None else ksp.n_seg} segments; residual {rest.n_edges} edges, longest row "
        f"{int(torch.diff(rest.row_ptr).max())}, K2 S = {SEGMENT_EDGES} "
        f"({'no' if rest.split is None else rest.split.n_long} rows split); "
        f"hybrid conversion {time.perf_counter() - t0:.1f} s on the host")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    # the phases of the --spmm bsr / onehot / auto slice draw from their own
    # generator, so the earlier phases' inputs stay what they were
    gen_formats = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_pad = bsr.n_block_rows * bsr.bm
    # kernel name -> [(max abs err, ms, device ms, plain ms), ...]; the first
    # timed entry is the one the JSON record reports times from (F=200, the
    # forward CSR; the phases that only check a kernel add (err, None, None,
    # None)); yard: kernel name -> (bound ms, bound by, library ms,
    # library device ms; None where there is none) for it
    records, yard = {}, {}

    # 3. K1 vs plain
    for f in (200, 8):
        fp = -(-f // F_ALIGN) * F_ALIGN
        xp = torch.zeros((n_pad, fp), dtype=torch.bfloat16, device=dev)
        xp[: h.n_nodes, :f] = torch.randn((h.n_nodes, f), generator=gen, device=dev)
        args = (bsr.blocks, bsr.tile_ptr, bsr.block_cols, xp)
        got, want = bsr_spmm(*args, split=ksp), bsr_spmm_plain(*args)
        if not torch.equal(got, bsr_spmm(*args, split=ksp)):
            raise AssertionError(f"two K1 launches differ at F={f}")
        err, rel = compare(got, want, K1_TOL)
        ms, dev_ms = both_ms(lambda: bsr_spmm(*args, split=ksp))
        plain_ms = cuda_ms(lambda: bsr_spmm_plain(*args))
        lib_k1 = ""
        if f == 200:
            yard["bsr_spmm"] = k1_yardsticks(bsr, xp, n_pad)
            lib_k1 = (f", bound {yard['bsr_spmm'][0]:.4f} ms by {yard['bsr_spmm'][1]}, "
                      f"torch.sparse.mm {yard['bsr_spmm'][2]:.4f} ms a call "
                      f"({yard['bsr_spmm'][3]:.4f} device)")
        log("K1 bsr_spmm", f"F={f} (F'={fp}), split at T = {SEGMENT_TILES}: max abs "
            f"err {err:.3e}, rel {rel:.3e}, tol {K1_TOL}*(1+|ref|) (same bf16 "
            f"products, f32 sums in another order); two launches bit-equal; "
            f"kernel {ms:.4f} ms a call ({dev_ms:.4f} device), plain "
            f"{plain_ms:.4f} ms{lib_k1}")
        records.setdefault("bsr_spmm", []).append((err, ms, dev_ms, plain_ms))

        # 4. K2 vs plain on the real residual leg, onto K1's output and from 0
        rargs = (rest.row_ptr, rest.col, rest.val, xp)
        err_b, _ = compare(
            row_reduce(*rargs, base=got.clone(), split=rest.split),
            row_reduce_plain(*rargs, base=got.clone()), K2_TOL,
        )
        err_z, rel_z = compare(
            row_reduce(*rargs, split=rest.split), row_reduce_plain(*rargs), K2_TOL
        )
        base = got.clone()
        ms, dev_ms = both_ms(lambda: row_reduce(*rargs, base=base, split=rest.split))
        plain_ms = cuda_ms(lambda: row_reduce_plain(*rargs, base=base))
        log("K2 row_reduce", f"F={f}: max abs err {err_b:.3e} with base, "
            f"{err_z:.3e} (rel {rel_z:.3e}) from zero, tol {K2_TOL}*(1+|ref|) "
            f"(f32 sums of a few products per row); kernel {ms:.4f} ms a call "
            f"({dev_ms:.4f} device), plain {plain_ms:.4f} ms (with base)")
        records.setdefault("row_reduce", []).append((max(err_b, err_z), ms, dev_ms, plain_ms))
        if f == 200:
            yard["row_reduce"] = k2_yardsticks(rest.row_ptr, rest.col, rest.val, xp, base)

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
    hyb_ms = cuda_ms(lambda: hybrid_pass(h, x.detach()))
    seg_ms = cuda_ms(
        lambda: spmm_coo_segment(seg.row, seg.col, seg.val, x.detach(), h.n_nodes)
    )
    log("hybrid", f"F=200 pass vs segment oracle: max abs err {err:.3e} (rel "
        f"{rel:.3e}), backward {gerr:.3e}, tol {HYBRID_TOL}*(1+|ref|) (bf16 "
        f"features and tiles); backward == pass on the cotangent; hybrid pass "
        f"{hyb_ms:.4f} ms, segment pass {seg_ms:.4f} ms")
    del seg, x, y, want, cot, bwd_again, bsr, rest

    # 5a. K1's f32 mode on the bare R8 doc-word tile stack (--spmm bsr)
    b, _ = convert_graph(pre.graph, "bsr")
    bsr_f32_phase("bsr f32", b, gen_formats, (200, 8), records, yard)
    del b

    # 5b. B10: the sharded tile legs at SHARDS ranks, in this process
    shard_phase(dev, gen, records, yard, h, perm[row], perm[col], val)
    del h

    # 6. the GCN main path, through the CLI
    counters = {
        "bsr_spmm": (bsr_spmm,), "bsr_spmm_f32": (bsr_spmm_f32,), "bsr_leg": (bsr_leg,),
        "row_reduce": (row_reduce,),
        "attn_stats": (att.stats_logits,), "softmax_stats": (att.softmax_stats,),
        "attn_agg": (att.attn_agg,), "sddmm": (att.sddmm,),
        "rowsum": (att.rowsum,),
    }
    launches, _ = train_via_cli(
        cli, "gcn", ["--spmm", "hybrid"], ACC_MIN, counters,
        need=("bsr_spmm", "row_reduce"),
    )

    # 6b. the sharded GCN through the CLI: an NCCL group of one on this card
    shard1, run1 = train_via_cli(
        cli, "gcn sharded", ["--spmm", "hybrid", "--shards", "1", "--partition", "allgather"],
        ACC_MIN, counters, need=("bsr_leg", "row_reduce"),
        sharding={"n_shards": 1, "partition": "allgather", "kernel": "hybrid"},
    )
    # 6c. SHARDS ranks on this one card through the library (gloo: NCCL
    # refuses two ranks on one GPU); rank 0 runs here, so its launches count
    shard4 = train_sharded_ranks(pre, counters, run1)
    # 6c'. ranks started by an outside launcher (torchrun), against spawned ranks
    launcher_launches = launcher_ranks_phase(pre)
    # 6d. the one-hot mesh layouts (B.1, B.2) on SHARDS gloo ranks, and the
    # sharded GCN under halo-segment, halo-onehot and allgather-onehot
    mesh_onehot_phase(pre.graph, records)
    halo_k2 = train_sharded_halo_phase(pre)
    # 6d'. route B.3: the attention kernels on each rank's rectangular graph
    mesh_gat_phase(pre.graph, records)
    # 6e. the JAX defaults under --shards: halo + segment (an NCCL group of one)
    shard1_defaults, _ = train_via_cli(
        cli, "gcn sharded defaults", ["--shards", "1"], ACC_MIN, counters, need=(),
        sharding={"n_shards": 1, "partition": "halo", "kernel": "segment"},
    )
    if any(shard1_defaults.values()):
        raise AssertionError(f"--shards with the JAX defaults launched {shard1_defaults}")
    # 6f. sharded checkpoints on SHARDS gloo ranks, and route B.4 (the sorted
    # ring over B11) on them
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_launches = sharded_checkpoint_phase(pre, tmp)
        mesh_ranks_launches = mesh_stream_ranks_phase(pre, records, tmp)

    # 7. the attention kernels vs plain on the degree-sorted R8 attention graph
    t0 = time.perf_counter()
    pre_att = apply_attention_format(pre, degree_sort=True)
    ag = pre_att.graph
    deg = torch.diff(ag.row_ptr)
    sp, sp_t = ag.split, ag.split_t
    log("gat data", f"R8 doc-word attention graph (degree-sorted): "
        f"{ag.n_nodes} rows, {ag.n_edges} edges; hub row {ag.max_degree} "
        f"edges, median row {int(deg.median())}, {int((deg >= 1024).sum())} "
        f"rows >= 1024 edges; S = {SEGMENT_EDGES}: the forward CSR's "
        f"{0 if sp is None else sp.n_long} rows longer than S cut into "
        f"{0 if sp is None else sp.n_seg} segments (attn_stats, attn_agg, rowsum), "
        f"the transpose CSR's {0 if sp_t is None else sp_t.n_long} into "
        f"{0 if sp_t is None else sp_t.n_seg} (K2 as dx, rowsum); "
        f"{time.perf_counter() - t0:.1f} s on the host")
    n = ag.n_nodes
    es = torch.randn(n, generator=gen, device=dev)
    ed = torch.randn(n, generator=gen, device=dev)
    s_args = (ag.row_ptr, ag.col, ag.logval, es, ed, SLOPE)
    got, want = att.stats_logits(*s_args, split=sp), att.stats_logits_plain(*s_args)
    if not all(map(torch.equal, got, att.stats_logits(*s_args, split=sp))):
        raise AssertionError("two stats_logits launches differ")
    err = max(compare(a, b, ATT_TOL)[0] for a, b in zip(got, want))
    ms, dev_ms = both_ms(lambda: att.stats_logits(*s_args, split=sp))
    ms_nt, dev_nt = both_ms(lambda: att.stats_logits(*s_args))
    plain_ms = cuda_ms(lambda: att.stats_logits_plain(*s_args))
    records["attn_stats"] = [(err, ms, dev_ms, plain_ms)]
    logits, mx, sm = want
    got6 = att.softmax_stats(ag.row_ptr, logits, split=sp)
    if not all(map(torch.equal, got6, att.softmax_stats(ag.row_ptr, logits, split=sp))):
        raise AssertionError("two softmax_stats launches differ")
    err6 = max(compare(a, b, ATT_TOL)[0] for a, b in zip(got6, (mx, sm)))
    ms6, dev6 = both_ms(lambda: att.softmax_stats(ag.row_ptr, logits, split=sp))
    ms6_nt, dev6_nt = both_ms(lambda: att.softmax_stats(ag.row_ptr, logits))
    plain6 = cuda_ms(lambda: att.softmax_stats_plain(ag.row_ptr, logits))
    records["softmax_stats"] = [(err6, ms6, dev6, plain6)]
    del got6
    e, n_rows = ag.n_edges, ag.n_nodes
    # B5 per edge: gather-add, leaky relu (compare, multiply), add log(val),
    # subtract the max, exp, add: ~7 f32 operations, and one max; it writes
    # the logits and two statistics per row. B6 reads the logits instead.
    yard["attn_stats"] = (*bound(
        nbytes(ag.row_ptr, ag.col, ag.logval, es, ed) + 4 * e + 8 * n_rows, 8 * e, PEAK_F32,
    ), None, None)
    yard["softmax_stats"] = (*bound(
        nbytes(ag.row_ptr, logits) + 8 * n_rows, 4 * e, PEAK_F32,
    ), None, None)
    log("B5/B6 attn_stats", f"forward CSR split at S = {SEGMENT_EDGES}; logits+stats "
        f"(B5): max abs err {err:.3e}, two launches bit-equal, kernel {ms:.4f} ms a "
        f"call ({dev_ms:.4f} device; without the table {ms_nt:.4f} ({dev_nt:.4f})), "
        f"plain {plain_ms:.4f} ms, bound {yard['attn_stats'][0]:.4f} ms by "
        f"{yard['attn_stats'][1]}; stats of given logits (B6, softmax_stats): max "
        f"abs err {err6:.3e}, two launches bit-equal, kernel {ms6:.4f} ms a call "
        f"({dev6:.4f} device; without the table {ms6_nt:.4f} ({dev6_nt:.4f})), plain "
        f"{plain6:.4f} ms, bound {yard['softmax_stats'][0]:.4f} ms by "
        f"{yard['softmax_stats'][1]}; no one PyTorch call computes either; tol "
        f"{ATT_TOL}*(1+|ref|) (same f32 logits, exp-sums in another order)")
    # the backward's softmax weights, moved to the transpose CSR (dx's val)
    w_t = att.edge_weights(ag, logits, mx, sm).index_select(0, ag.perm_t)
    for f in (200, 8):
        x16 = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
        g16 = torch.randn((n, f), generator=gen, device=dev).to(torch.bfloat16)
        a_args = (ag.row_ptr, ag.col, logits, mx, sm, x16)
        agg = att.attn_agg(*a_args, split=sp)
        if not torch.equal(agg, att.attn_agg(*a_args, split=sp)):
            raise AssertionError(f"two attn_agg launches differ at F={f}")
        err, _ = compare(agg, att.attn_agg_plain(*a_args), ATT_TOL)
        del agg
        ms, dev_ms = both_ms(lambda: att.attn_agg(*a_args, split=sp))
        plain_ms = cuda_ms(lambda: att.attn_agg_plain(*a_args))
        records.setdefault("attn_agg", []).append((err, ms, dev_ms, plain_ms))
        if f == 200:
            yard["attn_agg"] = (*bound(
                nbytes(ag.row_ptr, ag.col, logits, mx, sm) + rows_read(ag.col, f, 2)
                + 4 * n * f, (2 * f + 3) * ag.n_edges, PEAK_F32,
            ), None, None)
        d_args = (ag.row_ptr, ag.col, g16, x16, ag.row)
        u1 = att.sddmm(*d_args)
        if not torch.equal(u1, att.sddmm(*d_args)):
            raise AssertionError(f"two sddmm launches differ at F={f}")
        err_d, _ = compare(u1, att.sddmm_plain(*d_args), ATT_TOL)
        ms_d, dev_d = both_ms(lambda: att.sddmm(*d_args))
        plain_d = cuda_ms(lambda: att.sddmm_plain(*d_args))
        records.setdefault("sddmm", []).append((err_d, ms_d, dev_d, plain_d))
        lib_d = ""
        if f == 200:
            pattern = csr(ag.row_ptr, ag.col, torch.zeros(ag.n_edges, device=dev), (n, n))
            gf, xt = g16.float(), x16.float().t().contiguous()
            libs = both_ms(lambda: torch.sparse.sampled_addmm(pattern, gf, xt, beta=0.0))
            yard["sddmm"] = (*bound(
                nbytes(ag.row_ptr, ag.col) + rows_read(ag.row, f, 2) + rows_read(ag.col, f, 2)
                + 4 * ag.n_edges, 2 * f * ag.n_edges, PEAK_F32,
            ), *libs)
            lib_d = (f", torch.sparse.sampled_addmm {libs[0]:.4f} ms a call "
                     f"({libs[1]:.4f} device)")
            del pattern, gf, xt
        log("B7/B8 attn_agg, sddmm", f"F={f}: attn_agg max abs err {err:.3e}, "
            f"two launches bit-equal, kernel {ms:.4f} ms a call ({dev_ms:.4f} device), "
            f"plain {plain_ms:.4f} ms; sddmm max abs err {err_d:.3e}, two launches bit-equal, kernel "
            f"{ms_d:.4f} ms a call ({dev_d:.4f} device), plain {plain_d:.4f} ms"
            f"{lib_d}; tol {ATT_TOL}*(1+|ref|) (f32 weights, exact bf16 "
            f"products, f32 sums in another order)")
        # K2 in B3's role: dx = (weighted A)ᵀ @ g over the transpose CSR
        k_args = (ag.row_ptr_t, ag.col_t, w_t, g16)
        dx = row_reduce(*k_args, split=sp_t)
        if not torch.equal(dx, row_reduce(*k_args, split=sp_t)):
            raise AssertionError(f"two launches of K2 as dx differ at F={f}")
        err_k, _ = compare(dx, row_reduce_plain(*k_args), ATT_TOL)
        ms_k, dev_k = both_ms(lambda: row_reduce(*k_args, split=sp_t))
        plain_k = cuda_ms(lambda: row_reduce_plain(*k_args))
        records.setdefault("row_reduce_dx", []).append((err_k, ms_k, dev_k, plain_k))
        yard_k = k2_yardsticks(*k_args)
        if f == 200:
            yard["row_reduce_dx"] = yard_k
        del dx, u1
        log("K2 row_reduce as dx", f"F={f}, transpose CSR with the softmax "
            f"weights, S = {SEGMENT_EDGES}: max abs err {err_k:.3e}, two launches "
            f"bit-equal, kernel {ms_k:.4f} ms a call ({dev_k:.4f} device), plain "
            f"{plain_k:.4f} ms, bound {yard_k[0]:.4f} ms by {yard_k[1]}, "
            f"torch.sparse.mm {yard_k[2]:.4f} ms a call ({yard_k[3]:.4f} device); "
            f"tol {ATT_TOL}*(1+|ref|) (f32 sums in another order)")
    v = torch.randn(ag.n_edges, generator=gen, device=dev)
    v_t = v.index_select(0, ag.perm_t)
    for ptr, vals, split, csr_name in (
        (ag.row_ptr, v, sp, "forward"), (ag.row_ptr_t, v_t, sp_t, "transpose"),
    ):
        rs = att.rowsum(ptr, vals, split=split)
        if not torch.equal(rs, att.rowsum(ptr, vals, split=split)):
            raise AssertionError(f"two rowsum launches differ on the {csr_name} CSR")
        err, _ = compare(rs, att.rowsum_plain(ptr, vals), ATT_TOL)
        ms, dev_ms = both_ms(lambda: att.rowsum(ptr, vals, split=split))
        ms_nt, dev_nt = both_ms(lambda: att.rowsum(ptr, vals))
        plain_ms = cuda_ms(lambda: att.rowsum_plain(ptr, vals))
        records.setdefault("rowsum", []).append((err, ms, dev_ms, plain_ms))
        if csr_name == "forward":
            lengths = torch.diff(ptr.long())
            lib = cuda_ms(lambda: torch.segment_reduce(vals, "sum", lengths=lengths))
            yard["rowsum"] = (*bound(nbytes(ptr, vals) + 4 * n, ag.n_edges, PEAK_F32), lib, None)
        log("B9 rowsum", f"{csr_name} CSR with its split table "
            f"({0 if split is None else split.n_seg} segments): max abs err {err:.3e}, "
            f"two launches bit-equal, kernel {ms:.4f} ms a call ({dev_ms:.4f} device; "
            f"without the table {ms_nt:.4f} ({dev_nt:.4f})), plain {plain_ms:.4f} ms; "
            f"tol {ATT_TOL}*(1+|ref|) (f32 sums in another order)")
        del rs
    del x16, g16, v, v_t, w_t, logits, mx, sm, got, want

    # 7b. K2 from zero over the whole graph as one CSR (--spmm onehot)
    onehot_phase(pre.graph, gen_formats, records)

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
    del seg, p, cot, res

    # 8b. the attention_spmm path (B6), fwd+bwd, its launches counted
    spmm_launches = attention_spmm_path(att, ag, gen, counters)
    # 8c. the learnable-edge ops (rowsum, K2 from zero, sddmm) and the
    # learnable-edge GCN
    # (a generator of their own: the later phases' inputs stay as they were)
    edge_launches = edge_ops_phase(
        att, ag, torch.Generator(device=dev).manual_seed(SEED + 2), records, counters)
    edge_gcn_phase(pre.graph, pre.labels, dev)
    r8_graph, r8_labels, r8_pre = pre.graph, pre.labels, pre
    del ag, pre, pre_att

    # 9. the GAT main path, through the CLI
    gat_launches, _ = train_via_cli(
        cli, "gat", ["--model", "gat", "--spmm", "hybrid"], GAT_ACC_MIN,
        counters, need=("row_reduce", "attn_stats", "attn_agg", "sddmm", "rowsum"),
    )

    # 9b. auto: every eligible format's pass on three graphs against the
    # cost model's pick, GAT's dense peak; then the GCN trained on auto,
    # bsr and onehot, the GAT on auto, and the checkpoints
    graphs = auto_graphs(dev, r8_graph)
    picks = auto_phase(dev, gen_formats, graphs, mm_probe)
    gat_picks = gat_peak_phase(dev, gen_formats, graphs)
    del graphs
    with tempfile.TemporaryDirectory() as tmp:
        new_paths = formats_training_phase(cli, counters, tmp, picks, gat_picks)
        new_paths += checkpoint_phase(cli, counters, tmp)

    # 10-15. the streamed slice at the baseline scale config, every family
    stream_launches, mesh_p1_launches = stream_phases(dev, gen, records, yard, r8_graph,
                                                     r8_labels)

    # 16-21. the topic slice: its data, the E-step, and every family trained
    with tempfile.TemporaryDirectory() as tmp:
        roots = topic_roots(tmp)
        residual = topic_data_phase(dev, gen, records, yard, roots["fresh"], gen_formats)
        lda_phase(dev, roots)
        topic_hybrid, topic_gat, topic_formats, seg = topic_training_phases(
            cli, counters, roots["fresh"], residual)
        segment_determinism_phase(cli, counters, roots["fresh"])
        new_paths += topic_formats
        topic_pre = prepare_topic_data("R8", data_root=roots["fresh"], device=dev)
        topic_gat_report_phase(topic_pre, dev)
        # every family sharded (GAT on its three layouts) on SHARDS gloo
        # ranks, and the sharded GAT through the CLI
        sharded_runs = sharded_trainings_phase(r8_pre, topic_pre, seg)
        sharded_cli = sharded_cli_phase(cli, counters, roots["fresh"], seg)
        sharded_checkpoint_cli_phase(cli, counters, roots["fresh"], tmp)
    del r8_pre

    # 22-27. the build slice: R8's topic graph built on the card, trained,
    # the YAML experiment, mr's doc-word graph, and the checkout untouched
    with tempfile.TemporaryDirectory() as tmp:
        built = corpus_root(tmp, "built", "R8")
        build_phase(dev, built)
        determinism_phase(dev, built)
        built_hybrid = train_built_phase(cli, counters, dev, built)
        experiment_phase(cli, tmp)
        experiment_phase(cli, tmp, "r8_docword.yaml")
        docword_phase(cli, tmp)
    checkout_phase(untouched)

    sources = {
        "bsr_spmm": ("textgcn_tpu_torch/csrc/bsr_spmm.cu",
                     "textgcn_tpu/ops/pallas_spmm.py:143"),
        "bsr_spmm_f32": ("textgcn_tpu_torch/csrc/bsr_spmm_f32.cu",
                         "textgcn_tpu/ops/pallas_spmm.py:245"),
        "row_reduce": ("textgcn_tpu_torch/csrc/row_reduce.cu",
                       "textgcn_tpu/ops/pallas_onehot.py:232"),
        "row_reduce_dx": ("textgcn_tpu_torch/csrc/row_reduce.cu",
                          "textgcn_tpu/ops/pallas_onehot.py:214"),
        "attn_stats": ("textgcn_tpu_torch/csrc/attn_stats.cu",
                       "textgcn_tpu/ops/pallas_attention.py:94"),
        "softmax_stats": ("textgcn_tpu_torch/csrc/attn_stats.cu",
                          "textgcn_tpu/ops/pallas_attention.py:64"),
        "attn_agg": ("textgcn_tpu_torch/csrc/attn_agg.cu",
                     "textgcn_tpu/ops/pallas_attention.py:160"),
        "sddmm": ("textgcn_tpu_torch/csrc/sddmm.cu",
                  "textgcn_tpu/ops/pallas_attention.py:185"),
        "rowsum": ("textgcn_tpu_torch/csrc/rowsum.cu",
                   "textgcn_tpu/ops/pallas_attention.py:140"),
        "sorted_chunk_add": ("textgcn_tpu_torch/csrc/row_reduce.cu",
                             "textgcn_tpu/ops/streamed_sorted.py:81"),
        "bsr_leg": ("textgcn_tpu_torch/csrc/bsr_spmm.cu",
                    "textgcn_tpu/parallel/mesh_kernels.py:641"),
    }
    paths = (launches, gat_launches, spmm_launches, shard1, shard4, topic_hybrid, topic_gat,
             built_hybrid)
    total = {k: sum(p[k] for p in paths) for k in launches}
    # K2's one counter: the attention paths' launches are dx (B3), the
    # others B2
    total["row_reduce_dx"] = sum(p["row_reduce"] for p in (gat_launches, spmm_launches, topic_gat))
    total["row_reduce"] -= total["row_reduce_dx"]
    # the runs of this slice's formats: K2 from zero (onehot) is B3's role
    for p, k2 in new_paths:
        for k in launches:
            total[k2 if k == "row_reduce" else k] += p[k]
    # B11: the streamed steps on one card, and route B.4 (the P = 1 ring's
    # pass and steps, rank 0's sharded streamed GCN on R8 doc-word)
    total["sorted_chunk_add"] = stream_launches + mesh_p1_launches + mesh_ranks_launches
    # the sharded checkpoint runs on rank 0, and the launcher-started rank 0:
    # B10 and the residual's K2 (B2)
    for k, v in (*ckpt_launches.items(), *launcher_launches.items()):
        total[k] += v
    # this slice's routes: the edge ops (K2 from zero is B3's role) and rank
    # 0 of the sharded trainings (all-gather from zero B3, halo buckets onto
    # the accumulator B2)
    for k in ("rowsum", "sddmm"):
        total[k] += edge_launches[k]
    total["row_reduce_dx"] += edge_launches["row_reduce"] + halo_k2["row_reduce_dx"]
    total["row_reduce"] += halo_k2["row_reduce"]
    # route B.3 and the sharded families: rank 0 of each sharded training
    # (K2 is dx (B3) under GAT and from zero (B3) on allgather-onehot, onto
    # the accumulator (B2) on the halo buckets and the hybrid's residual)
    # and the sharded CLI GAT
    for (_, model, kernel, partition), run_launches in sharded_runs.items():
        for k, v in run_launches.items():
            b3 = k == "row_reduce" and (model == "gat" or (kernel, partition) == ("onehot", "allgather"))
            total["row_reduce_dx" if b3 else k] += v
    for k, v in sharded_cli.items():
        total["row_reduce_dx" if k == "row_reduce" else k] += v
    kernels = []
    for name, (src, replaces) in sources.items():
        _, ms, device_ms, plain_ms = next(r for r in records[name] if r[1] is not None)
        bound_ms, bound_by, library_ms, library_device_ms = yard[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": total[name],
            "max_abs_err": max(r[0] for r in records[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "device_ms": device_ms,
            "library_device_ms": library_device_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
