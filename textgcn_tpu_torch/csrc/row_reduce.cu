// K2: row-sorted sparse edges reduced onto output rows, for Hopper (sm_90a).
//
//   out[r, :] = base[r, :] + sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} val[e] * x[col[e], :]
//
// Replaces the Pallas kernels textgcn_tpu/ops/pallas_onehot.py
// `_onehot_kernel_base` (windows start from a base) and `_onehot_kernel`
// (from zero). The Python wrapper, the split table and the plain PyTorch
// version are in textgcn_tpu_torch/ops/row_reduce.py.
//
// `out` [>= n_rows, f] f32 is updated IN PLACE when `has_base` (on the hybrid
// path it holds the tile leg's result, so the two legs' sum never makes a
// separate pass over device memory: the fused add of `_onehot_kernel_base`);
// rows without edges are then left untouched. Without a base every row of
// `out` is written, empty rows with zeros. `x` is [*, f] bf16, f even.
//
// Bound on the card: the gathers of x rows, 2*f bytes per edge. At R8's
// sizes x (6 MB) sits in L2, so the rate of L2 gathers bounds the pass; at
// the streamed sizes (x 320 MB) the random 32-byte reads from HBM do.
//
// The hub rows. The TPU kernel walked fixed chunks of k edge slots per grid
// step, so its cost followed the edge count. Here no warp walks more than
// S = kSegEdges edges (512: the best of 128-1024 on the H100 at R8's sizes,
// PERF.md; scripts/sweep_kernels.py rebuilds the kernel at other S with
// -DTEXTGCN_K2_S): a row longer than S is cut into row-local segments
// (boundaries at multiples of S from the row's first edge), listed in a
// split table that the wrapper's caller builds once with the CSR. Pass 1
// gives each segment a warp that writes an f32 partial row, and each row of
// at most S edges a warp that reads base, adds its sum and writes once.
// Pass 2 (a second small launch, only when there are long rows; the code is
// `row_split.cuh`, shared with attn_agg and K1) adds each long row's
// partials onto its base in segment order. A
// second launch was chosen over one block per long row because a hub of R8
// (9,589 edges) has more segments than a block has warps at any S worth
// having, and over a last-warp-done counter because it needs no counters to
// reset between launches. The sums use no atomics and a fixed order, so two
// launches give the same bits, and a row gives the same bits in any CSR that
// holds it. Without a table every row takes the direct path, whatever its
// length (right, not balanced).
//
// One walk over the edges for f <= 256: each lane keeps its columns in f32
// registers and reads x as one vector of V bf16 values: 16 bytes (V = 8)
// where f % 8 == 0, f > kNarrowF and x and out are 16-byte aligned, else 4
// (V = 2; at f = 8 and 16 the narrower loads put more lanes on an edge and
// leave fewer lane groups to sum, which was faster on the H100). `lanes`
// lanes (a power of two covering f/V vectors) share an edge, so narrow rows
// give a warp's 32/lanes lane groups different edges, and the groups are
// summed with shuffles in a fixed order. Each lane keeps kUnroll gathers in
// flight. Wider rows walk in column tiles of 32*V columns.
//
// A run of chunks (`textgcn_row_reduce_run`). The streamed pass reduces
// each row-sorted chunk onto its own row range of one accumulator, and a
// chunk's call costs the host more than K2 takes on the card. The chunks
// that a cache keeps on the card take one launch a run instead, over a
// device table of the chunks' CSRs, first output rows, row counts and tile
// counts summed before them. Only chunks without a split table and with
// disjoint row ranges form a run (one launch has no order between two
// warps on the same row); the wrapper checks both when it builds the table.
//
// Its bound at the streamed shapes (the benchmark's graph: 610 chunks of
// 16,384 rows, ~50 edges a row, F = 8 or 16) is the CSR, streamed from
// device memory at 8 bytes an edge (4.04 GB a pass), and the gathers of x,
// one 32-byte sector an edge at f <= 16: a chunk gathers from its partner block's
// 16,384 rows only (256-512 KB), which stay in L2, so they cost L2's
// sector rate and not device memory. A warp a row (the per-chunk design)
// does not reach either: each row waits on a chain of dependent trips (its
// chunk, row_ptr, col and val, then the gathers, then the base), and
// nothing fetches the next row's CSR meanwhile. So the run kernel is its
// own design:
// - Work unit: a tile of kTileRows consecutive rows of one chunk (and a
//   column tile of x, for f past 256). Persistent blocks, one an SM, claim
//   the units in order from a counter in the run's table, so all blocks
//   work on neighbouring tiles and their gathers share the L2. A tile's
//   chunk is found once, by binary search over the chunks' tile prefix.
// - The CSR staged by TMA: a producer warp keeps the next tiles' row_ptr,
//   col and val in flight with bulk asynchronous copies (`cp.async.bulk`,
//   completion on an mbarrier) into a ring of kStages stages of shared
//   memory, each window rounded out to 16 bytes. A tile of more than
//   kStageEdges edges comes in pieces, a stage each; the sums of a row that
//   crosses a piece stay in registers, so a row of any length works.
// - kConsumers warps gather from shared indices: a lane reads its edges'
//   col and val from shared memory (no shuffles) and keeps kRunUnroll
//   gathers of x in flight, 16 bytes each where f % 8 == 0 and the
//   pointers allow (at f = 8 a lane reads a whole row of x). The base row
//   is read and the sum written once, when the row is done.
// - The bits of the per-chunk call: a row's sum is split into the chains
//   of that call's lane groups, each an fmaf chain in edge order, added by
//   the same butterfly, then onto the base (RunLayout). Only which lane
//   holds which chain differs, so a run gives each row the bits of its
//   chunk's own call, and a pass that mixes the two gives equal bits.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "row_split.cuh"  // S (TEXTGCN_K2_S), split_item and pass 2

#ifndef TEXTGCN_K2_NARROW_F
#define TEXTGCN_K2_NARROW_F 16
#endif

namespace {

constexpr int kNarrowF = TEXTGCN_K2_NARROW_F;  // widest f read in 4-byte loads
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // gathers a lane keeps in flight

template <int V>
struct Vec;  // V bf16 values read by one lane load
template <>
struct Vec<8> {
  using T = uint4;
};
template <>
struct Vec<2> {
  using T = unsigned;
};

// acc += w * (the bf16 values of q); bf16 -> f32 is a 16-bit shift.
__device__ __forceinline__ void fma_vec(float (&acc)[8], float w, uint4 q) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void fma_vec(float (&acc)[2], float w, unsigned q) {
  acc[0] = fmaf(w, __uint_as_float(q << 16), acc[0]);
  acc[1] = fmaf(w, __uint_as_float(q & 0xffff0000u), acc[1]);
}

__device__ __forceinline__ void store(float* o, const float (&a)[8]) {
  reinterpret_cast<float4*>(o)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(o)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

__device__ __forceinline__ void store(float* o, const float (&a)[2]) {
  *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
}

__device__ __forceinline__ void load(float (&a)[8], const float* o) {
  const float4 p = reinterpret_cast<const float4*>(o)[0];
  const float4 q = reinterpret_cast<const float4*>(o)[1];
  a[0] = p.x; a[1] = p.y; a[2] = p.z; a[3] = p.w;
  a[4] = q.x; a[5] = q.y; a[6] = q.z; a[7] = q.w;
}

__device__ __forceinline__ void load(float (&a)[2], const float* o) {
  const float2 p = *reinterpret_cast<const float2*>(o);
  a[0] = p.x; a[1] = p.y;
}

// The lane's share of sum_{e in [e0, e1)} val[e] * x[col[e], columns of
// vector v], for the lane group `grp` of `n_grp` (edges t = grp, grp + n_grp,
// ... of each batch of 32). The order depends only on e - e0. Every lane of
// the warp calls it with the same e0, e1 (the shuffles are convergent).
template <int V>
__device__ __forceinline__ void walk(const int* __restrict__ col,
                                     const float* __restrict__ val,
                                     const typename Vec<V>::T* __restrict__ x,
                                     int nv, int v, bool active, int e0, int e1,
                                     int lane, int grp, int n_grp, float (&acc)[V]) {
  using T = typename Vec<V>::T;
  for (int base = e0; base < e1; base += 32) {
    const int n_in = min(32, e1 - base);
    int c_l = 0;
    float w_l = 0.f;
    if (lane < n_in) {
      c_l = col[base + lane];
      w_l = val[base + lane];
    }
    const int steps = (n_in + n_grp - 1) / n_grp;  // the same for every lane
    for (int k = 0; k < steps; k += kUnroll) {
      T q[kUnroll];
      float w[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = (k + u) * n_grp + grp;
        const int c = __shfl_sync(kFull, c_l, t & 31);
        w[u] = __shfl_sync(kFull, w_l, t & 31);
        ok[u] = active && t < n_in;
        if (ok[u]) q[u] = x[(size_t)c * nv + v];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (ok[u]) fma_vec(acc, w[u], q[u]);
    }
  }
}

// Sum the lane groups (lanes with the same `sub` hold the same columns for
// other edges) with a butterfly: every lane ends with the same bits.
template <int V>
__device__ __forceinline__ void sum_groups(float (&acc)[V], int lanes) {
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
}

// One warp's output row: dst = base + the row's sum over edges [e0, e1)
// when `add_base` (dst holds the base), else the sum alone; lane group 0
// stores. The order of every sum depends only on the edges, so a row gets
// the same bits from either kernel below.
template <int V>
__device__ __forceinline__ void reduce_row(const int* __restrict__ col,
                                           const float* __restrict__ val,
                                           const typename Vec<V>::T* __restrict__ x,
                                           float* __restrict__ dst, int e0, int e1,
                                           int f, bool add_base, int lanes) {
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;
  const int grp = lane / lanes;
  const int n_grp = 32 / lanes;
  const int nv = f / V;
  for (int v0 = 0; v0 < nv; v0 += lanes) {
    const int v = v0 + sub;
    const bool active = v < nv;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    walk<V>(col, val, x, nv, v, active, e0, e1, lane, grp, n_grp, acc);
    sum_groups<V>(acc, lanes);
    if (grp == 0 && active) {
      float* o = dst + (size_t)v * V;
      if (add_base) {
        float b[V];
        load(b, o);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = b[i] + acc[i];
      }
      store(o, acc);
    }
  }
}

// Pass 1. Warps [0, n_seg) take the split table's segments and write their
// partial rows; warps [n_seg, n_seg + n_rows) take the rows, and with a
// table a row of more than S edges is left to its segments.
template <int V>
__global__ void __launch_bounds__(kThreads)
row_reduce_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const float* __restrict__ val,
                  const typename Vec<V>::T* __restrict__ x,
                  float* __restrict__ out,
                  const int* __restrict__ seg_row,
                  const int* __restrict__ seg_e0,
                  float* __restrict__ partial,
                  int n_rows, int n_seg, int f, int has_base, int lanes) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= n_seg + n_rows) return;
  const bool seg = w < n_seg;
  int row, e0, e1;
  if (!split_item(w, n_seg, kSegEdges, row_ptr, seg_row, seg_e0, row, e0, e1)) return;
  if (!seg && e0 == e1 && has_base) return;  // nothing to add
  float* dst = seg ? partial + (size_t)w * f : out + (size_t)row * f;
  reduce_row<V>(col, val, x, dst, e0, e1, f, !seg && has_base, lanes);
}

// A chunk of a run: a row-sorted CSR whose row i is output row r0 + i
// (textgcn_tpu_torch/ops/row_reduce.py `ReduceRun`, one int64 row each).
struct RunChunk {
  const int* row_ptr;
  const int* col;
  const float* val;
  long long r0;
};

// The run kernel's shape (the best of the sweeps that PERF.md records, on
// an H100). A tile is kTileRows consecutive rows of one chunk
// (ops/row_reduce.py RUN_TILE_ROWS): at f <= 16 a row group for each
// consumer warp. A stage
// of the ring holds one piece of a tile: its row_ptr and at most
// kStageEdges of its edges (a tile of the benchmark's graph has ~3,200).
// One block an SM: its 100 KB of stages leave the rest of the SM's 228 KB
// to L1, and a second block (or fewer, wider blocks) was slower.
constexpr int kTileRows = 64;
constexpr int kStageEdges = 4096;
constexpr int kStages = 3;
constexpr int kConsumers = 16;  // consumer warps; one producer warp more
constexpr int kRunThreads = 32 * (kConsumers + 1);
constexpr int kClaim = 4;       // units a block claims at once
constexpr int kRunUnroll = 8;   // gathers a lane keeps in flight
// A stage: its head, then row_ptr, col and val windows, each rounded out to
// 16 bytes at both ends (so 3 spare entries either side).
constexpr int kHeadBytes = 64;
constexpr int kRpBytes = ((kTileRows + 1 + 6) * 4 + 15) / 16 * 16;
constexpr int kEdgeBytes = ((kStageEdges + 6) * 4 + 15) / 16 * 16;
constexpr int kStageBytes = kHeadBytes + kRpBytes + 2 * kEdgeBytes;
constexpr int kRunSmem = kStages * kStageBytes + 2 * kStages * 8;

// What the producer tells the consumers of a stage.
struct StageHead {
  long long out_row;  // output row of the tile's row 0
  int n;              // rows of the tile
  int pa, pb;         // the piece: edges [pa, pb) of the chunk
  int rp_at, col_at, val_at;  // the windows' first wanted entry in the stage
  int ct;             // column tile
  int last;           // the tile's last piece
  int end;            // no more units for this block
};
static_assert(sizeof(StageHead) <= kHeadBytes, "stage head");

// The lanes' roles, chosen from f on the host. A row's sum is split into
// n_grp chains, the per-chunk call's lane groups (32 / lanes_for(f / V) for
// that call's V): chain c sums edges e0 + c, e0 + c + n_grp, ... with fmaf
// in edge order, and the chains are added by the same xor butterfly (low
// chain bit first), so a row gets that call's bits. Lane l of a row's
// n_grp * lanes_v lanes takes chain l / lanes_v and vector l % lanes_v of a
// column tile of lanes_v vectors of W values (so 8 neighbouring lanes read
// 128 contiguous bytes of a wide row); a warp takes 32 / (n_grp *
// lanes_v) rows at once. At f = 8 and 16 (W = 8, where the per-chunk call
// reads V = 2) a lane gathers 16 bytes and a warp takes 4 rows; elsewhere W
// is the per-chunk call's V and a warp takes a row, as there.
struct RunLayout {
  int n_grp, lanes_v, ncv, n_ct;  // ncv: vectors of W a row; n_ct column tiles
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

// arrive, and expect `bytes` of bulk copies to complete the phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(bytes)
               : "memory");
}

// until the barrier's phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(phase)
      : "memory");
}

// a bulk copy (TMA) of `bytes` from global to shared memory, both 16-byte
// aligned, completing on the barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the 16-byte-aligned window around [lo, hi) bytes: its start and length
__device__ __forceinline__ unsigned window(uintptr_t lo, uintptr_t hi, uintptr_t& start) {
  start = lo & ~uintptr_t(15);
  return static_cast<unsigned>(((hi + 15) & ~uintptr_t(15)) - start);
}

// The producer warp. It claims units (tile u / n_ct, column tile u % n_ct)
// kClaim at a time from the run's counter (sched[0]), so the blocks take
// the units in order and work on neighbouring tiles at any time, whose
// gathers share the L2 (a static stride lets the blocks drift apart, and at
// wide f their partners' rows then no longer fit in L2). Lane i looks up
// unit i of a claim (binary search for the chunk over the tile prefix tp,
// then row_ptr at the tile's ends); lane 0 then cuts each tile into pieces
// of at most kStageEdges edges, and for each waits for a stage to be free,
// writes its head and starts its copies. A head with `end` set closes the
// block's stream.
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const RunChunk* __restrict__ chunks,
                                        const long long* __restrict__ w0,
                                        const long long* __restrict__ tp,
                                        unsigned* __restrict__ sched, int n_chunks,
                                        long long n_units, int n_ct) {
  const int lane = threadIdx.x % 32;
  int stage = 0;
  unsigned phase = 0;
  unsigned next = 0;  // the next claim, in flight while the last one's stages go out
  if (lane == 0) next = atomicAdd(&sched[0], 1u);
  for (bool more = true; more;) {
    const long long ub = (long long)__shfl_sync(kFull, next, 0) * kClaim, u = ub + lane;
    more = ub + kClaim < n_units;
    if (more && lane == 0) next = atomicAdd(&sched[0], 1u);
    unsigned long long rp = 0, col = 0, val = 0;
    long long out_row = 0;
    int n = 0, ea = 0, eb = 0, ct = 0;
    if (lane < kClaim && u < n_units) {
      const long long t = u / n_ct;
      ct = static_cast<int>(u - t * n_ct);
      int lo = 0, hi = n_chunks;  // tp[lo] <= t < tp[lo + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (tp[mid] <= t) lo = mid;
        else hi = mid;
      }
      const RunChunk c = chunks[lo];
      const long long i0 = (t - tp[lo]) * kTileRows;
      n = static_cast<int>(min((long long)kTileRows, w0[lo + 1] - w0[lo] - i0));
      rp = reinterpret_cast<unsigned long long>(c.row_ptr + i0);
      col = reinterpret_cast<unsigned long long>(c.col);
      val = reinterpret_cast<unsigned long long>(c.val);
      out_row = c.r0 + i0;
      ea = c.row_ptr[i0];
      eb = c.row_ptr[i0 + n];
    }
    const int m = static_cast<int>(max(0LL, min((long long)kClaim, n_units - ub)));
    for (int i = 0; i < m; ++i) {
      const int* rp_i = reinterpret_cast<const int*>(__shfl_sync(kFull, rp, i));
      const int* col_i = reinterpret_cast<const int*>(__shfl_sync(kFull, col, i));
      const float* val_i = reinterpret_cast<const float*>(__shfl_sync(kFull, val, i));
      const long long row_i = __shfl_sync(kFull, out_row, i);
      const int n_i = __shfl_sync(kFull, n, i), ct_i = __shfl_sync(kFull, ct, i);
      const int ea_i = __shfl_sync(kFull, ea, i), eb_i = __shfl_sync(kFull, eb, i);
      for (int pa = ea_i;;) {
        const int pb = eb_i - pa > kStageEdges ? pa + kStageEdges : eb_i;
        if (lane == 0) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + (size_t)stage * kStageBytes;
          uintptr_t r_at, c_at = 0, v_at = 0;
          const uintptr_t r_lo = reinterpret_cast<uintptr_t>(rp_i);
          const unsigned r_len = window(r_lo, r_lo + 4 * (n_i + 1), r_at);
          unsigned c_len = 0, v_len = 0;
          if (pb > pa) {
            c_len = window(reinterpret_cast<uintptr_t>(col_i + pa),
                           reinterpret_cast<uintptr_t>(col_i + pb), c_at);
            v_len = window(reinterpret_cast<uintptr_t>(val_i + pa),
                           reinterpret_cast<uintptr_t>(val_i + pb), v_at);
          }
          StageHead* h = reinterpret_cast<StageHead*>(st);
          h->out_row = row_i;
          h->n = n_i;
          h->pa = pa;
          h->pb = pb;
          h->rp_at = static_cast<int>((r_lo - r_at) / 4);
          h->col_at = c_len ? static_cast<int>((reinterpret_cast<uintptr_t>(col_i + pa) - c_at) / 4) : 0;
          h->val_at = c_len ? static_cast<int>((reinterpret_cast<uintptr_t>(val_i + pa) - v_at) / 4) : 0;
          h->ct = ct_i;
          h->last = pb == eb_i;
          h->end = 0;
          mbar_arrive_tx(&full[stage], r_len + c_len + v_len);
          unsigned char* d = st + kHeadBytes;
          bulk_load(d, reinterpret_cast<const void*>(r_at), r_len, &full[stage]);
          if (c_len) {
            bulk_load(d + kRpBytes, reinterpret_cast<const void*>(c_at), c_len, &full[stage]);
            bulk_load(d + kRpBytes + kEdgeBytes, reinterpret_cast<const void*>(v_at), v_len,
                      &full[stage]);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
        if (pb == eb_i) break;
        pa = pb;
      }
    }
  }
  if (lane == 0) {
    mbar_wait(&empty[stage], phase ^ 1);
    reinterpret_cast<StageHead*>(smem + (size_t)stage * kStageBytes)->end = 1;
    mbar_arrive(&full[stage]);
  }
}

// acc += the products of chain edges e, e + step, ... below hi, in edge
// order, kRunUnroll gathers of x in flight at a time; col and val come
// from the stage (cs[e], vs[e]).
template <int W>
__device__ __forceinline__ void walk_chain(const int* cs, const float* vs,
                                           const typename Vec<W>::T* __restrict__ x, int ncv,
                                           int v, int e, int hi, int step, float (&acc)[W]) {
  for (; e < hi; e += kRunUnroll * step) {
    typename Vec<W>::T q[kRunUnroll];
    float w[kRunUnroll];
#pragma unroll
    for (int k = 0; k < kRunUnroll; ++k) {
      const int ek = e + k * step;
      if (ek < hi) {
        w[k] = vs[ek];
        q[k] = x[(size_t)cs[ek] * ncv + v];
      }
    }
#pragma unroll
    for (int k = 0; k < kRunUnroll; ++k)
      if (e + k * step < hi) fma_vec(acc, w[k], q[k]);
  }
}

// Pass 1 over a run of chunks with disjoint row ranges and no split table,
// onto a base, by persistent blocks: one producer warp stages the tiles'
// CSR into a ring of shared memory with bulk copies, and kConsumers warps
// reduce it. Warp w takes the tile's row groups w, w + kConsumers, ... (a
// group is the rows one warp takes at once) in order, and keeps one group's
// sums in registers across the pieces of a tile, so a row of any length
// works; it reads the base and writes the row when the sum is done. Each
// row's sum is ordered as in the per-chunk call (RunLayout), so it gets the
// bits of that call. The last block to finish zeroes the work counter.
template <int W>
__global__ void __launch_bounds__(kRunThreads, 1)
row_reduce_kernel_run(const RunChunk* __restrict__ chunks,
                      const long long* __restrict__ w0,
                      const long long* __restrict__ tp,
                      unsigned* __restrict__ sched,
                      const typename Vec<W>::T* __restrict__ x,
                      float* __restrict__ out,
                      int n_chunks, long long n_units, int f, RunLayout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumers) {
    produce(smem, full, empty, chunks, w0, tp, sched, n_chunks, n_units, lay.n_ct);
  } else {
    const int n_grp = lay.n_grp, L = n_grp * lay.lanes_v, rpw = 32 / L;
    const int vl = lane % lay.lanes_v, c = lane % L / lay.lanes_v, g = lane / L;
    int stage = 0;
    unsigned phase = 0;
    int q = warp;  // this warp's next row group of the tile: rows [q rpw, q rpw + rpw)
    float acc[W];
#pragma unroll
    for (int i = 0; i < W; ++i) acc[i] = 0.f;
    for (;;) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + (size_t)stage * kStageBytes;
      const StageHead h = *reinterpret_cast<const StageHead*>(st);
      if (h.end) break;
      const int* rp = reinterpret_cast<const int*>(st + kHeadBytes) + h.rp_at;
      // col and val of edge e of the chunk, for e in [pa, pb)
      const int* cs = reinterpret_cast<const int*>(st + kHeadBytes + kRpBytes) + h.col_at - h.pa;
      const float* vs =
          reinterpret_cast<const float*>(st + kHeadBytes + kRpBytes + kEdgeBytes) + h.val_at - h.pa;
      const int v = h.ct * lay.lanes_v + vl;
      const int nq = (h.n + rpw - 1) / rpw;
      while (q < nq) {
        const int j0 = q * rpw;
        // the group's edges; one wholly past the piece waits for the next
        if (rp[j0] >= h.pb && !h.last) break;
        const int j = j0 + g;
        const bool ok = j < h.n && v < lay.ncv;
        const int e0 = ok ? rp[j] : 0, e1 = ok ? rp[j + 1] : 0;
        float* o = out + (size_t)(h.out_row + j) * f + (size_t)v * W;
        // chain c's edges in [max(e0, pa), min(e1, pb))
        const int lo = max(e0, h.pa), hi = min(e1, h.pb);
        int e = e0 + c;
        if (lo > e) e += (lo - e + n_grp - 1) / n_grp * n_grp;
        walk_chain<W>(cs, vs, x, lay.ncv, v, e, hi, n_grp, acc);
        if (rp[min(j0 + rpw, h.n)] > h.pb) break;  // goes on in the next piece
        for (int off = lay.lanes_v; off < L; off <<= 1) {
#pragma unroll
          for (int i = 0; i < W; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
        }
        if (c == 0 && e0 < e1) {
          float b[W];
          load(b, o);
#pragma unroll
          for (int i = 0; i < W; ++i) acc[i] = b[i] + acc[i];
          store(o, acc);
        }
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] = 0.f;
        q += kConsumers;
      }
      if (h.last) q = warp;  // the tile is done; the next stage starts another
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // the last block out resets the counter for the run's next launch
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(&sched[1], 1u) == gridDim.x - 1) {
    sched[0] = 0;
    sched[1] = 0;
  }
}

int lanes_for(int nv) {
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  return lanes;
}

// V's choice. It is the same for every chunk of a run as for the chunk's
// own call, whose `out` is 4 r0 f bytes further on: with f % 8 == 0 that
// is a multiple of 32, so both have the alignment of the accumulator.
bool wide_loads(int f, const void* x, const void* out) {
  const bool aligned16 =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  return f % 8 == 0 && f > kNarrowF && aligned16;
}

template <int V>
void launch_pass1(const void* row_ptr, const void* col, const void* val,
                  const void* x, void* out, const int* seg_row,
                  const int* seg_e0, void* partial, int n_rows, int n_seg,
                  int f, int has_base, cudaStream_t stream) {
  const int blocks = (n_seg + n_rows + kWarps - 1) / kWarps;
  row_reduce_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(val),
      static_cast<const typename Vec<V>::T*>(x), static_cast<float*>(out),
      seg_row, seg_e0, static_cast<float*>(partial), n_rows, n_seg, f,
      has_base, lanes_for(f / V));
}

// The run kernel's launch: a persistent block an SM, or fewer when there
// are fewer units.
template <int W>
int launch_run(const void* table, int n_chunks, int n_tiles, const void* x, void* out,
               int f, const RunLayout& lay, cudaStream_t stream) {
  const RunChunk* chunks = static_cast<const RunChunk*>(table);
  const long long* w0 = reinterpret_cast<const long long*>(chunks + n_chunks);
  const long long* tp = w0 + n_chunks + 1;
  unsigned* sched = reinterpret_cast<unsigned*>(const_cast<long long*>(tp + n_chunks + 1));
  int dev = 0, sms = 0;
  cudaError_t err = cudaFuncSetAttribute(row_reduce_kernel_run<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kRunSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_units = (long long)n_tiles * lay.n_ct;
  const int blocks = static_cast<int>(std::min(n_units, (long long)sms));
  row_reduce_kernel_run<W><<<blocks, kRunThreads, kRunSmem, stream>>>(
      chunks, w0, tp, sched, static_cast<const typename Vec<W>::T*>(x), static_cast<float*>(out),
      n_chunks, n_units, f, lay);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S, the most edges one warp walks: the split table must be built for it.
extern "C" int textgcn_row_reduce_segment_edges() { return kSegEdges; }

// Launches on `stream`; returns cudaGetLastError() after the launches.
// `table` is the split table: seg_row [n_seg], seg_e0 [n_seg], long_ptr
// [n_long + 1] (int32, back to back; null when n_seg == 0), `partial` an
// [n_seg, f] f32 scratch. f is even, x 4-byte and out 8-byte aligned.
extern "C" int textgcn_row_reduce(const void* row_ptr, const void* col,
                                  const void* val, const void* x, void* out,
                                  const void* table, void* partial, int n_rows,
                                  int f, int has_base, int n_seg, int n_long,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows + n_seg == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const int* seg_e0 = n_seg ? seg_row + n_seg : nullptr;
  const int* long_ptr = n_seg ? seg_row + 2 * n_seg : nullptr;
  if (wide_loads(f, x, out))
    launch_pass1<8>(row_ptr, col, val, x, out, seg_row, seg_e0, partial, n_rows,
                    n_seg, f, has_base, s);
  else
    launch_pass1<2>(row_ptr, col, val, x, out, seg_row, seg_e0, partial, n_rows,
                    n_seg, f, has_base, s);
  launch_split_sum(seg_row, long_ptr, static_cast<const float*>(partial),
                   static_cast<float*>(out), n_long, f, has_base, s);
  return static_cast<int>(cudaGetLastError());
}

// A run of chunks in one launch on `stream`, onto the base `out` [>= the
// last chunk's r0 + rows, f] f32 in place; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a table of other tiles than kTileRows rows.
// `table` is n_chunks RunChunk rows (32 bytes each: row_ptr, col and val's
// device addresses, r0), then w0 [n_chunks + 1] (the chunks' rows summed
// before them) and tp [n_chunks + 1] (their tiles of tile_rows rows summed
// before them, n_tiles = tp[n_chunks]), int64, then the work counter (8
// bytes, zero between launches; the kernel zeroes it when it ends, so two
// launches of one table must not overlap), on the device; no chunk has
// rows longer than S with a split table, and their row ranges are
// disjoint. f is even, x 4-byte and out 8-byte aligned.
extern "C" int textgcn_row_reduce_run(const void* table, int n_chunks, int n_tiles,
                                      int tile_rows, const void* x, void* out, int f,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_rows != kTileRows) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return static_cast<int>(cudaGetLastError());
  // the per-chunk call's V sets the chains; the loads take 16 bytes where
  // f and the alignment allow
  const int v_ref = wide_loads(f, x, out) ? 8 : 2;
  const bool w8 = f % 8 == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  RunLayout lay;
  lay.n_grp = 32 / lanes_for(f / v_ref);
  lay.ncv = f / (w8 ? 8 : 2);
  lay.lanes_v = lanes_for(lay.ncv);
  lay.n_ct = (lay.ncv + lay.lanes_v - 1) / lay.lanes_v;
  return w8 ? launch_run<8>(table, n_chunks, n_tiles, x, out, f, lay, s)
            : launch_run<2>(table, n_chunks, n_tiles, x, out, f, lay, s);
}
