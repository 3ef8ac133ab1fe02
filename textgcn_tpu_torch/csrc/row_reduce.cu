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
// chunk's call costs the host more than K2 takes on the card (~17 us for
// a chunk of 16,384 rows at F <= 16 on an H100). The chunks that a cache
// keeps on the card take one launch a run instead: a device table lists
// each chunk's CSR and first output row, and warp w finds its chunk by
// binary search over the chunks' row counts summed before them (at most
// ~10 steps over the 610 chunks of the benchmark's graph). Each row then
// takes the path that the chunk's own call would give it, so the run's
// output equals the per-chunk calls' bit for bit. Only chunks without a
// split table and with disjoint row ranges form a run (one launch has no
// order between two warps on the same row); the wrapper checks both when
// it builds the table.
#include <cuda_runtime.h>

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

// Pass 1 over a run of chunks with disjoint row ranges and no split table,
// onto a base: warp w takes row w - w0[k] of chunk k, the chunk with
// w0[k] <= w < w0[k+1] (w0 [n_chunks + 1]: the chunks' rows, summed
// before them), found by binary search. Each row is the direct path of
// `row_reduce_kernel` with the chunk's own call's arguments, so it gets the
// bits of that call.
template <int V>
__global__ void __launch_bounds__(kThreads)
row_reduce_kernel_run(const RunChunk* __restrict__ chunks,
                      const long long* __restrict__ w0,
                      const typename Vec<V>::T* __restrict__ x,
                      float* __restrict__ out,
                      int n_chunks, int n_rows, int f, int lanes) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= n_rows) return;
  int lo = 0, hi = n_chunks;  // w0[lo] <= w < w0[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (w0[mid] <= w) lo = mid;
    else hi = mid;
  }
  const RunChunk c = chunks[lo];
  const int i = w - static_cast<int>(w0[lo]);
  const int e0 = c.row_ptr[i], e1 = c.row_ptr[i + 1];
  if (e0 == e1) return;  // nothing to add
  reduce_row<V>(c.col, c.val, x, out + (size_t)(c.r0 + i) * f, e0, e1, f, true, lanes);
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

template <int V>
void launch_run(const void* table, int n_chunks, int n_rows, const void* x,
                void* out, int f, cudaStream_t stream) {
  const RunChunk* chunks = static_cast<const RunChunk*>(table);
  const long long* w0 = reinterpret_cast<const long long*>(chunks + n_chunks);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  row_reduce_kernel_run<V><<<blocks, kThreads, 0, stream>>>(
      chunks, w0, static_cast<const typename Vec<V>::T*>(x),
      static_cast<float*>(out), n_chunks, n_rows, f, lanes_for(f / V));
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
// last chunk's r0 + rows, f] f32 in place; returns cudaGetLastError().
// `table` is n_chunks RunChunk rows (32 bytes each: row_ptr, col and val's
// device addresses, r0) then w0 [n_chunks + 1] int64, on the device; no
// chunk has rows longer than S with a split table, and their row ranges
// are disjoint. n_rows = w0[n_chunks]. f is even, x 4-byte and out 8-byte
// aligned.
extern "C" int textgcn_row_reduce_run(const void* table, int n_chunks, int n_rows,
                                      const void* x, void* out, int f, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  if (wide_loads(f, x, out))
    launch_run<8>(table, n_chunks, n_rows, x, out, f, s);
  else
    launch_run<2>(table, n_chunks, n_rows, x, out, f, s);
  return static_cast<int>(cudaGetLastError());
}
