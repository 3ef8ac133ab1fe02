// GAT softmax-weighted aggregation over a forward CSR, for Hopper (sm_90a).
//
//   out[r, :] = sum_{e in row r} exp(logit[e] - shift_r) / max(sm[r], 1e-30)
//                                * x[col[e], :]
//
// with shift_r = mx[r], or 0 for a row whose mx is the -1e30 sentinel. Every
// row of `out` [n_rows, f] f32 is written, rows without edges with zeros.
// `x` is [*, f] bf16 with f a multiple of 8.
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_attention.py
// `_attn_agg_kernel`. The Python wrapper, its checks and its plain PyTorch
// version are in textgcn_tpu_torch/ops/attention.py.
//
// The TPU kernel rounds the softmax weights to bf16 before its one-hot MXU
// dot; this kernel keeps them in f32 (the products of f32 weights and bf16
// features are summed in f32), so it is at least as exact.
//
// Bound on the card: the random reads of feature rows, 2*f bytes per edge
// (x itself, ~6 MB at R8 doc-word width, stays in L2), as for K2 as dx over
// the transpose CSR. A degree-sorted graph has hub rows of thousands of
// edges (R8's: 9,589), which one warp would walk alone while the rest of the
// card idles.
//
// Design: the hub rows are split as K2 splits them (`row_reduce.cu`, with
// the same S = kSegEdges and the same kind of table: the forward CSR's
// `RowSplit`, `AttentionGraph.split`). Pass 1 gives one warp each segment of
// at most S edges of a long row and each row of at most S edges; the warp
// forms the softmax weights in registers from the row's (mx, sm) and each
// edge's logit (nothing per edge is written back). A short row's warp writes
// its output row once; a segment's warp writes an f32 partial row. Pass 2
// (`row_split.cuh`, K2's code) writes each long row as the sum of its
// partials in segment order. No atomics: two launches give the same bits,
// and a row the same bits in any CSR that holds it.
//
// Inside a warp: each lane loads 8 bf16 columns as one 16-byte vector;
// `lanes` lanes (a power of two, enough to cover f/8 vectors, at most 32)
// share an edge, so a warp works on 32/lanes edges at once and narrow rows
// (the 8-class layer) keep every lane busy. The lanes stage the column and
// weight of 32 edges with one coalesced load each and hand them round with
// shuffles; each lane keeps kUnroll gathers in flight. The edge groups'
// partial rows are summed with shuffles at the end in a fixed order.
#include <cuda_runtime.h>

#include "row_split.cuh"  // S (TEXTGCN_K2_S), kNeg, split_item and pass 2

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // gathers a lane keeps in flight

// acc[0..7] += w * (the 8 bf16 values of q); bf16 -> f32 is a 16-bit shift.
__device__ __forceinline__ void fma8(float (&acc)[8], float w, uint4 q) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

// Pass 1. Warps [0, n_seg) take the split table's segments and write their
// partial rows; warps [n_seg, n_seg + n_rows) take the rows, and with a
// table a row of more than S edges is left to its segments.
__global__ void __launch_bounds__(kThreads)
attn_agg_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ col,
                const float* __restrict__ logits,
                const float* __restrict__ mx,
                const float* __restrict__ sm,
                const uint4* __restrict__ x,
                float* __restrict__ out,
                const int* __restrict__ seg_row,
                const int* __restrict__ seg_e0,
                float* __restrict__ partial,
                int n_rows, int n_seg, int nv, int lanes) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= n_seg + n_rows) return;
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;   // which vector of the column tile
  const int grp = lane / lanes;   // which edge of each group of 32/lanes
  const int n_grp = 32 / lanes;
  int row, e0, e1;
  if (!split_item(w, n_seg, kSegEdges, row_ptr, seg_row, seg_e0, row, e0, e1)) return;
  float* dst = w < n_seg ? partial + (size_t)w * nv * 8 : out + (size_t)row * nv * 8;
  const float m = mx[row];
  const float shift = m > 0.5f * kNeg ? m : 0.f;
  const float inv = 1.f / fmaxf(sm[row], 1e-30f);
  float4* o = reinterpret_cast<float4*>(dst);
  for (int v0 = 0; v0 < nv; v0 += lanes) {
    const int v = v0 + sub;
    const bool active = v < nv;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int base = e0; base < e1; base += 32) {
      const int n_in = min(32, e1 - base);
      int c_l = 0;
      float w_l = 0.f;
      if (lane < n_in) {
        c_l = col[base + lane];
        w_l = expf(logits[base + lane] - shift) * inv;
      }
      const int steps = (n_in + n_grp - 1) / n_grp;  // the same for every lane
      for (int k = 0; k < steps; k += kUnroll) {
        uint4 q[kUnroll];
        float wt[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int t = (k + u) * n_grp + grp;
          const int c = __shfl_sync(kFull, c_l, t & 31);
          wt[u] = __shfl_sync(kFull, w_l, t & 31);
          ok[u] = active && t < n_in;
          if (ok[u]) q[u] = x[(size_t)c * nv + v];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) fma8(acc, wt[u], q[u]);
      }
    }
    // lanes with the same `sub` hold the same columns for other edges
    for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], off);
    }
    if (grp == 0 && active) {
      o[2 * v] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[2 * v + 1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launches.
// nv = f / 8, the 16-byte vectors in a row of x and of out. `table` is the
// forward CSR's split table (seg_row [n_seg], seg_e0 [n_seg], long_ptr
// [n_long + 1], int32 back to back; null when n_seg == 0), `partial` an
// [n_seg, f] f32 scratch.
extern "C" int textgcn_attn_agg(const void* row_ptr, const void* col,
                                const void* logits, const void* mx,
                                const void* sm, const void* x, void* out,
                                const void* table, void* partial, int n_rows,
                                int nv, int n_seg, int n_long, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_seg + n_rows + kWarps - 1) / kWarps;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const int* seg_e0 = n_seg ? seg_row + n_seg : nullptr;
  const int* long_ptr = n_seg ? seg_row + 2 * n_seg : nullptr;
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  attn_agg_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(logits), static_cast<const float*>(mx),
      static_cast<const float*>(sm), static_cast<const uint4*>(x),
      static_cast<float*>(out), seg_row, seg_e0, static_cast<float*>(partial),
      n_rows, n_seg, nv, lanes);
  launch_split_sum(seg_row, long_ptr, static_cast<const float*>(partial),
                   static_cast<float*>(out), n_long, nv * 8, 0, s);
  return static_cast<int>(cudaGetLastError());
}
