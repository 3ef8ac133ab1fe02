// GAT softmax statistics over a forward CSR, for Hopper (sm_90a).
//
// B5 mode (build = 1): for every edge e of row r
//   logit[e] = leaky(es[r] + ed[col[e]], slope) + logval[e]
// is written, and mx[r], sm[r] are the row's softmax max and sum of
// exp(logit - mx[r]). B6 mode (build = 0) takes the logits as given and only
// computes mx and sm. A row with no edge (or only -inf logits) gets the
// sentinel mx = -1e30 and sm = 0, as in the TPU kernels.
//
// Replaces the Pallas kernels textgcn_tpu/ops/pallas_attention.py
// `_stats_logits_kernel` (B5) and `_stats_kernel` (B6). The Python wrappers,
// their checks and their plain PyTorch versions are in
// textgcn_tpu_torch/ops/attention.py.
//
// Bound on the card: a few bytes per edge (col, logval and the logit written
// back in B5, 12 bytes; the logit read in B6, 4), one 4-byte gather of ed
// from an array that sits in L2, and one exp. A degree-sorted graph has hub
// rows of thousands of edges (R8's: 9,589), which one warp would walk alone,
// with a dependent online-softmax update at each step, while the rest of the
// card idles (0.13 ms on an H100 at R8's sizes against a 0.0125 ms bound).
//
// Design: the hub rows are split as K2 and attn_agg split them, with the
// same S = kSegEdges and the same table (the forward CSR's `RowSplit`,
// `AttentionGraph.split`). Pass 1 gives one warp each segment of at most S
// edges of a long row and each row of at most S edges. In B5 mode a
// segment's warp writes the logits of its own edges, so every logit is
// written once. A short row's warp writes mx and sm; a segment's warp writes
// its (m, s) pair to an [n_seg, 2] f32 scratch, and pass 2
// (`row_split.cuh` split_scalar_kernel) merges each long row's pairs in
// segment order with the online-softmax rescale. No atomics: two launches
// give the same bits, and a row the same bits in any CSR that holds it; a
// max does not depend on order, so mx equals the unsplit kernel's bits.
// Without a table every row is one warp's, whatever its length.
//
// Inside a warp: lanes stride over the edges with coalesced loads, kUnroll
// edges a lane in flight (in B5 their col and logval loads, then their ed
// gathers); each lane folds a batch into its online (max, rescaled sum) pair
// with one rescale for the batch, and the warp merges the 32 pairs with
// shuffles. The row's es is read once (the TPU selected it per slot with a
// one-hot mask). The 128-lane replicated stats rows and the window/chunk
// layout of the TPU are not carried over: mx and sm are one float per row.
#include <cuda_runtime.h>

#include <cmath>

#include "row_split.cuh"  // S (TEXTGCN_K2_S), kNeg, split_item, softmax_merge, pass 2

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // edges a lane keeps in flight

// Pass 1. Warps [0, n_seg) take the split table's segments and write their
// (m, s) pairs; warps [n_seg, n_seg + n_rows) take the rows, and with a table
// a row of more than S edges is left to its segments. A lane's edges are
// e0 + lane + 32 * t: they depend only on e - e0.
template <bool kBuild>
__global__ void __launch_bounds__(kThreads)
attn_stats_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const float* __restrict__ logval,
                  const float* __restrict__ es,
                  const float* __restrict__ ed,
                  float* __restrict__ logits,
                  float* __restrict__ mx,
                  float* __restrict__ sm,
                  const int* __restrict__ seg_row,
                  const int* __restrict__ seg_e0,
                  float2* __restrict__ partial,
                  int n_rows, int n_seg, float slope) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= n_seg + n_rows) return;
  const int lane = threadIdx.x % 32;
  int row, e0, e1;
  if (!split_item(w, n_seg, kSegEdges, row_ptr, seg_row, seg_e0, row, e0, e1)) return;
  const float es_r = kBuild ? es[row] : 0.f;
  float m = kNeg, s = 0.f;
  for (int base = e0 + lane; base < e1; base += 32 * kUnroll) {
    float lg[kUnroll];
    if (kBuild) {
      int c[kUnroll];
      float lv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + 32 * u;
        c[u] = e < e1 ? col[e] : -1;
        lv[u] = e < e1 ? logval[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + 32 * u;
        if (c[u] >= 0) {
          const float b = es_r + ed[c[u]];
          lg[u] = (b >= 0.f ? b : slope * b) + lv[u];
          logits[e] = lg[u];
        } else {
          lg[u] = -INFINITY;  // past the row: adds exp(-inf) = 0
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int e = base + 32 * u;
        lg[u] = e < e1 ? logits[e] : -INFINITY;
      }
    }
    // fold the batch: one rescale to its max, then its terms
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, lg[u]);
    s *= expf(m - m_new);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += expf(lg[u] - m_new);
    m = m_new;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, off);
    const float s_o = __shfl_xor_sync(kFull, s, off);
    softmax_merge(m, s, m_o, s_o);
  }
  if (lane == 0) {
    if (w < n_seg) {
      partial[w] = make_float2(m, s);
    } else {
      mx[row] = m;
      sm[row] = s;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launches. With
// build = 0, `col`, `logval`, `es` and `ed` are not read and `logits` is.
// `table` is the forward CSR's split table (seg_row [n_seg], seg_e0 [n_seg],
// long_ptr [n_long + 1], int32 back to back; null when n_seg == 0),
// `partial` an [n_seg, 2] f32 scratch.
extern "C" int textgcn_attn_stats(const void* row_ptr, const void* col,
                                  const void* logval, const void* es,
                                  const void* ed, void* logits, void* mx,
                                  void* sm, const void* table, void* partial,
                                  int n_rows, float slope, int build, int n_seg,
                                  int n_long, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_seg + n_rows + kWarps - 1) / kWarps;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const int* seg_e0 = n_seg ? seg_row + n_seg : nullptr;
  const int* long_ptr = n_seg ? seg_row + 2 * n_seg : nullptr;
  auto kernel = build ? attn_stats_kernel<true> : attn_stats_kernel<false>;
  kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(logval), static_cast<const float*>(es),
      static_cast<const float*>(ed), static_cast<float*>(logits),
      static_cast<float*>(mx), static_cast<float*>(sm), seg_row, seg_e0,
      static_cast<float2*>(partial), n_rows, n_seg, slope);
  launch_split_scalar(seg_row, long_ptr, static_cast<const float*>(partial),
                      static_cast<float*>(mx), static_cast<float*>(sm), n_long, 1, st);
  return static_cast<int>(cudaGetLastError());
}
