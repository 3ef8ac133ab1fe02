// Per-row sums of per-edge scalars over a CSR, for Hopper (sm_90a).
//
//   out[r] = sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} v[e]
//
// Every row of `out` [n_rows] f32 is written (0 for a row without edges).
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_attention.py
// `_rowsum_kernel`. In the GAT backward it runs three times: the softmax
// S-term and des over the forward CSR, and ded over the transpose CSR. The
// Python wrapper, its checks and its plain PyTorch version are in
// textgcn_tpu_torch/ops/attention.py.
//
// Bound on the card: one streaming read of v (4 bytes per edge). On a
// degree-sorted graph one warp a row walks the hub rows alone (R8's: 9,589
// edges, 300 strided steps) while the rest of the card idles.
//
// Design: the hub rows are split as K2's (the same S = kSegEdges and the
// same kind of table: `AttentionGraph.split` for the forward CSR,
// `AttentionGraph.split_t` for the transpose). Pass 1 gives one warp each
// segment of at most S edges of a long row and each row of at most S edges;
// lanes stride over the edges with coalesced loads, kUnroll loads a lane in
// flight, and the warp sums with shuffles (the TPU masked each k-slot chunk
// against a one-hot row matrix). A short row's warp writes its sum; a
// segment's warp writes one f32 partial, and pass 2 (`row_split.cuh`
// split_scalar_kernel) adds a long row's partials in segment order. No
// atomics: two launches give the same bits, and a row the same bits in any
// CSR that holds it. Without a table every row is one warp's.
#include <cuda_runtime.h>

#include "row_split.cuh"  // S (TEXTGCN_K2_S), split_item and the scalar pass 2

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;  // loads a lane keeps in flight

// Pass 1. Warps [0, n_seg) take the split table's segments and write their
// partial sums; warps [n_seg, n_seg + n_rows) take the rows, and with a
// table a row of more than S edges is left to its segments. A lane's edges
// are e0 + lane + 32 * t: they depend only on e - e0.
__global__ void __launch_bounds__(kThreads)
rowsum_kernel(const int* __restrict__ row_ptr, const float* __restrict__ v,
              float* __restrict__ out, const int* __restrict__ seg_row,
              const int* __restrict__ seg_e0, float* __restrict__ partial,
              int n_rows, int n_seg) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= n_seg + n_rows) return;
  const int lane = threadIdx.x % 32;
  int row, e0, e1;
  if (!split_item(w, n_seg, kSegEdges, row_ptr, seg_row, seg_e0, row, e0, e1)) return;
  float s = 0.f;
  for (int base = e0 + lane; base < e1; base += 32 * kUnroll) {
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + 32 * u;
      x[u] = e < e1 ? v[e] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s += x[u];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) (w < n_seg ? partial[w] : out[row]) = s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launches.
// `table` is the CSR's split table (seg_row [n_seg], seg_e0 [n_seg],
// long_ptr [n_long + 1], int32 back to back; null when n_seg == 0),
// `partial` an [n_seg] f32 scratch.
extern "C" int textgcn_rowsum(const void* row_ptr, const void* v, void* out,
                              const void* table, void* partial, int n_rows,
                              int n_seg, int n_long, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n_seg + n_rows + kWarps - 1) / kWarps;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const int* seg_e0 = n_seg ? seg_row + n_seg : nullptr;
  const int* long_ptr = n_seg ? seg_row + 2 * n_seg : nullptr;
  rowsum_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const int*>(row_ptr), static_cast<const float*>(v),
      static_cast<float*>(out), seg_row, seg_e0, static_cast<float*>(partial),
      n_rows, n_seg);
  launch_split_scalar(seg_row, long_ptr, static_cast<const float*>(partial),
                      static_cast<float*>(out), nullptr, n_long, 0, st);
  return static_cast<int>(cudaGetLastError());
}
