// The second pass of a split reduction, shared by K2 (`row_reduce.cu`),
// `attn_agg.cu` and K1 (`bsr_spmm.cu`).
//
// A kernel that splits its long rows (K2's and attn_agg's rows of more than
// S edges, K1's block-rows of more than T tiles) writes one f32 partial row
// per segment in its first pass. This pass gives each long row i (segments
// long_ptr[i] .. long_ptr[i+1]-1 of a split table, see
// textgcn_tpu_torch/ops/split.py) base + p_0 + p_1 + ..., in segment order,
// or p_0 + p_1 + ... from zero without a base: no atomics and a fixed order,
// so two launches give the same bits. K1 passes a block-row's 128 rows of F
// columns as one row of 128 * F values.
//
// One warp adds a span of kSpan columns of one long row, two columns a lane
// (the row width f is even); the grid's y dimension walks the spans, so a
// wide row (K1's) spreads over many warps and a narrow one (f <= kSpan)
// takes one.
#pragma once

#include <cuda_runtime.h>

// S: the most edges one warp of K2 or attn_agg walks; the split tables are
// built for it (textgcn_tpu_torch/ops/row_reduce.py SEGMENT_EDGES)
#ifndef TEXTGCN_K2_S
#define TEXTGCN_K2_S 512
#endif

namespace {

constexpr int kSegEdges = TEXTGCN_K2_S;
constexpr int kSplitThreads = 256;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kSpan = 256;  // columns of a long row one warp adds

__global__ void __launch_bounds__(kSplitThreads)
split_sum_kernel(const int* __restrict__ seg_row,
                 const int* __restrict__ long_ptr,
                 const float* __restrict__ partial,
                 float* __restrict__ out,
                 int n_long, int f, int has_base) {
  const int i = blockIdx.x * kSplitWarps + threadIdx.x / 32;
  if (i >= n_long) return;
  const int lane = threadIdx.x % 32;
  const int k0 = long_ptr[i], k1 = long_ptr[i + 1];
  float* o = out + (size_t)seg_row[k0] * f;
  const int c_end = min(f, (int)(blockIdx.y + 1) * kSpan);
  for (int c = blockIdx.y * kSpan + 2 * lane; c < c_end; c += 64) {
    float2 a = has_base ? *reinterpret_cast<const float2*>(o + c) : make_float2(0.f, 0.f);
    for (int k = k0; k < k1; ++k) {
      const float2 p = *reinterpret_cast<const float2*>(partial + (size_t)k * f + c);
      a.x += p.x;
      a.y += p.y;
    }
    *reinterpret_cast<float2*>(o + c) = a;
  }
}

// Pass 2 on `stream`, nothing when there is no long row. `out` is 8-byte
// aligned and f even.
inline void launch_split_sum(const int* seg_row, const int* long_ptr,
                             const float* partial, float* out, int n_long,
                             int f, int has_base, cudaStream_t stream) {
  if (n_long <= 0) return;
  const dim3 grid((n_long + kSplitWarps - 1) / kSplitWarps, (f + kSpan - 1) / kSpan);
  split_sum_kernel<<<grid, kSplitThreads, 0, stream>>>(seg_row, long_ptr, partial,
                                                        out, n_long, f, has_base);
}

}  // namespace
