// The second pass of a split reduction, shared by K2 (`row_reduce.cu`),
// `attn_agg.cu`, K1 (`bsr_spmm.cu`), `attn_stats.cu` and `rowsum.cu`.
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
//
// A kernel with one value a row (`rowsum.cu`: a sum; `attn_stats.cu`: the
// softmax pair (max, sum of exp(x - max))) writes one f32 partial, or one
// (m, s) pair, per segment instead, and `split_scalar_kernel` combines
// them: one thread a long row, in segment order (R8's hub row has 19
// segments at S = 512, so a thread's walk is short), no atomics.
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
constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernels'

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

// Pass 1's work item w (a warp of K2, attn_agg, attn_stats or rowsum; a
// block of K1) under a split table: segment w of the table when w < n_seg
// (its row, and its items [i0, i1): at most seg_len from the segment's
// first), else row w - n_seg (all its items). Returns false for a row of
// more than seg_len items when there is a table: its segments cover it,
// and pass 2 writes it.
__device__ __forceinline__ bool split_item(int w, int n_seg, int seg_len,
                                           const int* __restrict__ ptr,
                                           const int* __restrict__ seg_row,
                                           const int* __restrict__ seg_i0,
                                           int& row, int& i0, int& i1) {
  if (w < n_seg) {
    row = seg_row[w];
    i0 = seg_i0[w];
    i1 = min(i0 + seg_len, ptr[row + 1]);
    return true;
  }
  row = w - n_seg;
  i0 = ptr[row];
  i1 = ptr[row + 1];
  return n_seg == 0 || i1 - i0 <= seg_len;
}

// Merge (m_o, s_o) into the running softmax pair (m, s): the max, and both
// sums rescaled to it. Starting from (kNeg, 0), an empty pair stays empty
// and -inf values contribute exp(-inf) = 0; no NaN arises while every max
// is finite (every pair starts from kNeg, so its max is at least kNeg).
__device__ __forceinline__ void softmax_merge(float& m, float& s, float m_o, float s_o) {
  const float m_new = fmaxf(m, m_o);
  s = s * expf(m - m_new) + s_o * expf(m_o - m_new);
  m = m_new;
}

// Pass 2 for one value a row. Thread i takes long row r = seg_row[k0] of
// segments k0 = long_ptr[i] .. long_ptr[i+1]-1. With pair = 0, `partial`
// [n_seg] f32 holds one sum a segment and out[r] = p_0 + p_1 + ... from
// zero; with pair = 1, `partial` [n_seg, 2] holds (m, s) pairs, merged in
// segment order from (kNeg, 0) into out[r] = m and out2[r] = s.
__global__ void __launch_bounds__(kSplitThreads)
split_scalar_kernel(const int* __restrict__ seg_row,
                    const int* __restrict__ long_ptr,
                    const float* __restrict__ partial,
                    float* __restrict__ out,
                    float* __restrict__ out2,
                    int n_long, int pair) {
  const int i = blockIdx.x * kSplitThreads + threadIdx.x;
  if (i >= n_long) return;
  const int k0 = long_ptr[i], k1 = long_ptr[i + 1];
  const int row = seg_row[k0];
  if (pair) {
    const float2* p = reinterpret_cast<const float2*>(partial);
    float m = kNeg, s = 0.f;
    for (int k = k0; k < k1; ++k) {
      const float2 q = p[k];
      softmax_merge(m, s, q.x, q.y);
    }
    out[row] = m;
    out2[row] = s;
  } else {
    float a = 0.f;
    for (int k = k0; k < k1; ++k) a += partial[k];
    out[row] = a;
  }
}

// The scalar pass 2 on `stream`, nothing when there is no long row.
// `partial` is 8-byte aligned when pair = 1.
inline void launch_split_scalar(const int* seg_row, const int* long_ptr,
                                const float* partial, float* out, float* out2,
                                int n_long, int pair, cudaStream_t stream) {
  if (n_long <= 0) return;
  const int blocks = (n_long + kSplitThreads - 1) / kSplitThreads;
  split_scalar_kernel<<<blocks, kSplitThreads, 0, stream>>>(seg_row, long_ptr, partial,
                                                            out, out2, n_long, pair);
}

}  // namespace
