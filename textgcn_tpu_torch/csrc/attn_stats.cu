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
// Bound on the card: a few bytes per edge (col, logval, the logit written
// back, one 4-byte gather of ed from an array that sits in L2) and one exp;
// on a degree-sorted graph the serial walk of the hub rows, one warp each.
// Design: one warp per row; the row's es is read once (the TPU selected it
// per slot with a one-hot mask); lanes stride over the row's edges with
// coalesced loads, each keeps an online (max, rescaled sum) pair, and the
// warp merges the 32 pairs with shuffles. The 128-lane replicated stats
// rows and the window/chunk layout of the TPU are not carried over: mx and
// sm are one float per row. No atomics, so the result is deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;  // finite -inf stand-in, as the TPU kernels'

// Merge (m_o, s_o) into the running (m, s): max, and both sums rescaled to
// it. Starting from (kNeg, 0), an empty pair stays empty and -inf logits
// contribute exp(-inf) = 0; no NaN arises while every max is finite.
__device__ __forceinline__ void merge(float& m, float& s, float m_o, float s_o) {
  const float m_new = fmaxf(m, m_o);
  s = s * expf(m - m_new) + s_o * expf(m_o - m_new);
  m = m_new;
}

__global__ void __launch_bounds__(kThreads)
attn_stats_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const float* __restrict__ logval,
                  const float* __restrict__ es,
                  const float* __restrict__ ed,
                  float* __restrict__ logits,
                  float* __restrict__ mx,
                  float* __restrict__ sm,
                  int n_rows, float slope, int build) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  const float es_r = build ? es[row] : 0.f;
  float m = kNeg, s = 0.f;
#pragma unroll 4
  for (int e = e0 + lane; e < e1; e += 32) {
    float lg;
    if (build) {
      const float base = es_r + ed[col[e]];
      lg = (base >= 0.f ? base : slope * base) + logval[e];
      logits[e] = lg;
    } else {
      lg = logits[e];
    }
    // merge(m, s, lg, 1) with one exp
    if (lg > m) {
      s = s * expf(m - lg) + 1.f;
      m = lg;
    } else {
      s += expf(lg - m);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, off);
    const float s_o = __shfl_xor_sync(kFull, s, off);
    merge(m, s, m_o, s_o);
  }
  if (lane == 0) {
    mx[row] = m;
    sm[row] = s;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch. With
// build = 0, `col`, `logval`, `es` and `ed` are not read and `logits` is.
extern "C" int textgcn_attn_stats(const void* row_ptr, const void* col,
                                  const void* logval, const void* es,
                                  const void* ed, void* logits, void* mx,
                                  void* sm, int n_rows, float slope, int build,
                                  void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  attn_stats_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(logval), static_cast<const float*>(es),
      static_cast<const float*>(ed), static_cast<float*>(logits),
      static_cast<float*>(mx), static_cast<float*>(sm), n_rows, slope, build);
  return static_cast<int>(cudaGetLastError());
}
