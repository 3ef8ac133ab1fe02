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
// (x itself, ~6 MB at R8 doc-word width, stays in L2); on a degree-sorted
// graph also the serial walk of the hub rows, one warp each.
// Design: one warp per row, the softmax weight formed in registers from the
// row's (mx, sm) and the edge's logit (nothing per edge is written back, as
// with K2 `row_reduce.cu`). Each lane loads 8 bf16 columns as one 16-byte
// vector; `lanes` lanes (a power of two, enough to cover f/8 vectors, at
// most 32) share an edge, so a warp works on 32/lanes edges at once and
// narrow rows (the 8-class layer) keep every lane busy. The lanes stage the
// column and weight of 32 edges with one coalesced load each and hand them
// round with shuffles. The edge groups' partial rows are summed with
// shuffles at the end and written once. No atomics: deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;

// acc[0..7] += w * (the 8 bf16 values of q); bf16 -> f32 is a 16-bit shift.
__device__ __forceinline__ void fma8(float (&acc)[8], float w, uint4 q) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(w, __uint_as_float(u[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(w, __uint_as_float(u[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

__global__ void __launch_bounds__(kThreads)
attn_agg_kernel(const int* __restrict__ row_ptr,
                const int* __restrict__ col,
                const float* __restrict__ logits,
                const float* __restrict__ mx,
                const float* __restrict__ sm,
                const uint4* __restrict__ x,
                float* __restrict__ out,
                int n_rows, int nv, int lanes) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;   // which vector of the column tile
  const int grp = lane / lanes;   // which edge of each group of 32/lanes
  const int n_grp = 32 / lanes;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  const float m = mx[row];
  const float shift = m > 0.5f * kNeg ? m : 0.f;
  const float inv = 1.f / fmaxf(sm[row], 1e-30f);
  float4* o = reinterpret_cast<float4*>(out + (size_t)row * nv * 8);
  for (int v0 = 0; v0 < nv; v0 += lanes) {
    const int v = v0 + sub;
    const bool active = v < nv;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int base = e0; base < e1; base += 32) {
      const int e = base + lane;
      int c_l = 0;
      float w_l = 0.f;
      if (e < e1) {
        c_l = col[e];
        w_l = expf(logits[e] - shift) * inv;
      }
      const int n_in = min(32, e1 - base);
      // every lane runs the same `lanes` iterations, so the shuffles are
      // convergent
#pragma unroll 4
      for (int t = grp; t < 32; t += n_grp) {
        const int c = __shfl_sync(kFull, c_l, t);
        const float w = __shfl_sync(kFull, w_l, t);
        if (t < n_in && active) fma8(acc, w, x[(size_t)c * nv + v]);
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

// Launches on `stream`; returns cudaGetLastError() after the launch.
// nv = f / 8, the 16-byte vectors in a row of x and of out.
extern "C" int textgcn_attn_agg(const void* row_ptr, const void* col,
                                const void* logits, const void* mx,
                                const void* sm, const void* x, void* out,
                                int n_rows, int nv, void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  attn_agg_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(logits), static_cast<const float*>(mx),
      static_cast<const float*>(sm), static_cast<const uint4*>(x),
      static_cast<float*>(out), n_rows, nv, lanes);
  return static_cast<int>(cudaGetLastError());
}
