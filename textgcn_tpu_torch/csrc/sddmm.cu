// Sampled dense-dense product over a forward CSR, for Hopper (sm_90a).
//
//   u[e] = g[r, :] . x[col[e], :]   for every edge e of row r
//
// `g` [>= n_rows, f] and `x` [*, f] are bf16 with f a multiple of 8; `u` [E]
// f32 is in forward-CSR order. Each product of two bf16 values is exact in
// f32; the sums are f32.
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_attention.py
// `_sddmm_kernel` (the GAT backward's u = g[row] . x[col]). The Python
// wrapper, its checks and its plain PyTorch version are in
// textgcn_tpu_torch/ops/attention.py.
//
// Bound on the card: the random reads of x rows, 2*f bytes per edge, and on
// a degree-sorted graph the serial walk of the hub rows.
// Design: one warp per row. The row side never leaves registers: each lane
// holds 8 columns of g[r] (the TPU selected the window's g rows with a
// one-hot transpose on the MXU). `lanes` lanes (a power of two covering
// f/8 vectors, at most 32) share an edge: each loads its 16-byte slice of
// x[col[e]], takes a partial dot product and the group sums the partials
// with shuffles, so a warp works on 32/lanes edges at once. The lanes stage
// the columns of 32 edges with one coalesced load and hand them round with
// shuffles. For f > 256 the columns go in tiles of 256 and u[e] accumulates
// over them, written by the same lane each time. No atomics: deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack8(float (&v)[8], uint4 q) {
  const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ row_ptr,
             const int* __restrict__ col,
             const uint4* __restrict__ g,
             const uint4* __restrict__ x,
             float* __restrict__ u,
             int n_rows, int nv, int lanes) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;
  const int grp = lane / lanes;
  const int n_grp = 32 / lanes;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  for (int v0 = 0; v0 < nv; v0 += lanes) {
    const int v = v0 + sub;
    const bool active = v < nv;
    float gv[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (active) unpack8(gv, g[(size_t)row * nv + v]);
    for (int base = e0; base < e1; base += 32) {
      const int c_l = base + lane < e1 ? col[base + lane] : 0;
      const int n_in = min(32, e1 - base);
#pragma unroll 4
      for (int t = grp; t < 32; t += n_grp) {
        const int c = __shfl_sync(kFull, c_l, t);
        float d = 0.f;
        if (t < n_in && active) {
          float xv[8];
          unpack8(xv, x[(size_t)c * nv + v]);
#pragma unroll
          for (int k = 0; k < 8; ++k) d = fmaf(gv[k], xv[k], d);
        }
        // sum over the group's lanes (aligned blocks of `lanes` lanes)
        for (int off = lanes / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(kFull, d, off);
        if (sub == 0 && t < n_in) u[base + t] = v0 == 0 ? d : u[base + t] + d;
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// nv = f / 8, the 16-byte vectors in a row of g and of x.
extern "C" int textgcn_sddmm(const void* row_ptr, const void* col,
                             const void* g, const void* x, void* u,
                             int n_rows, int nv, void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  int lanes = 1;
  while (lanes < nv && lanes < 32) lanes <<= 1;
  sddmm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const uint4*>(g), static_cast<const uint4*>(x),
      static_cast<float*>(u), n_rows, nv, lanes);
  return static_cast<int>(cudaGetLastError());
}
