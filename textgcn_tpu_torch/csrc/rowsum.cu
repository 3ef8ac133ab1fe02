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
// Bound on the card: one streaming read of v (4 bytes per edge), plus the
// serial walk of the hub rows on a degree-sorted graph.
// Design: one warp per row, lanes stride over the row's edges with coalesced
// loads and the warp sums with shuffles (the TPU masked each k-slot chunk
// against a one-hot row matrix). No atomics: deterministic.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
rowsum_kernel(const int* __restrict__ row_ptr, const float* __restrict__ v,
              float* __restrict__ out, int n_rows) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  float s = 0.f;
#pragma unroll 4
  for (int e = e0 + lane; e < e1; e += 32) s += v[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if (lane == 0) out[row] = s;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int textgcn_rowsum(const void* row_ptr, const void* v, void* out,
                              int n_rows, void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  rowsum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const float*>(v),
      static_cast<float*>(out), n_rows);
  return static_cast<int>(cudaGetLastError());
}
