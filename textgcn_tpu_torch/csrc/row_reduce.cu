// K2: row-sorted sparse edges reduced onto output rows, for Hopper (sm_90a).
//
//   out[r, :] += sum_{e = row_ptr[r]}^{row_ptr[r+1]-1} val[e] * x[col[e], :]
//
// Replaces the Pallas kernels textgcn_tpu/ops/pallas_onehot.py
// `_onehot_kernel_base` and `_onehot_kernel`. The Python wrapper, its checks
// and its plain PyTorch version are in textgcn_tpu_torch/ops/row_reduce.py.
//
// `out` [>= n_rows, f] f32 is updated IN PLACE: on the hybrid path it holds
// the tile leg's result, so the two legs' sum never makes a separate pass over
// device memory (the fused add of `_onehot_kernel_base`). The wrapper passes a
// zeroed buffer when there is no base. `x` is [*, f] bf16 and f is even.
//
// Design: one warp per output row; each lane owns two adjacent columns
// (one bf16x2 load of x, one float2 of out) and the warp strides across f.
// The gather of x and the scale by val happen here, in registers; the TPU
// version had XLA write the [E, f] product stream to memory first. The pass is
// bound by the random reads of x rows (2*f bytes each), which the row-sorted
// CSR makes the only irregular access; out is read and written once per row
// that has edges, and rows without edges are left untouched.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
row_reduce_kernel(const int* __restrict__ row_ptr,
                  const int* __restrict__ col,
                  const float* __restrict__ val,
                  const __nv_bfloat16* __restrict__ x,
                  float* __restrict__ out,
                  int n_rows, int f) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  const int e0 = row_ptr[row], e1 = row_ptr[row + 1];
  if (e0 == e1) return;
  float* o = out + (size_t)row * f;
  for (int c = 2 * lane; c < f; c += 64) {
    float2 acc = *reinterpret_cast<const float2*>(o + c);
    for (int e = e0; e < e1; ++e) {
      const float v = val[e];
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(x + (size_t)col[e] * f + c));
      acc.x = fmaf(v, xv.x, acc.x);
      acc.y = fmaf(v, xv.y, acc.y);
    }
    *reinterpret_cast<float2*>(o + c) = acc;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int textgcn_row_reduce(const void* row_ptr, const void* col,
                                  const void* val, const void* x, void* out,
                                  int n_rows, int f, void* stream) {
  const int blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  row_reduce_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(col),
      static_cast<const float*>(val), static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(out), n_rows, f);
  return static_cast<int>(cudaGetLastError());
}
