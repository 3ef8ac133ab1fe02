// K1: block-sparse (BSR) tiles times a dense feature table, for Hopper (sm_90a).
//
//   out[br*128 + i, :] = sum over tiles t of block-row br:
//                        sum_k tiles[t, i, k] * x[tile_col[t]*128 + k, :]
//
// Replaces the Pallas kernels textgcn_tpu/ops/pallas_spmm.py
// `_make_grouped_kernel` and `_bsr_kernel`, and, on one shard's block-rows,
// textgcn_tpu/parallel/mesh_kernels.py `_bsr_leg_apply`. The Python wrappers
// (`bsr_spmm`, `bsr_leg`), their checks and their plain PyTorch version are
// in textgcn_tpu_torch/ops/bsr_spmm.py.
//
// Layout: `tiles` is the flat [T, 128, 128] bf16 tile stack sorted by
// block-row; `tile_ptr` [n_block_rows + 1] is a CSR over tiles (the tiles of
// block-row br are tile_ptr[br] .. tile_ptr[br+1]-1); `tile_col` [T] is each
// tile's block-column. `x` is [n_block_cols*128, f] bf16 and `out` is
// [n_block_rows*128, f] f32, both row-major with f a multiple of 16; the
// matrix may be rectangular (a shard's block-rows against all columns). A
// block-row without tiles gets zeros.
//
// Design: one block per (half block-row, 64-column feature chunk). The block
// loops over its block-row's tiles, so it owns its 64 output rows and writes
// them once, with no atomics and no zero-fill pass (the TPU kernel's
// sequential "zero on first visit" grid becomes this loop). Each of the four
// warps keeps a 16 x 64 f32 accumulator in WMMA fragments (bf16 inputs, f32
// accumulation). The next tile's slice of A and of x is loaded into
// registers while the tensor cores work on the current one from shared
// memory, so each tile costs one overlapped round trip to memory rather than
// several exposed ones. The feature chunks of one block-row are neighbours in
// the grid, so they run together and walk the same tiles at the same time:
// a tile comes from device memory once and from L2 for the other chunks.
// The x rows a tile needs (a table of a few MB) stay in L2 as well.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kTile = 128;             // tile edge, rows = columns
constexpr int kRows = 64;              // output rows per block
constexpr int kCols = 64;              // feature columns per block
constexpr int kWarps = kRows / 16;     // one warp per 16 output rows
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 padding per shared row (bank spread)
constexpr int kLdA = kTile + kPad;     // 136: row stride of the A slice
constexpr int kLdX = kCols + kPad;     // 72: row stride of the x slice
constexpr int kVecA = kRows * (kTile / 8) / kThreads;  // 16-byte vectors per thread
constexpr int kVecX = kTile * (kCols / 8) / kThreads;

// One tile's share of A (64 x 128) and x (128 x 64) for this thread.
struct Stage {
  uint4 a[kVecA];
  uint4 x[kVecX];
};

__device__ __forceinline__ void load_stage(Stage& st, const __nv_bfloat16* __restrict__ tiles,
                                           const __nv_bfloat16* __restrict__ x, int t,
                                           int col, int row_half, int f, int f0, int nvec) {
  const uint4* a_src = reinterpret_cast<const uint4*>(
      tiles + ((size_t)t * kTile + (size_t)row_half * kRows) * kTile);
#pragma unroll
  for (int j = 0; j < kVecA; ++j) st.a[j] = a_src[threadIdx.x + j * kThreads];
  const __nv_bfloat16* x_src = x + (size_t)col * kTile * f + f0;
#pragma unroll
  for (int j = 0; j < kVecX; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kCols / 8), c = i % (kCols / 8);
    if (c < nvec) st.x[j] = *reinterpret_cast<const uint4*>(x_src + (size_t)r * f + c * 8);
  }
}

__device__ __forceinline__ void store_stage(const Stage& st, __nv_bfloat16* sa,
                                            __nv_bfloat16* sx, int nvec) {
#pragma unroll
  for (int j = 0; j < kVecA; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kTile / 8), c = i % (kTile / 8);
    *reinterpret_cast<uint4*>(&sa[r * kLdA + c * 8]) = st.a[j];
  }
#pragma unroll
  for (int j = 0; j < kVecX; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kCols / 8), c = i % (kCols / 8);
    if (c < nvec) *reinterpret_cast<uint4*>(&sx[r * kLdX + c * 8]) = st.x[j];
  }
}

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const __nv_bfloat16* __restrict__ tiles,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ tile_col,
                const __nv_bfloat16* __restrict__ x,
                float* __restrict__ out,
                int f) {
  __shared__ __align__(128) __nv_bfloat16 sa[kRows * kLdA];
  __shared__ __align__(128) __nv_bfloat16 sx[kTile * kLdX];

  const int n_chunks = (f + kCols - 1) / kCols;
  const int chunk = blockIdx.x % n_chunks;
  const int row_half = (blockIdx.x / n_chunks) % (kTile / kRows);
  const int block_row = blockIdx.x / n_chunks / (kTile / kRows);
  const int f0 = chunk * kCols;
  const int nfrag = min(kCols, f - f0) / 16;  // 16-column fragments in use
  const int nvec = 2 * nfrag;                 // 16-byte vectors per x row
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCols / 16];
#pragma unroll
  for (int j = 0; j < kCols / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  const int t_begin = tile_ptr[block_row], t_end = tile_ptr[block_row + 1];
  Stage st;
  if (t_begin < t_end) load_stage(st, tiles, x, t_begin, tile_col[t_begin], row_half, f, f0, nvec);
  for (int t = t_begin; t < t_end; ++t) {
    store_stage(st, sa, sx, nvec);
    __syncthreads();
    // the next tile's loads are in flight while this one is multiplied
    if (t + 1 < t_end) load_stage(st, tiles, x, t + 1, tile_col[t + 1], row_half, f, f0, nvec);
#pragma unroll
    for (int k = 0; k < kTile / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &sa[warp * 16 * kLdA + k * 16], kLdA);
#pragma unroll
      for (int j = 0; j < kCols / 16; ++j) {
        if (j < nfrag) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &sx[k * 16 * kLdX + j * 16], kLdX);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    }
    __syncthreads();
  }

  float* o = out + ((size_t)block_row * kTile + row_half * kRows + warp * 16) * f + f0;
#pragma unroll
  for (int j = 0; j < kCols / 16; ++j)
    if (j < nfrag) wmma::store_matrix_sync(o + j * 16, acc[j], f, wmma::mem_row_major);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int textgcn_bsr_spmm(const void* tiles, const void* tile_ptr,
                                const void* tile_col, const void* x, void* out,
                                int n_block_rows, int f, void* stream) {
  const int grid = n_block_rows * (kTile / kRows) * ((f + kCols - 1) / kCols);
  bsr_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tiles), static_cast<const int*>(tile_ptr),
      static_cast<const int*>(tile_col), static_cast<const __nv_bfloat16*>(x),
      static_cast<float*>(out), f);
  return static_cast<int>(cudaGetLastError());
}
