// K1's f32 mode: block-sparse (BSR) f32 tiles times an f32 feature table, for
// Hopper (sm_90a), on the CUDA cores.
//
//   out[br*128 + i, :] = sum over tiles t of block-row br:
//                        sum_k tiles[t, i, k] * x[tile_col[t]*128 + k, :]
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_spmm.py `_bsr_kernel` on
// f32 blocks (`spmm_bsr(..., bf16=False)`, the JAX package's `--spmm bsr`).
// The Python wrappers (`bsr_spmm`, which dispatches f32 tiles here, and
// `bsr_spmm_f32`), the split table and the plain PyTorch version are in
// textgcn_tpu_torch/ops/bsr_spmm.py.
//
// Layout: K1's (bsr_spmm.cu), in f32: `tiles` is the flat [T, 128, 128] f32
// tile stack sorted by block-row, `tile_ptr` [n_block_rows + 1] a CSR over
// tiles, `tile_col` [T] each tile's block-column; `x` [n_block_cols*128, f]
// and `out` [n_block_rows*128, f] are f32, row-major, f a multiple of 16 up
// to 256. A block-row without tiles gets zeros.
//
// Numerics: f32 products, f32 sums (fmaf), never TF32: `--spmm bsr` is the
// package's f32-exact format, and TF32 keeps about three decimal digits.
//
// Bound on the card. A 64 KiB f32 tile carries 2*128*128*f flops, 104 a
// byte at f = 208, far above the f32 ridge (67 TFLOP/s over 3.35 TB/s, 20
// a byte): the FMAs bound the call, not the bytes. On R8 doc-word without a
// degree sort (11,091 tiles, most holding a few edges) that is 1.13 ms at
// f = 208, 53 times the matrix's nonzero work: the tile format is meant for
// graphs whose edges cluster.
//
// Design (simple and right first; a faster version, e.g. 3xTF32 on the
// tensor cores, is later work):
// - K1's work items and second pass (row_split.cuh): a block takes one
//   segment of at most T tiles of a long block-row (writing an f32 partial)
//   or one whole block-row of at most T tiles; pass 2 adds a long
//   block-row's partials in segment order. No atomics: two launches give
//   the same bits. The split table is the stack's own TileSplit, built at
//   the same T as K1's.
// - A 128 x 128 f32 tile is 64 KiB and a 128-row slab of x up to 128 KiB,
//   so a stage holds a 128 x 32 chunk of the tile and the 32 rows of x it
//   multiplies; `cp.async` keeps kStages - 1 stages in flight while the
//   threads work on the one that landed (one barrier a stage).
// - 256 threads in a 16 x 16 grid: thread (tx, ty) holds output rows
//   ty + 16*i (i < 8) and columns tx + 16*j (j < f/16) in registers (104
//   accumulators at f = 208). A warp reads two rows of the tile chunk (36
//   floats apart: other banks; the rest broadcast) and 16 consecutive
//   floats of x: no bank conflicts.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_split.cuh"  // split_item and pass 2

#ifndef TEXTGCN_K1_T
#define TEXTGCN_K1_T 16
#endif

namespace {

constexpr int kSegTiles = TEXTGCN_K1_T;  // T: the most tiles a block walks
constexpr int kTile = 128;               // tile edge, rows = columns
constexpr int kK = 32;                   // tile columns (rows of x) in a stage
constexpr int kChunks = kTile / kK;      // stages a tile
constexpr int kStages = 3;               // ring stages
constexpr int kThreads = 256;            // 16 x 16
constexpr int kRows = kTile / 16;        // output rows a thread holds
constexpr int kPad = 4;                  // f32 padding per shared row (16 bytes)
constexpr int kLdA = kK + kPad;          // 36: row stride of a tile chunk in shared memory

size_t smem_bytes(int f) {
  return (size_t)kStages * (kTile * kLdA + kK * (f + kPad)) * sizeof(float);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Pass 1. Blocks [0, n_seg) take the split table's segments and write their
// partials; blocks [n_seg, n_seg + n_block_rows) take the block-rows, and
// with a table a block-row of more than T tiles is left to its segments.
// NT >= f / 16 is the number of columns a thread may hold; it uses f / 16.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_f32_kernel(const float* __restrict__ tiles,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ tile_col,
                    const float* __restrict__ x,
                    float* __restrict__ out,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_t0,
                    float* __restrict__ partial,
                    int n_seg, int f) {
  extern __shared__ __align__(16) float smem[];
  const int ldx = f + kPad;
  const int stage_elems = kTile * kLdA + kK * ldx;

  const int w = blockIdx.x;
  int br, t0, t1;
  if (!split_item(w, n_seg, kSegTiles, tile_ptr, seg_row, seg_t0, br, t0, t1)) return;
  float* dst = w < n_seg ? partial + (size_t)w * kTile * f : out + (size_t)br * kTile * f;
  const int n_units = kChunks * (t1 - t0);  // unit u: chunk u % 4 of tile t0 + u / 4

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = f / 16;
  const int vpr = f / 4;  // 16-byte vectors in a row of x

  // unit u into stage s: 16-byte async copies, cached in L2 only
  auto load = [&](int s, int u) {
    float* sa = smem + s * stage_elems;
    float* sx = sa + kTile * kLdA;
    const int t = t0 + u / kChunks, q = u % kChunks;
    const float* ga = tiles + (size_t)t * kTile * kTile + q * kK;
#pragma unroll
    for (int j = 0; j < kTile * kK / 4 / kThreads; ++j) {
      const int v = threadIdx.x + j * kThreads;
      const int r = v / (kK / 4), k = (v % (kK / 4)) * 4;
      cp_async16(sa + r * kLdA + k, ga + (size_t)r * kTile + k);
    }
    const float* gx = x + ((size_t)tile_col[t] * kTile + q * kK) * f;
    for (int v = threadIdx.x; v < kK * vpr; v += kThreads) {
      const int r = v / vpr, c = (v % vpr) * 4;
      cp_async16(sx + r * ldx + c, gx + (size_t)r * f + c);
    }
  };

  float acc[kRows][NT];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_units) load(s, s);
    cp_async_commit();
  }
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<kStages - 2>();  // unit u has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and stage (u-1) % kStages is free
    const int v = u + kStages - 1;
    if (v < n_units) load(v % kStages, v);
    cp_async_commit();
    const float* sa = smem + (u % kStages) * stage_elems;
    const float* sx = sa + kTile * kLdA;
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      float a[kRows], b[NT];
#pragma unroll
      for (int i = 0; i < kRows; ++i) a[i] = sa[(ty + 16 * i) * kLdA + k];
#pragma unroll
      for (int j = 0; j < NT; ++j) b[j] = j < nt ? sx[k * ldx + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float* o = dst + (size_t)(ty + 16 * i) * f + tx;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt) o[16 * j] = acc[i][j];
  }
}

struct Args {
  const float* tiles;
  const int* tile_ptr;
  const int* tile_col;
  const float* x;
  float* out;
  const int* seg_row;
  const int* seg_t0;
  float* partial;
  int n_block_rows, n_seg, f;
};

template <int NT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.f);
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_f32_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsr_spmm_f32_kernel<NT><<<a.n_seg + a.n_block_rows, kThreads, smem, stream>>>(
      a.tiles, a.tile_ptr, a.tile_col, a.x, a.out, a.seg_row, a.seg_t0, a.partial,
      a.n_seg, a.f);
  return static_cast<int>(cudaGetLastError());
}

// the smallest compiled NT that holds f / 16 columns (f = 16, 112 and 208
// exactly or with one idle column)
int launch_nt(const Args& a, cudaStream_t stream) {
  const int nt = a.f / 16;
  if (nt <= 1) return launch<1>(a, stream);
  if (nt <= 2) return launch<2>(a, stream);
  if (nt <= 4) return launch<4>(a, stream);
  if (nt <= 8) return launch<8>(a, stream);
  if (nt <= 13) return launch<13>(a, stream);
  return launch<16>(a, stream);
}

}  // namespace

// T, the most tiles one block walks: the split table must be built for it
// (the same T as K1's bf16 kernel, so one TileSplit serves both).
extern "C" int textgcn_bsr_spmm_f32_segment_tiles() { return kSegTiles; }

// Launches on `stream`; returns the first CUDA error of the launches (0 when
// none). Arguments as textgcn_bsr_spmm's (bsr_spmm.cu), with f32 tiles and x.
extern "C" int textgcn_bsr_spmm_f32(const void* tiles, const void* tile_ptr,
                                    const void* tile_col, const void* x, void* out,
                                    const void* table, void* partial, int n_block_rows,
                                    int f, int n_seg, int n_long, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_block_rows + n_seg == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const Args a{static_cast<const float*>(tiles), static_cast<const int*>(tile_ptr),
               static_cast<const int*>(tile_col), static_cast<const float*>(x),
               static_cast<float*>(out), seg_row, n_seg ? seg_row + n_seg : nullptr,
               static_cast<float*>(partial), n_block_rows, n_seg, f};
  const int err = launch_nt(a, s);
  if (err != 0) return err;
  launch_split_sum(seg_row, n_seg ? seg_row + 2 * n_seg : nullptr,
                   static_cast<const float*>(partial), static_cast<float*>(out), n_long,
                   kTile * f, 0, s);
  return static_cast<int>(cudaGetLastError());
}
