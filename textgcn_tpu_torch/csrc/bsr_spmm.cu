// K1: block-sparse (BSR) tiles times a dense feature table, for Hopper (sm_90a).
//
//   out[br*128 + i, :] = sum over tiles t of block-row br:
//                        sum_k tiles[t, i, k] * x[tile_col[t]*128 + k, :]
//
// Replaces the Pallas kernels textgcn_tpu/ops/pallas_spmm.py
// `_make_grouped_kernel` and `_bsr_kernel`, and, on one shard's block-rows,
// textgcn_tpu/parallel/mesh_kernels.py `_bsr_leg_apply`. The Python wrappers
// (`bsr_spmm`, `bsr_leg`), the split table and the plain PyTorch version are
// in textgcn_tpu_torch/ops/bsr_spmm.py.
//
// Layout: `tiles` is the flat [T, 128, 128] bf16 tile stack sorted by
// block-row; `tile_ptr` [n_block_rows + 1] is a CSR over tiles (the tiles of
// block-row br are tile_ptr[br] .. tile_ptr[br+1]-1); `tile_col` [T] is each
// tile's block-column. `x` is [n_block_cols*128, f] bf16 and `out` is
// [n_block_rows*128, f] f32, both row-major with f a multiple of 16 up to
// 256; the matrix may be rectangular (a shard's block-rows against all
// columns). A block-row without tiles gets zeros.
//
// Bound on the card. A tile (32 KiB) carries 2*128*128*f flops: at f = 208
// about 208 flops a byte of tile, below the bf16 ridge (~295), so the bytes
// bound the call: each tile read once from HBM (194 MB on R8 doc-word) and
// its 128-row slab of x (53 KB at f = 208) brought into the SM from L2. At
// f = 16 the tile bytes are nearly the whole cost. The degree sort makes
// the block-rows uneven (R8: 1 to 120 tiles, mean 49), and a block that
// walks a whole block-row makes the call as long as the longest one.
//
// Design against that bound:
// - Long block-rows are split. No block walks more than T = kSegTiles
//   tiles: a block-row of more than T tiles is cut into block-row-local
//   segments (boundaries at multiples of T from its first tile), listed in a
//   split table (`TileSplit`) that the tile stack's container builds once.
//   Pass 1 gives each segment a block that writes a 128 x f f32 partial, and
//   each block-row of at most T tiles a block that writes its output rows
//   once. Pass 2 (`row_split.cuh`, shared with K2) adds a long block-row's
//   partials in segment order. No atomics and a fixed order: two launches
//   give the same bits, and a block-row the same bits in any tile stack that
//   holds it (its path depends only on its own tile count), so a shard's
//   block-rows equal the single-device pass's. T = 16 (the best of 8-64 and
//   no split on the H100 at R8's F'=208, PERF.md; scripts/sweep_kernels.py
//   rebuilds the kernel at other T with -DTEXTGCN_K1_T). On R8 at T = 16,
//   93 of 121 block-rows are split into 399 segments.
// - Each tile and each x slab is read once per block: one block of 8 warps
//   covers all 128 rows and all f columns (warps in a 4 x 2 grid of 32 rows
//   by f/2 columns, f32 accumulators in registers: 104 a thread at f = 208).
// - Loads are asynchronous: `cp.async` streams the tiles and their x slabs
//   into a ring of kStages stages in dynamic shared memory, each stage half
//   a tile (its 128 x 64 half and the 64 x rows it multiplies), and the
//   tensor cores (`mma.sync` m16n8k16, bf16 in, f32 accumulate) work on one
//   stage while the next ones land; one barrier a stage. Shared rows are
//   padded by 16 bytes, so `ldmatrix` reads are free of bank conflicts. A
//   tile's block-column is read one stage ahead, so no copy waits on it,
//   and the fragments of the next 16-column step are loaded into a second
//   set of registers while the tensor cores work on the current one.
//   Four stages (two tiles in flight) take 184 KB at f = 208; six fit only
//   up to f = 144 and are taken there when the kernel is built with
//   -DTEXTGCN_K1_STAGES=6 (no faster at f = 16 on the H100).
// What bounds it now: a block's tile costs ~3.8 us at f = 208 and ~1.1 at
// f = 16 (R8's 120-tile block-row without a table, PERF.md): at f = 208
// the MMA and ldmatrix issue of 8 warps an SM, not the bytes. The next step
// is `wgmma` from shared memory (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "row_split.cuh"  // split_item and pass 2

#ifndef TEXTGCN_K1_T
#define TEXTGCN_K1_T 16
#endif
#ifndef TEXTGCN_K1_STAGES
#define TEXTGCN_K1_STAGES 4
#endif

namespace {

constexpr int kSegTiles = TEXTGCN_K1_T;  // T: the most tiles a block walks
constexpr int kStages = TEXTGCN_K1_STAGES;  // ring stages, half a tile each
constexpr int kTile = 128;            // tile edge, rows = columns
constexpr int kK = 64;                // tile columns (rows of x) in a stage
constexpr int kThreads = 256;         // 8 warps: 4 row groups x 2 column halves
constexpr int kPad = 8;               // bf16 padding per shared row
constexpr int kLdA = kK + kPad;       // 72: row stride of a half tile in shared memory
constexpr size_t kMaxSmem = 232448;   // a block's dynamic shared memory on the H100

size_t smem_bytes(int stages, int f) {
  return (size_t)stages * (kTile * kLdA + kK * (f + kPad)) * sizeof(__nv_bfloat16);
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 1. Blocks [0, n_seg) take the split table's segments and write their
// partials; blocks [n_seg, n_seg + n_block_rows) take the block-rows, and
// with a table a block-row of more than T tiles is left to its segments.
// NT >= f / 16 is the number of 8-column MMA blocks a warp may hold; the
// warp uses f / 16 of them.
template <int NT, int S>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_kernel(const __nv_bfloat16* __restrict__ tiles,
                const int* __restrict__ tile_ptr,
                const int* __restrict__ tile_col,
                const __nv_bfloat16* __restrict__ x,
                float* __restrict__ out,
                const int* __restrict__ seg_row,
                const int* __restrict__ seg_t0,
                float* __restrict__ partial,
                int n_seg, int f) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int ldx = f + kPad;
  const int stage_elems = kTile * kLdA + kK * ldx;

  const int w = blockIdx.x;
  int br, t0, t1;
  if (!split_item(w, n_seg, kSegTiles, tile_ptr, seg_row, seg_t0, br, t0, t1)) return;
  float* dst = w < n_seg ? partial + (size_t)w * kTile * f : out + (size_t)br * kTile * f;
  const int n_units = 2 * (t1 - t0);  // half tiles: unit u is half u % 2 of tile u / 2

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp % 4) * 32;  // this warp's 32 output rows
  const int nt = f / 16;             // 8-column blocks per warp
  const int col0 = (warp / 4) * nt * 8;
  // this thread's first 16-byte vector of a stage's x rows and its step
  const int vpr = f / 8;             // 16-byte vectors in a row of x
  const int xr0 = threadIdx.x / vpr, xk0 = threadIdx.x % vpr;
  const int xdr = kThreads / vpr, xdk = kThreads % vpr;

  // unit u (tile t0 + u/2, block-column col) into stage s: 16-byte async
  // copies, cached in L2 only
  auto load = [&](int s, int u, int col) {
    __nv_bfloat16* sa = smem + s * stage_elems;
    __nv_bfloat16* sx = sa + kTile * kLdA;
    const int half = u & 1;
    const __nv_bfloat16* ga = tiles + (size_t)(t0 + u / 2) * kTile * kTile + half * kK;
#pragma unroll
    for (int j = 0; j < kTile * kK / 8 / kThreads; ++j) {
      const int r = threadIdx.x / (kK / 8) + j * (kThreads * 8 / kK), k = (threadIdx.x % (kK / 8)) * 8;
      cp_async16(sa + r * kLdA + k, ga + r * kTile + k);
    }
    const __nv_bfloat16* gx = x + ((size_t)col * kTile + half * kK) * f;
    for (int r = xr0, k = xk0; r < kK;) {
      cp_async16(sx + r * ldx + k * 8, gx + (size_t)r * f + k * 8);
      r += xdr;
      k += xdk;
      if (k >= vpr) {
        k -= vpr;
        ++r;
      }
    }
  };

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][j][q] = 0.f;

  // the ring: S - 1 units in flight before the first product; the
  // block-column of the next unit to load is read one unit ahead
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_units) load(s, s, tile_col[t0 + s / 2]);
    cp_async_commit();
  }
  int next_col = S - 1 < n_units ? tile_col[t0 + (S - 1) / 2] : 0;
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<S - 2>();  // unit u has landed (this thread's copies)
    __syncthreads();         // ... everyone's; and stage (u-1) % S is free
    const int v = u + S - 1;
    if (v < n_units) load(v % S, v, next_col);
    cp_async_commit();
    if (v + 1 < n_units) next_col = tile_col[t0 + (v + 1) / 2];
    const __nv_bfloat16* sa = smem + (u % S) * stage_elems;
    const __nv_bfloat16* sx = sa + kTile * kLdA;
    // the fragments of 16-column step kk: A's two 16-row blocks, and x's
    // 8-column blocks (two per x4 load, the last one of an odd count alone)
    auto fragments = [&](int kk, unsigned (&a)[2][4], unsigned (&b)[NT][2]) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], sa + (row0 + mi * 16 + (lane & 15)) * kLdA + kk * 16 + (lane >> 4) * 8);
      const __nv_bfloat16* xb = sx + (kk * 16 + (lane & 15)) * ldx + col0;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < NT && j + 1 < nt) {
          unsigned q[4];
          ldsm_x4_t(q, xb + j * 8 + (lane >> 4) * 8);
          b[j][0] = q[0];
          b[j][1] = q[1];
          b[j + 1][0] = q[2];
          b[j + 1][1] = q[3];
        } else if (j < nt) {
          ldsm_x2_t(b[j], xb + j * 8);
        }
      }
    };
    // two register sets: step kk + 1's loads are in flight during step
    // kk's products (the asm statements keep their order, so the overlap
    // is written out)
    unsigned a[2][2][4], b[2][NT][2];
    fragments(0, a[0], b[0]);
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
      if (kk + 1 < kK / 16) fragments(kk + 1, a[(kk + 1) & 1], b[(kk + 1) & 1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          mma16816(acc[0][j], a[kk & 1][0], b[kk & 1][j][0], b[kk & 1][j][1]);
          mma16816(acc[1][j], a[kk & 1][1], b[kk & 1][j][0], b[kk & 1][j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the accumulators: rows lane/4 and lane/4 + 8 of each 16-row block,
  // columns 2*(lane%4) and +1 of each 8-column block
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = row0 + mi * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int c = col0 + j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(dst + (size_t)r * f + c) =
            make_float2(acc[mi][j][0], acc[mi][j][1]);
        *reinterpret_cast<float2*>(dst + (size_t)(r + 8) * f + c) =
            make_float2(acc[mi][j][2], acc[mi][j][3]);
      }
    }
  }
}

struct Args {
  const __nv_bfloat16* tiles;
  const int* tile_ptr;
  const int* tile_col;
  const __nv_bfloat16* x;
  float* out;
  const int* seg_row;
  const int* seg_t0;
  float* partial;
  int n_block_rows, n_seg, f;
};

template <int NT, int S>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, a.f);
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_kernel<NT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsr_spmm_kernel<NT, S><<<a.n_seg + a.n_block_rows, kThreads, smem, stream>>>(
      a.tiles, a.tile_ptr, a.tile_col, a.x, a.out, a.seg_row, a.seg_t0, a.partial,
      a.n_seg, a.f);
  return static_cast<int>(cudaGetLastError());
}

// the smallest compiled NT that holds f / 16 blocks (f = 16 and 208 exactly)
template <int S>
int launch_nt(const Args& a, cudaStream_t stream) {
  const int nt = a.f / 16;
  if (nt <= 1) return launch<1, S>(a, stream);
  if (nt <= 2) return launch<2, S>(a, stream);
  if (nt <= 4) return launch<4, S>(a, stream);
  if (nt <= 8) return launch<8, S>(a, stream);
  if (nt <= 13) return launch<13, S>(a, stream);
  return launch<16, S>(a, stream);
}

}  // namespace

// T, the most tiles one block walks: the split table must be built for it.
extern "C" int textgcn_bsr_spmm_segment_tiles() { return kSegTiles; }

// Launches on `stream`; returns the first CUDA error of the launches (0 when
// none). `table` is the split table: seg_row [n_seg] (block-rows), seg_t0
// [n_seg] (first tiles), long_ptr [n_long + 1], int32 back to back (null
// when n_seg == 0); `partial` an [n_seg, 128, f] f32 scratch. f is a
// multiple of 16 up to 256; tiles and x are 16-byte aligned.
extern "C" int textgcn_bsr_spmm(const void* tiles, const void* tile_ptr,
                                const void* tile_col, const void* x, void* out,
                                const void* table, void* partial, int n_block_rows,
                                int f, int n_seg, int n_long, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_block_rows + n_seg == 0) return static_cast<int>(cudaGetLastError());
  const int* seg_row = static_cast<const int*>(table);
  const Args a{static_cast<const __nv_bfloat16*>(tiles), static_cast<const int*>(tile_ptr),
               static_cast<const int*>(tile_col), static_cast<const __nv_bfloat16*>(x),
               static_cast<float*>(out), seg_row, n_seg ? seg_row + n_seg : nullptr,
               static_cast<float*>(partial), n_block_rows, n_seg, f};
  const int err = (kStages > 4 && smem_bytes(kStages, f) > kMaxSmem)
                      ? launch_nt<4>(a, s)
                      : launch_nt<kStages>(a, s);
  if (err != 0) return err;
  launch_split_sum(seg_row, n_seg ? seg_row + 2 * n_seg : nullptr,
                   static_cast<const float*>(partial), static_cast<float*>(out), n_long,
                   kTile * f, 0, s);
  return static_cast<int>(cudaGetLastError());
}
