// K1's f32 mode: block-sparse (BSR) f32 tiles times an f32 feature table, for
// Hopper (sm_90a), on the tensor cores (`wgmma`) in 3xTF32.
//
//   out[br*128 + i, :] = sum over tiles t of block-row br:
//                        sum_k tiles[t, i, k] * x[tile_col[t]*128 + k, :]
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_spmm.py `_bsr_kernel` on
// f32 blocks (`spmm_bsr(..., bf16=False)`, the JAX package's `--spmm bsr`,
// which runs `jax.lax.dot(..., preferred_element_type=f32)` on f32 tiles).
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
// Numerics: 3xTF32. Each operand v is split into big = tf32(v) and small =
// tf32(v - big), both rounded to nearest (ties away, as cvt.rna); v - big is
// exact in f32, so big + small holds v within 2^-22. The tensor cores add
// small*big, big*small and big*big; small*small (2^-22 of the product) is
// dropped. The tensor cores' own f32 accumulation truncates, and over a
// block-row's thousands of k steps that drifts (accumulated in place, the
// error against the f64 product was 16-50x plain f32's on the card). So
// each stage's 12 products (4 k8 steps x 3) are summed from zero into a
// partial, which an f32 add joins to the accumulator, stage after stage.
// The result is f32-accurate, which keeps `--spmm bsr` the package's
// f32-exact format; one TF32 product (about three decimal digits:
// tests/test_torch_tf32.py) would not be, and is not used.
//
// Bound on the card. A 64 KiB f32 tile carries 2*128*128*f flops; three
// TF32 products of it at 495 TFLOP/s (dense) take 3 * 2 * 128*128*f / 495e12
// s, 0.458 ms on R8 doc-word without a degree sort at f = 208 (11,091 tiles,
// 727 MB: the bytes take 0.225 ms), so the operations bound the call there;
// at f = 16 the tile bytes do (0.218 ms). On that stack the tile format does
// 53 times the matrix's nonzero work: it is meant for graphs whose edges
// cluster.
//
// Design:
// - `wgmma` (`m64nNk8.f32.tf32.tf32`), A from registers, B from shared
//   memory through a 128-byte-swizzle descriptor. `wgmma` takes a TF32
//   operand from shared memory only K-major: the tile (row i, k contiguous)
//   is K-major as stored, x (k rows, features contiguous) is not. So the
//   wide layout swaps the operands, out^T = x^T tiles^T: the tile chunk is
//   B (N = tile rows) and x is A (M = 64 features), loaded and split by the
//   consumer. With f <= 64 and enough work items the narrow layout keeps
//   out = tiles x: the tile chunk is A (M = 64 tile rows, split by the
//   consumer) and x^T, written by the producer into two small planes, is B
//   (N = f), so no features are padded to 64.
// - Warp-specialised blocks of three warpgroups: warpgroup 2 produces, 0
//   and 1 consume, through a ring of stages handed over with mbarriers
//   (full: the producer's 128 threads; empty: the consumers' 256). A stage
//   is a 32-column chunk of the tile (one 128-byte swizzle row a tile row)
//   and the 32 rows of x it multiplies. The producer copies with `cp.async`
//   (features past f zero-filled), kLag units ahead of the stage it splits:
//   wide layout, the tile chunk's big part in place and its small part
//   beside it; narrow layout, x^T's two planes. It then fences the async
//   proxy and arrives on the stage's full barrier. A consumer loads and
//   splits its register operand, runs the 12 `wgmma` into its partial,
//   waits, adds, and arrives on the empty barrier. Warpgroup 1 starts a
//   little later than 0, so one's loads and adds overlap the other's
//   products. The ring takes as many stages as 220 KB holds (4-8).
// - Wide layout, more than 64 features: a block takes 128 features (64 a
//   consumer) of every tile row (N = 128: 64 accumulators and 64 partials
//   a consumer thread, so `setmaxnreg` moves registers from the producer,
//   88, to the consumers, 208); at f = 208 two blocks an item, side by side
//   in the grid so the second read of a tile comes from L2. With fewer work
//   items than SMs (R8 topic: 67) a consumer takes N = 32 tile rows, so
//   each item is cut into row slabs as well (128 or 64 features each).
// - ptxas (sm_90a): the wide kernel at N = 128, 168 registers a thread at
//   launch (88 and 208 after `setmaxnreg`), at N = 32, 84; the narrow one
//   72-110 (f = 16-64); no spills.
// - K1's work items and second pass (row_split.cuh): a block takes one
//   segment of at most T tiles of a long block-row (writing an f32 partial)
//   or one whole block-row of at most T tiles; pass 2 adds a long
//   block-row's partials in segment order. No atomics: two launches give
//   the same bits. The split table is the stack's own TileSplit, built at
//   the same T as K1's.
// What bounds it now (chip_smoke.py on an H100, PERF.md): at f = 208 on R8
// doc-word 0.97 ms of device time, 2.1x its bound: 208 features computed
// as 256, the splits and partial adds around each stage's products, and
// the last of 11 waves of blocks; at f = 16, 0.29 ms, 1.3x the tile
// bytes' bound.
// Dropped: the first version, FFMA on the CUDA cores (f32 fmaf, 255
// registers, 2.27x its 67 TFLOP/s bound: PERF.md), and a 3xTF32 `mma.sync`
// m16n8k8 version, measured slower than this one on the card while
// developing it: its loop of fragment loads, splits and partial adds left
// the tensor cores idle most of the time. Also measured slower: f > 128 cut
// into the wide layout's first 128 features and a narrow launch for the
// rest (no padding), whose second pass read every tile from memory again.
#include <cuda_runtime.h>

#include <cstdint>

#include "row_split.cuh"  // split_item and pass 2

#ifndef TEXTGCN_K1_T
#define TEXTGCN_K1_T 16
#endif

namespace {

constexpr int kSegTiles = TEXTGCN_K1_T;  // T: the most tiles a block walks
constexpr int kTile = 128;               // tile edge, rows = columns
constexpr int kK = 32;                   // tile columns (rows of x) in a stage: 128 bytes
constexpr int kChunks = kTile / kK;      // stages a tile
constexpr int kThreads = 384;            // two consumer warpgroups, one producer
constexpr int kProducer = 256;           // the producer's first thread
// registers a thread at N = 128: 88 * 128 + 208 * 256 of the SM's 65,536
constexpr int kProducerRegs = 88, kConsumerRegs = 208;
constexpr int kWgFeat = 64;              // features (wgmma M) a warpgroup holds
constexpr int kXPad = 8;                 // f32 padding per shared row of x
constexpr int kSwizzle = 1024;           // bytes of a 128-byte-swizzle atom (8 rows)
constexpr int kRing = 220 * 1024;        // shared bytes for the ring's stages

// A block's shape: NW, a consumer's wgmma N; WF, 2 when the consumers split
// 128 features, 1 when they split the tile rows (64 features). A stage holds
// a 32-column chunk of `kRows` tile rows, its small part, and the 32 rows of
// x it multiplies (`kFeats` features); as many stages as kRing holds, up to
// 8, with the loads kLag units ahead of the split.
template <int NW, int WF>
struct Shape {
  static constexpr int kRows = NW * 2 / WF;
  static constexpr int kFeats = kWgFeat * WF;
  static constexpr int kLdx = kFeats + kXPad;
  static constexpr int kTileBytes = kRows * kK * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + kK * kLdx * 4;
  static constexpr int kStages = kRing / kStageBytes < 8 ? kRing / kStageBytes : 8;
  static constexpr int kLag = kStages - 2;
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kStages * 8 + kSwizzle;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, or zeros when !full (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b)) : "memory");
}

// until the barrier's phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(b)),
      "r"(phase)
      : "memory");
}

// v rounded to TF32's 10 mantissa bits, to nearest with ties away from
// zero: cvt.rna.tf32.f32's result for a finite v, in two integer
// instructions (the cvt compiles to a sequence several times longer)
__device__ __forceinline__ unsigned tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = big + small (+ what TF32 cannot hold of the remainder, 2^-22 of v)
__device__ __forceinline__ void split_tf32(float v, unsigned& big, unsigned& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// the 128-byte-swizzle descriptor of a K-major operand at shared address
// `addr` (1024-byte aligned but for the k step's 32-byte offset): 8-row
// groups 1024 bytes apart, the leading offset unused
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(kSwizzle >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep a register's value where it is across the asynchronous wgmma
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(unsigned& r) { asm volatile("" : "+r"(r)::"memory"); }

// d (+)= a (64 x 8 from registers) * b (8 x 128, K-major in shared memory,
// 128-byte swizzle) for one warpgroup; d from zero when scale_d is 0
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a (64 x 8 from registers) * b (8 x 64, K-major in shared memory,
// 128-byte swizzle) for one warpgroup; d from zero when scale_d is 0
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a (64 x 8 from registers) * b (8 x 32, K-major in shared memory,
// 128-byte swizzle) for one warpgroup; d from zero when scale_d is 0
__device__ __forceinline__ void wgmma_n32(float (&d)[16], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// d (+)= a (64 x 8 from registers) * b (8 x 48, K-major in shared memory,
// 128-byte swizzle) for one warpgroup; d from zero when scale_d is 0
__device__ __forceinline__ void wgmma_n48(float (&d)[24], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (+)= a (64 x 8 from registers) * b (8 x 16, K-major in shared memory,
// 128-byte swizzle) for one warpgroup; d from zero when scale_d is 0
__device__ __forceinline__ void wgmma_n16(float (&d)[8], const unsigned (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <int NW>
__device__ __forceinline__ void wgmma_n(float (&d)[NW / 2], const unsigned (&a)[4], uint64_t desc,
                                        int scale_d) {
  if constexpr (NW == 128) wgmma_n128(d, a, desc, scale_d);
  if constexpr (NW == 64) wgmma_n64(d, a, desc, scale_d);
  if constexpr (NW == 48) wgmma_n48(d, a, desc, scale_d);
  if constexpr (NW == 32) wgmma_n32(d, a, desc, scale_d);
  if constexpr (NW == 16) wgmma_n16(d, a, desc, scale_d);
}

// Pass 1. Block b takes work item b / nslab and its slab b % nslab (the
// slabs of an item run side by side, so a tile read again comes from L2).
// Items [0, n_seg) are the split table's segments, which write their
// partials; items [n_seg, n_seg + n_block_rows) the block-rows, and with a
// table a block-row of more than T tiles is left to its segments. Slab y
// takes row slab y % rslabs (NW * 2 / wf tile rows) and feature slab
// y / rslabs (64 * wf features). Warpgroup 2 produces: it copies each unit
// (a 32-column chunk of a tile and its 32 rows of x) into the ring, splits
// the tile chunk into its big part (in place) and small part, and marks the
// stage full; warpgroups 0 and 1 consume: each loads and splits its x
// fragments, runs the unit's 12 wgmma m64 x NW x k8 into a partial, adds it
// to its accumulators and marks the stage empty.
template <int NW, int WF>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_f32_kernel(const float* __restrict__ tiles,
                    const int* __restrict__ tile_ptr,
                    const int* __restrict__ tile_col,
                    const float* __restrict__ x,
                    float* __restrict__ out,
                    const int* __restrict__ seg_row,
                    const int* __restrict__ seg_t0,
                    float* __restrict__ partial,
                    int n_seg, int f, int nslab) {
  using B = Shape<NW, WF>;
  constexpr int rows = B::kRows, feats = B::kFeats, ldx = B::kLdx, S = B::kStages;
  constexpr int tile_bytes = B::kTileBytes, stage_bytes = B::kStageBytes;
  constexpr int rslabs = kTile / rows;
  extern __shared__ unsigned char smem_raw[];
  const int item = blockIdx.x / nslab, slab = blockIdx.x % nslab;
  int br, t0, t1;
  if (!split_item(item, n_seg, kSegTiles, tile_ptr, seg_row, seg_t0, br, t0, t1)) return;
  // the swizzled buffers start on a 1024-byte boundary
  unsigned char* smem = smem_raw + ((kSwizzle - smem_addr(smem_raw) % kSwizzle) % kSwizzle);
  const int r0 = (slab % rslabs) * rows;     // this block's tile rows
  const int c0 = (slab / rslabs) * feats;    // and features
  // stage s: the tile chunk (big part after the split), its small part, x
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * stage_bytes);
  uint64_t* empty = full + S;
  const int n_units = kChunks * (t1 - t0);   // unit u: chunk u % 4 of tile t0 + u / 4
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 128);   // the producer's threads
      mbar_init(empty + s, 256);  // the consumers'
    }
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    // at N = 128 the consumers need more than the 168 registers a thread
    // of three warpgroups gets; the producer needs fewer
    if constexpr (NW == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int pt = threadIdx.x - kProducer;
    constexpr int vsh = 3 + WF;  // log2 of the 16-byte vectors in a row of x
    for (int u = 0; u < n_units + B::kLag; ++u) {
      if (u < n_units) {
        // unit u into stage u % S once the consumers are done with unit
        // u - S there: the tile chunk's rows, 128 bytes each,
        // 16-byte chunk c of row r at chunk c ^ (r % 8); x's rows, features
        // [c0, c0 + feats), zeros past f
        const int s = u % S;
        if (u >= S) mbar_wait(empty + s, (u / S - 1) & 1);
        unsigned char* st = smem + s * stage_bytes;
        const float* ga = tiles + (size_t)(t0 + u / kChunks) * kTile * kTile +
                          (size_t)r0 * kTile + (u % kChunks) * kK;
#pragma unroll
        for (int j = 0; j < rows * 8 / 128; ++j) {
          const int v = pt + j * 128, r = v >> 3, c = v & 7;
          cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4), ga + (size_t)r * kTile + c * 4);
        }
        float* sx = reinterpret_cast<float*>(st + 2 * tile_bytes);
        const float* gx = x + ((size_t)tile_col[t0 + u / kChunks] * kTile + (u % kChunks) * kK) * f;
#pragma unroll
        for (int j = 0; j < (kK << vsh) / 128; ++j) {
          const int v = pt + j * 128, r = v >> vsh, c = (v & ((1 << vsh) - 1)) * 4;
          const bool in = c0 + c < f;
          cp_async16(sx + r * ldx + c, gx + (size_t)r * f + (in ? c0 + c : 0), in);
        }
      }
      cp_async_commit();
      const int w = u - B::kLag;  // the unit to split
      if (w >= 0) {
        cp_async_wait<B::kLag>();                      // this thread's copies of unit w
        asm volatile("bar.sync 1, 128;\n" ::: "memory");  // ... the producer's
        unsigned char* st = smem + (w % S) * stage_bytes;
#pragma unroll
        for (int j = 0; j < rows * 8 / 128; ++j) {
          const int i = pt + j * 128;
          uint4* p = reinterpret_cast<uint4*>(st + i * 16);
          const uint4 q = *p;
          uint4 big, small;
          split_tf32(__uint_as_float(q.x), big.x, small.x);
          split_tf32(__uint_as_float(q.y), big.y, small.y);
          split_tf32(__uint_as_float(q.z), big.z, small.z);
          split_tf32(__uint_as_float(q.w), big.w, small.w);
          *p = big;
          *reinterpret_cast<uint4*>(st + tile_bytes + i * 16) = small;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + w % S);
      }
    }
    return;
  }

  if constexpr (NW == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  float* dst = item < n_seg ? partial + (size_t)item * kTile * f : out + (size_t)br * kTile * f;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int fbase = kWgFeat * (wg % WF);     // this warpgroup's features, from c0
  const int rbase = NW * (wg / WF);          // its tile rows, from r0
  const bool active = c0 + fbase < f;        // uniform in the warpgroup

  float acc[NW / 2], d[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  // warpgroup 1 starts a little later, so one warpgroup's fragment loads
  // and adds overlap the other's products on the tensor cores
  if (wg == 1) __nanosleep(200);
  for (int u = 0; u < n_units; ++u) {
    const int s = u % S;
    mbar_wait(full + s, (u / S) & 1);
    if (active) {
      unsigned char* st = smem + s * stage_bytes;
      // x's A fragments of the 4 k8 steps, wgmma row m = 16w + g holding
      // feature 16w + 2g and row m + 8 feature 16w + 2g + 1 (so each pair is
      // one 8-byte load): (m, k = t), (m + 8, t), (m, t + 4), (m + 8, t + 4)
      const float* sx =
          reinterpret_cast<const float*>(st + 2 * tile_bytes) + fbase + 16 * warp + 2 * g;
      unsigned ab[kK / 8][4], as[kK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v = *reinterpret_cast<const float2*>(sx + (kk * 8 + tq + h * 4) * ldx);
          split_tf32(v.x, ab[kk][2 * h], as[kk][2 * h]);
          split_tf32(v.y, ab[kk][2 * h + 1], as[kk][2 * h + 1]);
        }
      const unsigned tb = smem_addr(st) + rbase * 128, ts = tb + tile_bytes;
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) fence_reg(d[i]);
      wgmma_fence();
      // small_x * big_t from zero, then big_x * small_t and big_x * big_t
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
        wgmma_n<NW>(d, as[kk], sw128_desc(tb + kk * 32), kk > 0);
        wgmma_n<NW>(d, ab[kk], sw128_desc(ts + kk * 32), 1);
        wgmma_n<NW>(d, ab[kk], sw128_desc(tb + kk * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fence_reg(ab[kk][q]);
          fence_reg(as[kk][q]);
        }
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) {
        fence_reg(d[i]);
        acc[i] += d[i];
      }
    }
    mbar_arrive(empty + s);
  }

  // the accumulators: features f0 = 16w + 2g and f0 + 1 (rows m, m + 8),
  // tile rows n = 8j + 2t and n + 1 of each 8-row block j
  if (active) {
    const int f0 = c0 + fbase + 16 * warp + 2 * g;
    if (f0 < f) {
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        float* o = dst + (size_t)(r0 + rbase + 8 * j + 2 * tq) * f + f0;
        *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j], acc[4 * j + 2]);
        *reinterpret_cast<float2*>(o + f) = make_float2(acc[4 * j + 1], acc[4 * j + 3]);
      }
    }
  }
}

// The narrow layout, for f <= 64 with at least as many work items as SMs:
// out = tiles x (no swap), so the padding to 64 features is gone and the
// producer splits only x. Each consumer warpgroup holds 64 tile rows (wgmma
// M) by all N = f features; the tile chunk is its A operand from registers
// (loaded and split by the consumer), and x^T (features by k, K-major, the
// 128-byte swizzle) its B operand, in two planes (big and small) that the
// producer writes from the x rows it copied.
template <int N>
struct Narrow {
  static constexpr int kLdA = kK + 4;  // tile chunk rows 36 floats apart: no bank conflicts
  static constexpr int kLdX = N + 4;   // staged x rows
  static constexpr int kPlane = N * 128;
  static constexpr int kTileOff = 2 * kPlane;
  static constexpr int kXOff = kTileOff + kTile * kLdA * 4;
  static constexpr int kStageBytes = (kXOff + kK * kLdX * 4 + kSwizzle - 1) / kSwizzle * kSwizzle;
  static constexpr int kStages = kRing / kStageBytes < 8 ? kRing / kStageBytes : 8;
  static constexpr int kLag = kStages - 2;
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + 2 * kStages * 8 + kSwizzle;
};

template <int N>
__global__ void __launch_bounds__(kThreads, 1)
bsr_spmm_f32_narrow_kernel(const float* __restrict__ tiles,
                           const int* __restrict__ tile_ptr,
                           const int* __restrict__ tile_col,
                           const float* __restrict__ x,
                           float* __restrict__ out,
                           const int* __restrict__ seg_row,
                           const int* __restrict__ seg_t0,
                           float* __restrict__ partial,
                           int n_seg) {
  using B = Narrow<N>;
  constexpr int S = B::kStages, stage_bytes = B::kStageBytes;
  extern __shared__ unsigned char smem_raw[];
  const int item = blockIdx.x;
  int br, t0, t1;
  if (!split_item(item, n_seg, kSegTiles, tile_ptr, seg_row, seg_t0, br, t0, t1)) return;
  unsigned char* smem = smem_raw + ((kSwizzle - smem_addr(smem_raw) % kSwizzle) % kSwizzle);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * stage_bytes);
  uint64_t* empty = full + S;
  const int n_units = kChunks * (t1 - t0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 256);
    }
  }
  __syncthreads();

  if (threadIdx.x >= kProducer) {
    const int pt = threadIdx.x - kProducer;
    for (int u = 0; u < n_units + B::kLag; ++u) {
      if (u < n_units) {
        // unit u: the tile chunk's 128 rows (padded) and x's 32 rows
        const int s = u % S;
        if (u >= S) mbar_wait(empty + s, (u / S - 1) & 1);
        unsigned char* st = smem + s * stage_bytes;
        const float* ga = tiles + (size_t)(t0 + u / kChunks) * kTile * kTile + (u % kChunks) * kK;
        float* sa = reinterpret_cast<float*>(st + B::kTileOff);
#pragma unroll
        for (int j = 0; j < kTile * 8 / 128; ++j) {
          const int v = pt + j * 128, r = v >> 3, c = (v & 7) * 4;
          cp_async16(sa + r * B::kLdA + c, ga + (size_t)r * kTile + c);
        }
        float* sx = reinterpret_cast<float*>(st + B::kXOff);
        const float* gx = x + ((size_t)tile_col[t0 + u / kChunks] * kTile + (u % kChunks) * kK) * N;
#pragma unroll
        for (int j = 0; j < kK * N / 4 / 128; ++j) {
          const int v = pt + j * 128, r = v / (N / 4), c = (v % (N / 4)) * 4;
          cp_async16(sx + r * B::kLdX + c, gx + (size_t)r * N + c);
        }
      }
      cp_async_commit();
      const int w = u - B::kLag;  // the unit whose x to split
      if (w >= 0) {
        cp_async_wait<B::kLag>();
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        unsigned char* st = smem + (w % S) * stage_bytes;
        const float* sx = reinterpret_cast<const float*>(st + B::kXOff);
        // x^T: feature n's 32 k values in a 128-byte row, 16-byte chunk
        // c at chunk c ^ (n % 8); a warp takes one n, a lane one k
#pragma unroll
        for (int j = 0; j < kK * N / 128; ++j) {
          const int e = pt + j * 128, k = e % kK, n = e / kK;
          unsigned big, small;
          split_tf32(sx[k * B::kLdX + n], big, small);
          const int off = n * 128 + (((k >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
          *reinterpret_cast<unsigned*>(st + off) = big;
          *reinterpret_cast<unsigned*>(st + B::kPlane + off) = small;
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(full + w % S);
      }
    }
    return;
  }

  float* dst = item < n_seg ? partial + (size_t)item * kTile * N : out + (size_t)br * kTile * N;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = 64 * wg + 16 * warp + g;  // this thread's first tile row
  float acc[N / 2], d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int u = 0; u < n_units; ++u) {
    const int s = u % S;
    mbar_wait(full + s, (u / S) & 1);
    unsigned char* st = smem + s * stage_bytes;
    // the tile chunk's A fragments of the 4 k8 steps: rows (g, k = t),
    // (g + 8, t), (g, t + 4), (g + 8, t + 4), split
    const float* sa = reinterpret_cast<const float*>(st + B::kTileOff) + row0 * B::kLdA + tq;
    unsigned ab[kK / 8][4], as[kK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split_tf32(sa[(q & 1) * 8 * B::kLdA + kk * 8 + (q >> 1) * 4], ab[kk][q], as[kk][q]);
    const unsigned xb = smem_addr(st), xs = xb + B::kPlane;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) fence_reg(d[i]);
    wgmma_fence();
    // small_t * big_x from zero, then big_t * small_x and big_t * big_x
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk) {
      wgmma_n<N>(d, as[kk], sw128_desc(xb + kk * 32), kk > 0);
      wgmma_n<N>(d, ab[kk], sw128_desc(xs + kk * 32), 1);
      wgmma_n<N>(d, ab[kk], sw128_desc(xb + kk * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fence_reg(ab[kk][q]);
        fence_reg(as[kk][q]);
      }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      fence_reg(d[i]);
      acc[i] += d[i];
    }
    mbar_arrive(empty + s);
  }
  // the accumulators: tile rows m and m + 8, features n = 8j + 2t and n + 1
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    float* o = dst + (size_t)row0 * N + 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(o + 8 * N) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
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

template <int NW, int WF>
int launch(const Args& a, cudaStream_t stream) {
  using B = Shape<NW, WF>;
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_f32_kernel<NW, WF>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nslab = (a.f + B::kFeats - 1) / B::kFeats * (kTile / B::kRows);
  bsr_spmm_f32_kernel<NW, WF><<<(a.n_seg + a.n_block_rows) * nslab, kThreads, B::kSmem, stream>>>(
      a.tiles, a.tile_ptr, a.tile_col, a.x, a.out, a.seg_row, a.seg_t0, a.partial,
      a.n_seg, a.f, nslab);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_narrow(const Args& a, cudaStream_t stream) {
  using B = Narrow<N>;
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_spmm_f32_narrow_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bsr_spmm_f32_narrow_kernel<N><<<a.n_seg + a.n_block_rows, kThreads, B::kSmem, stream>>>(
      a.tiles, a.tile_ptr, a.tile_col, a.x, a.out, a.seg_row, a.seg_t0, a.partial, a.n_seg);
  return static_cast<int>(cudaGetLastError());
}

// The layout, from the grid and f. Fewer work items than SMs: the wide
// layout at N = 32, each item's rows cut into slabs (WF = 2 when f > 64:
// the consumers take 64 features each; else they split the rows). More:
// the narrow layout (N = f) for f <= 64, else the wide one at N = 128, a
// block for each 128 features.
int launch_items(const Args& a, int n_items, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_items < sms) return a.f > kWgFeat ? launch<32, 2>(a, stream) : launch<32, 1>(a, stream);
  switch (a.f) {
    case 16: return launch_narrow<16>(a, stream);
    case 32: return launch_narrow<32>(a, stream);
    case 48: return launch_narrow<48>(a, stream);
    case 64: return launch_narrow<64>(a, stream);
    default: return launch<128, 2>(a, stream);
  }
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
  // the blocks with work: the segments and the block-rows they do not cover
  const int err = launch_items(a, n_block_rows - n_long + n_seg, s);
  if (err != 0) return err;
  launch_split_sum(seg_row, n_seg ? seg_row + 2 * n_seg : nullptr,
                   static_cast<const float*>(partial), static_cast<float*>(out), n_long,
                   kTile * f, 0, s);
  return static_cast<int>(cudaGetLastError());
}
