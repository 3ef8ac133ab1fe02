// Sampled dense-dense product over a forward CSR, for Hopper (sm_90a).
//
//   u[e] = g[row[e], :] . x[col[e], :]   for every edge e
//
// `g` [>= n_rows, f] and `x` [*, f] are bf16 with f a multiple of 8; `row`
// and `col` [E] int32 are the forward CSR's edges in order; `u` [E] f32 is
// in forward-CSR order. Each product of two bf16 values is exact in f32; the
// sums are f32.
//
// Replaces the Pallas kernel textgcn_tpu/ops/pallas_attention.py
// `_sddmm_kernel` (the GAT backward's u = g[row] . x[col]). The Python
// wrapper, its checks and its plain PyTorch version are in
// textgcn_tpu_torch/ops/attention.py.
//
// Bound on the card: the gathers of x rows, 2*f bytes per edge; at R8's
// sizes x and g (6 MB each) sit in L2, so the rate of L2 gathers bounds it.
//
// The hub rows. u[e] needs no sum across edges, so the kernel is edge-
// parallel: each warp takes a fixed range of kEdgesPerWarp edges, whatever
// rows they belong to, and a hub row is spread over as many warps as its
// edges fill (the TPU kernel walked fixed chunks of k edge slots per grid
// step, balanced by edges too). `lanes` lanes (a power of two) share an
// edge, so a warp works on 32/lanes edges at once: each lane holds up to
// kRegVec 16-byte vectors of g[row] in registers and reloads them only when
// its edge's row changes (the edges are row-sorted), loads the same vectors
// of x[col] and takes a partial dot product; the lanes of a group sum their
// partials with log2(lanes) shuffle levels in a fixed order, and one lane
// writes u[e], once. A row wider than lanes * kRegVec vectors reads the rest
// of g from memory (L1) per edge, so any f is one walk. No atomics:
// deterministic, and u[e] does not depend on which warp takes the edge.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEdgesPerWarp = 256;
constexpr int kRegVec = 4;  // g vectors a lane keeps in registers

// sum of the 8 products of two bf16 vectors, added onto d in order
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float d) {
  const unsigned p[4] = {a.x, a.y, a.z, a.w};
  const unsigned q[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d = fmaf(__uint_as_float(p[i] << 16), __uint_as_float(q[i] << 16), d);
    d = fmaf(__uint_as_float(p[i] & 0xffff0000u), __uint_as_float(q[i] & 0xffff0000u), d);
  }
  return d;
}

__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int* __restrict__ row,
             const int* __restrict__ col,
             const uint4* __restrict__ g,
             const uint4* __restrict__ x,
             float* __restrict__ u,
             int n_edges, int nv, int lanes) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  const long long first = (long long)w * kEdgesPerWarp;
  if (first >= n_edges) return;
  const int e_begin = (int)first;
  const int e_end = min(n_edges, e_begin + kEdgesPerWarp);
  const int lane = threadIdx.x % 32;
  const int sub = lane % lanes;
  const int grp = lane / lanes;
  const int n_grp = 32 / lanes;
  uint4 gv[kRegVec];
  int cur = -1;  // the row whose g vectors gv holds
  for (int base = e_begin; base < e_end; base += 32) {
    const int n_in = min(32, e_end - base);
    int r_l = 0, c_l = 0;
    if (lane < n_in) {
      r_l = row[base + lane];
      c_l = col[base + lane];
    }
    const int steps = (n_in + n_grp - 1) / n_grp;  // the same for every lane
    for (int k = 0; k < steps; ++k) {
      const int t = k * n_grp + grp;  // < 32
      const int r = __shfl_sync(kFull, r_l, t);
      const int c = __shfl_sync(kFull, c_l, t);
      const bool ok = t < n_in;
      float d = 0.f;
      if (ok) {
        if (r != cur) {
          cur = r;
#pragma unroll
          for (int j = 0; j < kRegVec; ++j) {
            const int v = sub + j * lanes;
            if (v < nv) gv[j] = g[(size_t)r * nv + v];
          }
        }
        uint4 xv[kRegVec];
#pragma unroll
        for (int j = 0; j < kRegVec; ++j) {
          const int v = sub + j * lanes;
          if (v < nv) xv[j] = x[(size_t)c * nv + v];
        }
#pragma unroll
        for (int j = 0; j < kRegVec; ++j)
          if (sub + j * lanes < nv) d = dot8(gv[j], xv[j], d);
        for (int v = sub + kRegVec * lanes; v < nv; v += lanes)
          d = dot8(g[(size_t)r * nv + v], x[(size_t)c * nv + v], d);
      }
      // sum over the group's lanes (aligned blocks of `lanes` lanes)
      for (int off = lanes / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(kFull, d, off);
      if (ok && sub == 0) u[base + t] = d;
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() after the launch.
// nv = f / 8, the 16-byte vectors in a row of g and of x. The lanes that
// share an edge are the fewest that hold a row of g in kRegVec vectors each
// (8 at f = 200, 1 at f = 8: the fastest on the H100, PERF.md), or
// TEXTGCN_SDDMM_LANES where scripts/sweep_kernels.py sets it.
extern "C" int textgcn_sddmm(const void* row, const void* col, const void* g,
                             const void* x, void* u, int n_edges, int nv,
                             void* stream) {
#ifdef TEXTGCN_SDDMM_LANES
  constexpr int lanes = TEXTGCN_SDDMM_LANES;
  static_assert(lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0,
                "TEXTGCN_SDDMM_LANES: a power of two up to 32");
#else
  int lanes = 1;
  while (lanes * kRegVec < nv && lanes < 32) lanes <<= 1;
#endif
  const long long warps = ((long long)n_edges + kEdgesPerWarp - 1) / kEdgesPerWarp;
  const int blocks = (int)((warps + kWarps - 1) / kWarps);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  sddmm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row), static_cast<const int*>(col),
      static_cast<const uint4*>(g), static_cast<const uint4*>(x),
      static_cast<float*>(u), n_edges, nv, lanes);
  return static_cast<int>(cudaGetLastError());
}
