// Coded gradient combine:  out[p] = sum_i c_i g[i, p]  over a worker-stacked
// (m, P) block, summed in float32; g and out in float32 or bfloat16, c in
// float32 (m,).
//
// Replaces the TPU kernel src/repro/kernels/coded_reduce.py (_combine_body,
// launched by coded_combine_call), which tiles P into lane-aligned blocks
// (combine_layout pads P or snaps the block to a divisor of P) with the m
// workers along the sublanes (m <= 32).  None of that layout exists here:
// threads mask the ragged edge themselves, and m is any count.
//
// Bound on the H100: memory at large P, launch latency at small P.  Every
// element of g is read once and used in one multiply-add (2 flops per 4
// bytes in float32), far below the card's operations-per-byte line, so a
// wide block (the coded-SGD flat gradient, 537 MB at (32, 4194304)) is
// bound by bytes: each thread loads E = 16 bytes / sizeof(T) contiguous
// columns of a row as one 16-byte load where P is a multiple of E and g and
// out are 16-byte aligned (one element at a time otherwise, the ragged tail
// masked), and the lanes of a warp that share a row take neighbouring
// column slots, so every load is a run of whole 32-byte sectors.  A narrow
// block (the L-BFGS step's (32, 6000), 0.77 MB) is bound by the latency of
// the launch and of its loads: there the work of a column is split over
// rows as well, so that each thread issues a few independent loads, the
// card has many more threads in flight, and no barrier or shared memory
// sits on the path.  The lanes of a warp form G row groups (G = 1, 2, 4
// or 8, the least power of two >= min(m, 8)) of 32 / G column slots; group
// y sums the rows y, y + G, y + 2G, ... in that order, and the G partial
// sums are added by a fixed shuffle tree.  G depends on m alone, so every
// column's sum has one order fixed by m, whatever P, the alignment or the
// launch; (m,) and (m, 1) weights are the same m floats and give the same
// result bit for bit.
#include "hadamard.cuh"

#include <cstdint>

namespace {

constexpr int kWarps = 8;        // warps a block
constexpr int kMaxGroups = 8;

inline int row_groups(int m) {
  int g = 1;
  while (g < m && g < kMaxGroups) g <<= 1;
  return g;
}

// Lane l of a warp takes column slot l % (32 / G) of the warp's 32 / G
// slots and row group l / (32 / G).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
combine_kernel(const T* __restrict__ g, const float* __restrict__ c,
               T* __restrict__ out, int m, int64_t P, int G) {
  constexpr int E = 16 / sizeof(T);
  const int per_warp = 32 / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = lane / per_warp;
  const int64_t slot = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) *
                           per_warp + lane % per_warp;
  const int64_t col0 = slot * E;
  const int ncol = P - col0 < E ? static_cast<int>(P - col0) : E;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if (ncol > 0) {
    if constexpr (kVec) {
#pragma unroll 4
      for (int i = y; i < m; i += G) {
        alignas(16) T v[E];
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(g + i * P + col0);
        const float ci = __ldg(c + i);
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[e] = fmaf(ci, repro::to_f32(v[e]), acc[e]);
      }
    } else {
#pragma unroll 4
      for (int i = y; i < m; i += G) {
        const T* row = g + i * P + col0;
        const float ci = __ldg(c + i);
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (e < ncol) acc[e] = fmaf(ci, repro::to_f32(row[e]), acc[e]);
      }
    }
  }
  // the groups' partial sums, lane l + 16, + 8, ... onto lane l
  for (int off = 16; off >= per_warp; off >>= 1) {
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[e] += __shfl_down_sync(0xffffffffu, acc[e], off);
  }
  if (y != 0 || ncol <= 0) return;
  if constexpr (kVec) {
    alignas(16) T o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = repro::from_f32<T>(acc[e]);
    *reinterpret_cast<uint4*>(out + col0) = *reinterpret_cast<const uint4*>(o);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < ncol) out[col0 + e] = repro::from_f32<T>(acc[e]);
  }
}

template <typename T>
cudaError_t launch(const void* g, const float* c, void* out, int m,
                   int64_t P, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool vec = P % E == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int G = row_groups(m);
  const int64_t per_block = static_cast<int64_t>(kWarps) * (32 / G);
  const int64_t slots = (P + E - 1) / E;
  const int64_t blocks = (slots + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  const unsigned nb = static_cast<unsigned>(blocks);
  if (vec)
    combine_kernel<T, true><<<nb, kWarps * 32, 0, stream>>>(gt, c, ot, m, P,
                                                            G);
  else
    combine_kernel<T, false><<<nb, kWarps * 32, 0, stream>>>(gt, c, ot, m,
                                                             P, G);
  return cudaGetLastError();
}

}  // namespace

// g (m, P) contiguous, c (m,) float32, out (P,).  dtype: 0 = float32,
// 1 = bfloat16 (g and out).  Returns cudaGetLastError() after the launch.
extern "C" int repro_coded_combine(const void* g, const void* c, void* out,
                                   int m, int64_t P, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || P <= 0) return cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  if (dtype == 0) return launch<float>(g, cf, out, m, P, st);
  if (dtype == 1) return launch<__nv_bfloat16>(g, cf, out, m, P, st);
  return cudaErrorInvalidValue;
}

// The row groups the combine splits m worker rows into (for the tests).
extern "C" int repro_coded_combine_groups(int m) { return row_groups(m); }
