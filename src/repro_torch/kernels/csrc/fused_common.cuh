// What the fused masked gradient's two forms share (fused_step.cu up to
// p = 16384, fused_wide.cu past it): the copies that fill a block's ring
// of rows (or row slices) in shared memory, and the second stage.  Internal
// linkage: each source that includes it has its own copy.
#pragma once

#include "hadamard.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 256;             // threads a block of either form
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 64 * kThreads;   // 16384: a row in registers
constexpr int kMaxUnits = 256;            // row blocks a block or cluster
// dynamic shared memory a block may use: the 227 KB opt-in maximum less
// 3 KB kept for the static arrays
constexpr int kSmemBudget = 227 * 1024 - 3072;

// How a row block reaches the shared-memory ring.
enum CopyMode { kBulk = 0, kWords = 1, kPlain = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Row k of the slab (p elements; for the column-split form a CTA's
// slice) into ring slot `dst`; completes a phase of `bar`.
//   kBulk  - thread 0 posts the byte count and one bulk copy (1 arrival);
//   kWords - every thread copies its 4-byte words with cp.async and
//            arrives when they land (kThreads arrivals);
//   kPlain - every thread loads and stores its elements, then arrives.
template <typename T, int kMode>
__device__ __forceinline__ void fetch_row(const T* src, T* dst, int p,
                                          uint64_t* bar) {
  const int t = threadIdx.x;
  if constexpr (kMode == kBulk) {
    if (t == 0) {
      const uint32_t bytes = static_cast<uint32_t>(p) * sizeof(T);
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              smem_addr(bar)), "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
          "r"(bytes), "r"(smem_addr(bar)) : "memory");
    }
  } else if constexpr (kMode == kWords) {
    const int words = p * static_cast<int>(sizeof(T)) / 4;
    const uint32_t d = smem_addr(dst);
    const char* s = reinterpret_cast<const char*>(src);
    for (int w = t; w < words; w += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d + 4 * w), "l"(s + 4 * w) : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(bar)) : "memory");
  } else {
    for (int col = t; col < p; col += kThreads) dst[col] = src[col];
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_addr(bar)) : "memory");
  }
}

// The second stage: the first stage leaves c_qi times one unit's column
// sums in scratch[q, unit, :] for every active (realization, unit); this
// sums them over the units in a fixed order.

// A block reduces kCols columns; each column's partials are split kSplit
// ways (block b goes to lane group b % kSplit, in increasing b), and the
// kSplit sums are added in a fixed order: deterministic, and many loads in
// flight instead of one long serial chain a column.
constexpr int kCols = 32, kSplit = 8;

template <typename T>
__global__ void __launch_bounds__(kCols * kSplit)
fused_stage2(const float* __restrict__ scratch,
             const float* __restrict__ masks, T* __restrict__ G, int m,
             int nrb, int p) {
  __shared__ float part[kSplit][kCols];
  const int tx = threadIdx.x % kCols, ty = threadIdx.x / kCols;
  const int q = blockIdx.y;
  const int col = blockIdx.x * kCols + tx;
  const float* mrow = masks + static_cast<size_t>(q) * m;
  const int nblk = m * nrb;
  float acc = 0.f;
  if (col < p) {
    const float* base = scratch + static_cast<size_t>(q) * nblk * p + col;
#pragma unroll 4
    for (int blk = ty; blk < nblk; blk += kSplit)
      if (mrow[blk / nrb] != 0.f) acc += base[static_cast<size_t>(blk) * p];
  }
  part[ty][tx] = acc;
  __syncthreads();
  if (ty == 0 && col < p) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) s += part[j][tx];
    G[static_cast<size_t>(q) * p + col] = repro::from_f32<T>(s);
  }
}

// Launch the second stage over R realizations of width p.
template <typename T>
cudaError_t launch_stage2(const float* scratch, const float* masks, void* G,
                          int R, int m, int nrb, int p, cudaStream_t stream) {
  dim3 grid((p + kCols - 1) / kCols, R);
  fused_stage2<T><<<grid, kCols * kSplit, 0, stream>>>(
      scratch, masks, static_cast<T*>(G), m, nrb, p);
  return cudaGetLastError();
}

}  // namespace
