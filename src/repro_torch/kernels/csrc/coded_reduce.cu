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
// Bound on the H100: memory.  Every element of g is read once and used in
// one multiply-add (2 flops per 4 bytes in float32), far below the card's
// operations-per-byte line.  Design: thread t owns E contiguous columns,
// E = 16 bytes / sizeof(T) (4 in float32, 8 in bfloat16).  When P is a
// multiple of E and both g and out are 16-byte aligned, each row's E
// columns arrive as one 16-byte load (every row start is then aligned too);
// otherwise the same columns are read one at a time, and the last thread's
// ragged tail is masked.  Each thread walks i = 0 .. m-1 in order, so every
// column's sum has one fixed order, whatever the launch.  c is staged in
// shared memory once per block.
#include "hadamard.cuh"

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ g, const float* __restrict__ c,
               T* __restrict__ out, int m, int64_t P) {
  constexpr int E = 16 / sizeof(T);
  extern __shared__ float cs[];
  for (int i = threadIdx.x; i < m; i += blockDim.x) cs[i] = c[i];
  __syncthreads();
  const int64_t col0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * E;
  if (col0 >= P) return;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  if constexpr (kVec) {
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      alignas(16) T v[E];
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(g + i * P + col0);
      const float ci = cs[i];
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(ci, repro::to_f32(v[e]), acc[e]);
    }
    alignas(16) T o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = repro::from_f32<T>(acc[e]);
    *reinterpret_cast<uint4*>(out + col0) = *reinterpret_cast<const uint4*>(o);
  } else {
    const int ncol = P - col0 < E ? static_cast<int>(P - col0) : E;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const T* row = g + i * P + col0;
      const float ci = cs[i];
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (e < ncol) acc[e] = fmaf(ci, repro::to_f32(row[e]), acc[e]);
    }
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
  const int64_t slots = (P + E - 1) / E;
  const int64_t blocks = (slots + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(m) * sizeof(float);
  const void* fn = vec ? reinterpret_cast<const void*>(&combine_kernel<T, true>)
                       : reinterpret_cast<const void*>(&combine_kernel<T, false>);
  cudaError_t err = repro::set_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const T* gt = static_cast<const T*>(g);
  T* ot = static_cast<T*>(out);
  if (vec)
    combine_kernel<T, true><<<static_cast<unsigned>(blocks), kThreads, smem,
                              stream>>>(gt, c, ot, m, P);
  else
    combine_kernel<T, false><<<static_cast<unsigned>(blocks), kThreads, smem,
                               stream>>>(gt, c, ot, m, P);
  return cudaGetLastError();
}

}  // namespace

// g (m, P) contiguous, c (m,) float32, out (P,).  dtype: 0 = float32,
// 1 = bfloat16 (g and out).  Returns cudaGetLastError() after the launch.
extern "C" int repro_coded_combine(const void* g, const void* c, void* out,
                                   int m, int64_t P, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m < 0 || P <= 0 || m > 227 * 1024 / 4) return cudaErrorInvalidValue;
  const float* cf = static_cast<const float*>(c);
  if (dtype == 0) return launch<float>(g, cf, out, m, P, st);
  if (dtype == 1) return launch<__nv_bfloat16>(g, cf, out, m, P, st);
  return cudaErrorInvalidValue;
}
