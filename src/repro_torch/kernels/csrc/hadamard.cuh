// Shared device code of the port's Hopper kernels: the Walsh-Hadamard
// butterfly used by fwht.cu and srht.cu, and the dtype conversions.
//
// Layout: an N-point row (N a power of two, N <= 32768) is held by the T
// threads of one block, R = N / T values each; element i = j * T + t lives
// in register j of thread t.  Each butterfly stage acts on one bit of i and
// the stages commute, so they run in the order the layout makes cheapest:
//   bits of j  (strides T, 2T, ..., (R/2)T) - in registers, no traffic;
//   bits 0-4 of t (strides 1 .. 16)          - warp shuffles, no barrier;
//   bits 5.. of t (strides 32 .. T/2)        - shared memory + __syncthreads.
// Global loads and stores touch x[j * T + t]: neighbouring threads hit
// neighbouring addresses, so every access is coalesced.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// All log2(N) unnormalised butterfly stages over the row held in v (layout
// above).  On return the transformed row is in s[0, N), and the block has
// passed a barrier after the last write, so any thread may read any slot.
template <int R>
__device__ __forceinline__ void butterfly(float (&v)[R], float* s) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
#pragma unroll
  for (int h = 1; h < R; h <<= 1) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if ((j & h) == 0) {
        const float a = v[j], b = v[j + h];
        v[j] = a + b;
        v[j + h] = a - b;
      }
    }
  }
  const int lanes = T < 32 ? T : 32;
  const unsigned mask = T < 32 ? ((1u << T) - 1u) : 0xffffffffu;
  const int lane = t & 31;
  for (int h = 1; h < lanes; h <<= 1) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float other = __shfl_xor_sync(mask, v[j], h);
      v[j] = upper ? other - v[j] : v[j] + other;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) s[j * T + t] = v[j];
  __syncthreads();
  const int half = R * T / 2;
  for (int h = 32; h < T; h <<= 1) {
    for (int q = t; q < half; q += T) {
      const int i = (q & ~(h - 1)) * 2 + (q & (h - 1));
      const float a = s[i], b = s[i + h];
      s[i] = a + b;
      s[i + h] = a - b;
    }
    __syncthreads();
  }
}

// Threads per block for an n-point row: at most 512, so R = n / T values a
// thread stays at or below 64 registers for the largest one-pass row.
inline int butterfly_threads(int n) { return n <= 512 ? n : 512; }

inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace repro
