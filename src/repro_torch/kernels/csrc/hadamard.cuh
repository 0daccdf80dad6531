// Shared device code of the port's Hopper kernels: the Walsh-Hadamard
// butterfly used by fwht.cu and srht.cu, its top stages across a
// thread-block cluster, the bulk copies (TMA) on mbarriers, and the dtype
// conversions.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

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

// All stages of an (R * 512)-point row held as above by 512 threads, R a
// multiple of 16 (R = 16 Q), with one transpose through shared memory in
// place of butterfly()'s four shared-memory stages: the bits of j in
// registers, the lane bits by shuffles, then s[j * 512 + t] = v[j], a
// barrier, and thread t takes back the R elements whose j is in
// [(t >> 5) Q, (t >> 5 + 1) Q) and whose lane is t & 31, so the four warp
// bits of t become register bits for the last four stages.  On return
// register r of thread t holds element t512_pos<R>(r): for each r a
// warp's 32 lanes hold 32 consecutive elements, so stores from registers
// stay coalesced.  s[0, R * 512) is free again once the block has passed a
// barrier (each thread read back its own R addresses, which no other
// thread reads, so it may also write them back without one).
template <int R>
__device__ __forceinline__ int t512_pos(int r) {
  constexpr int Q = R / 16;
  const int t = threadIdx.x;
  return ((t >> 5) * Q + r % Q) * 512 + (r / Q) * 32 + (t & 31);
}

template <int R>
__device__ __forceinline__ void butterfly_t512(float (&v)[R], float* s) {
  static_assert(R % 16 == 0, "butterfly_t512 takes 16 Q values a thread");
  constexpr int Q = R / 16;
  const int t = threadIdx.x, lane = t & 31;
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
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const bool upper = (lane & h) != 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float other = __shfl_xor_sync(0xffffffffu, v[j], h);
      v[j] = upper ? other - v[j] : v[j] + other;
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) s[j * 512 + t] = v[j];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = s[t512_pos<R>(r)];
  // register r = w Q + jb: the warp bits w of the element index
#pragma unroll
  for (int h = Q; h < R; h <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if ((r & h) == 0) {
        const float a = v[r], b = v[r + h];
        v[r] = a + b;
        v[r + h] = a - b;
      }
    }
  }
}

// The local stages of a cluster CTA's `slots` = R * 512 values (R = 16, 32
// or 64), leaving the result in s[0, slots) in order.  The caller's
// cluster barrier follows.
template <int R>
__device__ __forceinline__ void local_stages(float (&v)[R], float* s) {
  butterfly_t512<R>(v, s);
#pragma unroll
  for (int r = 0; r < R; ++r) s[t512_pos<R>(r)] = v[r];
}

// The top log2(C) stages of an (N = C * slots)-point row held by the C CTAs
// of a thread-block cluster, CTA k holding positions [k slots, (k+1) slots)
// in s[0, slots) after its local stages (butterfly() above).  In Sylvester
// order H_N = H_C (x) H_slots, so position c * slots + o of the result is
// H_C applied to the C values at offset o, one from each CTA.  CTA k takes
// the offsets [k slots / C, (k+1) slots / C), reads their C values through
// distributed shared memory, runs the C-point butterfly in registers (its
// stages in the reference's order) and hands each result to
// store(position, value): C contiguous runs of offsets, so stores through
// store() stay coalesced.  The caller passes cluster.sync() before (every
// CTA's local stages done) and after (no CTA exits while its shared memory
// is read).
constexpr int kMaxCluster = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of local shared address `a` in CTA `rank`
// of this cluster (volatile: recomputed at each use rather than held in a
// register a rank).
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

template <typename Store>
__device__ __forceinline__ void cluster_stage(float* s, int slots,
                                              Store store) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  const int per = slots / C;
  for (int o = k * per + static_cast<int>(threadIdx.x); o < (k + 1) * per;
       o += blockDim.x) {
    const uint32_t a = smem_u32(s + o);
    float u[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C) u[c] = ld_cluster(cluster_addr(a, c));
#pragma unroll
    for (int h = 1; h < kMaxCluster; h <<= 1) {
      if (h < C) {
#pragma unroll
        for (int c = 0; c < kMaxCluster; ++c) {
          if (c < C && (c & h) == 0) {
            const float x = u[c], y = u[c + h];
            u[c] = x + y;
            u[c + h] = x - y;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < C) store(c * slots + o, u[c]);
  }
}

// Bulk copies (TMA) into shared memory, completing on an mbarrier.

// Thread 0 only: an mbarrier that one arrival (with its bytes) completes;
// the block must pass a barrier before any thread waits on it.
__device__ __forceinline__ void mbar_init1(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Thread 0 only: copy `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory; completes a phase of bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// Threads per block for an n-point row: at most 512, so R = n / T values a
// thread stays at or below 64 registers for the largest one-pass row.
inline int butterfly_threads(int n) { return n <= 512 ? n : 512; }

// Launch kernel fn on `blocks` blocks of `threads`, in clusters of C blocks
// along x.  Returns the launch's error: a cluster size the card refuses, or
// one whose blocks do not fit an SM, is reported, not worked around.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*fn)(Params...), int64_t blocks, int threads,
                           size_t smem, int C, cudaStream_t stream,
                           Args... args) {
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fn, args...);
  if (err != cudaSuccess) {
    cudaGetLastError();               // clear it: the caller reports it
    return err;
  }
  return cudaGetLastError();
}

// The current device's SM count, asked of the runtime once a device.
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  int v = known[dev].load(std::memory_order_relaxed);
  if (v == 0) {
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    known[dev].store(v, std::memory_order_relaxed);
  }
  *sms = v;
  return cudaSuccess;
}

// Let kernel fn take `bytes` of dynamic shared memory on the current
// device.  The runtime is asked only for more than the most set before for
// this (device, kernel), so a launch at a known size makes no runtime call.
inline cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, size_t> most;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::pair<int, const void*> key(dev, fn);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = most.find(key);
    if (it != most.end() && it->second >= bytes) return cudaSuccess;
  }
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  size_t& known = most[key];
  if (bytes > known) known = bytes;
  return cudaSuccess;
}

}  // namespace repro
