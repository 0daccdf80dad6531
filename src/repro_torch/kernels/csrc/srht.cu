// Matrix-free SRHT encode (paper §4.2.2):  rows [lo, hi) of
//     S X = H_N[:, cols] diag(signs) X / sqrt(n)
// for data X (n, p), computed one data column at a time as
//     out[c, :] = FWHT_N(scatter(xt[c, :] * signs, cols))[lo:hi] * scale
// with xt = X^T (p, n), float32, and signs of +-1.
//
// Replaces the TPU kernel src/repro/kernels/encode.py (_srht_body, launched
// by srht_encode_call) together with the XLA scatter in front of it
// (src/repro/kernels/ops.py srht_encode): sign-flip, all log2(N) butterfly
// stages and the row window in one pass.
//
// Bound on the H100: memory.  Per data column it reads n values and writes
// hi - lo values, against 0.5 N log2(N) add/sub pairs - below the card's
// operations-per-byte line.  Each route below reads a column once and
// writes its window once; the wrapper (kernels/encode.py srht_plan) picks
// the route from the shapes alone, so a column's result never depends on
// how many columns share the call.
//
// The signed slot map (smap, N int32, built once per (cols, signs) by the
// wrapper, kernels/encode.py srht_signed_slot_map, and passed in): slot j
// holds (d << 1) | (signs[d] < 0) for the data index d with cols[d] = j,
// -1 where empty.  A slot's value is then one coalesced map read and one
// read of the column, with no separate random read of signs.  The one-pass,
// pruned and passes routes gather through it; the cluster route reads
// (cols, signs) in data order instead.  The signs are +-1 (the map's
// builder rejects any other value), so a route that keeps only the sign
// bit and one that multiplies by signs[d] agree bit for bit.
//
// one-pass (N <= 8192, the window not pruned; srht_onepass): persistent
// blocks walk the columns.  Thread t holds slots j * T + t (the butterfly
// layout of hadamard.cuh), the same for every column, so it loads their R
// map entries into registers once.  A column's contiguous data row is
// staged in shared memory by a bulk copy (TMA) on an mbarrier while the
// block transforms the previous column (two buffers), and each thread
// gathers its slots from the staged row into registers: no zero-fill, no
// scatter, no barrier between load and transform.  Then the butterfly and
// the window store, coalesced.
//
// pruned (a window inside an aligned block [b r', (b+1) r') with
// r' < N, r' <= 32768; srht_pruned): in Sylvester order
// H_N = H_{N/r'} (x) H_{r'}, so
//     out = H_{r'}( sum_q (-1)^popcount(b & q) z_q )[lo - b r' : hi - b r']
// with z_q the q-th r'-slot chunk of the signed, scattered column.  One
// block a column sums the N / r' chunks slot by slot in q order through
// the map, and transforms r' points: one read of the column, an r'-point
// transform and a write of the window, where the frame route does all of
// N.
//
// cluster (8192 < N <= 2^18, the window not pruned; srht_cluster): the C
// CTAs of a thread-block cluster hold the N slots of one column, N / C
// each.  Each zero-fills its slots; after a cluster barrier each reads its
// 1/C share of the column and of (cols, signs), coalesced, and stores each
// signed value into its owner's slot through distributed shared memory;
// after a second barrier each runs the stages below N / C, and the top
// log2(C) stages read across the cluster and store only [lo, hi), scaled
// (hadamard.cuh cluster_stage).  The random remote stores, a network
// transaction each, bound this route.
//
// passes (N > 2^18, the window not pruned): the split of fwht.cu,
// N = N1 * N2 with N2 = 32768.  Pass 1 (srht_segment_kernel) takes one
// contiguous segment of N2 slots of one data column a block and folds the
// sign flip and the scatter into its load through the signed slot map.
// The later passes are fwht.cu's strided passes; the last applies the
// scale and the row window in its store.  The wrapper runs them in place
// on the output for the full window, and for a partial window through a
// float32 intermediate of at most 1 GiB, a chunk of data columns at a
// time.
#include "hadamard.cuh"

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 512;

// The signed value of map entry e from the column row src: 0 when empty.
__device__ __forceinline__ float signed_value(const float* src, int e) {
  if (e < 0) return 0.f;
  const float a = src[e >> 1];
  return (e & 1) ? -a : a;
}

// one-pass: dynamic shared memory s[N] (the butterfly), then two staging
// buffers of `stride` floats (kBulk).  At N = 8192 (R = 16, 512 threads)
// the butterfly is hadamard.cuh's butterfly_t512.
template <int R, bool kBulk>
__global__ void __launch_bounds__(kThreads)
srht_onepass(const float* __restrict__ xt, const int* __restrict__ smap,
             float* __restrict__ out, int rows, int n_in, int N, int lo,
             int hi, float scale, int stride) {
  extern __shared__ __align__(16) float sm[];
  __shared__ __align__(8) uint64_t full[2];
  const int T = blockDim.x, t = threadIdx.x;
  float* s = sm;
  float* buf = sm + N;
  int e[R];
#pragma unroll
  for (int j = 0; j < R; ++j) e[j] = smap[j * T + t];
  if constexpr (kBulk) {
    if (t == 0) {
      repro::mbar_init1(&full[0]);
      repro::mbar_init1(&full[1]);
    }
    __syncthreads();
    if (t == 0 && static_cast<int>(blockIdx.x) < rows)
      repro::bulk_load(buf, xt + static_cast<size_t>(blockIdx.x) * n_in,
                       n_in * 4u, &full[0]);
  }
  const int w = hi - lo;
  int it = 0;
  for (int c = blockIdx.x; c < rows; c += gridDim.x, ++it) {
    const float* src;
    if constexpr (kBulk) {
      // the other buffer was last read in the previous column, which every
      // thread left behind at its closing barrier
      const int b = it & 1, next = c + gridDim.x;
      if (t == 0 && next < rows)
        repro::bulk_load(buf + (b ^ 1) * stride,
                         xt + static_cast<size_t>(next) * n_in, n_in * 4u,
                         &full[b ^ 1]);
      repro::mbar_wait(&full[b], (it >> 1) & 1);
      src = buf + b * stride;
    } else {
      src = xt + static_cast<size_t>(c) * n_in;
    }
    float v[R];
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = signed_value(src, e[j]);
    float* orow = out + static_cast<size_t>(c) * w;
    if constexpr (R == 16) {
      // N = 8192 (512 threads): the window straight from registers
      repro::butterfly_t512<16>(v, s);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int i = repro::t512_pos<16>(r);
        if (i >= lo && i < hi) orow[i - lo] = v[r] * scale;
      }
    } else {
      repro::butterfly<R>(v, s);
      for (int i = t; i < w; i += T) orow[i] = s[lo + i] * scale;
    }
    __syncthreads();                   // s is rewritten by the next column
  }
}

// pruned: dynamic shared memory s[rp] (the butterfly).  A thread sums its
// R slots over q = 0 .. N / rp - 1 in that order, gathering from device
// memory with 8 map reads in flight (each gather's address takes
// registers).  Staging the column in shared memory by a bulk copy first
// was slower at the main path's window, where 6001 columns keep every SM
// busy (PERF.md).
template <int R>
__global__ void __launch_bounds__(kThreads)
srht_pruned(const float* __restrict__ xt, const int* __restrict__ smap,
            float* __restrict__ out, int n_in, int N, int rp, int b, int lo,
            int hi, float scale) {
  constexpr int U = R >= 8 ? 1 : 8 / R;
  extern __shared__ __align__(16) float s[];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* src = xt + row * n_in;
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = 0.f;
  const int Q = N / rp;
  for (int q0 = 0; q0 < Q; q0 += U) {
    if constexpr (U == 1) {
      const bool flip = __popc(b & q0) & 1;
      const int* mp = smap + static_cast<size_t>(q0) * rp;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float a = signed_value(src, mp[j * kThreads + t]);
        v[j] += flip ? -a : a;
      }
    } else {
      // U steps of q at a time: their map reads are in flight together
      int e[U][R];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int* mp = smap + static_cast<size_t>(q0 + u) * rp;
#pragma unroll
        for (int j = 0; j < R; ++j)
          e[u][j] = q0 + u < Q ? mp[j * kThreads + t] : -1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool flip = __popc(b & (q0 + u)) & 1;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float a = signed_value(src, e[u][j]);
          v[j] += flip ? -a : a;
        }
      }
    }
  }
  repro::butterfly<R>(v, s);
  const int w = hi - lo, off = lo - b * rp;
  float* orow = out + row * w;
  for (int i = t; i < w; i += kThreads) orow[i] = s[off + i] * scale;
}

// cluster: dynamic shared memory s[slots], slots = R * kThreads.  Each CTA
// zero-fills its slots; after a cluster barrier it reads its 1/C share of
// the column and of (cols, signs), coalesced, and stores each signed value
// into its owner's slot through distributed shared memory, a store a value
// (two forms without the random remote stores took longer, PERF.md: a
// partition by owner so that owners read contiguous runs, and the whole
// column in every CTA by one multicast bulk copy with a local gather);
// after a second barrier it runs its local stages.
template <int R>
__global__ void __launch_bounds__(kThreads)
srht_cluster(const float* __restrict__ xt, const int* __restrict__ cols,
             const float* __restrict__ signs, float* __restrict__ out,
             int n_in, int lo, int hi, float scale) {
  extern __shared__ float s[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int k = static_cast<int>(cluster.block_rank());
  constexpr int slots = R * kThreads;
  const int t = threadIdx.x;
  const size_t row = blockIdx.x / C;
  for (int i = t; i < slots; i += kThreads) s[i] = 0.f;
  cluster.sync();
  const int share = (n_in + C - 1) / C;
  const int d0 = k * share, d1 = min(n_in, d0 + share);
  const float* xr = xt + row * n_in;
  const uint32_t s0 = repro::smem_u32(s);
  for (int d = d0 + t; d < d1; d += kThreads) {
    const int slot = cols[d], owner = slot / slots;
    const float val = xr[d] * signs[d];
    if (owner == k)
      s[slot % slots] = val;
    else
      repro::st_cluster(repro::cluster_addr(s0 + 4u * (slot % slots), owner),
                        val);
  }
  cluster.sync();
  float v[R];
  // thread t reads exactly the slots it writes back first in local_stages()
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = s[j * kThreads + t];
  repro::local_stages<R>(v, s);
  cluster.sync();
  float* orow = out + row * (hi - lo);
  repro::cluster_stage(s, slots, [&](int pos, float val) {
    if (pos >= lo && pos < hi) orow[pos - lo] = val * scale;
  });
  cluster.sync();
}

template <int R, bool kBulk>
cudaError_t launch_onepass(const float* xt, const int* smap, float* out,
                           int rows, int n_in, int N, int lo, int hi,
                           float scale, cudaStream_t stream) {
  auto* fn = &srht_onepass<R, kBulk>;
  const int threads = N / R;
  const int stride = (n_in + 3) / 4 * 4;
  const size_t smem = (static_cast<size_t>(N) + (kBulk ? 2 * stride : 0)) *
                      sizeof(float);
  cudaError_t err = repro::set_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return err;
  // blocks an SM at this shared memory, asked of the runtime once a
  // (kernel, shared memory) and kept: (smem << 8) | blocks
  static std::atomic<uint64_t> occupancy{0};
  uint64_t known = occupancy.load(std::memory_order_relaxed);
  if (known >> 8 != smem) {
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, threads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1 || per_sm > 255) return cudaErrorInvalidConfiguration;
    known = (static_cast<uint64_t>(smem) << 8) | static_cast<uint64_t>(per_sm);
    occupancy.store(known, std::memory_order_relaxed);
  }
  int sms = 0;
  if ((err = repro::sm_count(&sms)) != cudaSuccess) return err;
  const int64_t most = static_cast<int64_t>(known & 0xff) * sms;
  const int blocks = static_cast<int>(rows < most ? rows : most);
  srht_onepass<R, kBulk><<<blocks, threads, smem, stream>>>(
      xt, smap, out, rows, n_in, N, lo, hi, scale, stride);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_pruned(const float* xt, const int* smap, float* out,
                          int rows, int n_in, int N, int rp, int b, int lo,
                          int hi, float scale, cudaStream_t stream) {
  auto* fn = &srht_pruned<R>;
  const size_t smem = static_cast<size_t>(rp) * sizeof(float);
  cudaError_t err = repro::set_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return err;
  srht_pruned<R><<<rows, kThreads, smem, stream>>>(xt, smap, out, n_in, N,
                                                   rp, b, lo, hi, scale);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_srht_cluster(const float* xt, const int* cols,
                                const float* signs, float* out, int rows,
                                int n_in, int C, int lo, int hi, float scale,
                                cudaStream_t stream) {
  auto* fn = &srht_cluster<R>;
  const size_t smem = static_cast<size_t>(R) * kThreads * sizeof(float);
  cudaError_t err = repro::set_smem(reinterpret_cast<const void*>(fn), smem);
  if (err != cudaSuccess) return err;
  return repro::launch_cluster(fn, static_cast<int64_t>(rows) * C, kThreads,
                               smem, C, stream, xt, cols, signs, out, n_in,
                               lo, hi, scale);
}

// Pass 1 of the multi-pass encode: block b is segment a = b % (N / seg) of
// data column b / (N / seg); its seg slots are gathered through the signed
// slot map, transformed (the stages h < seg) and written unscaled to out
// (rows, N).
template <int R>
__global__ void srht_segment_kernel(const float* __restrict__ xt,
                                    const int* __restrict__ smap,
                                    float* __restrict__ out, int n_in,
                                    int64_t N, int seg) {
  extern __shared__ float s[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int64_t nseg = N / seg;
  const int64_t row = blockIdx.x / nseg, a = blockIdx.x % nseg;
  const float* xr = xt + row * n_in;
  const int* mp = smap + a * seg;
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = signed_value(xr, mp[j * nt + t]);
  repro::butterfly<R>(v, s);
  float* orow = out + row * N + a * seg;
  for (int i = t; i < seg; i += nt) orow[i] = s[i];
}

template <int R>
cudaError_t launch_segments(const float* xt, const int* smap, float* out,
                            int64_t blocks, int n_in, int64_t N, int seg,
                            cudaStream_t stream) {
  const int threads = seg / R;
  const size_t smem = static_cast<size_t>(seg) * sizeof(float);
  cudaError_t err = repro::set_smem(
      reinterpret_cast<const void*>(&srht_segment_kernel<R>), smem);
  if (err != cudaSuccess) return err;
  srht_segment_kernel<R><<<static_cast<unsigned>(blocks), threads, smem,
                           stream>>>(xt, smap, out, n_in, N, seg);
  return cudaGetLastError();
}

}  // namespace


// The one-pass route over `rows` data columns: N a power of two up to 8192;
// smap (N int32) the signed slot map of (cols, signs); bulk = 1 stages each
// column with a bulk copy (n_in a multiple of 4 and xt 16-byte aligned), 0
// gathers from device memory.  Returns the launch's error (0 on success).
extern "C" int repro_srht_onepass(const void* xt, const void* smap,
                                  void* out, int rows, int n_in, int N,
                                  int lo, int hi, float scale, int bulk,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || N <= 0 || (N & (N - 1)) || N > 8192 || n_in > N ||
      n_in < 1 || lo < 0 || hi > N || lo >= hi || (bulk && n_in % 4))
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xt);
  const int* m = static_cast<const int*>(smap);
  float* o = static_cast<float*>(out);
#define REPRO_ONEPASS(R)                                                    \
  return bulk ? launch_onepass<R, true>(x, m, o, rows, n_in, N, lo, hi,     \
                                        scale, st)                          \
              : launch_onepass<R, false>(x, m, o, rows, n_in, N, lo, hi,    \
                                         scale, st)
  switch (N / repro::butterfly_threads(N)) {
    case 1: REPRO_ONEPASS(1);
    case 2: REPRO_ONEPASS(2);
    case 4: REPRO_ONEPASS(4);
    case 8: REPRO_ONEPASS(8);
    case 16: REPRO_ONEPASS(16);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ONEPASS
}

// The pruned route: rows [lo, hi) inside the aligned block [b rp, (b+1) rp)
// of N, rp a power of two from 512 to 32768 below N; smap (N int32) the
// signed slot map.  Returns the launch's error (0 on success).
extern "C" int repro_srht_pruned(const void* xt, const void* smap, void* out,
                                 int rows, int n_in, int N, int rp, int b,
                                 int lo, int hi, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || N <= 0 || (N & (N - 1)) || n_in > N || n_in < 1 ||
      rp < kThreads || rp > 32768 || (rp & (rp - 1)) || rp >= N || b < 0 ||
      b >= N / rp || lo < b * rp || hi > (b + 1) * rp || lo >= hi)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xt);
  const int* m = static_cast<const int*>(smap);
  float* o = static_cast<float*>(out);
#define REPRO_PRUNED(R)                                                     \
  return launch_pruned<R>(x, m, o, rows, n_in, N, rp, b, lo, hi, scale, st)
  switch (rp / kThreads) {
    case 1: REPRO_PRUNED(1);
    case 2: REPRO_PRUNED(2);
    case 4: REPRO_PRUNED(4);
    case 8: REPRO_PRUNED(8);
    case 16: REPRO_PRUNED(16);
    case 32: REPRO_PRUNED(32);
    case 64: REPRO_PRUNED(64);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PRUNED
}

// The cluster route: N = C * slots, slots (the slots a CTA) one of 8192,
// 16384, 32768 and C a power of two from 2 to 16 (above 8 the launch is
// refused); rows [lo, hi) of each column, times scale, to out (rows,
// hi - lo).  Returns the launch's error (0 on success).
extern "C" int repro_srht_cluster(const void* xt, const void* cols,
                                  const void* signs, void* out, int rows,
                                  int n_in, int N, int C, int lo, int hi,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || N <= 0 || (N & (N - 1)) || n_in > N || n_in < 1 ||
      C < 2 || C > repro::kMaxCluster || (C & (C - 1)) || N % C || lo < 0 ||
      hi > N || lo >= hi)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xt);
  const int* c = static_cast<const int*>(cols);
  const float* sg = static_cast<const float*>(signs);
  float* o = static_cast<float*>(out);
  switch (N / C) {
    case 8192:
      return launch_srht_cluster<16>(x, c, sg, o, rows, n_in, C, lo, hi,
                                     scale, st);
    case 16384:
      return launch_srht_cluster<32>(x, c, sg, o, rows, n_in, C, lo, hi,
                                     scale, st);
    case 32768:
      return launch_srht_cluster<64>(x, c, sg, o, rows, n_in, C, lo, hi,
                                     scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 1 of the multi-pass encode over `rows` data columns: segments of
// seg = 32768 slots of the N-slot frame, N a power of two above seg,
// through the signed slot map smap (N int32), to out (rows, N) float32,
// unscaled.  Returns the launch's error (0 on success).
extern "C" int repro_srht_segments(const void* xt, const void* smap,
                                   void* out, int rows, int n_in, int64_t N,
                                   int seg, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || seg != 32768 || N <= seg || (N & (N - 1)) || n_in > N)
    return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>(rows) * (N / seg);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_segments<32768 / 512>(
      static_cast<const float*>(xt), static_cast<const int*>(smap),
      static_cast<float*>(out), blocks, n_in, N, seg, st);
}
