// The fused masked gradient's column-split form, for rows wider than the
// first form's registers (p > 16384):
//     G[q] = sum_i c_qi (S_i X)^T (S_i X W[q] - S_i y),
//     c_qi = mask_qi * (m / k_q) / (n beta),  k_q = max(sum_i mask_qi, 1),
// summed in float32; SX (m, r, p), Sy (m, r), W (R, p) in float32 or
// bfloat16, masks (R, m) float32 -> G (R, p) in W's dtype.  Replaces the
// TPU kernel src/repro/kernels/fused_step.py (_fused_body) past the width
// whose row one thread block holds in registers (fused_step.cu).
//
// The TPU kernel reads each row block of S X once: the residual u and the
// gradient come from the same VMEM tile.  A 400 KB row (p = 100 000 in
// float32) fits no single SM, so here a thread-block cluster holds it:
//   route "cluster" - the C = 8 CTAs of a cluster each own one column slice
//             of every row (slices of S columns, S a multiple of 16 bytes,
//             the last CTA taking the rest of p).  A cluster walks a list
//             of units (a unit: one worker's bw rows) as one stream of
//             rows; each CTA keeps a ring of 3-8 slices in shared memory,
//             filled by 1D bulk copies (TMA) completing on an mbarrier
//             (4-byte cp.async copies, or plain loads, where a row is not
//             whole aligned 16-byte units).  For row k a CTA reduces its
//             slice's share of SX_k . W[q] (the thread's columns in order,
//             a shuffle tree, the warps' sums in order) and pushes it into
//             row k's share slot of every CTA of the cluster (mapa +
//             st.async, which completes 4 bytes of that CTA's mbarrier for
//             the slot).  Then it takes row k - 1: it waits on that row's
//             share barrier (acquire, cluster scope), sums the C shares in
//             rank order, so u_q,k-1 is the same float in every CTA, and
//             adds the row into its accumulators, acc_q += u_q,k-1
//             SX_k-1[slice], from the slice still in shared memory, whose
//             slot then takes the next row.  No CTA waits for a whole
//             cluster barrier a row: only for the shares it needs, one row
//             after it pushed its own.  At a unit's end each CTA writes
//             c_qi acc_q to scratch[q, unit, slice].  A CTA holds its
//             tile's iterates and accumulators in registers (4 NV columns
//             a thread of 256), so RT, the realizations of a tile, is the
//             largest of 4, 2, 1 with 2 * 4 NV * RT <= 208 registers.
//   route "two-read" - past the cluster's capacity (a ring of three slices
//             must fit one CTA's shared memory and NV <= 19: about p =
//             152 896 in float32, 155 648 in bfloat16) the earlier form:
//             wide_residual (the rows' dot products by column chunks of
//             4096 into partial[q, i, k, chunk]), then wide_gradient (u
//             from the chunk sums in chunk order, the gradient by column
//             tiles of 1024), reading the active S X twice.
// Both end in the shared second stage (fused_common.cuh), which sums
// scratch over the units in a fixed order.  The route, C, S, NV, RT and the
// ring depth depend on p and the dtype alone (repro_fused_wide_plan), and a
// realization's operations on neither R nor its place in a tile nor the
// cluster that takes a unit, so a batched call gives, bit for bit, the rows
// of R single calls.  A worker masked out in every realization of a tile is
// in no unit list of the tile (its clusters never read its rows), a
// masked-out realization in an active unit writes no scratch, and an
// all-zero mask gives exactly 0.
//
// Bytes read on the cluster route, a tile: each active row of S X once
// (4p a row in float32, 2p in bfloat16), Sy of the active rows, the tile's
// iterates once a CTA (from L2), the masks; written: one float32 p-row of
// scratch an active (realization, unit), 1/bw of the rows' float32 bytes a
// realization, read back once by the second stage.  A single call (the
// coded runners' step) reads S X's active rows once; a call of R > RT
// realizations runs ceil(R / RT) tiles, each reading its own active rows
// (numbering the units over the whole call, so that the tiles' clusters
// walk the same rows side by side, gained nothing from the L2: PERF.md).
// Bound: memory.  For a tile the product does about 4 RT flops an element;
// at RT <= 4 that stays below the card's float32 line (about 20 flops a
// byte), so float32 FMAs on the CUDA cores suffice and tensor cores would
// add only TF32's error.  What held the first version back (PERF.md): a
// barrier.cluster a row, which the share barriers replaced.
#include "fused_common.cuh"

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kC = 8;                     // CTAs a cluster: the portable max
constexpr int kVec = 4;                   // columns a thread reads at once
// vectors of 4 columns a thread holds for one slice (NV): a slice of S
// columns takes the smallest listed NV with NV * 4 * kThreads >= S
constexpr int kVectors[] = {3, 4, 6, 8, 10, 13, 16, 19};
constexpr int kRegBudget = 208;           // 2 * 4 NV * RT: iterates + sums
constexpr int kMaxTile = 4;
constexpr int kMinSlots = 3;              // the dot's row, the gradient's, one
constexpr int kMaxSlots = 8;              // ... in flight
// share slots a CTA: a peer pushes row j's shares only after it has this
// CTA's share of row j - 2, which this CTA pushes after reading row j - 4's
// shares and re-arming that slot for row j, so four slots are never
// overwritten unread
constexpr int kShareSlots = 4;
constexpr int kMaxWideRows = 64;          // rows of a unit

enum Route { kTwoRead = 0, kCluster = 1 };

__host__ __device__ constexpr int tile_for(int nv) {
  for (int rt = kMaxTile; rt > 1; rt >>= 1)
    if (2 * kVec * nv * rt <= kRegBudget) return rt;
  return 1;
}

// the static shared memory of fused_wide_cluster stays within its share
static_assert(2 * kMaxTile * kWarps * 4 + kShareSlots * kC * kMaxTile * 4 +
                  kMaxTile * 4 + (kMaxUnits + kWarps) * 4 +
                  (kMaxSlots + kShareSlots) * 8 <=
              227 * 1024 - kSmemBudget,
              "static shared memory of the cluster route over its share");

// How a width p of itemsize bytes an element is taken; from p and the
// dtype alone, never R.
struct WidePlan {
  int route = kTwoRead;
  int C = 1;                              // CTAs a row
  int S = 0;                              // columns a slice (not the last)
  int threads = kThreads;
  int nv = 0;                             // vectors of 4 columns a thread
  int rt = kMaxTile;                      // realizations a tile
  int slots = 0;                          // ring depth a CTA
};

inline WidePlan wide_plan(int p, int itemsize) {
  WidePlan pl;
  if (p <= kMaxCols || (itemsize != 4 && itemsize != 2)) return pl;
  const int align = 16 / itemsize;        // columns of 16 bytes
  const int per = (p + kC - 1) / kC;
  const int S = (per + align - 1) / align * align;
  const int need = (S + kVec * kThreads - 1) / (kVec * kThreads);
  int nv = 0;
  for (int v : kVectors)
    if (need <= v) {
      nv = v;
      break;
    }
  int slots = kSmemBudget / (S * itemsize);
  if (slots > kMaxSlots) slots = kMaxSlots;
  if (nv == 0 || slots < kMinSlots) return pl;
  pl.route = kCluster;
  pl.C = kC;
  pl.S = S;
  pl.nv = nv;
  pl.rt = tile_for(nv);
  pl.slots = slots;
  return pl;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Thread 0 only: arm the current phase of bar for `bytes` of pushes.
__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

// Store v at shared::cluster address `dst` of a peer CTA (or this one),
// completing 4 bytes of the peer's mbarrier at shared::cluster `bar`.
__device__ __forceinline__ void push_share(uint32_t dst, float v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// Wait for the phase of parity `parity` of a share barrier: the peers'
// pushes are then visible (acquire at cluster scope).
__device__ __forceinline__ void wait_shares(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT_SHARES:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra SHARES_DONE;\n"
      "bra WAIT_SHARES;\n"
      "SHARES_DONE:\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ int cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// A CTA's slice of one row (`width` elements at src) into ring slot dst,
// by the copy mode the launch chose.
template <typename T>
__device__ __forceinline__ void fetch_slice(int mode, const T* src, T* dst,
                                            int width, uint64_t* bar) {
  if (mode == kBulk)
    fetch_row<T, kBulk>(src, dst, width, bar);
  else if (mode == kWords)
    fetch_row<T, kWords>(src, dst, width, bar);
  else
    fetch_row<T, kPlain>(src, dst, width, bar);
}

// Columns idx .. idx + 3 of a staged slice as float32, those at or past
// `width` as 0 (idx is a multiple of 4, and the slot holds S >= width
// columns, S a multiple of 4, so the read stays inside it).
__device__ __forceinline__ void load4(const float* s, int idx, int width,
                                      float (&v)[4]) {
  if (idx < width) {
    const float4 f = *reinterpret_cast<const float4*>(s + idx);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
#pragma unroll
  for (int e = 1; e < kVec; ++e)
    if (idx + e >= width) v[e] = 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* s, int idx,
                                      int width, float (&v)[4]) {
  if (idx < width) {
    const uint2 raw = *reinterpret_cast<const uint2*>(s + idx);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    v[0] = __low2float(a), v[1] = __high2float(a);
    v[2] = __low2float(b), v[3] = __high2float(b);
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
#pragma unroll
  for (int e = 1; e < kVec; ++e)
    if (idx + e >= width) v[e] = 0.f;
}

// The cluster route (header).  Grid: ntiles * per_tile clusters of kC
// CTAs; cluster number g takes tile g % ntiles and, of that tile's units
// (workers active in some realization of the tile, ranked on the device,
// each with its r / bw units in order), the units a with a % per_tile ==
// g / ntiles.  Thread t of the CTA of rank c holds the slice columns
// (v kThreads + t) 4 + e, v < NV, e < 4: column c S + that.  Dynamic shared
// memory: `slots` ring slots of S elements.
template <typename T, int NV, int RT>
__global__ void __launch_bounds__(kThreads, 1)
fused_wide_cluster(const T* __restrict__ SX, const T* __restrict__ Sy,
                   const T* __restrict__ W, const float* __restrict__ masks,
                   float* __restrict__ scratch, int R, int m, int r, int p,
                   int bw, int S, int nbuf, int mode, int per_tile,
                   float nbeta) {
  constexpr int NE = NV * kVec;
  constexpr uint32_t kShareBytes = kC * RT * sizeof(float);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][RT][kWarps];      // a row's warp sums, by parity
  __shared__ float shares[kShareSlots][kC][RT];  // the cluster's shares
  __shared__ float mk[RT];                  // m / k_q of the tile
  __shared__ int units[kMaxUnits];
  __shared__ int count[kWarps];
  __shared__ __align__(8) uint64_t full[kMaxSlots];
  __shared__ __align__(8) uint64_t got[kShareSlots];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rank = cta_rank();
  const int g = blockIdx.x / kC;
  const int ntiles = (R + RT - 1) / RT;
  const int tile = g % ntiles, c = g / ntiles;
  const int q0 = tile * RT;
  const int nq = R - q0 < RT ? R - q0 : RT;
  const int c0 = rank * S;
  const int width = rank == kC - 1 ? p - c0 : S;
  const int nrb = r / bw;

  // this cluster's units, from the ranks of the tile's active workers (the
  // same list in every CTA of the cluster)
  int active = 0;
  for (int i0 = 0; i0 < m; i0 += kThreads) {
    const int i = i0 + t;
    bool on = false;
    for (int q = 0; q < nq && i < m; ++q)
      on = on || masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) count[warp] = __popc(ballot);
    __syncthreads();
    int rk = active + __popc(ballot & ((1u << lane) - 1u));
    for (int v = 0; v < kWarps; ++v) {
      if (v < warp) rk += count[v];
      active += count[v];
    }
    if (on) {
      for (int jb = 0; jb < nrb; ++jb) {
        const int a = rk * nrb + jb;
        if (a % per_tile == c) units[a / per_tile] = i * nrb + jb;
      }
    }
    __syncthreads();                        // count is rewritten next chunk
  }
  const int nall = active * nrb;
  const int nunits = c < nall ? (nall - c + per_tile - 1) / per_tile : 0;
  if (nunits == 0) return;                  // the whole cluster: no row read
  const int nrows = nunits * bw;
  auto row_src = [&](int s) {               // this CTA's slice of row s
    return SX + (static_cast<size_t>(units[s / bw]) * bw + s % bw) * p + c0;
  };
  auto slot = [&](int s) {
    return reinterpret_cast<T*>(smem) + static_cast<size_t>(s % nbuf) * S;
  };

  // the ring's barriers, and the share barriers armed for the first rows:
  // row j's completes when the C CTAs' kShareBytes have landed
  if (t == 0) {
    for (int b = 0; b < nbuf; ++b)
      mbar_init(&full[b], mode == kBulk ? 1 : kThreads);
    for (int b = 0; b < kShareSlots; ++b) {
      mbar_init(&got[b], 1);
      if (b < nrows) expect_bytes(&got[b], kShareBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ahead = nbuf < nrows ? nbuf : nrows;
  for (int s = 0; s < ahead; ++s)
    fetch_slice<T>(mode, row_src(s), slot(s), width, &full[s]);
  // every CTA of the cluster has started and armed its share barriers
  // before any pushes into another
  cluster_arrive();

  // the tile's iterates over this slice, and the decode scales (k_q sums
  // the masks in the reference's order), while the first rows land
  float w[RT][NE];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int idx = (v * kThreads + t) * kVec + e;
        w[q][v * kVec + e] = q < nq && idx < width
            ? repro::to_f32(W[static_cast<size_t>(q0 + q) * p + c0 + idx])
            : 0.f;
      }
  if (t < nq) {
    const float* mrow = masks + static_cast<size_t>(q0 + t) * m;
    float k = 0.f;
    for (int a = 0; a < m; ++a) k += mrow[a];
    mk[t] = static_cast<float>(m) / fmaxf(k, 1.f);
  }
  __syncthreads();
  cluster_wait();

  float acc[RT][NE];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[q][j] = 0.f;
  bool act[RT], pact[RT];                   // row s's unit, row s - 1's
  int unit = 0, punit = 0;
  float syk = 0.f, psyk = 0.f;
#pragma unroll
  for (int q = 0; q < RT; ++q) act[q] = pact[q] = false;

  for (int s = 0; s <= nrows; ++s) {
    // (1) row s: this slice's share of each dot product, pushed into every
    // CTA of the cluster (row s's share slot, completing its barrier)
    if (s < nrows) {
      const int par = s & 1;
      if (s % bw == 0) {
        unit = units[s / bw];
        const int i = unit / nrb;
#pragma unroll
        for (int q = 0; q < RT; ++q)
          act[q] = q < nq && masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
      }
      syk = repro::to_f32(Sy[static_cast<size_t>(unit) * bw + s % bw]);
      mbar_wait(&full[s % nbuf], static_cast<uint32_t>((s / nbuf) & 1));
      const T* x = slot(s);
      float d[RT];
#pragma unroll
      for (int q = 0; q < RT; ++q) d[q] = 0.f;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float xv[kVec];
        load4(x, (v * kThreads + t) * kVec, width, xv);
#pragma unroll
        for (int q = 0; q < RT; ++q)
#pragma unroll
          for (int e = 0; e < kVec; ++e) d[q] += xv[e] * w[q][v * kVec + e];
      }
#pragma unroll
      for (int q = 0; q < RT; ++q) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d[q] += __shfl_down_sync(0xffffffffu, d[q], off);
        if (lane == 0) red[par][q][warp] = d[q];
      }
      __syncthreads();
      if (t < kC * RT) {
        const int q = t % RT, dst = t / RT;
        float share = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) share += red[par][q][v];
        const int b = s % kShareSlots;
        push_share(repro::cluster_addr(
                       smem_addr(&shares[b][rank][q]), dst),
                   share,
                   repro::cluster_addr(smem_addr(&got[b]), dst));
      }
    }
    // (2) row s - 1: u_q from the C shares in rank order (the same float in
    // every CTA), then acc_q += u_q SX_s-1[slice] from the slice still
    // staged; at a unit's last row, the unit's scratch; then its slot takes
    // the row nbuf on
    if (s >= 1) {
      const int b = (s - 1) % kShareSlots;
      wait_shares(&got[b], static_cast<uint32_t>(((s - 1) / kShareSlots) & 1));
      float u[RT];
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        float uq = 0.f;
#pragma unroll
        for (int k = 0; k < kC; ++k) uq += shares[b][k][q];
        u[q] = uq - psyk;
      }
      if (t == 0 && s - 1 + kShareSlots < nrows)
        expect_bytes(&got[b], kShareBytes);
      const T* x = slot(s - 1);
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float xv[kVec];
        load4(x, (v * kThreads + t) * kVec, width, xv);
#pragma unroll
        for (int q = 0; q < RT; ++q)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            acc[q][v * kVec + e] += u[q] * xv[e];
      }
      if ((s - 1) % bw == bw - 1) {
        const int i = punit / nrb;
#pragma unroll
        for (int q = 0; q < RT; ++q) {
          if (pact[q]) {
            const float mq = masks[static_cast<size_t>(q0 + q) * m + i];
            const float ci = mq * mk[q] / nbeta;
            float* out = scratch +
                (static_cast<size_t>(q0 + q) * m * nrb + punit) * p + c0;
#pragma unroll
            for (int v = 0; v < NV; ++v)
#pragma unroll
              for (int e = 0; e < kVec; ++e) {
                const int idx = (v * kThreads + t) * kVec + e;
                if (idx < width) out[idx] = ci * acc[q][v * kVec + e];
              }
          }
#pragma unroll
          for (int j = 0; j < NE; ++j) acc[q][j] = 0.f;
        }
      }
      // every thread is done with row s - 1's slot and share slot
      __syncthreads();
      if (s - 1 + nbuf < nrows)
        fetch_slice<T>(mode, row_src(s - 1 + nbuf), slot(s - 1), width,
                       &full[(s - 1) % nbuf]);
    }
#pragma unroll
    for (int q = 0; q < RT; ++q) pact[q] = act[q];
    punit = unit;
    psyk = syk;
  }
  // no CTA leaves while a push of its own may be in flight to a peer
  cluster_arrive();
  cluster_wait();
}

// Clusters of `kernel` resident on the card at once with `smem` bytes of
// dynamic shared memory a CTA, asked of the runtime once a (device,
// kernel, smem).
cudaError_t max_clusters(const void* kernel, size_t smem, int* out) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(dev, kernel, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = known.find(key);
    if (it != known.end()) {
      *out = it->second;
      return cudaSuccess;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  std::lock_guard<std::mutex> lock(mu);
  known[key] = n;
  *out = n;
  return cudaSuccess;
}

template <typename T, int NV>
cudaError_t launch_cluster_route(const void* SX, const void* Sy,
                                 const void* W, const float* masks,
                                 float* scratch, void* G, int R, int m, int r,
                                 int p, int bw, float nbeta,
                                 const WidePlan& pl, cudaStream_t stream) {
  constexpr int RT = tile_for(NV);
  const auto kernel = &fused_wide_cluster<T, NV, RT>;
  const size_t smem = static_cast<size_t>(pl.slots) * pl.S * sizeof(T);
  cudaError_t err = repro::set_smem(reinterpret_cast<const void*>(kernel),
                                    smem);
  if (err != cudaSuccess) return err;
  int clusters = 0;
  err = max_clusters(reinterpret_cast<const void*>(kernel), smem, &clusters);
  if (err != cudaSuccess) return err;
  const uintptr_t base = reinterpret_cast<uintptr_t>(SX);
  const size_t row_bytes = static_cast<size_t>(p) * sizeof(T);
  const int mode = row_bytes % 16 == 0 && base % 16 == 0 ? kBulk
                   : row_bytes % 4 == 0 && base % 4 == 0 ? kWords
                                                         : kPlain;
  // one wave of clusters over the tiles (each cluster at most kMaxUnits
  // units, no more clusters a tile than units); which cluster takes a unit
  // changes no sum
  const int nrb = r / bw;
  const int ntiles = (R + RT - 1) / RT;
  const int units = m * nrb;
  int per_tile = clusters / ntiles;
  if (per_tile < (units + kMaxUnits - 1) / kMaxUnits)
    per_tile = (units + kMaxUnits - 1) / kMaxUnits;
  if (per_tile > units) per_tile = units;
  if (per_tile < 1) per_tile = 1;
  err = repro::launch_cluster(
      kernel, static_cast<int64_t>(ntiles) * per_tile * kC, kThreads, smem, kC,
      stream, static_cast<const T*>(SX), static_cast<const T*>(Sy),
      static_cast<const T*>(W), masks, scratch, R, m, r, p, bw, pl.S,
      pl.slots, mode, per_tile, nbeta);
  if (err != cudaSuccess) return err;
  return launch_stage2<T>(scratch, masks, G, R, m, nrb, p, stream);
}

template <typename T>
cudaError_t dispatch_cluster(const void* SX, const void* Sy, const void* W,
                             const float* masks, float* scratch, void* G,
                             int R, int m, int r, int p, int bw, float nbeta,
                             const WidePlan& pl, cudaStream_t stream) {
  switch (pl.nv) {
#define REPRO_WIDE_NV(NV)                                                   \
  case NV:                                                                  \
    return launch_cluster_route<T, NV>(SX, Sy, W, masks, scratch, G, R, m,  \
                                       r, p, bw, nbeta, pl, stream);
    REPRO_WIDE_NV(3)
    REPRO_WIDE_NV(4)
    REPRO_WIDE_NV(6)
    REPRO_WIDE_NV(8)
    REPRO_WIDE_NV(10)
    REPRO_WIDE_NV(13)
    REPRO_WIDE_NV(16)
    REPRO_WIDE_NV(19)
#undef REPRO_WIDE_NV
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The two-read route, past the cluster's capacity.
constexpr int kChunk = 4096;                // columns of one partial dot
constexpr int kChunkRegs = kChunk / kThreads;
constexpr int kWideCols = 1024;             // columns of a gradient block
constexpr int kWideRegs = kWideCols / kThreads;
constexpr int kWideRows = 32;               // rows a residual block walks

// partial[q, i, k, chunk] = the chunk's share of SX_ik . W[q], for each
// realization q of the tile with worker i active.  Grid: (m * groups,
// chunks, tiles), groups = ceil(r / kWideRows).
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
wide_residual(const T* __restrict__ SX, const T* __restrict__ W,
              const float* __restrict__ masks, float* __restrict__ partial,
              int R, int m, int r, int p, int nchunks) {
  __shared__ float red[2][RT][kWarps];
  const int groups = (r + kWideRows - 1) / kWideRows;
  const int i = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int chunk = blockIdx.y, q0 = blockIdx.z * RT;
  const int nq = R - q0 < RT ? R - q0 : RT;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  bool act[RT];
  bool any = false;
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    act[q] = q < nq && masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
    any = any || act[q];
  }
  if (!any) return;                         // worker i's rows are not read
  const int c0 = chunk * kChunk;
  float wv[RT][kChunkRegs];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < kChunkRegs; ++j) {
      const int col = c0 + t + j * kThreads;
      wv[q][j] = act[q] && col < p
          ? repro::to_f32(W[static_cast<size_t>(q0 + q) * p + col]) : 0.f;
    }
  const int k0 = grp * kWideRows;
  const int k1 = r < k0 + kWideRows ? r : k0 + kWideRows;
  for (int k = k0; k < k1; ++k) {
    const T* row = SX + (static_cast<size_t>(i) * r + k) * p;
    float x[kChunkRegs];
#pragma unroll
    for (int j = 0; j < kChunkRegs; ++j) {
      const int col = c0 + t + j * kThreads;
      x[j] = col < p ? repro::to_f32(row[col]) : 0.f;
    }
    const int par = k & 1;
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      float d = 0.f;
      if (act[q]) {
#pragma unroll
        for (int j = 0; j < kChunkRegs; ++j)
          if (c0 + t + j * kThreads < p) d += x[j] * wv[q][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          d += __shfl_down_sync(0xffffffffu, d, off);
      }
      if (lane == 0) red[par][q][warp] = d;
    }
    // red[par] is rewritten two rows on, after the next barrier, by which
    // time its readers below are done with it
    __syncthreads();
    if (t < nq && masks[static_cast<size_t>(q0 + t) * m + i] != 0.f) {
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) sum += red[par][t][v];
      partial[((static_cast<size_t>(q0 + t) * m + i) * r + k) * nchunks +
              chunk] = sum;
    }
  }
}

// scratch[q, unit, cols] = c_qi sum_k u_qk SX_k[cols] over the unit's bw
// rows in order, u_qk = (partial[q, i, k, :] added in chunk order) - Sy_k.
// Grid: (m * r / bw units, column tiles of kWideCols, tiles).
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads)
wide_gradient(const T* __restrict__ SX, const T* __restrict__ Sy,
              const float* __restrict__ masks,
              const float* __restrict__ partial, float* __restrict__ scratch,
              int R, int m, int r, int p, int bw, int nchunks, float nbeta) {
  __shared__ float us[RT][kMaxWideRows];
  __shared__ float mk[RT];
  const int nrb = r / bw;
  const int unit = blockIdx.x, i = unit / nrb, kb = (unit % nrb) * bw;
  const int c0 = blockIdx.y * kWideCols, q0 = blockIdx.z * RT;
  const int nq = R - q0 < RT ? R - q0 : RT;
  const int t = threadIdx.x;
  bool act[RT];
  bool any = false;
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    act[q] = q < nq && masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
    any = any || act[q];
  }
  if (!any) return;                         // worker i's rows are not read
  for (int idx = t; idx < RT * bw; idx += kThreads) {
    const int q = idx / bw, kk = idx % bw;
    if (act[q]) {
      const float* pp = partial +
          ((static_cast<size_t>(q0 + q) * m + i) * r + kb + kk) * nchunks;
      float u = 0.f;
      for (int c = 0; c < nchunks; ++c) u += pp[c];
      us[q][kk] = u - repro::to_f32(Sy[static_cast<size_t>(i) * r + kb + kk]);
    }
  }
  // m / k_q, k_q summing the masks in the reference's order
  if (t < nq) {
    const float* mrow = masks + static_cast<size_t>(q0 + t) * m;
    float kq = 0.f;
    for (int a = 0; a < m; ++a) kq += mrow[a];
    mk[t] = static_cast<float>(m) / fmaxf(kq, 1.f);
  }
  __syncthreads();
  float acc[RT][kWideRegs];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < kWideRegs; ++j) acc[q][j] = 0.f;
  const T* base = SX + (static_cast<size_t>(i) * r + kb) * p;
#pragma unroll 4
  for (int kk = 0; kk < bw; ++kk) {
    const T* row = base + static_cast<size_t>(kk) * p;
    float x[kWideRegs];
#pragma unroll
    for (int j = 0; j < kWideRegs; ++j) {
      const int col = c0 + t + j * kThreads;
      x[j] = col < p ? repro::to_f32(row[col]) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      if (!act[q]) continue;
      const float uk = us[q][kk];
#pragma unroll
      for (int j = 0; j < kWideRegs; ++j) acc[q][j] += uk * x[j];
    }
  }
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    if (!act[q]) continue;
    const float mq = masks[static_cast<size_t>(q0 + q) * m + i];
    const float ci = mq * mk[q] / nbeta;
    float* out = scratch + (static_cast<size_t>(q0 + q) * m * nrb + unit) * p;
#pragma unroll
    for (int j = 0; j < kWideRegs; ++j) {
      const int col = c0 + t + j * kThreads;
      if (col < p) out[col] = ci * acc[q][j];
    }
  }
}

template <typename T, int RT>
cudaError_t launch_two_read(const void* SX, const void* Sy, const void* W,
                            const float* masks, float* partial,
                            float* scratch, void* G, int R, int m, int r,
                            int p, int bw, float nbeta, cudaStream_t stream) {
  const int nchunks = (p + kChunk - 1) / kChunk;
  const int ntiles = (R + RT - 1) / RT;
  const int groups = (r + kWideRows - 1) / kWideRows;
  const int nrb = r / bw;
  const int64_t rblocks = static_cast<int64_t>(m) * groups;
  const int64_t units = static_cast<int64_t>(m) * nrb;
  const int ctiles = (p + kWideCols - 1) / kWideCols;
  if (rblocks > 0x7fffffffLL || units > 0x7fffffffLL || nchunks > 65535 ||
      ctiles > 65535 || ntiles > 65535)
    return cudaErrorInvalidValue;
  wide_residual<T, RT><<<dim3(static_cast<unsigned>(rblocks), nchunks,
                              ntiles), kThreads, 0, stream>>>(
      static_cast<const T*>(SX), static_cast<const T*>(W), masks, partial, R,
      m, r, p, nchunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_gradient<T, RT><<<dim3(static_cast<unsigned>(units), ctiles, ntiles),
                         kThreads, 0, stream>>>(
      static_cast<const T*>(SX), static_cast<const T*>(Sy), masks, partial,
      scratch, R, m, r, p, bw, nchunks, nbeta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stage2<T>(scratch, masks, G, R, m, nrb, p, stream);
}

// The route of the plan.  On the two-read route a single call takes a
// tile of one (fewer registers); its sums are the same in a tile of
// kMaxTile.
template <typename T>
cudaError_t dispatch_wide(const void* SX, const void* Sy, const void* W,
                          const float* masks, float* partial, float* scratch,
                          void* G, int R, int m, int r, int p, int bw,
                          float nbeta, cudaStream_t stream) {
  const WidePlan pl = wide_plan(p, sizeof(T));
  if (pl.route == kCluster) {
    if (partial != nullptr) return cudaErrorInvalidValue;
    return dispatch_cluster<T>(SX, Sy, W, masks, scratch, G, R, m, r, p, bw,
                               nbeta, pl, stream);
  }
  if (partial == nullptr) return cudaErrorInvalidValue;
  if (R == 1)
    return launch_two_read<T, 1>(SX, Sy, W, masks, partial, scratch, G, R, m,
                                 r, p, bw, nbeta, stream);
  return launch_two_read<T, kMaxTile>(SX, Sy, W, masks, partial, scratch, G,
                                      R, m, r, p, bw, nbeta, stream);
}

}  // namespace

// The column-split form for p > 16384, along repro_fused_wide_plan's route.
// scratch: (R, m * r / bw, p) float32, bw dividing r, at most 64; partial:
// (R, m, r, ceil(p / 4096)) float32 on the two-read route, null on the
// cluster route.  dtype: 0 = float32, 1 = bfloat16 (SX, Sy, W and G).
// Returns the launches' error: a refused cluster launch is reported, never
// worked around.
extern "C" int repro_fused_masked_gradient_wide(
    const void* SX, const void* Sy, const void* W, const void* masks,
    void* partial, void* scratch, void* G, int R, int m, int r, int p,
    int bw, float nbeta, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || m <= 0 || r <= 0 || p <= kMaxCols || bw <= 0 ||
      bw > kMaxWideRows || r % bw || R > 65535)
    return cudaErrorInvalidValue;
  const float* mk = static_cast<const float*>(masks);
  float* pa = static_cast<float*>(partial);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 0)
    return dispatch_wide<float>(SX, Sy, W, mk, pa, sc, G, R, m, r, p, bw,
                                nbeta, st);
  if (dtype == 1)
    return dispatch_wide<__nv_bfloat16>(SX, Sy, W, mk, pa, sc, G, R, m, r, p,
                                        bw, nbeta, st);
  return cudaErrorInvalidValue;
}

// The column-split form's plan at width p for elements of itemsize bytes,
// one field a call, for the tests to hold against the wrapper's wide_plan:
// 0 route (1 cluster, 0 two-read), 1 CTAs a row, 2 columns a slice, 3
// threads a CTA, 4 vectors of 4 columns a thread, 5 realizations a tile,
// 6 ring slots a CTA; -1 for another field.
extern "C" int repro_fused_wide_plan(int p, int itemsize, int field) {
  const WidePlan pl = wide_plan(p, itemsize);
  const int fields[] = {pl.route, pl.C, pl.S, pl.threads, pl.nv, pl.rt,
                        pl.slots};
  return field >= 0 && field < 7 ? fields[field] : -1;
}
