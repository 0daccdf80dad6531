// Fused masked gradient of encoded GD / ISTA (paper Algorithm 1), batched
// over R iterates that share one encoded problem:
//     G[q] = sum_i c_qi (S_i X)^T (S_i X W[q] - S_i y),
//     c_qi = mask_qi * (m / k_q) / (n beta),  k_q = max(sum_i mask_qi, 1),
// summed in float32.  SX (m, r, p), Sy (m, r), W (R, p) in float32 or
// bfloat16, masks (R, m) float32 -> G (R, p) in W's dtype.
//
// Replaces the TPU kernel src/repro/kernels/fused_step.py (_fused_body,
// launched by _fused_call).  That body zero-fills one (1, p) accumulator at
// grid step (0, 0) and adds into it on every later step, which is only
// right because a TPU runs its grid in order.  CUDA blocks run in any
// order, so this port reduces in two deterministic stages, with no atomics:
//   stage 1 - a grid of (blocks, ceil(R / RT)): a block takes a tile of RT
//             realizations and a list of units (a unit: one worker's block
//             of br rows); for every row k and every active realization q,
//             u_qk = SX_k . W[q] - Sy_k (the tile's dot products share one
//             reduction through the block), and at the unit's end
//             c_qi SX_unit^T u_q goes to scratch[q, unit, :];
//   stage 2 - scratch summed over units in a fixed order (split eight ways
//             a column, the eight sums then added in order).
// Realization q's sequence of operations depends on neither R, nor RT, nor
// q's place in its tile, nor the block that takes a unit (the same threads
// and columns, the same shuffle tree, the warps' sums in the same order,
// the rows in the same order), so a batched call gives, bit for bit, the
// rows of R single calls.  Workers with mask 0 are skipped in both stages: a
// worker masked out in every realization of a tile is in no unit list (its
// rows are never read), a masked-out realization inside an active unit
// does no work and writes no scratch, and an all-zero mask gives exactly 0.
// c is computed on the device, in the reference's operation order, so a
// step never waits on the host.
//
// Bound on the H100: memory in principle, issue latency as built.  One
// step must read the active workers' SX blocks once.  Read once for a tile,
// the product does about 4 flops a realization per element, 1 flop a byte
// in float32 a realization: at RT <= 16 that stays below the card's
// float32 line of 67 TFLOP/s over 3.35 TB/s, about 20 flops a byte, so
// float32 FMAs on the CUDA cores can reach the memory bound, and tensor
// cores would add nothing but TF32's error against the trace gates.  So the
// batch is a loop over the tile inside the block.  A thread keeps its share
// of a row in registers (NE of them) from the dot products to the column
// sums, and RT sets of NE accumulators: RT comes from p alone, the largest
// of 8, 4, 2, 1 with NE (1 + RT) <= 200 registers and the tile's iterates
// (RT p floats, staged in shared memory once a block) beside two row
// buffers inside 227 KB; NE <= 64 caps this form at p = 16384 (wider rows
// take the column-split form, below).  A single call takes a tile of one
// (fewer registers, so more blocks an SM); its sums are the same.  Rows
// reach shared memory through a ring of 2-4 row buffers filled by
// asynchronous copies (one 1D
// bulk copy of the Tensor Memory Accelerator a row, completing on an
// mbarrier, where a row is a whole number of aligned 16-byte units; 4-byte
// cp.async copies arriving on the same mbarrier where rows are whole
// aligned words; plain loads otherwise), so a block keeps rows in flight
// while it reduces others, and where registers allow (NE (RT + 2) <= 160)
// a step reduces two rows with one read of the iterates and one barrier.
// A batched call runs one wave of blocks, each staging its iterates once
// and walking its units as one stream of rows.  What holds the tiled
// block back (PERF.md): at p = 6000 and RT = 4 it needs about 200
// registers a thread and 192 KB of shared memory, so one block of 8 warps
// runs on an SM, too few to hide the latency of its per-row chain of
// shared-memory reads, shuffles and a barrier.  The scratch (one p-row per
// active unit of up to 16 rows and realization) adds about 1/16 of the
// rows' bytes a realization.
//
// Past p = 16384 (a row no longer fits a thread's registers) the call takes
// the column-split form of fused_wide.cu, entry
// repro_fused_masked_gradient_wide; both forms share the row ring's copies
// and the second stage (fused_common.cuh).
#include "fused_common.cuh"

#include <cstdint>

namespace {

constexpr int kMaxBlockRows = 64;
constexpr int kRegBudget = 200;           // NE * (1 + RT) registers
constexpr int kMaxTile = 8;
constexpr int kMaxBuf = 4;
constexpr int kMinBuf = 2;
// rows a step of the first stage reduces together: two where their
// registers, NE (RT + 2), stay within this budget
constexpr int kPairBudget = 160;
// shared memory of one SM that blocks may share (228 KB), and what the
// runtime reserves for each resident block
constexpr int kSmemPerSM = 228 * 1024;
constexpr int kSmemPerBlock = 1024;
constexpr int kMaxDevices = 64;

// fused_stage1's static shared memory stays inside what kSmemBudget leaves
static_assert(2 * 2 * kMaxTile * kWarps * sizeof(float) +
                  kMaxTile * sizeof(float) +
                  (kMaxUnits + kWarps) * sizeof(int) +
                  kMaxBuf * sizeof(uint64_t) <=
              227 * 1024 - kSmemBudget,
              "static shared memory of the first stage over its share");

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Realizations a block takes for NE registers a row: the largest of 8, 4,
// 2, 1 whose accumulators fit the register budget and whose iterates fit
// shared memory beside two float32 row buffers at the widest p this NE
// serves (NE * kThreads).  Depends on p alone (through NE).
__host__ __device__ constexpr int tile_for(int ne) {
  for (int rt = kMaxTile; rt > 1; rt >>= 1)
    if (ne * (1 + rt) <= kRegBudget &&
        rt * ne * kThreads * 4 + kMinBuf * ne * kThreads * 4 <= kSmemBudget)
      return rt;
  return 1;
}

// Rows a first-stage step reduces together (their dot products share one
// read of the iterates and one barrier): 2 where NE (RT + 2) registers fit
// kPairBudget, else 1.  Each row's sums keep their order either way.
__host__ __device__ constexpr int rows_for(int ne, int rt) {
  return ne * (rt + 2) <= kPairBudget ? 2 : 1;
}

// Registers a thread holds for one row: the smallest listed NE with
// NE * kThreads >= p.  Depends on p alone, never on R.
constexpr int kRegSteps[] = {1, 2, 4, 8, 16, 24, 32, 48, 64};

inline int regs_for(int p) {
  const int need = (p + kThreads - 1) / kThreads;
  for (int ne : kRegSteps)
    if (need <= ne) return ne;
  return 0;
}

// In the first stage a block stages the iterates of its tile of
// realizations once, then walks a list of units (a unit is one row block of
// br rows of one worker, scratch row `unit`) as one stream of rows that its
// ring of row buffers keeps ahead of it.  Units are numbered over the
// workers active in some realization of the tile (each with its nrb row
// blocks, in order), and block c of the tile's gridDim.x takes the units
// c, c + gridDim.x, ...: every active unit once, the blocks evenly loaded,
// and an erased worker's rows never read.
//
// For every row of a unit, thread t holds the columns t, t + kThreads, ...
// in registers (NE of them, NE * kThreads >= p): it reads them once from
// the ring, the block reduces the dot products u_qk = SX_k . W[q] - Sy_k of
// the unit's active realizations (a shuffle tree a warp, then the warps'
// sums in order), and the same registers then feed acc[q] += u_qk * SX_k.
// A step takes RS rows of one unit (two where registers allow): their dot
// products share each read of the iterates and one barrier, and the
// accumulators take the rows in order.  At the unit's last row,
// c_qi acc[q] goes to scratch[q, unit, :].
// Dynamic shared memory: the tile's iterates (min(RT, R) of them), then
// nbuf row buffers of row_stride bytes.
template <typename T, int NE, int RT, int kMode>
__global__ void __launch_bounds__(kThreads)
fused_stage1(const T* __restrict__ SX, const T* __restrict__ Sy,
             const T* __restrict__ W, const float* __restrict__ masks,
             float* __restrict__ scratch, int R, int m, int r, int p, int br,
             int nbuf, int ws_bytes, int row_stride, float nbeta) {
  constexpr int RS = rows_for(NE, RT);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][RS][RT][kWarps];  // by step parity: one barrier
  __shared__ float mk[RT];                  // m / k_q of the tile
  __shared__ int units[kMaxUnits];
  __shared__ int count[kWarps];
  __shared__ __align__(8) uint64_t full[kMaxBuf];
  const int nrb = r / br;
  const int nblocks = gridDim.x, c = blockIdx.x;
  const int q0 = blockIdx.y * RT;
  const int nq = R - q0 < RT ? R - q0 : RT;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  // this block's units, from the ranks of the active workers
  int active = 0;                           // active workers so far
  for (int i0 = 0; i0 < m; i0 += kThreads) {
    const int i = i0 + t;
    bool on = false;
    for (int q = 0; q < nq && i < m; ++q)
      on = on || masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
    const unsigned ballot = __ballot_sync(0xffffffffu, on);
    if (lane == 0) count[warp] = __popc(ballot);
    __syncthreads();
    int rank = active + __popc(ballot & ((1u << lane) - 1u));
    for (int v = 0; v < kWarps; ++v) {
      if (v < warp) rank += count[v];
      active += count[v];
    }
    if (on) {
      for (int jb = 0; jb < nrb; ++jb) {
        const int a = rank * nrb + jb;
        if (a % nblocks == c) units[a / nblocks] = i * nrb + jb;
      }
    }
    __syncthreads();                        // count is rewritten next chunk
  }
  const int nall = active * nrb;
  const int nunits = c < nall ? (nall - c + nblocks - 1) / nblocks : 0;
  if (nunits == 0) return;
  const int nrows = nunits * br;
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + ws_bytes;
  auto row_at = [&](int s) {                // row s of this block's stream
    return SX + (static_cast<size_t>(units[s / br]) * br + s % br) * p;
  };

  if (t == 0) {
    for (int b = 0; b < nbuf; ++b)
      mbar_init(&full[b], kMode == kBulk ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ahead = nbuf < nrows ? nbuf : nrows;
  for (int s = 0; s < ahead; ++s)
    fetch_row<T, kMode>(row_at(s), reinterpret_cast<T*>(ring + s * row_stride),
                        p, &full[s]);
  // the tile's iterates and decode scales, staged while the first rows are
  // in flight; k_q sums the masks in the reference's order
  for (int q = 0; q < nq; ++q) {
    const T* w = W + static_cast<size_t>(q0 + q) * p;
    for (int col = t; col < p; col += kThreads)
      ws[q * p + col] = repro::to_f32(w[col]);
  }
  if (t < nq) {
    const float* mrow = masks + static_cast<size_t>(q0 + t) * m;
    float k = 0.f;
    for (int a = 0; a < m; ++a) k += mrow[a];
    mk[t] = static_cast<float>(m) / fmaxf(k, 1.f);
  }
  __syncthreads();

  float acc[RT][NE];
#pragma unroll
  for (int q = 0; q < RT; ++q)
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[q][j] = 0.f;
  bool act[RT];
  int unit = 0, i = 0;
  // a step reduces nr = RS rows of one unit (fewer at a unit's end)
  for (int s = 0, k = 0, step = 0; s < nrows; ++step) {
    if (k == 0) {
      unit = units[s / br];
      i = unit / nrb;
#pragma unroll
      for (int q = 0; q < RT; ++q)
        act[q] = q < nq && masks[static_cast<size_t>(q0 + q) * m + i] != 0.f;
    }
    const int nr = br - k < RS ? br - k : RS;
    float syk[RS];
    float x[RS][NE];
    const T* row[RS];
#pragma unroll
    for (int h = 0; h < RS; ++h) {
      syk[h] = 0.f;
      row[h] = nullptr;
      if (h < nr)
        syk[h] = repro::to_f32(Sy[static_cast<size_t>(unit) * br + k + h]);
    }
#pragma unroll
    for (int h = 0; h < RS; ++h) {
      if (h < nr) {
        const int slot = (s + h) % nbuf;
        mbar_wait(&full[slot], static_cast<uint32_t>(((s + h) / nbuf) & 1));
        row[h] = reinterpret_cast<const T*>(ring + slot * row_stride);
      }
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int col = t + j * kThreads;
        x[h][j] = h < nr && col < p ? repro::to_f32(row[h][col]) : 0.f;
      }
    }
    float d[RS][RT];
#pragma unroll
    for (int q = 0; q < RT; ++q) {
#pragma unroll
      for (int h = 0; h < RS; ++h) d[h][q] = 0.f;
      if (!act[q]) continue;
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int col = t + j * kThreads;
        if (col < p) {
          const float wv = ws[q * p + col];
#pragma unroll
          for (int h = 0; h < RS; ++h) d[h][q] += x[h][j] * wv;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int h = 0; h < RS; ++h)
          d[h][q] += __shfl_down_sync(0xffffffffu, d[h][q], off);
    }
    const int par = step & 1;
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < RS; ++h)
#pragma unroll
        for (int q = 0; q < RT; ++q) red[par][h][q][warp] = d[h][q];
    }
    // every thread has read its share of this step's rows and posted its
    // dot products
    __syncthreads();
#pragma unroll
    for (int h = 0; h < RS; ++h)
      if (h < nr && s + h + nbuf < nrows)
        fetch_row<T, kMode>(row_at(s + h + nbuf), const_cast<T*>(row[h]), p,
                            &full[(s + h) % nbuf]);
    // the rows in order: acc[q] += u_q,k x_k, then row k + 1
#pragma unroll
    for (int h = 0; h < RS; ++h) {
      if (h >= nr) continue;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        if (!act[q]) continue;
        float uk = 0.f;
#pragma unroll
        for (int v = 0; v < kWarps; ++v) uk += red[par][h][q][v];
        uk -= syk[h];
#pragma unroll
        for (int j = 0; j < NE; ++j) acc[q][j] += uk * x[h][j];
      }
    }
    s += nr;
    k += nr;
    if (k == br) {                          // the unit's last row
      k = 0;
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        if (act[q]) {
          const float mq = masks[static_cast<size_t>(q0 + q) * m + i];
          const float ci = mq * mk[q] / nbeta;
          float* out = scratch +
              (static_cast<size_t>(q0 + q) * m * nrb + unit) * p;
#pragma unroll
          for (int j = 0; j < NE; ++j) {
            const int col = t + j * kThreads;
            if (col < p) out[col] = ci * acc[q][j];
          }
        }
#pragma unroll
        for (int j = 0; j < NE; ++j) acc[q][j] = 0.f;
      }
    }
  }
}

// What the first stage's launch needs of a kernel and the card, read once
// per kernel and device.
struct Resident {
  int sms = 0;                              // streaming multiprocessors
  int regs_per_block = 0;                   // allocated registers a block
  int static_smem = 0;
};

template <typename T, int NE, int RT, int kMode>
cudaError_t resident(Resident* out) {
  const auto kernel = &fused_stage1<T, NE, RT, kMode>;
  static Resident cache[kMaxDevices];       // one per kernel and device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Resident& rs = cache[dev];
  if (rs.sms == 0) {
    // opt in to the full dynamic shared memory once, not on every launch;
    // a failed call's error is cleared, so no later launch reports it
    cudaFuncAttributes fa;
    int sms = 0;
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBudget);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&fa, reinterpret_cast<const void*>(kernel));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
    // registers are allocated 256 at a time a warp
    const int per_warp = (fa.numRegs * 32 + 255) / 256 * 256;
    rs.regs_per_block = per_warp * kWarps;
    rs.static_smem = static_cast<int>(fa.sharedSizeBytes);
    rs.sms = sms;
  }
  *out = rs;
  return cudaSuccess;
}

// Blocks of the first stage resident on one SM with `dyn` bytes of dynamic
// shared memory: the least of the thread, register and shared-memory
// limits.
int blocks_per_sm(const Resident& rs, int dyn) {
  int n = 2048 / kThreads;
  const int by_regs = 65536 / rs.regs_per_block;
  const int by_smem = kSmemPerSM / (dyn + rs.static_smem + kSmemPerBlock);
  if (by_regs < n) n = by_regs;
  if (by_smem < n) n = by_smem;
  return n;
}

template <typename T, int NE, int RT, int kMode>
cudaError_t launch(const void* SX, const void* Sy, const void* W,
                   const float* masks, float* scratch, void* G, int R, int m,
                   int r, int p, int br, float nbeta, cudaStream_t stream) {
  const auto kernel = &fused_stage1<T, NE, RT, kMode>;
  Resident rs;
  cudaError_t err = resident<T, NE, RT, kMode>(&rs);
  if (err != cudaSuccess) return err;
  const int ws_bytes = round16((R < RT ? R : RT) * p * 4);
  const int row_stride = round16(p * static_cast<int>(sizeof(T)));
  // ring depth: of the depths from 2 up that fit, the one that keeps the
  // most rows in flight on an SM (buffers ahead of the step's rows, times
  // resident blocks), the fewer on a tie; it changes no sum
  constexpr int RS = rows_for(NE, RT);
  int nbuf = kMinBuf, per_sm = 1, best = -1;
  for (int nb = kMinBuf; nb <= kMaxBuf; ++nb) {
    const int dyn = ws_bytes + nb * row_stride;
    if (dyn > kSmemBudget) break;
    const int blocks = blocks_per_sm(rs, dyn);
    if (blocks * (nb - RS) > best)
      best = blocks * (nb - RS), nbuf = nb, per_sm = blocks;
  }
  if (per_sm < 1) per_sm = 1;
  const size_t smem = static_cast<size_t>(ws_bytes) + nbuf * row_stride;
  // A single call stages one cheap iterate: a block a unit, balanced by
  // the card's block scheduler.  A batched call stages RT iterates a block:
  // one wave of blocks over all tiles, each block taking at most kMaxUnits
  // units, and no more blocks than units.
  const int nrb = r / br;
  const int ntiles = (R + RT - 1) / RT;
  const int units = m * nrb;
  int per_tile = R == 1 ? units : rs.sms * per_sm / ntiles;
  if (per_tile < (units + kMaxUnits - 1) / kMaxUnits)
    per_tile = (units + kMaxUnits - 1) / kMaxUnits;
  if (per_tile > units) per_tile = units;
  if (per_tile < 1) per_tile = 1;
  dim3 grid1(per_tile, ntiles);
  kernel<<<grid1, kThreads, smem, stream>>>(
      static_cast<const T*>(SX), static_cast<const T*>(Sy),
      static_cast<const T*>(W), masks, scratch, R, m, r, p, br, nbuf,
      ws_bytes, row_stride, nbeta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_stage2<T>(scratch, masks, G, R, m, nrb, p, stream);
}

// The tile a launch takes: one realization for a single call (its block
// then holds one set of accumulators, and more blocks fit an SM), else
// tile_for(NE).  A realization's sums are the same in either.
template <typename T, int NE, int kMode>
cudaError_t by_tile(const void* SX, const void* Sy, const void* W,
                    const float* masks, float* scratch, void* G, int R, int m,
                    int r, int p, int br, float nbeta, cudaStream_t stream) {
  constexpr int RT = tile_for(NE);
  if (R == 1 || RT == 1)
    return launch<T, NE, 1, kMode>(SX, Sy, W, masks, scratch, G, R, m, r, p,
                                   br, nbeta, stream);
  return launch<T, NE, RT, kMode>(SX, Sy, W, masks, scratch, G, R, m, r, p,
                                  br, nbeta, stream);
}

template <typename T, int NE>
cudaError_t by_mode(const void* SX, const void* Sy, const void* W,
                    const float* masks, float* scratch, void* G, int R, int m,
                    int r, int p, int br, float nbeta, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(p) * sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(SX);
  if (row_bytes % 16 == 0 && base % 16 == 0)
    return by_tile<T, NE, kBulk>(SX, Sy, W, masks, scratch, G, R, m, r, p,
                                 br, nbeta, stream);
  if (row_bytes % 4 == 0 && base % 4 == 0)
    return by_tile<T, NE, kWords>(SX, Sy, W, masks, scratch, G, R, m, r, p,
                                  br, nbeta, stream);
  return by_tile<T, NE, kPlain>(SX, Sy, W, masks, scratch, G, R, m, r, p, br,
                                nbeta, stream);
}

template <typename T>
cudaError_t dispatch(const void* SX, const void* Sy, const void* W,
                     const float* masks, float* scratch, void* G, int R,
                     int m, int r, int p, int br, float nbeta,
                     cudaStream_t stream) {
  switch (regs_for(p)) {
#define REPRO_FUSED_NE(NE)                                                 \
  case NE:                                                                 \
    return by_mode<T, NE>(SX, Sy, W, masks, scratch, G, R, m, r, p, br,    \
                          nbeta, stream);
    REPRO_FUSED_NE(1)
    REPRO_FUSED_NE(2)
    REPRO_FUSED_NE(4)
    REPRO_FUSED_NE(8)
    REPRO_FUSED_NE(16)
    REPRO_FUSED_NE(24)
    REPRO_FUSED_NE(32)
    REPRO_FUSED_NE(48)
    REPRO_FUSED_NE(64)
#undef REPRO_FUSED_NE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// scratch: (R, m * r / br, p) float32.  dtype: 0 = float32, 1 = bfloat16
// (SX, Sy, W and G).  Returns cudaGetLastError() after the launches.
extern "C" int repro_fused_masked_gradient(const void* SX, const void* Sy,
                                           const void* W, const void* masks,
                                           void* scratch, void* G, int R,
                                           int m, int r, int p, int br,
                                           float nbeta, int dtype,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R <= 0 || m <= 0 || r <= 0 || p <= 0 || br <= 0 ||
      br > kMaxBlockRows || r % br || R > 65535)
    return cudaErrorInvalidValue;
  const float* mk = static_cast<const float*>(masks);
  float* sc = static_cast<float*>(scratch);
  if (p > kMaxCols) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(SX, Sy, W, mk, sc, G, R, m, r, p, br, nbeta, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(SX, Sy, W, mk, sc, G, R, m, r, p, br,
                                   nbeta, st);
  return cudaErrorInvalidValue;
}

// The realizations one stage-1 block takes at width p (0 if p is out of
// range): the kernel's own choice, for the tests to hold against the
// wrapper's pick_fused_realization_tile.
extern "C" int repro_fused_realization_tile(int p) {
  const int ne = p > 0 ? regs_for(p) : 0;
  switch (ne) {
#define REPRO_FUSED_RT(NE) \
  case NE:                 \
    return tile_for(NE);
    REPRO_FUSED_RT(1)
    REPRO_FUSED_RT(2)
    REPRO_FUSED_RT(4)
    REPRO_FUSED_RT(8)
    REPRO_FUSED_RT(16)
    REPRO_FUSED_RT(24)
    REPRO_FUSED_RT(32)
    REPRO_FUSED_RT(48)
    REPRO_FUSED_RT(64)
#undef REPRO_FUSED_RT
  }
  return 0;
}
