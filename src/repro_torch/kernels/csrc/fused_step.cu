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
//   stage 1 - one block per (realization q, worker i, row block):
//             u = SX_blk W[q] - Sy_blk (a warp per row), then
//             c_qi SX_blk^T u into scratch[q, block, :];
//   stage 2 - scratch summed over blocks in a fixed order (split eight
//             ways a column, the eight sums then added in order).
// The order of every sum for realization q depends on neither R nor q, so
// a batched call gives, bit for bit, the rows of R single calls.  Workers
// with mask 0 are skipped in both stages: an erased worker's block is never
// read, and an all-zero mask gives exactly 0.  c is computed on the device,
// in the reference's operation order, so a step never waits on the host.
//
// Bound on the H100: memory.  One step must read the active workers' SX
// blocks once (about 2 flops per 4-byte element, far below the card's
// operations-per-byte line); everything else is small.  Stage 1 reads each
// row once: a thread keeps its share of the row in registers from the dot
// product to the column sums, which caps p at 16384 (64 registers a
// thread); wider rows need a multi-pass form.  The scratch (one p-row per
// active block of 16 rows) adds about 1/8 of SX's bytes.  A batched call
// reads SX once per realization; the batch as one product on the tensor
// cores is later work.
#include "hadamard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlockRows = 64;
constexpr int kMaxCols = 64 * kThreads;   // 16384: a row in registers

__device__ __forceinline__ float decode_weight(const float* mrow, int m,
                                               int i, float nbeta) {
  float k = 0.f;
  for (int a = 0; a < m; ++a) k += mrow[a];
  k = fmaxf(k, 1.f);
  return mrow[i] * (static_cast<float>(m) / k) / nbeta;
}

// One block walks its br rows one at a time.  Thread t holds the columns
// t, t + kThreads, ... of the current row in registers (NE of them, NE *
// kThreads >= p): it loads them once, the block reduces the dot product
// u_k = SX_k . w - Sy_k (a shuffle tree a warp, then the warps' sums in
// order), and the same registers then feed acc += u_k * SX_k.  Every row is
// read from device memory once; w is staged in shared memory.
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
fused_stage1(const T* __restrict__ SX, const T* __restrict__ Sy,
             const T* __restrict__ W, const float* __restrict__ masks,
             float* __restrict__ scratch, int m, int r, int p, int br,
             float nbeta) {
  extern __shared__ float ws[];             // w of this realization, (p,)
  __shared__ float red[kThreads / 32];
  const int nrb = r / br;
  const int blk = blockIdx.x;
  const int q = blockIdx.y;
  const int i = blk / nrb, jb = blk - i * nrb;
  const float* mrow = masks + static_cast<size_t>(q) * m;
  if (mrow[i] == 0.f) return;
  const float ci = decode_weight(mrow, m, i, nbeta);
  const size_t row0 = static_cast<size_t>(i) * r + static_cast<size_t>(jb) * br;
  const T* slab = SX + row0 * p;
  const T* w = W + static_cast<size_t>(q) * p;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int col = t; col < p; col += kThreads) ws[col] = repro::to_f32(w[col]);
  __syncthreads();
  float acc[NE];
#pragma unroll
  for (int j = 0; j < NE; ++j) acc[j] = 0.f;
  for (int k = 0; k < br; ++k) {
    const T* row = slab + static_cast<size_t>(k) * p;
    float x[NE];
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int col = t + j * kThreads;
      x[j] = col < p ? repro::to_f32(row[col]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < NE; ++j) {
      const int col = t + j * kThreads;
      if (col < p) d += x[j] * ws[col];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      d += __shfl_down_sync(0xffffffffu, d, off);
    if (lane == 0) red[warp] = d;
    __syncthreads();
    float uk = 0.f;
#pragma unroll
    for (int v = 0; v < kThreads / 32; ++v) uk += red[v];
    uk -= repro::to_f32(Sy[row0 + k]);
    __syncthreads();                        // red is rewritten next row
#pragma unroll
    for (int j = 0; j < NE; ++j) acc[j] += uk * x[j];
  }
  float* out = scratch + (static_cast<size_t>(q) * gridDim.x + blk) * p;
#pragma unroll
  for (int j = 0; j < NE; ++j) {
    const int col = t + j * kThreads;
    if (col < p) out[col] = ci * acc[j];
  }
}

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

template <typename T, int NE>
cudaError_t launch(const void* SX, const void* Sy, const void* W,
                   const float* masks, float* scratch, void* G, int R, int m,
                   int r, int p, int br, float nbeta, cudaStream_t stream) {
  const int nrb = r / br;
  const size_t smem = static_cast<size_t>(p) * sizeof(float);
  cudaError_t err = repro::set_smem(
      reinterpret_cast<const void*>(&fused_stage1<T, NE>), smem);
  if (err != cudaSuccess) return err;
  dim3 grid1(m * nrb, R);
  fused_stage1<T, NE><<<grid1, kThreads, smem, stream>>>(
      static_cast<const T*>(SX), static_cast<const T*>(Sy),
      static_cast<const T*>(W), masks, scratch, m, r, p, br, nbeta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2((p + kCols - 1) / kCols, R);
  fused_stage2<T><<<grid2, kCols * kSplit, 0, stream>>>(
      scratch, masks, static_cast<T*>(G), m, nrb, p);
  return cudaGetLastError();
}

// Registers a thread holds for one row: the smallest listed NE with
// NE * kThreads >= p.  Depends on p alone, never on R.
template <typename T>
cudaError_t dispatch(const void* SX, const void* Sy, const void* W,
                     const float* masks, float* scratch, void* G, int R,
                     int m, int r, int p, int br, float nbeta,
                     cudaStream_t stream) {
  const int need = (p + kThreads - 1) / kThreads;
#define REPRO_FUSED_NE(NE)                                                 \
  if (need <= NE)                                                          \
    return launch<T, NE>(SX, Sy, W, masks, scratch, G, R, m, r, p, br,     \
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
