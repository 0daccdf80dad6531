// Matrix-free SRHT encode (paper §4.2.2):  rows [lo, hi) of
//     S X = H_N[:, cols] diag(signs) X / sqrt(n)
// for data X (n, p), computed one data column at a time as
//     out[c, :] = FWHT_N(scatter(xt[c, :] * signs, cols))[lo:hi] * scale
// with xt = X^T (p, n), float32.
//
// Replaces the TPU kernel src/repro/kernels/encode.py (_srht_body, launched
// by srht_encode_call) together with the XLA scatter in front of it
// (src/repro/kernels/ops.py srht_encode): sign-flip, all log2(N) butterfly
// stages and the row window in one pass.
//
// Bound on the H100: memory.  Per data column it reads n values plus the
// shared (cols, signs) and writes hi - lo values, against 0.5 N log2(N)
// add/sub pairs - below the card's operations-per-byte line.
//
// One pass (N <= 32768, srht_kernel): one block per data column with the
// whole N-point row in shared memory (128 KB at most).  The scatter is
// folded into the load: the row is zero-filled on chip and each live value
// lands in its slot, so the zero-padded (p, N) intermediate of the TPU path
// never exists in device memory.  The butterfly runs as in fwht.cu
// (hadamard.cuh), and only the window is scaled and written, coalesced.
//
// Several passes (N > 32768): the split of fwht.cu, N = N1 * N2 with
// N2 = 32768.  Pass 1 (srht_segment_kernel) takes one contiguous segment of
// N2 slots of one data column a block and folds the sign flip and the
// scatter into its load through a slot -> data-index map (int32, N of them,
// -1 for an empty slot, built once on the device from cols): slot j holds
// xt[c, map[j]] * signs[map[j]] or 0, read coalesced from the map and
// gathered from the column's row of xt (which the N1 blocks of a column,
// launched together, find in L2).  The later passes are fwht.cu's strided
// passes; the last applies the scale and the row window in its store.  The
// wrapper (kernels/encode.py) runs them in place on the output for the
// full window, and for a partial window through a float32 intermediate of
// at most 1 GiB, a chunk of data columns at a time.
#include "hadamard.cuh"

#include <cstdint>

namespace {

template <int R>
__global__ void srht_kernel(const float* __restrict__ xt,
                            const int* __restrict__ cols,
                            const float* __restrict__ signs,
                            float* __restrict__ out, int n_in, int N, int lo,
                            int hi, float scale) {
  extern __shared__ float s[];
  const int nt = blockDim.x, t = threadIdx.x;
  const size_t row = blockIdx.x;
  for (int i = t; i < N; i += nt) s[i] = 0.f;
  __syncthreads();
  const float* xr = xt + row * n_in;
  for (int j = t; j < n_in; j += nt) s[cols[j]] = xr[j] * signs[j];
  __syncthreads();
  float v[R];
  // thread t reads exactly the slots it writes back first in butterfly(),
  // so no barrier is needed between this read and that write
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = s[j * nt + t];
  repro::butterfly<R>(v, s);
  const int w = hi - lo;
  float* orow = out + row * w;
  for (int i = t; i < w; i += nt) orow[i] = s[lo + i] * scale;
}

template <int R>
cudaError_t launch(const float* xt, const int* cols, const float* signs,
                   float* out, int rows, int n_in, int N, int lo, int hi,
                   float scale, cudaStream_t stream) {
  const int threads = N / R;
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  cudaError_t err =
      repro::set_smem(reinterpret_cast<const void*>(&srht_kernel<R>), smem);
  if (err != cudaSuccess) return err;
  srht_kernel<R><<<rows, threads, smem, stream>>>(xt, cols, signs, out, n_in,
                                                  N, lo, hi, scale);
  return cudaGetLastError();
}

// Pass 1 of the multi-pass encode: block b is segment a = b % (N / seg) of
// data column b / (N / seg); its seg slots are gathered through slot_of,
// transformed (the stages h < seg) and written unscaled to out (rows, N).
template <int R>
__global__ void srht_segment_kernel(const float* __restrict__ xt,
                                    const int* __restrict__ slot_of,
                                    const float* __restrict__ signs,
                                    float* __restrict__ out, int n_in,
                                    int64_t N, int seg) {
  extern __shared__ float s[];
  const int nt = blockDim.x, t = threadIdx.x;
  const int64_t nseg = N / seg;
  const int64_t row = blockIdx.x / nseg, a = blockIdx.x % nseg;
  const float* xr = xt + row * n_in;
  const int* mp = slot_of + a * seg;
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int d = mp[j * nt + t];
    v[j] = d >= 0 ? xr[d] * signs[d] : 0.f;
  }
  repro::butterfly<R>(v, s);
  float* orow = out + row * N + a * seg;
  for (int i = t; i < seg; i += nt) orow[i] = s[i];
}

template <int R>
cudaError_t launch_segments(const float* xt, const int* slot_of,
                            const float* signs, float* out, int64_t blocks,
                            int n_in, int64_t N, int seg,
                            cudaStream_t stream) {
  const int threads = seg / R;
  const size_t smem = static_cast<size_t>(seg) * sizeof(float);
  cudaError_t err = repro::set_smem(
      reinterpret_cast<const void*>(&srht_segment_kernel<R>), smem);
  if (err != cudaSuccess) return err;
  srht_segment_kernel<R><<<static_cast<unsigned>(blocks), threads, smem,
                           stream>>>(xt, slot_of, signs, out, n_in, N, seg);
  return cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_srht_encode(const void* xt, const void* cols,
                                 const void* signs, void* out, int rows,
                                 int n_in, int N, int lo, int hi, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || N <= 0 || (N & (N - 1)) || N > 32768 || n_in > N ||
      lo < 0 || hi > N || lo >= hi)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xt);
  const int* c = static_cast<const int*>(cols);
  const float* sg = static_cast<const float*>(signs);
  float* o = static_cast<float*>(out);
  switch (N / repro::butterfly_threads(N)) {
    case 1: return launch<1>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 2: return launch<2>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 4: return launch<4>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 8: return launch<8>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 16: return launch<16>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 32: return launch<32>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    case 64: return launch<64>(x, c, sg, o, rows, n_in, N, lo, hi, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// Pass 1 of the multi-pass encode over `rows` data columns: segments of
// seg = 32768 slots of the N-slot frame, N a power of two above seg,
// through the slot -> data-index map slot_of (N int32, -1 where empty), to
// out (rows, N) float32, unscaled.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_srht_segments(const void* xt, const void* slot_of,
                                   const void* signs, void* out, int rows,
                                   int n_in, int64_t N, int seg,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || seg != 32768 || N <= seg || (N & (N - 1)) || n_in > N)
    return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>(rows) * (N / seg);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_segments<32768 / 512>(
      static_cast<const float*>(xt), static_cast<const int*>(slot_of),
      static_cast<const float*>(signs), static_cast<float*>(out), blocks,
      n_in, N, seg, st);
}
