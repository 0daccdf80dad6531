// Unnormalised fast Walsh-Hadamard transform along the last axis of a
// (rows, n) array, n a power of two up to 32768, summed in float32.
//
// Replaces the TPU kernel src/repro/kernels/fwht.py (_fwht_body with
// butterfly, launched by fwht_kernel_call), which keeps a (rows, n) tile
// resident in VMEM across all log2(n) stages.
//
// Bound on the H100: memory.  Each row is read once and written once
// (8 bytes an element in float32) against 0.5 log2(n) add/sub pairs an
// element, far below the card's operations-per-byte line.  Design: one block
// per row, the whole row on chip (registers + shared memory) for every
// stage, so device memory sees one coalesced read and one coalesced write;
// the low-stride stages never touch shared memory (registers and warp
// shuffles, hadamard.cuh).
#include "hadamard.cuh"

namespace {

template <typename T, int R>
__global__ void fwht_kernel(const T* __restrict__ x, T* __restrict__ out,
                            int n) {
  extern __shared__ float s[];
  const int nt = blockDim.x, t = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) v[j] = repro::to_f32(x[base + j * nt + t]);
  repro::butterfly<R>(v, s);
  for (int i = t; i < n; i += nt) out[base + i] = repro::from_f32<T>(s[i]);
}

template <typename T, int R>
cudaError_t launch(const void* x, void* out, int rows, int n,
                   cudaStream_t stream) {
  const int threads = n / R;
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  cudaError_t err = repro::set_smem(
      reinterpret_cast<const void*>(&fwht_kernel<T, R>), smem);
  if (err != cudaSuccess) return err;
  fwht_kernel<T, R><<<rows, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, int rows, int n,
                     cudaStream_t stream) {
  switch (n / repro::butterfly_threads(n)) {
    case 1: return launch<T, 1>(x, out, rows, n, stream);
    case 2: return launch<T, 2>(x, out, rows, n, stream);
    case 4: return launch<T, 4>(x, out, rows, n, stream);
    case 8: return launch<T, 8>(x, out, rows, n, stream);
    case 16: return launch<T, 16>(x, out, rows, n, stream);
    case 32: return launch<T, 32>(x, out, rows, n, stream);
    case 64: return launch<T, 64>(x, out, rows, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_fwht(const void* x, void* out, int rows, int n,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || n <= 0 || (n & (n - 1)) || n > 32768)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(x, out, rows, n, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(x, out, rows, n, st);
  return cudaErrorInvalidValue;
}
