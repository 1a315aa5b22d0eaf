// Kernel K3: forward CT-order four-step FFT of [rows, n] rows, one thread
// block per row.
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct (body
// fft_kernel.ct_fft_core). Python wrapper and plain PyTorch version:
// radio_mapper_tpu_torch/ops/cuda/fft_rows.py.
//
// The row lives in shared memory (n float2: 40,960 B at the wideband
// n = 5120) and the two in-place DFT stages of ct_dft.cuh -- the same code
// kernel K1 runs -- transform it; the spectra are written once, in CT
// order (bin k = k2 + n2*k1 at m = k2*n1 + k1).
//
// Bound on the H100: the direct DFT stages, n*(n1+n2) complex FMAs per row
// (0.86 M at 5120 = 128*40), issued from shared memory on the FP32 CUDA
// cores. Unlike K1 no detector state is held in registers, so the launch
// bounds ask for two 512-thread blocks per SM (at most 64 registers a
// thread): two rows in flight per SM hide each other's loads and
// barriers. Later PRs: the DFT stages on tensor cores, TMA row loads.

#include <cuda_runtime.h>

#include "ct_dft.cuh"

namespace {

constexpr int K3_THREADS = 512;  // fft_rows.THREADS
constexpr int K3_MAX_KJ = 16;    // inner DFT: n2 <= (K3_THREADS / 32) * K3_MAX_KJ = 256
constexpr int K3_RJ = 8;         // outer DFT: rows per thread per chunk

__global__ void __launch_bounds__(K3_THREADS, 2)
fft_rows_ct_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                   const float2* __restrict__ w1, const float2* __restrict__ w2,
                   const float2* __restrict__ tw,
                   float* __restrict__ fre, float* __restrict__ fim, int n1, int n2) {
  extern __shared__ float2 xs[];  // [n] complex row, CT layout
  const int n = n1 * n2;
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const float* xr = xre + off;
  const float* xi = xim + off;

  for (int m = tid; m < n; m += K3_THREADS) xs[m] = make_float2(xr[m], xi[m]);
  __syncthreads();

  rm_ct::inner_dft<K3_THREADS, K3_MAX_KJ>(xs, w2, tw, n1, n2);
  rm_ct::outer_dft<K3_THREADS, K3_RJ>(xs, w1, n1, n2);

  float* fr = fre + off;
  float* fi = fim + off;
  for (int m = tid; m < n; m += K3_THREADS) {
    const float2 v = xs[m];
    fr[m] = v.x;
    fi[m] = v.y;
  }
}

}  // namespace

extern "C" int rm_fft_rows_ct(const float* xre, const float* xim, const float2* w1,
                              const float2* w2, const float2* tw, float* fre, float* fim,
                              int rows, int n1, int n2, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n1) * n2 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fft_rows_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_rows_ct_kernel<<<rows, K3_THREADS, smem, stream>>>(xre, xim, w1, w2, tw, fre, fim, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
