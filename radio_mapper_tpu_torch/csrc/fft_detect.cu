// Kernel K1: forward CT-order four-step FFT + spectral detection, one
// thread block per row.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct
// (fft_kernel.ct_fft_core + detect_kernel._detect_body). Python wrapper and
// plain PyTorch version: radio_mapper_tpu_torch/ops/cuda/fft_detect.py.
//
// The whole row lives in shared memory (n float2, 139,264 B at n = 17408)
// and the two DFT stages of ct_dft.cuh (shared with kernel K3) run on it
// in place; see that header for the CT layout. The detect epilogue is
// ct_detect.cuh's detect_row (shared with kernels K4 and K8).
//
// Bound on the H100: the direct DFT stages, n*(n1+n2) complex FMAs per row,
// issued from shared memory and L1 on the FP32 CUDA cores. Later PRs: the
// DFT stages on tensor cores, TMA row loads, fusion with kernel K2.

#include <cuda_runtime.h>

#include "ct_detect.cuh"
#include "ct_dft.cuh"

namespace {

constexpr int K1_THREADS = 512;            // fft_detect.THREADS
constexpr int K1_MAX_KJ = 16;              // inner DFT: n2 <= (K1_THREADS/32) * K1_MAX_KJ = 256
constexpr int K1_RJ = 8;                   // outer DFT: rows per thread per chunk
constexpr int K1_MAX_PER_THREAD = 48;      // n <= K1_THREADS * 48 = 24576

using rm_det::DetectParams;

__global__ void __launch_bounds__(K1_THREADS, 1)
fft_detect_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w1, const float2* __restrict__ w2,
                  const float2* __restrict__ tw,
                  float* __restrict__ fre, float* __restrict__ fim,
                  float* __restrict__ seg_score, float* __restrict__ seg_arg,
                  float* __restrict__ nf_out, float* __restrict__ rmax_out,
                  int n1, int n2, DetectParams prm) {
  extern __shared__ float2 xs[];  // [n] complex row, CT layout

  const int n = n1 * n2;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* xr = xre + row * n;
  const float* xi = xim + row * n;

  for (int m = tid; m < n; m += K1_THREADS) xs[m] = make_float2(xr[m], xi[m]);
  __syncthreads();

  rm_ct::inner_dft<K1_THREADS, K1_MAX_KJ>(xs, w2, tw, n1, n2);
  rm_ct::outer_dft<K1_THREADS, K1_RJ>(xs, w1, n1, n2);

  // ---- write the spectra once; keep each thread's power values in
  // registers while the shared buffer is re-purposed as power + scratch.
  float* fr = fre + row * n;
  float* fi = fim + row * n;
  float pv[K1_MAX_PER_THREAD];
#pragma unroll
  for (int j = 0; j < K1_MAX_PER_THREAD; ++j) {
    const int m = tid + K1_THREADS * j;
    if (m < n) {
      const float2 v = xs[m];
      fr[m] = v.x;
      fi[m] = v.y;
      pv[j] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }
  }
  __syncthreads();
  float* pwr = reinterpret_cast<float*>(xs);  // [n] linear power, CT order
  float* aux = pwr + n;                       // [n] scratch
#pragma unroll
  for (int j = 0; j < K1_MAX_PER_THREAD; ++j) {
    const int m = tid + K1_THREADS * j;
    if (m < n) pwr[m] = pv[j];
  }
  const int s = n / rm_det::SEG;
  const float2 r = rm_det::detect_row<K1_THREADS>(pwr, aux, n1, n2, prm, seg_score + row * s,
                                                  seg_arg + row * s);
  if (tid == 0) {
    nf_out[row] = r.x;
    rmax_out[row] = r.y;
  }
}

}  // namespace

extern "C" int rm_fft_detect_rows_ct(
    const float* xre, const float* xim, const float2* w1, const float2* w2, const float2* tw,
    float* fre, float* fim, float* seg_score, float* seg_arg, float* nf, float* rmax,
    int rows, int n1, int n2, int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters,
    cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n1) * n2 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      fft_detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  fft_detect_kernel<<<rows, K1_THREADS, smem, stream>>>(
      xre, xim, w1, w2, tw, fre, fim, seg_score, seg_arg, nf, rmax, n1, n2, prm);
  return static_cast<int>(cudaGetLastError());
}
