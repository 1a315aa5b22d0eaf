// Kernel K4: spectral detection on CT-order spectra read from memory, one
// thread block per row.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::detect_ct_partials
// (detect_kernel._detect_body with emit_topk = 0). Python wrapper and plain
// PyTorch version: radio_mapper_tpu_torch/ops/cuda/detect_ct.py.
//
// The block reads its row's spectra once, writes the linear power
// fr^2 + fi^2 into shared memory (69,632 B at n = 17408) beside a scratch
// of the same size, and runs ct_detect.cuh's detect_row, the epilogue of
// kernel K1: on K1's own spectra it gives K1's partials and noise floor bit
// for bit. The reference's rows_per_block and row padding are TPU tiling
// devices and are dropped: one block per row, as K1. There is no row-max
// output (the reference's K4 emits none).
//
// Bound on the H100: device-memory bytes -- 8 bytes read per bin, 1 byte
// written per bin (the n/8 partials, two floats each); the sliding max
// reads shared memory 2*radius+1 times per bin. Later PRs: several rows per
// block for short rows, a register-tiled sliding max.

#include <cuda_runtime.h>

#include "ct_detect.cuh"

namespace {

constexpr int K4_THREADS = 512;  // detect_ct.THREADS

using rm_det::DetectParams;

__global__ void __launch_bounds__(K4_THREADS)
detect_ct_kernel(const float* __restrict__ fre, const float* __restrict__ fim,
                 float* __restrict__ seg_score, float* __restrict__ seg_arg,
                 float* __restrict__ nf_out, int n1, int n2, DetectParams prm) {
  extern __shared__ float sbuf[];  // [n] power, CT order + [n] scratch
  const int n = n1 * n2;
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* fr = fre + row * n;
  const float* fi = fim + row * n;
  float* pwr = sbuf;
  float* aux = sbuf + n;
  for (int m = tid; m < n; m += K4_THREADS) {
    const float a = fr[m], b = fi[m];
    pwr[m] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
  }
  const int s = n / rm_det::SEG;
  const float2 r = rm_det::detect_row<K4_THREADS>(pwr, aux, n1, n2, prm, seg_score + row * s,
                                                  seg_arg + row * s);
  if (tid == 0) nf_out[row] = r.x;
}

}  // namespace

extern "C" int rm_detect_ct_partials(
    const float* fre, const float* fim, float* seg_score, float* seg_arg, float* nf,
    int rows, int n1, int n2, int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters,
    cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(n1) * n2 * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      detect_ct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  detect_ct_kernel<<<rows, K4_THREADS, smem, stream>>>(fre, fim, seg_score, seg_arg, nf, n1, n2, prm);
  return static_cast<int>(cudaGetLastError());
}
