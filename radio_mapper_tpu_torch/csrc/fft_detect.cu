// Kernel K1: forward CT-order FFT + spectral detection, one thread block
// per row (the one-block design, n <= 24576): the route with emit_topk
// (the in-kernel top-K), and the card's comparison for the cluster design
// (fft_rows_ct_cluster.cu), which takes K1 without emit_topk at every
// n1 = 128/256 length.
//
// Replaces radio_mapper_tpu/ops/pallas/detect_kernel.py::fft_detect_rows_ct
// (fft_kernel.ct_fft_core + detect_kernel._detect_body). Python wrapper and
// plain PyTorch version: radio_mapper_tpu_torch/ops/cuda/fft_detect.py.
//
// The whole row lives in shared memory (n float2, 139,264 B at n = 17408,
// and W_128 after it) and ct_fft.cuh's fft_power_row transforms it in
// place with kernel K3's steps: an 8-point radix-2 FFT and a direct
// r-point DFT (r = n2/8 <= 24, in registers) for the inner n2 points, then
// a warp-shuffle 128-point FFT per slot row that stores the spectra to
// device memory, coalesced, as K3 does (so K1's spectra are K3's bit for
// bit) and keeps each value's power in registers (at most 48 a thread).
// After a barrier the powers overwrite the row in CT order and the detect
// epilogue, ct_detect.cuh's detect_row (shared with kernels K4 and K8),
// runs on them. With emit_topk = K the segment partials go to shared memory
// over the power (no longer read) and ct_detect.cuh's block_topk writes
// the row's [128] block of top-K values and packed 8*f + offset instead
// (detect_kernel._detect_body's emit_topk).
//
// Bound on the H100: device-memory bytes, a row read and its spectrum
// written once (16 B a sample); the radix steps are a few passes over the
// row in shared memory, and the detect body's sliding max reads it
// 2*radius + 1 times. One 512-thread block an SM (a 139 KB row at 17408).
// Later PRs: the detect body (register-tiled sliding max), TMA row loads,
// fusion with kernel K2.

#include <cuda_runtime.h>

#include "ct_detect.cuh"
#include "ct_fft.cuh"

namespace {

constexpr int K1_THREADS = 512;  // fft_detect.THREADS
static_assert(K1_THREADS == rm_fft::THREADS, "K1 runs ct_fft.cuh's steps at their block size");

using rm_det::DetectParams;
using rm_fft::N1;

template <int RMAX>
__global__ void __launch_bounds__(K1_THREADS, 1)
fft_detect_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                  const float2* __restrict__ w128, const float2* __restrict__ wn2,
                  const float2* __restrict__ wr, const float2* __restrict__ tw,
                  float* __restrict__ fre, float* __restrict__ fim,
                  float* __restrict__ seg_score, float* __restrict__ seg_arg,
                  float* __restrict__ nf_out, float* __restrict__ rmax_out,
                  int n2, int r, DetectParams prm, int topk) {
  extern __shared__ float4 smem[];  // float4: step C reads a lane's 4 values as two float4
  float2* xs = reinterpret_cast<float2*>(smem);  // [n2][128] slot rows, then [64] W_128
  const int n = N1 * n2;
  const size_t row = blockIdx.x;
  const size_t off = row * n;

  rm_fft::fft_power_row<RMAX>(xre + off, xim + off, w128, wn2, wr, tw, fre + off, fim + off, xs, n2, r);
  float* pwr = reinterpret_cast<float*>(xs);  // [n] linear power, CT order
  float* aux = pwr + n;                       // [n] scratch
  const int s = n / rm_det::SEG;
  if (topk == 0) {
    const float2 res = rm_det::detect_row<K1_THREADS>(pwr, aux, N1, n2, prm, seg_score + row * s,
                                                      seg_arg + row * s);
    if (threadIdx.x == 0) {
      nf_out[row] = res.x;
      rmax_out[row] = res.y;
    }
    return;
  }
  // emit_topk: the partials over the power (read for the last time before
  // detect_row's segment pass), then the K passes
  const float2 res = rm_det::detect_row<K1_THREADS>(pwr, aux, N1, n2, prm, pwr, pwr + s);
  __syncthreads();
  rm_det::block_topk<K1_THREADS>(pwr, pwr + s, s, topk, seg_score + row * rm_det::TOPK_LANES,
                                 seg_arg + row * rm_det::TOPK_LANES);
  if (threadIdx.x == 0) {
    nf_out[row] = res.x;
    rmax_out[row] = res.y;
  }
}

template <int RMAX>
int launch(const float* xre, const float* xim, const float2* w128, const float2* wn2, const float2* wr,
           const float2* tw, float* fre, float* fim, float* seg_score, float* seg_arg, float* nf,
           float* rmax, int rows, int n2, int r, const DetectParams& prm, int topk, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N1) * n2 + N1 / 2) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(fft_detect_kernel<RMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_detect_kernel<RMAX><<<rows, K1_THREADS, smem, stream>>>(
      xre, xim, w128, wn2, wr, tw, fre, fim, seg_score, seg_arg, nf, rmax, n2, r, prm, topk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rm_fft_detect_rows_ct(
    const float* xre, const float* xim, const float2* w128, const float2* wn2, const float2* wr,
    const float2* tw, float* fre, float* fim, float* seg_score, float* seg_arg, float* nf, float* rmax,
    int rows, int n2, int a, int r, int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters, int topk,
    cudaStream_t stream) {
  if (a != rm_fft::HANDOFF_A || a * r != n2 || topk < 0 || topk > rm_det::TOPK_LANES) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  switch (rm_fft::handoff_rmax(r)) {
    case 8:
      return launch<8>(xre, xim, w128, wn2, wr, tw, fre, fim, seg_score, seg_arg, nf, rmax, rows, n2, r, prm,
                       topk, stream);
    case 16:
      return launch<16>(xre, xim, w128, wn2, wr, tw, fre, fim, seg_score, seg_arg, nf, rmax, rows, n2, r, prm,
                        topk, stream);
    case 24:
      return launch<24>(xre, xim, w128, wn2, wr, tw, fre, fim, seg_score, seg_arg, nf, rmax, rows, n2, r, prm,
                        topk, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
