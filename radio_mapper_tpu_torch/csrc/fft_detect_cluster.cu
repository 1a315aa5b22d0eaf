// Kernel K1 (and K3's long rows) at n1 = 384, 640, 896, the wide design
// (fft_detect_cluster.cuh): its n1 = 384 instantiations and the entries
// rm_fft_detect_wide and rm_fft_detect_wide_info, which take every n1
// (640 and 896 from fft_detect_cluster_mixed.cu).

#include "fft_detect_cluster.cuh"

namespace {

Kernel kernel_for(int n1, int n2, int a, int r, int detect, int topk, int* min_blocks) {
  switch (n1) {
    case 384: return kernel_at<384>(n2, a, r, detect, topk, min_blocks);
    case 640:
    case 896: return rm_wide_kernel_mixed(n1, n2, a, r, detect, topk, min_blocks);
    default: return nullptr;
  }
}

bool topk_fits_for(int n1, int n2, int r, int radius, int topk) {
  switch (n1) {
    case 384: return topk_fits<384>(n2, r, radius, topk);
    case 640: return topk_fits<640>(n2, r, radius, topk);
    default: return topk_fits<896>(n2, r, radius, topk);
  }
}

size_t smem_for(int n1, int n2, int detect) {
  switch (n1) {
    case 384: return smem_bytes<384>(n2, detect != 0);
    case 640: return smem_bytes<640>(n2, detect != 0);
    default: return smem_bytes<896>(n2, detect != 0);
  }
}

}  // namespace

// w1: W_n1^e (e < n1/2); wn2, wr: ct_plan.radix_tables' (wr [r][r]); tw:
// ct_constants' twiddle. detect = 0: K3 (seg_score ... rmax unused, may
// be null); detect = 1: K1's outputs, 2 <= radius <= n2; with topk = K in
// 1 .. 128 (emit_topk) the [rows, 128] top-K values and packed 8*f +
// offset in place of the partials. Rows 16-byte aligned (the wrapper
// checks).
extern "C" int rm_fft_detect_wide(const float* xre, const float* xim, const float2* w1, const float2* wn2,
                                  const float2* wr, const float2* tw, float* fre, float* fim, float* seg_score,
                                  float* seg_arg, float* nf, float* rmax, int rows, int n1, int n2, int a, int r,
                                  int detect, int radius, int keep_lo, int keep_hi, float thr_lin, int has_conf,
                                  float conf_cs, float off, int bisect_iters, int topk, cudaStream_t stream) {
  int min_blocks = 0;
  const Kernel k = kernel_for(n1, n2, a, r, detect, detect ? topk : 0, &min_blocks);
  if (k == nullptr || rows <= 0 || rows > 0x7fffffff / C || (detect && (radius < 2 || radius > n2)) ||
      (detect && topk != 0 && !topk_fits_for(n1, n2, r, radius, topk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
  return rm_cluster::launch(k, rows * C, THREADS, smem_for(n1, n2, detect), C, stream, xre, xim, w1, wn2, wr,
                            tw, fre, fim, seg_score, seg_arg, nf, rmax, n2, r, prm, detect ? topk : 0);
}

// The design's shape on this card (detect with topk > 0: K1's top-K
// instantiation): dynamic shared memory a block, blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// cudaOccupancyMaxActiveClusters, registers a thread, local memory and the
// instantiation's __launch_bounds__ blocks an SM (MIN_BLOCKS).
extern "C" int rm_fft_detect_wide_info(int n1, int n2, int a, int r, int detect, int topk, int* smem, int* blocks,
                                       int* clusters, int* registers, int* local_bytes, int* min_blocks) {
  const Kernel k = kernel_for(n1, n2, a, r, detect, detect ? topk : 0, min_blocks);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_for(n1, n2, detect);
  *smem = static_cast<int>(bytes);
  cudaError_t e = rm_cluster::occupancy(k, THREADS, bytes, C, clusters);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, THREADS, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes attr{};
  e = cudaFuncGetAttributes(&attr, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  *registers = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}
