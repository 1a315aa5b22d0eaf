// Kernel K1 (and K3's long rows) at n1 = 640 and 896, the wide design
// (fft_detect_cluster.cuh): those instantiations, in a translation unit
// apart from n1 = 384's (fft_detect_cluster.cu holds the entries).

#include "fft_detect_cluster.cuh"

Kernel rm_wide_kernel_mixed(int n1, int n2, int a, int r, int detect, int topk, int* min_blocks) {
  switch (n1) {
    case 640: return kernel_at<640>(n2, a, r, detect, topk, min_blocks);
    case 896: return kernel_at<896>(n2, a, r, detect, topk, min_blocks);
    default: return nullptr;
  }
}
