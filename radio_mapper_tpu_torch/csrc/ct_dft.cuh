// Shared device code of the port's kernels: the complex multiply and
// multiply-add, with every product an explicit fmaf, so each kernel that
// inlines them rounds the same way.
//
// Used by ct_fft.cuh (the forward radix steps of kernels K3, K1 and K8)
// and gcc_pair_wide.cuh (the pair body of kernels K2, K5, K6 and K8).

#pragma once

#include <cuda_runtime.h>

namespace rm_ct {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

}  // namespace rm_ct
