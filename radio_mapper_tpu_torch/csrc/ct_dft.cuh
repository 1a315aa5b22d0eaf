// Shared device code of the port's kernels: complex multiply-adds and the
// two in-place stages of the forward CT-order four-step DFT.
//
// Used by kernel K1 (fft_detect.cu, FFT + detect) and kernel K3
// (fft_rows_ct.cu, FFT alone); kernel K2/K5/K6 (gcc_pair.cu) uses the
// complex helpers. The stages are the body of
// radio_mapper_tpu/ops/pallas/fft_kernel.py::ct_fft_core.
//
// Layout: a row of n = n1*n2 samples is x[q][p] at time q*n1 + p. The
// transform emits bin k = k2 + n2*k1 at CT address m = k2*n1 + k1:
//   B[k2][p] = sum_q W2[k2][q] x[q][p]          (inner n2-point DFT)
//   C[k2][p] = B[k2][p] * TW[k2][p]             (twiddle W_n^{k2 p})
//   D[k2][k1] = sum_p C[k2][p] W1[p][k1]        (outer n1-point DFT)
// The row lives in shared memory and both stages run in place: a stage
// reads a set of columns (rows) into register accumulators, the block
// synchronises, and the results overwrite exactly the columns (rows) that
// were read. Each stage ends with __syncthreads().

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

// Inner n2-point DFT over q with the twiddle folded into the write-back,
// 32 columns at a time; lane = column, warp w owns output rows
// k2 = w + WARPS*j (W2 loads are warp-uniform). Needs n1 % 32 == 0 and
// n2 <= (THREADS/32) * MAX_KJ.
template <int THREADS, int MAX_KJ>
__device__ __forceinline__ void inner_dft(float2* xs, const float2* __restrict__ w2,
                                          const float2* __restrict__ tw, int n1, int n2) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int p0 = 0; p0 < n1; p0 += 32) {
    const int p = p0 + lane;
    float2 acc[MAX_KJ];
#pragma unroll
    for (int j = 0; j < MAX_KJ; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int q = 0; q < n2; ++q) {
      const float2 x = xs[q * n1 + p];
      const float2* wq = w2 + q;
#pragma unroll
      for (int j = 0; j < MAX_KJ; ++j) {
        const int k2 = warp + WARPS * j;
        if (k2 < n2) cmac(acc[j], __ldg(wq + k2 * n2), x);
      }
    }
    __syncthreads();  // every read of these columns is done
#pragma unroll
    for (int j = 0; j < MAX_KJ; ++j) {
      const int k2 = warp + WARPS * j;
      if (k2 < n2) xs[k2 * n1 + p] = cmul(acc[j], __ldg(tw + k2 * n1 + p));
    }
  }
  __syncthreads();
}

// Outer n1-point DFT over p, a chunk of rows at a time; thread owns output
// column k1 of rows r0 + g + groups*j (W1 loads coalesced, row reads are
// shared-memory broadcasts). Needs THREADS % n1 == 0.
template <int THREADS, int RJ>
__device__ __forceinline__ void outer_dft(float2* xs, const float2* __restrict__ w1, int n1,
                                          int n2) {
  const int tid = threadIdx.x;
  const int groups = THREADS / n1;
  const int k1 = tid % n1, g = tid / n1;
  const int chunk = groups * RJ;
  for (int r0 = 0; r0 < n2; r0 += chunk) {
    float2 acc[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int p = 0; p < n1; ++p) {
      const float2 w = __ldg(w1 + p * n1 + k1);
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int k2 = r0 + g + groups * j;
        if (k2 < n2) cmac(acc[j], xs[k2 * n1 + p], w);
      }
    }
    __syncthreads();  // every read of these rows is done
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int k2 = r0 + g + groups * j;
      if (k2 < n2) xs[k2 * n1 + k1] = acc[j];
    }
  }
  __syncthreads();
}

}  // namespace rm_ct
