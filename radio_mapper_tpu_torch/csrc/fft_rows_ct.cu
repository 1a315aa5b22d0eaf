// Kernel K3: forward CT-order FFT of [rows, n] rows, one thread block per
// row, n = 128*n2 <= 24576.
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows_ct (body
// fft_kernel.ct_fft_core). Python wrapper and plain PyTorch version:
// radio_mapper_tpu_torch/ops/cuda/fft_rows.py.
//
// The row lives in shared memory (n float2: 40,960 B at the wideband
// n = 5120, 139,264 B at the flagship 17408) and the steps of ct_fft.cuh
// transform it in place: an A-point radix-2 FFT and a direct r-point DFT
// for the inner n2 = A*r points, then a warp-shuffle 128-point radix-2
// FFT per slot row that stores the spectra once, coalesced, in CT order
// (bin k = k2 + n2*k1 at m = k2*128 + k1).
//
// Bound on the H100: device-memory bytes, a row read and its spectrum
// written once (16 B a sample), then the three block barriers between the
// loads and the stores. The direct four-step this replaces issued
// n*(128 + n2) complex FMAs a row from shared memory (0.86 M at 5120);
// the inner work is now 128*A*r^2 FMAs (25.6 k at 5120) plus radix-2
// butterflies, so shared memory sees a handful of passes over the row.
// Launch bounds: two blocks an SM while step B holds at most 16 inputs
// in registers (64 registers a thread), one otherwise (a 139 KB row at
// 17408 allows one anyway). Later PRs: TMA row loads, tensor cores.

#include <cuda_runtime.h>

#include "ct_fft.cuh"

namespace {

using rm_fft::N1;
using rm_fft::THREADS;

// RMAX > 0: step B holds up to RMAX inputs in registers; RMAX == 0: it
// streams them from shared memory.
template <int A, int RMAX>
__global__ void __launch_bounds__(THREADS, (RMAX > 0 && RMAX <= 16) ? 2 : 1)
fft_rows_ct_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                   const float2* __restrict__ w128, const float2* __restrict__ wn2,
                   const float2* __restrict__ wr, const float2* __restrict__ tw,
                   float* __restrict__ fre, float* __restrict__ fim, int n2, int r) {
  extern __shared__ float4 smem[];  // float4: step C reads a lane's 4 values as two float4
  float2* xs = reinterpret_cast<float2*>(smem);  // [n2][128] slot rows
  const int n = N1 * n2;
  float2* w128s = xs + n;  // [64] W_128^e
  const int tid = threadIdx.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const float* xr = xre + off;
  const float* xi = xim + off;

#pragma unroll 4
  for (int m = tid; m < n; m += THREADS) xs[m] = make_float2(xr[m], xi[m]);
  if (tid < N1 / 2) w128s[tid] = w128[tid];
  __syncthreads();

  if constexpr (A > 1) {
    rm_fft::step_a<A>(xs, w128s, wn2, r);
    __syncthreads();
  }
  if constexpr (RMAX > 0) {
    rm_fft::step_b<A, RMAX>(xs, wr, tw, N1, xs, N1, r);
    __syncthreads();
  } else {
    rm_fft::step_b_stream<A>(xs, wr, tw, N1, xs, N1, r);
  }
  rm_fft::step_c_store(xs, w128s, fre + off, fim + off, n2, A, r);
}

template <int A, int RMAX>
int launch(const float* xre, const float* xim, const float2* w128, const float2* wn2,
           const float2* wr, const float2* tw, float* fre, float* fim, int rows, int n2, int r,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N1) * n2 + N1 / 2) * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(fft_rows_ct_kernel<A, RMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_rows_ct_kernel<A, RMAX><<<rows, THREADS, smem, stream>>>(xre, xim, w128, wn2, wr, tw, fre,
                                                               fim, n2, r);
  return static_cast<int>(cudaGetLastError());
}

template <int A>
int launch_a(const float* xre, const float* xim, const float2* w128, const float2* wn2,
             const float2* wr, const float2* tw, float* fre, float* fim, int rows, int n2, int r,
             cudaStream_t stream) {
  if (r <= 8) return launch<A, 8>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
  if (r <= 16) return launch<A, 16>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
  if (r <= 24) return launch<A, 24>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
  if (r <= rm_fft::WARPS * rm_fft::STREAM_MAX_SJ)
    return launch<A, 0>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rm_fft_rows_ct(const float* xre, const float* xim, const float2* w128,
                              const float2* wn2, const float2* wr, const float2* tw, float* fre,
                              float* fim, int rows, int n2, int a, int r, cudaStream_t stream) {
  if (a * r != n2) return static_cast<int>(cudaErrorInvalidValue);
  switch (a) {
    case 1: return launch_a<1>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
    case 2: return launch_a<2>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
    case 4: return launch_a<4>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
    case 8: return launch_a<8>(xre, xim, w128, wn2, wr, tw, fre, fim, rows, n2, r, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
