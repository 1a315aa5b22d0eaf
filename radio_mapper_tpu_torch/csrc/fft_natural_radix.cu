// Kernel K7, radix design: forward natural-order FFT of [rows, n] rows for
// n = 4096, 8192 and 16384, one thread block a row, the row in registers.
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows (body
// _fft_rows_kernel) for the rows that fit one SM. Python wrapper, plan,
// tables and plain PyTorch version: radio_mapper_tpu_torch/ops/cuda/
// fft_natural.py (design(n) == "radix"; 32768 and 65536 take the cluster
// design of fft_natural_cluster.cu, which runs these passes as its
// 16384-point sub-FFTs: fft_natural.cuh). tests/test_torch_fft_natural_radix.py replays this
// schedule, its shared-memory index maps and its tables in numpy.
//
// Bound on the H100: device-memory bytes, each row read once and its
// spectrum written once, 16 B a point (0.641 ms at [8192, 16384] at 3.35
// TB/s). The FFT's 5*n*log2(n) FLOP are a fifth of that at 67 TFLOP/s.
//
// Design. A block of T = n / POINTS threads holds the row in registers,
// POINTS = 16 complex points a thread: register m of thread t holds point
// t + T*m of the current pass's input. The transform is a Stockham
// (autosort) plan of radix-16 passes and a last radix-2 or radix-4 pass,
// 16384 = 16*16*16*4, 8192 = 16*16*16*2, 4096 = 16*16*16:
//   pass (R, NS), NS = product of the earlier radices: butterfly j < n/R
//   takes the inputs j + r*n/R (registers b + B*r of thread j mod T,
//   b = j / T, B = POINTS / R), multiplies input r by W_{NS*R}^{r*(j mod
//   NS)}, runs the R-point FFT (radix-2 DIF in registers, W_16 constants)
//   and writes output r to (j / NS)*NS*R + j mod NS + r*NS.
// After the last pass that address is the natural bin, and it equals
// t + T*m again, so:
//   - the loads go straight from device memory to registers, consecutive
//     threads on consecutive addresses, all 2*POINTS of a thread issued
//     before its first arithmetic (128 KiB in flight an SM at 16384);
//   - the last pass stores straight from registers to natural order, also
//     coalesced; there is no transpose, no CT-order intermediate and no
//     device-memory scratch;
//   - between passes (at most three exchanges) shared memory is only the
//     exchange buffer: planar re/im, 2*4*n bytes (128 KiB at 16384), word
//     a stored at a ^ ((a >> 5) & 31). The swizzle makes the first pass's
//     stride-16 write conflict-free and keeps every other write at most
//     two accesses a bank per warp; the reads, 32 consecutive words a
//     warp, stay conflict-free.
// Twiddles: fft_natural.radix_plan's float32 table of float64 roots of
// unity, rounded once, one [R-1][NS] block per pass after the first, read
// with __ldg (consecutive j on consecutive entries). FP32 on the CUDA
// cores throughout.
//
// Registers: __launch_bounds__(T, 16384 / n) caps a thread at 64
// registers (1024 threads at 16384, one block an SM; two and four blocks
// at 8192 and 4096). -Xptxas -v (sm_90a): 64 registers and no spills at
// 16384 and 4096; at 8192, 64 registers and 8 bytes spilled. So the form
// is n/16 threads x 16 points at every length: the routed length 16384
// does not spill, and 8192 is on no path. (n/32 threads x 32 points, at
// 128 registers, spilled at all three lengths.)
//
// What holds it back at 16384: one 1024-thread block an SM, so a row's
// loads and stores do not overlap another row's passes and exchanges;
// the shorter lengths run two and four blocks an SM and come nearer the
// bytes bound (PERF.md).

#include <cuda_runtime.h>

#include "fft_natural.cuh"

namespace {

using namespace rm_k7;

// RL: the last pass's radix, 1 when N = 16^3 has no fourth pass. Twiddle
// blocks: pass (16, 16) at 0, (16, 256) at 15*16, (RL, 4096) at
// 15*16 + 15*256 (fft_natural.radix_plan's offsets).
template <int N, int RL>
__global__ void __launch_bounds__(N / POINTS, 16384 / N)
fft_natural_radix_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                         const float2* __restrict__ tw, float* __restrict__ fre,
                         float* __restrict__ fim) {
  constexpr int T = N / POINTS;
  extern __shared__ float smem[];
  float* sre = smem;     // [N], swizzled
  float* sim = smem + N;  // [N], swizzled
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  const int t = static_cast<int>(threadIdx.x);

  float2 v[POINTS];
#pragma unroll
  for (int m = 0; m < POINTS; ++m) v[m].x = __ldcs(xre + off + t + T * m);
#pragma unroll
  for (int m = 0; m < POINTS; ++m) v[m].y = __ldcs(xim + off + t + T * m);

  butterflies<N, RADIX, 1>(v, nullptr);
  exchange<N, RADIX, 1, false>(v, sre, sim);
  butterflies<N, RADIX, 16>(v, tw);
  exchange<N, RADIX, 16, true>(v, sre, sim);
  butterflies<N, RADIX, 256>(v, tw + 15 * 16);
  if constexpr (RL == 1) {
    store<N, RADIX>(v, fre + off, fim + off);
  } else {
    exchange<N, RADIX, 256, true>(v, sre, sim);
    butterflies<N, RL, 4096>(v, tw + 15 * 16 + 15 * 256);
    store<N, RL>(v, fre + off, fim + off);
  }
}

template <int N, int RL>
int launch(const float* xre, const float* xim, const float2* tw, float* fre, float* fim, int rows,
           cudaStream_t stream) {
  constexpr int smem = 2 * N * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(fft_natural_radix_kernel<N, RL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fft_natural_radix_kernel<N, RL><<<rows, N / POINTS, smem, stream>>>(xre, xim, tw, fre, fim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward FFT of `rows` rows of n points, natural bin order. tw:
// fft_natural.radix_plan(n).twiddles as float2.
extern "C" int rm_fft_natural_radix(const float* xre, const float* xim, const float2* tw, float* fre,
                                    float* fim, int rows, int n, cudaStream_t stream) {
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 4096: return launch<4096, 1>(xre, xim, tw, fre, fim, rows, stream);
    case 8192: return launch<8192, 2>(xre, xim, tw, fre, fim, rows, stream);
    case 16384: return launch<16384, 4>(xre, xim, tw, fre, fim, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
