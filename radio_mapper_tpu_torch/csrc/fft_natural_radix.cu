// Kernel K7, radix design: forward natural-order FFT of [rows, n] rows for
// n = 4096, 8192 and 16384, one thread block a row, the row in registers.
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows (body
// _fft_rows_kernel) for the rows that fit one SM. Python wrapper, plan,
// tables and plain PyTorch version: radio_mapper_tpu_torch/ops/cuda/
// fft_natural.py (design(n) == "radix"; longer rows take the tiled design
// of fft_rows.cu). tests/test_torch_fft_natural_radix.py replays this
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

namespace {

constexpr int POINTS = 16;  // fft_natural.POINTS
constexpr int RADIX = 16;   // fft_natural.RADIX

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

__host__ __device__ constexpr int brev_bits(int x, int bits) {
  int y = 0;
  for (int i = 0; i < bits; ++i) y |= ((x >> i) & 1) << (bits - 1 - i);
  return y;
}

// The exchange buffer's word for element a of a plane.
__device__ __forceinline__ int swizzle(int a) { return a ^ ((a >> 5) & 31); }

// cos and sin of 2*pi*e/16, e = 1..3, float64 rounded once.
constexpr float C1 = 0.923879532511286756f;
constexpr float S1 = 0.382683432365089772f;
constexpr float H = 0.707106781186547524f;

// a * W_16^e, W_16 = exp(-2*pi*i/16), 0 <= e < 8; e is a constant once
// the callers' loops are unrolled.
__device__ __forceinline__ float2 mul_w16(float2 a, int e) {
  switch (e) {
    case 0: return a;
    case 1: return cmul(a, make_float2(C1, -S1));
    case 2: return make_float2((a.x + a.y) * H, (a.y - a.x) * H);
    case 3: return cmul(a, make_float2(S1, -C1));
    case 4: return make_float2(a.y, -a.x);
    case 5: return cmul(a, make_float2(-S1, -C1));
    case 6: return make_float2((a.y - a.x) * H, -(a.x + a.y) * H);
    default: return cmul(a, make_float2(-C1, -S1));
  }
}

// Radix-2 DIF FFT of R <= 16 points held in v[base + stride*i]: the pair
// (i, i + h) of sub-size 2h becomes (a + b, (a - b) * W_2h^(i mod h)),
// W_2h^u = W_16^(u*8/h). Position i then holds output brev(i).
template <int R>
__device__ __forceinline__ void dif(float2 (&v)[POINTS], int base, int stride) {
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i & h) continue;
      const float2 a = v[base + stride * i], b = v[base + stride * (i + h)];
      v[base + stride * i] = cadd(a, b);
      v[base + stride * (i + h)] = mul_w16(csub(a, b), (i & (h - 1)) * (8 / h));
    }
  }
}

// The butterflies of pass (R, NS): butterfly b of the thread is j = t + T*b
// on registers b + B*r. tw: the pass's [R-1][NS] twiddles.
template <int N, int R, int NS>
__device__ __forceinline__ void butterflies(float2 (&v)[POINTS], const float2* __restrict__ tw) {
  constexpr int T = N / POINTS, B = POINTS / R;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    if constexpr (NS > 1) {
      const int k = (static_cast<int>(threadIdx.x) + T * b) & (NS - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) v[b + B * r] = cmul(v[b + B * r], __ldg(tw + (r - 1) * NS + k));
    }
    dif<R>(v, b, B);
  }
}

// Hands pass (R, NS)'s outputs to the next pass through shared memory:
// output r of butterfly j (register b + B*brev(r)) to element
// (j / NS)*NS*R + j mod NS + r*NS, then register m reads element t + T*m.
// AFTER_READ: the buffer was read by the previous exchange, so wait for
// every thread to finish that read before writing.
template <int N, int R, int NS, bool AFTER_READ>
__device__ __forceinline__ void exchange(float2 (&v)[POINTS], float* sre, float* sim) {
  constexpr int T = N / POINTS, B = POINTS / R, BITS = log2_of(R);
  const int t = static_cast<int>(threadIdx.x);
  if constexpr (AFTER_READ) __syncthreads();
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int j = t + T * b;
    const int base = (j & ~(NS - 1)) * R + (j & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = swizzle(base + r * NS);
      const float2 x = v[b + B * brev_bits(r, BITS)];
      sre[a] = x.x;
      sim[a] = x.y;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < POINTS; ++m) {
    const int a = swizzle(t + T * m);
    v[m] = make_float2(sre[a], sim[a]);
  }
}

// The last pass (R, NS = N / R) stores output r of butterfly j to natural
// bin j + r*N/R = t + T*(b + B*r).
template <int N, int R>
__device__ __forceinline__ void store(const float2 (&v)[POINTS], float* fre, float* fim) {
  constexpr int T = N / POINTS, B = POINTS / R, BITS = log2_of(R);
  const int t = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 x = v[b + B * brev_bits(r, BITS)];
      __stcs(fre + t + T * (b + B * r), x.x);
      __stcs(fim + t + T * (b + B * r), x.y);
    }
  }
}

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
