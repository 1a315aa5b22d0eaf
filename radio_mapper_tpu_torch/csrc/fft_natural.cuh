// The Stockham radix passes of kernel K7 on one row of N points held in a
// block's registers, 16 points a thread (fft_natural_radix.cu, whose
// header comment describes the plan, the exchange buffer's swizzle and the
// twiddle tables), shared by the one-block radix design and the cluster
// design's 16384-point sub-FFTs (fft_natural_cluster.cu).
// tests/test_torch_fft_natural_radix.py replays these index maps in numpy.

#pragma once

#include <cuda_runtime.h>

namespace rm_k7 {

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

// The last pass (R, NS = N / R) of a cluster block: output r of butterfly
// j, bin t + T*(b + B*r) of the sub-FFT, to that element of the exchange
// buffer (the same swizzle as exchange's), for the partners to read.
// Call after a barrier that ends the previous exchange's reads.
template <int N, int R>
__device__ __forceinline__ void store_shared(const float2 (&v)[POINTS], float* sre, float* sim) {
  constexpr int T = N / POINTS, B = POINTS / R, BITS = log2_of(R);
  const int t = static_cast<int>(threadIdx.x);
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 x = v[b + B * brev_bits(r, BITS)];
      const int a = swizzle(t + T * (b + B * r));
      sre[a] = x.x;
      sim[a] = x.y;
    }
  }
}

}  // namespace rm_k7
