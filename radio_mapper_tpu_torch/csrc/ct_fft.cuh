// Kernel K3's forward CT-order FFT of one row held in shared memory.
//
// Layout: a row of n = 128*n2 samples is x[q][p] at time q*128 + p, kept
// as n2 "slot rows" of 128 float2. The transform emits bin k = k2 + n2*k1
// at CT address m = k2*128 + k1, as ct_dft.cuh's direct four-step does,
// but with n2 = A*r (A = min(8, 2^v2(n2))) and three in-place steps:
//
//   step A  for each column p and j < r: an A-point radix-2 FFT in
//           registers over the slots j + r*t (t < A); output k times
//           W_n2^{j*k} goes back to slot j + r*k;
//   step B  for each column p and k < A: the direct r-point DFT over the
//           slots j + r*k (j < r); X[k + A*s] times the row twiddle
//           W_n^{(k + A*s)*p} goes to slot s + r*k;
//   step C  one warp per slot row: the 128-point radix-2 FFT, two stages
//           in registers and five across lanes (__shfl_xor_sync); the
//           outputs, bit-reversed across lanes, are stored straight to
//           device memory at CT row k2 = k + A*s in natural k1 order.
//
// Every twiddle comes from a float32 table of float64 roots of unity
// (ct_plan.radix_tables, ct_constants' tw). tests/test_torch_fft_radix.py
// replays this schedule in numpy.

#pragma once

#include <cuda_runtime.h>

#include "ct_dft.cuh"

namespace rm_fft {

constexpr int N1 = 128;       // the outer length of every split K3 takes
constexpr int THREADS = 512;  // one block per row: 4 threads per column in steps A and B
constexpr int WARPS = THREADS / 32;
constexpr int STREAM_MAX_SJ = 12;  // streamed step B: r <= WARPS * STREAM_MAX_SJ = 192

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__host__ __device__ constexpr int brev_bits(int x, int bits) {
  int y = 0;
  for (int i = 0; i < bits; ++i) y |= ((x >> i) & 1) << (bits - 1 - i);
  return y;
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// Radix-2 DIF over v[0..L) in registers: the pair (t, t + h) of sub-size
// 2h becomes (a + b, (a - b) * W_2h^(t mod h)), W_2h^u = W_128^(u*64/h).
// Position t then holds output brev(t).
template <int L>
__device__ __forceinline__ void dif_regs(float2 (&v)[L], const float2* w128) {
#pragma unroll
  for (int h = L / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if (t & h) continue;
      const float2 a = v[t], b = v[t + h];
      const int e = (t & (h - 1)) * (64 / h);
      v[t] = cadd(a, b);
      v[t + h] = e ? rm_ct::cmul(csub(a, b), w128[e]) : csub(a, b);
    }
  }
}

// Step A. Thread (p, j0) takes j = j0, j0 + 4, ... < r.
template <int A>
__device__ __forceinline__ void step_a(float2* xs, const float2* w128, const float2* __restrict__ wn2,
                                       int r) {
  const int p = threadIdx.x & (N1 - 1);
  for (int j = threadIdx.x / N1; j < r; j += THREADS / N1) {
    float2 v[A];
#pragma unroll
    for (int t = 0; t < A; ++t) v[t] = xs[(j + r * t) * N1 + p];
    dif_regs<A>(v, w128);
#pragma unroll
    for (int t = 0; t < A; ++t) {
      constexpr int bits = log2_of(A);
      const int k = brev_bits(t, bits);
      xs[(j + r * k) * N1 + p] = k ? rm_ct::cmul(v[t], __ldg(wn2 + j * k)) : v[t];
    }
  }
}

// Step B with the r inputs of a column in registers (r <= RMAX). Thread
// (p, k0) takes k = k0, k0 + 4, ... < A; the W_r loads are warp-uniform.
template <int A, int RMAX>
__device__ __forceinline__ void step_b(float2* xs, const float2* __restrict__ wr,
                                       const float2* __restrict__ tw, int r) {
  const int p = threadIdx.x & (N1 - 1);
  for (int k = threadIdx.x / N1; k < A; k += THREADS / N1) {
    float2* col = xs + r * k * N1 + p;
    float2 y[RMAX];
#pragma unroll
    for (int j = 0; j < RMAX; ++j) y[j] = j < r ? col[j * N1] : make_float2(0.f, 0.f);
    for (int s = 0; s < r; ++s) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < r) rm_ct::cmac(acc, __ldg(wr + j * r + s), y[j]);
      col[s * N1] = rm_ct::cmul(acc, __ldg(tw + (k + A * s) * N1 + p));
    }
  }
}

// Step B for r too large for registers: 32 columns at a time, lane =
// column, warp w owns outputs s = w + WARPS*i; the inputs stream from
// shared memory, as ct_dft.cuh's inner_dft does. Ends with a barrier.
template <int A>
__device__ __forceinline__ void step_b_stream(float2* xs, const float2* __restrict__ wr,
                                              const float2* __restrict__ tw, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < A; ++k) {
    for (int p0 = 0; p0 < N1; p0 += 32) {
      const int p = p0 + lane;
      float2* col = xs + r * k * N1 + p;
      float2 acc[STREAM_MAX_SJ];
#pragma unroll
      for (int i = 0; i < STREAM_MAX_SJ; ++i) acc[i] = make_float2(0.f, 0.f);
      for (int j = 0; j < r; ++j) {
        const float2 y = col[j * N1];
#pragma unroll
        for (int i = 0; i < STREAM_MAX_SJ; ++i) {
          const int s = warp + WARPS * i;
          if (s < r) rm_ct::cmac(acc[i], __ldg(wr + j * r + s), y);
        }
      }
      __syncthreads();  // every read of these columns is done
#pragma unroll
      for (int i = 0; i < STREAM_MAX_SJ; ++i) {
        const int s = warp + WARPS * i;
        if (s < r) col[s * N1] = rm_ct::cmul(acc[i], __ldg(tw + (k + A * s) * N1 + p));
      }
      __syncthreads();
    }
  }
}

// Step C and the store. Lane l holds positions p = 4l + i (i < 4); the
// stages of half-size h = 64..4 pair lane l with lane l ^ (h/4), h = 2
// and 1 pair registers. Position 4l + i then holds bin brev7(4l + i) =
// brev2(i)*32 + brev5(l), so each i stores 32 consecutive floats a plane.
__device__ __forceinline__ void step_c_store(const float2* xs, const float2* w128, float* fr, float* fi,
                                             int n2, int a, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k1_lane = static_cast<int>(__brev(lane) >> 27);
  for (int sr = warp; sr < n2; sr += WARPS) {
    const float4* row4 = reinterpret_cast<const float4*>(xs + sr * N1) + 2 * lane;
    const float4 lo = row4[0], hi = row4[1];
    float2 v[4] = {make_float2(lo.x, lo.y), make_float2(lo.z, lo.w), make_float2(hi.x, hi.y),
                   make_float2(hi.z, hi.w)};
#pragma unroll
    for (int h = 64; h >= 4; h >>= 1) {
      const int d = h >> 2;
      const bool top = (lane & d) == 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 w = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, d),
                                     __shfl_xor_sync(0xffffffffu, v[i].y, d));
        const int e = ((4 * lane + i) & (h - 1)) * (64 / h);
        v[i] = top ? cadd(v[i], w) : rm_ct::cmul(csub(w, v[i]), w128[e]);
      }
    }
    dif_regs<4>(v, w128);
    const int k = sr / r, s = sr - r * k;
    const size_t base = static_cast<size_t>(k + a * s) * N1 + k1_lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k1 = brev_bits(i, 2) * 32;
      fr[base + k1] = v[i].x;
      fi[base + k1] = v[i].y;
    }
  }
}

}  // namespace rm_fft
