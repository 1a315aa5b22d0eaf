// The mixed-radix core of kernels K9 and K10 (pair_fft.cu): radix-2, 3,
// 4, 5 and 8 butterflies on float2 (re, im) values in registers, and one
// Stockham pass of a block over sequences held in shared memory or read
// from device memory. tests/test_torch_mixed_fft.py replays these passes,
// their index maps and their twiddle tables in numpy.
//
// Stockham (autosort) plan of a length N = R_0 * R_1 * ... : pass (R, NS),
// NS the product of the earlier radices, runs butterfly j < N/R on the
// inputs j + r*N/R (r < R), multiplies input r by W_{NS*R}^{r*(j mod NS)},
// runs the R-point DFT and writes output r to (j / NS)*NS*R + j mod NS +
// r*NS. After the last pass that address is the natural bin. The same plan
// runs forward (W = exp(-2*pi*i/N)) and inverse (its conjugate, no 1/N).
//
// Twiddles: a float32 table of W_N^e, e < N, of float64 roots rounded once
// (pair_fft.tables); pass (R, NS) reads entry r*(j mod NS)*N/(NS*R). The
// inverse conjugates what it reads. The butterflies' own constants (cos and
// sin of 2*pi/8, /3, /5) are float64 values rounded once. FP32 on the CUDA
// cores throughout.

#pragma once

#include <cuda_runtime.h>

namespace rm_mfft {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cscale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }

// A root of the table, conjugated for the inverse.
template <bool INV>
__device__ __forceinline__ float2 root(float2 w) {
  return INV ? make_float2(w.x, -w.y) : w;
}

// a * (-i) forward, a * (+i) inverse: W_4 of the direction.
template <bool INV>
__device__ __forceinline__ float2 rot(float2 a) {
  return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

constexpr float H8 = 0.707106781186547524f;   // cos(2*pi/8)
constexpr float S3 = 0.866025403784438647f;   // sin(2*pi/3)
constexpr float C51 = 0.309016994374947424f;  // cos(2*pi/5)
constexpr float C52 = -0.809016994374947424f; // cos(4*pi/5)
constexpr float S51 = 0.951056516295153572f;  // sin(2*pi/5)
constexpr float S52 = 0.587785252292473129f;  // sin(4*pi/5)

template <bool INV>
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = cadd(a0, a2), t1 = csub(a0, a2), t2 = cadd(a1, a3), t3 = rot<INV>(csub(a1, a3));
  a0 = cadd(t0, t2);
  a2 = csub(t0, t2);
  a1 = cadd(t1, t3);
  a3 = csub(t1, t3);
}

// a * W_8^e of the direction, e = 1, 3.
template <bool INV>
__device__ __forceinline__ float2 w8_1(float2 a) {
  return INV ? make_float2(H8 * (a.x - a.y), H8 * (a.x + a.y)) : make_float2(H8 * (a.x + a.y), H8 * (a.y - a.x));
}
template <bool INV>
__device__ __forceinline__ float2 w8_3(float2 a) {
  return INV ? make_float2(-H8 * (a.x + a.y), H8 * (a.x - a.y)) : make_float2(H8 * (a.y - a.x), -H8 * (a.x + a.y));
}

// The R-point DFT of v in place, natural order in and out.
template <int R, bool INV>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  static_assert(R == 2 || R == 3 || R == 4 || R == 5 || R == 8, "radix 2, 3, 4, 5 or 8");
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 3) {
    const float2 s = cadd(v[1], v[2]);
    const float2 d = cscale(rot<INV>(csub(v[1], v[2])), S3);
    const float2 m = csub(v[0], cscale(s, 0.5f));
    v[0] = cadd(v[0], s);
    v[1] = cadd(m, d);
    v[2] = csub(m, d);
  } else if constexpr (R == 4) {
    dft4<INV>(v[0], v[1], v[2], v[3]);
  } else if constexpr (R == 5) {
    const float2 s1 = cadd(v[1], v[4]), d1 = csub(v[1], v[4]);
    const float2 s2 = cadd(v[2], v[3]), d2 = csub(v[2], v[3]);
    const float2 a = v[0];
    const float2 t1 = cadd(a, cadd(cscale(s1, C51), cscale(s2, C52)));
    const float2 t2 = cadd(a, cadd(cscale(s1, C52), cscale(s2, C51)));
    const float2 u1 = rot<INV>(cadd(cscale(d1, S51), cscale(d2, S52)));
    const float2 u2 = rot<INV>(csub(cscale(d1, S52), cscale(d2, S51)));
    v[0] = cadd(a, cadd(s1, s2));
    v[1] = cadd(t1, u1);
    v[4] = csub(t1, u1);
    v[2] = cadd(t2, u2);
    v[3] = csub(t2, u2);
  } else {
    // two 4-point DFTs of the even and odd inputs, then W_8^k and radix 2
    float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6];
    float2 o0 = v[1], o1 = v[3], o2 = v[5], o3 = v[7];
    dft4<INV>(e0, e1, e2, e3);
    dft4<INV>(o0, o1, o2, o3);
    o1 = w8_1<INV>(o1);
    o2 = rot<INV>(o2);
    o3 = w8_3<INV>(o3);
    v[0] = cadd(e0, o0);
    v[4] = csub(e0, o0);
    v[1] = cadd(e1, o1);
    v[5] = csub(e1, o1);
    v[2] = cadd(e2, o2);
    v[6] = csub(e2, o2);
    v[3] = cadd(e3, o3);
    v[7] = csub(e3, o3);
  }
}

// Butterfly j of pass (R, NS) on its loaded inputs v: the twiddles
// W_{NS*R}^{r*(j mod NS)} from the W_N table, then the R-point DFT.
template <int N, int R, int NS, bool INV>
__device__ __forceinline__ void butterfly(float2 (&v)[R], int j, const float2* __restrict__ roots) {
  if constexpr (NS > 1) {
    constexpr int STEP = N / (NS * R);
    const int k = j % NS;
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = cmul(v[r], root<INV>(roots[r * k * STEP]));
  }
  dft<R, INV>(v);
}

// Output r of butterfly j of pass (R, NS).
template <int R, int NS>
__device__ __forceinline__ int out_index(int j, int r) {
  return (j / NS) * NS * R + j % NS + r * NS;
}

// Pass (R, NS) of the length-N plan of a block of T threads over G
// sequences: butterfly b < G*N/R is sequence g = b mod G (consecutive
// threads on consecutive sequences), j = b / G. load(g, i) gives element i
// of sequence g, store(g, i, value) writes it. Every thread loads all its
// butterflies' inputs, the block synchronises, then each computes and
// stores, and the block synchronises again: so load and store may address
// the same shared buffer (an in-place pass), and a store into shared memory
// is visible to the next pass.
template <int N, int R, int NS, int G, int T, bool INV, class Load, class Store>
__device__ __forceinline__ void pass(const Load& load, const Store& store, const float2* __restrict__ roots) {
  constexpr int M = N / R;
  constexpr int TOTAL = G * M;
  constexpr int ROUNDS = (TOTAL + T - 1) / T;
  const int t = static_cast<int>(threadIdx.x);
  float2 v[ROUNDS][R];
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int b = t + q * T;
    if (TOTAL % T == 0 || b < TOTAL) {
      const int g = b % G, j = b / G;
#pragma unroll
      for (int r = 0; r < R; ++r) v[q][r] = load(g, j + r * M);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < ROUNDS; ++q) {
    const int b = t + q * T;
    if (TOTAL % T == 0 || b < TOTAL) {
      const int g = b % G, j = b / G;
      butterfly<N, R, NS, INV>(v[q], j, roots);
#pragma unroll
      for (int r = 0; r < R; ++r) store(g, out_index<R, NS>(j, r), v[q][r]);
    }
  }
  __syncthreads();
}

// Passes (R, NS), (REST..., NS*R ...) of the length-N plan, in place in
// shared memory: element i of sequence g at buf[g*CS + i].
template <int N, int NS, int G, int CS, int T, bool INV, int R, int... REST>
__device__ __forceinline__ void smem_passes(float2* buf, const float2* __restrict__ roots) {
  pass<N, R, NS, G, T, INV>([&](int g, int i) { return buf[g * CS + i]; },
                            [&](int g, int i, float2 x) { buf[g * CS + i] = x; }, roots);
  if constexpr (sizeof...(REST) > 0) smem_passes<N, NS * R, G, CS, T, INV, REST...>(buf, roots);
}

// W_N^e (forward) or its conjugate, e in [0, N), from the two-level table
// hi[e / OMEGA_LO] * lo[e mod OMEGA_LO] (pair_fft.tables): two roots rounded
// once each, where one table of N entries would not stay in L1.
constexpr int OMEGA_LO = 512;  // pair_fft.OMEGA_LO

template <bool INV>
__device__ __forceinline__ float2 omega(int e, const float2* __restrict__ hi, const float2* __restrict__ lo) {
  return root<INV>(cmul(hi[e / OMEGA_LO], lo[e % OMEGA_LO]));
}

}  // namespace rm_mfft
