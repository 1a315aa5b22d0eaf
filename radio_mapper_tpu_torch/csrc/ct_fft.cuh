// Kernel K3's forward CT-order FFT of one row held in shared memory, the
// forward half that kernels K1 and K8 run on it before their detect body,
// and the column and row passes of K3's long-row design.
//
// Layout: a row of n = n1*n2 samples is x[q][p] at time q*n1 + p, kept as
// n2 "slot rows" of n1 float2. The transform emits bin k = k2 + n2*k1 at
// CT address m = k2*n1 + k1 (the order of the reference's four-step
// ct_fft_core), with n2 = A*r (A = min(8, 2^v2(n2))) and three steps:
//
//   step A  for each column p and j < r: an A-point radix-2 FFT in
//           registers over the slots j + r*t (t < A); output k times
//           W_n2^{j*k} goes back to slot j + r*k;
//   step B  for each column p and k < A: the direct r-point DFT over the
//           slots j + r*k (j < r); X[k + A*s] times the row twiddle
//           W_n^{(k + A*s)*p} goes to slot s + r*k;
//   step C  one warp per slot row: the n1-point FFT, P = n1/32 points a
//           lane, five radix-2 stages across lanes (__shfl_xor_sync) and
//           then a P-point transform in registers (radix-2 for P = 4 or 8;
//           for P = 4q, q = 3, 5, 7, two radix-2 stages and a direct
//           q-point DFT); the outputs, in that transform's digit order
//           (digit<P>) times brev5(lane), belong at CT row k2 = k + A*s.
//
// One-block design (n1 = 128, the row in shared memory): K3 runs the
// three steps in place and stores (step_c_store); K1 and K8 store the
// spectra the same way and keep each value's power in registers
// (step_c_handoff), then, after a barrier, write the power over the row
// in CT order (power_store) for the detect body (fft_power_row).
//
// Long-row designs: steps A and B run on tiles of COLS columns of the row
// (the template parameter COLS of step_a, step_b and step_b_stream). The
// cluster design (fft_rows_ct_cluster.cu, n1 = 128 or 256) holds the row
// across a thread-block cluster, runs them in place and step C
// (step_c_regs) on slot rows whose points its lanes gather from the
// blocks' shared memory; the wide design (fft_detect_cluster.cuh, n1 =
// 384, 640, 896) does the same on a cluster of 8 blocks, with step C's
// twiddles in shared memory, and is kernel K1's one-pass kernel too; the
// workspace design (fft_rows_ct_long.cu, the wide design's comparison
// only) writes the slot rows to a device-memory workspace and runs step C
// from there, one warp a slot row. All store as K3 does; the per-value
// arithmetic is the same in every design.
//
// Every twiddle comes from a float32 table of float64 roots of unity
// (ct_plan.radix_tables, ct_constants' tw). tests/test_torch_fft_radix.py
// replays K3's one-block schedule in numpy, tests/test_torch_fft_detect_radix.py
// K1's hand-off, tests/test_torch_long_rows_radix.py and
// tests/test_torch_cluster_fft.py the long-row design.

#pragma once

#include <cuda_runtime.h>

#include "ct_dft.cuh"

namespace rm_fft {

constexpr int N1 = 128;       // the outer length of the one-block design
constexpr int THREADS = 512;  // one block per row: 4 threads per column in steps A and B
constexpr int WARPS = THREADS / 32;
constexpr int STREAM_MAX_SJ = 12;  // streamed step B: outputs a thread holds (one-block: r <= 192 in one pass)
constexpr int HANDOFF_A = 8;       // K1 and K8 take n2 = 8*r (detect plans have 8 | n2)
constexpr int HANDOFF_MAX_HELD = 48;  // powers a thread holds: n2 <= WARPS * 48 / 4 = 192, n <= 24576

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

__host__ __device__ constexpr int brev_bits(int x, int bits) {
  int y = 0;
  for (int i = 0; i < bits; ++i) y |= ((x >> i) & 1) << (bits - 1 - i);
  return y;
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

__host__ __device__ constexpr bool is_pow2(int x) { return (x & (x - 1)) == 0; }

// The register transform's output order: after step C (or the pair body's
// inverse), register i of lane l holds bin digit<P>(i)*32 + brev5(l)
// (forward) or time P*brev5(l) + digit<P>(i) (inverse). Radix-2 (P a power
// of two): brev(i). Mixed (P = 4q, q odd): register i = b*q + u holds the
// output brev2(b) + 4u of block b's q-point DFT.
template <int P>
__host__ __device__ constexpr int digit(int i) {
  if constexpr (is_pow2(P)) {
    return brev_bits(i, log2_of(P));
  } else {
    return brev_bits(i / (P / 4), 2) + 4 * (i % (P / 4));
  }
}

// The register that holds output m: digit<P>(digit_inv<P>(m)) = m.
template <int P>
__host__ __device__ constexpr int digit_inv(int m) {
  if constexpr (is_pow2(P)) {
    return brev_bits(m, log2_of(P));
  } else {
    return brev_bits(m % 4, 2) * (P / 4) + m / 4;
  }
}

// Radix-2 DIF over v[0..L) in registers: the pair (t, t + h) of sub-size
// 2h becomes (a + b, (a - b) * W_2h^(t mod h)), W_2h^u = W_NW^(u*NW/(2h)),
// from the table w of W_NW^e, e < NW/2. Position t then holds output
// brev(t).
template <int L, int NW = N1>
__device__ __forceinline__ void dif_regs(float2 (&v)[L], const float2* w) {
#pragma unroll
  for (int h = L / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      if (t & h) continue;
      const float2 a = v[t], b = v[t + h];
      const int e = (t & (h - 1)) * (NW / 2 / h);
      v[t] = cadd(a, b);
      v[t + h] = e ? rm_ct::cmul(csub(a, b), w[e]) : csub(a, b);
    }
  }
}

// The roots of a q-point DFT: wq[m] = W_q^m, read as w[m*NW/q] for
// m <= q/2 and conj(W_q^(q-m)) above (w: W_NW^e, e < NW/2; the pair body
// passes its table of W_NW^-e and so gets the inverse's roots).
template <int Q, int NW>
__device__ __forceinline__ void q_roots(const float2* w, float2 (&wq)[Q]) {
  wq[0] = make_float2(1.f, 0.f);
#pragma unroll
  for (int m = 1; m <= Q / 2; ++m) {
    wq[m] = w[m * (NW / Q)];
    wq[Q - m] = make_float2(wq[m].x, -wq[m].y);
  }
}

// The direct q-point DFT (q = P/4, odd) of each of v's four blocks of q
// registers, in place: y[u] = sum_t x[t] * wq[t*u mod q].
template <int P>
__device__ __forceinline__ void q_dfts(float2 (&v)[P], const float2 (&wq)[P / 4]) {
  constexpr int Q = P / 4;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float2 x[Q];
#pragma unroll
    for (int t = 0; t < Q; ++t) x[t] = v[b * Q + t];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      float2 acc = x[0];
#pragma unroll
      for (int t = 1; t < Q; ++t) {
        if ((t * u) % Q == 0) acc = cadd(acc, x[t]);
        else rm_ct::cmac(acc, x[t], wq[(t * u) % Q]);
      }
      v[b * Q + u] = acc;
    }
  }
}

// The registers' transform for P = 4q, q odd (3, 5, 7): the two radix-2
// DIF stages of dif_regs (h = 2q, then q; the pair (t, t + h) becomes
// (a + b, (a - b) * W_2h^(t mod h)), W_2h = W_NW^(NW/(2h))), after which
// block b = t/q holds a q-point problem whose outputs are brev2(b) + 4u
// (digit<P>); then q_dfts.
template <int P, int NW>
__device__ __forceinline__ void mixed_regs(float2 (&v)[P], const float2* w) {
  constexpr int Q = P / 4;
  static_assert(P % 4 == 0 && Q % 2 == 1 && Q > 1, "mixed_regs takes P = 4q, q odd");
#pragma unroll
  for (int h = 2 * Q; h >= Q; h -= Q) {
#pragma unroll
    for (int t = 0; t < P; ++t) {
      if (t % (2 * h) >= h) continue;
      const float2 a = v[t], b = v[t + h];
      const int e = (t % h) * (NW / 2 / h);
      v[t] = cadd(a, b);
      v[t + h] = e ? rm_ct::cmul(csub(a, b), w[e]) : csub(a, b);
    }
  }
  float2 wq[Q];
  q_roots<Q, NW>(w, wq);
  q_dfts<P>(v, wq);
}

// Step A on COLS columns held as xs[q*COLS + p]. Thread (p, j0) takes
// j = j0, j0 + THREADS/COLS, ... < r.
template <int A, int COLS = N1>
__device__ __forceinline__ void step_a(float2* xs, const float2* w128, const float2* __restrict__ wn2,
                                       int r) {
  const int p = threadIdx.x & (COLS - 1);
  for (int j = threadIdx.x / COLS; j < r; j += THREADS / COLS) {
    float2 v[A];
#pragma unroll
    for (int t = 0; t < A; ++t) v[t] = xs[(j + r * t) * COLS + p];
    dif_regs<A>(v, w128);
#pragma unroll
    for (int t = 0; t < A; ++t) {
      constexpr int bits = log2_of(A);
      const int k = brev_bits(t, bits);
      xs[(j + r * k) * COLS + p] = k ? rm_ct::cmul(v[t], __ldg(wn2 + j * k)) : v[t];
    }
  }
}

// Step B with the r inputs of a column in registers (r <= RMAX), on COLS
// columns held as xs[q*COLS + p]. Output s of column block k times
// tw[(k + A*s)*tw_ld + p] goes to dst[(s + r*k)*dst_ld + p]: back into xs
// (one block: dst = xs, both strides N1) or to a workspace row. Thread
// (p, k0) takes k = k0, k0 + THREADS/COLS, ... < A; the W_r loads are
// warp-uniform.
template <int A, int RMAX, int COLS = N1>
__device__ __forceinline__ void step_b(float2* xs, const float2* __restrict__ wr,
                                       const float2* __restrict__ tw, int tw_ld, float2* dst, int dst_ld,
                                       int r) {
  const int p = threadIdx.x & (COLS - 1);
  for (int k = threadIdx.x / COLS; k < A; k += THREADS / COLS) {
    const float2* col = xs + r * k * COLS + p;
    float2 y[RMAX];
#pragma unroll
    for (int j = 0; j < RMAX; ++j) y[j] = j < r ? col[j * COLS] : make_float2(0.f, 0.f);
    for (int s = 0; s < r; ++s) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < RMAX; ++j)
        if (j < r) rm_ct::cmac(acc, __ldg(wr + j * r + s), y[j]);
      dst[(s + r * k) * dst_ld + p] = rm_ct::cmul(acc, __ldg(tw + (k + A * s) * tw_ld + p));
    }
  }
}

// Step B for r too large for registers, with step_b's operands: the
// inputs stream from xs. Lanes take columns, LANES = min(32, COLS) a
// group, 32/LANES groups a warp; each of the OWNERS groups of the block
// owns outputs s = s0 + owner + OWNERS*i (i < SJ), in passes s0 = 0,
// OWNERS*SJ, ... . A barrier separates each pass's reads from its writes,
// so dst may be xs (in place) when r fits one pass (r <= 192 at 128
// columns and SJ = STREAM_MAX_SJ). Ends with a barrier.
template <int A, int COLS = N1, int SJ = STREAM_MAX_SJ>
__device__ __forceinline__ void step_b_stream(float2* xs, const float2* __restrict__ wr,
                                              const float2* __restrict__ tw, int tw_ld, float2* dst,
                                              int dst_ld, int r) {
  constexpr int LANES = COLS < 32 ? COLS : 32;
  constexpr int OWNERS = WARPS * (32 / LANES);
  const int lane = threadIdx.x & 31;
  const int owner = (threadIdx.x >> 5) * (32 / LANES) + lane / LANES;
  for (int k = 0; k < A; ++k) {
    for (int p0 = 0; p0 < COLS; p0 += LANES) {
      const int p = p0 + lane % LANES;
      const float2* col = xs + r * k * COLS + p;
      for (int s0 = 0; s0 < r; s0 += OWNERS * SJ) {
        float2 acc[SJ];
#pragma unroll
        for (int i = 0; i < SJ; ++i) acc[i] = make_float2(0.f, 0.f);
        for (int j = 0; j < r; ++j) {
          const float2 y = col[j * COLS];
#pragma unroll
          for (int i = 0; i < SJ; ++i) {
            const int s = s0 + owner + OWNERS * i;
            if (s < r) rm_ct::cmac(acc[i], __ldg(wr + j * r + s), y);
          }
        }
        __syncthreads();  // every read of these columns is done
#pragma unroll
        for (int i = 0; i < SJ; ++i) {
          const int s = s0 + owner + OWNERS * i;
          if (s < r) dst[(s + r * k) * dst_ld + p] = rm_ct::cmul(acc[i], __ldg(tw + (k + A * s) * tw_ld + p));
        }
        __syncthreads();
      }
    }
  }
}

// Step C on one slot row of R1 = 32*P points (P = 4, 8, 12, 20 or 28), in
// one warp, lane l holding positions P*l + i (i < P) of the row in v[i]
// (loaded by step_c_row, or gathered from a cluster's blocks by the
// cluster design); w1 the table W_R1^e, e < R1/2. The five radix-2 DIF
// stages of half-size h = R1/2 .. P pair lane l with lane l ^ (h/P),
// twiddle W_R1^(((P*l + i) mod h) * R1/(2h)); after them lane l holds the
// P-point problem whose outputs are bins brev5(l) + 32*u, solved in
// registers (dif_regs, or mixed_regs for P = 4q, q odd). Register i then
// holds bin digit<P>(i)*32 + brev5(l).
template <int R1 = N1>
__device__ __forceinline__ void step_c_regs(float2 (&v)[R1 / 32], const float2* w1) {
  constexpr int P = R1 / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = R1 / 2; h >= P; h >>= 1) {
    const int d = h / P;
    const bool top = (lane & d) == 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float2 w = make_float2(__shfl_xor_sync(0xffffffffu, v[i].x, d),
                                   __shfl_xor_sync(0xffffffffu, v[i].y, d));
      int e;
      if constexpr (is_pow2(P)) e = ((P * lane + i) & (h - 1)) * (R1 / 2 / h);
      else e = ((P * lane + i) % h) * (R1 / 2 / h);
      v[i] = top ? cadd(v[i], w) : rm_ct::cmul(csub(w, v[i]), w1[e]);
    }
  }
  if constexpr (is_pow2(P)) dif_regs<P, R1>(v, w1);
  else mixed_regs<P, R1>(v, w1);
}

// Step C on one slot row held contiguously: row is the slot row (shared or
// device memory, 16-byte aligned); lane l loads its P positions as P/2
// 16-byte loads, then step_c_regs. Register i of v returns bin
// digit<P>(i)*32 + brev5(l).
template <int R1 = N1>
__device__ __forceinline__ void step_c_row(const float2* row, const float2* w1, float2 (&v)[R1 / 32]) {
  constexpr int P = R1 / 32;
  const int lane = threadIdx.x & 31;
  const float4* row4 = reinterpret_cast<const float4*>(row) + (P / 2) * lane;
#pragma unroll
  for (int q = 0; q < P / 2; ++q) {
    const float4 f = row4[q];
    v[2 * q] = make_float2(f.x, f.y);
    v[2 * q + 1] = make_float2(f.z, f.w);
  }
  step_c_regs<R1>(v, w1);
}

// CT address of value i of this lane's step-C output of slot row sr =
// s + r*k: row k2 = k + a*s, column k1 = digit<P>(i)*32 + brev5(lane).
template <int R1 = N1>
__device__ __forceinline__ size_t ct_address(int sr, int i, int a, int r) {
  const int k = sr / r, s = sr - r * k;
  const int k1 = digit<R1 / 32>(i) * 32 + static_cast<int>(__brev(threadIdx.x & 31) >> 27);
  return static_cast<size_t>(k + a * s) * R1 + k1;
}

// Step C and K3's store: warp w takes slot rows w, w + WARPS, ...; each i
// stores 32 consecutive floats a plane.
__device__ __forceinline__ void step_c_store(const float2* xs, const float2* w128, float* fr, float* fi,
                                             int n2, int a, int r) {
  for (int sr = threadIdx.x >> 5; sr < n2; sr += WARPS) {
    float2 v[4];
    step_c_row(xs + sr * N1, w128, v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const size_t m = ct_address(sr, i, a, r);
      fr[m] = v[i].x;
      fi[m] = v[i].y;
    }
  }
}

// Step C and K1's hand-off: the spectra stored as step_c_store stores
// them, and each value's power fr^2 + fi^2 (the expression of K4) kept in
// pv[4*t + i] for slot row warp + WARPS*t. The slot rows are still being
// read by other warps, so nothing goes to shared memory here.
template <int MAX_SR>
__device__ __forceinline__ void step_c_handoff(const float2* xs, const float2* w128, float* fr, float* fi,
                                               float (&pv)[4 * MAX_SR], int n2, int r) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < MAX_SR; ++t) {
    const int sr = warp + WARPS * t;
    if (sr < n2) {
      float2 v[4];
      step_c_row(xs + sr * N1, w128, v);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t m = ct_address(sr, i, HANDOFF_A, r);
        fr[m] = v[i].x;
        fi[m] = v[i].y;
        pv[4 * t + i] = __fadd_rn(__fmul_rn(v[i].x, v[i].x), __fmul_rn(v[i].y, v[i].y));
      }
    }
  }
}

// After a barrier: the held powers to pwr[k2*128 + k1], the CT address of
// each value (not its slot row), over the row's first n floats.
template <int MAX_SR>
__device__ __forceinline__ void power_store(float* pwr, const float (&pv)[4 * MAX_SR], int n2, int r) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < MAX_SR; ++t) {
    const int sr = warp + WARPS * t;
    if (sr < n2) {
#pragma unroll
      for (int i = 0; i < 4; ++i) pwr[ct_address(sr, i, HANDOFF_A, r)] = pv[4 * t + i];
    }
  }
}

// The step-B register tile K1 and K8 launch for r (as K3's launch_a picks
// it), 0 where they take no such r.
__host__ __device__ constexpr int handoff_rmax(int r) {
  return r < 1 ? 0 : r <= 8 ? 8 : r <= 16 ? 16 : r <= 24 ? 24 : 0;
}

// The forward half of kernels K1 and K8 on one row of n = 128*n2 samples,
// n2 = 8*r, r <= RMAX: the row and W_128 loaded to xs (n + 64 float2),
// steps A and B, step C with the hand-off (spectra to fr/fi), a barrier,
// and the power store. On return pwr = (float*)xs holds the row's linear
// power in CT order, visible after the detect body's first barrier; xs's
// other n floats are free for its scratch. Every thread of the block calls
// it.
template <int RMAX>
__device__ __forceinline__ void fft_power_row(const float* __restrict__ xr, const float* __restrict__ xi,
                                              const float2* __restrict__ w128,
                                              const float2* __restrict__ wn2,
                                              const float2* __restrict__ wr,
                                              const float2* __restrict__ tw, float* fr, float* fi,
                                              float2* xs, int n2, int r) {
  constexpr int MAX_SR = RMAX / 2;  // slot rows a warp takes: ceil(8*r / WARPS) <= RMAX/2
  static_assert(RMAX % 2 == 0 && 4 * MAX_SR <= HANDOFF_MAX_HELD, "the hand-off holds at most 48 powers");
  const int n = N1 * n2;
  const int tid = threadIdx.x;
  float2* w128s = xs + n;  // [64] W_128^e
#pragma unroll 4
  for (int m = tid; m < n; m += THREADS) xs[m] = make_float2(xr[m], xi[m]);
  if (tid < N1 / 2) w128s[tid] = w128[tid];
  __syncthreads();

  step_a<HANDOFF_A>(xs, w128s, wn2, r);
  __syncthreads();
  step_b<HANDOFF_A, RMAX>(xs, wr, tw, N1, xs, N1, r);
  __syncthreads();
  float pv[4 * MAX_SR];
  step_c_handoff<MAX_SR>(xs, w128s, fr, fi, pv, n2, r);
  __syncthreads();  // every warp has read its slot rows
  power_store<MAX_SR>(reinterpret_cast<float*>(xs), pv, n2, r);
}

}  // namespace rm_fft
