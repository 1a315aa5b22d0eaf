// Shared device code: one GCC pair's lag window -- cross-power R = X conj(Y),
// whitening, four-step inverse DFT of the lag-window rows only, |r|/n.
//
// The body of kernels K2, K5 and K6 (gcc_pair.cu) and of the pair stage of
// kernel K8 (channel_step.cu); it is radio_mapper_tpu/ops/pallas/
// gcc_kernel.py::_whiten + _invert_to_lag_windows for one pair.
//
// Input spectra are in CT order (bin k = k2 + n2*k1 at m = k2*n1 + k1); the
// inverse consumes that order and emits time t = q*n1 + p:
//   R[k2][k1] = whiten(X * conj(Y))
//   E[k2][p]  = sum_k1 R[k2][k1] W1c[k1][p]      (inner inverse n1-point DFT)
//   C[k2][p]  = E[k2][p] * TWc[k2][p]
//   z[q][p]   = sum_k2 W2c[q][k2] C[k2][p]       (outer, window rows q only)
// The rows k2 are processed in chunks; each chunk's C is folded straight
// into the window accumulators, in k2 order whatever the chunk size, so a
// block of any THREADS gives the same sums.
//
// Whitening (gcc_kernel._whiten, the gate of set_phat_gate):
//   l2rx  R * rsqrt(|R|^2 + eps^2 * s2 + 1e-30), s2 given per pair
//         (max|X_i|^2 * max|Y_j|^2 from the per-receiver maxima)
//   l2    the same with s2 = max_k |R|^2 of this pair
//   l1    R / (mag + eps * max_k mag + 1e-30), mag = |R|^2 * rsqrt(|R|^2 + 1e-30)
//   none  R unchanged ("cc", no whitening)
// l2 and l1 need the pair's maximum before any bin is whitened: a first
// pass over the n bins forms R and block-reduces it, so those two gates
// read X and Y twice (mostly from L2).

#pragma once

#include <cuda_runtime.h>

#include "ct_dft.cuh"

namespace rm_pair {

constexpr int RJ = 8;  // inner DFT: chunk rows per thread

enum Gate : int { GATE_L2RX = 0, GATE_L2 = 1, GATE_L1 = 2, GATE_NONE = 3 };

// Spectra loads: read-only-cache loads where the spectra predate the
// launch; L2 loads (no L1) where another block of the same launch wrote
// them (kernel K8).
template <bool FRESH>
__device__ __forceinline__ float load(const float* p) {
  if constexpr (FRESH) return __ldcg(p);
  else return __ldg(p);
}

template <bool FRESH>
__device__ __forceinline__ void cross_power(const float* xr, const float* xi, const float* yr,
                                            const float* yi, int m, float& rr, float& ri) {
  const float ar = load<FRESH>(xr + m), ai = load<FRESH>(xi + m);
  const float br = load<FRESH>(yr + m), bim = load<FRESH>(yi + m);
  rr = __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bim));
  ri = __fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bim));
}

// One pair: X = (xr, xi), Y = (yr, yi) CT-order rows of n = n1*n2, gate
// mode `gate` (l2rx floor eps2 * s2 in floor2; eps2 = eps^2 and eps for
// the per-pair gates), window |r|/n written to orow[0 .. 2*max_lag].
// sm: (THREADS/n1 * RJ + nneg + npos) * n1 float2 of shared memory.
template <int THREADS, bool FRESH>
__device__ void pair_lag_window(
    const float* xr, const float* xi, const float* yr, const float* yi,
    int gate, float floor2, float eps2, float eps,
    const float2* __restrict__ w1, const float2* __restrict__ w2,
    const float2* __restrict__ tw, float* __restrict__ orow, float2* sm,
    int n1, int n2, int nneg, int npos, int max_lag, float inv_n) {
  __shared__ float red[THREADS / 32];
  const int groups = THREADS / n1;
  const int chunk = groups * RJ;
  const int nw = nneg + npos;
  float2* rbuf = sm;              // [chunk][n1] whitened R, then C
  float2* z = sm + chunk * n1;    // [nw][n1] window accumulators
  const int tid = threadIdx.x;

  for (int o = tid; o < nw * n1; o += THREADS) z[o] = make_float2(0.f, 0.f);

  // l2 / l1: the pair's max |R|^2 (or max mag) first
  float scale = 0.f;
  if (gate == GATE_L2 || gate == GATE_L1) {
    const int n = n1 * n2;
    float v = 0.f;  // |R|^2 and mag are >= 0
    for (int m = tid; m < n; m += THREADS) {
      float rr, ri;
      cross_power<FRESH>(xr, xi, yr, yi, m, rr, ri);
      const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
      v = fmaxf(v, gate == GATE_L2 ? p2 : __fmul_rn(p2, rsqrtf(__fadd_rn(p2, 1e-30f))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if ((tid & 31) == 0) red[tid >> 5] = v;
    __syncthreads();
    scale = red[0];
    for (int w = 1; w < THREADS / 32; ++w) scale = fmaxf(scale, red[w]);
    if (gate == GATE_L2) floor2 = __fmul_rn(eps2, scale);
  }
  const float l1_floor = __fmul_rn(eps, scale);

  const int p = tid % n1, g = tid / n1;
  for (int r0 = 0; r0 < n2; r0 += chunk) {
    const int rows = min(chunk, n2 - r0);

    // R = X conj(Y), whitened
    for (int idx = tid; idx < rows * n1; idx += THREADS) {
      float rr, ri;
      cross_power<FRESH>(xr, xi, yr, yi, r0 * n1 + idx, rr, ri);
      float inv = 1.f;
      if (gate != GATE_NONE) {
        const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
        if (gate == GATE_L1) {
          const float mag = __fmul_rn(p2, rsqrtf(__fadd_rn(p2, 1e-30f)));
          inv = __fdiv_rn(1.f, __fadd_rn(__fadd_rn(mag, l1_floor), 1e-30f));
        } else {
          inv = rsqrtf(__fadd_rn(__fadd_rn(p2, floor2), 1e-30f));
        }
      }
      rbuf[idx] = gate == GATE_NONE ? make_float2(rr, ri) : make_float2(rr * inv, ri * inv);
    }
    __syncthreads();

    // inner inverse DFT over k1 + inverse twiddle; thread owns column p of
    // chunk rows g + groups j (W1 loads coalesced, R reads broadcast)
    float2 acc[RJ];
#pragma unroll
    for (int j = 0; j < RJ; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int k1 = 0; k1 < n1; ++k1) {
      const float2 w = __ldg(w1 + k1 * n1 + p);
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int rl = g + groups * j;
        if (rl < rows) rm_ct::cmac(acc[j], rbuf[rl * n1 + k1], w);
      }
    }
    __syncthreads();  // every read of rbuf is done
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int rl = g + groups * j;
      if (rl < rows) rbuf[rl * n1 + p] = rm_ct::cmul(acc[j], __ldg(tw + (r0 + rl) * n1 + p));
    }
    __syncthreads();

    // outer inverse DFT over this chunk's k2, window rows only: neg rows
    // q = n2 - nneg .. n2 - 1 first, then pos rows q = 0 .. npos - 1
    for (int o = tid; o < nw * n1; o += THREADS) {
      const int qw = o / n1, pp = o - qw * n1;
      const int q = (qw < nneg) ? (n2 - nneg + qw) : (qw - nneg);
      const float2* wq = w2 + q * n2 + r0;
      float2 a = z[o];
      for (int rl = 0; rl < rows; ++rl) rm_ct::cmac(a, __ldg(wq + rl), rbuf[rl * n1 + pp]);
      z[o] = a;
    }
    __syncthreads();  // rbuf is overwritten by the next chunk
  }

  // lags -L..-1 are the last L samples of the neg rows, 0..L the first
  // L+1 of the pos rows: one contiguous run of z
  const int width = 2 * max_lag + 1;
  const float2* zw = z + nneg * n1 - max_lag;
  for (int t = tid; t < width; t += THREADS) {
    const float2 v = zw[t];
    orow[t] = __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y))), inv_n);
  }
}

// Shared memory of pair_lag_window for a block of THREADS.
template <int THREADS>
size_t pair_smem_bytes(int n1, int nneg, int npos) {
  const int chunk = (THREADS / n1) * RJ;
  return static_cast<size_t>(chunk + nneg + npos) * n1 * sizeof(float2);
}

}  // namespace rm_pair
