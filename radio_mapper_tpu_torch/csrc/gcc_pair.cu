// Kernel K2: all-pairs GCC-PHAT pair stage -- gather, cross-power, l2rx
// whitening, four-step inverse DFT of the lag-window rows only, |r|/n.
// One thread block per (channel, pair).
//
// Replaces radio_mapper_tpu/ops/pallas/gcc_kernel.py::gcc_pair_lag_mags
// (_gcc_pairs_kernel + _whiten + _invert_to_lag_windows) for "phat" with
// the per-receiver gate. Python wrapper and plain PyTorch version:
// radio_mapper_tpu_torch/ops/cuda/gcc_pair.py.
//
// Input spectra are in CT order (bin k = k2 + n2*k1 at m = k2*n1 + k1); the
// inverse consumes that order and emits time t = q*n1 + p:
//   R[k2][k1] = X_i * conj(Y_j) * rsqrt(|R|^2 + eps^2 * smax_i * smax_j + 1e-30)
//   E[k2][p]  = sum_k1 R[k2][k1] W1c[k1][p]      (inner inverse n1-point DFT)
//   C[k2][p]  = E[k2][p] * TWc[k2][p]
//   z[q][p]   = sum_k2 W2c[q][k2] C[k2][p]       (outer, window rows q only)
// The rows k2 are processed in chunks; each chunk's C is folded straight
// into the window accumulators, so shared memory holds one chunk plus the
// window (about 26 KB at nfft 17408, max_lag 512) and several blocks share
// an SM.
//
// Bound on the H100: the inner inverse DFT, n*n1 complex FMAs per pair, on
// the FP32 CUDA cores. Later PRs: tensor cores for both stages, TMA loads,
// fusion with kernel K1 so spectra never reach device memory.

#include <cuda_runtime.h>

namespace {

constexpr int K2_THREADS = 256;  // gcc_pair.THREADS
constexpr int K2_RJ = 8;         // inner DFT: chunk rows per thread

// acc += a * b (complex)
__device__ __forceinline__ void cmac(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, acc.x));
  acc.y = fmaf(a.x, b.y, fmaf(a.y, b.x, acc.y));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__global__ void __launch_bounds__(K2_THREADS)
gcc_pair_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                const float* __restrict__ smax,
                const int* __restrict__ pair_i, const int* __restrict__ pair_j,
                const float2* __restrict__ w1, const float2* __restrict__ w2,
                const float2* __restrict__ tw, float* __restrict__ out,
                int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
                float eps2, float inv_n) {
  extern __shared__ float2 sm[];
  const int groups = K2_THREADS / n1;
  const int chunk = groups * K2_RJ;
  const int nw = nneg + npos;
  float2* rbuf = sm;              // [chunk][n1] whitened R, then C
  float2* z = sm + chunk * n1;    // [nw][n1] window accumulators

  const int n = n1 * n2;
  const int tid = threadIdx.x;
  const int c = blockIdx.x / np, pidx = blockIdx.x - c * np;
  const int bi = __ldg(pair_i + pidx), bj = __ldg(pair_j + pidx);
  const size_t xo = (static_cast<size_t>(c) * nb + bi) * n;
  const size_t yo = (static_cast<size_t>(c) * nb + bj) * n;
  const float* xr = sre + xo;
  const float* xi = sim + xo;
  const float* yr = sre + yo;
  const float* yi = sim + yo;
  const float floor2 = eps2 * (__ldg(smax + c * nb + bi) * __ldg(smax + c * nb + bj));

  for (int o = tid; o < nw * n1; o += K2_THREADS) z[o] = make_float2(0.f, 0.f);

  const int p = tid % n1, g = tid / n1;
  for (int r0 = 0; r0 < n2; r0 += chunk) {
    const int rows = min(chunk, n2 - r0);

    // gather by index, R = X conj(Y), per-receiver-bound PHAT gate
    for (int idx = tid; idx < rows * n1; idx += K2_THREADS) {
      const int m = r0 * n1 + idx;
      const float ar = xr[m], ai = xi[m], br = yr[m], bim = yi[m];
      const float rr = __fadd_rn(__fmul_rn(ar, br), __fmul_rn(ai, bim));
      const float ri = __fsub_rn(__fmul_rn(ai, br), __fmul_rn(ar, bim));
      const float p2 = __fadd_rn(__fmul_rn(rr, rr), __fmul_rn(ri, ri));
      const float inv = rsqrtf(__fadd_rn(__fadd_rn(p2, floor2), 1e-30f));
      rbuf[idx] = make_float2(rr * inv, ri * inv);
    }
    __syncthreads();

    // inner inverse DFT over k1 + inverse twiddle; thread owns column p of
    // chunk rows g + groups j (W1 loads coalesced, R reads broadcast)
    float2 acc[K2_RJ];
#pragma unroll
    for (int j = 0; j < K2_RJ; ++j) acc[j] = make_float2(0.f, 0.f);
    for (int k1 = 0; k1 < n1; ++k1) {
      const float2 w = __ldg(w1 + k1 * n1 + p);
#pragma unroll
      for (int j = 0; j < K2_RJ; ++j) {
        const int rl = g + groups * j;
        if (rl < rows) cmac(acc[j], rbuf[rl * n1 + k1], w);
      }
    }
    __syncthreads();  // every read of rbuf is done
#pragma unroll
    for (int j = 0; j < K2_RJ; ++j) {
      const int rl = g + groups * j;
      if (rl < rows) rbuf[rl * n1 + p] = cmul(acc[j], __ldg(tw + (r0 + rl) * n1 + p));
    }
    __syncthreads();

    // outer inverse DFT over this chunk's k2, window rows only: neg rows
    // q = n2 - nneg .. n2 - 1 first, then pos rows q = 0 .. npos - 1
    for (int o = tid; o < nw * n1; o += K2_THREADS) {
      const int qw = o / n1, pp = o - qw * n1;
      const int q = (qw < nneg) ? (n2 - nneg + qw) : (qw - nneg);
      const float2* wq = w2 + q * n2 + r0;
      float2 a = z[o];
      for (int rl = 0; rl < rows; ++rl) cmac(a, __ldg(wq + rl), rbuf[rl * n1 + pp]);
      z[o] = a;
    }
    __syncthreads();  // rbuf is overwritten by the next chunk
  }

  // lags -L..-1 are the last L samples of the neg rows, 0..L the first
  // L+1 of the pos rows: one contiguous run of z
  const int width = 2 * max_lag + 1;
  float* orow = out + static_cast<size_t>(blockIdx.x) * width;
  const float2* zw = z + nneg * n1 - max_lag;
  for (int t = tid; t < width; t += K2_THREADS) {
    const float2 v = zw[t];
    orow[t] = __fmul_rn(sqrtf(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y))), inv_n);
  }
}

}  // namespace

extern "C" int rm_gcc_pair_lag_mags(
    const float* sre, const float* sim, const float* smax,
    const int* pair_i, const int* pair_j,
    const float2* w1, const float2* w2, const float2* tw, float* out,
    int nc, int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
    float eps2, float inv_n, cudaStream_t stream) {
  const int chunk = (K2_THREADS / n1) * K2_RJ;
  const size_t smem = static_cast<size_t>(chunk + nneg + npos) * n1 * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      gcc_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  gcc_pair_kernel<<<nc * np, K2_THREADS, smem, stream>>>(
      sre, sim, smax, pair_i, pair_j, w1, w2, tw, out,
      nb, np, n1, n2, nneg, npos, max_lag, eps2, inv_n);
  return static_cast<int>(cudaGetLastError());
}
