// Kernels K2, K5 and K6: the GCC pair stage -- cross-power, whitening
// (l2rx, l2, l1 or none), four-step inverse transform of the lag-window
// rows only, |r|/n. One thread block per pair; the three kernels differ
// only in where a pair's two spectra and its l2rx gate scale come from:
//
//   K2 rm_gcc_pair_lag_mags         [C, B, n] spectra, host pair list,
//                                   gate from per-receiver maxima smax[C, B]
//     replaces radio_mapper_tpu/ops/pallas/gcc_kernel.py::gcc_pair_lag_mags
//   K5 rm_gcc_pairs_onehot_lag_mags [M, B, n] spectra, pair list as data,
//                                   per-pair gate s2[M, P]
//     replaces gcc_kernel.py::gcc_pairs_onehot_lag_mags (its resident
//     spectra + one-hot MXU gather are a VMEM/MXU layout device; here the
//     gather is by index and one subchannel's B spectra stay in L2)
//   K6 rm_gcc_rows_lag_mags         row k of X pairs with row k of Y,
//                                   [P, n] x 4, per-pair gate s2[P]
//     replaces gcc_kernel.py::gcc_rows_lag_mags
//
// (bodies _gcc_pairs_kernel / _gcc_onehot_kernel / _gcc_rows_kernel +
// _whiten + _invert_to_lag_windows). The pair body, shared with kernel K8,
// is gcc_pair.cuh's pair_lag_window: one warp a CT row, whose n1 = 32*P
// points (n1 = 128 or 256; or, in the kernels' WIDE instantiations, 384,
// 640 or 896) go through a warp-shuffle inverse FFT in registers, then a
// fold of each chunk of rows into the window rows. The WIDE kernels hold up
// to 28 points and 39 twiddles a lane, so they run at one block an SM's
// register budget; the n1 = 128/256 kernels keep four. `gate` is its
// rm_pair::Gate, and the gate-scale pointer may be null unless gate is
// l2rx; `wi` is the inverse radix table W_n1^-e (e < n1/2). Python
// wrappers and plain PyTorch versions: radio_mapper_tpu_torch/ops/cuda/
// gcc_pair.py.
//
// Shared memory holds one chunk of CT rows plus the window (about 26 KB at
// nfft 17408, max_lag 512; 19 KB at nfft 5120, max_lag 128), so several
// blocks share an SM.
//
// Bound on the H100: the inner FFT costs 5*n*log2(n1) FLOP a pair, so the
// outer fold into the window rows, 8*n*(nneg + npos) FLOP with a shared-
// memory read for each complex FMA, is now the largest part of the work;
// each pair reads its two spectra once (from L2 where a channel's spectra
// are shared by its pairs). The l2 and l1 gates add a pass over X and Y
// (the pair's max before any bin is whitened). Later PRs: several pairs
// that share a receiver in one block, tensor cores for the fold, fusion
// with the forward transform so spectra never reach device memory.

#include <cuda_runtime.h>

#include "gcc_pair.cuh"

namespace {

constexpr int K2_THREADS = 256;  // gcc_pair.THREADS

using rm_pair::pair_lag_window;

// K2: block = (channel c, pair pidx); gate from per-receiver maxima.
template <bool WIDE>
__global__ void __launch_bounds__(K2_THREADS, WIDE ? 1 : 4)
gcc_pair_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                const float* __restrict__ smax,
                const int* __restrict__ pair_i, const int* __restrict__ pair_j,
                const float2* __restrict__ wi, const float2* __restrict__ w2,
                const float2* __restrict__ tw, float* __restrict__ out,
                int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
                int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];  // float4: the pair body stores 16 bytes at a time
  float2* sm = reinterpret_cast<float2*>(smem);
  const size_t n = static_cast<size_t>(n1) * n2;
  const int c = blockIdx.x / np, pidx = blockIdx.x - c * np;
  const int bi = __ldg(pair_i + pidx), bj = __ldg(pair_j + pidx);
  const size_t xo = (static_cast<size_t>(c) * nb + bi) * n;
  const size_t yo = (static_cast<size_t>(c) * nb + bj) * n;
  const float floor2 =
      gate == rm_pair::GATE_L2RX ? eps2 * (__ldg(smax + c * nb + bi) * __ldg(smax + c * nb + bj)) : 0.f;
  pair_lag_window<K2_THREADS, false, WIDE>(sre + xo, sim + xo, sre + yo, sim + yo, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

// K5: block = (subchannel c, pair pidx) = blockIdx.x; per-pair gate s2[c, pidx].
template <bool WIDE>
__global__ void __launch_bounds__(K2_THREADS, WIDE ? 1 : 4)
gcc_pairs_onehot_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                        const float* __restrict__ s2,
                        const int* __restrict__ pair_i, const int* __restrict__ pair_j,
                        const float2* __restrict__ wi, const float2* __restrict__ w2,
                        const float2* __restrict__ tw, float* __restrict__ out,
                        int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
                        int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];  // float4: the pair body stores 16 bytes at a time
  float2* sm = reinterpret_cast<float2*>(smem);
  const size_t n = static_cast<size_t>(n1) * n2;
  const int c = blockIdx.x / np, pidx = blockIdx.x - c * np;
  const int bi = __ldg(pair_i + pidx), bj = __ldg(pair_j + pidx);
  const size_t xo = (static_cast<size_t>(c) * nb + bi) * n;
  const size_t yo = (static_cast<size_t>(c) * nb + bj) * n;
  const float floor2 = gate == rm_pair::GATE_L2RX ? eps2 * __ldg(s2 + blockIdx.x) : 0.f;
  pair_lag_window<K2_THREADS, false, WIDE>(sre + xo, sim + xo, sre + yo, sim + yo, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

// K6: block = row k; X row k pairs with Y row k, gate s2[k].
template <bool WIDE>
__global__ void __launch_bounds__(K2_THREADS, WIDE ? 1 : 4)
gcc_rows_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                const float* __restrict__ yre, const float* __restrict__ yim,
                const float* __restrict__ s2,
                const float2* __restrict__ wi, const float2* __restrict__ w2,
                const float2* __restrict__ tw, float* __restrict__ out,
                int n1, int n2, int nneg, int npos, int max_lag,
                int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];  // float4: the pair body stores 16 bytes at a time
  float2* sm = reinterpret_cast<float2*>(smem);
  const size_t o = static_cast<size_t>(blockIdx.x) * n1 * n2;
  const float floor2 = gate == rm_pair::GATE_L2RX ? eps2 * __ldg(s2 + blockIdx.x) : 0.f;
  pair_lag_window<K2_THREADS, false, WIDE>(xre + o, xim + o, yre + o, yim + o, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

size_t smem_bytes(int n1, int nneg, int npos) {
  return rm_pair::pair_smem_bytes<K2_THREADS>(n1, nneg, npos);
}

}  // namespace

extern "C" int rm_gcc_pair_lag_mags(
    const float* sre, const float* sim, const float* smax,
    const int* pair_i, const int* pair_j,
    const float2* wi, const float2* w2, const float2* tw, float* out,
    int nc, int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
    int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  if (!rm_pair::pair_n1_supported(n1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1, nneg, npos);
  const auto kernel = rm_pair::pair_n1_wide(n1) ? gcc_pair_kernel<true> : gcc_pair_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<nc * np, K2_THREADS, smem, stream>>>(
      sre, sim, smax, pair_i, pair_j, wi, w2, tw, out,
      nb, np, n1, n2, nneg, npos, max_lag, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_gcc_pairs_onehot_lag_mags(
    const float* sre, const float* sim, const float* s2,
    const int* pair_i, const int* pair_j,
    const float2* wi, const float2* w2, const float2* tw, float* out,
    int nc, int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
    int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  if (!rm_pair::pair_n1_supported(n1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1, nneg, npos);
  const auto kernel = rm_pair::pair_n1_wide(n1) ? gcc_pairs_onehot_kernel<true> : gcc_pairs_onehot_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<nc * np, K2_THREADS, smem, stream>>>(
      sre, sim, s2, pair_i, pair_j, wi, w2, tw, out,
      nb, np, n1, n2, nneg, npos, max_lag, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_gcc_rows_lag_mags(
    const float* xre, const float* xim, const float* yre, const float* yim, const float* s2,
    const float2* wi, const float2* w2, const float2* tw, float* out,
    int np, int n1, int n2, int nneg, int npos, int max_lag,
    int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  if (!rm_pair::pair_n1_supported(n1)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(n1, nneg, npos);
  const auto kernel = rm_pair::pair_n1_wide(n1) ? gcc_rows_kernel<true> : gcc_rows_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<np, K2_THREADS, smem, stream>>>(
      xre, xim, yre, yim, s2, wi, w2, tw, out, n1, n2, nneg, npos, max_lag, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}
