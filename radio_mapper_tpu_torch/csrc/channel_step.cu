// Kernel K8: the per-channel megakernel -- forward CT-order FFT, spectral
// detection and the l2rx GCC pair stage of one channel in one launch.
//
// Replaces radio_mapper_tpu/ops/pallas/channel_kernel.py::
// channel_step_partials (ct_fft_core + _detect_body + _whiten("l2rx") +
// _invert_to_lag_windows). Python wrapper and plain PyTorch version:
// radio_mapper_tpu_torch/ops/cuda/channel_step.py.
//
// The TPU kernel keeps a channel's B rows in VMEM. On the H100 one complex
// row at nfft 17408 is 139,264 B of the 227 KB a block has, so a channel
// is a thread-block cluster of B blocks (cudaLaunchAttributeClusterDimension;
// B <= 8 is portable, 9..16 non-portable), one block per receiver:
//
//   1. each block runs kernel K1's body on its receiver's row: ct_fft.cuh's
//      fft_power_row (kernel K3's radix steps A, B and C in shared memory,
//      the spectra written to a scratch [C, B, n] that the wrapper
//      allocates, the power kept in registers and written back over the
//      row), then ct_detect.cuh's detect_row, whose row max is the
//      receiver's l2rx gate input;
//   2. the cluster barrier (after a device-scope fence): the channel's B
//      spectra and maxima are complete;
//   3. block `rank` runs gcc_pair_wide.cuh's wide_pair_body, the body of
//      kernel K2, on K2's tiles t = rank, rank + B, ... (two pairs that
//      share a receiver, gcc_pair.wide_tiles), its bulk copies reading the
//      partners' spectra from the scratch (async-proxy reads, ordered after
//      the other blocks' writes by proxy fences on both sides of the
//      barrier), in the shared memory the row no longer needs
//      (channel_step.pair_plan: the pair buffers fit the row's n float2).
//
// The same device functions run in the same order, with the same template
// arguments (step B's register tile RMAX) and the same 512 threads, as K1,
// followed by K2's body with the l2rx gate (which folds a pair's window by
// the same k-steps of 4 rows in k2 order at any chunk size, tile or block
// size: 512 threads split its accumulator slots in two), so the partials,
// noise floors and windows equal that composition's bit for bit. The gate
// is l2rx whatever set_phat_gate says, as in the reference.
//
// Design taken: spectra through a device-memory scratch (1.1 MB per
// channel, written once and read back at once, mostly from L2). The other
// design keeps each block's spectrum in its own shared memory and lets the
// partners read it through distributed shared memory: no scratch traffic
// (2 x 142.6 MB per 128-channel block, ~0.09 ms at 3.35 TB/s), but about
// 209 KB per block (spectrum + candidate scratch, power recomputed from the
// spectrum) before the pair buffers, and remote reads in the inner loop.
//
// What bounds it as written: the forward half, K1's radix body, bound by
// its bytes and barriers, at one 512-thread block per SM (the row's shared
// memory is reserved for the whole launch); the pair half is K2's body
// (bulk copies, the fold on tensor cores) at that one block an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ct_detect.cuh"
#include "ct_fft.cuh"
#include "gcc_pair.cuh"
#include "gcc_pair_wide.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K8_THREADS = 512;  // channel_step.THREADS, = K1's block
static_assert(K8_THREADS == rm_fft::THREADS, "K8 runs K1's forward half at ct_fft.cuh's block size");

using rm_det::DetectParams;
using rm_fft::N1;

template <int RMAX>
__global__ void __launch_bounds__(K8_THREADS, 1)
channel_step_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                    const float2* __restrict__ w128, const float2* __restrict__ wn2,
                    const float2* __restrict__ wr, const float2* __restrict__ ftw,
                    const float2* __restrict__ iwr, const float2* __restrict__ iw2,
                    const float2* __restrict__ itwx, const int* __restrict__ tiles,
                    float* fre, float* fim, float* smax,
                    float* __restrict__ seg_score, float* __restrict__ seg_arg,
                    float* __restrict__ nf_out, float* __restrict__ out,
                    int nb, int np, int ntiles, int n2, int r, int nneg, int npos, int max_lag,
                    int nsrc, int rows, int ntg, int groups, float eps2, float inv_n, DetectParams prm) {
  extern __shared__ float4 smem[];  // float4: step C moves 16 bytes at a time
  float2* xs = reinterpret_cast<float2*>(smem);  // [n] slot rows + [64] W_128; later the pair buffers
  __shared__ rm_wide::Tile tile;
  cg::cluster_group cluster = cg::this_cluster();

  const int n = N1 * n2;
  const size_t row = blockIdx.x;  // = c * nb + rank: the cluster is the channel
  const int c = blockIdx.x / nb;
  const int rank = static_cast<int>(cluster.block_rank());

  // ---- 1. K1's body on this receiver's row
  const size_t off = row * n;
  rm_fft::fft_power_row<RMAX>(xre + off, xim + off, w128, wn2, wr, ftw, fre + off, fim + off, xs, n2, r);
  float* pwr = reinterpret_cast<float*>(xs);
  float* aux = pwr + n;
  const int s = n / rm_det::SEG;
  const float2 res = rm_det::detect_row<K8_THREADS>(pwr, aux, N1, n2, prm, seg_score + row * s,
                                                    seg_arg + row * s);
  if (threadIdx.x == 0) {
    nf_out[row] = res.x;
    smax[row] = res.y;
  }

  // ---- 2. the channel's spectra and maxima are complete (and ordered
  // before the bulk copies that read them)
  rm_wide::fence_proxy_async_global();
  __threadfence();
  cluster.sync();

  // ---- 3. K2's body (l2rx) on tiles rank, rank + nb, ...
  const size_t co = static_cast<size_t>(c) * nb * n;
  const int width = 2 * max_lag + 1;
  for (int ti = rank; ti < ntiles; ti += nb) {
    for (int grp = 0; grp < groups; ++grp) {
      if (threadIdx.x == 0) {
        rm_wide::load_tile<true>(tile, tiles + rm_wide::TILE_INTS * ti, fre + co, fim + co,
                                 smax + static_cast<size_t>(c) * nb, out + static_cast<size_t>(c) * np * width, n,
                                 width, rm_pair::GATE_L2RX, eps2);
      }
      rm_wide::wide_pair_body<N1, K8_THREADS>(tile, rm_pair::GATE_L2RX, eps2, 0.f, iwr, iw2, itwx,
                                              reinterpret_cast<float*>(xs), nsrc, n2, nneg, npos, max_lag,
                                              inv_n, rows, ntg, grp);
      __syncthreads();  // the next body call rewrites the tile and the buffers
    }
  }
}

template <int RMAX>
int launch(const float* xre, const float* xim, const float2* w128, const float2* wn2, const float2* wr,
           const float2* ftw, const float2* iwr, const float2* iw2, const float2* itwx,
           const int* tiles, float* fre, float* fim, float* smax,
           float* seg_score, float* seg_arg, float* nf, float* out,
           int nc, int nb, int np, int ntiles, int n2, int r, int nneg, int npos, int max_lag,
           int nsrc, int rows, int ntg, int groups, float eps2, float inv_n, const DetectParams& prm,
           cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(N1) * n2 + N1 / 2) * sizeof(float2);  // row + W_128
  cudaError_t e = cudaFuncSetAttribute(
      channel_step_kernel<RMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nb > 8) {
    e = cudaFuncSetAttribute(channel_step_kernel<RMAX>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nc * nb);
  cfg.blockDim = dim3(K8_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, channel_step_kernel<RMAX>,
                         xre, xim, w128, wn2, wr, ftw, iwr, iw2, itwx, tiles,
                         fre, fim, smax, seg_score, seg_arg, nf, out,
                         nb, np, ntiles, n2, r, nneg, npos, max_lag, nsrc, rows, ntg, groups, eps2, inv_n, prm);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rm_channel_step_partials(
    const float* xre, const float* xim,
    const float2* w128, const float2* wn2, const float2* wr, const float2* ftw,
    const float2* iwr, const float2* iw2, const float2* itwx, const int* tiles,
    float* fre, float* fim, float* smax,
    float* seg_score, float* seg_arg, float* nf, float* out,
    int nc, int nb, int np, int ntiles, int n2, int a, int r, int nneg, int npos, int max_lag,
    int nsrc, int rows, int ntg, int groups,
    float eps2, float inv_n,
    int radius, int keep_lo, int keep_hi,
    float thr_lin, int has_conf, float conf_cs, float off, int bisect_iters,
    cudaStream_t stream) {
  // the pair body's buffers start at the row and stay inside its n float2
  // (W_128 after it is left alone)
  if (a != rm_fft::HANDOFF_A || a * r != n2 || nsrc < 2 || nsrc > rm_wide::MAX_SRC || rows % 4 != 0 ||
      ntg * (nsrc - 1) > rm_wide::SLOTS<N1> ||
      rm_wide::smem_floats(N1, n2, nsrc, rows, ntg) * sizeof(float) > static_cast<size_t>(N1) * n2 * sizeof(float2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DetectParams prm{radius, keep_lo, keep_hi, thr_lin, has_conf, conf_cs, off, bisect_iters};
#define RM_K8_LAUNCH(R)                                                                                         \
  launch<R>(xre, xim, w128, wn2, wr, ftw, iwr, iw2, itwx, tiles, fre, fim, smax, seg_score, seg_arg, nf, out, nc, \
            nb, np, ntiles, n2, r, nneg, npos, max_lag, nsrc, rows, ntg, groups, eps2, inv_n, prm, stream)
  switch (rm_fft::handoff_rmax(r)) {
    case 8:
      return RM_K8_LAUNCH(8);
    case 16:
      return RM_K8_LAUNCH(16);
    case 24:
      return RM_K8_LAUNCH(24);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RM_K8_LAUNCH
}
