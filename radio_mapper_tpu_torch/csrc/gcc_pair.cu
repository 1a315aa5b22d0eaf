// Kernels K2, K5 and K6: the GCC pair stage -- cross-power, whitening
// (l2rx, l2, l1 or none), four-step inverse transform of the lag-window
// rows only, |r|/n. The three kernels differ only in where a pair's two
// spectra and its l2rx gate scale come from:
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
// _whiten + _invert_to_lag_windows). `gate` is an rm_pair::Gate, and the
// gate-scale pointer may be null unless gate is l2rx; `wi` is the inverse
// radix table W_n1^-e (e < n1/2). Python wrappers and plain PyTorch
// versions: radio_mapper_tpu_torch/ops/cuda/gcc_pair.py.
//
// Two bodies, by the inner length n1 of the CT split:
//
// n1 = 128, 256: gcc_pair.cuh's pair_lag_window, shared with kernel K8.
// One pair a block; one warp a CT row, whose n1 = 32*P points go through a
// warp-shuffle inverse FFT in registers, then the CUDA cores fold each
// chunk of rows into the window rows held in shared memory (about 26 KB
// at nfft 17408, max_lag 512; 19 KB at nfft 5120, max_lag 128), so four
// blocks share an SM. The fold, 8*n*(nneg + npos) FLOP a pair with a
// shared-memory read for each complex FMA, is the largest part of the work.
//
// n1 = 384, 640, 896: gcc_pair_wide.cuh's wide_pair_body, one kernel
// instantiated for each length (gcc_pair_wide_kernel<N1>, ...), each with
// its own __launch_bounds__: K2 takes tiles of two pairs that share a
// receiver, K5 and K6 one pair; the tile's rows arrive by bulk copies
// (cp.async.bulk on an mbarrier) into a double buffer a chunk ahead; the
// fold runs on the tensor cores (mma.sync m16n8k8 TF32, 3xTF32 split,
// accumulators in registers); blockIdx.y takes the window's n-tiles past
// the first two. rm_gcc_pair_wide_info reports each kernel's registers,
// local memory and resident blocks.
//
// Later PRs: fusion with the forward transform so spectra never reach
// device memory (kernel K8 does it for n1 = 128 through a scratch).

#include <cuda_runtime.h>

#include "gcc_pair.cuh"
#include "gcc_pair_wide.cuh"

namespace {

constexpr int K2_THREADS = 256;  // gcc_pair.THREADS

using rm_pair::pair_lag_window;

// K2: block = (channel c, pair pidx); gate from per-receiver maxima.
__global__ void __launch_bounds__(K2_THREADS, 4)
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
  pair_lag_window<K2_THREADS, false>(sre + xo, sim + xo, sre + yo, sim + yo, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

// K5: block = (subchannel c, pair pidx) = blockIdx.x; per-pair gate s2[c, pidx].
__global__ void __launch_bounds__(K2_THREADS, 4)
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
  pair_lag_window<K2_THREADS, false>(sre + xo, sim + xo, sre + yo, sim + yo, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

// K6: block = row k; X row k pairs with Y row k, gate s2[k].
__global__ void __launch_bounds__(K2_THREADS, 4)
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
  pair_lag_window<K2_THREADS, false>(xre + o, xim + o, yre + o, yim + o, gate, floor2, eps2, eps,
                  wi, w2, tw,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1), sm,
                  n1, n2, nneg, npos, max_lag, inv_n);
}

// ---- the wide inner lengths (gcc_pair_wide.cuh): one kernel a length ----

// K2 wide: block = (channel c, tile t) = blockIdx.x, n-tile group blockIdx.y.
// tiles[8t ..]: receivers of slots 0, 1, 2 (-1: none), pairs in the tile,
// then per pair its index and whether X is the leaf (1) or slot 0 (0).
// nsrc: the most sources a tile of the launch stages (its buffers' size).
template <int N1>
__global__ void __launch_bounds__(rm_wide::THREADS, rm_wide::MIN_BLOCKS<N1>)
gcc_pair_wide_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                     const float* __restrict__ smax, const int* __restrict__ tiles,
                     const float2* __restrict__ wi, const float2* __restrict__ w2,
                     const float2* __restrict__ twx, float* __restrict__ out,
                     int nb, int np, int ntiles, int n2, int nneg, int npos, int max_lag,
                     int nsrc, int rows, int ntg, int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];
  __shared__ rm_wide::Tile tile;
  const size_t n = static_cast<size_t>(N1) * n2;
  if (threadIdx.x == 0) {
    const int c = blockIdx.x / ntiles;
    const int* td = tiles + 8 * (blockIdx.x - c * ntiles);
    tile.npairs = td[3];
    tile.nsrc = td[3] + 1;
    for (int s = 0; s < tile.nsrc; ++s) {
      const size_t o = (static_cast<size_t>(c) * nb + td[s]) * n;
      tile.src[2 * s] = sre + o;
      tile.src[2 * s + 1] = sim + o;
    }
    for (int g = 0; g < tile.npairs; ++g) {
      const int leaf_x = td[5 + 2 * g];
      tile.xs[g] = leaf_x ? g + 1 : 0;
      tile.ys[g] = leaf_x ? 0 : g + 1;
      const int bi = td[tile.xs[g]], bj = td[tile.ys[g]];
      tile.floor2[g] = gate == rm_pair::GATE_L2RX ? eps2 * (smax[c * nb + bi] * smax[c * nb + bj]) : 0.f;
      tile.l1_floor[g] = 0.f;
      tile.out[g] = out + (static_cast<size_t>(c) * np + td[4 + 2 * g]) * (2 * max_lag + 1);
    }
  }
  rm_wide::wide_pair_body<N1>(tile, gate, eps2, eps, wi, w2, twx, reinterpret_cast<float*>(smem), nsrc, n2,
                              nneg, npos, max_lag, inv_n, rows, ntg);
}

// One pair a block on two sources: X in slot 0, Y in slot 1 (K5, K6).
__device__ __forceinline__ void one_pair_tile(rm_wide::Tile& tile, const float* xre, const float* xim,
                                              const float* yre, const float* yim, float floor2, float* orow) {
  tile.npairs = 1;
  tile.nsrc = 2;
  tile.src[0] = xre;
  tile.src[1] = xim;
  tile.src[2] = yre;
  tile.src[3] = yim;
  tile.xs[0] = 0;
  tile.ys[0] = 1;
  tile.floor2[0] = floor2;
  tile.l1_floor[0] = 0.f;
  tile.out[0] = orow;
}

// K5 wide: block = (subchannel c, pair pidx) = blockIdx.x, n-tile group blockIdx.y.
template <int N1>
__global__ void __launch_bounds__(rm_wide::THREADS, rm_wide::MIN_BLOCKS<N1>)
gcc_pairs_onehot_wide_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                             const float* __restrict__ s2,
                             const int* __restrict__ pair_i, const int* __restrict__ pair_j,
                             const float2* __restrict__ wi, const float2* __restrict__ w2,
                             const float2* __restrict__ twx, float* __restrict__ out,
                             int nb, int np, int n2, int nneg, int npos, int max_lag,
                             int rows, int ntg, int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];
  __shared__ rm_wide::Tile tile;
  if (threadIdx.x == 0) {
    const size_t n = static_cast<size_t>(N1) * n2;
    const int c = blockIdx.x / np, pidx = blockIdx.x - c * np;
    const size_t xo = (static_cast<size_t>(c) * nb + pair_i[pidx]) * n;
    const size_t yo = (static_cast<size_t>(c) * nb + pair_j[pidx]) * n;
    one_pair_tile(tile, sre + xo, sim + xo, sre + yo, sim + yo,
                  gate == rm_pair::GATE_L2RX ? eps2 * s2[blockIdx.x] : 0.f,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1));
  }
  rm_wide::wide_pair_body<N1>(tile, gate, eps2, eps, wi, w2, twx, reinterpret_cast<float*>(smem), 2, n2, nneg,
                              npos, max_lag, inv_n, rows, ntg);
}

// K6 wide: block = row k = blockIdx.x, n-tile group blockIdx.y.
template <int N1>
__global__ void __launch_bounds__(rm_wide::THREADS, rm_wide::MIN_BLOCKS<N1>)
gcc_rows_wide_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                     const float* __restrict__ yre, const float* __restrict__ yim,
                     const float* __restrict__ s2,
                     const float2* __restrict__ wi, const float2* __restrict__ w2,
                     const float2* __restrict__ twx, float* __restrict__ out,
                     int n2, int nneg, int npos, int max_lag,
                     int rows, int ntg, int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];
  __shared__ rm_wide::Tile tile;
  if (threadIdx.x == 0) {
    const size_t o = static_cast<size_t>(blockIdx.x) * N1 * n2;
    one_pair_tile(tile, xre + o, xim + o, yre + o, yim + o,
                  gate == rm_pair::GATE_L2RX ? eps2 * s2[blockIdx.x] : 0.f,
                  out + static_cast<size_t>(blockIdx.x) * (2 * max_lag + 1));
  }
  rm_wide::wide_pair_body<N1>(tile, gate, eps2, eps, wi, w2, twx, reinterpret_cast<float*>(smem), 2, n2, nneg,
                              npos, max_lag, inv_n, rows, ntg);
}

// The kernel instantiated for n1 of a kind's three, or null where n1 is not
// a wide length.
template <typename Kernel>
Kernel pick(int n1, Kernel k384, Kernel k640, Kernel k896) {
  return n1 == 384 ? k384 : n1 == 640 ? k640 : n1 == 896 ? k896 : nullptr;
}

auto pick_k2(int n1) {
  return pick(n1, gcc_pair_wide_kernel<384>, gcc_pair_wide_kernel<640>, gcc_pair_wide_kernel<896>);
}

auto pick_k5(int n1) {
  return pick(n1, gcc_pairs_onehot_wide_kernel<384>, gcc_pairs_onehot_wide_kernel<640>,
              gcc_pairs_onehot_wide_kernel<896>);
}

auto pick_k6(int n1) {
  return pick(n1, gcc_rows_wide_kernel<384>, gcc_rows_wide_kernel<640>, gcc_rows_wide_kernel<896>);
}

// The wide kernel of kind (0: K2, 1: K5, 2: K6) at n1, or null.
const void* wide_kernel(int kind, int n1) {
  if (kind == 0) return reinterpret_cast<const void*>(pick_k2(n1));
  if (kind == 1) return reinterpret_cast<const void*>(pick_k5(n1));
  if (kind == 2) return reinterpret_cast<const void*>(pick_k6(n1));
  return nullptr;
}

// Dynamic shared memory of a wide launch (gcc_pair.wide_smem_bytes).
size_t wide_smem_bytes(int n1, int n2, int nsrc, int rows, int ntg) {
  return rm_wide::smem_floats(n1, n2, nsrc, rows, ntg) * sizeof(float);
}

cudaError_t prepare_wide(const void* kernel, size_t smem) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
  const auto kernel = gcc_pair_kernel;
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
  const auto kernel = gcc_pairs_onehot_kernel;
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
  const auto kernel = gcc_rows_kernel;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<np, K2_THREADS, smem, stream>>>(
      xre, xim, yre, yim, s2, wi, w2, tw, out, n1, n2, nneg, npos, max_lag, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

// ---- the wide inner lengths: one kernel a length (gcc_pair_wide.cuh) ----

extern "C" int rm_gcc_pair_wide_lag_mags(
    const float* sre, const float* sim, const float* smax, const int* tiles,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int nc, int nb, int np, int ntiles, int n1, int n2, int nneg, int npos, int max_lag,
    int nsrc, int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  if (nsrc < 2 || nsrc > rm_wide::MAX_SRC) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pick_k2(n1);
  const size_t smem = wide_smem_bytes(n1, n2, nsrc, rows, ntg);
  cudaError_t e = prepare_wide(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nc * ntiles, groups), rm_wide::THREADS, smem, stream>>>(
      sre, sim, smax, tiles, wi, w2, twx, out, nb, np, ntiles, n2, nneg, npos, max_lag, nsrc, rows, ntg, gate,
      eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_gcc_pairs_onehot_wide_lag_mags(
    const float* sre, const float* sim, const float* s2, const int* pair_i, const int* pair_j,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int nc, int nb, int np, int n1, int n2, int nneg, int npos, int max_lag,
    int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  const auto kernel = pick_k5(n1);
  const size_t smem = wide_smem_bytes(n1, n2, 2, rows, ntg);
  cudaError_t e = prepare_wide(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nc * np, groups), rm_wide::THREADS, smem, stream>>>(
      sre, sim, s2, pair_i, pair_j, wi, w2, twx, out, nb, np, n2, nneg, npos, max_lag, rows, ntg, gate, eps2,
      eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rm_gcc_rows_wide_lag_mags(
    const float* xre, const float* xim, const float* yre, const float* yim, const float* s2,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int np, int n1, int n2, int nneg, int npos, int max_lag,
    int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  const auto kernel = pick_k6(n1);
  const size_t smem = wide_smem_bytes(n1, n2, 2, rows, ntg);
  cudaError_t e = prepare_wide(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(np, groups), rm_wide::THREADS, smem, stream>>>(
      xre, xim, yre, yim, s2, wi, w2, twx, out, n2, nneg, npos, max_lag, rows, ntg, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the wide kernel of kind (0: K2, 1: K5, 2: K6) at
// n1 with smem bytes of dynamic shared memory: info[0] registers a thread,
// [1] local memory a thread (bytes; 0 without spills), [2] blocks resident
// on an SM, [3] static shared memory (bytes).
extern "C" int rm_gcc_pair_wide_info(int kind, int n1, int smem, int* info) {
  const void* kernel = wide_kernel(kind, n1);
  cudaError_t e = prepare_wide(kernel, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, rm_wide::THREADS, static_cast<size_t>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.localSizeBytes);
  info[2] = blocks;
  info[3] = static_cast<int>(a.sharedSizeBytes);
  return 0;
}
