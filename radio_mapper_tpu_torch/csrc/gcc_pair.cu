// Kernels K2, K5 and K6: the GCC pair stage -- cross-power, whitening
// (l2rx, l2, l1 or none), four-step inverse transform of the lag-window
// rows only, |r|/n. The three kernels differ only in where a pair's two
// spectra and its l2rx gate scale come from:
//
//   K2 rm_gcc_pair_lag_mags         [C, B, n] spectra, host pair list in
//                                   tiles, gate from per-receiver maxima smax[C, B]
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
// radix table W_n1^-e (e < n1/2), `twx` the inverse twiddle's two factor
// tables (gcc_pair.wide_twiddle_factors). Python wrappers and plain
// PyTorch versions: radio_mapper_tpu_torch/ops/cuda/gcc_pair.py.
//
// One body, gcc_pair_wide.cuh's wide_pair_body, at every inner length
// n1 = 128, 256, 384, 640, 896, one kernel instantiated for each length and
// kind (gcc_pair_tile_kernel<N1, PAIR_S2>, gcc_rows_kernel<N1>), each with
// its own __launch_bounds__: K2 takes tiles of two pairs that share a
// receiver, K5 tiles of up to six (at one n-tile a window) and K6 one
// pair; the tile's rows arrive by bulk copies (cp.async.bulk
// on an mbarrier) into a double buffer a chunk ahead; the fold runs on the
// tensor cores (mma.sync m16n8k8 TF32, 3xTF32 split, accumulators in
// registers); blockIdx.y takes the window's n-tiles past a block's slots.
// rm_gcc_pair_info reports each kernel's registers, local memory and
// resident blocks. Kernel K8's pair half (channel_step.cu) runs the same
// body at n1 = 128.

#include <cuda_runtime.h>

#include "gcc_pair.cuh"
#include "gcc_pair_wide.cuh"

namespace {

// K2 (and K5, PAIR_S2): block = (channel c or subchannel, tile t) = blockIdx.x,
// n-tile group blockIdx.y. tiles[TILE_INTS*t ..]: gcc_pair.wide_tiles. nsrc: the
// most sources a tile of the launch stages (its buffers' size). The l2rx
// gate from the per-receiver maxima smax [C, B] (K2) or per pair from
// s2 [C, P] (PAIR_S2).
template <int N1, bool PAIR_S2>
__global__ void __launch_bounds__(rm_wide::THREADS, rm_wide::MIN_BLOCKS<N1>)
gcc_pair_tile_kernel(const float* __restrict__ sre, const float* __restrict__ sim,
                     const float* __restrict__ scale, const int* __restrict__ tiles,
                     const float2* __restrict__ wi, const float2* __restrict__ w2,
                     const float2* __restrict__ twx, float* __restrict__ out,
                     int nb, int np, int ntiles, int n2, int nneg, int npos, int max_lag,
                     int nsrc, int rows, int ntg, int gate, float eps2, float eps, float inv_n) {
  extern __shared__ float4 smem[];
  __shared__ rm_wide::Tile tile;
  const size_t n = static_cast<size_t>(N1) * n2;
  if (threadIdx.x == 0) {
    const int c = blockIdx.x / ntiles;
    const int* td = tiles + rm_wide::TILE_INTS * (blockIdx.x - c * ntiles);
    const size_t co = static_cast<size_t>(c) * nb * n;
    const int width = 2 * max_lag + 1;
    rm_wide::load_tile<false>(tile, td, sre + co, sim + co, PAIR_S2 ? nullptr : scale + c * nb,
                              out + static_cast<size_t>(c) * np * width, n, width,
                              PAIR_S2 ? rm_pair::GATE_NONE : gate, eps2);
    if constexpr (PAIR_S2) {
      for (int g = 0; g < tile.npairs; ++g) {
        tile.floor2[g] = gate == rm_pair::GATE_L2RX ? eps2 * scale[c * np + td[rm_wide::MAX_SRC + 1 + 2 * g]] : 0.f;
      }
    }
  }
  rm_wide::wide_pair_body<N1>(tile, gate, eps2, eps, wi, w2, twx, reinterpret_cast<float*>(smem), nsrc, n2,
                              nneg, npos, max_lag, inv_n, rows, ntg, blockIdx.y);
}

// One pair a block on two sources: X in slot 0, Y in slot 1 (K6).
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

// K6: block = row k = blockIdx.x, n-tile group blockIdx.y. Two blocks an SM
// at n1 = 128 (at three its 80 registers spilled).
template <int N1>
__global__ void __launch_bounds__(rm_wide::THREADS, N1 == 128 ? 2 : rm_wide::MIN_BLOCKS<N1>)
gcc_rows_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
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
                              npos, max_lag, inv_n, rows, ntg, blockIdx.y);
}

// The kernel instantiated for n1 of a kind's five, or null where n1 is
// not an inner length of the body.
template <template <int> class Kind>
auto pick(int n1) -> decltype(Kind<128>::kernel()) {
  switch (n1) {
    case 128: return Kind<128>::kernel();
    case 256: return Kind<256>::kernel();
    case 384: return Kind<384>::kernel();
    case 640: return Kind<640>::kernel();
    case 896: return Kind<896>::kernel();
    default: return nullptr;
  }
}

template <int N1> struct K2 { static auto kernel() { return &gcc_pair_tile_kernel<N1, false>; } };
template <int N1> struct K5 { static auto kernel() { return &gcc_pair_tile_kernel<N1, true>; } };
template <int N1> struct K6 { static auto kernel() { return &gcc_rows_kernel<N1>; } };

// The kernel of kind (0: K2, 1: K5, 2: K6) at n1, or null.
const void* kernel_of(int kind, int n1) {
  if (kind == 0) return reinterpret_cast<const void*>(pick<K2>(n1));
  if (kind == 1) return reinterpret_cast<const void*>(pick<K5>(n1));
  if (kind == 2) return reinterpret_cast<const void*>(pick<K6>(n1));
  return nullptr;
}

// Dynamic shared memory of a launch (gcc_pair.wide_smem_bytes).
size_t smem_bytes(int n1, int n2, int nsrc, int rows, int ntg) {
  return rm_wide::smem_floats(n1, n2, nsrc, rows, ntg) * sizeof(float);
}

cudaError_t prepare(const void* kernel, size_t smem) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

// K2, or K5 (s2 per pair instead of smax per receiver)
int launch_tiles(int kind, const float* sre, const float* sim, const float* scale, const int* tiles,
                 const float2* wi, const float2* w2, const float2* twx, float* out,
                 int nc, int nb, int np, int ntiles, int n1, int n2, int nneg, int npos, int max_lag,
                 int nsrc, int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n,
                 cudaStream_t stream) {
  if (nsrc < 2 || nsrc > rm_wide::MAX_SRC) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kind == 0 ? pick<K2>(n1) : pick<K5>(n1);
  const size_t smem = smem_bytes(n1, n2, nsrc, rows, ntg);
  cudaError_t e = prepare(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(nc * ntiles, groups), rm_wide::THREADS, smem, stream>>>(
      sre, sim, scale, tiles, wi, w2, twx, out, nb, np, ntiles, n2, nneg, npos, max_lag, nsrc, rows, ntg, gate,
      eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rm_gcc_pair_lag_mags(
    const float* sre, const float* sim, const float* smax, const int* tiles,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int nc, int nb, int np, int ntiles, int n1, int n2, int nneg, int npos, int max_lag,
    int nsrc, int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  return launch_tiles(0, sre, sim, smax, tiles, wi, w2, twx, out, nc, nb, np, ntiles, n1, n2, nneg, npos,
                      max_lag, nsrc, rows, ntg, groups, gate, eps2, eps, inv_n, stream);
}

// K5: the tile kernel with s2 [M, P] per pair (M subchannels as K2's channels).
extern "C" int rm_gcc_pairs_onehot_lag_mags(
    const float* sre, const float* sim, const float* s2, const int* tiles,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int nc, int nb, int np, int ntiles, int n1, int n2, int nneg, int npos, int max_lag,
    int nsrc, int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  return launch_tiles(1, sre, sim, s2, tiles, wi, w2, twx, out, nc, nb, np, ntiles, n1, n2, nneg, npos,
                      max_lag, nsrc, rows, ntg, groups, gate, eps2, eps, inv_n, stream);
}

extern "C" int rm_gcc_rows_lag_mags(
    const float* xre, const float* xim, const float* yre, const float* yim, const float* s2,
    const float2* wi, const float2* w2, const float2* twx, float* out,
    int np, int n1, int n2, int nneg, int npos, int max_lag,
    int rows, int ntg, int groups, int gate, float eps2, float eps, float inv_n, cudaStream_t stream) {
  const auto kernel = pick<K6>(n1);
  const size_t smem = smem_bytes(n1, n2, 2, rows, ntg);
  cudaError_t e = prepare(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(np, groups), rm_wide::THREADS, smem, stream>>>(
      xre, xim, yre, yim, s2, wi, w2, twx, out, n2, nneg, npos, max_lag, rows, ntg, gate, eps2, eps, inv_n);
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the kernel of kind (0: K2, 1: K5, 2: K6) at n1
// with smem bytes of dynamic shared memory: info[0] registers
// a thread, [1] local memory a thread (bytes; 0 without spills), [2]
// blocks resident on an SM, [3] static shared memory (bytes).
extern "C" int rm_gcc_pair_info(int kind, int n1, int smem, int* info) {
  const void* kernel = kernel_of(kind, n1);
  cudaError_t e = prepare(kernel, static_cast<size_t>(smem));
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
