// Kernel K7, cluster design: forward natural-order FFT of [rows, n] rows
// for n = 32768 and 65536, a row too long for one SM, on a thread-block
// cluster of c = n / 16384 blocks (2 and 4).
//
// Replaces radio_mapper_tpu/ops/pallas/fft_kernel.py::fft_rows (body
// _fft_rows_kernel) for those rows. Python wrapper, plan, tables and plain
// PyTorch version: radio_mapper_tpu_torch/ops/cuda/fft_natural.py
// (design(n) == "cluster"). tests/test_torch_cluster_fft.py replays this
// schedule in numpy.
//
// Bound on the H100: device-memory bytes, each row read once and its
// spectrum written once, 16 B a point (1.282 ms at [8192, 32768] and at
// [4096, 65536] at 3.35 TB/s).
//
// Design. With m = n / c = 16384, block r of a row's cluster computes
//   y_r[j] = W_n^(r*j) * sum_{s<c} x[j + s*m] * W_c^(r*s),   j < m,
//   Y_r    = FFT_m(y_r),
// one radix-c decimation-in-frequency stage folded into the loads (W_c^e
// is 1, -i, -1 or i, so the sum is exact adds), and X[c*k + r] = Y_r[k].
//   - The loads: block r reads only its own part of the row, x[r*m +
//     t + T*i] (T = 1024 threads, 16 points a thread; consecutive threads
//     on consecutive addresses), stores it to its exchange buffer, and
//     after a cluster barrier reads the c inputs of its points, x[j +
//     s*m] at element j of block s's buffer, through DSMEM; a second
//     barrier ends those reads before the first exchange writes. (Reading
//     all c inputs from device memory instead, the partners' repeats
//     served by L2, took 6-8% longer at both lengths: PERF.md.)
//   - The sub-FFT is the radix design's 16384-point core as it stands
//     (fft_natural.cuh: butterflies, exchange; 1024 threads, 16 points a
//     thread, the 128 KiB XOR-swizzled exchange buffer), except its last
//     pass, which stores Y_r to the block's own exchange buffer with the
//     same swizzle (store_shared).
//   - After a cluster barrier, block r writes natural bins [r*m, (r+1)*m)
//     contiguously: bin g = r*m + t + T*i is Y_{g mod c}[g / c], and
//     g mod c = t mod c (c divides m and T), so thread t reads one
//     partner's buffer for all its 16 bins. A warp reads 32/c consecutive
//     elements of each of c buffers, which the swizzle keeps in distinct
//     banks; the stores are coalesced.
//   - A last cluster barrier: no block exits while a partner reads it.
// Twiddles: W_n^(r*j), r = 1..c-1, j < m, a float32 table of float64
// roots rounded once (fft_natural.cluster_plan), read with __ldg; the
// sub-FFT's own table is radix_plan(16384)'s. FP32 on the CUDA cores.
// Device traffic: 16 B a point, no scratch.

#include <cuda_runtime.h>

#include "cluster.cuh"
#include "fft_natural.cuh"

namespace {

using namespace rm_k7;

constexpr int M = 16384;          // the sub-FFT's length: fft_natural.CLUSTER_SUB_N
constexpr int T = M / POINTS;     // 1024 threads a block
constexpr int RL = 4;             // 16384 = 16*16*16*4
constexpr size_t SMEM = 2 * M * sizeof(float);  // planar re/im exchange buffer, 128 KiB

// x * W_c^e for W_c^e in {1, -i, -1, i} (e taken mod c, scaled to W_4).
template <int C>
__device__ __forceinline__ float2 mul_wc(float2 x, int e) {
  switch ((e % C) * (4 / C)) {
    case 0: return x;
    case 1: return make_float2(x.y, -x.x);
    case 2: return make_float2(-x.x, -x.y);
    default: return make_float2(-x.y, x.x);
  }
}

template <int C>
__global__ void __launch_bounds__(T, 1)
fft_natural_cluster_kernel(const float* __restrict__ xre, const float* __restrict__ xim,
                           const float2* __restrict__ tw, const float2* __restrict__ pre,
                           float* __restrict__ fre, float* __restrict__ fim) {
  constexpr int N = C * M;
  extern __shared__ float smem[];
  float* sre = smem;      // [M], swizzled
  float* sim = smem + M;  // [M], swizzled
  const int rank = static_cast<int>(rm_cluster::rank());
  const size_t off = static_cast<size_t>(blockIdx.x / C) * N;
  const int t = static_cast<int>(threadIdx.x);

  // ---- the radix-c DIF stage: v[i] = y_rank[t + T*i]
  const size_t own = off + static_cast<size_t>(rank) * M;
#pragma unroll
  for (int i = 0; i < POINTS; ++i) {
    const int a = swizzle(t + T * i);
    sre[a] = __ldcs(xre + own + t + T * i);
    sim[a] = __ldcs(xim + own + t + T * i);
  }
  rm_cluster::sync();
  uint32_t src[C];
#pragma unroll
  for (int s = 0; s < C; ++s) src[s] = rm_cluster::dsmem(sre, s);
  float2 v[POINTS];
#pragma unroll
  for (int i = 0; i < POINTS; ++i) {
    const uint32_t a = 4u * static_cast<uint32_t>(swizzle(t + T * i));
    float2 acc = make_float2(rm_cluster::ld1(src[0] + a), rm_cluster::ld1(src[0] + a + 4u * M));
#pragma unroll
    for (int s = 1; s < C; ++s) {
      const float2 x = make_float2(rm_cluster::ld1(src[s] + a), rm_cluster::ld1(src[s] + a + 4u * M));
      acc = cadd(acc, mul_wc<C>(x, rank * s));
    }
    v[i] = acc;
  }
  rm_cluster::sync();  // every partner has read this buffer before the first exchange writes it
  if (rank > 0) {
    const float2* w = pre + static_cast<size_t>(rank - 1) * M + t;
#pragma unroll
    for (int i = 0; i < POINTS; ++i) v[i] = cmul(v[i], __ldg(w + T * i));
  }

  // ---- Y_rank = FFT_16384(y_rank), the radix design's passes
  butterflies<M, RADIX, 1>(v, nullptr);
  exchange<M, RADIX, 1, false>(v, sre, sim);
  butterflies<M, RADIX, 16>(v, tw);
  exchange<M, RADIX, 16, true>(v, sre, sim);
  butterflies<M, RADIX, 256>(v, tw + 15 * 16);
  exchange<M, RADIX, 256, true>(v, sre, sim);
  butterflies<M, RL, 4096>(v, tw + 15 * 16 + 15 * 256);
  __syncthreads();  // the last exchange's reads are done
  store_shared<M, RL>(v, sre, sim);
  rm_cluster::sync();  // every block's Y is in its buffer

  // ---- bins [rank*m, (rank+1)*m): bin g = Y_{t mod C}[g / C]
  const uint32_t part = rm_cluster::dsmem(sre, static_cast<unsigned>(t % C));
  const int k0 = rank * (M / C) + t / C;
  float2 y[POINTS];
#pragma unroll
  for (int i = 0; i < POINTS; ++i) {
    const uint32_t a = 4u * static_cast<uint32_t>(swizzle(k0 + (T / C) * i));
    y[i] = make_float2(rm_cluster::ld1(part + a), rm_cluster::ld1(part + a + 4u * M));
  }
  const size_t o = off + static_cast<size_t>(rank) * M + t;
#pragma unroll
  for (int i = 0; i < POINTS; ++i) {
    __stcs(fre + o + T * i, y[i].x);
    __stcs(fim + o + T * i, y[i].y);
  }
  rm_cluster::sync();  // no block exits while a partner reads its buffer
}

template <int C>
int launch(const float* xre, const float* xim, const float2* tw, const float2* pre, float* fre,
           float* fim, int rows, cudaStream_t stream) {
  return rm_cluster::launch(fft_natural_cluster_kernel<C>, rows * C, T, SMEM, C, stream,
                            xre, xim, tw, pre, fre, fim);
}

}  // namespace

// Forward FFT of `rows` rows of n = 32768 or 65536 points, natural bin
// order, on clusters of c = n / 16384 blocks. tw: radix_plan(16384)'s
// twiddles; pre: [(c-1), 16384] W_n^(r*j) (fft_natural.cluster_plan), as
// float2.
extern "C" int rm_fft_natural_cluster(const float* xre, const float* xim, const float2* tw,
                                      const float2* pre, float* fre, float* fim, int rows, int n,
                                      cudaStream_t stream) {
  if (rows <= 0 || rows > 0x7fffffff / 4) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 32768: return launch<2>(xre, xim, tw, pre, fre, fim, rows, stream);
    case 65536: return launch<4>(xre, xim, tw, pre, fre, fim, rows, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The cluster's shape at n: its c, shared memory a block, and
// cudaOccupancyMaxActiveClusters (0: the card cannot run it).
extern "C" int rm_fft_natural_cluster_info(int n, int* c, int* smem, int* clusters) {
  *smem = static_cast<int>(SMEM);
  switch (n) {
    case 32768: *c = 2; return static_cast<int>(
        rm_cluster::occupancy(fft_natural_cluster_kernel<2>, T, SMEM, 2, clusters));
    case 65536: *c = 4; return static_cast<int>(
        rm_cluster::occupancy(fft_natural_cluster_kernel<4>, T, SMEM, 4, clusters));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
